"""Blockwise 8-bit AdamW and Lion on `torch.optim` (port of
trlx_tpu.ops.adam8bit and of the registry's `lion`).

The moment states live in int8 with one fp32 absmax scale per block of
BLOCK = 256 elements (the flattened leaf, zero-padded to whole blocks),
companded as q = round(sign(x) * 127 * sqrt(|x| / absmax)): the first
moment symmetric, the second (non-negative) in the positive half. The
payloads and scales are the optimizer's per-parameter state (`m_q`,
`m_scale`, `v_q`, `v_scale`), so `state_dict` and a checkpoint carry them
bit for bit; `step` is the shared update count, a host tensor as in
torch's Adam.

Two AdamW variants, as in the reference:
- `fused=True` (`adamw_8bit_fused`, the reference's `FusedAdamW8bit`):
  dequantize -> moment update -> bias-corrected step -> weight decay ->
  parameter write -> requantize in one pass per leaf, never materialising
  an fp32 moment or update tree; on CUDA tensors it is kernel 9
  (`csrc/adam8bit.cu`).
- `fused=False` (`adamw_8bit_bnb`, the reference's optax chain
  `scale_by_adam_8bit` -> `add_decayed_weights` -> `scale_by_learning_rate`):
  the same moment math, but the step is emitted in the gradient's dtype
  (bf16 under `train.grads_dtype: bfloat16`), then the decay is added and
  the learning rate applied in that chain's dtypes. The kernel reproduces
  that rounding (its `bnb` mode), so both variants take kernel 9 on CUDA.

The learning rate is the param group's `lr`, which the trainer's LambdaLR
sets to schedule(count) before the step: the pre-increment count, as
`optax.scale_by_learning_rate` reads it. Frozen parameters are not in
the optimizer at all: their moments are never created (the reference's
zero-mask skip).

Kernel 9 replaces no Pallas kernel: the reference runs this update as an
XLA-fused elementwise pass. It was added because in eager PyTorch the
same chain is a dozen full-size fp32 temporaries per leaf; the kernel
moves about 14 bytes per parameter (fp32 parameter read and write, a bf16
gradient, the two int8 payloads read and written) and is bound by them.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

BLOCK = 256


# ---------------------------------------------------------------------------
# The blockwise companded int8 code
# ---------------------------------------------------------------------------


def _to_blocks(x: torch.Tensor) -> torch.Tensor:
    """A leaf flattened, zero-padded to whole blocks: [n_blocks, BLOCK]."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, BLOCK)


def n_blocks(numel: int) -> int:
    return -(-numel // BLOCK)


def quant_blocks(blocks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[n, BLOCK] fp32 -> (int8 payload [n, BLOCK], fp32 absmax [n])."""
    scale = blocks.abs().amax(dim=1, keepdim=True)
    norm = blocks.abs() / torch.clamp(scale, min=1e-30)
    q = torch.round(torch.sign(blocks) * torch.sqrt(norm) * 127.0)
    return q.to(torch.int8), scale[:, 0]


def _true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d by a correctly rounded division, as JAX and kernel 9 divide (a
    CUDA tensor divided by a python scalar multiplies by its reciprocal)."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def deq_blocks(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    u = _true_div(q.float(), 127.0)
    return torch.sign(u) * u * u * scale[:, None]


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A leaf's blockwise int8 code: (payload [n_blocks, BLOCK], scales)."""
    return quant_blocks(_to_blocks(x.float()))


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    n = math.prod(shape)
    return deq_blocks(q, scale).reshape(-1)[:n].reshape(shape)


def bias_corrections(b1: float, b2: float, count: int) -> Tuple[float, float]:
    """(1 - b1^count, 1 - b2^count) in fp32, as the reference computes them."""
    c = torch.tensor(float(count), dtype=torch.float32)
    bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** c
    bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** c
    return float(bc1), float(bc2)


# ---------------------------------------------------------------------------
# One leaf's update: the plain version and kernel 9
# ---------------------------------------------------------------------------


def adam8bit_step_plain(p, g, m_q, m_scale, v_q, v_scale, lr, b1, b2, eps, weight_decay, bc1, bc2,
                        bnb: bool = False) -> None:
    """One AdamW step of a leaf over its int8 moments, IN PLACE on `p`
    (fp32) and the four state tensors. `g` is fp32 or bf16. `bnb` selects
    the optax-chain variant's rounding: the step in g's dtype, then the
    decay, then the learning rate in the resulting dtype; otherwise the
    fused variant's fp32 `p - lr * (step + wd * p)`."""
    n = p.numel()
    pb = _to_blocks(p.detach().float())
    g32 = _to_blocks(g.detach()).float()
    m = b1 * deq_blocks(m_q, m_scale) + (1 - b1) * g32
    v = b2 * deq_blocks(v_q, v_scale) + (1 - b2) * g32 * g32
    step = _true_div(m, bc1) / (torch.sqrt(_true_div(v, bc2)) + eps)
    if bnb:
        step = step.to(g.dtype)
        if weight_decay:
            upd = torch.tensor(-lr, dtype=torch.float32) * (step.float() + weight_decay * pb)
        else:
            upd = (torch.tensor(-lr, dtype=torch.float32).to(g.dtype) * step).float()
        new_p = pb + upd
    else:
        if weight_decay:
            step = step + weight_decay * pb
        new_p = pb - lr * step
    p.data.copy_(new_p.reshape(-1)[:n].reshape(p.shape).to(p.dtype))
    for (q_out, s_out), x in (((m_q, m_scale), m), ((v_q, v_scale), v)):
        q, s = quant_blocks(x)
        q_out.copy_(q)
        s_out.copy_(s)


def _check_leaf(p, g, m_q, m_scale, v_q, v_scale) -> None:
    dev, nb = p.device, n_blocks(p.numel())
    if p.dtype != torch.float32 or g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel 9 takes an fp32 parameter and an fp32 or bf16 gradient, got {p.dtype}, {g.dtype}")
    if g.shape != p.shape:
        raise ValueError(f"gradient shape {tuple(g.shape)} != parameter shape {tuple(p.shape)}")
    for name, x, dtype, shape in (("m_q", m_q, torch.int8, (nb, BLOCK)), ("v_q", v_q, torch.int8, (nb, BLOCK)),
                                  ("m_scale", m_scale, torch.float32, (nb,)),
                                  ("v_scale", v_scale, torch.float32, (nb,))):
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got {x.dtype} {tuple(x.shape)}")
    for name, x in (("p", p), ("g", g), ("m_q", m_q), ("m_scale", m_scale), ("v_q", v_q), ("v_scale", v_scale)):
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")


def adam8bit_step(p, g, m_q, m_scale, v_q, v_scale, lr, b1, b2, eps, weight_decay, bc1, bc2,
                  bnb: bool = False) -> None:
    """`adam8bit_step_plain`'s update: the plain version on CPU tensors,
    kernel 9 on CUDA tensors (or an exception, never the plain path)."""
    if p.device.type == "cpu":
        return adam8bit_step_plain(p, g, m_q, m_scale, v_q, v_scale, lr, b1, b2, eps, weight_decay, bc1, bc2, bnb)
    if p.device.type != "cuda":
        raise ValueError(f"adam8bit_step runs on cpu or cuda, not {p.device}")
    from trlx_tpu_torch.ops.flash_attention import _launch, _stream

    g = g.detach()
    _check_leaf(p, g, m_q, m_scale, v_q, v_scale)
    adam8bit_step.launches += 1
    _launch(
        "adam8bit.cu", "adam8bit_step",
        [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_float] * 9
        + [ctypes.c_int, ctypes.c_void_p],
        (p.data_ptr(), g.data_ptr(), m_q.data_ptr(), m_scale.data_ptr(), v_q.data_ptr(), v_scale.data_ptr(),
         int(g.dtype == torch.bfloat16), p.numel(), lr, b1, b2, 1 - b1, 1 - b2, eps, weight_decay, bc1, bc2,
         int(bnb), _stream(p)),
    )


adam8bit_step.launches = 0


# ---------------------------------------------------------------------------
# The optimizers
# ---------------------------------------------------------------------------

Q8_KEYS = ("m_q", "v_q")  # the int8 payloads of a parameter's state
LEAF_STATE = ("m_q", "m_scale", "v_q", "v_scale")  # adam8bit_step's state arguments, in order


def zero_state(p: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A parameter's fresh state: the count 0 and independent zero codes for
    m and v (payload 0, scale 0)."""
    nb = n_blocks(p.numel())
    return {
        "step": torch.zeros((), dtype=torch.float32),
        "m_q": torch.zeros((nb, BLOCK), dtype=torch.int8, device=p.device),
        "m_scale": torch.zeros(nb, dtype=torch.float32, device=p.device),
        "v_q": torch.zeros((nb, BLOCK), dtype=torch.int8, device=p.device),
        "v_scale": torch.zeros(nb, dtype=torch.float32, device=p.device),
    }


def _grads_of(params, grads: Optional[Dict[torch.Tensor, torch.Tensor]]):
    """(param, gradient) pairs: `grads[p]` when given (any float dtype, e.g.
    the trainer's bf16 gradient tree), else p.grad; parameters without a
    gradient are skipped."""
    for p in params:
        g = grads.get(p) if grads is not None else p.grad
        if g is not None:
            yield p, g


class AdamW8bit(torch.optim.Optimizer):
    """AdamW over blockwise int8 moments (`adamw_8bit_fused` with fused=True,
    `adamw_8bit_bnb` with fused=False). `step(grads=...)` takes a gradient
    tree of another dtype than the parameters (bf16 beside fp32 masters).
    The fused variant applies a non-finite step with zeroed gradients, as
    the reference's fused branch does (`applies_nonfinite_as_zero`)."""

    takes_grad_tree = True

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0,
                 fused: bool = True):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay))
        self.fused = fused
        self.applies_nonfinite_as_zero = fused

    def init_state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        """p's state before its first step (the step makes it when it finds
        none; `utils.init_optimizer_state` makes it ahead)."""
        return zero_state(p)

    @torch.no_grad()
    def step(self, closure=None, grads: Optional[Dict[torch.Tensor, torch.Tensor]] = None):
        if closure is not None:
            raise ValueError("AdamW8bit takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            corrections = {}  # count -> (bc1, bc2): once a group and count, not once a leaf
            for p, g in _grads_of(group["params"], grads):
                st = self.state[p]
                if not st:
                    st.update(self.init_state(p))
                st["step"] += 1
                count = int(st["step"])
                if count not in corrections:
                    corrections[count] = bias_corrections(b1, b2, count)
                bc1, bc2 = corrections[count]
                adam8bit_step(p, g.contiguous(), *(st[k] for k in LEAF_STATE), float(group["lr"]), b1, b2,
                              group["eps"], group["weight_decay"], bc1, bc2, bnb=not self.fused)

    def load_state_dict(self, state_dict) -> None:
        # torch casts every tensor of a floating-point parameter's state to
        # the parameter's dtype; the payloads go back to int8 (exactly: an
        # int8 value is exact in fp32)
        super().load_state_dict(state_dict)
        for st in self.state.values():
            for k in Q8_KEYS:
                if k in st:
                    st[k] = st[k].to(torch.int8)


class Lion(torch.optim.Optimizer):
    """optax.lion: u = sign((1 - b1) g + b1 m) (+ wd p), p -= lr u, then
    m = (1 - b2) g + b2 m, in the reference's dtypes (the products with g
    in g's dtype, the moment in the parameter's). Plain PyTorch."""

    takes_grad_tree = True
    applies_nonfinite_as_zero = False

    def __init__(self, params, lr: float, betas=(0.9, 0.99), weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), weight_decay=weight_decay))

    def init_state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        """p's state before its first step: the count 0 and a zero moment."""
        return {"step": torch.zeros((), dtype=torch.float32), "exp_avg": torch.zeros_like(p)}

    @torch.no_grad()
    def step(self, closure=None, grads: Optional[Dict[torch.Tensor, torch.Tensor]] = None):
        if closure is not None:
            raise ValueError("Lion takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            wd, lr = group["weight_decay"], float(group["lr"])
            for p, g in _grads_of(group["params"], grads):
                st = self.state[p]
                if not st:
                    st.update(self.init_state(p))
                m = st["exp_avg"]
                # a python scalar times a bf16 gradient is rounded to bf16
                # first in JAX (a weak type); torch would keep it in fp32
                c1, c2 = (torch.tensor(1.0 - b, dtype=g.dtype, device=g.device) for b in (b1, b2))
                u = torch.sign(c1 * g + b1 * m)
                if wd:
                    u = u + wd * p
                p.add_(torch.tensor(-lr, dtype=u.dtype, device=u.device) * u)
                m.copy_(c2 * g + b2 * m)
                st["step"] += 1


def state_bytes(optimizer: torch.optim.Optimizer) -> int:
    """Bytes of every tensor in the optimizer's state (the moments and,
    for the 8-bit variants, their scales)."""
    return sum(v.numel() * v.element_size() for st in optimizer.state.values() for v in st.values()
               if isinstance(v, torch.Tensor) and v.dim() > 0)
