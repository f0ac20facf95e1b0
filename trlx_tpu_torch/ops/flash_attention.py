"""Fused attention, forward and backward: the port of
trlx_tpu.ops.flash_attention.flash_attention and of its bias-carrying
variant, flash_attention_bias (T5's self-attention; end of this module).

`flash_attention` runs the hand-written Hopper kernels on CUDA tensors
and their plain PyTorch versions on CPU tensors:

- forward: `csrc/flash_fwd.cu` in two routes (`forward_route`): up to
  SHORT_FWD_MAX_LEN queries and keys one CTA per (batch row, head) holds
  the head's whole K/V; past that 64-row query tiles stream K/V tiles.
  Plain version `flash_attention_plain`;
- backward: `csrc/flash_bwd.cu` in two routes (`backward_route`): up to
  FUSED_BWD_MAX_LEN queries and keys (FUSED_BWD_MAX_LEN_D128 at D = 128)
  one fused kernel gives dq, dk and dv in one launch; past that the dq
  kernel, then the dk/dv kernel. Plain version
  `flash_attention_backward_plain`.

The kernels take head widths D = 64 (GPT-2, T5) and D = 128 (the Llama
family); the plain versions any D.

Both compute the same function:

- q [B, H, T, D]; k/v [B, Hkv, S, D] with Hkv | H (grouped-query
  attention: query head h reads kv head h // (H // Hkv), never repeated);
  key_mask [B, S] (1 = attendable slot).
- Causality compares PHYSICAL slots: query row t sits at slot
  q_offset + t, default q_offset = S - T (right-aligned queries, the
  teacher-forced layout); a KV-cache prefill passes its write index.
- Masked scores are replaced by the finite NEG_INF = -1e30, so a fully
  masked row (a left-pad query) averages v uniformly over all S slots
  instead of producing NaN.
- Optionally returns the per-row softmax stats (m, l), fp32 [B*H, T, 1].

With grad enabled and an input that requires grad, the call goes through
`_FlashAttentionFn`, the counterpart of the reference's `custom_vjp`: its
forward saves exactly (q, k, v, key_mask, out, m, l) and its backward
recomputes the probabilities from (q, k, m, l) as the reference's
`_flash_backward` does: p = exp(s - m) / max(l, 1e-30), so a fully masked
row keeps its uniform 1/l weights (they reach dv at every slot), while
ds = p (dp - delta) sm_scale is zeroed on masked pairs, so those rows add
nothing to dq or dk. dk and dv are summed over each GQA group. The plain
version takes the reference's delta = rowsum(dO * O); the kernels sum
delta = sum_j p dp from the p and dp that form ds, which is the same in
exact arithmetic and keeps each row's ds summing to zero in bf16 (see
`csrc/flash_bwd.cu`).

The kernels take any T and S (they mask the ragged edge themselves).
Without `causal` the query offset plays no part (a cross-attention with
T > S gives a negative default offset, which is then ignored).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from trlx_tpu_torch.ops._build import HEAD_DIMS
from trlx_tpu_torch.ops.remat import saved_attention

NEG_INF = -1e30


def _prepare(q, k, key_mask, sm_scale, q_offset, causal):
    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"n_head={H} not a multiple of n_kv_head={Hkv}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if not causal:
        q_offset = 0  # no causal window: the offset plays no part
    elif q_offset is None:
        q_offset = S - T
    if key_mask is None:
        key_mask = torch.ones((B, S), dtype=torch.int32, device=q.device)
    return key_mask, float(sm_scale), int(q_offset)


def _valid_pairs(key_mask, T, S, causal, q_offset, device):
    """[B, 1, 1, T, S] bool: the (query row, slot) pairs that attend."""
    valid = (key_mask > 0)[:, None, None, None, :]
    if causal:
        rows = torch.arange(T, device=device)[:, None] + q_offset
        valid = valid & (rows >= torch.arange(S, device=device)[None, :])
    return valid


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    q_offset: Optional[int] = None,
    with_stats: bool = False,
):
    """The forward kernel's function in plain PyTorch, computed in fp32
    (the oracle the kernel is held to, and the CPU path)."""
    key_mask, sm_scale, q_offset = _prepare(q, k, key_mask, sm_scale, q_offset, causal)
    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    rep = H // Hkv
    qf = q.float().reshape(B, Hkv, rep, T, D)
    s = torch.einsum("bgrtd,bgsd->bgrts", qf, k.float()) * sm_scale
    valid = _valid_pairs(key_mask, T, S, causal, q_offset, q.device)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bgrts,bgsd->bgrtd", p, v.float()) / torch.clamp(l, min=1e-30)
    out = o.reshape(B, H, T, D).to(q.dtype)
    if with_stats:
        return out, m.reshape(B * H, T, 1), l.reshape(B * H, T, 1)
    return out


def flash_attention_backward_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor,
    o: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    g: torch.Tensor,
    causal: bool,
    sm_scale: float,
    q_offset: int,
):
    """(dq, dk, dv) of the fused attention in plain PyTorch, computed in
    fp32 from the forward's residuals (out o and stats m, l) and the
    output gradient g: the backward kernels' oracle and the CPU path.
    Each gradient comes out in its input's dtype."""
    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    rep = H // Hkv
    qf = q.float().reshape(B, Hkv, rep, T, D)
    kf, vf = k.float(), v.float()
    gf = g.float().reshape(B, Hkv, rep, T, D)
    delta = (gf * o.float().reshape(B, Hkv, rep, T, D)).sum(dim=-1, keepdim=True)
    s = torch.einsum("bgrtd,bgsd->bgrts", qf, kf) * sm_scale
    valid = _valid_pairs(key_mask, T, S, causal, q_offset, q.device)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - m.float().reshape(B, Hkv, rep, T, 1)) / torch.clamp(
        l.float().reshape(B, Hkv, rep, T, 1), min=1e-30
    )
    dp = torch.einsum("bgrtd,bgsd->bgrts", gf, vf)
    ds = torch.where(valid, p * (dp - delta) * sm_scale, torch.zeros_like(p))
    dq = torch.einsum("bgrts,bgsd->bgrtd", ds, kf).reshape(B, H, T, D)
    dk = torch.einsum("bgrts,bgrtd->bgsd", ds, qf)
    dv = torch.einsum("bgrts,bgrtd->bgsd", p, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _check_cuda(name: str, x: torch.Tensor, device: torch.device, dtype, ndim: int):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} for the CUDA kernel, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(x.shape)}")


def _kernel_layout_ok(x: torch.Tensor) -> bool:
    """A contiguous last dim, row strides in whole 16-byte vectors and a
    16-byte aligned start: what the kernels' vector loads need."""
    return x.stride(-1) == 1 and not any(s % 8 for s in x.stride()[:3]) and x.data_ptr() % 16 == 0


KERNEL_HEAD_DIMS = HEAD_DIMS  # the head widths the flash kernels are built for (the bias ones: 64)


def _check_inputs(q, k, v, key_mask):
    """Validate the kernels' operands; returns the int32 key mask."""
    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    dev = q.device
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_cuda(name, x, dev, torch.bfloat16, 4)
        if not _kernel_layout_ok(x):
            raise ValueError(
                f"{name} needs a contiguous last dim, strides in multiples of 8 "
                f"elements and a 16-byte aligned start (strides {x.stride()})"
            )
    if tuple(k.shape) != (B, Hkv, S, D) or tuple(v.shape) != (B, Hkv, S, D):
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {D} unsupported by the CUDA kernels (built for {KERNEL_HEAD_DIMS})")
    if tuple(key_mask.shape) != (B, S) or key_mask.device != dev:
        raise ValueError(f"key_mask must be [B, S] = {(B, S)} on {dev}")
    return key_mask.to(torch.int32).contiguous()


def _launch(source: str, fn_name: str, argtypes, args) -> None:
    """Call the C entry `fn_name` of `csrc/<source>`; raise with the CUDA
    error string when the launch was refused."""
    from trlx_tpu_torch.ops import _build

    lib = _build.load(source)
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    rc = fn(*args)
    if rc != 0:
        err = getattr(lib, source.split(".")[0] + "_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{fn_name} kernel launch failed: {err(rc).decode()}")


def _strides(*tensors):
    return ctypes.cast(
        (ctypes.c_longlong * (3 * len(tensors)))(*(s for x in tensors for s in x.stride()[:3])),
        ctypes.c_void_p,
    )


def _bhtd_empty(B, H, T, D, like):
    """A [B, H, T, D] view of a [B, T, H, D] buffer, so `.transpose(1, 2)`
    of the result is contiguous (the layout of the projections)."""
    return torch.empty((B, T, H, D), dtype=like.dtype, device=like.device).transpose(1, 2)


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


SHORT_FWD_MAX_LEN = 128  # the longest T or S the short forward kernel takes


def forward_route(T: int, S: int, D: int = 64) -> str:
    """The CUDA forward's route for T queries and S keys of head width D:
    "short" (one CTA per (batch row, head) holding the head's whole K/V)
    when both are at most SHORT_FWD_MAX_LEN, at either width, else "long"
    (64-row query tiles streaming 64-slot K/V tiles)."""
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"no flash forward kernel takes head_dim {D}")
    return "short" if max(T, S) <= SHORT_FWD_MAX_LEN else "long"


def _forward_kernel(fn_name, q, k, v, km, causal, sm_scale, q_offset):
    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    out = _bhtd_empty(B, H, T, D, q)
    m = torch.empty((B * H, T, 1), dtype=torch.float32, device=q.device)
    l = torch.empty((B * H, T, 1), dtype=torch.float32, device=q.device)
    _launch(
        "flash_fwd.cu", fn_name,
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
        (q.data_ptr(), k.data_ptr(), v.data_ptr(), km.data_ptr(), out.data_ptr(),
         m.data_ptr(), l.data_ptr(), B, H, Hkv, T, S, D, _strides(q, k, v, out),
         int(causal), q_offset, sm_scale, _stream(q)),
    )
    return out, m, l


def flash_attention_fwd_short(q, k, v, km, causal, sm_scale, q_offset):
    """(out, m, l) by the short-route kernel of `csrc/flash_fwd.cu` (T, S
    <= 128) on operands `_check_inputs` validated: one CTA per (batch row,
    head), the head's K/V loaded once."""
    flash_attention_fwd_short.launches += 1
    return _forward_kernel("flash_fwd_short_bf16", q, k, v, km, causal, sm_scale, q_offset)


def flash_attention_fwd_long(q, k, v, km, causal, sm_scale, q_offset):
    """(out, m, l) by the long-route kernel of `csrc/flash_fwd.cu` (any T and
    S) on operands `_check_inputs` validated."""
    flash_attention_fwd_long.launches += 1
    return _forward_kernel("flash_fwd_bf16", q, k, v, km, causal, sm_scale, q_offset)


flash_attention_fwd_short.launches = 0
flash_attention_fwd_long.launches = 0


def flash_attention_fwd_short_occupancy(T: int, S: int, causal: bool, q_offset: int, D: int = 64) -> dict:
    """What a short-route launch at these lengths and head width gets on
    the current card: its threads a CTA, its dynamic shared memory and the
    CTAs an SM holds."""
    ctas, threads, smem = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    _launch(
        "flash_fwd.cu", "flash_fwd_short_occupancy",
        [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 3,
        (T, S, D, int(causal), q_offset, ctypes.byref(ctas), ctypes.byref(threads), ctypes.byref(smem)),
    )
    return {"ctas_per_sm": ctas.value, "threads": threads.value, "smem_bytes": smem.value}


def _flash_forward_cuda(q, k, v, key_mask, causal, sm_scale, q_offset):
    """The route `forward_route` names; neither gives way to the other."""
    km = _check_inputs(q, k, v, key_mask)
    flash_attention.launches += 1
    if forward_route(q.shape[2], k.shape[2], q.shape[3]) == "short":
        return flash_attention_fwd_short(q, k, v, km, causal, sm_scale, q_offset)
    return flash_attention_fwd_long(q, k, v, km, causal, sm_scale, q_offset)


def backward_operands(q, k, v, key_mask, g, m, l):
    """Check the backward kernels' operands and prepare them: returns
    (int32 key mask, dout in a layout the kernels read). The reference
    forms delta = rowsum(dO * O) outside its kernels from the bf16
    output; here the kernels sum delta = sum_j p dp from the same p and
    dp that form ds (equal in exact arithmetic, see `csrc/flash_bwd.cu`),
    so the forward's output is not read."""
    km = _check_inputs(q, k, v, key_mask)
    B, H, T, D = q.shape
    _check_cuda("dout", g, q.device, torch.bfloat16, 4)
    if tuple(g.shape) != (B, H, T, D):
        raise ValueError(f"dout shape {tuple(g.shape)} does not match q {tuple(q.shape)}")
    if not _kernel_layout_ok(g):
        g = g.contiguous()
    for name, x in (("m", m), ("l", l)):
        _check_cuda(name, x, q.device, torch.float32, 3)
        if not x.is_contiguous() or tuple(x.shape) != (B * H, T, 1):
            raise ValueError(f"{name} must be a contiguous fp32 [B*H, T, 1] tensor")
    return km, g


FUSED_BWD_MAX_LEN = 128  # the longest T or S the fused backward kernel takes at D = 64
FUSED_BWD_MAX_LEN_D128 = 112  # ... and at D = 128, where its tile at 128 passes the shared memory


def backward_route(T: int, S: int, D: int = 64) -> str:
    """The CUDA backward's route for T queries and S keys of head width D:
    "fused" (one kernel for dq, dk and dv) when both are at most
    FUSED_BWD_MAX_LEN (FUSED_BWD_MAX_LEN_D128 at D = 128), else "long" (the
    dq kernel, then the dk/dv kernel)."""
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"no flash backward kernel takes head_dim {D}")
    return "fused" if max(T, S) <= (FUSED_BWD_MAX_LEN if D == 64 else FUSED_BWD_MAX_LEN_D128) else "long"


def flash_attention_bwd(q, k, v, km, g, m, l, causal, sm_scale, q_offset):
    """(dq [B, H, T, D], dk, dv [B, Hkv, S, D]) by the fused kernel of
    `csrc/flash_bwd.cu` (T, S <= 128; 112 at D = 128), on the operands `backward_operands`
    prepared: one CTA per (batch row, kv head), walking the GQA group's
    heads in order. With more than one head a group, dk and dv are summed
    over it in fp32 scratch of this call (ceil16(S) x 2D for each CTA)."""
    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    dq = _bhtd_empty(B, H, T, D, q)
    dk = _bhtd_empty(B, Hkv, S, D, k)
    dv = _bhtd_empty(B, Hkv, S, D, v)
    part = None
    if H > Hkv:
        part = torch.empty(B * Hkv * (-(-S // 16) * 16) * 2 * D, dtype=torch.float32, device=q.device)
    flash_attention_bwd.launches += 1
    _launch(
        "flash_bwd.cu", "flash_bwd_fused_bf16",
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
        (q.data_ptr(), k.data_ptr(), v.data_ptr(), km.data_ptr(), g.data_ptr(), m.data_ptr(),
         l.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), None if part is None else part.data_ptr(),
         B, H, Hkv, T, S, D, _strides(q, k, v, g, dq, dk, dv), int(causal), q_offset, sm_scale, _stream(q)),
    )
    return dq, dk, dv


flash_attention_bwd.launches = 0


def flash_attention_bwd_occupancy(T: int, S: int, D: int = 64) -> dict:
    """What a fused backward launch at (T, S) and head width D gets on the
    current card: its threads a CTA, its dynamic shared memory and the CTAs
    an SM holds."""
    ctas, threads, smem = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    _launch(
        "flash_bwd.cu", "flash_bwd_fused_occupancy",
        [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 3,
        (T, S, D, ctypes.byref(ctas), ctypes.byref(threads), ctypes.byref(smem)),
    )
    return {"ctas_per_sm": ctas.value, "threads": threads.value, "smem_bytes": smem.value}


def flash_attention_dq(q, k, v, km, g, m, l, causal, sm_scale, q_offset):
    """The long route's first step: (dq [B, H, T, D], delta fp32 [B*H, T])
    by the dq kernel of `csrc/flash_bwd.cu`, on the operands
    `backward_operands` prepared; `flash_attention_dkv` reads the delta."""
    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    dq = _bhtd_empty(B, H, T, D, q)
    delta = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    flash_attention_dq.launches += 1
    _launch(
        "flash_bwd.cu", "flash_bwd_dq_bf16",
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
        (q.data_ptr(), k.data_ptr(), v.data_ptr(), km.data_ptr(), g.data_ptr(), m.data_ptr(),
         l.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H, Hkv, T, S, D,
         _strides(q, k, v, g, dq), int(causal), q_offset, sm_scale, _stream(q)),
    )
    return dq, delta


def flash_attention_dkv(q, k, v, km, g, m, l, delta, causal, sm_scale, q_offset):
    """The long route's second step: (dk, dv) [B, Hkv, S, D] by the dk/dv
    kernel of `csrc/flash_bwd.cu` (one launch at D = 64; at D = 128 one for
    dv, then one for dk), on the operands `backward_operands` prepared and
    the delta that `flash_attention_dq` wrote."""
    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    dk = _bhtd_empty(B, Hkv, S, D, k)
    dv = _bhtd_empty(B, Hkv, S, D, v)
    flash_attention_dkv.launches += 1
    _launch(
        "flash_bwd.cu", "flash_bwd_dkv_bf16",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
        (q.data_ptr(), k.data_ptr(), v.data_ptr(), km.data_ptr(), g.data_ptr(), m.data_ptr(),
         l.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, Hkv, T, S, D,
         _strides(q, k, v, g, dk, dv), int(causal), q_offset, sm_scale, _stream(q)),
    )
    return dk, dv


flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0


def flash_attention_backward(q, k, v, key_mask, o, m, l, g, causal, sm_scale, q_offset):
    """(dq, dk, dv) from the forward's residuals: on CPU tensors
    `flash_attention_backward_plain`; on CUDA tensors the kernels of the
    route `backward_route` picks (no atomics on either: the same result
    run to run), or an exception. Neither route gives way to the other.
    q/k/v/dout are bf16 there."""
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, key_mask, o, m, l, g, causal, sm_scale, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    km, g = backward_operands(q, k, v, key_mask, g, m, l)
    if backward_route(q.shape[2], k.shape[2], q.shape[3]) == "fused":
        return flash_attention_bwd(q, k, v, km, g, m, l, causal, sm_scale, q_offset)
    dq, delta = flash_attention_dq(q, k, v, km, g, m, l, causal, sm_scale, q_offset)
    dk, dv = flash_attention_dkv(q, k, v, km, g, m, l, delta, causal, sm_scale, q_offset)
    return dq, dk, dv


def _forward(q, k, v, key_mask, causal, sm_scale, q_offset):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, key_mask, causal, sm_scale, q_offset, with_stats=True)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    return _flash_forward_cuda(q, k, v, key_mask, causal, sm_scale, q_offset)


class _FlashAttentionFn(torch.autograd.Function):
    """The reference's `custom_vjp` pair (`_fwd` / `_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal, sm_scale, q_offset):
        # under remat "save_attn" a recompute reuses the forward's outputs
        out, m, l = saved_attention(lambda: _forward(q, k, v, key_mask, causal, sm_scale, q_offset))
        ctx.save_for_backward(q, k, v, key_mask, out, m, l)
        ctx.static = (causal, sm_scale, q_offset)
        ctx.mark_non_differentiable(m, l)
        return out, m, l

    @staticmethod
    def backward(ctx, g, _gm, _gl):
        q, k, v, key_mask, out, m, l = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, key_mask, out, m, l, g, *ctx.static)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    q_offset: Optional[int] = None,
    with_stats: bool = False,
):
    """Fused attention (see the module docstring for the contract),
    differentiable in q, k and v.

    On CPU tensors the plain versions run. On CUDA tensors the kernels
    launch or the call raises: q/k/v must be bf16 with a contiguous last
    dimension, D = 64 or 128, 16-byte aligned rows. q/k/v may be strided views
    (e.g. [B, T, H, D] projections transposed to [B, H, T, D]); `out` and
    the gradients come back as [B, H, T, D] views of [B, T, H, D] buffers,
    so `.transpose(1, 2)` of each is contiguous."""
    key_mask, sm_scale, q_offset = _prepare(q, k, key_mask, sm_scale, q_offset, causal)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        out, m, l = _FlashAttentionFn.apply(q, k, v, key_mask, causal, sm_scale, q_offset)
    else:
        out, m, l = _forward(q, k, v, key_mask, causal, sm_scale, q_offset)
    if with_stats:
        return out, m, l
    return out


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# The bias-carrying variant (T5's relative position bias)
#
# softmax(q k^T * sm_scale + bias, masked) v with a learned bias [H, T, S]
# shared by the batch and differentiable: the backward returns dbias, the
# sum over the batch of ds = d(score + bias). T5 semantics: sm_scale 1.0 by
# default, no GQA, and causality is TOP-LEFT (query row t sees slots
# j <= t, no offset), which agrees with the plain kernel's right-aligned
# rule only at T == S, the decoder's self-attention; the CUDA kernels
# therefore take `causal` only at T == S. Kernels: `csrc/flash_bias_fwd.cu`,
# whose forward has two routes (`bias_forward_route`): up to 128 queries
# and keys one CTA per (batch row, head) holds the head's K/V and bias tile,
# past that 64-row query tiles stream K/V tiles; and
# `csrc/flash_bias_bwd.cu`, whose backward has two routes
# (`bias_backward_route`): up to 128 queries and keys one fused kernel
# (dq, dk, dv and dbias in one launch), past that the dq + dbias kernels
# and then the dk/dv kernel. Plain versions `flash_attention_bias_plain`
# and `flash_attention_bias_backward_plain`, which keep the top-left rule
# at any shape. The plain backward takes the reference's delta =
# rowsum(dO * O); the kernels sum delta = sum_j p dp, as the plain
# variant's kernels do.
# ---------------------------------------------------------------------------


def _bias_valid_pairs(key_mask, T, S, causal, device):
    """[B, 1, T|1, S] bool: the (query row, slot) pairs that attend, with
    the bias variant's top-left causal rule."""
    valid = (key_mask > 0)[:, None, None, :]
    if causal:
        valid = valid & (torch.arange(T, device=device)[:, None] >= torch.arange(S, device=device)[None, :])
    return valid


def _bias_prepare(q, k, key_mask):
    B, H, T, D = q.shape
    if k.shape[1] != H:
        raise ValueError("flash_attention_bias does not support GQA")
    if key_mask is None:
        key_mask = torch.ones((B, k.shape[2]), dtype=torch.int32, device=q.device)
    return key_mask


def flash_attention_bias_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    bias: torch.Tensor,
    causal: bool = False,
    sm_scale: float = 1.0,
    with_stats: bool = False,
):
    """The bias forward kernel's function in plain PyTorch, computed in
    fp32: the kernel's oracle and the CPU path."""
    key_mask = _bias_prepare(q, k, key_mask)
    B, H, T, D = q.shape
    S = k.shape[2]
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) * sm_scale + bias.float()[None]
    s = torch.where(_bias_valid_pairs(key_mask, T, S, causal, q.device), s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhts,bhsd->bhtd", p, v.float()) / torch.clamp(l, min=1e-30)
    out = o.to(q.dtype)
    if with_stats:
        return out, m.reshape(B * H, T, 1), l.reshape(B * H, T, 1)
    return out


def flash_attention_bias_backward_plain(q, k, v, key_mask, bias, o, m, l, g, causal: bool, sm_scale: float):
    """(dq, dk, dv, dbias) of the bias variant in plain PyTorch, computed in
    fp32 from the forward's residuals, as the reference's
    `_flash_bias_backward`: delta = rowsum(dO * O), p = exp(s - m) /
    max(l, 1e-30), ds = p (dp - delta) on valid pairs, dbias = sum_b ds.
    Each gradient comes out in its input's dtype."""
    B, H, T, D = q.shape
    S = k.shape[2]
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    delta = (gf * o.float()).sum(dim=-1, keepdim=True)
    s = torch.einsum("bhtd,bhsd->bhts", qf, kf) * sm_scale + bias.float()[None]
    valid = _bias_valid_pairs(key_mask, T, S, causal, q.device)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - m.float().reshape(B, H, T, 1)) / torch.clamp(l.float().reshape(B, H, T, 1), min=1e-30)
    dp = torch.einsum("bhtd,bhsd->bhts", gf, vf)
    ds = torch.where(valid, p * (dp - delta), torch.zeros_like(p))
    dq = torch.einsum("bhts,bhsd->bhtd", ds, kf) * sm_scale
    dk = torch.einsum("bhts,bhtd->bhsd", ds, qf) * sm_scale
    dv = torch.einsum("bhts,bhtd->bhsd", p, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds.sum(dim=0).to(bias.dtype)


def _check_top_left(T: int, S: int, causal: bool) -> None:
    if causal and T != S:
        raise ValueError(f"the bias kernels' causal rule is top-left and needs T == S (got T={T}, S={S})")


def _check_bias(q, k, bias, causal):
    """Validate what the bias kernels take beyond `_check_inputs`' operands;
    returns the bias as a contiguous fp32 [H, T, S]."""
    B, H, T, D = q.shape
    S = k.shape[2]
    if k.shape[1] != H:
        raise ValueError("flash_attention_bias does not support GQA")
    if D != 64:
        raise ValueError(f"head_dim {D} unsupported by the bias kernels (built for T5's 64)")
    _check_top_left(T, S, causal)
    _check_cuda("bias", bias, q.device, torch.float32, 3)
    if tuple(bias.shape) != (H, T, S):
        raise ValueError(f"bias must be [H, T, S] = {(H, T, S)}, got {tuple(bias.shape)}")
    return bias.contiguous()


SHORT_BIAS_FWD_MAX_LEN = 128  # the longest T or S the short bias forward kernel takes


def bias_forward_route(T: int, S: int) -> str:
    """The CUDA bias forward's route for T queries and S keys: "short" (one
    CTA per (batch row, head) holding the head's whole K/V and bias tile)
    when both are at most SHORT_BIAS_FWD_MAX_LEN, else "long" (64-row query
    tiles streaming 64-slot K/V tiles)."""
    return "short" if max(T, S) <= SHORT_BIAS_FWD_MAX_LEN else "long"


def _bias_forward_kernel(fn_name, q, k, v, km, bias, causal, sm_scale):
    B, H, T, D = q.shape
    S = k.shape[2]
    out = _bhtd_empty(B, H, T, D, q)
    m = torch.empty((B * H, T, 1), dtype=torch.float32, device=q.device)
    l = torch.empty((B * H, T, 1), dtype=torch.float32, device=q.device)
    _launch(
        "flash_bias_fwd.cu", fn_name,
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
        (q.data_ptr(), k.data_ptr(), v.data_ptr(), km.data_ptr(), bias.data_ptr(), out.data_ptr(),
         m.data_ptr(), l.data_ptr(), B, H, T, S, D, _strides(q, k, v, out), int(causal),
         sm_scale, _stream(q)),
    )
    return out, m, l


def flash_attention_bias_fwd_short(q, k, v, km, bias, causal, sm_scale):
    """(out, m, l) by the short-route kernel of `csrc/flash_bias_fwd.cu` (T,
    S <= 128) on operands `_check_inputs` and `_check_bias` validated: one
    CTA per (batch row, head), the head's K/V and bias tile loaded once."""
    flash_attention_bias_fwd_short.launches += 1
    return _bias_forward_kernel("flash_bias_fwd_short_bf16", q, k, v, km, bias, causal, sm_scale)


def flash_attention_bias_fwd_long(q, k, v, km, bias, causal, sm_scale):
    """(out, m, l) by the long-route kernel of `csrc/flash_bias_fwd.cu` (any
    T and S) on operands `_check_inputs` and `_check_bias` validated."""
    flash_attention_bias_fwd_long.launches += 1
    return _bias_forward_kernel("flash_bias_fwd_bf16", q, k, v, km, bias, causal, sm_scale)


flash_attention_bias_fwd_short.launches = 0
flash_attention_bias_fwd_long.launches = 0


def flash_bias_fwd_short_occupancy(T: int, S: int, causal: bool) -> dict:
    """What a short-route bias forward launch at these lengths gets on the
    current card: its threads a CTA, its dynamic shared memory and the
    CTAs an SM holds."""
    ctas, threads, smem = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    _launch(
        "flash_bias_fwd.cu", "flash_bias_fwd_short_occupancy",
        [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 3,
        (T, S, int(causal), ctypes.byref(ctas), ctypes.byref(threads), ctypes.byref(smem)),
    )
    return {"ctas_per_sm": ctas.value, "threads": threads.value, "smem_bytes": smem.value}


def _flash_bias_forward_cuda(q, k, v, key_mask, bias, causal, sm_scale):
    """The route `bias_forward_route` names; neither gives way to the other."""
    km = _check_inputs(q, k, v, key_mask)
    bias = _check_bias(q, k, bias, causal)
    flash_attention_bias.launches += 1
    if bias_forward_route(q.shape[2], k.shape[2]) == "short":
        return flash_attention_bias_fwd_short(q, k, v, km, bias, causal, sm_scale)
    return flash_attention_bias_fwd_long(q, k, v, km, bias, causal, sm_scale)


FUSED_BIAS_BWD_MAX_LEN = 128  # the longest T or S the fused backward kernel takes


def bias_backward_route(T: int, S: int, causal: bool) -> str:
    """The CUDA bias backward's route for T queries and S keys: "fused"
    (one kernel) when both are at most FUSED_BIAS_BWD_MAX_LEN, else "long"
    (the dq + dbias kernels, then the dk/dv kernel). Raises ValueError for
    a causal call with T != S, which neither route takes."""
    _check_top_left(T, S, causal)
    return "fused" if max(T, S) <= FUSED_BIAS_BWD_MAX_LEN else "long"


# (device index, stream) -> the fused kernel's int32 arrival counters, one a
# head: zeroed here once, and left zeroed by every launch. Device state of
# the process, as the loaded kernel libraries are; keyed by stream because
# launches that share counters must run in order.
_BIAS_ARRIVALS = {}


def _bias_arrivals(device: torch.device, H: int) -> torch.Tensor:
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _BIAS_ARRIVALS.get(key)
    if buf is None or buf.numel() < H:
        buf = torch.zeros(H, dtype=torch.int32, device=device)
        _BIAS_ARRIVALS[key] = buf
    return buf


def flash_attention_bias_bwd(q, k, v, km, bias, g, m, l, causal, sm_scale):
    """(dq, dk, dv, dbias fp32 [H, T, S]) by the fused kernel of
    `csrc/flash_bias_bwd.cu` (T, S <= 128), on operands `backward_operands`
    and `_check_bias` prepared: one CTA per (batch row, head); the last CTA
    of each head to finish sums the per-batch ds partials (fp32 scratch of
    this call, ceil16(T) x ceil16(S) for each (batch row, head)) over the
    batch in order."""
    B, H, T, D = q.shape
    S = k.shape[2]
    dq = _bhtd_empty(B, H, T, D, q)
    dk = _bhtd_empty(B, H, S, D, k)
    dv = _bhtd_empty(B, H, S, D, v)
    ds_part = torch.empty(B * H * (-(-T // 16) * 16) * (-(-S // 16) * 16), dtype=torch.float32, device=q.device)
    dbias = torch.empty((H, T, S), dtype=torch.float32, device=q.device)
    arrivals = _bias_arrivals(q.device, H)
    flash_attention_bias_bwd.launches += 1
    _launch(
        "flash_bias_bwd.cu", "flash_bias_bwd_fused_bf16",
        [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
        (q.data_ptr(), k.data_ptr(), v.data_ptr(), km.data_ptr(), bias.data_ptr(), g.data_ptr(),
         m.data_ptr(), l.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ds_part.data_ptr(),
         dbias.data_ptr(), arrivals.data_ptr(), B, H, T, S, D, _strides(q, k, v, g, dq, dk, dv),
         int(causal), sm_scale, _stream(q)),
    )
    return dq, dk, dv, dbias


flash_attention_bias_bwd.launches = 0


def flash_attention_bias_bwd_occupancy(T: int, S: int) -> dict:
    """What a fused backward launch at (T, S) gets on the current card: its
    threads a CTA, its dynamic shared memory and the CTAs an SM holds."""
    ctas, threads, smem = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    _launch(
        "flash_bias_bwd.cu", "flash_bias_bwd_fused_occupancy",
        [ctypes.c_int, ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3,
        (T, S, ctypes.byref(ctas), ctypes.byref(threads), ctypes.byref(smem)),
    )
    return {"ctas_per_sm": ctas.value, "threads": threads.value, "smem_bytes": smem.value}


def flash_attention_bias_dq(q, k, v, km, bias, g, m, l, causal, sm_scale):
    """The long route's first step: (dq [B, H, T, D], dbias [H, T, S]
    fp32, delta fp32 [B*H, T]) by the dq kernel and the dbias reduce
    kernel of `csrc/flash_bias_bwd.cu`, on operands `backward_operands`
    and `_check_bias` prepared; `flash_attention_bias_dkv` reads the
    delta. The per-batch ds partial [B, H, T, S] fp32 is scratch of this
    call."""
    B, H, T, D = q.shape
    S = k.shape[2]
    dq = _bhtd_empty(B, H, T, D, q)
    delta = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    ds_part = torch.empty((B, H, T, S), dtype=torch.float32, device=q.device)
    dbias = torch.empty((H, T, S), dtype=torch.float32, device=q.device)
    flash_attention_bias_dq.launches += 1
    _launch(
        "flash_bias_bwd.cu", "flash_bias_bwd_dq_bf16",
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
        (q.data_ptr(), k.data_ptr(), v.data_ptr(), km.data_ptr(), bias.data_ptr(), g.data_ptr(),
         m.data_ptr(), l.data_ptr(), delta.data_ptr(), dq.data_ptr(), ds_part.data_ptr(),
         dbias.data_ptr(), B, H, T, S, D, _strides(q, k, v, g, dq), int(causal), sm_scale,
         _stream(q)),
    )
    return dq, dbias, delta


def flash_attention_bias_dkv(q, k, v, km, bias, g, m, l, delta, causal, sm_scale):
    """The long route's second step: (dk, dv) [B, H, S, D] by the dk/dv
    kernel of `csrc/flash_bias_bwd.cu`, on the prepared operands and the
    delta `flash_attention_bias_dq` wrote."""
    B, H, T, D = q.shape
    S = k.shape[2]
    dk = _bhtd_empty(B, H, S, D, k)
    dv = _bhtd_empty(B, H, S, D, v)
    flash_attention_bias_dkv.launches += 1
    _launch(
        "flash_bias_bwd.cu", "flash_bias_bwd_dkv_bf16",
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
        (q.data_ptr(), k.data_ptr(), v.data_ptr(), km.data_ptr(), bias.data_ptr(), g.data_ptr(),
         m.data_ptr(), l.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
         B, H, T, S, D, _strides(q, k, v, g, dk, dv), int(causal), sm_scale, _stream(q)),
    )
    return dk, dv


flash_attention_bias_dq.launches = 0
flash_attention_bias_dkv.launches = 0


def flash_attention_bias_backward(q, k, v, key_mask, bias, o, m, l, g, causal, sm_scale):
    """(dq, dk, dv, dbias) from the forward's residuals: on CPU tensors
    `flash_attention_bias_backward_plain`; on CUDA tensors the kernels of
    the route `bias_backward_route` picks (no float atomics on either: the
    same result run to run), or an exception. Neither route gives way to
    the other."""
    if q.device.type == "cpu":
        return flash_attention_bias_backward_plain(q, k, v, key_mask, bias, o, m, l, g, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bias runs on cpu or cuda, not {q.device}")
    route = bias_backward_route(q.shape[2], k.shape[2], causal)
    km, g = backward_operands(q, k, v, key_mask, g, m, l)
    bias32 = _check_bias(q, k, bias, causal)
    if route == "fused":
        dq, dk, dv, dbias = flash_attention_bias_bwd(q, k, v, km, bias32, g, m, l, causal, sm_scale)
    else:
        dq, dbias, delta = flash_attention_bias_dq(q, k, v, km, bias32, g, m, l, causal, sm_scale)
        dk, dv = flash_attention_bias_dkv(q, k, v, km, bias32, g, m, l, delta, causal, sm_scale)
    return dq, dk, dv, dbias.to(bias.dtype)


def _bias_forward(q, k, v, key_mask, bias, causal, sm_scale):
    if q.device.type == "cpu":
        return flash_attention_bias_plain(q, k, v, key_mask, bias, causal, sm_scale, with_stats=True)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bias runs on cpu or cuda, not {q.device}")
    return _flash_bias_forward_cuda(q, k, v, key_mask, bias, causal, sm_scale)


class _FlashBiasAttentionFn(torch.autograd.Function):
    """The reference's `custom_vjp` pair (`_bias_fwd` / `_bias_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, bias, causal, sm_scale):
        out, m, l = saved_attention(lambda: _bias_forward(q, k, v, key_mask, bias, causal, sm_scale))
        ctx.save_for_backward(q, k, v, key_mask, bias, out, m, l)
        ctx.static = (causal, sm_scale)
        ctx.mark_non_differentiable(m, l)
        return out, m, l

    @staticmethod
    def backward(ctx, g, _gm, _gl):
        q, k, v, key_mask, bias, out, m, l = ctx.saved_tensors
        dq, dk, dv, dbias = flash_attention_bias_backward(q, k, v, key_mask, bias, out, m, l, g, *ctx.static)
        return dq, dk, dv, None, dbias, None, None


def flash_attention_bias(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    bias: torch.Tensor,
    causal: bool = False,
    sm_scale: float = 1.0,
    with_stats: bool = False,
):
    """Fused attention with a learned additive bias [H, T, S] (see the
    section comment above), differentiable in q, k, v and the bias. On CPU
    tensors the plain versions run; on CUDA tensors the kernels launch or
    the call raises (q/k/v bf16 with D = 64 under `flash_attention`'s
    layout rules, the bias fp32 [H, T, S], T == S when causal)."""
    key_mask = _bias_prepare(q, k, key_mask)
    sm_scale = float(sm_scale)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v, bias)):
        out, m, l = _FlashBiasAttentionFn.apply(q, k, v, key_mask, bias, causal, sm_scale)
    else:
        out, m, l = _bias_forward(q, k, v, key_mask, bias, causal, sm_scale)
    if with_stats:
        return out, m, l
    return out


flash_attention_bias.launches = 0
