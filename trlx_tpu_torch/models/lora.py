"""LoRA: low-rank adapters on the projections of the port's models (the
port of trlx_tpu.models.lora).

The reference stacks one (A, B) pair per stacked kernel, {path: {"a": [L,
in, r], "b": [L, r, out]}}, and merges `W + scaling * A @ B` into the base
weights inside jit. Here each adapted projection (`QDense` of
`models/transformer.py`, `Dense` of `models/seq2seq.py`) gets its own
`LoRAPair` with `a` [in, r] and `b` [r, out], held in a module tree of the
wrapper (`lora.blocks.{i}.attn.q.a`, beside `base.blocks.{i}.attn.q.kernel`),
and the projection keeps a reference to it outside its own parameters.

Which form runs where:
- Teacher-forced and train passes run the adapter unmerged inside the
  projection: `x W + scaling * (x A) B`, the products in the compute dtype,
  which is the form HF peft computes. No full-size weight is made a layer
  a forward, and the base weight gets no gradient.
- The samplers (`generate`, `generate_seq2seq`, the decode engine) merge
  once a call: `models/generation.py::cast_params_for_decode` builds the
  compute-dtype copy they read from `W + scaling * (A @ B)` (fp32), as the
  reference merges before its sampler, and drops it after the call.
The two forms differ by rounding only (ROADMAP queue 3).

Targets keep the reference's names: a regex is matched against the
reference's param path (`blocks/attn/q/kernel`, `blocks/mlp/fc_in/kernel`,
`decoder/blocks/cross_attn/o/kernel`, ...), and a list of HF module names
("q_proj", "c_attn", "fc_in", ...) against the module's own name, as
`trlx_tpu.models.lora._target_match` does. An adapter on `lm_head` raises
(ROADMAP queue 7).
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

# (path regex, n leading stack dims, n input dims, n output dims): the
# reference's table; the port's projections are already [in, out]
_SPLITS: List[Tuple[str, int, int, int]] = [
    (r"blocks/(self_|cross_)?attn/[qkv]/kernel$", 1, 1, 2),  # [L, E, H, D]
    (r"blocks/(self_|cross_)?attn/o/kernel$", 1, 2, 1),  # [L, H, D, E]
    (r"blocks/mlp/fc_(in|gate|out)/kernel$", 1, 1, 1),  # [L, in, out]
    (r"lm_head/kernel$", 0, 1, 1),  # [E, V]
]

DEFAULT_TARGETS = (
    r"blocks/(self_|cross_)?attn/[qkv]/kernel$"
    r"|blocks/(self_|cross_)?attn/o/kernel$"
)

_ALIASES = {"q_proj": "q", "k_proj": "k", "v_proj": "v", "o_proj": "o", "c_attn": "q", "out_proj": "o"}


class LoRAPair(nn.Module):
    """One projection's adapter: `a` [in, r], `b` [r, out] (param dtype),
    `scaling` = alpha / r. `enabled` off (`adapters_disabled`) makes the
    projection the plain base."""

    def __init__(self, d_in: int, d_out: int, r: int, scaling: float, dtype, device=None):
        super().__init__()
        self.a = nn.Parameter(torch.zeros(d_in, r, dtype=dtype, device=device))
        self.b = nn.Parameter(torch.zeros(r, d_out, dtype=dtype, device=device))
        self.scaling = float(scaling)
        self.enabled = True

    def delta(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """scaling * (x A) B in `dtype` (the unmerged form)."""
        return torch.matmul(torch.matmul(x.to(dtype), self.a.to(dtype)), self.b.to(dtype)) * self.scaling

    @torch.no_grad()
    def merged(self, kernel: torch.Tensor) -> torch.Tensor:
        """W + scaling * (A @ B), in W's dtype (the merged form)."""
        return kernel + (torch.matmul(self.a.float(), self.b.float()) * self.scaling).to(kernel.dtype)


def adapter_of(module: nn.Module) -> Optional[LoRAPair]:
    """The active LoRA pair of a projection, or None."""
    pair = module.__dict__.get("lora")
    return pair if pair is not None and pair.enabled else None


def reference_path(name: str) -> Tuple[str, Optional[int]]:
    """The reference's param path of a projection's kernel and its layer:
    "decoder.blocks.3.cross_attn.q" -> ("decoder/blocks/cross_attn/q/kernel", 3)."""
    parts = name.split(".")
    layer = None
    if "blocks" in parts:
        i = parts.index("blocks")
        layer = int(parts[i + 1])
        parts = parts[: i + 1] + parts[i + 2:]
    return "/".join(parts + ["kernel"]), layer


def port_module_name(path: str, layer: Optional[int]) -> str:
    """The inverse of `reference_path`."""
    parts = path.split("/")[:-1]
    if layer is not None:
        i = parts.index("blocks")
        parts = parts[: i + 1] + [str(layer)] + parts[i + 1:]
    return ".".join(parts)


def _split_for(path: str):
    for pattern, n_stack, n_in, n_out in _SPLITS:
        if re.search(pattern, path):
            return n_stack, n_in, n_out
    return None


def target_match(path: str, targets) -> bool:
    """The reference's `_target_match`: a regex searched in the path, or a
    list of module names (HF aliases mapped) compared with its module."""
    if isinstance(targets, str):
        return re.search(targets, path) is not None
    leaf = path.split("/")[-2] if "/" in path else path
    return leaf in {_ALIASES.get(t, t) for t in targets}


def projections(base: nn.Module) -> Iterator[Tuple[str, nn.Module]]:
    """(name, module) of every projection of `base` that can carry a pair:
    the modules with a `kernel` [in, out]."""
    for name, module in base.named_modules():
        if name and isinstance(getattr(module, "kernel", None), nn.Parameter):
            yield name, module


def build_lora(base: nn.Module, r: int, alpha: float, targets=DEFAULT_TARGETS) -> nn.Module:
    """A module tree of zero `LoRAPair`s, one per targeted projection of
    `base`, named as the projections are (`blocks.0.attn.q`), each attached
    to its projection. Raises when nothing matches, as the reference does."""
    root = nn.Module()
    scaling = alpha / r
    for name, module in projections(base):
        path, _ = reference_path(name)
        if _split_for(path) is None or not target_match(path, targets):
            continue
        if path.startswith("lm_head"):
            raise NotImplementedError("a LoRA adapter on lm_head is not ported yet (ROADMAP queue 7)")
        d_in, d_out = module.kernel.shape
        pair = LoRAPair(d_in, d_out, r, scaling, module.kernel.dtype, module.kernel.device)
        parent = root
        *stems, leaf = name.split(".")
        for stem in stems:
            if not hasattr(parent, stem):
                parent.add_module(stem, nn.Module())
            parent = getattr(parent, stem)
        parent.add_module(leaf, pair)
        module.__dict__["lora"] = pair  # a reference outside the projection's own parameters
    if not any(isinstance(m, LoRAPair) for m in root.modules()):
        raise ValueError(f"no LoRA targets matched {targets!r}")
    return root


def pairs(lora: nn.Module) -> Iterator[Tuple[str, LoRAPair]]:
    """(projection name, pair) of every pair in a `build_lora` tree."""
    for name, module in lora.named_modules():
        if isinstance(module, LoRAPair):
            yield name, module


@torch.no_grad()
def init_lora(lora: nn.Module, generator: torch.Generator) -> None:
    """A ~ N(0, 0.02), B = 0, so the adapter starts as a no-op (the
    reference's init), drawn in module order from a CPU `generator`."""
    for _, pair in pairs(lora):
        pair.a.copy_(torch.randn(pair.a.shape, generator=generator, dtype=torch.float32) * 0.02)
        pair.b.zero_()


@contextlib.contextmanager
def adapters_disabled(module: nn.Module):
    """Run `module` as the plain base: every LoRA pair its projections hold
    is off inside the block (the reference model of a LoRA run)."""
    held = [p for m in module.modules() if (p := m.__dict__.get("lora")) is not None]
    states = [p.enabled for p in held]
    for p in held:
        p.enabled = False
    try:
        yield
    finally:
        for p, s in zip(held, states):
            p.enabled = s


def fp32_tensor(x) -> torch.Tensor:
    """An fp32 CPU tensor of its own from a tensor or an array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().clone()
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def lora_state_dict_from_stacked(lora: Dict, prefix: str = "lora") -> Dict[str, torch.Tensor]:
    """The port's per-layer pair tensors from the reference's stacked
    {path: {"a": [L?, in, r], "b": [L?, r, out]}} (numpy or torch)."""
    out = {}
    for path, ab in lora.items():
        a, b = fp32_tensor(ab["a"]), fp32_tensor(ab["b"])
        split = _split_for(path)
        if split is None:
            raise ValueError(f"no LoRA layout for {path!r}")
        if split[0] == 0:
            raise NotImplementedError("a LoRA adapter on lm_head is not ported yet (ROADMAP queue 7)")
        for i in range(a.shape[0]):
            name = port_module_name(path, i)
            out[f"{prefix}.{name}.a"] = a[i].clone()
            out[f"{prefix}.{name}.b"] = b[i].clone()
    return out


def stacked_from_lora(lora: nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
    """The reference's stacked {path: {"a", "b"}} from a `build_lora` tree
    (fp32 CPU tensors)."""
    by_path: Dict[str, Dict[int, LoRAPair]] = {}
    for name, pair in pairs(lora):
        path, layer = reference_path(name)
        by_path.setdefault(path, {})[layer] = pair
    out = {}
    for path, layers in by_path.items():
        order = sorted(layers)
        out[path] = {side: torch.stack([getattr(layers[i], side).detach().float().cpu() for i in order])
                     for side in ("a", "b")}
    return out
