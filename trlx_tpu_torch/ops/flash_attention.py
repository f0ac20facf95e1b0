"""Fused causal attention forward: the port of
trlx_tpu.ops.flash_attention.flash_attention (forward only).

`flash_attention` runs the hand-written Hopper kernel `csrc/flash_fwd.cu`
on CUDA tensors and its plain PyTorch version, `flash_attention_plain`,
on CPU tensors. Both compute the same function:

- q [B, H, T, D]; k/v [B, Hkv, S, D] with Hkv | H (grouped-query
  attention: query head h reads kv head h // (H // Hkv), never repeated);
  key_mask [B, S] (1 = attendable slot).
- Causality compares PHYSICAL slots: query row t sits at slot
  q_offset + t, default q_offset = S - T (right-aligned queries, the
  teacher-forced layout); a KV-cache prefill passes its write index.
- Masked scores are replaced by the finite NEG_INF = -1e30, so a fully
  masked row (a left-pad query) averages v uniformly over all S slots
  instead of producing NaN.
- Optionally returns the per-row softmax stats (m, l), fp32
  [B*H, T, 1], which the backward of the training slice consumes.

The kernel takes any T and S (it masks the ragged edge itself); it has
no backward yet, so it refuses inputs that require grad.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

NEG_INF = -1e30


def _prepare(q, k, key_mask, sm_scale, q_offset):
    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"n_head={H} not a multiple of n_kv_head={Hkv}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if q_offset is None:
        q_offset = S - T
    if key_mask is None:
        key_mask = torch.ones((B, S), dtype=torch.int32, device=q.device)
    return key_mask, float(sm_scale), int(q_offset)


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
    """The kernel's function in plain PyTorch, computed in fp32 (the
    oracle the kernel is held to, and the CPU path)."""
    key_mask, sm_scale, q_offset = _prepare(q, k, key_mask, sm_scale, q_offset)
    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    rep = H // Hkv
    qf = q.float().reshape(B, Hkv, rep, T, D)
    s = torch.einsum("bgrtd,bgsd->bgrts", qf, k.float()) * sm_scale
    valid = (key_mask > 0)[:, None, None, None, :]
    if causal:
        rows = torch.arange(T, device=q.device)[:, None] + q_offset
        valid = valid & (rows >= torch.arange(S, device=q.device)[None, :])
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bgrts,bgsd->bgrtd", p, v.float()) / torch.clamp(l, min=1e-30)
    out = o.reshape(B, H, T, D).to(q.dtype)
    if with_stats:
        return out, m.reshape(B * H, T, 1), l.reshape(B * H, T, 1)
    return out


def _check_cuda(name: str, x: torch.Tensor, device: torch.device, dtype, ndim: int):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} for the CUDA kernel, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(x.shape)}")


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
    """Fused attention (see the module docstring for the contract).

    On CPU tensors this is `flash_attention_plain`. On CUDA tensors it
    launches `csrc/flash_fwd.cu` or raises: q/k/v must be bf16 with a
    contiguous last dimension, D = 64, 16-byte aligned rows.
    q/k/v may be strided views (e.g. a [B, S, Hkv, D] cache slice
    transposed to [B, Hkv, S, D]); `out` is returned as a [B, H, T, D]
    view of a buffer laid out [B, T, H, D], so `out.transpose(1, 2)` is
    contiguous."""
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, key_mask, causal, sm_scale, q_offset, with_stats
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "the CUDA flash-attention kernel has no backward yet; run the "
            "forward under torch.no_grad()"
        )
    key_mask, sm_scale, q_offset = _prepare(q, k, key_mask, sm_scale, q_offset)
    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    dev = q.device
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_cuda(name, x, dev, torch.bfloat16, 4)
        if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(
                f"{name} needs a contiguous last dim, strides in multiples of 8 "
                f"elements and a 16-byte aligned start (strides {x.stride()})"
            )
    if tuple(k.shape) != (B, Hkv, S, D) or tuple(v.shape) != (B, Hkv, S, D):
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if D != 64:
        raise ValueError(f"head_dim {D} unsupported by the CUDA kernel (built for 64)")
    if tuple(key_mask.shape) != (B, S) or key_mask.device != dev:
        raise ValueError(f"key_mask must be [B, S] = {(B, S)} on {dev}")
    km = key_mask.to(torch.int32).contiguous()
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=dev).transpose(1, 2)
    m = torch.empty((B * H, T, 1), dtype=torch.float32, device=dev)
    l = torch.empty((B * H, T, 1), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    from trlx_tpu_torch.ops import _build

    lib = _build.load("flash_fwd.cu")
    fn = lib.flash_fwd_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    )
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), km.data_ptr(), out.data_ptr(),
        m.data_ptr(), l.data_ptr(), B, H, Hkv, T, S, D, ctypes.cast(strides, ctypes.c_void_p),
        int(causal), q_offset, sm_scale, torch.cuda.current_stream(dev).cuda_stream,
    )
    flash_attention.launches += 1
    if rc != 0:
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
        lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
        raise RuntimeError(
            f"flash_fwd kernel launch failed: {lib.flash_fwd_error_string(rc).decode()}"
        )
    if with_stats:
        return out, m, l
    return out


flash_attention.launches = 0
