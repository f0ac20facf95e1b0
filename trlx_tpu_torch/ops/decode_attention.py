"""One decode step of attention over the stacked int8 KV cache: the port
of trlx_tpu.ops.decode_attention.decode_attention_int8.

`decode_attention_int8` runs the hand-written Hopper kernel
`csrc/decode_int8.cu` on CUDA tensors and `decode_attention_int8_plain`
on CPU tensors. The function, for one layer `layer_ix` of the cache:

- q [B, H, D]; ck/cv [L, B, Hkv, S, D] int8 (the full stacked cache — the
  layer is an index, so no per-layer copy is made); k_scale
  [L, B, Hkv, 1, S] fp32 per-slot K scales; v_scale [B, Hkv, 1, D] fp32
  per-channel V scales of this layer; key_mask [B, S].
- scores = (q . k_int8) * (k_scale * sm_scale), NEG_INF = -1e30 where
  key_mask == 0; softmax in fp32; out = (p . v_int8) / max(l, 1e-30) *
  v_scale, in q.dtype, [B, H, D].

Query head h reads kv head h // (H // Hkv). Any cache length S works.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30


def decode_attention_int8_plain(
    q: torch.Tensor,
    ck: torch.Tensor,
    cv: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    key_mask: torch.Tensor,
    layer_ix: int,
    sm_scale: float,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, computed in fp32."""
    L, B, Hkv, S, D = ck.shape
    H = q.shape[1]
    if H % Hkv:
        raise ValueError(f"n_head={H} not a multiple of n_kv_head={Hkv}")
    qg = q.float().reshape(B, Hkv, H // Hkv, D)
    s = torch.einsum("bgrd,bgsd->bgrs", qg, ck[layer_ix].float())
    s = s * (k_scale[layer_ix].float() * sm_scale)  # [B, Hkv, 1, S] broadcast
    s = torch.where((key_mask > 0)[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bgrs,bgsd->bgrd", p, cv[layer_ix].float())
    o = o / torch.clamp(l, min=1e-30) * v_scale.float()
    return o.reshape(B, H, D).to(q.dtype)


def decode_attention_int8(
    q: torch.Tensor,
    ck: torch.Tensor,
    cv: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    key_mask: torch.Tensor,
    layer_ix: int,
    sm_scale: float,
) -> torch.Tensor:
    """One decode step's attention for one layer of the stacked cache
    (see the module docstring). CPU tensors take the plain version; CUDA
    tensors launch `csrc/decode_int8.cu` or raise: q bf16, all operands
    contiguous, D = 64, H // Hkv in {1, 3}."""
    if q.device.type == "cpu":
        return decode_attention_int8_plain(
            q, ck, cv, k_scale, v_scale, key_mask, layer_ix, sm_scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_int8 runs on cpu or cuda, not {q.device}")
    L, B, Hkv, S, D = ck.shape
    H = q.shape[1]
    dev = q.device
    expect = {
        "q": (q, torch.bfloat16, (B, H, D)),
        "ck": (ck, torch.int8, (L, B, Hkv, S, D)),
        "cv": (cv, torch.int8, (L, B, Hkv, S, D)),
        "k_scale": (k_scale, torch.float32, (L, B, Hkv, 1, S)),
        "v_scale": (v_scale, torch.float32, (B, Hkv, 1, D)),
    }
    for name, (x, dtype, shape) in expect.items():
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {dev}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}"
            )
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if H % Hkv or H // Hkv not in (1, 3) or D != 64:
        raise ValueError(f"unsupported (H, Hkv, D) = {(H, Hkv, D)} for the CUDA kernel")
    if not 0 <= int(layer_ix) < L:
        raise IndexError(f"layer_ix {layer_ix} out of range for {L} layers")
    if tuple(key_mask.shape) != (B, S) or key_mask.device != dev:
        raise ValueError(f"key_mask must be [B, S] = {(B, S)} on {dev}")
    km = key_mask.to(torch.int32).contiguous()
    out = torch.empty((B, H, D), dtype=q.dtype, device=dev)
    from trlx_tpu_torch.ops import _build

    lib = _build.load("decode_int8.cu")
    fn = lib.decode_int8_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    rc = fn(
        q.data_ptr(), ck.data_ptr(), cv.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), km.data_ptr(), out.data_ptr(), B, H, Hkv, S, D,
        int(layer_ix), float(sm_scale), torch.cuda.current_stream(dev).cuda_stream,
    )
    decode_attention_int8.launches += 1
    if rc != 0:
        lib.decode_int8_error_string.restype = ctypes.c_char_p
        lib.decode_int8_error_string.argtypes = [ctypes.c_int]
        raise RuntimeError(
            f"decode_int8 kernel launch failed: {lib.decode_int8_error_string(rc).decode()}"
        )
    return out


decode_attention_int8.launches = 0
