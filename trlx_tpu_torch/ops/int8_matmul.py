"""Int8 decode weights: per-output-channel symmetric quantization of a
projection kernel and the W8A16 product that consumes it (the port of
trlx_tpu.models.transformer's `quantize_decode_weights` numerics and of
QDense's int8 branch).

`quantize_kernel(w)` gives q = round(w / s) in int8 with s = max|w| / 127
per output column (over the input axis of the [in, out] kernel), the
reference's code. `int8_weight_matmul(x, q, s)` computes (x . q) * s with
fp32 accumulation and the scale on the accumulator, rounded once to x's
dtype: on CUDA tensors kernel 10 (`csrc/int8_weight_matmul.cu`, bf16
activations; K split over several CTAs when the output tiles alone would
not fill the card, `int8_matmul_splits`), on CPU tensors
`int8_weight_matmul_plain`, the same arithmetic in PyTorch. (The
reference rounds the product to the compute dtype before it scales; in
fp32 the two are the same computation, and in bf16 they differ by that
one rounding.)
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch


def quantize_kernel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[in, out] kernel (any float dtype) -> (int8 [in, out], fp32 scales
    [out]); a zero column gets scale 0 and quantizes to zeros."""
    w = w.float()
    s = w.abs().amax(dim=0) / 127.0
    q = torch.round(w / torch.clamp(s, min=1e-12)).to(torch.int8)
    return q, s


def int8_weight_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(x . q) * s in fp32, rounded to x's dtype: [..., K] x [K, N] -> [..., N]."""
    return (torch.matmul(x.float(), q.float()) * s.float()).to(x.dtype)


def check_decode_dtype(device, dtype: torch.dtype) -> None:
    """Refuse int8 decode weights that kernel 10 could not run: on a CUDA
    device the W8A16 product takes bf16 activations only, so another
    compute dtype there raises NotImplementedError (the CPU's plain
    version takes any)."""
    if torch.device(device).type == "cuda" and dtype != torch.bfloat16:
        raise NotImplementedError(
            f"decode_weights_quant='int8' on {device} with compute dtype {dtype}: kernel 10 takes bf16 "
            "activations only (ROADMAP queue 2 item 8); use compute_dtype bfloat16"
        )


def _check(x2, q, s) -> None:
    dev = x2.device
    K, N = q.shape
    if x2.dtype != torch.bfloat16 or q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"kernel 10 takes bf16 x, int8 q and fp32 s, got {x2.dtype}, {q.dtype}, {s.dtype}")
    if x2.shape[1] != K or tuple(s.shape) != (N,):
        raise ValueError(f"shapes x {tuple(x2.shape)}, q {tuple(q.shape)}, s {tuple(s.shape)} do not match")
    if N % 16 or K % 8:
        raise ValueError(f"kernel 10 needs N % 16 == 0 and K % 8 == 0, got K={K}, N={N}")
    for name, t in (("x", x2), ("q", q), ("s", s)):
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and on {dev}")


# CTAs kernel 10 aims to have in flight (four an SM of an H100's 132)
# before it splits K; each split keeps at least 256 of K
_TARGET_CTAS = 4 * 132


def int8_matmul_splits(M: int, N: int, K: int) -> int:
    """The K splits kernel 10 runs for an [M, K] x [K, N] product: 1 when its
    output tiles (64 columns by 16 rows up to 16 rows, else 64) fill the
    card, more for the decode rows. The kernel gives each split the same
    whole number of 64-deep steps, so the count is taken back to the
    number of such ranges that K needs: no split starts past K."""
    tiles = -(-N // 64) * -(-M // (16 if M <= 16 else 64))
    want = max(1, min(-(-_TARGET_CTAS // tiles), K // 256))
    per = -(-(-(-K // want)) // 64) * 64
    return -(-K // per)


def int8_weight_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The W8A16 product: the plain version on CPU tensors, kernel 10 on
    CUDA tensors (or an exception, never the plain path)."""
    if x.device.type == "cpu":
        return int8_weight_matmul_plain(x, q, s)
    if x.device.type != "cuda":
        raise ValueError(f"int8_weight_matmul runs on cpu or cuda, not {x.device}")
    from trlx_tpu_torch.ops.flash_attention import _launch, _stream

    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    _check(x2, q, s)
    M, (K, N) = x2.shape[0], q.shape
    y = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    splits = int8_matmul_splits(M, N, K)
    part = torch.empty((splits, M, N), dtype=torch.float32, device=x.device) if splits > 1 else None
    int8_weight_matmul.launches += 1
    _launch("int8_weight_matmul.cu", "int8_weight_matmul",
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
            (x2.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(), None if part is None else part.data_ptr(),
             M, N, K, splits, _stream(x)))
    return y.reshape(*lead, N)


int8_weight_matmul.launches = 0
