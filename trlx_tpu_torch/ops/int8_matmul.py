"""Int8 decode weights: per-output-channel symmetric quantization of a
projection kernel and the W8A16 product that consumes it (the port of
trlx_tpu.models.transformer's `quantize_decode_weights` numerics and of
QDense's int8 branch).

`quantize_kernel(w)` gives q = round(w / s) in int8 with s = max|w| / 127
per output column (over the input axis of the [in, out] kernel), the
reference's code. `int8_weight_matmul(x, q, s)` computes (x . q) * s with
fp32 accumulation and the scale on the accumulator, rounded once to x's
dtype: on CUDA tensors kernel 10 (`csrc/int8_weight_matmul.cu`, bf16
activations) on the route and tiling `int8_matmul_route` picks by the row
count, on CPU tensors `int8_weight_matmul_plain`, the same arithmetic in
PyTorch. (The
reference rounds the product to the compute dtype before it scales; in
fp32 the two are the same computation, and in bf16 they differ by that
one rounding.)
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from trlx_tpu_torch.ops.flash_attention import _launch, _stream


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


SMS = 132  # an H100's streaming multiprocessors
STREAM_MAX_ROWS = 64  # the most rows the decode route ("stream") takes
# the stream route reads 32 channels (32 contiguous bytes of each weight
# row) a CTA while that still gives the card this many CTAs, else 16
STREAM_MIN_CTAS = 128
WGMMA_COLS = 128  # the prefill route's ("wgmma") output channels a CTA


def int8_matmul_tilings() -> list:
    """Every (route, rows, cols) kernel 10 is built for (the wgmma route's
    K split is chosen at launch)."""
    return ([("stream", r, c) for r in (8, 16, 32, 64) for c in (16, 32)]
            + [("wgmma", r, WGMMA_COLS) for r in (128, 256)])


@functools.lru_cache(maxsize=None)  # a pure choice, made on every launch
def int8_matmul_route(M: int, N: int, K: int) -> Tuple[str, int, int, int]:
    """Kernel 10's (route, rows, cols, splits) for an [M, K] x [K, N]
    product.

    "stream" (M <= STREAM_MAX_ROWS, the decode rows; bound by the int8
    weight bytes): a CTA holds all M rows (rows 8, 16, 32 or 64, the least
    that covers M) and `cols` = 32 output channels over all of K, or 16
    when 32-wide tiles would give the card fewer than STREAM_MIN_CTAS
    CTAs (at 8 rows x 4096 x 4096 on an H100, 32-wide tiles took 0.0165
    ms against 0.0176; at GPT-2's 768 and 3072 channels 16-wide ones were
    faster); `splits` 1.
    "wgmma" (the prefill rows; bound by the tensor cores): `rows` x 128
    output tiles, rows 256 where that gives the card one CTA an SM, else
    128; where 128-row tiles do not either, K is split over clusters of
    `splits` = 2, 4 or 8 CTAs, the fewest that do, keeping at least two
    64-deep stages a CTA.

    The split pays for long K over few tiles (128 x 4096 x 768) and costs
    time at short K (the recipe cell's 768-deep prefills at 1024 and 2048
    rows, where unsplit 128-row tiles are faster; PERF.md, kernel 10). It is
    kept there, not for speed: the recipe cell's greedy gate on the card
    (95% agreement with plain bf16 at one seed) passed with it and failed
    with no split at K = 768, though both rules' outputs lie within half a
    bf16 ulp of the fp32 product. The gate draws over the random policy's
    near ties; once it states its noise (ROADMAP queue 3 item 37) the rule
    can follow the speed."""
    if M < 1 or N < 16 or K < 8 or N % 16 or K % 8:
        raise ValueError(f"kernel 10 takes M >= 1, N % 16 == 0 and K % 8 == 0, got M={M}, K={K}, N={N}")
    if M <= STREAM_MAX_ROWS:
        rows = next(r for r in (8, 16, 32, 64) if M <= r)
        cols = 32 if -(-N // 32) >= STREAM_MIN_CTAS else 16
        return "stream", rows, cols, 1
    col_tiles = -(-N // WGMMA_COLS)
    if -(-M // 256) * col_tiles >= SMS:
        return "wgmma", 256, WGMMA_COLS, 1
    tiles, stages, splits = -(-M // 128) * col_tiles, -(-K // 64), 1
    for s in (2, 4, 8):
        if tiles * splits >= SMS or 2 * s > stages:
            break
        splits = s
    return "wgmma", 128, WGMMA_COLS, splits


def _launch_route(x2, q, s, route: str, rows: int, cols: int, splits: int) -> torch.Tensor:
    M, (K, N) = x2.shape[0], q.shape
    y = torch.empty((M, N), dtype=torch.bfloat16, device=x2.device)
    _launch("int8_weight_matmul.cu", "int8_weight_matmul",
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
            (x2.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(), M, N, K, int(route == "wgmma"), rows, cols,
             splits, _stream(x2)))
    return y


def int8_weight_matmul_stream(x2, q, s, rows: int, cols: int) -> torch.Tensor:
    """Kernel 10's decode route on a checked [M, K] x (M <= rows): `rows` x
    `cols` output tiles, each over all of K."""
    int8_weight_matmul_stream.launches += 1
    return _launch_route(x2, q, s, "stream", rows, cols, 1)


int8_weight_matmul_stream.launches = 0


def int8_weight_matmul_wgmma(x2, q, s, rows: int, splits: int) -> torch.Tensor:
    """Kernel 10's prefill route on a checked [M, K] x: `rows` x 128 output
    tiles, K split over clusters of `splits` CTAs."""
    int8_weight_matmul_wgmma.launches += 1
    return _launch_route(x2, q, s, "wgmma", rows, WGMMA_COLS, splits)


int8_weight_matmul_wgmma.launches = 0


def int8_weight_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The W8A16 product: the plain version on CPU tensors, kernel 10 on
    CUDA tensors on the route `int8_matmul_route` names (or an exception,
    never the plain path)."""
    if x.device.type == "cpu":
        return int8_weight_matmul_plain(x, q, s)
    if x.device.type != "cuda":
        raise ValueError(f"int8_weight_matmul runs on cpu or cuda, not {x.device}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    _check(x2, q, s)
    M, (K, N) = x2.shape[0], q.shape
    route, rows, cols, splits = int8_matmul_route(M, N, K)
    int8_weight_matmul.launches += 1
    if route == "stream":
        y = int8_weight_matmul_stream(x2, q, s, rows, cols)
    else:
        y = int8_weight_matmul_wgmma(x2, q, s, rows, splits)
    return y.reshape(*lead, N)


int8_weight_matmul.launches = 0
