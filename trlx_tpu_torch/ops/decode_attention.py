"""Decode attention over the two cache layouts: the stacked int8 cache of
the static sampler and the paged pools of the decode engine (port of
trlx_tpu.ops.decode_attention).

Paged layout. `paged_attention_step` is one layer's attention over a
paged pool: it writes the T incoming tokens' K/V into their pages (in
place), then attends every query over its lane's logical sequence. Its
`impl="xla"` half gathers the lane's [B, S] view and runs the plain math
(grouped GQA, folded per-row int8 scales); `impl="pallas"` calls
`paged_attention`, which runs a hand-written Hopper kernel of
`csrc/paged_attention.cu` on CUDA tensors (the route `paged_route` names
from the table's width: the short kernel up to SHORT_PAGED_MAX_SLOTS
slots, the long one past that) and `paged_attention_plain` on CPU
tensors. The contiguous layout always takes the gather half.

Contiguous int8 layout. `decode_attention_int8` runs a hand-written Hopper
kernel of `csrc/decode_int8.cu` on CUDA tensors (the route `decode_route`
names from the cache length S: the short kernel up to
SHORT_DECODE_MAX_SLOTS slots, the long one past that) and
`decode_attention_int8_plain` on CPU tensors. The function, for one layer
`layer_ix` of the cache:

- q [B, H, D]; ck/cv [L, B, Hkv, S, D] int8 (the full stacked cache — the
  layer is an index, so no per-layer copy is made); k_scale
  [L, B, Hkv, 1, S] fp32 per-slot K scales; v_scale [B, Hkv, 1, D] fp32
  per-channel V scales of this layer; key_mask [B, S].
- scores = (q . k_int8) * (k_scale * sm_scale), NEG_INF = -1e30 where
  key_mask == 0; softmax in fp32; out = (p . v_int8) / max(l, 1e-30) *
  v_scale, in q.dtype, [B, H, D].

Query head h reads kv head h // (H // Hkv). Any cache length S works.
The kernels of both layouts take head widths D = 64 and 128; the int8
decode kernels GQA groups H // Hkv of 1 to 8, the paged kernels groups of
(H // Hkv) * T <= 32 query rows. The plain versions take any shape.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from trlx_tpu_torch.ops import paged_kv
from trlx_tpu_torch.ops._build import HEAD_DIMS

NEG_INF = -1e30
POOL_KEYS = ("pk", "pv", "pk_scale", "pv_scale")
KERNEL_HEAD_DIMS = HEAD_DIMS  # the head widths the decode and paged kernels are built for
DECODE_MAX_GROUP = 8  # the largest GQA group H // Hkv the int8 decode kernels take


def paged_attention_step(
    q: torch.Tensor,  # [B, T, H, D] queries, T >= 1
    k_new: torch.Tensor,  # [B, T, Hkv, D] this step's keys
    v_new: torch.Tensor,  # [B, T, Hkv, D] this step's values
    pools: Dict[str, torch.Tensor],  # pk/pv [L, NP, PS, Hkv, D] (+ scales)
    layer_ix: int,
    page_table: torch.Tensor,  # [B, MP] int32
    slot_pos: torch.Tensor,  # [B] logical slot of the first incoming token
    attn_bias: torch.Tensor,  # [B, 1, T, S] additive fp32, S = MP * PS
    sm_scale: float,
    lane_valid: Optional[torch.Tensor] = None,  # [B] bool; False -> null-page write
    contiguous: bool = False,
    impl: str = "xla",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One layer's attention over a paged KV cache: write the T incoming
    tokens into their pages (IN PLACE: `pools` is returned, updated), then
    attend each query over its lane's whole logical sequence, reading the
    pool after the write. All masking (lane lengths, causality among the T
    tokens, stale slots, null pages) rides `attn_bias`, so one function
    serves the T = 1 decode step and the T = draft_k verify. Returns
    (out [B, T, H, D] in q's dtype, pools)."""
    if impl not in ("xla", "pallas"):
        raise ValueError(f"paged attention impl must be xla/pallas, got {impl!r}")
    B, T, H, D = q.shape
    Hkv = k_new.shape[2]
    PS = pools["pk"].shape[2]
    quant = "pk_scale" in pools
    positions = slot_pos[:, None] + torch.arange(T, device=q.device)[None, :]
    pids, offs = paged_kv.write_positions(page_table, positions, PS, lane_valid)
    if quant:
        kq, ks = paged_kv.quantize_rows(k_new)
        vq, vs = paged_kv.quantize_rows(v_new)
        for name, x in (("pk", kq), ("pv", vq), ("pk_scale", ks), ("pv_scale", vs)):
            paged_kv.scatter_layer(pools[name], layer_ix, pids, offs, x)
    else:
        paged_kv.scatter_layer(pools["pk"], layer_ix, pids, offs, k_new)
        paged_kv.scatter_layer(pools["pv"], layer_ix, pids, offs, v_new)

    if impl == "pallas" and not contiguous:
        return paged_attention(q, pools, layer_ix, page_table, attn_bias, sm_scale), pools

    k_all = paged_kv.gather_layer(pools["pk"], layer_ix, page_table, contiguous)  # [B, S, Hkv, D]
    v_all = paged_kv.gather_layer(pools["pv"], layer_ix, page_table, contiguous)
    rep = H // Hkv
    # GQA grouped: rows (g, r) of group g share kv head g; K and V are
    # never repeated to H heads
    qg = q.reshape(B, T, Hkv, rep, D)
    scores = torch.einsum("btgrd,bsgd->bgrts", qg.float(), k_all.to(q.dtype).float()) * sm_scale
    bias = attn_bias[:, :, None]  # [B, 1, 1, T, S]
    if quant:
        ks_all = paged_kv.gather_layer(pools["pk_scale"], layer_ix, page_table, contiguous)  # [B, S, Hkv]
        vs_all = paged_kv.gather_layer(pools["pv_scale"], layer_ix, page_table, contiguous)
        scores = scores * ks_all.permute(0, 2, 1)[:, :, None, None, :]
        probs = torch.softmax(scores + bias, dim=-1)
        probs = (probs * vs_all.permute(0, 2, 1)[:, :, None, None, :]).to(q.dtype)
    else:
        probs = torch.softmax(scores + bias, dim=-1).to(q.dtype)
    out = torch.einsum("bgrts,bsgd->btgrd", probs, v_all.to(q.dtype))
    return out.reshape(B, T, H, D).to(q.dtype), pools


def paged_attention_plain(
    q: torch.Tensor,
    pools: Dict[str, torch.Tensor],
    layer_ix: int,
    page_table: torch.Tensor,
    attn_bias: torch.Tensor,
    sm_scale: float,
) -> torch.Tensor:
    """The paged kernel's function in plain PyTorch, in fp32: for lane b,
    query (t, head h) and kv head g = h // (H // Hkv), over every slot j
    of the lane's pages (page_table[b, j // PS], row j % PS),
    s_j = (q . k_j) * sm_scale * k_scale_j + bias[b, 0, t, j], softmax
    over j, o = sum_j p_j * v_scale_j * v_j / max(l, 1e-30)."""
    B, T, H, D = q.shape
    Hkv = pools["pk"].shape[3]
    if H % Hkv:
        raise ValueError(f"n_head={H} not a multiple of n_kv_head={Hkv}")
    k = paged_kv.gather_layer(pools["pk"], layer_ix, page_table).float()  # [B, S, Hkv, D]
    v = paged_kv.gather_layer(pools["pv"], layer_ix, page_table).float()
    qg = q.float().reshape(B, T, Hkv, H // Hkv, D)
    s = torch.einsum("btgrd,bsgd->bgrts", qg, k) * sm_scale
    if "pk_scale" in pools:
        ks = paged_kv.gather_layer(pools["pk_scale"], layer_ix, page_table)  # [B, S, Hkv]
        s = s * ks.permute(0, 2, 1)[:, :, None, None, :]
    s = s + attn_bias.float()[:, :, None]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if "pv_scale" in pools:
        vs = paged_kv.gather_layer(pools["pv_scale"], layer_ix, page_table)
        p = p * vs.permute(0, 2, 1)[:, :, None, None, :]
    o = torch.einsum("bgrts,bsgd->btgrd", p, v) / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2, 4)
    return o.reshape(B, T, H, D).to(q.dtype)


SHORT_PAGED_MAX_SLOTS = 256  # the widest page table (MP * PS slots) the short kernel takes


def paged_route(T: int, H: int, Hkv: int, PS: int, MP: int) -> str:
    """The CUDA paged kernel's route for T queries of H heads over Hkv kv
    heads and a page table of MP pages of PS slots: "short" (one CTA per
    (lane, kv head) loads the lane's whole K/V in one burst and keeps its
    whole row of scores) when the table's width MP * PS is at most
    SHORT_PAGED_MAX_SLOTS, else "long" (128-slot chunks with an online
    softmax). The width is known on the host; how many slots a lane has
    filled never decides. Raises for a shape neither route takes: a GQA
    group of (H // Hkv) * T > 32 query rows."""
    if Hkv < 1 or H % Hkv or T < 1 or (H // Hkv) * T > 32:
        raise ValueError(f"no paged kernel takes (T, H, Hkv) = {(T, H, Hkv)}: needs (H // Hkv) * T <= 32")
    return "short" if MP * PS <= SHORT_PAGED_MAX_SLOTS else "long"


def _paged_operands(q, pools, layer_ix, page_table, attn_bias) -> None:
    """Check the paged kernels' operands: q bf16 on a CUDA device, D = 64 or 128,
    an int8 pool with its fp32 scales or a bf16 pool without, all
    contiguous, 16-byte aligned and on q's device."""
    if q.device.type != "cuda":
        raise ValueError(f"the paged kernels take CUDA tensors, not {q.device}")
    B, T, H, D = q.shape
    L, NP, PS, Hkv, _ = pools["pk"].shape
    MP = page_table.shape[1]
    quant = "pk_scale" in pools
    kv_dtype = torch.int8 if quant else torch.bfloat16
    dev = q.device
    expect = {
        "q": (q, torch.bfloat16, (B, T, H, D)),
        "pk": (pools["pk"], kv_dtype, (L, NP, PS, Hkv, D)),
        "pv": (pools["pv"], kv_dtype, (L, NP, PS, Hkv, D)),
        "page_table": (page_table, torch.int32, (B, MP)),
        "attn_bias": (attn_bias, torch.float32, (B, 1, T, MP * PS)),
    }
    if quant:
        expect["pk_scale"] = (pools["pk_scale"], torch.float32, (L, NP, PS, Hkv))
        expect["pv_scale"] = (pools["pv_scale"], torch.float32, (L, NP, PS, Hkv))
    for name, (x, dtype, shape) in expect.items():
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {dev}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}"
            )
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if H % Hkv or D not in KERNEL_HEAD_DIMS or (H // Hkv) * T > 32:
        raise ValueError(f"unsupported (H, Hkv, T, D) = {(H, Hkv, T, D)} for the CUDA kernel")
    if not 0 <= int(layer_ix) < L:
        raise IndexError(f"layer_ix {layer_ix} out of range for {L} layers")


def _paged_library(head_dim: int):
    from trlx_tpu_torch.ops import _build

    return _build.load("paged_attention.cu", head_dim=head_dim)


def _paged_kernel(fn_name, q, pools, layer_ix, page_table, attn_bias, sm_scale) -> torch.Tensor:
    """Launch the C entry `fn_name` of `csrc/paged_attention.cu` on checked
    operands; raise with the CUDA error string if the launch was refused."""
    _paged_operands(q, pools, layer_ix, page_table, attn_bias)
    B, T, H, D = q.shape
    L, NP, PS, Hkv, _ = pools["pk"].shape
    MP = page_table.shape[1]
    quant = "pk_scale" in pools
    out = torch.empty_like(q)
    lib = _paged_library(D)
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p]
    pks, pvs = (pools["pk_scale"].data_ptr(), pools["pv_scale"].data_ptr()) if quant else (None, None)
    rc = fn(
        q.data_ptr(), pools["pk"].data_ptr(), pools["pv"].data_ptr(), pks, pvs,
        page_table.data_ptr(), attn_bias.data_ptr(), out.data_ptr(),
        B, T, H, Hkv, D, NP, PS, MP, int(layer_ix), int(quant), float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{fn_name} kernel launch failed: {lib.paged_attention_error_string(rc).decode()}")
    return out


def paged_attention_short(q, pools, layer_ix, page_table, attn_bias, sm_scale) -> torch.Tensor:
    """The paged attention function (`paged_attention_plain`) by the short
    kernel of `csrc/paged_attention.cu`: CUDA tensors only, MP * PS <=
    SHORT_PAGED_MAX_SLOTS (wider tables raise)."""
    out = _paged_kernel("paged_attention_short_bf16", q, pools, layer_ix, page_table, attn_bias, sm_scale)
    paged_attention_short.launches += 1
    return out


def paged_attention_long(q, pools, layer_ix, page_table, attn_bias, sm_scale) -> torch.Tensor:
    """The paged attention function by the long kernel of
    `csrc/paged_attention.cu` (any table width): CUDA tensors only."""
    out = _paged_kernel("paged_attention_bf16", q, pools, layer_ix, page_table, attn_bias, sm_scale)
    paged_attention_long.launches += 1
    return out


paged_attention_short.launches = 0
paged_attention_long.launches = 0


def paged_attention_occupancy(route: str, T: int, H: int, Hkv: int, PS: int, MP: int, quant: bool,
                              D: int = 64) -> dict:
    """What a launch of the `route` kernel at this shape gets on the current
    card: its threads a CTA, its dynamic shared memory and the CTAs an SM
    holds."""
    ctas, threads, smem = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    lib = _paged_library(D)
    fn = lib.paged_attention_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_int)] * 3
    rc = fn(int(route == "short"), T, H, Hkv, D, PS, MP, int(quant),
            ctypes.byref(ctas), ctypes.byref(threads), ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"paged_attention_occupancy failed with CUDA error {rc}")
    return {"ctas_per_sm": ctas.value, "threads": threads.value, "smem_bytes": smem.value}


def paged_attention(
    q: torch.Tensor,  # [B, T, H, D] bf16
    pools: Dict[str, torch.Tensor],  # the pools AFTER this step's write
    layer_ix: int,
    page_table: torch.Tensor,  # [B, MP] int32
    attn_bias: torch.Tensor,  # [B, 1, T, MP * PS] fp32
    sm_scale: float,
) -> torch.Tensor:
    """Attention of T queries per lane over that lane's pages of one pool
    layer (see `paged_attention_plain`). CPU tensors take the plain
    version; CUDA tensors launch the kernel of the route `paged_route`
    names (`paged_attention_short` or `paged_attention_long`) or raise: q
    bf16, D = 64 or 128, (H // Hkv) * T <= 32, an int8 pool with its fp32 scales
    or a bf16 pool without, all operands contiguous. Neither route gives
    way to the other.

    Both kernels skip null pages (table entry 0), and the short one also
    every slot that no query row of the lane sees (bias <= -5e8 on every
    row). For a query row with at least one visible slot (bias 0) that
    gives the plain version's result: a masked slot's weight is
    exp(-1e9 - m) = 0. Rows with no visible slot belong only to lanes the
    engine has retired, whose output it never reads; there the versions
    may differ."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, pools, layer_ix, page_table, attn_bias, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, not {q.device}")
    _, T, H, _ = q.shape
    _, _, PS, Hkv, _ = pools["pk"].shape
    route = paged_route(T, H, Hkv, PS, page_table.shape[1])
    kernel = paged_attention_short if route == "short" else paged_attention_long
    out = kernel(q, pools, layer_ix, page_table, attn_bias, sm_scale)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


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


SHORT_DECODE_MAX_SLOTS = 256  # the longest cache (S slots) the short kernel takes


def decode_route(S: int) -> str:
    """The CUDA int8 decode kernel's route for a cache of S slots: "short"
    (one CTA per (batch row, kv head) loads the attendable K/V in one burst
    and keeps its whole row of scores) when S is at most
    SHORT_DECODE_MAX_SLOTS, else "long" (128-slot chunks with an online
    softmax). S is known on the host; how many slots the mask admits never
    decides."""
    return "short" if S <= SHORT_DECODE_MAX_SLOTS else "long"


def _decode_operands(q, ck, cv, k_scale, v_scale, key_mask, layer_ix) -> torch.Tensor:
    """Check the decode kernels' operands: q bf16 on a CUDA device, D = 64
    or 128, H // Hkv in 1..DECODE_MAX_GROUP, the int8 caches and fp32 scales contiguous, 16-byte
    aligned and on q's device. Returns the key mask as a contiguous,
    16-byte aligned int32 tensor."""
    if q.device.type != "cuda":
        raise ValueError(f"the int8 decode kernels take CUDA tensors, not {q.device}")
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
    if H % Hkv or not 1 <= H // Hkv <= DECODE_MAX_GROUP or D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"unsupported (H, Hkv, D) = {(H, Hkv, D)} for the CUDA kernel")
    if not 0 <= int(layer_ix) < L:
        raise IndexError(f"layer_ix {layer_ix} out of range for {L} layers")
    if tuple(key_mask.shape) != (B, S) or key_mask.device != dev:
        raise ValueError(f"key_mask must be [B, S] = {(B, S)} on {dev}")
    km = key_mask.to(torch.int32).contiguous()
    return km if km.data_ptr() % 16 == 0 else km.clone()


def _decode_library():
    from trlx_tpu_torch.ops import _build

    return _build.load("decode_int8.cu")


def _decode_kernel(fn_name, q, ck, cv, k_scale, v_scale, key_mask, layer_ix, sm_scale) -> torch.Tensor:
    """Launch the C entry `fn_name` of `csrc/decode_int8.cu` on checked
    operands; raise with the CUDA error string if the launch was refused."""
    km = _decode_operands(q, ck, cv, k_scale, v_scale, key_mask, layer_ix)
    L, B, Hkv, S, D = ck.shape
    H = q.shape[1]
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    lib = _decode_library()
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    rc = fn(
        q.data_ptr(), ck.data_ptr(), cv.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), km.data_ptr(), out.data_ptr(), B, H, Hkv, S, D,
        int(layer_ix), float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        lib.decode_int8_error_string.restype = ctypes.c_char_p
        lib.decode_int8_error_string.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{fn_name} kernel launch failed: {lib.decode_int8_error_string(rc).decode()}")
    return out


def decode_attention_int8_short(q, ck, cv, k_scale, v_scale, key_mask, layer_ix, sm_scale) -> torch.Tensor:
    """The int8 decode function (`decode_attention_int8_plain`) by the short
    kernel of `csrc/decode_int8.cu`: CUDA tensors only, S <=
    SHORT_DECODE_MAX_SLOTS (longer caches raise)."""
    out = _decode_kernel("decode_int8_short_bf16", q, ck, cv, k_scale, v_scale, key_mask, layer_ix, sm_scale)
    decode_attention_int8_short.launches += 1
    return out


def decode_attention_int8_long(q, ck, cv, k_scale, v_scale, key_mask, layer_ix, sm_scale) -> torch.Tensor:
    """The int8 decode function by the long kernel of `csrc/decode_int8.cu`
    (any S): CUDA tensors only."""
    out = _decode_kernel("decode_int8_bf16", q, ck, cv, k_scale, v_scale, key_mask, layer_ix, sm_scale)
    decode_attention_int8_long.launches += 1
    return out


decode_attention_int8_short.launches = 0
decode_attention_int8_long.launches = 0


def decode_attention_int8_occupancy(route: str, H: int, Hkv: int, S: int, device="cuda", D: int = 64) -> dict:
    """What a launch of the `route` kernel for H query heads over Hkv kv
    heads, a cache of S slots and head width D gets on the CUDA `device`:
    its threads a CTA, its dynamic shared memory and the CTAs an SM holds."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"decode_attention_int8_occupancy queries a CUDA device, not {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("decode_attention_int8_occupancy needs a CUDA device; none is available")
    if route not in ("short", "long"):
        raise ValueError(f"route must be short/long, got {route!r}")
    ctas, threads, smem = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    lib = _decode_library()
    fn = lib.decode_int8_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 3
    with torch.cuda.device(device):
        rc = fn(int(route == "short"), H, Hkv, S, D, ctypes.byref(ctas), ctypes.byref(threads), ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"decode_attention_int8_occupancy failed with CUDA error {rc}")
    return {"ctas_per_sm": ctas.value, "threads": threads.value, "smem_bytes": smem.value}


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
    tensors launch the kernel of the route `decode_route` names
    (`decode_attention_int8_short` or `decode_attention_int8_long`) or
    raise: q bf16, all operands contiguous, D = 64 or 128, H // Hkv in
    1..DECODE_MAX_GROUP. Neither route gives way to the other."""
    if q.device.type == "cpu":
        return decode_attention_int8_plain(
            q, ck, cv, k_scale, v_scale, key_mask, layer_ix, sm_scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_int8 runs on cpu or cuda, not {q.device}")
    kernel = decode_attention_int8_short if decode_route(ck.shape[3]) == "short" else decode_attention_int8_long
    out = kernel(q, ck, cv, k_scale, v_scale, key_mask, layer_ix, sm_scale)
    decode_attention_int8.launches += 1
    return out


decode_attention_int8.launches = 0
