"""Paged KV cache: fixed-size pages and slot -> page tables (port of
trlx_tpu.ops.paged_kv).

The pool is [L, n_pages, page_size, Hkv, D] per leaf (int8 K/V with fp32
per-row scales, or the compute dtype), plus a page table [slots, MP]
mapping each decode lane's logical pages onto pool pages. Page 0 is the
reserved null page: unassigned table entries point at it and masked
lanes write into it, so it is never allocated and never attendable.

The allocator is a free stack over pages 1..n_pages-1 with a zero
sentinel in its last slot; pages pop from the top. Its functions return
new tensors, as the reference's do, so its integers match the reference
exactly and never leave the device. The pool writes (`scatter_layer`,
`scatter_prefill`) update the pool IN PLACE, where the reference threads
a functional carry: the engine holds one pool and never needs its old
contents.

K and V are quantised per row (one scale per slot and kv head over D), so
both dequantisations commute out of the attention reductions.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def pages_per_slot(prompt_len: int, max_new: int, page_size: int) -> int:
    """Logical pages a slot can touch: ceil((P + N) / page_size)."""
    return -(-(prompt_len + max_new) // page_size)


def init_pool(
    n_layer: int,
    n_pages: int,
    page_size: int,
    n_kv_head: int,
    head_dim: int,
    quant: Optional[str],
    dtype: torch.dtype,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Allocate the page pool. Keys: pk/pv (+ pk_scale/pv_scale when
    quant == "int8"). Page 0 is the reserved null page."""
    shape = (n_layer, n_pages, page_size, n_kv_head, head_dim)
    if quant == "int8":
        return {
            "pk": torch.zeros(shape, dtype=torch.int8, device=device),
            "pv": torch.zeros(shape, dtype=torch.int8, device=device),
            "pk_scale": torch.zeros(shape[:4], dtype=torch.float32, device=device),
            "pv_scale": torch.zeros(shape[:4], dtype=torch.float32, device=device),
        }
    if quant in (None, "none"):
        return {
            "pk": torch.zeros(shape, dtype=dtype, device=device),
            "pv": torch.zeros(shape, dtype=dtype, device=device),
        }
    raise ValueError(f"paged KV quant must be None or 'int8', got {quant!r}")


def init_alloc(n_pages: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Free stack over pages 1..n_pages-1 (page 0 reserved null).

    Returns (free, ntop): free[:ntop] are free page ids, popped from the
    TOP (highest index); free[-1] is a zero sentinel."""
    free = torch.cat([
        torch.arange(1, n_pages, dtype=torch.int32, device=device),
        torch.zeros(1, dtype=torch.int32, device=device),
    ])
    return free, torch.tensor(n_pages - 1, dtype=torch.int32, device=device)


def push_free(
    free: torch.Tensor, ntop: torch.Tensor, pages: torch.Tensor, is_real: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return `pages[is_real]` to the stack, in input order. Entries with
    is_real False (or page id 0) are dropped."""
    n = free.shape[0]
    is_real = is_real & (pages > 0)
    order = torch.cumsum(is_real.to(torch.int32), 0) - 1
    dst = torch.where(is_real, ntop + order, n)
    dst = torch.where(dst < n, dst, n).long()  # past the end: dropped
    ext = torch.cat([free, free.new_zeros(1)])
    ext[dst] = pages.to(free.dtype)
    return ext[:n], (ntop + is_real.sum()).to(torch.int32)


def pop_pages(
    free: torch.Tensor, ntop: torch.Tensor, want: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pop one page per wanting lane: lanes are served in input order from
    the top of the stack; a lane beyond the available count gets page 0
    (null), which callers treat as an allocation failure. Returns
    (page_ids [M], free, ntop)."""
    want = want.to(torch.int32)
    order = torch.cumsum(want, 0) - 1  # rank among wanting lanes
    served = (want > 0) & (order < ntop)
    src = torch.where(served, ntop - 1 - order, free.shape[0] - 1).long()
    ids = free[src] * served
    return ids.to(torch.int32), free, (ntop - served.sum()).to(torch.int32)


def init_refcounts(n_pages: int, device=None) -> torch.Tensor:
    """Per-page reference counts, all zero."""
    return torch.zeros(n_pages, dtype=torch.int32, device=device)


def release_refcounted(
    free: torch.Tensor, ntop: torch.Tensor, refcnt: torch.Tensor,
    pages: torch.Tensor, is_real: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decrement each released page's count once (duplicates allowed for
    shared pages); pages at or below zero afterwards return to the stack
    in input order, as `push_free`. Returns (free, ntop, refcnt)."""
    is_real = is_real & (pages > 0)
    safe = torch.where(is_real, pages, 0).long()
    refcnt = refcnt.index_add(0, safe, -is_real.to(refcnt.dtype))
    freed = is_real & (refcnt[pages.long()] <= 0)
    free, ntop = push_free(free, ntop, pages, freed)
    return free, ntop, torch.clamp(refcnt, min=0)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 over the trailing D axis: (int8, fp32 scale
    shaped x.shape[:-1]). Zero rows get scale 0 and dequantize to 0."""
    x32 = x.float()
    s = x32.abs().amax(dim=-1) / 127.0
    q = torch.round(x32 / torch.clamp(s, min=1e-12)[..., None]).to(torch.int8)
    return q, s


def write_positions(
    page_table: torch.Tensor,  # [B, MP]
    positions: torch.Tensor,  # [B, T] logical slot positions
    page_size: int,
    lane_valid: Optional[torch.Tensor] = None,  # [B] bool; invalid -> null page
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(page_ids [B, T], offsets [B, T]) for writing tokens at
    `positions` of each slot; invalid lanes write into the null page."""
    MP = page_table.shape[1]
    pix = torch.clamp(torch.div(positions, page_size, rounding_mode="floor"), 0, MP - 1)
    pids = torch.gather(page_table, 1, pix.long())
    offs = torch.remainder(positions, page_size)
    if lane_valid is not None:
        pids = torch.where(lane_valid[:, None], pids, torch.zeros_like(pids))
    return pids.long(), offs.long()


def scatter_layer(pool_leaf, layer_ix: int, pids, offs, values) -> torch.Tensor:
    """Write one layer's new tokens [B, T, ...] into the pool, in place."""
    pool_leaf[layer_ix, pids, offs] = values.to(pool_leaf.dtype)
    return pool_leaf


def scatter_prefill(pool_leaf, pids, offs, values, layer_ixs=None) -> torch.Tensor:
    """Write a prefilled prompt block [Lv, R, P, ...] (all layers at once)
    into the pool, in place. `layer_ixs` [Lv] routes the block's layers
    onto pool layer slots (a hydra draft's branch layers go to the
    extension slots past the policy stack); None: the block spans every
    layer of the leaf."""
    if layer_ixs is not None:
        pool_leaf[layer_ixs.long()[:, None, None], pids[None], offs[None]] = values.to(pool_leaf.dtype)
    else:
        pool_leaf[:, pids, offs] = values.to(pool_leaf.dtype)
    return pool_leaf


def gather_layer(pool_leaf, layer_ix: int, page_table, contiguous: bool = False) -> torch.Tensor:
    """This layer's logical [B, MP*PS, ...] view of the pool.
    `contiguous=True` asserts page_table[b, j] == 1 + b*MP + j (the
    engine's unpaged layout): the gather is a slice and a reshape."""
    B, MP = page_table.shape
    layer = pool_leaf[layer_ix]
    PS = layer.shape[1]
    if contiguous:
        return layer[1:1 + B * MP].reshape((B, MP * PS) + tuple(layer.shape[2:]))
    return layer[page_table.long()].reshape((B, MP * PS) + tuple(layer.shape[2:]))
