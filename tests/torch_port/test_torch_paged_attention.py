"""trlx_tpu_torch.ops.decode_attention.paged_attention_step on the CPU (the
gather path and the kernel's plain version) against the JAX package's
`paged_attention_step` with impl="xla" and impl="pallas" (the Pallas
paged kernel in interpret mode), on the grid of the reference's own kernel
test: T in {1, 3}, page size in {4, 8}, int8 and unquantised pools, GQA,
ragged lane depths and a lane_valid=False lane; then at the CUDA
kernels' route edge (tables of 256 and 272 slots), and the route table
itself. fp32 inputs; atol 2e-5, rtol 1e-5 (the reference test's
tolerance). The updated pools are compared exactly, except the null
page, which both sides treat as trash."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops import paged_kv as jkv
from trlx_tpu.ops.decode_attention import paged_attention_step as j_step

from trlx_tpu_torch.ops import paged_kv
from trlx_tpu_torch.ops.decode_attention import (
    SHORT_PAGED_MAX_SLOTS,
    paged_attention,
    paged_attention_long,
    paged_attention_plain,
    paged_attention_short,
    paged_attention_step,
    paged_route,
)


def _setup(quant, H, Hkv, T, PS, seed=0):
    """A pool with 3 lanes at ragged depths (3 context tokens written by the
    op's own write path), the step's q/k/v and the engine-style bias."""
    L, NP, MP, B, D = 2, 9, 2, 3, 8
    S = MP * PS
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    kn = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    vn = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    ctx = rng.normal(size=(B, 3, Hkv, D)).astype(np.float32)
    table = np.array([[1, 2], [3, 4], [5, 6]], np.int32)
    slot_pos = np.array([3, 2, 3], np.int32)
    q_slots = slot_pos[:, None] + np.arange(T)[None, :]
    key_mask = np.arange(S)[None, :] < (slot_pos + T)[:, None]
    causal = q_slots[:, :, None] >= np.arange(S)[None, None, :]
    bias = np.where(causal & key_mask[:, None, :], 0.0, -1e30)[:, None].astype(np.float32)

    jpools = jkv.init_pool(L, NP, PS, Hkv, D, quant, jnp.float32)
    _, jpools = j_step(jnp.zeros((B, 3, H, D)), jnp.asarray(ctx), jnp.asarray(ctx), jpools, jnp.int32(1),
                       jnp.asarray(table), jnp.zeros((B,), jnp.int32), jnp.zeros((B, 1, 3, S)), 1.0)
    pools = paged_kv.init_pool(L, NP, PS, Hkv, D, quant, torch.float32)
    paged_attention_step(torch.zeros(B, 3, H, D), torch.from_numpy(ctx), torch.from_numpy(ctx), pools, 1,
                         torch.from_numpy(table), torch.zeros(B, dtype=torch.int64), torch.zeros(B, 1, 3, S), 1.0)
    return dict(q=q, kn=kn, vn=vn, table=table, slot_pos=slot_pos, bias=bias, D=D), pools, jpools


def _compare_pools(pools, jpools):
    for name, leaf in pools.items():
        np.testing.assert_array_equal(leaf.numpy()[:, 1:], np.asarray(jpools[name])[:, 1:], err_msg=name)


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("H,Hkv", [(2, 2), (2, 1)], ids=["mha", "gqa"])
@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("PS", [4, 8])
def test_step_matches_jax_xla_and_pallas(quant, H, Hkv, T, PS):
    x, pools, jpools = _setup(quant, H, Hkv, T, PS)
    lv = np.array([True, True, False])
    args = (x["table"], x["slot_pos"], x["bias"])
    ref = {}
    for impl in ("xla", "pallas"):
        out, jnew = j_step(jnp.asarray(x["q"]), jnp.asarray(x["kn"]), jnp.asarray(x["vn"]), dict(jpools),
                           jnp.int32(1), *map(jnp.asarray, args), 1.0 / np.sqrt(x["D"]),
                           lane_valid=jnp.asarray(lv), impl=impl)
        ref[impl] = (np.asarray(out), jax.tree_util.tree_map(np.asarray, jnew))
    for impl in ("xla", "pallas"):
        mine = {k: v.clone() for k, v in pools.items()}
        out, new = paged_attention_step(
            torch.from_numpy(x["q"]), torch.from_numpy(x["kn"]), torch.from_numpy(x["vn"]), mine, 1,
            *map(torch.from_numpy, args), 1.0 / np.sqrt(x["D"]), lane_valid=torch.from_numpy(lv), impl=impl,
        )
        assert new is mine  # written in place
        for jimpl in ("xla", "pallas"):
            np.testing.assert_allclose(out.numpy(), ref[jimpl][0], atol=2e-5, rtol=1e-5,
                                       err_msg=f"port {impl} vs jax {jimpl}")
        _compare_pools(new, ref["xla"][1])


def test_contiguous_layout_ignores_impl():
    """The contiguous layout always gathers, as in the reference: both impl
    values give identical bits, equal to the JAX package's."""
    L, NP, B, D, PS, Hkv = 2, 9, 3, 8, 4, 2
    rng = np.random.default_rng(5)
    q = rng.normal(size=(B, 1, Hkv, D)).astype(np.float32)
    kn = rng.normal(size=(B, 1, Hkv, D)).astype(np.float32)
    table = 1 + np.arange(B * 2, dtype=np.int32).reshape(B, 2)
    bias = np.zeros((B, 1, 1, 2 * PS), np.float32)
    outs = []
    for impl in ("xla", "pallas"):
        pools = paged_kv.init_pool(L, NP, PS, Hkv, D, "int8", torch.float32)
        o, _ = paged_attention_step(torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(kn), pools, 0,
                                    torch.from_numpy(table), torch.zeros(B, dtype=torch.int64),
                                    torch.from_numpy(bias), 1.0, contiguous=True, impl=impl)
        outs.append(o.numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    jo, _ = j_step(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(kn), jkv.init_pool(L, NP, PS, Hkv, D, "int8", jnp.float32),
                   jnp.int32(0), jnp.asarray(table), jnp.zeros((B,), jnp.int32), jnp.asarray(bias), 1.0,
                   contiguous=True)
    np.testing.assert_allclose(outs[0], np.asarray(jo), atol=2e-5, rtol=1e-5)


def test_plain_version_is_the_wrappers_cpu_path_and_rejects_unknown_impl():
    x, pools, _ = _setup("int8", 6, 2, 3, 4, seed=2)
    args = (torch.from_numpy(x["q"]), pools, 1, torch.from_numpy(x["table"]), torch.from_numpy(x["bias"]), 0.3)
    np.testing.assert_array_equal(paged_attention(*args).numpy(), paged_attention_plain(*args).numpy())
    with pytest.raises(ValueError, match="xla/pallas"):
        paged_attention_step(torch.from_numpy(x["q"]), torch.from_numpy(x["kn"][:, :, :2]),
                             torch.from_numpy(x["vn"][:, :, :2]), pools, 0, torch.from_numpy(x["table"]),
                             torch.from_numpy(x["slot_pos"]), torch.from_numpy(x["bias"]), 1.0, impl="cuda")


@pytest.mark.parametrize("T,H,Hkv,PS,MP,route", [
    (1, 12, 12, 16, 5, "short"),  # the engine's decode step: 80 slots
    (4, 12, 12, 16, 5, "short"),  # its speculative verify
    (4, 12, 4, 16, 16, "short"),  # 256 slots, GQA: the widest short table
    (1, 12, 12, 128, 2, "short"),  # 256 slots of 128-token pages
    (1, 12, 12, 257, 1, "long"),
    (1, 12, 12, 1, 257, "long"),
    (4, 12, 4, 16, 17, "long"),  # 272 slots
    (1, 12, 12, 16, 64, "long"),  # 1024 slots
    (32, 1, 1, 8, 32, "short"),  # 32 query rows
    (8, 12, 3, 1, 1, "short"),  # 32 query rows of a GQA group over one slot
])
def test_paged_route(T, H, Hkv, PS, MP, route):
    """The CUDA paged step takes the short kernel while the table's width
    MP * PS is at most SHORT_PAGED_MAX_SLOTS (whatever the lanes hold),
    the long one past it."""
    assert SHORT_PAGED_MAX_SLOTS == 256
    assert paged_route(T, H, Hkv, PS, MP) == route


@pytest.mark.parametrize("T,H,Hkv", [(33, 1, 1), (3, 12, 1), (1, 12, 5)])
def test_paged_route_refuses_what_no_kernel_takes(T, H, Hkv):
    """More than 32 query rows in a GQA group, or heads that do not split
    into the kv heads, have no kernel."""
    with pytest.raises(ValueError):
        paged_route(T, H, Hkv, 16, 5)


@pytest.mark.parametrize("kernel", [paged_attention_short, paged_attention_long], ids=["short", "long"])
def test_route_kernels_refuse_cpu_tensors(kernel):
    """The routes' kernels run on the card only: on CPU tensors they raise
    and count no launch (only `paged_attention` takes the plain version)."""
    x, pools, _ = _setup("int8", 2, 2, 1, 4, seed=3)
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernel(torch.from_numpy(x["q"]).to(torch.bfloat16), pools, 1, torch.from_numpy(x["table"]),
               torch.from_numpy(x["bias"]), 0.3)
    assert kernel.launches == before


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("MP", [16, 17], ids=["S256", "S272"])
def test_route_edges_match_jax(quant, MP):
    """At 256 slots (the short route's widest table) and 272 (the long
    route's) the port's kernel path on the CPU (the plain version) matches
    the JAX interpreted Pallas kernel and the JAX gather path: 16-token
    pages, a GQA group of 3 query heads over each kv head, T = 4 (a
    verify step), lanes at depths 1, ~S/2 and S - 4 with left padding,
    and a null page in the middle of lane 2's table. Only query rows
    with a visible slot are held (rows with none belong to retired
    lanes)."""
    L, B, T, H, Hkv, D, PS = 2, 3, 4, 6, 2, 8, 16
    S, NP = MP * PS, 1 + B * MP
    rng = np.random.default_rng(MP)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    kn = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    vn = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    shape = (L, NP, PS, Hkv, D)
    if quant:
        pool = {"pk": rng.integers(-127, 128, shape).astype(np.int8),
                "pv": rng.integers(-127, 128, shape).astype(np.int8),
                "pk_scale": (rng.random(shape[:4]) * 0.02).astype(np.float32),
                "pv_scale": (rng.random(shape[:4]) * 0.02).astype(np.float32)}
    else:
        pool = {"pk": rng.normal(size=shape).astype(np.float32), "pv": rng.normal(size=shape).astype(np.float32)}
    depths = np.array([1, S // 2 + 3, S - T], np.int32)
    pad = np.array([0, 5, 17], np.int32)
    table = (1 + np.arange(B * MP, dtype=np.int32)).reshape(B, MP)
    table[np.arange(MP)[None, :] >= ((depths + T + PS - 1) // PS)[:, None]] = 0
    table[2, 7] = 0  # released mid-lane: masked below, as the engine's key mask does
    slots = np.arange(S)
    key_mask = (slots[None, :] >= pad[:, None]) & (slots[None, :] < (depths + T)[:, None])
    key_mask[2, 7 * PS:8 * PS] = False
    q_slots = depths[:, None] + np.arange(T)[None, :]
    visible = (q_slots[:, :, None] >= slots[None, None, :]) & key_mask[:, None, :]
    bias = np.where(visible, 0.0, -1e30)[:, None].astype(np.float32)
    lv = np.array([True, False, True])
    args = (table, depths, bias)

    ref = {}
    for impl in ("xla", "pallas"):
        out, _ = j_step(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), {k: jnp.asarray(v) for k, v in pool.items()},
                        jnp.int32(1), *map(jnp.asarray, args), 1.0 / np.sqrt(D), lane_valid=jnp.asarray(lv),
                        impl=impl)
        ref[impl] = np.asarray(out)
    mine = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    out, _ = paged_attention_step(torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), mine, 1,
                                  *map(torch.from_numpy, args), 1.0 / np.sqrt(D), lane_valid=torch.from_numpy(lv),
                                  impl="pallas")
    rows = visible.any(axis=-1)  # [B, T]: a query row with a visible slot
    assert rows.all()
    for jimpl in ("xla", "pallas"):
        np.testing.assert_allclose(out.numpy()[rows], ref[jimpl][rows], atol=2e-5, rtol=1e-5,
                                   err_msg=f"port pallas vs jax {jimpl} at S={S}")
