"""trlx_tpu_torch.ops.decode_attention.paged_attention_step on the CPU (the
gather path and the kernel's plain version) against the JAX package's
`paged_attention_step` with impl="xla" and impl="pallas" (the Pallas
paged kernel in interpret mode), on the grid of the reference's own kernel
test: T in {1, 3}, page size in {4, 8}, int8 and unquantised pools, GQA,
ragged lane depths and a lane_valid=False lane. fp32 inputs; atol 2e-5,
rtol 1e-5 (the reference test's tolerance). The updated pools are
compared exactly, except the null page, which both sides treat as trash."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops import paged_kv as jkv
from trlx_tpu.ops.decode_attention import paged_attention_step as j_step

from trlx_tpu_torch.ops import paged_kv
from trlx_tpu_torch.ops.decode_attention import (
    paged_attention,
    paged_attention_plain,
    paged_attention_step,
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
