"""trlx_tpu_torch.ops.paged_kv against trlx_tpu.ops.paged_kv: the page
allocator's integers (free stack, its top, refcounts, tables) exactly,
over seeded random sequences of pops, pushes and refcounted releases that
include duplicated shared pages; the row quantiser, the pool scatters and
the gathers exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops import paged_kv as jkv

from trlx_tpu_torch.ops import paged_kv


def _eq(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got.cpu()), np.asarray(want), err_msg=what)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_sequences_match_exactly(seed):
    rng = np.random.default_rng(seed)
    NP = 13
    free, ntop = paged_kv.init_alloc(NP)
    jfree, jntop = jkv.init_alloc(NP)
    rc, jrc = paged_kv.init_refcounts(NP), jkv.init_refcounts(NP)
    _eq(free, jfree)
    held = []  # pages popped and not yet pushed
    for step in range(40):
        op = rng.integers(0, 3)
        if op == 0:  # pop for a random want mask (more than available at times)
            want = rng.random(rng.integers(1, 9)) < 0.7
            ids, free, ntop = paged_kv.pop_pages(free, ntop, torch.from_numpy(want))
            jids, jfree, jntop = jkv.pop_pages(jfree, jntop, jnp.asarray(want))
            _eq(ids, jids, f"ids at {step}")
            held += [int(x) for x in ids.tolist() if x > 0]
        elif op == 1 and held:  # push some held pages back (plus nulls and masked entries)
            rng.shuffle(held)
            k = int(rng.integers(1, len(held) + 1))
            pages = np.array(held[:k] + [0], np.int32)
            real = rng.random(len(pages)) < 0.8
            held = held[k:] + [int(p) for p, r in zip(pages, real) if p > 0 and not r]
            free, ntop = paged_kv.push_free(free, ntop, torch.from_numpy(pages), torch.from_numpy(real))
            jfree, jntop = jkv.push_free(jfree, jntop, jnp.asarray(pages), jnp.asarray(real))
        elif op == 2 and held:  # a refcounted release with a duplicated shared page
            shared = held[0]
            rc = rc.index_add(0, torch.tensor([shared]), torch.tensor([3], dtype=torch.int32))
            jrc = jrc.at[shared].add(3)
            pages = np.array([shared, shared] + held[1:3], np.int32)
            real = np.ones(len(pages), bool)
            held = [shared] + held[3:]
            free, ntop, rc = paged_kv.release_refcounted(
                free, ntop, rc, torch.from_numpy(pages), torch.from_numpy(real))
            jfree, jntop, jrc = jkv.release_refcounted(
                jfree, jntop, jrc, jnp.asarray(pages), jnp.asarray(real))
            _eq(rc, jrc, f"refcounts at {step}")
        _eq(free, jfree, f"free stack at {step}")
        assert int(ntop) == int(jntop), step


def test_quantize_scatter_gather_exact():
    rng = np.random.default_rng(3)
    L, NP, PS, Hkv, D, B, T = 2, 7, 4, 2, 8, 3, 3
    x = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    x[0, 0, 1] = 0.0  # a zero row: scale 0
    q, s = paged_kv.quantize_rows(torch.from_numpy(x))
    jq, js = jkv.quantize_rows(jnp.asarray(x))
    _eq(q, jq)
    _eq(s, js)

    table = np.array([[1, 2], [3, 0], [5, 6]], np.int32)
    positions = np.array([[3, 4, 5], [0, 1, 2], [6, 7, 8]], np.int32)
    valid = np.array([True, True, False])
    pids, offs = paged_kv.write_positions(torch.from_numpy(table), torch.from_numpy(positions), PS,
                                          torch.from_numpy(valid))
    jpids, joffs = jkv.write_positions(jnp.asarray(table), jnp.asarray(positions), PS, jnp.asarray(valid))
    _eq(pids, jpids)
    _eq(offs, joffs)

    pool = paged_kv.init_pool(L, NP, PS, Hkv, D, "int8", torch.float32)
    jpool = jkv.init_pool(L, NP, PS, Hkv, D, "int8", jnp.float32)
    paged_kv.scatter_layer(pool["pk"], 1, pids, offs, q)
    jpk = jkv.scatter_layer(jpool["pk"], jnp.int32(1), jpids, joffs, jq)
    _eq(pool["pk"], jpk)

    R, P = 2, 5
    vals = rng.normal(size=(L, R, P, Hkv, D)).astype(np.float32)
    rtab = np.array([[2, 4], [6, 0]], np.int32)
    ppos = np.broadcast_to(np.arange(P), (R, P))
    do = np.array([True, False])
    pp, po = paged_kv.write_positions(torch.from_numpy(rtab), torch.from_numpy(ppos.copy()), PS, torch.from_numpy(do))
    jpp, jpo = jkv.write_positions(jnp.asarray(rtab), jnp.asarray(ppos), PS, jnp.asarray(do))
    dense = paged_kv.init_pool(L + 1, NP, PS, Hkv, D, None, torch.float32)
    jdense = jkv.init_pool(L + 1, NP, PS, Hkv, D, None, jnp.float32)
    for lsel in (np.array([0, 2]), np.array([1, 2])):
        paged_kv.scatter_prefill(dense["pv"], pp, po, torch.from_numpy(vals), layer_ixs=torch.from_numpy(lsel))
        jdense["pv"] = jkv.scatter_prefill(jdense["pv"], jpp, jpo, jnp.asarray(vals), layer_ixs=jnp.asarray(lsel))
    _eq(dense["pv"][:, 1:], np.asarray(jdense["pv"])[:, 1:])  # page 0 is trash on both
    full = paged_kv.scatter_prefill(torch.zeros(L, NP, PS, Hkv, D), pp, po, torch.from_numpy(vals))
    jfull = jkv.scatter_prefill(jnp.zeros((L, NP, PS, Hkv, D)), jpp, jpo, jnp.asarray(vals))
    _eq(full[:, 1:], np.asarray(jfull)[:, 1:])
    for layer in range(L + 1):
        for contiguous, tab in ((False, rtab), (True, 1 + np.arange(4, dtype=np.int32).reshape(2, 2))):
            got = paged_kv.gather_layer(dense["pv"], layer, torch.from_numpy(tab), contiguous)
            want = jkv.gather_layer(jdense["pv"], jnp.int32(layer), jnp.asarray(tab), contiguous)
            if not contiguous:  # null-page rows are trash
                keep = np.repeat(tab > 0, PS, axis=1)
                got, want = got.numpy()[keep], np.asarray(want)[keep]
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_pages_per_slot_and_pool_layout():
    assert paged_kv.pages_per_slot(6, 12, 4) == jkv.pages_per_slot(6, 12, 4) == 5
    pool = paged_kv.init_pool(2, 5, 4, 3, 8, "int8", torch.bfloat16)
    jpool = jkv.init_pool(2, 5, 4, 3, 8, "int8", jnp.bfloat16)
    assert {k: tuple(v.shape) for k, v in pool.items()} == {k: tuple(v.shape) for k, v in jpool.items()}
    with pytest.raises(ValueError, match="quant"):
        paged_kv.init_pool(1, 2, 4, 1, 8, "fp4", torch.float32)
