"""trlx_tpu_torch.models.gen_engine against trlx_tpu.models.gen_engine.

Greedy decoding on a tiny fp32 model (2 layers, width 16, vocab 64; the
JAX package's init, converted) is held token for token, and every integer
of `gen_stats` exactly (occupancy to rel 1e-6): paged int8, paged
unquantised and contiguous layouts, the paged kernel's path, an
undersized pool, lanes that finish at refill, speculative decoding with a
full-copy draft, with a hydra trunk-shared draft and with a draft that
disagrees. Sampled decoding cannot match `jax.random` draw for draw; it
is held to the engine's own RNG contract (the port's goldens of the
reference's tests: invariance to slot geometry and batch composition,
speculative == plain when the draft is the policy) and the per-lane
sampler to its distribution."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sp_stats

from trlx_tpu.models.gen_engine import EngineSpec as JSpec
from trlx_tpu.models.gen_engine import compose_draft_params as j_compose
from trlx_tpu.models.gen_engine import engine_generate as j_engine
from trlx_tpu.models.generation import SamplerSettings as JSettings
from trlx_tpu.models.transformer import TransformerConfig as JConfig
from trlx_tpu.models.transformer import TransformerLM as JLM

from trlx_tpu_torch.models.convert import params_from_jax
from trlx_tpu_torch.models.gen_engine import (
    EngineSpec,
    GenEngineConfig,
    compose_draft_params,
    engine_generate,
    engine_generate_grouped,
    hydra_shared_trunk_layers,
)
from trlx_tpu_torch.models.generation import (
    SamplerSettings,
    lane_keys,
    lane_uniform,
    sample_token_lanes,
)
from trlx_tpu_torch.models.transformer import TransformerConfig, TransformerLM, extract_branch_params

EOS, PAD = 7, 9
TINY = dict(vocab_size=64, hidden_size=16, n_layer=2, n_head=2, n_positions=64)


@pytest.fixture(scope="module")
def models():
    jlm = JLM(JConfig(dtype=jnp.float32, **TINY))
    jparams = jlm.init(jax.random.PRNGKey(0))
    lm = TransformerLM(TransformerConfig(dtype=torch.float32, **TINY), device="cpu")
    lm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), lm.cfg))
    return jlm, jparams, lm


def _queue(Q=5, P=6, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 64, size=(Q, P)).astype(np.int32)
    mask = np.ones((Q, P), np.int32)
    mask[0, :2] = 0
    mask[3, :1] = 0
    return ids, mask


def _settings(do_sample, n=8, eos=EOS):
    return (JSettings(max_new_tokens=n, do_sample=do_sample, eos_token_id=eos, pad_token_id=PAD),
            SamplerSettings(max_new_tokens=n, do_sample=do_sample, eos_token_id=eos, pad_token_id=PAD))


def _run_jax(jlm, jparams, queue, settings, spec, draft=None, budget=None):
    ids, mask = queue
    fn = jax.jit(lambda p, d, i, m, r, b: j_engine(jlm, p, i, m, r, settings, spec, draft_params=d, row_budget=b))
    out = fn(jparams, draft, jnp.asarray(ids), jnp.asarray(mask), jax.random.PRNGKey(2),
             None if budget is None else jnp.asarray(budget))
    return jax.tree_util.tree_map(np.asarray, out)


def _run(lm, queue, settings, spec, draft=None, budget=None, seed=2):
    ids, mask = queue
    return engine_generate(lm, torch.from_numpy(ids), torch.from_numpy(mask), seed, settings, spec,
                           draft_params=draft, row_budget=None if budget is None else torch.as_tensor(budget))


def _assert_same(out, ref):
    np.testing.assert_array_equal(out["response_ids"].numpy(), ref["response_ids"])
    np.testing.assert_array_equal(out["response_mask"].numpy(), ref["response_mask"])
    np.testing.assert_array_equal(out["sequences"].numpy(), ref["sequences"])
    g, jg = out["gen_stats"], ref["gen_stats"]
    assert set(g) == set(jg)
    for k, v in jg.items():
        if k == "occupancy":
            assert g[k] == pytest.approx(float(v), rel=1e-6)
        else:
            assert g[k] == int(v), k


CASES = {  # name: (spec kwargs, queue kwargs, settings kwargs, budget)
    "paged_int8": (dict(kv_quant="int8"), {}, {}, None),
    "paged_none": (dict(kv_quant=None), {}, {}, None),
    "paged_int8_kernel_path": (dict(kv_quant="int8", paged_attention_impl="pallas"), {}, {}, None),
    "contiguous": (dict(paged=False), {}, {}, None),
    "undersized_pool": (dict(pool_pages=6), {}, {}, None),
    "instant_finish": (dict(), dict(P=12, seed=4), dict(n=2), [1] * 5),
    "budgets_no_eos": (dict(), {}, dict(eos=-1), [2, 1, 4, 1, 3]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_greedy_engine_matches_jax(models, name):
    jlm, jparams, lm = models
    spec_kw, queue_kw, st_kw, budget = CASES[name]
    queue = _queue(**queue_kw)
    jst, st = _settings(False, **st_kw)
    ref = _run_jax(jlm, jparams, queue, jst, JSpec(slots=2, page_size=4, **spec_kw), budget=budget)
    out = _run(lm, queue, st, EngineSpec(slots=2, page_size=4, **spec_kw), budget=budget)
    _assert_same(out, ref)
    if name == "undersized_pool":
        assert out["gen_stats"]["oom_truncated"] > 0
    if name == "instant_finish":
        assert out["gen_stats"]["unserved"] == 0 and out["gen_stats"]["decode_steps"] == 0


@pytest.mark.parametrize("draft_kind", ["full_copy", "hydra_shared", "hydra_shared_kernel_path", "disagreeing"])
def test_greedy_spec_decode_matches_jax(models, draft_kind):
    jlm, jparams, lm = models
    queue = _queue()
    jst, st = _settings(False, n=9)
    budget = [3, 9, 5, 1, 7]
    kw = dict(slots=2, page_size=4, spec_decode=True, draft_k=3)
    if draft_kind == "full_copy":
        jdraft, draft = jparams, lm
    elif draft_kind == "disagreeing":
        noise = np.random.default_rng(9)
        jdraft = jax.tree_util.tree_map(
            lambda x: x + 0.02 * noise.normal(size=x.shape).astype(np.float32), jax.tree_util.tree_map(np.asarray, jparams))
        draft = TransformerLM(lm.cfg, device="cpu")
        draft.load_state_dict(params_from_jax(jdraft, lm.cfg))
    else:
        jref = {"blocks": jax.tree_util.tree_map(lambda x: x[1:], jparams["blocks"]),
                **{k: v for k, v in jparams.items() if k != "blocks"}}
        jdraft = j_compose(jlm.cfg, jparams, jref)
        draft = compose_draft_params(lm.cfg, lm, extract_branch_params(lm, 1))
        kw["draft_shared_layers"] = hydra_shared_trunk_layers(2, 1)
        if draft_kind.endswith("kernel_path"):
            kw["paged_attention_impl"] = "pallas"
    ref = _run_jax(jlm, jparams, queue, jst, JSpec(**kw), draft=jdraft, budget=budget)
    out = _run(lm, queue, st, EngineSpec(**kw), draft=draft, budget=budget)
    _assert_same(out, ref)
    g = out["gen_stats"]
    assert g["free_pages"] == 1 + 2 * 5 - 1 and g["held_pages"] == 0  # drained: the pool balances
    if draft_kind != "disagreeing":
        assert g["accepted"] == g["drafted"]


def test_spec_shared_undersized_pool_matches_jax(models):
    """Refcounted release under pool starvation: the same tokens, counts
    and a balanced pool (free == pool - null) as the reference."""
    jlm, jparams, lm = models
    queue = _queue()
    jst, st = _settings(False, n=9, eos=-1)
    kw = dict(slots=2, page_size=4, spec_decode=True, draft_k=3, draft_shared_layers=1, pool_pages=6)
    jref = {"blocks": jax.tree_util.tree_map(lambda x: x[1:], jparams["blocks"]),
            **{k: v for k, v in jparams.items() if k != "blocks"}}
    ref = _run_jax(jlm, jparams, queue, jst, JSpec(**kw), draft=j_compose(jlm.cfg, jparams, jref))
    out = _run(lm, queue, st, EngineSpec(**kw), draft=compose_draft_params(lm.cfg, lm, extract_branch_params(lm, 1)))
    _assert_same(out, ref)
    g = out["gen_stats"]
    assert g["oom_truncated"] > 0 and g["held_pages"] == 0 and g["free_pages"] == 5


def test_sampled_stream_invariant_to_geometry_and_batch(models):
    """The port's own goldens of the RNG contract: slot count, page size
    and paging mode change no sampled token, and a prompt samples the same
    continuation alone in a smaller queue."""
    _, _, lm = models
    queue = _queue()
    _, st = _settings(True)
    a = _run(lm, queue, st, EngineSpec(slots=1, page_size=4))
    b = _run(lm, queue, st, EngineSpec(slots=4, page_size=8, paged=False))
    np.testing.assert_array_equal(a["response_ids"].numpy(), b["response_ids"].numpy())
    c = _run(lm, (queue[0][:3], queue[1][:3]), st, EngineSpec(slots=2, page_size=4))
    np.testing.assert_array_equal(c["response_ids"].numpy(), a["response_ids"].numpy()[:3])
    d = _run(lm, queue, st, EngineSpec(slots=1, page_size=4), seed=3)
    assert not np.array_equal(d["response_ids"].numpy(), a["response_ids"].numpy())  # the seed matters


def test_sampled_spec_equals_plain_when_draft_is_policy(models):
    _, _, lm = models
    queue = _queue()
    _, st = _settings(True, n=9, eos=-1)  # no EOS: every row runs to its budget
    budget = [3, 9, 5, 1, 7]
    base = _run(lm, queue, st, EngineSpec(slots=2, page_size=4), budget=budget)
    spec = _run(lm, queue, st, EngineSpec(slots=2, page_size=4, spec_decode=True, draft_k=3), draft=lm, budget=budget)
    np.testing.assert_array_equal(base["response_ids"].numpy(), spec["response_ids"].numpy())
    np.testing.assert_array_equal(base["response_mask"].numpy(), spec["response_mask"].numpy())
    assert spec["gen_stats"]["accepted"] == spec["gen_stats"]["drafted"]
    assert base["response_mask"].sum(1).tolist() == budget


def test_lane_sampler_frequencies_match_softmax():
    """Draws of one logits row over 20000 lane ids against its softmax
    (chi-square, p > 1e-3), and uniforms that are uniform."""
    V, M = 12, 20000
    logits = torch.from_numpy(np.random.default_rng(0).normal(size=V).astype(np.float32))
    keys = lane_keys(1234, torch.arange(M))
    toks = sample_token_lanes(keys, logits.expand(M, V), SamplerSettings(max_new_tokens=1))
    counts = np.bincount(toks.numpy(), minlength=V)
    expect = torch.softmax(logits.double(), -1).numpy()
    expect = expect / expect.sum() * M
    assert sp_stats.chisquare(counts, expect).pvalue > 1e-3
    u = lane_uniform(keys, 4).numpy().reshape(-1)
    assert 0.0 < u.min() and u.max() < 1.0
    assert sp_stats.kstest(u, "uniform").pvalue > 1e-3


def test_config_surface_and_unported_modes(models):
    _, _, lm = models
    cfg = GenEngineConfig.from_dict({"enabled": True, "slots": 4, "spec_decode": True, "draft_k": 2})
    assert cfg.enabled and cfg.draft_k == 2
    for bad, match in (({"slotz": 4}, "unknown keys"), ({"draft_k": 0}, "draft_k"),
                       ({"kv_quant": "fp4"}, "kv_quant"), ({"paged_attention_impl": "triton"}, "paged_attention_impl"),
                       ({"data_groups": 0}, "data_groups")):
        with pytest.raises(ValueError, match=match):
            GenEngineConfig.from_dict(bad)
    mcfg = TransformerConfig(vocab_size=8, hidden_size=8, n_layer=1, n_head=1, kv_cache_quant="int8")
    assert GenEngineConfig.from_dict({}).resolve(8, mcfg).kv_quant == "int8"
    assert GenEngineConfig.from_dict({"kv_quant": "none"}).resolve(8, mcfg).kv_quant is None
    assert GenEngineConfig.from_dict({"data_groups": 8}).resolve(2, mcfg).data_groups == 2
    queue = _queue()
    _, st = _settings(False)
    ids, mask = torch.from_numpy(queue[0]), torch.from_numpy(queue[1])
    with pytest.raises(NotImplementedError, match="ROADMAP queue 12"):
        engine_generate_grouped(lm, ids, mask, 0, st, EngineSpec(slots=2, data_groups=2))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 11"):
        engine_generate(lm, ids, mask, 0, st, EngineSpec(slots=2), warm={})
    # one group passes straight through
    one = engine_generate_grouped(lm, ids, mask, 0, st, EngineSpec(slots=2, page_size=4))
    two = _run(lm, queue, st, EngineSpec(slots=2, page_size=4), seed=0)
    np.testing.assert_array_equal(one["response_ids"].numpy(), two["response_ids"].numpy())
    assert dataclasses.asdict(EngineSpec(slots=1)).keys() == dataclasses.asdict(JSpec(slots=1)).keys()
