"""trlx_tpu_torch's sampler against the JAX package's.

Greedy decoding is held token for token (fp32 tiny config, left-padded
prompts, the same converted weights) for each KV-cache kind; sampled
decoding draws from a torch.Generator, whose stream cannot reproduce
jax.random, so it is held by its support and its frequencies."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.models.generation import SamplerSettings as JSettings
from trlx_tpu.models.generation import make_generate_fn as j_make_generate_fn
from trlx_tpu.models.generation import process_logits as j_process_logits
from trlx_tpu.models.transformer import TransformerConfig as JConfig
from trlx_tpu.models.transformer import TransformerLM as JLM
from trlx_tpu.models.transformer import quantize_kv_cache as j_quantize_kv_cache

from trlx_tpu_torch.models.convert import params_from_jax
from trlx_tpu_torch.models.generation import (
    SamplerSettings,
    generate,
    process_logits,
    sample_token,
)
from trlx_tpu_torch.models.transformer import TransformerConfig, TransformerLM, quantize_kv_cache

TINY = dict(vocab_size=300, hidden_size=32, n_layer=2, n_head=2, n_positions=128)


def _models(quant, impl="pallas"):
    jcfg = JConfig(dtype=jnp.float32, attention_impl=impl, kv_cache_quant=quant, **TINY)
    jlm = JLM(jcfg)
    jparams = jlm.init(jax.random.PRNGKey(7))
    cfg = TransformerConfig(dtype=torch.float32, attention_impl=impl, kv_cache_quant=quant, **TINY)
    lm = TransformerLM(cfg, device="cpu")
    lm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg))
    return jlm, jparams, lm


def _prompts(B=3, P=8, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 258, size=(B, P)).astype(np.int32)
    mask = np.ones((B, P), np.int32)
    mask[0, :3] = 0
    mask[2, :5] = 0
    ids[mask == 0] = 257  # the byte tokenizer's pad
    return ids, mask


@pytest.mark.parametrize("quant", [None, "int8", "int8_kernel"])
def test_greedy_matches_jax_token_for_token(quant):
    """P = 8 under attention_impl="pallas": the reference rounds the cache
    to 128 slots and runs its flash prefill, and with "int8_kernel" its
    int8 decode kernel, so both sides run the same kernels' math."""
    jlm, jparams, lm = _models(quant)
    ids, mask = _prompts()
    N = 10
    ref = j_make_generate_fn(jlm, JSettings(max_new_tokens=N, do_sample=False))(
        jparams, jnp.asarray(ids), jnp.asarray(mask), jax.random.PRNGKey(0)
    )
    out = generate(
        lm, torch.from_numpy(ids), torch.from_numpy(mask), None,
        SamplerSettings(max_new_tokens=N, do_sample=False),
    )
    np.testing.assert_array_equal(out["sequences"].numpy(), np.asarray(ref["sequences"]))
    np.testing.assert_array_equal(out["response_mask"].numpy(), np.asarray(ref["response_mask"]))


def test_eos_early_exit_matches_jax():
    """Rows stop at their EOS and emit pad afterwards; the loop exits once
    every row has finished — the same response_mask as the reference."""
    jlm, jparams, lm = _models(None, impl="xla")
    ids, mask = _prompts(seed=1)
    N = 12
    probe = generate(lm, torch.from_numpy(ids), torch.from_numpy(mask), None,
                     SamplerSettings(max_new_tokens=N, do_sample=False))
    eos = int(probe["response_ids"][0, 2])  # row 0 finishes by step 2
    first = int(np.argmax(probe["response_ids"][0].numpy() == eos))
    kw = dict(max_new_tokens=N, do_sample=False, eos_token_id=eos, pad_token_id=257)
    ref = j_make_generate_fn(jlm, JSettings(**kw))(
        jparams, jnp.asarray(ids), jnp.asarray(mask), jax.random.PRNGKey(0)
    )
    out = generate(lm, torch.from_numpy(ids), torch.from_numpy(mask), None, SamplerSettings(**kw))
    np.testing.assert_array_equal(out["sequences"].numpy(), np.asarray(ref["sequences"]))
    np.testing.assert_array_equal(out["response_mask"].numpy(), np.asarray(ref["response_mask"]))
    assert out["response_mask"][0].sum() == first + 1


def test_quantize_kv_cache_matches_jax():
    """On the same fp32 cache the int8 values and scales are
    identical: both sides divide, round half to even and clip in the same
    order. Caches each side built itself from a prefill differ in the
    last bits of K/V (matmul summation order), which may move a value
    across a rounding boundary: at most 0.1% of entries, by one LSB."""
    rng = np.random.default_rng(3)
    L, B, S, Hkv, D = 2, 2, 16, 2, 8
    k = rng.normal(size=(L, B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(L, B, S, Hkv, D)).astype(np.float32)
    k[:, :, 12:] = 0  # unwritten slots
    v[:, :, 12:] = 0
    ref = j_quantize_kv_cache({"k": jnp.asarray(k), "v": jnp.asarray(v), "index": 0})
    got = quantize_kv_cache({"k": torch.from_numpy(k), "v": torch.from_numpy(v), "index": 0})
    for key in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)

    jlm, jparams, lm = _models(None, impl="xla")
    ids, mask = _prompts(seed=2)
    jcache = jlm(jparams, jnp.asarray(ids), jnp.asarray(mask),
                 cache=jlm.init_cache(3, 16, jnp.asarray(np.pad(mask, ((0, 0), (0, 8))))),
                 compute_logits=False)["cache"]
    cache = lm(torch.from_numpy(ids), torch.from_numpy(mask),
               cache=lm.init_cache(3, 16, torch.from_numpy(np.pad(mask, ((0, 0), (0, 8))))),
               compute_logits=False)["cache"]
    jq, q = j_quantize_kv_cache(jcache), quantize_kv_cache(cache)
    for key in ("k", "v"):
        diff = np.abs(q[key].numpy().astype(np.int32) - np.asarray(jq[key]).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, key


@pytest.mark.parametrize(
    "kw", [dict(temperature=0.7), dict(top_k=5), dict(top_p=0.8), dict(temperature=1.3, top_k=7, top_p=0.9)]
)
def test_process_logits_matches_jax(kw):
    logits = np.random.default_rng(4).normal(size=(4, 64)).astype(np.float32) * 3
    ref = np.asarray(j_process_logits(jnp.asarray(logits), JSettings(max_new_tokens=1, **kw)))
    got = process_logits(torch.from_numpy(logits), SamplerSettings(max_new_tokens=1, **kw)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(ref))
    finite = np.isfinite(ref)
    np.testing.assert_allclose(got[finite], ref[finite], atol=1e-6, rtol=0)


def test_sampled_tokens_stay_in_top_k_top_p_support():
    logits = torch.from_numpy(np.random.default_rng(5).normal(size=(8, 40)).astype(np.float32) * 2)
    settings = SamplerSettings(max_new_tokens=1, top_k=6, top_p=0.7)
    support = torch.isfinite(process_logits(logits, settings))
    gen = torch.Generator().manual_seed(0)
    for _ in range(50):
        tok = sample_token(gen, logits, settings)
        assert support[torch.arange(8), tok].all()


def test_sampled_frequencies_follow_softmax():
    logits = torch.from_numpy(np.random.default_rng(6).normal(size=(1, 16)).astype(np.float32))
    probs = torch.softmax(logits[0], dim=-1).numpy()
    gen = torch.Generator().manual_seed(1)
    draws = sample_token(gen, logits.expand(20000, 16), SamplerSettings(max_new_tokens=1))
    freq = np.bincount(draws.numpy(), minlength=16) / 20000
    assert np.abs(freq - probs).max() < 0.02


def test_from_gen_kwargs_ignores_stray_hf_keys(caplog):
    with caplog.at_level(logging.WARNING):
        s = SamplerSettings.from_gen_kwargs(
            dict(max_new_tokens=9, top_k=0, top_p=1.0, do_sample=True,
                 num_beams=1, repetition_penalty=1.0, beta=1.0),
            eos_token_id=257, pad_token_id=257,
        )
    assert s == SamplerSettings(max_new_tokens=9, eos_token_id=257, pad_token_id=257)
    assert "num_beams" in caplog.text
