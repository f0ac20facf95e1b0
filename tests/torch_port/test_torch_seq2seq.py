"""trlx_tpu_torch's T5 model (models/seq2seq.py and Seq2SeqLMWithValueHead)
against the JAX package's on the same weights: the reference's own init,
carried over by `models/convert.py`, and inputs from numpy. Both sides run
an fp32 config on the CPU; the reference takes its XLA path (its fused path
is gated to sequence lengths divisible by 128), the port both of its paths
("pallas": the fused kernels' plain versions; "xla": the combined-bias
einsum math).

Tolerances: logits, values and reference logits atol 2e-4, gradients atol
5e-4 (fp32 sums in another order, through up to five stacked blocks and a
softmax whose scores T5 leaves unscaled); bucket integers and greedy tokens
exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.models import seq2seq as jseq
from trlx_tpu.models.generation import SamplerSettings as JSettings
from trlx_tpu.models.wrappers import Seq2SeqLMWithValueHead as JPolicy

from trlx_tpu_torch.models import seq2seq
from trlx_tpu_torch.models.convert import params_from_jax
from trlx_tpu_torch.models.generation import SamplerSettings
from trlx_tpu_torch.models.wrappers import Seq2SeqLMWithValueHead

LOGIT_TOL = dict(atol=2e-4, rtol=0)
GRAD_TOL = dict(atol=5e-4, rtol=0)
TINY = dict(vocab_size=300, d_model=32, n_layer=2, n_decoder_layer=3, n_head=4, d_kv=8, d_ff=64,
            relative_attention_num_buckets=8, relative_attention_max_distance=20,
            decoder_start_token_id=257)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _lms(impl="xla", seed=0, **kw):
    """(JAX T5LM, its params, the port's T5LM with the same weights)."""
    arch = dict(TINY, **kw)
    jlm = jseq.T5LM(jseq.Seq2SeqConfig(dtype=jnp.float32, **arch))
    jparams = jlm.init(jax.random.PRNGKey(seed))
    cfg = seq2seq.Seq2SeqConfig(dtype=torch.float32, attention_impl=impl, **arch)
    lm = seq2seq.T5LM(cfg, device="cpu")
    lm.load_state_dict(params_from_jax(_np(jparams), cfg))
    return jlm, jparams, lm


def _batch(seed=0, B=3, S=7, T=6):
    rng = np.random.default_rng(seed)
    enc = rng.integers(0, 256, size=(B, S)).astype(np.int32)
    enc_mask = np.ones((B, S), np.int32)
    enc_mask[0, :3] = 0  # left padding
    enc_mask[1, -2:] = 0  # right padding
    enc[enc_mask == 0] = 257
    dec = rng.integers(0, 256, size=(B, T)).astype(np.int32)
    dec[:, 0] = 257  # the decoder start token
    dec_mask = np.ones((B, T), np.int32)
    dec_mask[1, 4:] = 0  # a padded response tail
    dec_mask[2, 2:] = 0
    return enc, enc_mask, dec, dec_mask


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("buckets,max_distance", [(32, 128), (8, 20)])
def test_relative_position_bucket_exact(bidirectional, buckets, max_distance):
    """The same bucket integers as the reference, distances past
    max_distance (and past 128) included."""
    rel = np.arange(-700, 701, dtype=np.int32)
    want = np.asarray(jseq.relative_position_bucket(jnp.asarray(rel), bidirectional, buckets, max_distance))
    got = seq2seq.relative_position_bucket(torch.from_numpy(rel), bidirectional, buckets, max_distance)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("T,S", [(9, 9), (5, 12), (12, 5)])
def test_position_bias_dense_equals_gather(T, S):
    """The Toeplitz construction equals the direct gather, and both equal
    the reference's dense bias, exactly."""
    table = np.random.default_rng(1).normal(size=(8, 4)).astype(np.float32)
    for bidirectional in (True, False):
        dense = seq2seq.compute_position_bias_dense(torch.from_numpy(table), T, S, bidirectional, 8, 20)
        gather = seq2seq.compute_position_bias(torch.from_numpy(table), torch.arange(T), torch.arange(S),
                                               bidirectional, 8, 20)
        want = jseq.compute_position_bias_dense(jnp.asarray(table), T, S, bidirectional, 8, 20)
        assert dense.shape == (1, 4, T, S)
        np.testing.assert_array_equal(dense.numpy(), gather.numpy())
        np.testing.assert_array_equal(dense.numpy(), np.asarray(want))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("activation,tied", [("relu", True), ("gated-gelu", True), ("relu", False),
                                             ("gated-gelu", False)])
def test_t5_logits_match_jax(impl, activation, tied):
    jlm, jparams, lm = _lms(impl, activation=activation, tie_word_embeddings=tied)
    enc, enc_mask, dec, dec_mask = _batch()
    want = jlm(jparams, *map(jnp.asarray, (enc, enc_mask, dec, dec_mask)))
    got = lm(*_t(enc, enc_mask, dec, dec_mask))
    np.testing.assert_allclose(got["logits"].detach().numpy(), np.asarray(want["logits"]), **LOGIT_TOL)
    np.testing.assert_allclose(got["encoder_hidden"].detach().numpy(), np.asarray(want["encoder_hidden"]),
                               **LOGIT_TOL)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_t5_gradients_match_jax(impl):
    """The gradient of every parameter, both relative-bias tables and the
    untied head included, against jax.grad of the same loss."""
    jlm, jparams, lm = _lms(impl, tie_word_embeddings=False)
    enc, enc_mask, dec, dec_mask = _batch(seed=2)
    ct = np.random.default_rng(3).normal(size=dec.shape + (TINY["vocab_size"],)).astype(np.float32)

    def j_loss(p):
        return jnp.sum(jlm(p, *map(jnp.asarray, (enc, enc_mask, dec, dec_mask)))["logits"] * ct) / 100

    jgrads = params_from_jax(_np(jax.grad(j_loss)(jparams)), lm.cfg)
    loss = (lm(*_t(enc, enc_mask, dec, dec_mask))["logits"] * torch.from_numpy(ct)).sum() / 100
    loss.backward()
    grads = dict(lm.named_parameters())
    assert set(grads) == set(jgrads)
    for name, p in grads.items():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name].numpy(), err_msg=name, **GRAD_TOL)
    assert grads["encoder.rel_bias"].grad.abs().sum() > 0 and grads["decoder.rel_bias"].grad.abs().sum() > 0


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_hydra_forward_train_matches_jax(impl):
    """The hydra pass (branch_at=1: the top two decoder blocks re-run
    frozen over the shared encoder output): policy logits, values and
    reference logits."""
    jcfg = jseq.Seq2SeqConfig(dtype=jnp.float32, **TINY)
    jpolicy = JPolicy(jcfg, branch_at=1)
    jparams = jpolicy.init_params(jax.random.PRNGKey(4))
    cfg = seq2seq.Seq2SeqConfig(dtype=torch.float32, attention_impl=impl, **TINY)
    policy = Seq2SeqLMWithValueHead(cfg, branch_at=1, device="cpu")
    policy.load_state_dict(params_from_jax(_np(jparams), cfg))
    enc, enc_mask, dec, dec_mask = _batch(seed=5)
    want = jpolicy.forward_train(jparams, jpolicy.make_ref_params(jparams),
                                 *map(jnp.asarray, (enc, enc_mask, dec, dec_mask)))
    ref = policy.make_ref_params()
    assert len(ref.blocks) == 2 and not any(p.requires_grad for p in ref.parameters())
    with torch.no_grad():
        got = policy.forward_train(ref, *_t(enc, enc_mask, dec, dec_mask))
    for key in ("logits", "values", "ref_logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), err_msg=key, **LOGIT_TOL)


def test_cached_decode_step_equals_teacher_forced():
    """Step-by-step decoding over the KV cache gives the teacher-forced
    logits of the same decoder sequence, position by position."""
    _, _, lm = _lms("xla", seed=6)
    enc, enc_mask, dec, _ = _batch(seed=7)
    enc, enc_mask, dec = _t(enc, enc_mask, dec)
    with torch.no_grad():
        full = lm(enc, enc_mask, dec)
        cache = lm.init_cache(dec.shape[0], dec.shape[1])
        steps = []
        for t in range(dec.shape[1]):
            out, cache = lm.decode_step(dec[:, t:t + 1], full["encoder_hidden"], enc_mask, cache)
            steps.append(out["logits"])
    np.testing.assert_allclose(torch.cat(steps, dim=1).numpy(), full["logits"].numpy(), **LOGIT_TOL)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_greedy_generate_matches_jax(impl):
    """Greedy `generate_seq2seq` token for token against the reference's,
    with an EOS that some rows reach (the masks then cover the EOS and
    pad the rest)."""
    jlm, jparams, lm = _lms(impl, seed=8)
    enc, enc_mask, _, _ = _batch(seed=9)
    with torch.no_grad():
        probe = seq2seq.generate_seq2seq(lm, *_t(enc, enc_mask), None,
                                         SamplerSettings(max_new_tokens=8, do_sample=False))
    eos = int(probe["response_ids"][0, 2])  # row 0 stops at its third token or before
    settings = dict(max_new_tokens=8, do_sample=False, eos_token_id=eos, pad_token_id=257)
    want = jseq.generate_seq2seq(jlm, jparams, jnp.asarray(enc), jnp.asarray(enc_mask),
                                 jax.random.PRNGKey(0), JSettings(**settings))
    with torch.no_grad():
        got = seq2seq.generate_seq2seq(lm, *_t(enc, enc_mask), None, SamplerSettings(**settings))
    for key in ("sequences", "response_ids", "response_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    k = got["response_ids"][0].tolist().index(eos) + 1
    assert k < 8 and got["response_mask"][0].tolist() == [1] * k + [0] * (8 - k)
    np.testing.assert_allclose(got["encoder_hidden"].numpy(), np.asarray(want["encoder_hidden"]), **LOGIT_TOL)


def test_unported_knobs_raise():
    """Pipeline parallelism raises; int8 decode weights, which raised until
    the port reached them, build (test_torch_decode_weights.py), and a
    quantization the reference does not have is refused."""
    seq2seq.T5LM(seq2seq.Seq2SeqConfig(decode_weights_quant="int8", **TINY), device="cpu")
    with pytest.raises(ValueError, match="decode_weights_quant"):
        seq2seq.T5LM(seq2seq.Seq2SeqConfig(decode_weights_quant="int4", **TINY), device="cpu")
    with pytest.raises(NotImplementedError, match="queue 12"):
        seq2seq.T5LM(seq2seq.Seq2SeqConfig(pp_microbatches=2, **TINY), device="cpu")
