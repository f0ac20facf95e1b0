"""Int8 decode weights (`decode_weights_quant="int8"`) in trlx_tpu_torch
against trlx_tpu's `quantize_decode_weights`, on the CPU (kernel 10's plain
version).

Held exactly: the decode copy's int8 payloads of every block projection
(quantized from the compute-dtype rounding of the weights, fp32 and bf16),
with scales to 1e-6 relative; greedy rollouts token for token in fp32 on
the same converted weights: the static sampler over each KV-cache kind,
the decode engine with a full-copy and a hydra trunk-shared draft, and
T5's decoder (the encoder stays in full precision, as in the reference).
The training weights are never touched."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.models import seq2seq as jseq
from trlx_tpu.models.gen_engine import EngineSpec as JSpec
from trlx_tpu.models.gen_engine import compose_draft_params as j_compose
from trlx_tpu.models.gen_engine import engine_generate as j_engine
from trlx_tpu.models.generation import SamplerSettings as JSettings
from trlx_tpu.models.generation import cast_params_for_decode as j_cast
from trlx_tpu.models.generation import make_generate_fn as j_make_generate_fn
from trlx_tpu.models.transformer import TransformerConfig as JConfig
from trlx_tpu.models.transformer import TransformerLM as JLM
from trlx_tpu.models.transformer import quantize_decode_weights as j_quantize

from trlx_tpu_torch.models import seq2seq
from trlx_tpu_torch.models.convert import params_from_jax
from trlx_tpu_torch.models.gen_engine import (
    EngineSpec,
    compose_draft_params,
    engine_generate,
    hydra_shared_trunk_layers,
)
from trlx_tpu_torch.models.generation import SamplerSettings, cast_params_for_decode, generate
from trlx_tpu_torch.models.transformer import TransformerConfig, TransformerLM, extract_branch_params
from trlx_tpu_torch.ops.int8_matmul import (
    SMS,
    STREAM_MAX_ROWS,
    STREAM_MIN_CTAS,
    check_decode_dtype,
    int8_matmul_route,
    int8_matmul_tilings,
    int8_weight_matmul,
    int8_weight_matmul_plain,
    quantize_kernel,
)

TINY = dict(vocab_size=300, hidden_size=32, n_layer=2, n_head=2, n_positions=128)
T5_TINY = dict(vocab_size=300, d_model=32, n_layer=2, n_decoder_layer=3, n_head=4, d_kv=8, d_ff=64,
               relative_attention_num_buckets=8, relative_attention_max_distance=20, decoder_start_token_id=257)
EOS, PAD = 7, 9


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(quant=None, impl="pallas", dtype="float32", seed=7, **arch):
    arch = dict(TINY, **arch)
    jcfg = JConfig(dtype=getattr(jnp, dtype), attention_impl=impl, kv_cache_quant=quant,
                   decode_weights_quant="int8", **arch)
    jlm = JLM(jcfg)
    jparams = jlm.init(jax.random.PRNGKey(seed))
    cfg = TransformerConfig(dtype=dtype, attention_impl=impl, kv_cache_quant=quant, decode_weights_quant="int8",
                            **arch)
    lm = TransformerLM(cfg, device="cpu")
    lm.load_state_dict(params_from_jax(_np(jparams), cfg))
    return jlm, jparams, lm


def _prompts(B=3, P=8, seed=0, vocab=258):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(B, P)).astype(np.int32)
    mask = np.ones((B, P), np.int32)
    mask[0, :3] = 0
    mask[2, :5] = 0
    ids[mask == 0] = PAD
    return ids, mask


def _projections(blocks_tree, stacked_modules, E):
    """(name, reference [in, out] int8 kernel, its scales, the port's module)
    for every projection of every block."""
    out = []
    for i, block in enumerate(stacked_modules):
        for group, names in blocks_tree.items():
            for name, leaf in names.items():
                if not isinstance(leaf, dict) or "kernel_scale" not in leaf:
                    continue
                k = np.asarray(leaf["kernel"][i])
                k = k.reshape(-1, k.shape[-1]) if name in ("o",) else k.reshape(k.shape[0], -1)
                mod = getattr(getattr(block, group), name)
                out.append((f"{i}.{group}.{name}", k, np.asarray(leaf["kernel_scale"][i]).reshape(-1), mod))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_copy_payloads_match_reference(dtype):
    """Every block projection int8 with the reference's payloads (from the
    compute-dtype rounding); embeddings and the head in the compute dtype;
    the training model untouched."""
    jlm, jparams, lm = _models(dtype=dtype, tie_word_embeddings=False)
    want = j_quantize(j_cast(jparams, getattr(jnp, dtype)))
    copy = cast_params_for_decode(lm, lm.cfg.dtype)
    cases = _projections(want["blocks"], copy.blocks, TINY["hidden_size"])
    assert len(cases) == 6 * TINY["n_layer"]
    for name, jk, js, mod in cases:
        assert mod.kernel.dtype == torch.int8, name
        np.testing.assert_array_equal(mod.kernel.numpy(), jk, err_msg=name)
        np.testing.assert_allclose(mod.kernel_scale.numpy(), js, rtol=1e-6, atol=0, err_msg=name)
    assert copy.embed.wte.dtype == copy.lm_head.kernel.dtype == lm.cfg.dtype
    assert all(p.dtype == torch.float32 and m.kernel_scale is None
               for m in lm.modules() if hasattr(m, "kernel_scale") for p in (m.kernel,))


@pytest.mark.parametrize("quant", [None, "int8", "int8_kernel"])
def test_greedy_static_sampler_matches_reference(quant):
    jlm, jparams, lm = _models(quant)
    ids, mask = _prompts()
    N = 10
    ref = j_make_generate_fn(jlm, JSettings(max_new_tokens=N, do_sample=False))(
        jparams, jnp.asarray(ids), jnp.asarray(mask), jax.random.PRNGKey(0))
    out = generate(lm, torch.from_numpy(ids), torch.from_numpy(mask), None,
                   SamplerSettings(max_new_tokens=N, do_sample=False))
    np.testing.assert_array_equal(out["sequences"].numpy(), np.asarray(ref["sequences"]))
    np.testing.assert_array_equal(out["response_mask"].numpy(), np.asarray(ref["response_mask"]))


@pytest.mark.parametrize("draft_kind", ["full_copy", "hydra_shared"])
def test_greedy_engine_matches_reference(draft_kind):
    """The engine quantizes the policy and the draft for prefill and every
    decode and verify step, as the reference does."""
    jlm, jparams, lm = _models(None, impl="xla", vocab_size=64, hidden_size=16, n_positions=64, seed=0)
    ids, mask = _prompts(B=5, P=6, seed=1, vocab=64)
    jst = JSettings(max_new_tokens=9, do_sample=False, eos_token_id=EOS, pad_token_id=PAD)
    st = SamplerSettings(max_new_tokens=9, do_sample=False, eos_token_id=EOS, pad_token_id=PAD)
    kw = dict(slots=2, page_size=4, spec_decode=True, draft_k=3)
    if draft_kind == "full_copy":
        jdraft, draft = jparams, lm
    else:
        jref = {"blocks": jax.tree_util.tree_map(lambda x: x[1:], jparams["blocks"]),
                **{k: v for k, v in jparams.items() if k != "blocks"}}
        jdraft = j_compose(jlm.cfg, jparams, jref)
        draft = compose_draft_params(lm.cfg, lm, extract_branch_params(lm, 1))
        kw["draft_shared_layers"] = hydra_shared_trunk_layers(2, 1)
    budget = [3, 9, 5, 1, 7]
    fn = jax.jit(lambda p, d, i, m, r, b: j_engine(jlm, p, i, m, r, jst, JSpec(**kw), draft_params=d, row_budget=b))
    ref = _np(fn(jparams, jdraft, jnp.asarray(ids), jnp.asarray(mask), jax.random.PRNGKey(2), jnp.asarray(budget)))
    out = engine_generate(lm, torch.from_numpy(ids), torch.from_numpy(mask), 2, st, EngineSpec(**kw),
                          draft_params=draft, row_budget=torch.as_tensor(budget))
    for key in ("response_ids", "response_mask", "sequences"):
        np.testing.assert_array_equal(out[key].numpy(), ref[key], err_msg=key)
    assert out["gen_stats"]["accepted"] == out["gen_stats"]["drafted"] == int(ref["gen_stats"]["drafted"])


def test_greedy_t5_matches_reference():
    """T5: the decoder's projections (self- and cross-attention, MLP) go
    int8, the encoder does not; greedy `generate_seq2seq` token for token."""
    jlm = jseq.T5LM(jseq.Seq2SeqConfig(dtype=jnp.float32, decode_weights_quant="int8", **T5_TINY))
    jparams = jlm.init(jax.random.PRNGKey(8))
    cfg = seq2seq.Seq2SeqConfig(dtype=torch.float32, attention_impl="pallas", decode_weights_quant="int8", **T5_TINY)
    lm = seq2seq.T5LM(cfg, device="cpu")
    lm.load_state_dict(params_from_jax(_np(jparams), cfg))
    copy = cast_params_for_decode(lm, cfg.dtype)
    want = j_quantize(jparams["decoder"])
    cases = _projections(want["blocks"], copy.decoder.blocks, T5_TINY["d_model"])
    assert len(cases) == 10 * T5_TINY["n_decoder_layer"]
    for name, jk, js, mod in cases:
        np.testing.assert_array_equal(mod.kernel.numpy(), jk, err_msg=name)
        np.testing.assert_allclose(mod.kernel_scale.numpy(), js, rtol=1e-6, atol=0, err_msg=name)
    assert all(m.kernel.dtype == torch.float32 for m in copy.encoder.modules() if hasattr(m, "kernel_scale"))
    rng = np.random.default_rng(9)
    enc = rng.integers(0, 256, size=(3, 7)).astype(np.int32)
    enc_mask = np.ones((3, 7), np.int32)
    enc_mask[0, :3] = 0
    settings = dict(max_new_tokens=8, do_sample=False, eos_token_id=-1, pad_token_id=257)
    ref = jseq.generate_seq2seq(jlm, jparams, jnp.asarray(enc), jnp.asarray(enc_mask), jax.random.PRNGKey(0),
                                JSettings(**settings))
    with torch.no_grad():
        got = seq2seq.generate_seq2seq(lm, torch.from_numpy(enc), torch.from_numpy(enc_mask), None,
                                       SamplerSettings(**settings))
    for key in ("sequences", "response_ids", "response_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)


@pytest.mark.parametrize("M,K,N", [(1, 64, 48), (5, 96, 32)])
def test_w8a16_plain_product(M, K, N):
    """The wrapper takes the plain version on CPU tensors: (x . q) * s in
    fp32, one rounding to x's dtype; the scale of a zero column is 0."""
    rng = np.random.default_rng(M)
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    w[:, 3] = 0.0
    q, s = quantize_kernel(w)
    assert s[3] == 0 and not q[:, 3].any()
    x = torch.from_numpy(rng.standard_normal((2, M, K)).astype(np.float32)).bfloat16()
    want = ((x.float() @ q.float()) * s).bfloat16()
    assert torch.equal(int8_weight_matmul(x, q, s), want)
    assert torch.equal(int8_weight_matmul_plain(x, q, s), want)
    torch.testing.assert_close(q.float() * s, w, atol=float(s.max()) / 2 + 1e-7, rtol=0)


@pytest.mark.parametrize("M", [1, 8, 16, 32, 64, 2048, 3840])
def test_w8a16_route_covers_the_product(M):
    """Kernel 10's route and tiling (`int8_matmul_route`) at every width of
    GPT-2, T5 and Llama-2-7B and at K not a multiple of 64: a tiling the
    kernel is built for; the decode route for at most 64 rows with the least
    row tile that holds them all, its channel tiles 32 wide while that gives
    the card STREAM_MIN_CTAS CTAs; the prefill route past 64 rows, its tiles
    256 rows when that gives each SM a CTA, else 128, with K split over the
    fewest of 2, 4 or 8 CTAs that give each SM one when 128-row tiles do
    not, keeping at least two 64-deep stages a CTA, and the splits' stages
    covering K."""
    tilings = set(int8_matmul_tilings())
    for K in (768, 3072, 4096, 11008, 776, 4104):
        stages = -(-K // 64)
        for N in (768, 2304, 3072, 4096, 11008, 16):
            route, rows, cols, splits = int8_matmul_route(M, N, K)
            assert (route, rows, cols) in tilings, (M, K, N)
            tiles = -(-M // rows) * -(-N // cols)
            if M <= STREAM_MAX_ROWS:
                assert route == "stream" and splits == 1, (M, K, N)
                assert rows == min(r for r in (8, 16, 32, 64) if r >= M), (M, K, N)
                assert (cols == 32) == (-(-N // 32) >= STREAM_MIN_CTAS), (M, K, N)
                continue
            assert route == "wgmma" and cols == 128, (M, K, N)
            assert (rows == 256) == (-(-M // 256) * -(-N // 128) >= SMS), (M, K, N)
            assert splits in (1, 2, 4, 8) and (splits == 1 or rows == 128), (M, K, N)
            assert -(-stages // splits) * splits >= stages and 2 * splits <= max(stages, 2), (M, K, N)
            assert splits == 1 or tiles * splits // 2 < SMS, (M, K, N)  # the fewest splits
            assert splits == 8 or tiles * splits >= SMS or 4 * splits > stages, (M, K, N)  # enough
    for bad in ((M, 24, 768), (M, 768, 20)):
        with pytest.raises(ValueError, match="kernel 10 takes"):
            int8_matmul_route(*bad)


def test_int8_decode_weights_refuse_non_bf16_on_cuda():
    """Kernel 10 takes bf16 activations: int8 decode weights with another
    compute dtype raise on a CUDA device before any launch; the CPU's plain
    version takes any dtype."""
    check_decode_dtype(torch.device("cuda"), torch.bfloat16)
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        check_decode_dtype(torch.device("cpu"), dtype)
    for dtype in (torch.float32, torch.float16):
        with pytest.raises(NotImplementedError, match="kernel 10 takes bf16"):
            check_decode_dtype(torch.device("cuda", 0), dtype)
