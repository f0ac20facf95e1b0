"""trlx_tpu_torch's Llama, GPT-J and untied GPT-2 switches against the JAX
package on the same weights.

Three switch sets on tiny fp32 configs, on the CPU: Llama (rotary neox
style at rope_theta 500, RMSNorm without bias, the gated SiLU MLP, no
biases, an untied head, GQA 4 -> 2), GPT-J (rotary gptj style over a
partial rotary_dim of 8, the parallel residual, bias-free attention, an
untied head) and GPT-2 with an untied head. The weights come from the
reference's own init with every norm scale and bias perturbed by
N(0, 0.5) (so that a norm read in the wrong place shows), converted with
models/convert.py; inputs from numpy. Tolerances: logits and hidden
states atol 1e-5 (fp32; the frameworks sum in other orders), greedy
tokens exact, the PPO loop at test_torch_trainer.py's bars. Then the
kernels' plain versions at head width 128 (the width the CUDA kernels
gained for the Llama family) against the JAX Pallas kernels in interpret
mode, at the tolerances of the head width 64 tests, and the route tables
at 128."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.models.gen_engine import EngineSpec as JSpec
from trlx_tpu.models.gen_engine import compose_draft_params as j_compose
from trlx_tpu.models.gen_engine import engine_generate as j_engine
from trlx_tpu.models.generation import SamplerSettings as JSettings
from trlx_tpu.models.generation import make_generate_fn as j_make_generate_fn
from trlx_tpu.models.transformer import TransformerConfig as JConfig
from trlx_tpu.models.transformer import TransformerLM as JLM
from trlx_tpu.models.wrappers import CausalLMWithValueHead as JPolicy
from trlx_tpu.ops import paged_kv as jkv
from trlx_tpu.ops.decode_attention import decode_attention_int8 as j_decode
from trlx_tpu.ops.decode_attention import paged_attention_step as j_step
from trlx_tpu.ops.flash_attention import _flash_backward, _flash_forward

from tests.torch_port import ppo_parity
from trlx_tpu_torch.models.convert import params_from_jax
from trlx_tpu_torch.models.gen_engine import EngineSpec, compose_draft_params, engine_generate
from trlx_tpu_torch.models.generation import SamplerSettings, generate
from trlx_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    extract_branch_params,
)
from trlx_tpu_torch.models.wrappers import CausalLMWithValueHead
from trlx_tpu_torch.ops import paged_kv
from trlx_tpu_torch.ops.decode_attention import decode_attention_int8, paged_attention_step
from trlx_tpu_torch.ops.flash_attention import (
    backward_route,
    flash_attention,
    flash_attention_backward_plain,
    forward_route,
)

ATOL = 1e-5
BASE = dict(vocab_size=300, hidden_size=64, n_layer=3, n_head=4, n_positions=128)
ARCHS = {
    "llama": dict(BASE, n_kv_head=2, intermediate_size=96, pos_embed="rotary", rope_theta=500.0, norm="rmsnorm",
                  mlp_gated=True, activation="silu", use_attn_bias=False, use_mlp_bias=False, use_norm_bias=False,
                  tie_word_embeddings=False),
    "gptj": dict(BASE, pos_embed="rotary", rotary_style="gptj", rotary_dim=8, parallel_residual=True,
                 use_attn_bias=False, tie_word_embeddings=False),
    "gpt2_untied": dict(BASE, tie_word_embeddings=False),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb(tree, seed=0):
    """Every norm scale and every bias + N(0, 0.5), from numpy."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = getattr(path[-1], "key", None)
        return x + rng.normal(0, 0.5, x.shape).astype(np.float32) if name in ("scale", "bias") else x

    return jax.tree_util.tree_map_with_path(leaf, _np(tree))


def _batch(seed=1, B=3, T=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 300, size=(B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[0, :5] = 0  # left padding
    mask[1, :1] = 0
    return ids, mask


def _lms(arch, impl="xla", **kw):
    jcfg = JConfig(dtype=jnp.float32, attention_impl=impl, **ARCHS[arch], **kw)
    jlm = JLM(jcfg)
    jparams = _perturb(jlm.init(jax.random.PRNGKey(3)))
    cfg = TransformerConfig(dtype=torch.float32, attention_impl=impl, **ARCHS[arch], **kw)
    lm = TransformerLM(cfg, device="cpu")
    lm.load_state_dict(params_from_jax(jparams, cfg))
    return jlm, jax.tree_util.tree_map(jnp.asarray, jparams), lm


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_lm_logits_and_hidden_match(arch, impl):
    jlm, jparams, lm = _lms(arch, impl)
    ids, mask = _batch()
    ref = jlm(jparams, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        out = lm(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(ref["logits"]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out["hidden_states"].numpy(), np.asarray(ref["hidden_states"]), atol=ATOL, rtol=0)


def test_parameter_trees_match():
    """The port's parameters are the reference's leaves, one for one: no
    wpe under rotary, no ln_2 under the parallel residual, no biases where
    they are off, an lm_head where untied, fc_gate where gated."""
    for arch in ARCHS:
        jlm, jparams, lm = _lms(arch)
        assert sum(x.size for x in jax.tree_util.tree_leaves(jparams)) == sum(p.numel() for p in lm.parameters())
    names = dict(_lms("llama")[2].named_parameters())
    assert "lm_head.kernel" in names and "blocks.0.mlp.fc_gate.kernel" in names
    assert "embed.wpe" not in names and not any(n.endswith(".bias") for n in names)
    gptj = dict(_lms("gptj")[2].named_parameters())
    assert not any(".ln_2." in n for n in gptj) and "blocks.0.attn.q.bias" not in gptj


@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_train_matches(arch):
    """The hydra reference over the top block and a value branch over the
    top block: logits, values and reference logits."""
    kw = ARCHS[arch]
    jmodel = JPolicy(JConfig(dtype=jnp.float32, attention_impl="pallas", **kw), branch_at=2, value_branch_at=2)
    jparams = _perturb(jmodel.init_params(jax.random.PRNGKey(5)))
    cfg = TransformerConfig(dtype=torch.float32, attention_impl="pallas", **kw)
    model = CausalLMWithValueHead(cfg, branch_at=2, value_branch_at=2, device="cpu")
    model.load_state_dict(params_from_jax(jparams, cfg))
    jparams = jax.tree_util.tree_map(jnp.asarray, jparams)
    ids, mask = _batch(2)
    ref = jmodel.forward_train(jparams, jmodel.make_ref_params(jparams), jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        out = model.forward_train(model.make_ref_params(), torch.from_numpy(ids), torch.from_numpy(mask))
    for key in ("logits", "values", "ref_logits"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("arch", ["llama", "gptj"])
def test_ilql_heads_over_the_trunk(arch):
    """ILQL's wrapper over an untied, bias-free RMSNorm (or parallel
    residual) trunk: the logits at the actions and the Q, target Q and V
    heads, from the same (converted, perturbed) weights."""
    from trlx_tpu.models.wrappers import CausalLMWithILQLHeads as JILQL

    from trlx_tpu_torch.models.wrappers import CausalLMWithILQLHeads

    jmodel = JILQL(JConfig(dtype=jnp.float32, **ARCHS[arch]), two_qs=True, alpha=0.3)
    jparams = _perturb(jmodel.init_params(jax.random.PRNGKey(1)))
    cfg = TransformerConfig(dtype=torch.float32, **ARCHS[arch])
    model = CausalLMWithILQLHeads(cfg, two_qs=True, alpha=0.3, device="cpu")
    model.load_state_dict(params_from_jax(jparams, cfg))
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 300, size=(3, 10)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, :2] = 0
    states = np.tile(np.arange(2, 10), (3, 1)).astype(np.int32)
    actions = np.tile(np.arange(2, 9), (3, 1)).astype(np.int32)
    with torch.no_grad():
        logits, (qs, tqs, vs) = model(*map(torch.from_numpy, (ids, mask, states, actions)))
    jlogits, (jqs, jtqs, jvs) = jmodel.forward(jax.tree_util.tree_map(jnp.asarray, jparams),
                                               *map(jnp.asarray, (ids, mask, states, actions)))
    assert len(qs) == len(jqs) == 2
    for got, want in [(logits, jlogits), (vs, jvs), *zip(qs, jqs), *zip(tqs, jtqs)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_left_padding_invariance(arch):
    """A row's logits do not depend on its left padding (the rope rotates
    by real positions, not slots), on the port as on the reference."""
    jlm, jparams, lm = _lms(arch, "pallas")
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 300, size=(1, 10)).astype(np.int32)
    padded = np.concatenate([np.full((1, 6), 257, np.int32), ids], axis=1)
    mask = np.concatenate([np.zeros((1, 6), np.int32), np.ones((1, 10), np.int32)], axis=1)
    with torch.no_grad():
        bare = lm(torch.from_numpy(ids))["logits"].numpy()
        pad = lm(torch.from_numpy(padded), torch.from_numpy(mask))["logits"].numpy()[:, 6:]
    ref = np.asarray(jlm(jparams, jnp.asarray(padded), jnp.asarray(mask))["logits"])[:, 6:]
    np.testing.assert_allclose(pad, bare, atol=ATOL, rtol=0)
    np.testing.assert_allclose(pad, ref, atol=ATOL, rtol=0)


def _prompts(B=3, P=8, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 258, size=(B, P)).astype(np.int32)
    mask = np.ones((B, P), np.int32)
    mask[0, :3] = 0
    mask[2, :5] = 0
    ids[mask == 0] = 257
    return ids, mask


@pytest.mark.parametrize("quant", [None, "int8", "int8_kernel"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_cached_greedy_decode(arch, quant):
    """The cached greedy decode equals the JAX package's token for token
    (its flash prefill and, with "int8_kernel", its int8 decode kernel in
    interpret mode; the port's plain versions); over the bf16-free cache
    (None) it also equals the argmax of the full teacher-forced forward
    at every generated position."""
    jlm, jparams, lm = _lms(arch, "pallas", kv_cache_quant=quant)
    ids, mask = _prompts()
    N = 10
    ref = j_make_generate_fn(jlm, JSettings(max_new_tokens=N, do_sample=False))(
        jparams, jnp.asarray(ids), jnp.asarray(mask), jax.random.PRNGKey(0))
    out = generate(lm, torch.from_numpy(ids), torch.from_numpy(mask), None,
                   SamplerSettings(max_new_tokens=N, do_sample=False))
    np.testing.assert_array_equal(out["sequences"].numpy(), np.asarray(ref["sequences"]))
    if quant is None:
        seqs = out["sequences"]
        full_mask = torch.cat([torch.from_numpy(mask), torch.ones(3, N, dtype=torch.int32)], dim=1)
        with torch.no_grad():
            logits = lm(seqs, full_mask)["logits"]
        P = ids.shape[1]
        np.testing.assert_array_equal(logits[:, P - 1:-1].argmax(dim=-1).numpy(), seqs[:, P:].numpy())


def _engine_queue(Q=5, P=6, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 258, size=(Q, P)).astype(np.int32)
    mask = np.ones((Q, P), np.int32)
    mask[0, :2] = 0
    mask[3, :1] = 0
    ids[mask == 0] = 257
    return ids, mask


@pytest.mark.parametrize("spec", ["plain", "hydra_spec"])
@pytest.mark.parametrize("arch", ["llama", "gptj"])
def test_engine_greedy_streams(arch, spec):
    """The decode engine's greedy streams (paged int8 pages through the
    kernel's plain version; with speculative decoding, the hydra draft
    over the top block and its draft_k = 3 verify) equal the JAX engine's
    token for token, with every gen_stats integer; the plain engine's over
    unquantised pages equal the static sampler's over its unquantised
    cache."""
    jlm, jparams, lm = _lms(arch, kv_cache_quant="int8")
    ids, mask = _engine_queue()
    N = 8
    kw = dict(slots=2, page_size=4, kv_quant="int8", paged_attention_impl="pallas")
    jdraft = draft = None
    if spec == "hydra_spec":
        kw.update(spec_decode=True, draft_k=3, draft_shared_layers=2)
        from trlx_tpu.models.transformer import extract_branch_params as j_extract

        jdraft = j_compose(jlm.cfg, jparams, j_extract(jparams, 2))
        draft = compose_draft_params(lm.cfg, lm, extract_branch_params(lm, 2))
    jst = JSettings(max_new_tokens=N, do_sample=False, eos_token_id=-1, pad_token_id=257)
    st = SamplerSettings(max_new_tokens=N, do_sample=False, eos_token_id=-1, pad_token_id=257)
    fn = jax.jit(lambda p, d, i, m, r: j_engine(jlm, p, i, m, r, jst, JSpec(**kw), draft_params=d))
    ref = _np(fn(jparams, jdraft, jnp.asarray(ids), jnp.asarray(mask), jax.random.PRNGKey(2)))
    out = engine_generate(lm, torch.from_numpy(ids), torch.from_numpy(mask), 2, st, EngineSpec(**kw),
                          draft_params=draft)
    np.testing.assert_array_equal(out["response_ids"].numpy(), ref["response_ids"])
    for k, v in ref["gen_stats"].items():
        if k != "occupancy":
            assert out["gen_stats"][k] == int(v), k
    if spec == "plain":
        # the static sampler's int8 cache keeps per-channel V scales and the
        # engine's pages per-row ones (in the reference too): the two are
        # held to each other over unquantised caches
        _, _, lm32 = _lms(arch)
        one = engine_generate(lm32, torch.from_numpy(ids), torch.from_numpy(mask), 2, st,
                              EngineSpec(**dict(kw, kv_quant=None)))
        static = generate(lm32, torch.from_numpy(ids), torch.from_numpy(mask), None, st)
        np.testing.assert_array_equal(one["response_ids"].numpy(), static["response_ids"].numpy())


# ---------------------------------------------------------------------------
# the kernels' plain versions at head width 128
# ---------------------------------------------------------------------------


def _qkv(B, H, Hkv, T, S, D, seed=0, pads=()):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, T, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    g = rng.normal(size=(B, H, T, D)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    for b, n in pads:
        mask[b, :n] = 0
    return q, k, v, g, mask


@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 1)], ids=["mha", "gqa4"])
def test_flash_d128_matches_jax_kernels(H, Hkv):
    """The forward (out, m, l) against the interpreted `_flash_forward` and
    the backward against the interpreted `_flash_backward` on its
    residuals, causal, with a left-padded and a fully padded batch row
    (atol = rtol = 2e-5 forward, 1e-4 backward: the D = 64 tests' bars)."""
    B, T, S, D = 2, 16, 16, 128
    q, k, v, g, mask = _qkv(B, H, Hkv, T, S, D, pads=((0, 5), (1, 16)))
    scale = D ** -0.5
    jq, jk, jv, jm = map(jnp.asarray, (q, k, v, mask))
    ref_out, ref_m, ref_l = _flash_forward(jq, jk, jv, jm, True, scale, 256, with_stats=True)
    out, m, l = flash_attention(*map(torch.from_numpy, (q, k, v, mask)), with_stats=True)
    for got, want in ((out, ref_out), (m, ref_m), (l, ref_l)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    ref = _flash_backward(jq, jk, jv, jm, ref_out, ref_m, ref_l, jnp.asarray(g), True, scale, 256)
    got = flash_attention_backward_plain(
        *(torch.from_numpy(np.array(x)) for x in (q, k, v, mask, ref_out, ref_m, ref_l, g)), True, scale, S - T)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 1), (8, 1)], ids=["g1", "g4", "g8"])
def test_decode_int8_d128_matches_jax_kernel(H, Hkv):
    """The int8 decode step at head width 128 and GQA groups 1, 4 and 8
    against the interpreted Pallas `decode_attention_int8`, every layer of
    an L = 2 cache with a padded row and unwritten slots (atol 2e-5)."""
    L, B, S, D = 2, 2, 128, 128
    rng = np.random.default_rng(H + Hkv)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    ck = rng.integers(-127, 128, size=(L, B, Hkv, S, D)).astype(np.int8)
    cv = rng.integers(-127, 128, size=(L, B, Hkv, S, D)).astype(np.int8)
    ks = (rng.random(size=(L, B, Hkv, 1, S)) * 0.02).astype(np.float32)
    vs = (rng.random(size=(L, B, Hkv, 1, D)) * 0.02).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[0, :9] = 0
    mask[:, 100:] = 0
    for ix in range(L):
        ref = j_decode(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(ks), jnp.asarray(vs[ix]),
                       jnp.asarray(mask), ix, sm_scale=D ** -0.5)
        got = decode_attention_int8(*map(torch.from_numpy, (q, ck, cv, ks, vs[ix], mask)), ix, D ** -0.5)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("H,Hkv,T", [(2, 2, 1), (8, 1, 4)], ids=["g1_decode", "g8_verify"])
def test_paged_step_d128_matches_jax(quant, H, Hkv, T):
    """One paged step at head width 128 (the write half included) against
    the JAX `paged_attention_step` with impl="pallas" (interpreted) and
    "xla": a decode step at group 1 and a T = 4 verify at group 8 (8 x 4 =
    32 query rows, the kernels' largest), ragged lanes (atol 2e-5, rtol
    1e-5, the reference test's)."""
    L, NP, MP, B, D, PS = 2, 9, 2, 3, 128, 8
    S = MP * PS
    rng = np.random.default_rng(T + H)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    kn = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    vn = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    ctx = rng.normal(size=(B, 3, Hkv, D)).astype(np.float32)
    table = np.array([[1, 2], [3, 4], [5, 6]], np.int32)
    slot_pos = np.array([3, 2, 3], np.int32)
    q_slots = slot_pos[:, None] + np.arange(T)[None, :]
    key_mask = np.arange(S)[None, :] < (slot_pos + T)[:, None]
    visible = (q_slots[:, :, None] >= np.arange(S)[None, None, :]) & key_mask[:, None, :]
    bias = np.where(visible, 0.0, -1e30)[:, None].astype(np.float32)
    jpools = jkv.init_pool(L, NP, PS, Hkv, D, quant, jnp.float32)
    _, jpools = j_step(jnp.zeros((B, 3, H, D)), jnp.asarray(ctx), jnp.asarray(ctx), jpools, jnp.int32(1),
                       jnp.asarray(table), jnp.zeros((B,), jnp.int32), jnp.zeros((B, 1, 3, S)), 1.0)
    pools = paged_kv.init_pool(L, NP, PS, Hkv, D, quant, torch.float32)
    paged_attention_step(torch.zeros(B, 3, H, D), torch.from_numpy(ctx), torch.from_numpy(ctx), pools, 1,
                         torch.from_numpy(table), torch.zeros(B, dtype=torch.int64), torch.zeros(B, 1, 3, S), 1.0)
    args = (table, slot_pos, bias)
    out, _ = paged_attention_step(*map(torch.from_numpy, (q, kn, vn)), pools, 1, *map(torch.from_numpy, args),
                                  D ** -0.5, impl="pallas")
    for impl in ("pallas", "xla"):
        ref, _ = j_step(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), dict(jpools), jnp.int32(1),
                        *map(jnp.asarray, args), D ** -0.5, impl=impl)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5, err_msg=impl)


@pytest.mark.parametrize("T,S,D,fwd,bwd", [
    (64, 64, 128, "short", "fused"), (112, 112, 128, "short", "fused"), (113, 113, 128, "short", "long"),
    (128, 128, 128, "short", "long"), (129, 129, 128, "long", "long"), (128, 128, 64, "short", "fused"),
])
def test_routes_at_head_width_128(T, S, D, fwd, bwd):
    """The forward's short route holds T, S <= 128 at both widths; the
    fused backward's tile at D = 128 fits shared memory up to 112."""
    assert forward_route(T, S, D) == fwd
    assert backward_route(T, S, D) == bwd


def test_routes_refuse_other_head_widths():
    with pytest.raises(ValueError):
        forward_route(64, 64, 96)
    with pytest.raises(ValueError):
        backward_route(64, 64, 256)


def test_paged_kernels_build_once_a_head_width():
    """`csrc/paged_attention.cu`, the slowest source, compiles as one
    library a head width (side by side); the wrappers pick theirs by D."""
    from trlx_tpu_torch.ops import _build

    units = _build._units()
    assert units["paged_attention_d64"] == ("paged_attention.cu", ("-DKERNEL_HEAD_DIM=64",))
    assert units["paged_attention_d128"] == ("paged_attention.cu", ("-DKERNEL_HEAD_DIM=128",))
    assert units["flash_fwd"] == ("flash_fwd.cu", ()) and "paged_attention" not in units
    assert _build.library_stem("paged_attention.cu", 128) == "paged_attention_d128"
    assert _build.library_stem("decode_int8.cu", 128) == "decode_int8"
    with pytest.raises(ValueError):
        _build.library_stem("paged_attention.cu", 96)


# ---------------------------------------------------------------------------
# the PPO loop on a tiny random Llama
# ---------------------------------------------------------------------------

TINY_LLAMA = dict(hidden_size=32, n_layer=2, n_head=4, n_kv_head=2, n_positions=64, intermediate_size=48,
                  pos_embed="rotary", norm="rmsnorm", mlp_gated=True, activation="silu", use_attn_bias=False,
                  use_mlp_bias=False, use_norm_bias=False, tie_word_embeddings=False)


def test_ppo_train_on_llama_matches_reference(tmp_path):
    """`trlx_tpu_torch.train` against `trlx_tpu.train` on a tiny random
    Llama (the ppo_parity harness: two cycles, 8 steps, the hydra
    reference over the top block): the stores (tokens exactly, logprobs,
    values and rewards atol 1e-4) and the loss stream (rtol 1e-4)."""
    jconfig = ppo_parity.config(tmp_path, model=dict(model_path="random", num_layers_unfrozen=1,
                                                     model_extra_configs={"transformer": TINY_LLAMA}))
    ref, init, j_stats = ppo_parity.run_reference(jconfig)
    ours = ppo_parity.run_port(jconfig, init)
    assert ours.model.cfg.pos_embed == "rotary" and ours.model.base.lm_head is not None
    assert ours.iter_count == ref.iter_count == 8
    ppo_parity.assert_store_matches(ours, ref)
    want, got = ppo_parity.losses(j_stats), ppo_parity.losses(ours.stats_history)
    assert [s for s, _ in got] == [s for s, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-4, atol=1e-5)
