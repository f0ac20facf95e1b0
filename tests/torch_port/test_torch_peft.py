"""trlx_tpu_torch's peft tier (LoRA, prompt tuning, prefix tuning) against
the JAX package's on the same weights and adapters (carried over by
`models/convert.py`), on the CPU in fp32, inputs from numpy seeds.

Tolerances, each stated at its test: forwards (logits, hidden states,
values, reference logits) and the adapters' gradients atol 1e-5 (fp32;
the port runs LoRA unmerged, x W + s (x A) B, the reference merged, x (W +
s A B), which differ by rounding); the flash prefix pass against the
interpreted Pallas kernel atol = rtol = 1e-4 (the flash tests' bar); greedy
tokens exactly; `train()` runs as the harnesses of their trainers' parity
tests hold them (stores atol 1e-4, loss streams rtol 1e-4, tokens
exactly); the HF-peft files bit for bit."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trlx_tpu
from trlx_tpu.data.default_configs import default_sft_config as j_default_sft_config
from trlx_tpu.models import peft as jpeft
from trlx_tpu.models import seq2seq as jseq
from trlx_tpu.models.generation import SamplerSettings as JSettings
from trlx_tpu.models.generation import generate as j_generate
from trlx_tpu.models.lora import init_lora_params
from trlx_tpu.models.transformer import TransformerConfig as JConfig
from trlx_tpu.models.transformer import TransformerLM as JLM
from trlx_tpu.models.wrappers import CausalLMWithValueHead as JPolicy
from trlx_tpu.models.wrappers import Seq2SeqLMWithValueHead as JSeqPolicy
from trlx_tpu.ops.flash_attention import flash_attention as j_flash
from trlx_tpu.trainer import dpo as j_dpo
from trlx_tpu.trainer import grpo as j_grpo
from trlx_tpu.trainer import ilql as j_ilql
from trlx_tpu.trainer import rft as j_rft
from trlx_tpu.trainer import sft as j_sft
from trlx_tpu.trainer.base import TPUBaseTrainer as JBaseTrainer

import trlx_tpu_torch
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import default_sft_config
from trlx_tpu_torch.models import hf, lora, peft, seq2seq, wrappers
from trlx_tpu_torch.models.convert import params_from_jax
from trlx_tpu_torch.models.generation import SamplerSettings, generate
from trlx_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from trlx_tpu_torch.ops.flash_attention import flash_attention
from trlx_tpu_torch.trainer import base as trainer_base
from tests.torch_port import ppo_parity
from tests.torch_port import test_torch_dpo as dpo_parity
from tests.torch_port import test_torch_grpo as grpo_parity
from tests.torch_port import test_torch_ilql as ilql_parity
from tests.torch_port import test_torch_rft as rft_parity

TOL = dict(atol=1e-5, rtol=0)
FLASH_TOL = dict(atol=1e-4, rtol=1e-4)
GPT2 = dict(vocab_size=300, hidden_size=32, n_layer=2, n_head=4, n_positions=64)
LLAMA = dict(vocab_size=300, hidden_size=32, n_layer=2, n_head=4, n_kv_head=2, n_positions=64,
             intermediate_size=48, pos_embed="rotary", norm="rmsnorm", activation="silu", mlp_gated=True,
             use_attn_bias=False, use_mlp_bias=False, tie_word_embeddings=False)
T5 = dict(vocab_size=300, d_model=32, n_layer=2, n_decoder_layer=2, n_head=4, d_kv=8, d_ff=64,
          relative_attention_num_buckets=8, decoder_start_token_id=257)
ARCHS = {"gpt2": GPT2, "llama": LLAMA}
N_VIRTUAL = 3
LORA = {"peft_type": "LORA", "r": 4, "lora_alpha": 8}
# the reference's target syntaxes: its default (attention), a regex over
# its param paths (attention and MLP), a list of HF module names
TARGETS = {"default": None, "regex_mlp": r"blocks/(attn/[qkvo]|mlp/fc_\w+)/kernel$", "hf_names": ["q_proj", "v_proj"]}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _batch(seed=0, B=3, T=9, vocab=256):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[0, :4] = 0  # left padding
    mask[1, :1] = 0
    return ids, mask


def _jlora(params, targets, seed=1):
    """A reference LoRA tree with B nonzero (the init's B = 0 is a no-op)."""
    tree = init_lora_params(jax.random.PRNGKey(seed), params, r=LORA["r"],
                            **({} if targets is None else {"targets": targets}))
    rng = np.random.default_rng(seed)
    return {p: {"a": ab["a"], "b": jnp.asarray(rng.normal(size=ab["b"].shape).astype(np.float32) * 0.05)}
            for p, ab in tree.items()}


def _pc(**kw):
    return peft.normalize_peft_config(dict(LORA, **{k: v for k, v in kw.items() if v is not None}))


def _lora_policies(arch, targets=None, impl="xla"):
    """(JAX policy, its params with a LoRA tree, the port's policy with the
    same weights and adapter)."""
    kw = ARCHS[arch]
    jmodel = JPolicy(JConfig(dtype=jnp.float32, attention_impl=impl, **kw))
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    jparams["lora"] = _jlora(jparams["base"], targets)
    jmodel.lora_scaling = LORA["lora_alpha"] / LORA["r"]
    cfg = TransformerConfig(dtype=torch.float32, attention_impl=impl, **kw)
    model = wrappers.CausalLMWithValueHead(cfg, device="cpu")
    peft.attach_adapter(model, _pc(target_modules=targets))
    model.load_state_dict(params_from_jax(_np(jparams), cfg))
    return jmodel, jparams, model


# -- LoRA ----------------------------------------------------------------------


def test_lora_tree_matches_reference_paths_and_init():
    """The port's pairs sit where the reference's targets do, for each
    target syntax; the init is A ~ N(0, 0.02), B = 0 (a no-op)."""
    jparams = JLM(JConfig(dtype=jnp.float32, **LLAMA)).init(jax.random.PRNGKey(0))
    cfg = TransformerConfig(dtype=torch.float32, **LLAMA)
    for targets in TARGETS.values():
        jtree = init_lora_params(jax.random.PRNGKey(1), jparams, r=4,
                                 **({} if targets is None else {"targets": targets}))
        model = wrappers.CausalLMWithValueHead(cfg, device="cpu")
        peft.attach_adapter(model, _pc(target_modules=targets))
        model.init_params(torch.Generator().manual_seed(0))
        got = lora.stacked_from_lora(model.lora)
        assert set(got) == set(jtree)
        for path, ab in jtree.items():
            assert tuple(got[path]["a"].shape) == ab["a"].shape and tuple(got[path]["b"].shape) == ab["b"].shape
            assert not got[path]["b"].any() and 0.01 < got[path]["a"].std().item() < 0.03
    model = wrappers.CausalLMWithValueHead(cfg, device="cpu")
    with pytest.raises(ValueError, match="no LoRA targets"):
        peft.attach_adapter(model, _pc(target_modules=["nothing"]))
    with pytest.raises(NotImplementedError, match="lm_head"):
        peft.attach_adapter(model, _pc(target_modules=r"lm_head/kernel$"))


@pytest.mark.parametrize("targets", list(TARGETS))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_lora_forward_and_forward_train_match_merged_reference(arch, targets):
    """`forward` and `forward_train` (values, logits, hidden states, and the
    reference logits of the adapter-off base) against the reference's merged
    forward; tolerance atol 1e-5."""
    jmodel, jparams, model = _lora_policies(arch, TARGETS[targets])
    ids, mask = _batch()
    want = jmodel.forward_train(jparams, jmodel.make_ref_params(jparams), jnp.asarray(ids), jnp.asarray(mask))
    ref = model.make_ref_params()
    assert isinstance(ref, wrappers.AdapterOffReference) and not list(ref.parameters())
    with torch.no_grad():
        got = model.forward_train(ref, *_t(ids, mask))
        plain = model.forward(*_t(ids, mask))
    for key in ("logits", "hidden_states", "values", "ref_logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), err_msg=key, **TOL)
    np.testing.assert_allclose(plain["logits"].numpy(), np.asarray(want["logits"]), **TOL)
    # the adapter moves the policy away from its reference
    assert np.abs(np.asarray(want["logits"]) - np.asarray(want["ref_logits"])).max() > 1e-3


def test_lora_gradients_reach_only_the_adapter():
    """The adapters' gradients against jax.grad through the merged forward
    (atol 1e-5); the frozen base gets none."""
    jmodel, jparams, model = _lora_policies("llama", TARGETS["regex_mlp"])
    ids, mask = _batch(1)
    w = np.random.default_rng(2).normal(size=(3, 9, 300)).astype(np.float32)

    def j_loss(lora_tree):
        out = jmodel.forward(dict(jparams, lora=lora_tree), jnp.asarray(ids), jnp.asarray(mask))
        return jnp.sum(out["logits"] * w) + jnp.sum(out["values"])

    jgrad = jax.grad(j_loss)(jparams["lora"])
    model.base.requires_grad_(False)
    out = model(*_t(ids, mask))
    ((out["logits"] * torch.from_numpy(w)).sum() + out["values"].sum()).backward()
    got = {}
    for name, pair in lora.pairs(model.lora):
        path, layer = lora.reference_path(name)
        got.setdefault(path, {})[layer] = pair
    for path, ab in jgrad.items():
        for side in ("a", "b"):
            grad = torch.stack([getattr(got[path][i], side).grad for i in sorted(got[path])])
            np.testing.assert_allclose(grad.numpy(), np.asarray(ab[side]), err_msg=f"{path}/{side}", **TOL)
    assert all(p.grad is None for p in model.base.parameters())


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_t5_lora_forward_train_matches_merged_reference(impl):
    """T5 with LoRA on the self- and cross-attention of both stacks: values,
    logits and the adapter-off reference logits against the reference's
    merged forward, atol 1e-5."""
    jmodel = JSeqPolicy(jseq.Seq2SeqConfig(dtype=jnp.float32, **T5))
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    jparams["lora"] = _jlora(jparams["base"], None)
    assert any("cross_attn" in p for p in jparams["lora"]) and any("encoder" in p for p in jparams["lora"])
    jmodel.lora_scaling = 2.0
    cfg = seq2seq.Seq2SeqConfig(dtype=torch.float32, attention_impl=impl, **T5)
    model = wrappers.Seq2SeqLMWithValueHead(cfg, device="cpu")
    peft.attach_adapter(model, _pc())
    model.load_state_dict(params_from_jax(_np(jparams), cfg))
    rng = np.random.default_rng(0)
    enc = rng.integers(0, 256, size=(3, 7)).astype(np.int32)
    enc_mask = np.ones((3, 7), np.int32)
    enc_mask[0, :3] = 0
    dec = rng.integers(0, 256, size=(3, 6)).astype(np.int32)
    dec[:, 0] = 257
    dec_mask = np.ones((3, 6), np.int32)
    dec_mask[1, 4:] = 0
    want = jmodel.forward_train(jparams, jmodel.make_ref_params(jparams), *map(jnp.asarray, (enc, enc_mask, dec,
                                                                                              dec_mask)))
    with torch.no_grad():
        got = model.forward_train(model.make_ref_params(), *_t(enc, enc_mask, dec, dec_mask))
    for key in ("logits", "values", "ref_logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), err_msg=key, **TOL)


# -- prompt and prefix tuning ----------------------------------------------------


def _virtual(arch, kind, seed=3):
    """(reference kwargs, port kwargs) of a soft prompt or a kv prefix."""
    kw = ARCHS[arch]
    rng = np.random.default_rng(seed)
    if kind == "prompt":
        soft = rng.normal(size=(N_VIRTUAL, kw["hidden_size"])).astype(np.float32) * 0.3
        return {"prefix_embeds": jnp.asarray(soft)}, {"prefix_embeds": torch.from_numpy(soft)}
    hkv, hd = kw.get("n_kv_head", kw["n_head"]), kw["hidden_size"] // kw["n_head"]
    kv = {s: rng.normal(size=(kw["n_layer"], N_VIRTUAL, hkv, hd)).astype(np.float32) * 0.3 for s in ("k", "v")}
    return ({"kv_prefix": {s: jnp.asarray(x) for s, x in kv.items()}},
            {"kv_prefix": {s: torch.from_numpy(x) for s, x in kv.items()}})


def _lms(arch, impl="xla", **cfg_kw):
    kw = ARCHS[arch]
    jlm = JLM(JConfig(dtype=jnp.float32, **dict(kw, **cfg_kw)))
    jparams = jlm.init(jax.random.PRNGKey(4))
    cfg = TransformerConfig(dtype=torch.float32, attention_impl=impl, **dict(kw, **cfg_kw))
    lm = TransformerLM(cfg, device="cpu")
    lm.load_state_dict(params_from_jax(_np(jparams), cfg))
    return jlm, jparams, lm


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("kind", ["prompt", "prefix"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_virtual_token_forward_and_gradients_match_reference(arch, kind, impl):
    """Logits, hidden states and positions of the adapter forward on a
    left-padded batch, and the gradient of a weighted logit sum with
    respect to the soft embedding or the prefix keys and values, against
    the reference's (atol 1e-5). "pallas" runs the port's flash path (the
    prefix at q_offset = n over n + T keys), the reference its XLA path."""
    jlm, jparams, lm = _lms(arch, impl)
    jkw, kw = _virtual(arch, kind)
    ids, mask = _batch(5)
    w = np.random.default_rng(6).normal(size=(3, 9, 300)).astype(np.float32)
    want = jlm(jparams, jnp.asarray(ids), jnp.asarray(mask), **jkw)
    name = "prefix_embeds" if kind == "prompt" else "kv_prefix"

    def j_loss(x):
        return jnp.sum(jlm(jparams, jnp.asarray(ids), jnp.asarray(mask), **{name: x})["logits"] * w)

    jgrad = jax.grad(j_loss)(jkw[name])
    leaves = [kw[name]] if kind == "prompt" else [kw[name]["k"], kw[name]["v"]]
    for x in leaves:
        x.requires_grad_(True)
    out = lm(*_t(ids, mask), **kw)
    for key in ("logits", "hidden_states", "positions"):
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(want[key]), err_msg=key, **TOL)
    (out["logits"] * torch.from_numpy(w)).sum().backward()
    jleaves = [jgrad] if kind == "prompt" else [jgrad["k"], jgrad["v"]]
    for x, g in zip(leaves, jleaves):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), **TOL)


@pytest.mark.parametrize("causal_case", [(4, 2, 9, 4), (2, 2, 5, 3), (6, 2, 7, 2)])
def test_flash_prefix_layout_matches_interpreted_pallas(causal_case):
    """The prefix pass's attention call (T queries at q_offset = n over n + T
    keys, the key mask [ones(n), left-padded mask], GQA) against the
    reference's Pallas kernel in interpret mode, forward and jax.grad,
    tolerance atol = rtol = 1e-4 (the flash tests' bar)."""
    H, Hkv, T, n = causal_case
    B, D, S = 2, 8, n + T
    rng = np.random.default_rng(T)
    q = rng.normal(size=(B, H, T, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    g = rng.normal(size=(B, H, T, D)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[1, n:n + T - 1] = 0  # row 1: every real token padded but the last

    def j_loss(q, k, v):
        return jnp.sum(j_flash(q, k, v, jnp.asarray(mask), True, None, 256, n) * jnp.asarray(g))

    jout = j_flash(*map(jnp.asarray, (q, k, v, mask)), True, None, 256, n)
    jgrads = jax.grad(j_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = flash_attention(tq, tk, tv, torch.from_numpy(mask), q_offset=n)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **FLASH_TOL)
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), (tq, tk, tv))
    for name, a, b in zip(("dq", "dk", "dv"), grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **FLASH_TOL)


@pytest.mark.parametrize("quant", [None, "int8", "int8_kernel"])
@pytest.mark.parametrize("kind", ["prompt", "prefix"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_greedy_generate_with_adapter_matches_reference(arch, kind, quant):
    """Greedy `generate` with a soft prompt or a kv prefix, token for token
    against the reference's, over the plain cache and both int8 caches (the
    virtual slots quantized with the rest)."""
    jlm, jparams, lm = _lms(arch, kv_cache_quant=quant)
    jkw, kw = _virtual(arch, kind, seed=7)
    rename = {"prefix_embeds": "soft_prompt", "kv_prefix": "kv_prefix"}
    ids, mask = _batch(8, B=3, T=6)
    ids[mask == 0] = 0
    N = 6
    want = j_generate(jlm, jparams, jnp.asarray(ids), jnp.asarray(mask), jax.random.PRNGKey(0),
                      JSettings(max_new_tokens=N, do_sample=False, eos_token_id=-1, pad_token_id=0),
                      **{rename[k]: v for k, v in jkw.items()})
    got = generate(lm, *_t(ids, mask), None, SamplerSettings(max_new_tokens=N, do_sample=False, eos_token_id=-1,
                                                              pad_token_id=0),
                   **{rename[k]: v for k, v in kw.items()})
    np.testing.assert_array_equal(got["sequences"].numpy(), np.asarray(want["sequences"]))
    np.testing.assert_array_equal(got["response_mask"].numpy(), np.asarray(want["response_mask"]))


def test_lora_generate_samples_the_merged_weights():
    """The sampler merges an active LoRA pair into the weights it reads
    (and its copy holds no pair); with the pair off it samples the base,
    and so does the adapter-off reference's decode copy (the speculative
    draft), which leaves the policy's pairs on."""
    _, _, model = _lora_policies("llama")
    ids, mask = _batch(9, T=6)
    settings = SamplerSettings(max_new_tokens=5, do_sample=False)
    merged = TransformerLM(model.cfg, device="cpu")
    sd = model.base.state_dict()
    for name, pair in lora.pairs(model.lora):
        sd[name + ".kernel"] = pair.merged(sd[name + ".kernel"])
    merged.load_state_dict(sd)
    got = generate(model.base, *_t(ids, mask), None, settings)["sequences"]
    assert torch.equal(got, generate(merged, *_t(ids, mask), None, settings)["sequences"])
    with lora.adapters_disabled(model.base):
        off = generate(model.base, *_t(ids, mask), None, settings)["sequences"]
    assert all(pair.enabled for _, pair in lora.pairs(model.lora))
    base = TransformerLM(model.cfg, device="cpu")
    base.load_state_dict(model.base.state_dict())
    assert torch.equal(off, generate(base, *_t(ids, mask), None, settings)["sequences"])
    draft = wrappers.AdapterOffReference(model.base).decode_copy(torch.float32)
    assert all(pair.enabled for _, pair in lora.pairs(model.lora))
    assert not any(m.__dict__.get("lora") for m in draft.modules())
    assert torch.equal(off, generate(draft, *_t(ids, mask), None, settings)["sequences"])


# -- train() against trlx_tpu.train ---------------------------------------------


ENGINE_SPEC = dict(gen_engine=dict(enabled=True, slots=4, page_size=8, spec_decode=True, draft_k=2))


@pytest.mark.parametrize("peft_config,method", [
    (LORA, {}), ({"peft_type": "PROMPT_TUNING", "num_virtual_tokens": N_VIRTUAL}, {}), (LORA, ENGINE_SPEC)],
    ids=["lora", "prompt", "lora_engine_spec"])
def test_ppo_cycle_with_adapter_matches_reference(tmp_path, peft_config, method):
    """One PPO cycle (the ppo_parity harness: 16 greedy rollouts, 4 steps)
    with an adapter: the store to 1e-4, tokens exactly, the loss stream to
    rtol 1e-4. The hydra fork is dropped (k = -1), the reference is the
    adapter-off base, the base stays bit for bit, only the adapter and the
    value head move. Through the decode engine with speculative decoding,
    the draft is the adapter-off base, as the reference's is."""
    jconfig = ppo_parity.config(tmp_path, train=dict(total_steps=4), model=dict(peft_config=peft_config),
                                method=method)
    ref, init, j_stats = ppo_parity.run_reference(jconfig)
    ours = ppo_parity.run_port(jconfig, init)
    assert ours.iter_count == ref.iter_count
    ppo_parity.assert_store_matches(ours, ref)
    want, got = ppo_parity.losses(j_stats), ppo_parity.losses(ours.stats_history)
    assert [s for s, _ in got] == [s for s, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-4, atol=0)
    assert ours.model.branch_at is None and isinstance(ours.ref_params, wrappers.AdapterOffReference)
    start = params_from_jax(init, ours.model.cfg)
    for name, p in ours.model.named_parameters():
        assert torch.equal(p.detach(), start[name]) == name.startswith("base."), name
    trainable = {id(p) for g in ours.optimizer.param_groups for p in g["params"]}
    assert trainable == {id(p) for n, p in ours.model.named_parameters() if not n.startswith("base.")}
    if method:
        assert [s for _, s in j_stats if "rollout/spec_accept_rate" in s], "the reference fell back"
        assert [s for _, s in ours.stats_history if "rollout/spec_accept_rate" in s], "the port fell back"


def _train_pair(jtrainer, cls, jconfig, port_patch=None, **train_kw):
    """`trlx_tpu.train` and `trlx_tpu_torch.train` from the same init:
    (reference trainer, its init, its logged stats, the port's trainer)."""
    init, j_stats = {}, []
    setup = jtrainer.setup_model

    def capture_setup(self):
        setup(self)
        init.update(_np(self.params))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, "setup_model", capture_setup)
        mp.setattr(JBaseTrainer, "_tracker_log", lambda self, st, step: j_stats.append((step, dict(st))))
        mp.setattr(JBaseTrainer, "_save_checkpoint", lambda self, name, final=False: None)
        if port_patch:
            mp.setattr(JBaseTrainer, "generate", port_patch(False))
        ref = trlx_tpu.train(config=jconfig, **train_kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cls, "init_params", lambda self, gen: self.load_state_dict(params_from_jax(init, self.cfg)) and self)
        if port_patch:
            mp.setattr(trainer_base.TPUBaseTrainer, "generate", port_patch(True))
        ours = trlx_tpu_torch.train(config=TRLConfig.from_dict(jconfig.to_dict()), device="cpu", **train_kw)
    return ref, init, j_stats, ours


def _assert_streams(j_stats, ours, key):
    want = [(s, float(st[key])) for s, st in j_stats if key in st]
    got = [(s, float(st[key])) for s, st in ours.stats_history if key in st]
    assert want and [s for s, _ in got] == [s for s, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-4, atol=1e-6)


def _assert_adapter_run(ours, init):
    """The base bit for bit as initialised; the adapter moved; the
    reference is the adapter-off base and no frozen copy exists."""
    start = params_from_jax(init, ours.model.cfg)
    for name, p in ours.model.named_parameters():
        if name.startswith("base."):
            assert torch.equal(p.detach(), start[name]) and not p.requires_grad, name
    assert any(not torch.equal(p.detach(), start[n]) for n, p in ours.model.named_parameters()
               if n.startswith(peft.ADAPTER_KEYS))
    ref = getattr(ours, "ref_params", None)
    if ref is not None:
        assert isinstance(ref, wrappers.AdapterOffReference) and not list(ref.parameters())


SFT_SAMPLES = [("the cat", " sat"), ("a dog", " ran far"), "hello there", ("x", " y", " z", " w"),
               ("one", " two"), ("three", " four five"), "six seven", ("eight", " nine")] * 2


@pytest.mark.parametrize("peft_config", [LORA, {"peft_type": "PREFIX_TUNING", "num_virtual_tokens": N_VIRTUAL}],
                         ids=["lora", "prefix"])
def test_sft_with_adapter_matches_reference(tmp_path, peft_config):
    """SFT, 4 steps: the loss stream to rtol 1e-4; the base frozen."""
    jconfig = j_default_sft_config().evolve(
        train=dict(batch_size=8, total_steps=4, eval_interval=100, checkpoint_interval=100, seq_length=16,
                   epochs=10, tracker=None, compute_dtype="float32", fused_inner_loop=False,
                   checkpoint_dir=str(tmp_path / "ckpts"), seed=7),
        model=dict(model_path="random", peft_config=peft_config, model_extra_configs={
            "transformer": dict(hidden_size=32, n_layer=2, n_head=2, n_positions=64)}),
        tokenizer=dict(tokenizer_path="byte"),
        optimizer=dict(name="adamw", kwargs=dict(lr=1e-2, betas=(0.9, 0.95), eps=1e-8, weight_decay=1e-2)),
        method=dict(gen_kwargs=dict(max_new_tokens=4, do_sample=False)),
    )
    ref, init, j_stats, ours = _train_pair(j_sft.TPUSFTTrainer, wrappers.CausalLM, jconfig, samples=SFT_SAMPLES)
    assert ours.iter_count == ref.iter_count == 4
    _assert_streams(j_stats, ours, "losses/loss")
    _assert_adapter_run(ours, init)


def test_rft_with_lora_matches_reference(tmp_path):
    """RFT with LoRA (greedy sampling rounds, 6 steps): the loss stream to
    rtol 1e-4 and the selection stats exactly; the base frozen."""
    jconfig = rft_parity._config(tmp_path).evolve(model=dict(peft_config=LORA))
    ref, init, j_stats, ours = _train_pair(j_rft.TPURFTTrainer, wrappers.CausalLM, jconfig,
                                           reward_fn=rft_parity.reward_fn, prompts=rft_parity.PROMPTS,
                                           eval_prompts=rft_parity.PROMPTS)
    assert ours.iter_count == ref.iter_count == 6
    _assert_streams(j_stats, ours, "losses/loss")
    for key in ("len_samples_selected", "percentile"):
        assert [st[key] for _, st in ours.stats_history if key in st] == pytest.approx(
            [st[key] for _, st in j_stats if key in st], rel=1e-9), key
    _assert_adapter_run(ours, init)


def test_dpo_with_lora_matches_reference(tmp_path):
    """DPO with LoRA, 6 steps: every logged stream to rtol 1e-4; the
    reference is the adapter-off base (no copy) and the base stays put."""
    jconfig = dpo_parity._config(tmp_path).evolve(model=dict(peft_config=LORA))
    ref, init, j_stats, ours = _train_pair(j_dpo.TPUDPOTrainer, wrappers.CausalLM, jconfig,
                                           samples=dpo_parity.MIXED_PAIRS)
    assert ours.iter_count == ref.iter_count == 6
    for key in dpo_parity.DPO_STATS:
        _assert_streams(j_stats, ours, key)
    _assert_adapter_run(ours, init)


def test_grpo_with_lora_matches_reference(tmp_path):
    """GRPO with LoRA on injected samples (the GRPO parity harness): the
    loss and KL streams to rtol 1e-4, the stored logprobs and reference
    logprobs to 1e-4; no frozen copy."""
    jconfig = grpo_parity._config(tmp_path).evolve(model=dict(peft_config=LORA))
    ref, init, j_stats, ours = _train_pair(
        j_grpo.TPUGRPOTrainer, wrappers.CausalLM, jconfig,
        port_patch=lambda port: grpo_parity.scripted_generate([], port),
        reward_fn=grpo_parity.reward_fn, prompts=grpo_parity.PROMPTS, eval_prompts=grpo_parity.PROMPTS[:4])
    assert ours.iter_count == ref.iter_count == 8
    for key in ("losses/total_loss", "losses/kl_loss", "policy/approx_kl"):
        _assert_streams(j_stats, ours, key)
    j_hist = _np(ref.store.history)
    for name in ("logprobs", "ref_logprobs"):
        np.testing.assert_allclose(getattr(ours.store.history, name).numpy(), getattr(j_hist, name), atol=1e-4,
                                   rtol=0, err_msg=name)
    _assert_adapter_run(ours, init)


RANDOM_INIT_RUNS = {
    "sft_lora": lambda tmp: (j_default_sft_config().evolve(
        train=dict(batch_size=4, total_steps=3, seq_length=16, epochs=10, tracker=None, compute_dtype="float32",
                   checkpoint_dir=str(tmp / "ckpts"), seed=5),
        model=dict(model_path="random", peft_config=LORA, model_extra_configs={
            "transformer": dict(hidden_size=32, n_layer=2, n_head=2, n_positions=64)}),
        tokenizer=dict(tokenizer_path="byte"), optimizer=dict(kwargs=dict(lr=1e-3)),
        method=dict(gen_kwargs=dict(max_new_tokens=2))), dict(samples=SFT_SAMPLES)),
    "dpo_lora": lambda tmp: (dpo_parity._config(tmp).evolve(model=dict(peft_config=LORA)),
                             dict(samples=dpo_parity.MIXED_PAIRS)),
    "grpo_lora": lambda tmp: (grpo_parity._config(tmp).evolve(model=dict(peft_config=LORA)),
                              dict(reward_fn=grpo_parity.reward_fn, prompts=grpo_parity.PROMPTS)),
    "sft_prompt": lambda tmp: (RANDOM_INIT_RUNS["sft_lora"](tmp)[0].evolve(model=dict(peft_config={
        "peft_type": "PROMPT_TUNING", "num_virtual_tokens": 8})), dict(samples=SFT_SAMPLES)),
    "sft_prefix": lambda tmp: (RANDOM_INIT_RUNS["sft_lora"](tmp)[0].evolve(model=dict(peft_config={
        "peft_type": "PREFIX_TUNING", "num_virtual_tokens": 8})), dict(samples=SFT_SAMPLES)),
}


@pytest.mark.parametrize("run", sorted(RANDOM_INIT_RUNS))
def test_random_init_adapter_draws_reference_init_and_trains(tmp_path, run):
    """The trainer's own random init (no weights carried over): LoRA A ~
    N(0, 0.02) and B = 0, soft tokens and prefixes ~ N(0, 0.02), each std
    within 25% of 0.02 over the adapter's draws; after train() every adapter
    tensor has moved (every B off zero, so A had a gradient too) and the base
    is bit for bit as initialised."""
    jconfig, train_kw = RANDOM_INIT_RUNS[run](tmp_path)
    init = {}
    init_weights = trainer_base.TPUBaseTrainer.init_weights

    def recorded(self):
        init_weights(self)
        init.update({n: p.detach().clone() for n, p in self.model.named_parameters()})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer_base.TPUBaseTrainer, "init_weights", recorded)
        ours = trlx_tpu_torch.train(config=TRLConfig.from_dict(jconfig.to_dict()), device="cpu", **train_kw)
    assert ours.iter_count > 0
    adapter = {n: p.detach() for n, p in ours.model.named_parameters() if n.startswith(peft.ADAPTER_KEYS)}
    drawn = [n for n in adapter if not n.endswith(".b")]
    assert adapter and drawn
    assert all(not init[n].any() for n in adapter if n.endswith(".b"))
    std = float(torch.cat([init[n].flatten() for n in drawn]).std())
    assert 0.015 < std < 0.025, std
    for name, p in adapter.items():
        assert not torch.equal(p, init[name]), f"{name} did not train"
    for name, p in ours.model.base.named_parameters():
        assert torch.equal(p.detach(), init[f"base.{name}"]), name


def test_seq2seq_ilql_with_lora_matches_reference(tmp_path):
    """Seq2seq ILQL with LoRA (greedy evaluations sweeping beta): the loss
    stream to rtol 1e-4, the evaluations token for token."""
    jconfig = ilql_parity._train_config(tmp_path, "seq2seq").evolve(model=dict(peft_config=LORA))
    evals, j_evals = [], []
    with pytest.MonkeyPatch.context() as mp:
        ilql_parity._capture(mp, JBaseTrainer, j_evals)
        ilql_parity._capture(mp, trainer_base.TPUBaseTrainer, evals)
        ref, init, j_stats, ours = _train_pair(
            j_ilql.TPUILQLTrainer, wrappers.Seq2SeqLMWithILQLHeads, jconfig,
            samples=ilql_parity.TRAIN_SAMPLES, rewards=ilql_parity.TRAIN_REWARDS)
    assert ours.iter_count == ref.iter_count == ilql_parity.STEPS
    _assert_streams(j_stats, ours, "losses/loss")
    assert len(evals) == len(j_evals) == 6
    for (_, a), (_, b) in zip(evals, j_evals):
        np.testing.assert_array_equal(a, b)
    _assert_adapter_run(ours, init)


@pytest.mark.parametrize("peft_type", ["PROMPT_TUNING", "PREFIX_TUNING"])
@pytest.mark.parametrize("trainer", ["ppo", "ilql"])
def test_seq2seq_virtual_token_adapters_raise_as_reference(tmp_path, trainer, peft_type):
    """Seq2seq takes LoRA only, in both packages."""
    pc = {"peft_type": peft_type, "num_virtual_tokens": 2}
    if trainer == "ilql":
        jconfig = ilql_parity._train_config(tmp_path, "seq2seq").evolve(model=dict(peft_config=pc))
        kw = dict(samples=ilql_parity.TRAIN_SAMPLES, rewards=ilql_parity.TRAIN_REWARDS)
    else:
        jconfig = ppo_parity.config(tmp_path, model=dict(model_arch_type="seq2seq", peft_config=pc,
                                                         model_extra_configs={"seq2seq": dict(T5, vocab_size=258)}))
        kw = dict(reward_fn=ppo_parity.reward_fn, prompts=ppo_parity.PROMPTS)
    with pytest.raises(NotImplementedError, match="LORA"):
        trlx_tpu.train(config=jconfig, **kw)
    with pytest.raises(NotImplementedError, match="LORA"):
        trlx_tpu_torch.train(config=TRLConfig.from_dict(jconfig.to_dict()), device="cpu", **kw)


def test_value_layers_with_virtual_tokens_raise_as_reference(tmp_path):
    jconfig = ppo_parity.config(tmp_path, model=dict(peft_config={"peft_type": "PREFIX_TUNING"}),
                                method=dict(num_value_layers_unfrozen=1))
    kw = dict(reward_fn=ppo_parity.reward_fn, prompts=ppo_parity.PROMPTS)
    with pytest.raises(NotImplementedError, match="num_value_layers_unfrozen"):
        trlx_tpu.train(config=jconfig, **kw)
    with pytest.raises(NotImplementedError, match="num_value_layers_unfrozen"):
        trlx_tpu_torch.train(config=TRLConfig.from_dict(jconfig.to_dict()), device="cpu", **kw)


# -- HF-peft files ----------------------------------------------------------------


def _sft_config(tmp_path, peft_config=LORA, **model):
    return default_sft_config().evolve(
        train=dict(batch_size=8, total_steps=2, eval_interval=100, checkpoint_interval=100, seq_length=12, epochs=2,
                   tracker=None, compute_dtype="float32", checkpoint_dir=str(tmp_path / "ckpts")),
        model=dict(dict(model_path="random", peft_config=peft_config, model_extra_configs={
            "transformer": dict(hidden_size=16, n_layer=2, n_head=2, n_positions=64)}), **model),
        tokenizer=dict(tokenizer_path="byte"),
        method=dict(gen_kwargs=dict(max_new_tokens=4, do_sample=False)),
    )


@pytest.mark.parametrize("peft_config", [LORA, {"peft_type": "PROMPT_TUNING", "num_virtual_tokens": 3},
                                         {"peft_type": "PREFIX_TUNING", "num_virtual_tokens": 3}],
                         ids=["lora", "prompt", "prefix"])
def test_hf_peft_round_trip(tmp_path, peft_config):
    """`save_pretrained` writes adapter_config.json and
    adapter_model.safetensors; `peft_config=<that dir>` over the saved base
    reloads the adapter bit for bit with equal logits; the reference's
    `load_peft_adapter` reads the port's files into the same tensors, and
    the `safetensors` package reads the port's file."""
    from safetensors.numpy import load_file

    from trlx_tpu_torch.utils.loading import get_trainer

    trainer = trlx_tpu_torch.train(samples=[("question", "answer"), ("hi", "there")] * 8,
                                   config=_sft_config(tmp_path, peft_config), device="cpu")
    with torch.no_grad():
        for n, p in trainer.model.named_parameters():
            if n.startswith(peft.ADAPTER_KEYS):
                p.add_(0.01)  # a non-trivial adapter
    out = str(tmp_path / "export")
    trainer.save_pretrained(out)
    config = _sft_config(tmp_path, out, model_path=out)
    again = get_trainer(config.train.trainer)(config=config, device="cpu")
    adapters = {n: p for n, p in trainer.model.state_dict().items() if n.startswith(peft.ADAPTER_KEYS)}
    reloaded = again.model.state_dict()
    assert adapters and set(adapters) == {n for n in reloaded if n.startswith(peft.ADAPTER_KEYS)}
    for n, p in adapters.items():
        assert torch.equal(p, reloaded[n]), n
    ids = torch.full((2, 6), 7)
    with torch.no_grad():
        assert torch.equal(trainer.model(ids)["logits"], again.model(ids)["logits"])
    jpc, jadapter = jpeft.load_peft_adapter(out, JConfig(vocab_size=258, hidden_size=16, n_layer=2, n_head=2))
    keys = ("peft_type", "r", "alpha") if jpc["peft_type"] == "LORA" else ("peft_type", "num_virtual_tokens")
    assert {k: jpc[k] for k in keys} == {k: trainer._peft_cfg[k] for k in keys}
    sd = peft.adapter_state_dict_from_jax(_np(jadapter))
    assert set(sd) == set(adapters)
    for n, t in sd.items():
        assert torch.equal(t, adapters[n]), n
    raw = load_file(f"{out}/{peft.ADAPTER_SAFETENSORS}")
    ours = hf.read_safetensors(f"{out}/{peft.ADAPTER_SAFETENSORS}")
    assert set(raw) == set(ours) and all(np.array_equal(raw[k], ours[k].numpy()) for k in raw)


def test_reference_adapter_loads_into_the_port(tmp_path):
    """The reference's `save_peft_adapter` files (a Llama LoRA on q, k, v,
    o and the MLP) load into the port with equal tensors and logits equal
    to the reference's merged forward (atol 1e-5)."""
    jmodel, jparams, _ = _lora_policies("llama", TARGETS["regex_mlp"])
    jcfg = jmodel.cfg
    d = str(tmp_path / "jax_adapter")
    jpeft.save_peft_adapter(d, {"lora": jparams["lora"]}, {"peft_type": "LORA", "r": 4, "alpha": 8.0,
                                                          "targets": TARGETS["regex_mlp"]}, jcfg, "llama")
    pc, adapter = peft.load_peft_adapter(d, TransformerConfig(dtype=torch.float32, **LLAMA))
    assert pc["r"] == 4 and pc["alpha"] == 8.0
    for path, ab in jparams["lora"].items():
        for side in ("a", "b"):
            np.testing.assert_array_equal(adapter["lora"][path][side].numpy(), np.asarray(ab[side]))
    cfg = TransformerConfig(dtype=torch.float32, **LLAMA)
    model = wrappers.CausalLMWithValueHead(cfg, device="cpu")
    peft.attach_adapter(model, dict(pc, targets=peft.targets_of(adapter)))
    model.load_state_dict({k: v for k, v in params_from_jax(_np(dict(jparams, lora={})), cfg).items()},
                          strict=False)
    peft.load_adapter_into(model, adapter)
    ids, mask = _batch(11)
    with torch.no_grad():
        got = model(*_t(ids, mask))["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(jmodel.forward(jparams, jnp.asarray(ids),
                                                                     jnp.asarray(mask))["logits"]), **TOL)


def test_foreign_and_fused_adapters_load_as_reference(tmp_path):
    """A per-layer q_proj/v_proj adapter in the torch Linear layout and a
    fused c_attn one (shared A, B split in column thirds), both as `.bin`
    and as safetensors, load exactly as the reference loads them."""
    from safetensors.torch import save_file

    E, L, r = 16, 2, 4
    cfg = TransformerConfig(vocab_size=64, hidden_size=E, n_layer=L, n_head=2)
    jcfg = JConfig(vocab_size=64, hidden_size=E, n_layer=L, n_head=2)
    rng = np.random.default_rng(0)
    cases = {
        "separate": ({f"base_model.model.transformer.h.{i}.attn.{m}.lora_{s}.weight":
                      rng.normal(size=(r, E) if s == "A" else (E, r)).astype(np.float32)
                      for i in range(L) for m in ("q_proj", "v_proj") for s in "AB"}, ["q_proj", "v_proj"]),
        "fused": ({f"base_model.model.transformer.h.{i}.attn.c_attn.lora_{s}.weight":
                   rng.normal(size=(r, E) if s == "A" else (3 * E, r)).astype(np.float32)
                   for i in range(L) for s in "AB"}, ["c_attn"]),
    }
    for name, (tensors, targets) in cases.items():
        for fmt in ("safetensors", "bin"):
            d = tmp_path / f"{name}_{fmt}"
            d.mkdir()
            ts = {k: torch.from_numpy(v) for k, v in tensors.items()}
            if fmt == "bin":
                torch.save(ts, d / "adapter_model.bin")
            else:
                save_file(ts, str(d / "adapter_model.safetensors"))
            (d / "adapter_config.json").write_text(json.dumps(
                {"peft_type": "LORA", "r": r, "lora_alpha": 8, "target_modules": targets}))
            pc, got = peft.load_peft_adapter(str(d), cfg)
            if fmt == "safetensors":
                jpc, want = jpeft.load_peft_adapter(str(d), jcfg)
                assert pc == jpc
                assert set(got["lora"]) == set(want["lora"])
                for path, ab in want["lora"].items():
                    for side in ("a", "b"):
                        np.testing.assert_array_equal(got["lora"][path][side].numpy(), np.asarray(ab[side]))
            assert set(got["lora"]) == ({"blocks/attn/q/kernel", "blocks/attn/v/kernel"} if name == "separate"
                                        else {"blocks/attn/q/kernel", "blocks/attn/k/kernel",
                                              "blocks/attn/v/kernel"})
            if name == "fused":
                full_b = tensors["base_model.model.transformer.h.0.attn.c_attn.lora_B.weight"].T
                np.testing.assert_array_equal(got["lora"]["blocks/attn/k/kernel"]["b"][0].numpy(),
                                              full_b[:, E:2 * E])


def test_write_safetensors_round_trip(tmp_path):
    """The port's writer against its own reader and the `safetensors`
    package, over every dtype the reader names."""
    from safetensors.torch import load_file

    ts = {"f32": torch.randn(3, 4), "bf16": torch.randn(5).to(torch.bfloat16), "i8": torch.arange(6, dtype=torch.int8),
          "i64": torch.arange(2, dtype=torch.int64).reshape(1, 2), "empty": torch.zeros(0, 3), "b": torch.tensor([True])}
    fp = str(tmp_path / "x.safetensors")
    hf.write_safetensors(fp, ts)
    for read in (hf.read_safetensors, load_file):
        got = read(fp)
        assert set(got) == set(ts)
        for k, v in ts.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
