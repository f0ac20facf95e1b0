"""trlx_tpu_torch.models.hf: local HF checkpoint directories, without
`transformers` or `safetensors` in the port.

Tiny HF GPT-2, Llama (GQA), GPT-J and T5 models are built in-process
with `transformers` (no network, as tests/test_models.py does), their
norm weights and biases perturbed by N(0, 0.5) so that a norm loaded in
the wrong place shows (GPT-NeoX's ln_1 / ln_2 mix-up in the JAX package
shows only so). Each is saved as `pytorch_model.bin`, as
`model.safetensors` and as a sharded `.bin` checkpoint with its index.
The port's `load_pretrained` is held to HF's logits and to the JAX
package's `load_pretrained` at the reference test's bars (rtol 1e-3,
atol 2e-3); its safetensors reader to the `safetensors` library bit for
bit; its export round trip bit for bit; `train(model_path=<HF dir>)` to
`trlx_tpu.train` on the same directory (the ppo_parity bars); and
`save_pretrained` of an HF-loaded model reloads bit for bit."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from safetensors.torch import load_file, save_file

from trlx_tpu.models import hf as jhf
from trlx_tpu.models.seq2seq import T5LM as JT5LM

from tests.torch_port import ppo_parity
from trlx_tpu_torch.models import hf, wrappers
from trlx_tpu_torch.models.convert import params_from_jax
from trlx_tpu_torch.models.seq2seq import T5LM
from trlx_tpu_torch.models.transformer import TransformerLM
from trlx_tpu_torch.utils.loading import get_trainer

TOL = dict(rtol=1e-3, atol=2e-3)
FORMATS = ("bin", "safetensors", "sharded")


def tiny_hf_model(model_type: str, vocab: int = 97):
    if model_type == "gpt2":
        return transformers.GPT2LMHeadModel(transformers.GPT2Config(
            vocab_size=vocab, n_positions=64, n_embd=32, n_layer=3, n_head=2))
    if model_type == "llama":
        return transformers.LlamaForCausalLM(transformers.LlamaConfig(
            vocab_size=vocab, max_position_embeddings=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, intermediate_size=56, tie_word_embeddings=False))
    if model_type == "gptj":
        return transformers.GPTJForCausalLM(transformers.GPTJConfig(
            vocab_size=vocab, n_positions=64, n_embd=32, n_layer=2, n_head=2, rotary_dim=8))
    if model_type == "t5":
        return transformers.T5ForConditionalGeneration(transformers.T5Config(
            vocab_size=vocab, d_model=32, d_kv=16, d_ff=64, num_layers=2, num_decoder_layers=2, num_heads=2,
            feed_forward_proj="gated-gelu", tie_word_embeddings=False, decoder_start_token_id=0))
    raise ValueError(model_type)


def hf_dir(tmp_path, model_type: str, fmt: str, vocab: int = 97):
    """A perturbed tiny HF model saved to a directory in `fmt`: (model,
    directory)."""
    torch.manual_seed(0)
    model = tiny_hf_model(model_type, vocab).eval()
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            # GPT-J's lm_head bias stays at its zero init: neither package reads it
            if ("norm" in name or "ln_" in name or name.endswith(".bias")) and not name.startswith("lm_head"):
                p.add_(torch.from_numpy(rng.normal(0, 0.5, tuple(p.shape)).astype(np.float32)))
    path = str(tmp_path / f"{model_type}_{fmt}")
    kw = {"bin": dict(safe_serialization=False), "safetensors": dict(safe_serialization=True),
          "sharded": dict(safe_serialization=False, max_shard_size="40KB")}[fmt]
    model.save_pretrained(path, **kw)
    if fmt == "sharded":
        assert os.path.exists(os.path.join(path, "pytorch_model.bin.index.json"))
        assert len([f for f in os.listdir(path) if f.endswith(".bin")]) >= 2
    return model, path


def _ids(vocab=97, shape=(2, 12), seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("model_type", ["gpt2", "llama", "gptj"])
def test_causal_load_matches_hf_and_jax(tmp_path, model_type, fmt):
    model, path = hf_dir(tmp_path, model_type, fmt)
    cfg, sd, mt = hf.load_pretrained(path, dtype=torch.float32)
    assert mt == model_type
    lm = TransformerLM(cfg, device="cpu")
    lm.load_state_dict(sd)
    ids = _ids()
    with torch.no_grad():
        got = lm(torch.from_numpy(ids))["logits"].numpy()
        want = model(torch.from_numpy(ids)).logits.numpy()
    np.testing.assert_allclose(got, want, **TOL)
    jlm, jparams, jmt = jhf.load_pretrained(path, dtype=jnp.float32)
    assert jmt == model_type and jlm.cfg.pos_embed == cfg.pos_embed
    np.testing.assert_allclose(got, np.asarray(jlm(jparams, jnp.asarray(ids))["logits"]), **TOL)
    # the port's tree is the JAX package's tree, leaf for leaf
    jsd = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    assert set(jsd) == set(sd) and all(torch.equal(jsd[k], sd[k]) for k in sd)


@pytest.mark.parametrize("fmt", FORMATS)
def test_t5_load_matches_hf_and_jax(tmp_path, fmt):
    model, path = hf_dir(tmp_path, "t5", fmt)
    cfg, sd, mt = hf.load_pretrained_seq2seq(path, dtype=torch.float32)
    assert mt == "t5" and cfg.activation == "gated-gelu" and not cfg.tie_word_embeddings
    lm = T5LM(cfg, device="cpu")
    lm.load_state_dict(sd)
    enc, dec = _ids(shape=(2, 7)), _ids(shape=(2, 5), seed=2)
    enc_mask, dec_mask = np.ones_like(enc), np.ones_like(dec)
    with torch.no_grad():
        got = lm(*map(torch.from_numpy, (enc, enc_mask, dec, dec_mask)))["logits"].numpy()
        want = model(input_ids=torch.from_numpy(enc), decoder_input_ids=torch.from_numpy(dec)).logits.numpy()
    np.testing.assert_allclose(got, want, **TOL)
    jlm, jparams, _ = jhf.load_pretrained_seq2seq(path, dtype=jnp.float32)
    assert isinstance(jlm, JT5LM)
    ref = jlm(jparams, *map(jnp.asarray, (enc, enc_mask, dec, dec_mask)))["logits"]
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def test_safetensors_reader_matches_library_bit_for_bit(tmp_path):
    """Every dtype the format names, a scalar, an empty tensor, odd
    offsets: the reader gives the library's tensors exactly."""
    g = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn(3, 5, generator=g), "bf16": torch.randn(7, generator=g).to(torch.bfloat16),
        "f16": torch.randn(2, 3, 1, generator=g).to(torch.float16), "f64": torch.randn(4, generator=g).double(),
        "i64": torch.arange(-5, 6), "i32": torch.arange(9, dtype=torch.int32).reshape(3, 3),
        "i16": torch.arange(-3, 3, dtype=torch.int16), "i8": torch.tensor([-128, 0, 127], dtype=torch.int8),
        "u8": torch.tensor([0, 1, 255], dtype=torch.uint8), "bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(3.5), "empty": torch.zeros(0, 4),
    }
    fp = str(tmp_path / "t.safetensors")
    save_file(tensors, fp, metadata={"format": "pt"})
    got, want = hf.read_safetensors(fp), load_file(fp)
    assert set(got) == set(want) == set(tensors)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape and torch.equal(got[k], v), k


@pytest.mark.parametrize("model_type", ["gpt2", "llama", "gptj", "t5"])
def test_export_round_trip_bit_for_bit(tmp_path, model_type):
    """HF state dict -> the port's -> HF again: every tensor of the HF
    model's own state dict comes back bit for bit (GPT-J's lm_head bias,
    not read, as zeros: zero in a fresh model), and back into the port's
    bit for bit; `save_pretrained_hf` writes what HF reloads to equal
    logits."""
    model, path = hf_dir(tmp_path, model_type, "bin")
    seq2seq = model_type == "t5"
    cfg, sd, _ = (hf.load_pretrained_seq2seq if seq2seq else hf.load_pretrained)(path, dtype=torch.float32)
    export = hf.t5_state_dict_from_params(sd, cfg) if seq2seq else hf.state_dict_from_params(sd, cfg, model_type)
    original = model.state_dict()
    for k, v in original.items():
        assert torch.equal(export[k], v.float()), k
    again = hf.t5_params_from_state_dict(export, cfg) if seq2seq else hf.params_from_state_dict(export, cfg, model_type)
    assert set(again) == set(sd) and all(torch.equal(again[k], sd[k]) for k in sd)
    out = str(tmp_path / "export")
    hf.save_pretrained_hf(sd, cfg, model_type, path, out)
    reloaded = type(model).from_pretrained(out).eval()
    ids = _ids()
    with torch.no_grad():
        if seq2seq:
            a = model(input_ids=torch.from_numpy(ids), decoder_input_ids=torch.from_numpy(ids)).logits
            b = reloaded(input_ids=torch.from_numpy(ids), decoder_input_ids=torch.from_numpy(ids)).logits
        else:
            a, b = model(torch.from_numpy(ids)).logits, reloaded(torch.from_numpy(ids)).logits
    assert torch.equal(a, b)


@pytest.mark.parametrize("model_type", ["gpt_neox", "opt", "bloom", "gpt_bigcode", "gpt_neo"])
def test_unported_families_raise(tmp_path, model_type):
    path = tmp_path / model_type
    path.mkdir()
    (path / "config.json").write_text(json.dumps({"model_type": model_type}))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 7"):
        hf.load_pretrained(str(path))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 7"):
        hf.load_pretrained_seq2seq(str(path))


def test_missing_keys_take_transformers_defaults(tmp_path):
    """transformers writes only the keys that differ from a default: the
    reader supplies those defaults as transformers' config classes do."""
    model, path = hf_dir(tmp_path, "llama", "bin")
    with open(os.path.join(path, "config.json")) as f:
        raw = json.load(f)
    assert hf.read_config(path).rope_theta == model.config.rope_theta
    full = transformers.AutoConfig.from_pretrained(path)
    cfg = hf.config_from_hf(hf.read_config(path))
    assert (cfg.n_kv_head, cfg.layer_norm_epsilon, cfg.tie_word_embeddings) == (
        full.num_key_value_heads, full.rms_norm_eps, full.tie_word_embeddings)
    assert "model_type" in raw


def _llama_dir(tmp_path):
    # vocab 300 >= the byte tokenizer's 258 ids
    return hf_dir(tmp_path, "llama", "safetensors", vocab=300)[1]


def test_train_from_hf_dir_matches_reference(tmp_path):
    """`trlx_tpu_torch.train(model_path=<a local HF Llama directory>)`
    against `trlx_tpu.train` on the same directory: both load the same
    weights (the reference through transformers and safetensors, the port
    through models/hf.py), the port's value head is the reference's, then
    two cycles of 8 steps: the stores (tokens exactly, logprobs, values and
    rewards atol 1e-4) and the loss stream (rtol 1e-4)."""
    path = _llama_dir(tmp_path)
    jconfig = ppo_parity.config(tmp_path, model=dict(model_path=path, num_layers_unfrozen=1))
    jconfig = type(jconfig).from_dict({**jconfig.to_dict(), "model": {
        **jconfig.to_dict()["model"], "model_extra_configs": {}}})
    ref, init, j_stats = ppo_parity.run_reference(jconfig)
    with pytest.MonkeyPatch.context() as mp:
        # the heads the reference drew (the base weights are the directory's on both sides)
        mp.setattr(wrappers.CausalLMWithValueHead, "init_heads",
                   lambda self, gen: self.load_state_dict(params_from_jax(init, self.cfg)) and self)
        ours = ppo_parity.run_port(jconfig, init)
    assert ours.model_type == "llama" and ours.model.cfg.norm == "rmsnorm"
    assert ours.iter_count == ref.iter_count == 8
    ppo_parity.assert_store_matches(ours, ref)
    want, got = ppo_parity.losses(j_stats), ppo_parity.losses(ours.stats_history)
    assert [s for s, _ in got] == [s for s, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-4, atol=1e-5)


def test_save_pretrained_of_hf_model_reloads_bit_for_bit(tmp_path):
    """A model loaded from an HF directory saves the HF layout
    (config.json carried over, pytorch_model.bin, the value head in
    aux_weights.pt beside it) and `model_path=<that dir>` reloads the base
    bit for bit; a hub name raises (no network)."""
    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig

    path = _llama_dir(tmp_path)
    config = TRLConfig.from_dict(ppo_parity.config(tmp_path).to_dict())
    d = config.to_dict()
    d["model"].update(model_path=path, model_extra_configs={"transformer": {"kv_cache_quant": "int8"}})
    d["train"].update(total_steps=2)
    config = TRLConfig.from_dict(d)
    trainer = trlx_tpu_torch.train(reward_fn=ppo_parity.reward_fn, prompts=ppo_parity.PROMPTS, config=config,
                                   device="cpu")
    assert trainer.model.cfg.kv_cache_quant == "int8"  # the runtime key rides on the HF load
    out = str(tmp_path / "saved")
    trainer.save_pretrained(out)
    files = set(os.listdir(out))
    assert {"config.json", "pytorch_model.bin", "aux_weights.pt"} <= files and "base_weights.pt" not in files
    d["model"].update(model_path=out)
    reloaded = get_trainer(config.train.trainer)(config=TRLConfig.from_dict(d), reward_fn=ppo_parity.reward_fn,
                                                 device="cpu")
    a, b = trainer.model.base.state_dict(), reloaded.model.base.state_dict()
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    d["model"].update(model_path="meta-llama/Llama-2-7b-hf")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 7"):
        get_trainer(config.train.trainer)(config=TRLConfig.from_dict(d), reward_fn=ppo_parity.reward_fn,
                                          device="cpu")
