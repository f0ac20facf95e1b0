"""`save_pretrained` and the reload from a local directory, on the CPU:

- round trips bitwise for the bare `CausalLM` (the SFT trainer), for
  `CausalLMWithValueHead` (the PPO trainer, its value head kept as aux)
  and for the T5 value-headed model;
- `trlx_tpu_config.json` key for key and value for value as the JAX
  package writes it for the same architecture (causal and seq2seq); the
  directory the JAX package writes (orbax params/) raises a clear error;
- the runtime keys of `model_extra_configs` apply on top of a loaded
  config, architecture keys do not;
- a PPO trainer built from a saved directory holds the saved base and aux
  weights, and its frozen reference (hydra branch or full copy) equals
  them; `train(samples=...)` -> `save_pretrained` -> `train(reward_fn=...,
  model_path=dir)` runs."""

import json

import jax
import numpy as np
import pytest
import torch

from trlx_tpu.data.default_configs import default_ppo_config as j_default_ppo_config
from trlx_tpu.utils.loading import get_trainer as j_get_trainer

import trlx_tpu_torch
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import default_ppo_config, default_sft_config
from trlx_tpu_torch.trainer.base import AUX_WEIGHTS, BASE_WEIGHTS, NATIVE_CONFIG
from trlx_tpu_torch.utils.loading import get_trainer

TRANSFORMER = dict(hidden_size=32, n_layer=3, n_head=2, n_positions=64)
SEQ2SEQ = dict(d_model=32, n_layer=2, n_decoder_layer=3, n_head=2, d_kv=16, d_ff=64, activation="gated-gelu",
               tie_word_embeddings=False)


def _reward(samples, **kw):
    return [float(len(s)) for s in samples]


def _ppo_config(tmp_path, arch="causal", k=-1, **extra):
    key, arch_cfg = ("seq2seq", SEQ2SEQ) if arch == "seq2seq" else ("transformer", TRANSFORMER)
    return default_ppo_config().evolve(
        train=dict(batch_size=8, total_steps=2, seq_length=12, epochs=1, eval_interval=100, tracker=None,
                   compute_dtype="float32", checkpoint_dir=str(tmp_path / "ckpts"), seed=3),
        model=dict(model_path="random", model_arch_type=arch, num_layers_unfrozen=k,
                   model_extra_configs={key: dict(arch_cfg, **extra)}),
        tokenizer=dict(tokenizer_path="byte"),
        method=dict(num_rollouts=8, chunk_size=8, ppo_epochs=1, gen_kwargs=dict(max_new_tokens=4)),
    )


def _sft_config(tmp_path):
    return default_sft_config().evolve(
        train=dict(batch_size=4, total_steps=3, seq_length=12, epochs=10, compute_dtype="float32",
                   checkpoint_dir=str(tmp_path / "ckpts"), seed=3),
        model=dict(model_path="random", model_extra_configs={"transformer": TRANSFORMER}),
        tokenizer=dict(tokenizer_path="byte"),
        method=dict(gen_kwargs=dict(max_new_tokens=4)),
    )


def _trainer(config):
    return get_trainer(config.train.trainer)(config=config, reward_fn=_reward, device="cpu")


def _assert_state_equal(got, want):
    assert set(got) == set(want)
    for name, x in want.items():
        assert torch.equal(got[name], x), name


def _saved_state(directory):
    return (torch.load(directory / BASE_WEIGHTS, weights_only=True),
            torch.load(directory / AUX_WEIGHTS, weights_only=True) if (directory / AUX_WEIGHTS).exists() else {})


@pytest.mark.parametrize("arch,k", [("causal", 1), ("causal", -1), ("seq2seq", 2)],
                         ids=["causal-hydra", "causal-full", "t5-hydra"])
def test_ppo_round_trip_keeps_base_aux_and_reference(tmp_path, arch, k):
    trainer = _trainer(_ppo_config(tmp_path, arch, k))
    with torch.no_grad():  # move every weight off its init so nothing matches by chance
        for p in trainer.model.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())) * 1e-3)
    out = tmp_path / "saved"
    trainer.save_pretrained(str(out))
    base, aux = _saved_state(out)
    _assert_state_equal(base, trainer.model.base.state_dict())
    assert set(aux) == {n for n in trainer.model.state_dict() if not n.startswith("base.")} != set()

    config = _ppo_config(tmp_path, arch, k)
    config.model.model_path = str(out)
    loaded = _trainer(config)
    _assert_state_equal(loaded.model.state_dict(), trainer.model.state_dict())
    assert loaded.model_type == trainer.model_type
    # the frozen reference is taken from the loaded weights: the branch (or
    # full copy) of a model holding the saved base
    fresh = type(loaded.model)(loaded.model.cfg, branch_at=loaded.model.branch_at, device="cpu")
    fresh.base.load_state_dict(base)
    _assert_state_equal(loaded.ref_params.state_dict(), fresh.make_ref_params().state_dict())
    assert (loaded.model.branch_at is None) == (k == -1)


def test_sft_round_trip_and_ppo_from_sft(tmp_path):
    """SFT saves the bare LM (no aux file); a PPO run through
    `train(reward_fn=..., model_path=dir)` starts from it with a fresh
    value head, and its frozen reference (a full copy) is the SFT model."""
    sft = trlx_tpu_torch.train(samples=[("ab", "cd"), "efg", ("h", "ij")] * 2, config=_sft_config(tmp_path),
                               device="cpu")
    out = tmp_path / "sft"
    sft.save_pretrained(str(out))
    assert not (out / AUX_WEIGHTS).exists() and (out / "tokenizer_config.json").exists()
    base, _ = _saved_state(out)
    _assert_state_equal(base, sft.model.base.state_dict())

    config = _sft_config(tmp_path)
    config.model.model_path = str(out)
    again = get_trainer("TPUSFTTrainer")(config=config, device="cpu")
    _assert_state_equal(again.model.base.state_dict(), base)

    ppo = trlx_tpu_torch.train(reward_fn=_reward, prompts=["a", "b", "c", "d"] * 2, model_path=str(out),
                               config=_ppo_config(tmp_path), device="cpu")
    assert ppo.iter_count == 1
    _assert_state_equal(ppo.ref_params.state_dict(), base)
    assert not torch.equal(ppo.model.base.embed.wte, base["embed.wte"])  # PPO trained on from there


def test_runtime_keys_apply_on_top_of_a_loaded_config(tmp_path):
    trainer = _trainer(_ppo_config(tmp_path))
    out = tmp_path / "saved"
    trainer.save_pretrained(str(out))
    assert json.loads((out / NATIVE_CONFIG).read_text())["transformer"]["attention_impl"] == "xla"
    # runtime keys override; the architecture keys of the config are not
    # applied to a loaded model (the directory's own architecture is)
    config = _ppo_config(tmp_path, attention_impl="pallas", kv_cache_quant="int8_kernel").evolve(
        model=dict(model_extra_configs={"transformer": dict(hidden_size=64)}))
    config.model.model_path = str(out)
    loaded = _trainer(config)
    assert loaded.model.cfg.attention_impl == "pallas" and loaded.model.cfg.kv_cache_quant == "int8_kernel"
    assert loaded.model.cfg.hidden_size == TRANSFORMER["hidden_size"]
    assert loaded.model.cfg.replace(attention_impl="xla", kv_cache_quant=None) == trainer.model.cfg


def _j_ppo_config(tmp_path, arch):
    return j_default_ppo_config().evolve(**TRLConfig.to_dict(_ppo_config(tmp_path, arch)))


@pytest.mark.parametrize("arch", ["causal", "seq2seq"])
def test_native_config_matches_reference_file(tmp_path, arch):
    """trlx_tpu_config.json as the JAX package writes it for the same
    architecture: the same keys and values (the configs are field for
    field the same, so no switch is left out), the same model_type. The
    JAX package's directory holds orbax params/, which the port refuses
    with a clear error."""
    jconfig = _j_ppo_config(tmp_path, arch)
    ref = j_get_trainer(jconfig.train.trainer)(config=jconfig, reward_fn=_reward)
    jax.block_until_ready(ref.params)
    ref.save_pretrained(str(tmp_path / "jax"))
    ours = _trainer(_ppo_config(tmp_path, arch))
    ours.save_pretrained(str(tmp_path / "torch"))
    want = json.loads((tmp_path / "jax" / NATIVE_CONFIG).read_text())
    got = json.loads((tmp_path / "torch" / NATIVE_CONFIG).read_text())
    assert got == want

    config = _ppo_config(tmp_path, arch)
    config.model.model_path = str(tmp_path / "jax")
    with pytest.raises(ValueError, match="orbax"):
        _trainer(config)


def test_other_paths_raise(tmp_path):
    config = _ppo_config(tmp_path)
    config.model.model_extra_configs = {}
    config.model.model_path = str(tmp_path)  # a directory with no saved model: an HF path
    with pytest.raises(NotImplementedError, match="ROADMAP queue 7"):
        _trainer(config)
    (tmp_path / NATIVE_CONFIG).write_text(json.dumps({"transformer": dict(TRANSFORMER, vocab_size=258)}))
    with pytest.raises(FileNotFoundError, match=BASE_WEIGHTS):
        _trainer(config)
    np.testing.assert_equal(_trainer(_ppo_config(tmp_path)).model_type, None)  # "random" stays as it is
