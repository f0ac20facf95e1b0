"""trlx_tpu_torch stands alone: it imports neither JAX nor the JAX
package, its entry points refuse to fall back to the CPU silently, and
it reads the same YAML configs as the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
PKG = REPO / "trlx_tpu_torch"
PORT_FILES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"] + [
    REPO / "scripts" / name for name in ("torch_knobs_gate_diag.py", "torch_w8a16_ab.py", "torch_adam8bit_ab.py")]


def _module_names():
    for path in sorted(PKG.rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_every_module_imports_without_jax():
    mods = list(_module_names()) + ["chip_smoke"]
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['trlx_tpu'] = None\n"
        "sys.modules['transformers'] = None\n"
        "sys.modules['safetensors'] = None\n"
        "sys.modules['peft'] = None\n"
        f"for name in {mods!r}:\n"
        "    importlib.import_module(name)\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO)),
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_robustness_modules_are_covered():
    """The guardrails, the memory doctor, the chaos harness and the offline
    plan CLI are among the modules imported without JAX and scanned for
    imports."""
    names = set(_module_names())
    for name in ("trlx_tpu_torch.utils.chaos", "trlx_tpu_torch.utils.guardrails",
                 "trlx_tpu_torch.utils.memdoctor", "trlx_tpu_torch.tools.hbm_plan"):
        assert name in names
        assert REPO / (name.replace(".", "/") + ".py") in PORT_FILES


def test_fault_tolerance_modules_are_covered():
    """The checkpoint, retry and tracker modules are among those the two
    tests above import without JAX and scan for imports."""
    names = set(_module_names())
    for name in ("trlx_tpu_torch.utils.checkpointing", "trlx_tpu_torch.utils.resilient",
                 "trlx_tpu_torch.utils.trackers", "trlx_tpu_torch.api", "trlx_tpu_torch.trainer.base"):
        assert name in names
        assert REPO / (name.replace(".", "/") + ".py") in PORT_FILES


@pytest.mark.parametrize("name", ["trlx_tpu_torch.models.lora", "trlx_tpu_torch.models.peft",
                                  "trlx_tpu_torch.models.hf"])
def test_peft_modules_are_covered(name):
    """The peft tier's modules (and the safetensors writer beside the
    reader) are among those imported without JAX, `peft` and
    `safetensors`, and scanned for imports."""
    assert name in set(_module_names())
    assert REPO / (name.replace(".", "/") + ".py") in PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax", "trlx_tpu", "transformers", "safetensors",
                                "peft"), (path, name)


def test_entry_points_raise_without_a_gpu(monkeypatch):
    from trlx_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from trlx_tpu_torch.models.wrappers import CausalLMWithValueHead

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig(vocab_size=32, hidden_size=16, n_layer=1, n_head=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CausalLMWithValueHead(cfg, branch_at=0)
    assert TransformerLM(cfg, device="cpu").device.type == "cpu"


def test_unported_switches_raise():
    """The switches of OPT, Bloom, GPT-Neo and GPT-BigCode and ring
    attention raise (the Llama and GPT-J switches, which raised until the
    port reached them, build: test_torch_arch.py)."""
    from trlx_tpu_torch.models.transformer import TransformerConfig, TransformerLM

    base = dict(vocab_size=32, hidden_size=16, n_layer=1, n_head=2)
    for kw in (dict(pos_embed="alibi"), dict(local_window=4), dict(pos_offset=2),
               dict(embed_layernorm=True), dict(attn_scale=1.0), dict(attention_impl="ring")):
        with pytest.raises(NotImplementedError):
            TransformerLM(TransformerConfig(**base, **kw), device="cpu")


def test_test_config_loads_to_equal_dicts():
    from trlx_tpu.data.configs import TRLConfig as JTRLConfig

    from trlx_tpu_torch.data.configs import TRLConfig

    path = REPO / "configs" / "test_config.yml"
    assert TRLConfig.load_yaml(str(path)).to_dict() == JTRLConfig.load_yaml(str(path)).to_dict()


def test_default_ppo_config_matches():
    from trlx_tpu.data.default_configs import default_ppo_config as j_default

    from trlx_tpu_torch.data.default_configs import default_ppo_config

    assert default_ppo_config().to_dict() == j_default().to_dict()


def _tiny_ppo_config(checkpoint_dir, **sections):
    from trlx_tpu_torch.data.default_configs import default_ppo_config

    base = dict(
        train=dict(batch_size=2, total_steps=1, seq_length=8, tracker=None, checkpoint_dir=str(checkpoint_dir)),
        model=dict(model_path="random", model_extra_configs={
            "transformer": dict(hidden_size=16, n_layer=1, n_head=2, n_positions=32)
        }),
        tokenizer=dict(tokenizer_path="byte"),
        method=dict(num_rollouts=2, chunk_size=2, gen_kwargs=dict(max_new_tokens=2)),
    )
    for name, kw in sections.items():
        base[name] = dict(base.get(name, {}), **kw)
    return default_ppo_config().evolve(**base)


def test_train_raises_without_a_gpu(monkeypatch, tmp_path):
    import trlx_tpu_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trlx_tpu_torch.train(reward_fn=lambda **kw: [0.0], prompts=["a", "b"], config=_tiny_ppo_config(tmp_path))


@pytest.mark.parametrize("section,kw", [
    ("train", dict(obs={"enabled": True})),
    ("train", dict(profile_dir="profiles")),
    ("train", dict(serve={"enabled": True})),
    ("train", dict(guardrails={"enabled": True})),
    ("train", dict(watchdog={"enabled": True})),
    ("train", dict(memory={"enabled": True})),
    ("train", dict(chaos={"seed": 0})),
    ("train", dict(resilient_io={"reward_timeout": 1.0})),
    ("method", dict(fleet={"enabled": True})),
    ("method", dict(exp={"enabled": True})),
    ("method", dict(gen_engine={"enabled": True, "data_groups": 2})),
    ("train", dict(mesh={"dp": 2})),
    ("model", dict(model_path="gpt2", model_extra_configs={})),
    ("tokenizer", dict(tokenizer_path="gpt2")),
    ("train", dict(guardrails={"enabled": True, "consistency_every": 1})),
    ("train", dict(chaos={"faults": [{"fault": "stall_rollout", "at": 1}]})),
])
def test_unported_training_knobs_raise(section, kw, tmp_path):
    """Each knob that would turn on a part the port has not reached raises
    NotImplementedError naming its ROADMAP queue, rather than training
    without it. The guardrails, the memory doctor and the chaos harness
    raised until the port reached them: they train now, and the part of
    them that is not ported (the cross-host consistency check, a chaos
    site whose consumer is not ported) raises. (The memory recipe's knobs
    train too: test_torch_memory.py.)"""
    import trlx_tpu_torch

    config = _tiny_ppo_config(tmp_path, **{section: kw})
    name = next(iter(kw))
    if name in ("guardrails", "memory", "chaos") and kw[name] in ({"enabled": True}, {"seed": 0}):
        trainer = trlx_tpu_torch.train(reward_fn=lambda **kw: [0.0] * len(kw["samples"]), prompts=["a", "b"],
                                       config=config, device="cpu")
        assert trainer.iter_count == 1
        assert {"guardrails": trainer.guardrails.enabled, "memory": trainer.memdoctor.enabled,
                "chaos": trainer.chaos is not None}[name]
        return
    with pytest.raises(NotImplementedError, match="ROADMAP queue"):
        trlx_tpu_torch.train(reward_fn=lambda **kw: [0.0], prompts=["a", "b"], config=config, device="cpu")


def test_offline_sft_and_stop_sequences_raise(tmp_path):
    """The offline branch's misuses raise: DPO given `rewards` names the
    preference ordering, and GRPO and DPO on a seq2seq model raise
    NotImplementedError (causal only, as in the reference); the trainer
    names themselves, which raised until the port reached them, resolve
    (test_torch_grpo.py, test_torch_dpo.py). ILQL, which raised until the
    port reached it, now trains. Stop sequences, which raised until the
    port reached them, now train too: each output is cut at the first
    occurrence of a stop string before it is scored."""
    import trlx_tpu_torch
    from trlx_tpu_torch.data.default_configs import default_dpo_config, default_grpo_config, default_ilql_config

    tiny = _tiny_ppo_config(tmp_path).to_dict()
    train = dict(batch_size=2, total_steps=1, seq_length=8, checkpoint_dir=str(tmp_path))
    dpo = default_dpo_config().evolve(train=train, model=tiny["model"],
                                      tokenizer=tiny["tokenizer"], method=dict(gen_kwargs=dict(max_new_tokens=2)))
    with pytest.raises(ValueError, match="preference ordering"):
        trlx_tpu_torch.train(samples=[("a", "b", "c")], rewards=[1.0], config=dpo, device="cpu")
    seq2seq = dict(model_arch_type="seq2seq", model_extra_configs={"seq2seq": dict(
        d_model=16, n_layer=1, n_head=2, d_kv=8, d_ff=32)})
    grpo = default_grpo_config().evolve(train=train, model=tiny["model"],
                                        tokenizer=tiny["tokenizer"],
                                        method=dict(num_rollouts=2, chunk_size=2, group_size=2,
                                                    gen_kwargs=dict(max_new_tokens=2)))
    with pytest.raises(NotImplementedError, match="seq2seq DPO"):
        trlx_tpu_torch.train(samples=[("a", "b", "c")], config=dpo.evolve(model=seq2seq), device="cpu")
    with pytest.raises(NotImplementedError, match="seq2seq GRPO"):
        trlx_tpu_torch.train(reward_fn=lambda **kw: [0.0], prompts=["a"], config=grpo.evolve(model=seq2seq),
                             device="cpu")
    ilql = trlx_tpu_torch.train(samples=[("a", "b"), ("c", "d")], rewards=[1.0, 0.0], device="cpu",
                                config=default_ilql_config().evolve(
                                    train=train, model=tiny["model"],
                                    tokenizer=tiny["tokenizer"], method=dict(gen_kwargs=dict(max_new_tokens=2))))
    assert ilql.iter_count == 1
    scored = []

    def reward_fn(outputs, **kw):
        scored.extend(outputs)
        return [0.0] * len(outputs)

    trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=["a", "b"], config=_tiny_ppo_config(tmp_path),
                                   stop_sequences=["\n"], device="cpu")
    assert trainer.stop_sequences == ["\n"] and scored
    assert not any("\n" in o for o in scored)
