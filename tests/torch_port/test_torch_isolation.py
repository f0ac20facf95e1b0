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
PORT_FILES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


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
            assert root not in ("jax", "jaxlib", "flax", "optax", "trlx_tpu"), (path, name)


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
    from trlx_tpu_torch.models.transformer import TransformerConfig, TransformerLM

    base = dict(vocab_size=32, hidden_size=16, n_layer=1, n_head=2)
    for kw in (dict(pos_embed="rotary"), dict(norm="rmsnorm"), dict(mlp_gated=True),
               dict(parallel_residual=True), dict(attention_impl="ring"),
               dict(local_window=4), dict(tie_word_embeddings=False)):
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


def _tiny_ppo_config(**sections):
    from trlx_tpu_torch.data.default_configs import default_ppo_config

    base = dict(
        train=dict(batch_size=2, total_steps=1, seq_length=8, tracker=None),
        model=dict(model_path="random", model_extra_configs={
            "transformer": dict(hidden_size=16, n_layer=1, n_head=2, n_positions=32)
        }),
        tokenizer=dict(tokenizer_path="byte"),
        method=dict(num_rollouts=2, chunk_size=2, gen_kwargs=dict(max_new_tokens=2)),
    )
    for name, kw in sections.items():
        base[name] = dict(base.get(name, {}), **kw)
    return default_ppo_config().evolve(**base)


def test_train_raises_without_a_gpu(monkeypatch):
    import trlx_tpu_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trlx_tpu_torch.train(reward_fn=lambda **kw: [0.0], prompts=["a", "b"], config=_tiny_ppo_config())


@pytest.mark.parametrize("section,kw", [
    ("train", dict(minibatch_size=1)),
    ("train", dict(grads_dtype="bfloat16")),
    ("train", dict(remat_policy="full")),
    ("train", dict(guardrails={"enabled": True})),
    ("train", dict(watchdog={"enabled": True})),
    ("train", dict(memory={"enabled": True})),
    ("train", dict(chaos={"seed": 0})),
    ("train", dict(resume_from_checkpoint="auto")),
    ("method", dict(overlap_rollouts=True)),
    ("method", dict(exp={"enabled": True})),
    ("method", dict(gen_engine={"enabled": True, "data_groups": 2})),
    ("model", dict(model_arch_type="seq2seq", model_extra_configs={"seq2seq": dict(
        d_model=16, n_layer=1, n_head=2, d_kv=8, d_ff=32, decode_weights_quant="int8")})),
    ("model", dict(model_path="gpt2", model_extra_configs={})),
    ("tokenizer", dict(tokenizer_path="gpt2")),
])
def test_unported_training_knobs_raise(section, kw):
    """Each knob that would turn on a part the port has not reached raises
    NotImplementedError naming its ROADMAP queue, rather than training
    without it."""
    import trlx_tpu_torch

    with pytest.raises(NotImplementedError, match="ROADMAP queue"):
        trlx_tpu_torch.train(reward_fn=lambda **kw: [0.0], prompts=["a", "b"],
                             config=_tiny_ppo_config(**{section: kw}), device="cpu")


def test_offline_sft_and_stop_sequences_raise():
    import trlx_tpu_torch

    with pytest.raises(NotImplementedError, match="ROADMAP queue 6"):
        trlx_tpu_torch.train(samples=["a"], rewards=[1.0], config=_tiny_ppo_config(), device="cpu")
    with pytest.raises(NotImplementedError, match="left out of slice 2"):
        trlx_tpu_torch.train(reward_fn=lambda **kw: [0.0], prompts=["a", "b"], config=_tiny_ppo_config(),
                             stop_sequences=["\n"], device="cpu")
