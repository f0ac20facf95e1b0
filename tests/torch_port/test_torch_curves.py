"""The port's learning curves (docs/torch_curves/*.jsonl): the contract
tests/test_curves.py holds the JAX package's curves to (a meta first line
with task / protocol / hardware / date / reference_protocol and numeric
final_* metrics, then step-keyed numeric rows in step order) and its
thresholds: randomwalks SFT final optimality >= 0.95, PPO >= 0.9, ILQL
>= 0.9 at beta = 100, RFT >= 0.85.

The whole randomwalks protocol takes about 40 s on one CPU thread, so it
also runs live here: the SFT runner, and the PPO runner's behaviour
cloning -> save_pretrained -> reload -> PPO, each writing its curve
through the same writer; the ILQL and RFT runners run cut short. The live runs are held to the contract, finite
losses and a rising eval optimality; the thresholds are the committed
curves', which were recorded on the card (their meta's hardware)."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
CURVES = REPO / "docs" / "torch_curves"
THRESHOLDS = {"randomwalks_sft.jsonl": ("final_optimality", 0.95),
              "randomwalks_ppo.jsonl": ("final_optimality", 0.9),
              "randomwalks_ilql.jsonl": ("final_optimality@beta=100", 0.9),
              "randomwalks_rft.jsonl": ("final_optimality", 0.85)}


def _check_contract(path: Path) -> dict:
    lines = path.read_text().splitlines()
    meta = json.loads(lines[0])["meta"]
    for key in ("task", "protocol", "hardware", "date", "reference_protocol"):
        assert key in meta, f"{path}: meta missing {key!r}"
    finals = [k for k in meta if k.startswith("final_")]
    assert finals and all(isinstance(meta[k], (int, float)) for k in finals), path
    steps = []
    for line in lines[1:]:
        rec = json.loads(line)
        assert "step" in rec and len(rec) > 1, f"{path}: row without metrics"
        assert all(isinstance(v, (int, float)) for v in rec.values()), f"{path}: non-numeric row value"
        steps.append(rec["step"])
    assert steps == sorted(steps), f"{path}: steps not monotonic"
    return meta


@pytest.mark.parametrize("name", sorted(THRESHOLDS))
def test_committed_curve_contract_and_threshold(name):
    meta = _check_contract(CURVES / name)
    key, minimum = THRESHOLDS[name]
    assert meta[key] >= minimum, f"{name}: {key}={meta[key]} < {minimum}"
    assert "trlx_tpu_torch/examples/" in meta["task"]


def _rows(path: Path, key: str):
    return [json.loads(line)[key] for line in path.read_text().splitlines()[1:] if key in json.loads(line)]


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_sft_runner_live(tmp_path, one_thread):
    from trlx_tpu_torch.examples import sft_randomwalks

    trainer = sft_randomwalks.main({"train.checkpoint_dir": str(tmp_path / "ckpts")}, device="cpu")
    meta = sft_randomwalks.record(trainer, str(tmp_path / "sft.jsonl"), device="cpu")
    assert _check_contract(tmp_path / "sft.jsonl") == meta
    losses = _rows(tmp_path / "sft.jsonl", "losses/loss")
    optimality = _rows(tmp_path / "sft.jsonl", "metrics/optimality")
    assert len(losses) == trainer.iter_count == 100 and all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0] - 2.0
    assert optimality[-1] >= optimality[0] + 0.5


def test_ppo_runner_live(tmp_path, one_thread):
    """Behaviour cloning, save_pretrained into <checkpoint_dir>/bc_warmup/
    hf_model, the reload through model_path and 80 PPO steps."""
    from trlx_tpu_torch.examples import ppo_randomwalks

    trainer = ppo_randomwalks.main({"train.checkpoint_dir": str(tmp_path / "ckpts")}, device="cpu")
    assert trainer.config.model.model_path == str(tmp_path / "ckpts" / "bc_warmup" / "hf_model")
    assert (tmp_path / "ckpts" / "bc_warmup" / "hf_model" / "base_weights.pt").exists()
    meta = ppo_randomwalks.record(trainer, str(tmp_path / "ppo.jsonl"), device="cpu")
    assert _check_contract(tmp_path / "ppo.jsonl") == meta
    losses = _rows(tmp_path / "ppo.jsonl", "losses/total_loss")
    optimality = _rows(tmp_path / "ppo.jsonl", "metrics/optimality")
    assert len(losses) == trainer.iter_count == 80 and all(math.isfinite(x) for x in losses)
    assert len(optimality) == 5 and optimality[-1] >= optimality[0] + 0.3


def test_ilql_runner_live_short(tmp_path, one_thread):
    """The ILQL runner, cut to 32 steps: every evaluation sweeps beta over
    [0, 1, 100], and the meta holds a final optimality at each."""
    from trlx_tpu_torch.examples import ilql_randomwalks

    trainer = ilql_randomwalks.main({"train.checkpoint_dir": str(tmp_path / "ckpts"), "train.total_steps": 32},
                                    device="cpu")
    meta = ilql_randomwalks.record(trainer, str(tmp_path / "ilql.jsonl"), device="cpu")
    assert _check_contract(tmp_path / "ilql.jsonl") == meta
    assert {f"final_optimality@beta={b}" for b in (0, 1, 100)} <= set(meta)
    losses = _rows(tmp_path / "ilql.jsonl", "losses/loss")
    assert len(losses) == trainer.iter_count == 32 and all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]
    assert len(_rows(tmp_path / "ilql.jsonl", "metrics/optimality@beta=100")) == 3  # steps 0, 16, 32


def test_rft_runner_live_short(tmp_path, one_thread):
    """The RFT runner after its behaviour cloning, cut to 8 steps: the
    selection rounds are logged and the curve keeps the contract."""
    from trlx_tpu_torch.examples import rft_randomwalks

    trainer = rft_randomwalks.main({"train.checkpoint_dir": str(tmp_path / "ckpts"), "train.total_steps": 8,
                                    "train.eval_interval": 8}, device="cpu")
    assert trainer.config.model.model_path == str(tmp_path / "ckpts" / "bc_warmup" / "hf_model")
    meta = rft_randomwalks.record(trainer, str(tmp_path / "rft.jsonl"), device="cpu")
    assert _check_contract(tmp_path / "rft.jsonl") == meta
    selected = _rows(tmp_path / "rft.jsonl", "len_samples_selected")
    assert selected and all(n > 0 for n in selected)
    assert len(_rows(tmp_path / "rft.jsonl", "losses/loss")) == trainer.iter_count == 8


def test_ppo_from_jax_clone_matches_reference(tmp_path):
    """The cross-start check (`scripts/torch_randomwalks_cross_start.py`):
    the JAX example's behaviour-cloned start at the example's seed,
    converted into the port's save format, and the JAX trainer's value
    head; then two PPO cycles (8 steps) of the example's config, greedy in
    fp32, in the port and in the JAX package's per-step loop. The cloned
    start ends its walks with EOS, which the PPO parity test's random
    model never emits. Held: the last rollouts' tokens and masks exactly,
    their logprobs, values and rewards within 1e-4, the loss stream to
    rtol 1e-4 and the eval optimality exactly. It runs in a fresh
    interpreter on one torch thread (`cross_start_check.py`), as the
    script's `main` does, so that nothing an earlier test left in the
    worker's process reaches it."""
    res = subprocess.run(
        [sys.executable, "-m", "tests.torch_port.cross_start_check", str(tmp_path)], cwd=REPO,
        capture_output=True, text=True, timeout=900, env=dict(os.environ, PYTHONPATH=str(REPO)),
    )
    assert res.returncode == 0, f"{res.stdout[-3000:]}\n{res.stderr[-6000:]}"
    assert "every comparison holds" in res.stdout
