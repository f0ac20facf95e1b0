"""The chaos harness (`trlx_tpu_torch.utils.chaos`) against
`trlx_tpu.utils.chaos`, host-side: the same schedules through both
monkeys give the same fire decisions, consult for consult, and the same
per-site random draws (exact: both draw from python's `random` with the
same keys); the site order is the golden's; unported sites refuse to
arm; the batch poisoner works on tensors. No JAX trainer runs here."""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from trlx_tpu.utils import chaos as j_chaos

from trlx_tpu_torch.data import PPORolloutBatch, SFTBatch
from trlx_tpu_torch.utils import chaos
from trlx_tpu_torch.utils.memdoctor import classify_oom, is_oom
from trlx_tpu_torch.utils.resilient import ChaosFault

REPO = Path(__file__).resolve().parents[2]
PORTED = [s for s in chaos.FAULT_SITES if s not in chaos.UNPORTED_SITES]


def test_fault_sites_keep_the_golden_order():
    golden = json.loads((REPO / "tests" / "golden" / "chaos_sites.json").read_text())["sites"]
    assert list(chaos.FAULT_SITES) == golden == list(j_chaos.FAULT_SITES)
    assert set(PORTED) == {"nan_loss", "sigterm", "nan_reward", "ckpt_fail", "ckpt_corrupt",
                           "oom_fused_block", "oom_prefill", "hbm_creep"}


def _schedule(seed: int):
    """A random schedule over the ported sites (numpy-seeded): at/span,
    every and p entries, several per site."""
    rng = np.random.default_rng(seed)
    faults = []
    for site in PORTED:
        for _ in range(int(rng.integers(1, 4))):
            kind = rng.integers(0, 3)
            if kind == 0:
                faults.append({"fault": site, "at": int(rng.integers(1, 30)), "span": int(rng.integers(1, 4))})
            elif kind == 1:
                faults.append({"fault": site, "every": int(rng.integers(2, 9))})
            else:
                faults.append({"fault": site, "p": float(rng.uniform(0.05, 0.6))})
    return {"seed": int(rng.integers(0, 1000)), "faults": faults}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_consults_fire_as_the_reference_does(seed):
    """Interleaved consults of every ported site (a numpy-drawn order):
    each answer, the fired list and the counters equal the reference's."""
    cfg = _schedule(seed)
    ours, ref = chaos.ChaosMonkey(cfg), j_chaos.ChaosMonkey(cfg)
    order = np.random.default_rng(100 + seed).choice(PORTED, size=400)
    got = [ours.consult(s) for s in order]
    want = [ref.consult(s) for s in order]
    assert got == want and any(got)
    assert ours.fired == ref.fired
    assert {s: ours.counts()[s] for s in PORTED} == {s: ref.counts()[s] for s in PORTED}


def test_unported_sites_refuse_to_arm():
    for site in sorted(chaos.UNPORTED_SITES):
        with pytest.raises(NotImplementedError, match=r"ROADMAP queue 1, item \[1[0-2]\]"):
            chaos.ChaosMonkey({"faults": [{"fault": site, "at": 1}]})


def test_schedule_validation_matches_the_reference():
    for bad in ({"faults": [{"fault": "nope", "at": 1}]}, {"faults": [{"fault": "nan_loss"}]},
                {"faults": [{"fault": "nan_loss", "at": 1, "x": 2}]}, {"speed": 1}):
        with pytest.raises(ValueError):
            j_chaos.ChaosMonkey(bad)
        with pytest.raises(ValueError):
            chaos.ChaosMonkey(bad)
    assert chaos.build_chaos(type("T", (), {"chaos": None})()) is None


def test_oom_site_raises_what_the_classifier_takes():
    monkey = chaos.ChaosMonkey({"faults": [{"fault": "oom_prefill", "at": 2}]})
    monkey.oom("oom_prefill")
    with pytest.raises(chaos.ChaosOOM) as exc:
        monkey.oom("oom_prefill")
    assert not isinstance(exc.value, ChaosFault)
    assert is_oom(exc.value)
    event = classify_oom(exc.value, "rollout_prefill")
    ref = j_chaos.ChaosMonkey({"faults": [{"fault": "oom_prefill", "at": 1}]})
    with pytest.raises(j_chaos.ChaosOOM) as jexc:
        ref.oom("oom_prefill")
    from trlx_tpu.utils.memdoctor import classify_oom as j_classify

    assert str(exc.value) == str(jexc.value)
    assert vars(event) == vars(j_classify(jexc.value, "rollout_prefill"))
    assert event.bytes_requested == 8 << 30


def test_nan_reward_and_corrupt_checkpoint_match_the_reference(tmp_path):
    cfg = {"faults": [{"fault": "nan_reward", "every": 2}]}
    ours, ref = chaos.ChaosMonkey(cfg), j_chaos.ChaosMonkey(cfg)
    for out in ([1.0, 2.0], [3.0], 4.0, [5.0, 6.0, 7.0]):
        a, b = ours.reward_fault_post(out), ref.reward_fault_post(out)
        assert np.array_equal(np.asarray(a, float), np.asarray(b, float), equal_nan=True)
    for name in ("a", "b"):
        d = tmp_path / name / "state"
        d.mkdir(parents=True)
        (d / "model.pt").write_bytes(bytes(range(64)))
        (d / "optimizer.pt").write_bytes(bytes(range(32)))
    assert chaos.ChaosMonkey({}).corrupt_checkpoint(str(tmp_path / "a")) == str(tmp_path / "a/state/model.pt")
    j_chaos.ChaosMonkey({}).corrupt_checkpoint(str(tmp_path / "b"))
    for f in ("model.pt", "optimizer.pt"):
        assert (tmp_path / "a/state" / f).read_bytes() == (tmp_path / "b/state" / f).read_bytes()
    assert (tmp_path / "a/state/model.pt").read_bytes() != bytes(range(64))


def test_poison_batch_on_tensors():
    """Float tensors become NaN in a copy (the source stays clean); a batch
    with no float tensor comes back marked for the train step's in-graph
    NaN."""
    rng = np.random.default_rng(0)
    ppo = PPORolloutBatch(
        query_tensors=torch.from_numpy(rng.integers(0, 9, (2, 3))),
        response_tensors=torch.from_numpy(rng.integers(0, 9, (2, 4))),
        logprobs=torch.from_numpy(rng.standard_normal((2, 4)).astype(np.float32)),
        values=torch.zeros(2, 4), rewards=torch.ones(2, 4), response_mask=torch.ones(2, 4))
    bad = chaos.poison_batch(ppo)
    assert torch.isnan(bad.logprobs).all() and torch.isnan(bad.response_mask).all()
    assert torch.equal(bad.query_tensors, ppo.query_tensors) and torch.isfinite(ppo.logprobs).all()
    assert not getattr(bad, "nan_poisoned", False)
    sft = SFTBatch(input_ids=torch.ones(2, 5, dtype=torch.int32), attention_mask=torch.ones(2, 5, dtype=torch.int32),
                   labels=torch.ones(2, 5, dtype=torch.int32))
    marked = chaos.poison_batch(sft)
    assert marked.nan_poisoned and torch.equal(marked.input_ids, sft.input_ids)
    assert not getattr(sft, "nan_poisoned", False)


def test_chaos_and_guardrails_knobs_no_longer_raise_but_the_next_slice_does():
    from trlx_tpu_torch.data.default_configs import default_sft_config
    from trlx_tpu_torch.trainer.base import check_ported

    cfg = default_sft_config().evolve(train=dict(chaos={"faults": []}, guardrails={"enabled": True},
                                                 memory={"enabled": True}))
    check_ported(cfg)
    for knob in (dict(watchdog={"enabled": True}), dict(obs={"enabled": True}),
                 dict(resilient_io={"timeout_s": 1.0}), dict(profile_dir=os.devnull)):
        with pytest.raises(NotImplementedError, match=r"ROADMAP queue 1, item \[10\]"):
            check_ported(default_sft_config().evolve(train=knob))
