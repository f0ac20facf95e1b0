"""The guardrails (`trlx_tpu_torch.utils.guardrails`) against
`trlx_tpu.utils.guardrails`: host-side, identical observation sequences
(numpy-drawn) through both monitors give the same decisions, state
summaries, trip histories and commit gates, exactly; the signal names are
the golden's. End to end: a chaos `nan_loss` burst in PPO `train()`
against `trlx_tpu.train`'s per-step loop on identical weights, fp32 and
greedy: the same trips and ladder actions at the same steps, the rollback
to the same step, and the loss stream to rtol 1e-4; a requeue and an
lr_cut the same way, with the learning rate logged at each step."""

import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest

import trlx_tpu
from trlx_tpu.analysis.manifests import extract_guardrail_signals
from trlx_tpu.trainer.base import TPUBaseTrainer as JBaseTrainer
from trlx_tpu.trainer.ppo import TPUPPOTrainer as JPPOTrainer
from trlx_tpu.utils import guardrails as j_guardrails

import trlx_tpu_torch
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.trainer.base import TPUOnlineTrainer
from trlx_tpu_torch.utils import guardrails
from tests.torch_port import ppo_parity

REPO = Path(__file__).resolve().parents[2]


def test_signals_match_the_golden():
    golden = json.loads((REPO / "tests" / "golden" / "guardrail_signals.json").read_text())["signals"]
    src = (REPO / "trlx_tpu_torch" / "utils" / "guardrails.py").read_text()
    assert extract_guardrail_signals(src)[0] == golden
    assert guardrails.LADDER_ACTIONS == j_guardrails.LADDER_ACTIONS
    assert guardrails.MEMORY_SIGNAL == j_guardrails.MEMORY_SIGNAL == "memory"


def _value(rng, scale, p_bad):
    """A positive reading, sometimes NaN or a spike, sometimes absent."""
    r = rng.random()
    if r < p_bad / 2:
        return float("nan")
    if r < p_bad:
        return float(scale * 50 * (1 + rng.random()))
    if r < p_bad + 0.1:
        return None
    return float(scale * (1 + 0.1 * rng.standard_normal()))


CONFIGS = [
    {"enabled": True},
    {"enabled": True, "ladder": ["log", "lr_cut", "rollback", "abort"], "grad_norm_max": 3.0,
     "cycle_time_factor": 2.0, "truncation_max": 0.5, "cooldown_cycles": 2, "max_rollbacks": 1,
     "recover_after": 1, "min_history": 2, "window": 4},
    {"enabled": True, "ladder": ["requeue", "rollback"], "loss_spike_sigma": 2.0, "kl_factor": 1.5,
     "reward_sigma": 2.0, "recover_after": 3},
]


@pytest.mark.parametrize("case", range(len(CONFIGS)))
def test_monitor_decisions_match_the_reference(case):
    cfg = CONFIGS[case]
    ours = guardrails.GuardrailMonitor(guardrails.GuardrailConfig.from_dict(cfg))
    ref = j_guardrails.GuardrailMonitor(j_guardrails.GuardrailConfig.from_dict(cfg))
    rng = np.random.default_rng(case)
    log = []
    for cycle in range(300):
        kind = rng.integers(0, 6)
        if kind <= 2:
            args = dict(step=cycle, loss=_value(rng, 1.0, 0.08), grad_norm=_value(rng, 1.0, 0.08),
                        wall=_value(rng, 0.5, 0.05))
            ours.observe_train(**args)
            ref.observe_train(**args)
        elif kind == 3:
            args = dict(kl=_value(rng, 0.01, 0.1), kl_target=0.01, reward_mean=_value(rng, 1.0, 0.1),
                        running_mean=1.0, running_std=0.2, truncation_rate=float(rng.random()))
            ours.observe_rollout(**args)
            ref.observe_rollout(**args)
        elif kind == 4:
            signal = str(rng.choice(["memory", "stall", "staleness", "fleet"]))
            ours.trip(signal, "external")
            ref.trip(signal, "external")
        a, b = ours.pending_action(), ref.pending_action()
        assert a == b, cycle
        if a == "rollback":
            ours.notify_rollback(cycle)
            ref.notify_rollback(cycle)
        assert ours.commit_ok() == ref.commit_ok()
        assert ours.state_summary() == ref.state_summary()
        log.append(a)
    assert ours.trip_history == ref.trip_history and ours.actions_taken == ref.actions_taken
    assert [(t.signal, t.detail) for t in ours.last_trips] == [(t.signal, t.detail) for t in ref.last_trips]
    assert len(set(log) - {None}) >= 2
    ours.load_trip_tail(["x"])  # not empty: a no-op, as in the reference
    assert ours.trip_tail(5) == ref.trip_tail(5)


def test_config_validation_matches_the_reference():
    for bad in ({"ladder": ["rollback", "log"]}, {"ladder": ["log", "nope"]}, {"ladder": ["log", "log"]},
                {"windw": 3}):
        with pytest.raises(ValueError):
            j_guardrails.GuardrailConfig.from_dict(bad)
        with pytest.raises(ValueError):
            guardrails.GuardrailConfig.from_dict(bad)
    off = guardrails.GuardrailMonitor(guardrails.GuardrailConfig())
    off.observe_train(step=0, loss=float("nan"))
    assert off.pending_action() is None and off.commit_ok()


# ---------------------------------------------------------------------------
# end to end: a NaN burst walks the ladder to a rollback, in both packages
# ---------------------------------------------------------------------------


def _nan_burst_config(tmp_path):
    """PPO cycles of 4 steps (two passes of two batches) on the tiny parity
    model, the per-step loop, checkpoints every 5 steps (step 5 is mid-pass,
    where both packages save the same state), a NaN burst on the two
    batches after step 6: the first trips `log`, the second `rollback` to
    step 5, and the run goes on to step 12. Only non-finite trips are
    armed, so the comparison does not ride a threshold."""
    return ppo_parity.config(tmp_path, train=dict(
        total_steps=12, epochs=6, checkpoint_interval=5,
        guardrails=dict(enabled=True, ladder=["log", "rollback", "abort"], loss_spike_sigma=0.0,
                        kl_factor=0.0, reward_sigma=0.0, cooldown_cycles=2),
        chaos=dict(faults=[dict(fault="nan_loss", at=7, span=2)]),
    ))


def test_nan_burst_rolls_back_as_the_reference(tmp_path, monkeypatch):
    rollbacks = {"ref": [], "port": []}
    for key, cls in (("ref", j_guardrails.GuardrailMonitor), ("port", guardrails.GuardrailMonitor)):
        notify = cls.notify_rollback

        def spy(self, step, key=key, notify=notify):
            rollbacks[key].append(step)
            return notify(self, step)

        monkeypatch.setattr(cls, "notify_rollback", spy)
    # the reference keeps its interval checkpoints here (the harness's
    # no-op save would leave it nothing to roll back to)
    init, j_stats = {}, []
    setup = JPPOTrainer.setup_model

    def capture_setup(self):
        setup(self)
        init.update(jax.tree_util.tree_map(np.asarray, self.params))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JPPOTrainer, "setup_model", capture_setup)
        mp.setattr(JBaseTrainer, "_tracker_log", lambda self, st, step: j_stats.append((step, dict(st))))
        ref = trlx_tpu.train(reward_fn=ppo_parity.reward_fn, prompts=ppo_parity.PROMPTS,
                             config=_nan_burst_config(tmp_path / "ref"))
    ours = ppo_parity.run_port(_nan_burst_config(tmp_path / "port"), init)

    assert rollbacks["ref"] == rollbacks["port"] == [5]
    assert ours.guardrails.trip_history == ref.guardrails.trip_history == ["loss", "loss"]
    assert ours.guardrails.actions_taken == ref.guardrails.actions_taken == ["log", "rollback"]
    assert ours.chaos.fired == ref.chaos.fired
    assert ours.iter_count == ref.iter_count == 12
    key = "losses/total_loss"
    want = [(s, float(st[key])) for s, st in j_stats if key in st]
    got = [(s, float(st[key])) for s, st in ours.stats_history if key in st]
    assert [s for s, _ in got] == [s for s, _ in want]
    assert all(math.isfinite(v) for _, v in got)
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-4, atol=1e-6)
    ppo_parity.assert_store_matches(ours, ref)


def test_requeue_and_lr_cut_match_the_reference_and_the_cut_persists(tmp_path, monkeypatch):
    """The two rungs the NaN-burst comparison does not reach, against
    `trlx_tpu.train`'s per-step loop on identical weights: a NaN step on
    consult 3 requeues (the store dropped, the prompt stream rewound to
    the cycle's first chunk, the cycle collected again), the next one cuts
    the learning rate in half. Both packages take the same actions on the
    same trips, log the same learning rate every step (rtol 1e-6) and the
    loss stream to rtol 1e-4, and end on the same rollouts. The port's
    state.json carries `lr_scale` 0.5, and a fresh trainer that loads it
    steps at the halved schedule."""
    rewinds = []
    rewind = TPUOnlineTrainer._rewind_prompt_stream
    monkeypatch.setattr(TPUOnlineTrainer, "_rewind_prompt_stream",
                        lambda self, cursor: rewinds.append(cursor) or rewind(self, cursor))
    jconfig = ppo_parity.config(tmp_path, train=dict(
        guardrails=dict(enabled=True, ladder=["requeue", "lr_cut", "abort"], loss_spike_sigma=0.0, kl_factor=0.0,
                        reward_sigma=0.0),
        chaos=dict(faults=[dict(fault="nan_loss", at=3, span=2)])))
    ref, init, j_stats = ppo_parity.run_reference(jconfig)
    trainer = ppo_parity.run_port(jconfig, init)

    assert trainer.guardrails.actions_taken == ref.guardrails.actions_taken == ["requeue", "lr_cut"]
    assert trainer.guardrails.trip_history == ref.guardrails.trip_history == ["loss", "loss"]
    assert trainer.chaos.fired == ref.chaos.fired
    assert rewinds == [0] and trainer.iter_count == ref.iter_count == 8
    assert trainer._lr_scale == ref._lr_scale == 0.5
    key = "learning_rate_group_0"
    want = [(s, float(st[key])) for s, st in j_stats if key in st]
    got = [(s, float(st[key])) for s, st in trainer.stats_history if key in st]
    assert [s for s, _ in got] == [s for s, _ in want] and len(got) == 8
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-6, atol=0)
    want, got = ppo_parity.losses(j_stats), ppo_parity.losses(trainer.stats_history)
    assert [s for s, _ in got] == [s for s, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-4, atol=1e-6)
    ppo_parity.assert_store_matches(trainer, ref)

    config = TRLConfig.from_dict(jconfig.to_dict())
    lr = config.optimizer.kwargs["lr"]
    assert trainer.scheduler.base_lrs == [0.5 * lr]
    assert trainer.optimizer.param_groups[0]["lr"] == pytest.approx(trainer.schedule(trainer.iter_count))
    path = trainer.ckpt_manager.latest_resumable()
    with open(f"{path}/state.json") as f:
        state = json.load(f)
    assert state["lr_scale"] == 0.5 and state["guardrail_trips"] == ["loss", "loss"]
    fresh = trlx_tpu_torch.train(reward_fn=ppo_parity.reward_fn, prompts=ppo_parity.PROMPTS, device="cpu",
                                 config=config.evolve(train=dict(total_steps=0)))
    fresh.load(path)
    assert fresh._lr_scale == 0.5 and fresh.scheduler.base_lrs == [0.5 * lr]
    assert fresh.schedule(3) == pytest.approx(trainer.schedule(3))
    assert fresh.guardrails.trip_history == ["loss", "loss"]
