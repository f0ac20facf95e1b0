"""The memory doctor (`trlx_tpu_torch.utils.memdoctor`) against
`trlx_tpu.utils.memdoctor`.

Host-side, exact: the classifier on the reference's messages and on the
card's (torch's OutOfMemoryError text, a kernel wrapper's "out of memory"
launch status; launch errors and illegal addresses are not OOMs), the
config validation, the ladder's decisions and degradation records over
numpy-drawn event sequences, the max-merge of `restore`, the watermark
sampler on a fake allocator, and the config-only plan (`analytic_plan`,
the `hbm_plan` CLI). End to end against `trlx_tpu.train`'s per-step loop
on identical weights (fp32, greedy): one PPO run through the decode
engine where a chaos `oom_prefill` walks `shrink_pool` and a chaos
`oom_fused_block` walks `split_microbatch` (the loss stream to rtol 1e-4,
the rollouts token for token, the same `memory_degrade` record); the
preflight plan's state rows against the reference's `estimate_plan`
(bytes exact) and an over-budget config rejected by both before any
rollout; a degraded checkpoint resumed degraded, refused with the doctor
off and accepted under `accept_undegrade`."""

import json

import jax
import numpy as np
import pytest
import torch

import trlx_tpu
from trlx_tpu.data.configs import TRLConfig as JTRLConfig
from trlx_tpu.data.default_configs import default_ppo_config as j_default_ppo_config
from trlx_tpu.trainer.base import TPUBaseTrainer as JBaseTrainer
from trlx_tpu.utils import memdoctor as j_md

import trlx_tpu_torch
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.trainer import base as trainer_base
from trlx_tpu_torch.utils import memdoctor as md
from tests.torch_port import ppo_parity

ALL_CAPS = {"shrink_pool": True, "split_microbatch": True, "remat": True, "rollback": True}

MESSAGES = [
    "RESOURCE_EXHAUSTED: Out of memory while trying to allocate 8.25GiB.",
    "RESOURCE_EXHAUSTED: out of memory allocating 1234567 bytes while compiling the fused block",
    "Out of memory when allocating 12.5MiB during compilation",
    "OOM when allocating tensor of shape [4096]",
    "INTERNAL: something else entirely",
    "RESOURCE_EXHAUSTED: chaos: out of memory while trying to allocate 8.00GiB (oom_fused_block)",
]
# what the card says: the caching allocator's OutOfMemoryError, a kernel
# wrapper's launch status (cudaGetErrorString), and errors that are no OOM
CARD_MESSAGES = [
    ("CUDA out of memory. Tried to allocate 20.00 MiB. GPU 0 has a total capacity of 79.19 GiB of which 3.06 MiB "
     "is free. Of the allocated memory 3.98 GiB is allocated by PyTorch, and 25.36 MiB is reserved by PyTorch but "
     "unallocated.", True, 20 << 20),
    ("flash_attention_fwd kernel launch failed: out of memory", True, 0),
    ("flash_attention_fwd kernel launch failed: an illegal memory access was encountered", False, 0),
    ("paged_attention kernel launch failed: too many resources requested for launch", False, 0),
    ("CUDA error: unspecified launch failure", False, 0),
    ("CUDA error: an illegal memory access was encountered\nCUDA kernel errors might be asynchronously reported",
     False, 0),
]


def test_classifier_matches_the_reference_and_reads_the_card():
    for text in MESSAGES:
        exc = RuntimeError(text)
        assert md.is_oom(exc) == j_md.is_oom(exc), text
        assert vars(md.classify_oom(exc, "train_step")) == vars(j_md.classify_oom(exc, "train_step")), text
    for text, oom, nbytes in CARD_MESSAGES:
        exc = RuntimeError(text)
        assert md.is_oom(exc) == oom, text
        if oom:
            event = md.classify_oom(exc, "train_step")
            assert event.bytes_requested == nbytes and event.stage == "runtime"
    card_oom = torch.cuda.OutOfMemoryError(CARD_MESSAGES[0][0])
    assert md.is_oom(card_oom) and md.classify_oom(card_oom, "rollout_prefill").bytes_requested == 20 << 20
    abort = md.MemoryAbortError("memory doctor: ladder exhausted — RESOURCE_EXHAUSTED in phase 'train_step'")
    assert not md.is_oom(abort)


def test_config_validation_matches_the_reference():
    for bad in ({"ladder": ["remat", "shrink_pool"]}, {"ladder": ["nope"]}, {"preflight": "maybe"},
                {"pool_shrink_factor": 1.0}, {"remat_escalation": "bogus"}, {"enabld": True}):
        with pytest.raises(ValueError):
            j_md.MemoryConfig.from_dict(bad)
        with pytest.raises(ValueError):
            md.MemoryConfig.from_dict(bad)
    assert md.REMAT_STRENGTH == j_md.REMAT_STRENGTH and md.LADDER_ACTIONS == j_md.LADDER_ACTIONS
    assert vars(md.MemoryConfig.from_dict({"enabled": True})) == vars(j_md.MemoryConfig.from_dict({"enabled": True}))


@pytest.mark.parametrize("ladder", [None, ["split_microbatch", "rollback", "abort"], ["shrink_pool", "remat"]])
def test_ladder_decisions_and_records_match_the_reference(ladder):
    cfg = {"enabled": True, "max_splits": 2, "max_pool_shrinks": 2}
    if ladder:
        cfg["ladder"] = ladder
    ours, ref = md.MemoryDoctor(md.MemoryConfig.from_dict(cfg)), j_md.MemoryDoctor(j_md.MemoryConfig.from_dict(cfg))
    rng = np.random.default_rng(len(ladder or []))
    phases = ["rollout_prefill", "train_step", "fused_block", "experience"]
    for i in range(40):
        kw = dict(phase=str(rng.choice(phases)), stage=str(rng.choice(["runtime", "compile"])),
                  bytes_requested=int(rng.integers(0, 1 << 34)), detail="x")
        caps = {k: bool(rng.random() < 0.8) for k in ALL_CAPS}
        a = ours.decide(md.OOMEvent(**kw), caps)
        assert a == ref.decide(j_md.OOMEvent(**kw), caps), i
        ours.note(md.OOMEvent(**kw), a)
        ref.note(j_md.OOMEvent(**kw), a)
        if a == "remat":
            ours.note_remat("dots_saveable")
            ref.note_remat("dots_saveable")
        assert ours.degrade_state() == ref.degrade_state()
        assert ours.describe() == ref.describe() and ours.pool_scale() == ref.pool_scale()
    saved = {"pool_shrinks": 5, "accum_factor": 1, "remat_policy": "full", "rollbacks": 0,
             "events": [{"phase": "train_step", "stage": "runtime", "bytes_requested": 1, "action": "remat"}]}
    ours.restore(saved)
    ref.restore(saved)
    assert ours.degrade_state() == ref.degrade_state()
    assert md.is_degraded_record(saved) and not md.is_degraded_record({"accum_factor": 1})


def test_watermark_sampler_matches_the_reference():
    rng = np.random.default_rng(7)
    limit = 1000 << 20
    readings = [None if rng.random() < 0.05 else (int(rng.uniform(0.7, 1.0) * limit), limit) for _ in range(300)]
    cfg = {"enabled": True, "high_watermark": 0.9, "watermark_window": 3}
    samplers = []
    for mod in (md, j_md):
        feed = list(readings)
        samplers.append(mod.WatermarkSampler(mod.MemoryConfig.from_dict(cfg), stats_fn=lambda feed=feed: feed.pop(0),
                                             phase_fn=lambda: "train"))
    trips = [[], []]
    for i in range(300):
        creep = i % 50 == 17
        for s, out in zip(samplers, trips):
            if creep:
                s.inject_creep()
            s.sample()
            out.append(s.consume_trip() if i % 5 == 4 else None)
    assert trips[0] == trips[1] and any(trips[0])
    assert samplers[0].peak_stats() == samplers[1].peak_stats()
    assert samplers[0].watermark_trips == samplers[1].watermark_trips


@pytest.mark.parametrize("variant", ["default", "recipe", "engine"])
def test_analytic_plan_matches_the_reference(variant, tmp_path, capsys):
    """The config-only plan, row for row (one device: the reference's mesh
    resolves to 1), and the CLI's verdicts."""
    d = j_default_ppo_config().to_dict()
    if variant == "recipe":
        d["train"].update(grads_dtype="bfloat16", remat_policy="full", logit_chunks=4, minibatch_size=8,
                          memory={"hbm_bytes": 16 << 30})
        d["optimizer"] = {"name": "adamw_8bit_fused", "kwargs": {"lr": 1e-5}}
    elif variant == "engine":
        d["method"]["gen_engine"] = {"enabled": True, "slots": 16, "page_size": 16, "spec_decode": True,
                                     "kv_quant": "int8"}
        d["model"]["num_layers_unfrozen"] = 2
    ref = j_md.analytic_plan(JTRLConfig.from_dict(d), devices=1)
    ours = md.analytic_plan(TRLConfig.from_dict(d))
    rows = [(i.phase, i.component, i.bytes) for i in ours.items]
    assert rows == [(i.phase, i.component, i.bytes) for i in ref.items]
    got, want = ours.to_dict(), ref.to_dict()
    assert {k: v for k, v in got.items() if k != "items"} == {k: v for k, v in want.items() if k != "items"}

    import yaml

    from trlx_tpu_torch.tools import hbm_plan

    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(json.loads(json.dumps(d))))
    assert hbm_plan.main([str(path), "--hbm-gb", "64"]) == 0
    assert "VERDICT: fits" in capsys.readouterr().out
    assert hbm_plan.main([str(path), "--hbm-gb", "0.001", "--json"]) == 1
    assert json.loads(capsys.readouterr().out)["over_budget"]


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------


def _ladder_config(tmp_path):
    """PPO at batch 16 (a split to 8 stays divisible by the reference's 8
    virtual devices), two cycles of 2 steps, rollouts through the decode
    engine (4 slots); `oom_prefill` strikes the first generate() call and
    `oom_fused_block` the second train step."""
    return ppo_parity.config(
        tmp_path,
        train=dict(batch_size=16, total_steps=4, epochs=2, memory=dict(enabled=True),
                   chaos=dict(faults=[dict(fault="oom_prefill", at=1), dict(fault="oom_fused_block", at=2)])),
        method=dict(gen_engine=dict(enabled=True, slots=4, page_size=8)),
    )


def test_chaos_ooms_walk_shrink_pool_and_split_as_the_reference(tmp_path):
    ref, init, j_stats = ppo_parity.run_reference(_ladder_config(tmp_path / "ref"))
    ours = ppo_parity.run_port(_ladder_config(tmp_path / "port"), init)
    assert ours.iter_count == ref.iter_count == 4
    rec, j_rec = ours.memdoctor.degrade_state(), ref.memdoctor.degrade_state()
    assert rec == j_rec
    assert [e["action"] for e in rec["events"]] == ["shrink_pool", "split_microbatch"]
    assert ours.num_mb == ref.num_mb == 2 and ours.mb_size == 8
    assert ours._engine_spec(8).slots == ref._engine_spec(8).slots == 2
    assert ours.guardrails.trip_history == ref.guardrails.trip_history == []  # the guardrails are off
    assert ours.chaos.fired == ref.chaos.fired
    np.testing.assert_allclose([v for _, v in ppo_parity.losses(ours.stats_history)],
                               [v for _, v in ppo_parity.losses(j_stats)], rtol=1e-4, atol=0)
    assert [s for s, _ in ppo_parity.losses(ours.stats_history)] == [s for s, _ in ppo_parity.losses(j_stats)]
    ppo_parity.assert_store_matches(ours, ref)


def _built(package, config, monkeypatch):
    """The trainer `train()` builds, without training (learn captured)."""
    box = {}
    if package == "ref":
        monkeypatch.setattr(JBaseTrainer, "learn", lambda self: box.setdefault("t", self))
        trlx_tpu.train(reward_fn=ppo_parity.reward_fn, prompts=ppo_parity.PROMPTS, config=config)
    else:
        monkeypatch.setattr(trainer_base.TPUBaseTrainer, "learn", lambda self: box.setdefault("t", self))
        trlx_tpu_torch.train(reward_fn=ppo_parity.reward_fn, prompts=ppo_parity.PROMPTS,
                             config=TRLConfig.from_dict(config.to_dict()), device="cpu")
    monkeypatch.undo()
    return box["t"]


def test_preflight_plan_matches_the_reference_and_rejects_before_rollout(tmp_path, monkeypatch):
    """With every layer trainable (the reference keeps moments of frozen
    leaves too, the port holds none), the state rows (params, optimizer
    moments, the frozen full copy, the gradient tree) equal the reference's
    tree bytes exactly, the reference's optimizer counters aside (0-dim
    int32 leaves; torch keeps its step counters on the host); the analytic
    rows equal the
    reference's at its 8-way row split times 8. Then a budget below the
    plan: both packages raise MemoryPlanError from learn() before any
    rollout is generated."""
    cfg = ppo_parity.config(tmp_path, train=dict(batch_size=16, memory=dict(enabled=True)),
                            model=dict(num_layers_unfrozen=-1))
    ref = _built("ref", cfg, monkeypatch)
    ours = _built("port", cfg, monkeypatch)
    want, got = j_md.estimate_plan(ref), md.estimate_plan(ours)
    scalars = sum(np.asarray(x).nbytes for x in jax.tree_util.tree_leaves(ref.opt_state) if np.ndim(x) == 0)

    def row(plan, name):
        return sum(i.bytes for i in plan.items if i.component == name)

    assert row(got, "params") == row(want, "params") > 0
    assert row(got, "opt_state") == row(want, "opt_state") - scalars > 0
    assert row(got, "ref_params") == row(want, "ref_params") > 0
    assert row(got, "grads") == row(want, "grads") == sum(p.numel() * 4 for p in ours.trainable_params)
    ways = ref.data_ways()
    for name in ("activations", "logits", "epoch_batch", "experience_fwd"):
        assert row(got, name) == row(want, name) * ways > 0, name
    assert row(got, "static_kv_cache") == row(want, "static_kv_cache") > 0

    tiny = cfg.evolve(train=dict(memory=dict(enabled=True, hbm_bytes=1 << 20)))
    for package in ("ref", "port"):
        calls = []
        cls = JBaseTrainer if package == "ref" else trainer_base.TPUBaseTrainer
        generate = cls.generate
        monkeypatch.setattr(cls, "generate", lambda self, *a, **k: calls.append(1) or generate(self, *a, **k))
        with pytest.raises((j_md.MemoryPlanError, md.MemoryPlanError), match="preflight REJECTED"):
            if package == "ref":
                trlx_tpu.train(reward_fn=ppo_parity.reward_fn, prompts=ppo_parity.PROMPTS, config=tiny)
            else:
                trlx_tpu_torch.train(reward_fn=ppo_parity.reward_fn, prompts=ppo_parity.PROMPTS,
                                     config=TRLConfig.from_dict(tiny.to_dict()), device="cpu")
        assert calls == [], package
        monkeypatch.undo()


def test_degraded_checkpoint_resumes_degraded(tmp_path, monkeypatch):
    """As `tests/test_memdoctor.py::test_degraded_resume_adopts_failsloud_
    and_accepts`: a checkpoint saved after a split and a remat escalation
    carries the reference's `memory_degrade` record; a doctor-enabled
    trainer resumes it degraded, a doctor-disabled one refuses it, one
    with `accept_undegrade` takes it at the original sizes; a rollback
    onto an older, undegraded checkpoint keeps the live degradation."""
    def build(name, memory):
        cfg = ppo_parity.config(tmp_path / name, train=dict(batch_size=16, memory=memory))
        return _built("port", cfg, monkeypatch)

    event = dict(phase="train_step", stage="runtime", bytes_requested=8 << 30, detail="x")
    tr = build("a", dict(enabled=True))
    clean = str(tmp_path / "clean")
    tr.save(clean)
    tr.memdoctor.note(md.OOMEvent(**event), "split_microbatch")
    tr._apply_accum_factor()
    tr._escalate_remat("dots_saveable")
    degraded = str(tmp_path / "degraded")
    tr.save(degraded)
    ref_doctor = j_md.MemoryDoctor(j_md.MemoryConfig.from_dict(dict(enabled=True)))
    ref_doctor.note(j_md.OOMEvent(**event), "split_microbatch")
    ref_doctor.note_remat("dots_saveable")
    with open(f"{degraded}/state.json") as f:
        assert json.load(f)["memory_degrade"] == ref_doctor.degrade_state()

    tr2 = build("b", dict(enabled=True))
    tr2.load(degraded)
    assert tr2.memdoctor.accum_factor == 2 and tr2.num_mb == 2 and tr2.mb_size == 8
    assert tr2.config.train.remat_policy == "dots_saveable" and tr2.model.base.remat == "dots_saveable"
    with pytest.raises(ValueError, match="DEGRADED"):
        build("c", {}).load(degraded)
    tr4 = build("d", dict(accept_undegrade=True))
    tr4.load(degraded)
    assert tr4.num_mb == 1 and not tr4.memdoctor.degraded
    tr2.load(clean)  # the rollback path: an older state.json
    assert tr2.memdoctor.accum_factor == 2 and tr2.num_mb == 2
