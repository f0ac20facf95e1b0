"""The port's host-side checkpointing (`trlx_tpu_torch.utils.checkpointing`,
`.resilient`) against the JAX package's (`trlx_tpu.utils.checkpointing`,
`.resilient`), on the CPU.

Each scenario is one sequence of commits, torn directories, failed
writes, retention, integrity manifests, corruption, quarantine and
fallback (those of `tests/test_fault_tolerance.py` and
`tests/test_elastic.py`), run once through each package's
`CheckpointManager` under its own root. What each step observes (the
root's listing with quarantine suffixes normalised, `latest_committed`
and `latest_resumable`, the manifests, the verification verdicts, the
raised errors) must be the same list in both. Then the retry, backoff,
breaker, preemption and `ElasticConfig` / `check_cursor_invariants` units,
each against its reference counterpart."""

import json
import os
import random
import re
import signal

import pytest

from trlx_tpu.utils import checkpointing as j_ckpt
from trlx_tpu.utils import resilient as j_resilient

from trlx_tpu_torch.utils import checkpointing as t_ckpt
from trlx_tpu_torch.utils import resilient as t_resilient


def _write_files(files):
    def write(tmp):
        for rel, data in files.items():
            fp = os.path.join(tmp, rel)
            os.makedirs(os.path.dirname(fp), exist_ok=True)
            with open(fp, "wb") as f:
                f.write(data)

    return write


def _state(step):
    return {"state.json": json.dumps({"iter_count": step}).encode()}


def _full(step):
    return dict(_state(step), **{"state/model.pt": b"w" * (64 + step)})


def _flip(fp):
    with open(fp, "r+b") as f:
        f.seek(os.path.getsize(fp) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0x01]))


class Recorder:
    """Runs a scenario against one package's module, recording what each
    step observes, relative to the root."""

    def __init__(self, mod, root):
        self.m, self.root, self.log = mod, root, []

    def rel(self, path):
        return None if path is None else os.path.relpath(path, self.root)

    def listing(self):
        names = [re.sub(r"\.corrupt\.[0-9a-f]{8}$", ".corrupt.X", n) for n in os.listdir(self.root)]
        return sorted(names)

    def see(self, tag, mgr):
        self.log.append((tag, self.listing(), self.rel(mgr.latest_committed()), self.rel(mgr.latest_resumable()),
                         [(s, self.rel(p)) for s, p in mgr.step_checkpoints()]))

    def note(self, tag, value):
        self.log.append((tag, value))


def _scenario_commit_and_discovery(r):
    m = r.m
    mgr = m.CheckpointManager(r.root)
    r.see("empty", mgr)
    path = mgr.commit("checkpoint_2", _write_files(_state(2)))
    r.note("committed", m.is_committed(path))
    r.see("one", mgr)
    with pytest.raises(RuntimeError, match="boom"):
        mgr.commit("checkpoint_4", lambda tmp: (_ for _ in ()).throw(RuntimeError("boom")))
    r.see("failed write", mgr)
    mgr.commit("checkpoint_4", _write_files(_state(4)))
    os.makedirs(os.path.join(r.root, "checkpoint_9"))  # torn: no marker
    r.see("torn newest", mgr)
    mgr.commit("checkpoint_10", _write_files(_state(10)))  # numeric, not lexical
    r.see("ten", mgr)


def _scenario_recommit_same_name(r):
    mgr = r.m.CheckpointManager(r.root)
    mgr.commit("best_checkpoint", _write_files({"v.txt": b"one"}))
    path = mgr.commit("best_checkpoint", _write_files({"v.txt": b"two"}))
    r.note("content", open(os.path.join(path, "v.txt")).read())
    r.see("recommitted", mgr)


def _scenario_resumable_skips_deploy_only(r):
    mgr = r.m.CheckpointManager(r.root)
    mgr.commit("checkpoint_2", _write_files(_full(2)))
    mgr.commit("checkpoint_4", _write_files(_state(4)))  # no state/
    r.see("deploy-only newest", mgr)


def _scenario_retention(r):
    mgr = r.m.CheckpointManager(r.root, keep_last_n=2)
    mgr.commit("best_checkpoint", _write_files(_state(0)))
    for step in (1, 2, 3, 4):
        mgr.commit(f"checkpoint_{step}", _write_files(_full(step)))
        r.see(f"step {step}", mgr)
    os.makedirs(os.path.join(r.root, "emergency_checkpoint_7"))
    mgr.commit("checkpoint_5", _write_files(_full(5)))
    r.see("emergency kept", mgr)


def _scenario_integrity_manifest(r):
    m = r.m
    mgr = m.CheckpointManager(r.root)
    path = mgr.commit("checkpoint_2", _write_files({"state/shard0": b"abc" * 100, "state.json": b'{"iter_count": 2}',
                                                     "hf_model/w.pt": b"x" * 10}))
    with open(os.path.join(path, m.INTEGRITY_MANIFEST)) as f:
        r.note("manifest", json.load(f))
    r.note("fresh", m.verify_integrity(path))
    _flip(os.path.join(path, "state", "shard0"))
    r.note("flipped", m.verify_integrity(path))
    r.note("flipped, load scope", m.verify_integrity(path, scope=m.LOAD_SCOPE))
    os.unlink(os.path.join(path, "hf_model", "w.pt"))
    r.note("export gone, load scope", m.verify_integrity(path, scope=m.LOAD_SCOPE)[0])
    os.unlink(os.path.join(path, "state.json"))
    r.note("deleted", m.verify_integrity(path))


def _scenario_integrity_opt_out(r):
    m = r.m
    mgr = m.CheckpointManager(r.root, integrity=False)
    path = mgr.commit("checkpoint_1", _write_files({"state.json": b"{}"}))
    r.note("no manifest", (os.path.exists(os.path.join(path, m.INTEGRITY_MANIFEST)), m.verify_integrity(path)))
    m.write_integrity_manifest(path)
    r.note("backfilled", m.verify_integrity(path))
    r.note("computed", m.compute_integrity_manifest(path))


def _scenario_quarantine(r):
    m = r.m
    mgr = m.CheckpointManager(r.root)
    path = mgr.commit("checkpoint_3", _write_files({"state.json": b"{}"}))
    moved = m.quarantine(path)
    r.note("moved", (r.rel(moved), os.path.isfile(os.path.join(moved, "state.json"))))
    r.see("quarantined", mgr)
    moved2 = m.quarantine(mgr.commit("checkpoint_3", _write_files({"state.json": b"{}"})))
    r.note("second", (moved2 != moved, os.path.isdir(moved2)))
    r.see("two quarantined", mgr)


def _scenario_quarantine_fallback(r):
    """verify_or_quarantine on the auto-resume path: the corrupt newest is
    renamed and discovery falls back a step; a pinned path raises without
    the rename."""
    m = r.m
    mgr = m.CheckpointManager(r.root)
    for step in (1, 2, 3):
        mgr.commit(f"checkpoint_{step}", _write_files(_full(step)))
    _flip(os.path.join(r.root, "checkpoint_3", "state", "model.pt"))
    _flip(os.path.join(r.root, "checkpoint_2", "state.json"))
    pinned = os.path.join(r.root, "checkpoint_2")
    with pytest.raises(m.CheckpointCorruptError) as err:
        m.verify_or_quarantine(pinned, do_quarantine=False)
    r.note("pinned", (err.value.problems, os.path.isdir(pinned)))
    seen = []
    while True:
        path = mgr.latest_resumable()
        try:
            m.verify_or_quarantine(path)
            break
        except m.CheckpointCorruptError as e:
            seen.append((r.rel(e.directory), len(e.problems)))
    r.note("fell back past", seen)
    r.see("after fallback", mgr)


SCENARIOS = {f.__name__[len("_scenario_"):]: f for f in (
    _scenario_commit_and_discovery, _scenario_recommit_same_name, _scenario_resumable_skips_deploy_only,
    _scenario_retention, _scenario_integrity_manifest, _scenario_integrity_opt_out, _scenario_quarantine,
    _scenario_quarantine_fallback,
)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_manager_scenario_matches_reference(tmp_path, name):
    logs = []
    for mod, sub in ((j_ckpt, "jax"), (t_ckpt, "port")):
        rec = Recorder(mod, str(tmp_path / sub))
        os.makedirs(rec.root)
        SCENARIOS[name](rec)
        logs.append(rec.log)
    assert logs[1] == logs[0]
    # and no stale in-flight directory survives a successful commit
    leftovers = [e for e in os.listdir(tmp_path / "port") if e.startswith("tmp_")]
    assert not leftovers


def test_constants_and_cursor_invariants_match_reference():
    for name in ("COMMIT_MARKER", "INTEGRITY_MANIFEST", "TOPOLOGY_MANIFEST", "QUARANTINE_SUFFIX", "EMERGENCY_PREFIX",
                 "LOAD_SCOPE"):
        assert getattr(t_ckpt, name) == getattr(j_ckpt, name), name
    states = [
        {"iter_count": 3, "prompt_batches_consumed": 2, "prompt_stream": "global-chunks-v1"},
        {"exp_queue": {"cursor": 3, "epoch": 0}, "prompt_batches_consumed": 2},
        {"exp_queue": {"cursor": -1}},
        {"memory_degrade": {"pool_shrinks": 1, "accum_factor": 3}},
        {"memory_degrade": [1]},
        {"exp_queue": {"cursor": 1, "policy_version": 9}, "fleet": {"broadcast_version": 2, "membership_epoch": 0}},
    ]
    for state in states:
        assert t_ckpt.check_cursor_invariants(state) == j_ckpt.check_cursor_invariants(state), state


def test_elastic_config_matches_reference():
    for d in (None, {}, {"integrity": False}, {"verify_integrity": False, "allow_topology_change": False}):
        assert vars(t_ckpt.ElasticConfig.from_dict(d)) == vars(j_ckpt.ElasticConfig.from_dict(d))
    with pytest.raises(ValueError, match="unknown keys"):
        t_ckpt.ElasticConfig.from_dict({"integrity": True, "bogus": 1})


def test_backoff_and_retry_match_reference():
    """The same delays from the same jitter stream; the same attempts,
    sleeps and final raise."""
    for attempt in range(6):
        for base, cap, jitter in ((0.5, 8.0, 0.25), (0.01, 0.05, 0.0), (2.0, 8.0, 0.5)):
            want = j_resilient.compute_backoff(attempt, base, cap, jitter, random.Random(attempt))
            assert t_resilient.compute_backoff(attempt, base, cap, jitter, random.Random(attempt)) == want

    def run(mod, fails, retries):
        calls, sleeps = [], []

        def flaky(x, scale=1):
            calls.append(x)
            if len(calls) <= fails:
                raise ConnectionError("transient")
            return x * scale

        try:
            out = mod.retry_call(flaky, 3, scale=2, retries=retries, base_delay=0.1, sleep=sleeps.append,
                                 rng=random.Random(7))
        except ConnectionError:
            out = "raised"
        return out, calls, sleeps

    for fails, retries in ((0, 3), (2, 3), (3, 2), (5, 3)):
        assert run(t_resilient, fails, retries) == run(j_resilient, fails, retries)
    # the old name in the checkpointing module delegates
    assert t_ckpt.retry_call(lambda: "ok", retries=0) == "ok"


def test_circuit_breaker_matches_reference():
    script = ["f", "f", "allow", "f", "allow", "tick", "allow", "f", "allow", "tick", "allow", "s", "allow", "f"]

    def run(mod):
        now = [0.0]
        br = mod.CircuitBreaker(failure_threshold=3, reset_timeout=5.0, clock=lambda: now[0])
        out = []
        for op in script:
            if op == "f":
                br.record_failure()
            elif op == "s":
                br.record_success()
            elif op == "tick":
                now[0] += 5.0
            else:
                out.append(br.allow())
            out.append((br.state, br.is_closed))
        return out

    assert run(t_resilient) == run(j_resilient)
    with pytest.raises(ValueError):
        t_resilient.CircuitBreaker(failure_threshold=0)


def test_preemption_handler_sigterm():
    handler = t_ckpt.PreemptionHandler().install()
    previous = signal.getsignal(signal.SIGTERM)
    try:
        assert not handler.requested()
        os.kill(os.getpid(), signal.SIGTERM)
        assert handler.requested()
    finally:
        handler.uninstall()
    assert signal.getsignal(signal.SIGTERM) is not previous  # the handler's own went
    handler.install()  # a re-install clears the stale flag
    try:
        assert not handler.requested()
    finally:
        handler.uninstall()
