"""Fault-tolerant checkpointing, the host-side half (port of
trlx_tpu.utils.checkpointing for one process).

  CheckpointManager   atomic commits (write to ``tmp_<name>``, fsync,
                      rename, then a ``COMMIT`` marker: a torn write is
                      never discoverable), ``latest_committed()`` /
                      ``latest_resumable()`` discovery for
                      ``resume_from_checkpoint="auto"``, and a
                      ``keep_last_n`` retention policy that always keeps
                      ``best_checkpoint``.
  PreemptionHandler   SIGTERM/SIGINT -> a flag the train loop polls once
                      per step; the loop then commits one final
                      checkpoint and exits.
  retry_call          exponential backoff (cap + jitter) around the loop's
                      two external calls, ``tracker.log`` and the reward
                      function (`trlx_tpu_torch.utils.resilient`).
  integrity manifest  per-file sha256 (``integrity.json``) written inside
                      the atomic commit; ``verify_or_quarantine`` checks
                      it before a load and quarantines a mismatching
                      checkpoint (rename to ``*.corrupt``, never delete)
                      so auto-resume falls back to the previous step.
  ElasticConfig       the parsed ``train.elastic`` section.

The device-side half (what goes into a checkpoint: the model's, the
optimizer's and the scheduler's state dicts, ``iter_count``, the random
streams and the trainers' cursors) is `TPUBaseTrainer.save` / `load`.

Left out, with the watchdog that uses them: the host-RAM shadow and the
emergency snapshot. `EMERGENCY_PREFIX` stays, so discovery and retention
skip such directories as the reference does.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
import signal
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

COMMIT_MARKER = "COMMIT"
INTEGRITY_MANIFEST = "integrity.json"
TOPOLOGY_MANIFEST = "topology.json"
QUARANTINE_SUFFIX = ".corrupt"
_TMP_PREFIX = "tmp_"
_STEP_RE = re.compile(r"^checkpoint_(\d+)$")
# the watchdog's emergency snapshots live outside the step-checkpoint
# namespace: discovery never picks one and retention never reaps one
EMERGENCY_PREFIX = "emergency_checkpoint_"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity verification. With quarantine on, the
    directory was renamed ``*.corrupt`` (never deleted), so discovery skips
    it and auto-resume falls back to the previous committed step."""

    def __init__(self, directory: str, problems: List[str]):
        self.directory = directory
        self.problems = problems
        super().__init__(
            f"checkpoint {directory} failed integrity verification "
            f"({len(problems)} problems; first: {problems[0] if problems else '?'})"
        )


@dataclasses.dataclass
class ElasticConfig:
    """The parsed ``train.elastic`` section.

    integrity              write a per-file sha256 manifest inside every
                           checkpoint commit.
    verify_integrity       verify it before `load` touches the state; a
                           mismatch quarantines the checkpoint.
    allow_topology_change  resume a checkpoint saved under another
                           topology. The port runs on one device, so the
                           topology never changes; an architecture
                           mismatch always raises.
    """

    integrity: bool = True
    verify_integrity: bool = True
    allow_topology_change: bool = True

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ElasticConfig":
        d = dict(d or {})
        unknown = set(d) - set(cls.__dataclass_fields__)
        if unknown:
            raise ValueError(f"train.elastic: unknown keys {sorted(unknown)} "
                             f"(known: {sorted(cls.__dataclass_fields__)})")
        return cls(**d)


# -- integrity manifest ------------------------------------------------

# the manifest itself and the commit marker (written after the manifest)
_MANIFEST_EXCLUDE = (INTEGRITY_MANIFEST, COMMIT_MARKER, COMMIT_MARKER + ".tmp")


def _hash_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def compute_integrity_manifest(directory: str) -> Dict[str, Any]:
    """Per-file sha256 over everything under ``directory`` (relative
    paths, sorted), the manifest and the commit marker excluded."""
    files: Dict[str, str] = {}
    directory = os.path.abspath(directory)
    for root, _dirs, names in os.walk(directory):
        for name in names:
            fp = os.path.join(root, name)
            rel = os.path.relpath(fp, directory)
            if rel not in _MANIFEST_EXCLUDE:
                files[rel] = _hash_file(fp)
    return {"format": 1, "algo": "sha256", "files": dict(sorted(files.items()))}


def write_integrity_manifest(directory: str) -> None:
    atomic_json_write(os.path.join(directory, INTEGRITY_MANIFEST), compute_integrity_manifest(directory))


# what `load` reads: the resume path verifies only these, not the
# hf_model/ export (the offline validator checks everything)
LOAD_SCOPE = ("state/", "state.json", TOPOLOGY_MANIFEST)


def verify_integrity(directory: str, scope: Optional[Tuple[str, ...]] = None) -> Tuple[str, List[str]]:
    """Check ``directory`` against its manifest: ("ok", []), ("no-manifest",
    []) or ("corrupt", problems). Files the manifest does not list are not
    checked; ``scope`` limits the check to entries equal to or under the
    given relative prefixes."""
    fp = os.path.join(directory, INTEGRITY_MANIFEST)
    if not os.path.isfile(fp):
        return "no-manifest", []
    try:
        with open(fp) as f:
            expected = json.load(f)["files"]
    except Exception as e:
        return "corrupt", [f"{fp}: manifest unreadable ({e})"]
    if scope is not None:
        expected = {rel: want for rel, want in expected.items()
                    if any(rel == p or rel.startswith(p) for p in scope)}
    problems = []
    for rel, want in expected.items():
        target = os.path.join(directory, rel)
        if not os.path.isfile(target):
            problems.append(f"{rel}: missing (manifest expects {want[:12]}…)")
            continue
        got = _hash_file(target)
        if got != want:
            problems.append(f"{rel}: sha256 mismatch (expected {want[:12]}…, got {got[:12]}…)")
    return ("corrupt" if problems else "ok"), problems


def quarantine(directory: str) -> str:
    """Rename a corrupt checkpoint to ``<dir>.corrupt`` (a unique suffix on
    collision); never deletes. Returns the new path."""
    directory = os.path.abspath(directory.rstrip(os.sep))
    target = directory + QUARANTINE_SUFFIX
    if os.path.exists(target):
        target = f"{directory}{QUARANTINE_SUFFIX}.{uuid.uuid4().hex[:8]}"
    os.rename(directory, target)
    _fsync_path(os.path.dirname(directory))
    logger.error("quarantined corrupt checkpoint: %s -> %s (kept for postmortem; discovery will skip it)",
                 directory, target)
    return target


def verify_or_quarantine(directory: str, do_quarantine: bool = True) -> None:
    """The integrity gate of `load`: verify the load-relevant files
    (`LOAD_SCOPE`), quarantine on a mismatch when asked, and raise
    `CheckpointCorruptError`. A checkpoint without a manifest passes with
    a note. ``do_quarantine=False`` (an explicitly named checkpoint) raises
    without the rename."""
    status, problems = verify_integrity(directory, scope=LOAD_SCOPE)
    if status == "no-manifest":
        logger.info("checkpoint %s has no integrity manifest; skipping verification", directory)
    elif status == "corrupt" and do_quarantine:
        quarantine(directory)
    if problems:
        raise CheckpointCorruptError(directory, problems)


def _fsync_path(path: str) -> None:
    """Best-effort fsync of a file or directory (some filesystems refuse a
    directory fsync; that narrows durability, not correctness)."""
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


def fsync_tree(directory: str) -> None:
    """fsync every file and directory under `directory`, bottom-up."""
    for root, _dirs, files in os.walk(directory, topdown=False):
        for name in files:
            _fsync_path(os.path.join(root, name))
        _fsync_path(root)


def atomic_json_write(path: str, obj) -> None:
    """JSON through a tmp file, fsync, ``os.replace`` and a parent-dir
    fsync: a crash leaves the previous file or the complete new one."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_path(os.path.dirname(path))


def check_cursor_invariants(state: Dict[str, Any]) -> List[str]:
    """Cross-field invariants of a ``state.json`` dict (problem strings;
    empty = consistent). The experience transport's consumer cursor can
    never pass ``prompt_batches_consumed``; a memory-doctor record must be
    well formed. The port writes neither section yet (ROADMAP), so its
    checkpoints pass; the check keeps one definition for both packages'
    files."""
    problems: List[str] = []
    md = state.get("memory_degrade")
    if md is not None and not isinstance(md, dict):
        problems.append(
            f"memory_degrade={md!r} is not a mapping (torn or "
            "hand-edited state.json)"
        )
    elif isinstance(md, dict):
        shrinks = md.get("pool_shrinks", 0)
        accum = md.get("accum_factor", 1)
        if not isinstance(shrinks, int) or shrinks < 0:
            problems.append(
                f"memory_degrade.pool_shrinks={shrinks!r} is not a "
                "non-negative integer"
            )
        if not isinstance(accum, int) or accum < 1 or (accum & (accum - 1)):
            problems.append(
                f"memory_degrade.accum_factor={accum!r} is not a "
                "power-of-two >= 1 (each split rung doubles it) — a "
                "resume would derive a non-divisible microbatch"
            )
    eq = state.get("exp_queue")
    if not isinstance(eq, dict):
        return problems
    cursor = eq.get("cursor")
    prompts = state.get("prompt_batches_consumed")
    if not isinstance(cursor, int) or cursor < 0:
        problems.append(
            f"exp_queue.cursor={cursor!r} is not a non-negative integer"
        )
    elif isinstance(prompts, int) and cursor > prompts:
        problems.append(
            f"exp_queue.cursor={cursor} points PAST the committed "
            f"prompt-stream position (prompt_batches_consumed="
            f"{prompts}): every consumed chunk must have pulled a "
            "prompt chunk first — this state.json is torn (its halves "
            "were written at different moments) and a resume from it "
            "would train on experience for prompts never drawn"
        )
    epoch = eq.get("epoch")
    if epoch is not None and (not isinstance(epoch, int) or epoch < 0):
        problems.append(
            f"exp_queue.epoch={epoch!r} is not a non-negative integer"
        )
    fleet = state.get("fleet")
    if isinstance(fleet, dict):
        bver = fleet.get("broadcast_version")
        pver = eq.get("policy_version")
        lag_max = max(int(fleet.get("broadcast_every", 1) or 1), 1)
        if isinstance(bver, int) and isinstance(pver, int) and bver >= 0:
            if bver > pver:
                problems.append(
                    f"fleet.broadcast_version={bver} is NEWER than the "
                    f"exp cursor's policy version ({pver}): a snapshot "
                    "cannot be published for a policy the optimizer "
                    "never produced — this state.json is torn"
                )
            elif pver - bver > lag_max:
                problems.append(
                    f"exp_queue.policy_version={pver} references a "
                    f"policy {pver - bver} versions past the committed "
                    f"broadcast snapshot (v{bver}, publish cadence "
                    f"{lag_max}): the two halves of this state.json "
                    "were written at different moments (torn commit)"
                )
        me = fleet.get("membership_epoch")
        if me is not None and (not isinstance(me, int) or me < 1):
            problems.append(
                f"fleet.membership_epoch={me!r} is not a positive "
                "integer (the learner bumps it to >= 1 on attach)"
            )
    return problems


def is_committed(directory: str) -> bool:
    """True iff `directory` is a checkpoint whose commit marker landed."""
    return os.path.isfile(os.path.join(directory, COMMIT_MARKER))


class CheckpointManager:
    """Atomic checkpoint commits, discovery and retention under one root.

    Commit protocol, crash-safe at every boundary:
      1. the writer fills ``<root>/tmp_<name>/`` (a preemption here leaves
         a ``tmp_`` directory, which discovery ignores and the next commit
         clears);
      2. the integrity manifest is written, the tree fsynced and renamed
         to ``<root>/<name>/`` (not discoverable yet: no marker);
      3. a ``COMMIT`` marker is written into it by tmp file + ``os.replace``.
    """

    def __init__(self, checkpoint_dir: str, keep_last_n: Optional[int] = None, integrity: bool = True):
        self.root = os.path.abspath(checkpoint_dir)
        self.keep_last_n = keep_last_n
        self.integrity = integrity

    def commit(self, name: str, write_fn: Callable[[str], None]) -> str:
        """Run ``write_fn(tmp_dir)``, then publish the result atomically as
        ``<root>/<name>``. Returns the final path. A failed write leaves the
        torn ``tmp_`` directory and re-raises."""
        final = os.path.join(self.root, name)
        tmp = os.path.join(self.root, _TMP_PREFIX + name)
        # sweep every stale in-flight directory (a crashed commit of a step
        # checkpoint leaves a tmp_ tree no later commit would reuse); the
        # tmp_old_* aside copies are the recoverable previous versions
        if os.path.isdir(self.root):
            for entry in os.listdir(self.root):
                if entry.startswith(_TMP_PREFIX) and not entry.startswith(_TMP_PREFIX + "old_"):
                    shutil.rmtree(os.path.join(self.root, entry), ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        write_fn(tmp)
        if self.integrity:
            write_integrity_manifest(tmp)
        fsync_tree(tmp)
        # a re-commit of the same name (best_checkpoint, a preemption right
        # after an interval save): the old copy moves aside and goes only
        # after the new marker lands
        old = None
        if os.path.isdir(final):
            old = os.path.join(self.root, f"{_TMP_PREFIX}old_{name}.{uuid.uuid4().hex[:8]}")
            os.rename(final, old)
        os.rename(tmp, final)
        _fsync_path(self.root)
        self._write_marker(final, name)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
        self._apply_retention()
        return final

    @staticmethod
    def _write_marker(directory: str, name: str) -> None:
        atomic_json_write(os.path.join(directory, COMMIT_MARKER), {"name": name, "time": time.time()})

    # -- discovery -------------------------------------------------------

    def step_checkpoints(self) -> List[Tuple[int, str]]:
        """Committed ``checkpoint_<step>`` directories as (step, path),
        ascending; uncommitted (torn) ones are skipped with a warning."""
        if not os.path.isdir(self.root):
            return []
        out = []
        for entry in sorted(os.listdir(self.root)):
            m = _STEP_RE.match(entry)
            if not m:
                continue
            path = os.path.join(self.root, entry)
            if not is_committed(path):
                logger.warning("skipping uncommitted checkpoint %s (no %s marker: likely a torn write from a "
                               "preemption mid-save)", path, COMMIT_MARKER)
                continue
            out.append((int(m.group(1)), path))
        out.sort(key=lambda t: t[0])
        return out

    def latest_committed(self) -> Optional[str]:
        """The newest committed step checkpoint, or None (fresh start)."""
        ckpts = self.step_checkpoints()
        return ckpts[-1][1] if ckpts else None

    def latest_resumable(self) -> Optional[str]:
        """The newest committed checkpoint with full training state (a
        `state/` tree); deploy-only ones (train.save_optimizer off) are
        skipped with a warning."""
        for _step, path in reversed(self.step_checkpoints()):
            if os.path.isdir(os.path.join(path, "state")):
                return path
            logger.warning("skipping %s for auto-resume: committed but has no state/ tree "
                           "(saved with save_optimizer=false?): not resumable", path)
        return None

    # -- retention -------------------------------------------------------

    def _apply_retention(self) -> None:
        """Delete committed step checkpoints beyond the newest
        ``keep_last_n``; ``best_checkpoint`` and every other name stay. The
        marker goes before the tree, so a crash mid-delete leaves an
        ignorable torn directory."""
        if not self.keep_last_n or self.keep_last_n < 1:
            return
        ckpts = self.step_checkpoints()
        for _step, path in ckpts[: max(len(ckpts) - self.keep_last_n, 0)]:
            logger.info("retention (keep_last_n=%d): removing %s", self.keep_last_n, path)
            marker = os.path.join(path, COMMIT_MARKER)
            if os.path.exists(marker):
                os.unlink(marker)
                _fsync_path(path)
            shutil.rmtree(path, ignore_errors=True)


class PreemptionHandler:
    """SIGTERM/SIGINT -> a flag the train loop polls once per step; it then
    commits one final checkpoint and exits. A second SIGINT raises
    KeyboardInterrupt, so a double Ctrl-C still kills a hung save."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self._flag = False
        self._prev: Dict[int, Any] = {}
        self._installed = False

    def _handle(self, signum, frame):
        if self._flag and signum == signal.SIGINT:
            raise KeyboardInterrupt
        self._flag = True
        logger.warning("received signal %d: finishing the current step, then saving a final checkpoint "
                       "and exiting", signum)

    def install(self) -> "PreemptionHandler":
        """Install the handlers (main thread only: elsewhere the default
        handling stays) and clear a stale flag, so that a later learn() on
        the same trainer trains."""
        self._flag = False
        if self._installed:
            return self
        try:
            for sig in self.SIGNALS:
                self._prev[sig] = signal.signal(sig, self._handle)
            self._installed = True
        except ValueError:  # not the main thread
            self._prev.clear()
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except ValueError:
                pass
        self._prev.clear()
        self._installed = False

    def requested(self) -> bool:
        return self._flag


def retry_call(fn: Callable, *args, retries: int = 3, base_delay: float = 0.5, max_delay: float = 8.0,
               description: Optional[str] = None, **kwargs):
    """`trlx_tpu_torch.utils.resilient.retry_call` under its older name:
    doubling backoff from ``base_delay`` capped at ``max_delay``, +-25%
    jitter; the final failure re-raises."""
    from trlx_tpu_torch.utils import resilient

    return resilient.retry_call(fn, *args, retries=retries, base_delay=base_delay, max_delay=max_delay,
                                description=description, **kwargs)
