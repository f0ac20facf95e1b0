"""Run guardrails: a divergence watchdog with an escalation ladder (port of
trlx_tpu.utils.guardrails; pure host-side bookkeeping, as there).

The monitor watches the health signals the trainers produce (the step's
loss, the KL controller's current vs target KL, rollout reward moments,
the grad norm, per-cycle wall time) against rolling-window baselines,
and on a trip walks a configurable escalation ladder:

  log      -> warn and continue (transient blip)
  requeue  -> discard the poisoned rollout batch and replay its prompts
  lr_cut   -> multiply the learning-rate schedule by ``lr_cut_factor``
  rollback -> restore the last good checkpoint, then re-arm with a
              cooldown so it cannot rollback-loop
  abort    -> RuntimeError; a relaunch resumes from the last good
              checkpoint

Each consecutive unhealthy cycle escalates one rung; healthy cycles
de-escalate (after ``recover_after`` of them the ladder resets). The
monitor also gates checkpoint commits (:meth:`GuardrailMonitor.commit_ok`)
so a bad step can never become the "last good checkpoint" that rollback
restores. trainer/base.py executes the actions.

Trip signals: ``loss`` / ``grad_norm`` / ``cycle_time`` (observe_train),
``kl`` / ``reward`` / ``truncation`` (observe_rollout), and the kinds
recorded via :meth:`GuardrailMonitor.trip`: ``memory``
(:data:`MEMORY_SIGNAL`, the memory doctor's watermark and its classified
OOMs), ``peer``, ``staleness``, ``stall`` and ``fleet`` (their detectors,
the hang doctor, the experience transport and the rollout fleet, are not
ported yet; the constants keep the reference's names).
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

LADDER_ACTIONS = ("log", "requeue", "lr_cut", "rollback", "abort")

# the hang doctor's trip kind (utils/watchdog.py): a phase went silent
# past its heartbeat deadline. Soft detections (cross-host straggler
# report) escalate the ladder like any other signal; hard detections
# (frozen loop) record it here and then abort with the stalled exit
# class — either way the trip history names the stall.
STALL_SIGNAL = "stall"

# the experience transport's trip kind (trlx_tpu/exp/): a delivered
# chunk's staleness (policy-version-at-consumption minus
# version-at-generation) exceeded ``exp.staleness.max_staleness``. In
# ``reject`` mode the chunk was dropped and re-dispatched; in ``clip``
# mode it trains under IMPACT-style clipped importance weights — either
# way the trip walks this ladder, because sustained over-staleness
# means the rollout fleet is falling behind the learner.
STALENESS_SIGNAL = "staleness"

# the rollout fleet's trip kind (trlx_tpu/fleet/): live workers fell
# below ``fleet.min_workers`` (evictions, quarantine, a fleet that
# never came up) and the learner DEGRADED to the in-process rollout
# path — training continues bit-equal to the fleet-less run, but the
# disaggregation the operator paid for is gone. One trip per
# healthy->degraded transition, not per chunk.
FLEET_SIGNAL = "fleet"

# the memory doctor's trip kind (utils/memdoctor.py): host-side HBM
# watermark sampling saw bytes-in-use cross ``train.memory.
# high_watermark`` for ``watermark_window`` consecutive samples —
# creeping residency (a leak, fragmentation, an unplanned allocation)
# headed for a RESOURCE_EXHAUSTED. The trip walks this ladder like any
# other health signal; an actual OOM is handled separately by the
# memory doctor's own degradation ladder (shrink pool -> split
# microbatch -> remat -> rollback -> itemized abort).
MEMORY_SIGNAL = "memory"


def _finite(x) -> bool:
    try:
        return x is not None and math.isfinite(float(x))
    except (TypeError, ValueError):
        return False


@dataclass
class GuardrailConfig:
    """Parsed ``train.guardrails`` section (plain dict in YAML).

    enabled            master switch (default off: behavior-preserving).
    window             rolling-window length for loss/wall baselines.
    min_history        observations required before spike detection arms
                       (a fresh run's first losses are their own
                       baseline — tripping on them would be noise).
    loss_spike_sigma   trip when loss > mean + sigma*std of the window
                       (0 disables; non-finite loss always trips).
    kl_factor          trip when current KL > factor * the adaptive
                       controller's target (0 disables; needs a target).
    reward_sigma       trip when a rollout's mean reward departs the
                       running moments by more than sigma running-stds
                       (0 disables; non-finite reward mean always trips).
    grad_norm_max      absolute grad-norm trip threshold (0 disables;
                       enabling also makes the train step emit
                       ``losses/grad_norm``).
    cycle_time_factor  trip when a cycle's wall time exceeds factor *
                       the rolling median (0 disables) — a stuck host /
                       degraded interconnect shows up here first.
    consistency_every  compare a cheap cross-host state fingerprint
                       (param/opt-state reductions + iter/PRNG/cursor
                       hashes, via ``multihost.consensus``) every N
                       cycles; a disagreeing host trips the ladder
                       instead of drifting until a shape error or
                       silent reward collapse (0 disables).
    consistency_atol   absolute tolerance for the fingerprint compare
                       (0 = exact; the device reductions are
                       deterministic in lockstep SPMD, so exact is the
                       sound default).
    ladder             escalation rungs, a subset of
                       ``("log","requeue","lr_cut","rollback","abort")``
                       in order; consecutive unhealthy cycles walk up.
    lr_cut_factor      multiplier applied per ``lr_cut`` action.
    cooldown_cycles    cycles after a rollback during which further
                       trips cannot trigger another rollback (or abort)
                       — the anti-rollback-loop re-arm window.
    max_rollbacks      total rollback budget for the run; exceeding it
                       escalates straight to abort.
    recover_after      consecutive healthy cycles that reset the ladder
                       (and mark the state clean for checkpoint gating).
    truncation_max     trip when the fraction of rollout rows that hit
                       max_new_tokens WITHOUT emitting EOS exceeds this
                       (0 disables). A policy collapsing into never
                       emitting EOS silently multiplies rollout cost
                       (every response runs to the cap) before any
                       reward/KL signal moves — this catches it at the
                       decode ledger instead.
    """

    enabled: bool = False
    window: int = 8
    min_history: int = 3
    loss_spike_sigma: float = 4.0
    kl_factor: float = 4.0
    reward_sigma: float = 6.0
    grad_norm_max: float = 0.0
    cycle_time_factor: float = 0.0
    consistency_every: int = 0
    consistency_atol: float = 0.0
    ladder: Tuple[str, ...] = LADDER_ACTIONS
    lr_cut_factor: float = 0.5
    cooldown_cycles: int = 3
    max_rollbacks: int = 2
    recover_after: int = 2
    truncation_max: float = 0.0

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "GuardrailConfig":
        d = dict(d or {})
        known = set(cls.__dataclass_fields__)
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"train.guardrails: unknown keys {sorted(unknown)} "
                f"(known: {sorted(known)})"
            )
        if "ladder" in d:
            ladder = tuple(d["ladder"])
            bad = [a for a in ladder if a not in LADDER_ACTIONS]
            if bad:
                raise ValueError(
                    f"train.guardrails.ladder: unknown actions {bad} "
                    f"(choose from {list(LADDER_ACTIONS)})"
                )
            order = [LADDER_ACTIONS.index(a) for a in ladder]
            if order != sorted(order) or len(set(ladder)) != len(ladder):
                raise ValueError(
                    "train.guardrails.ladder must be an ordered subset of "
                    f"{list(LADDER_ACTIONS)}, got {list(ladder)}"
                )
            d["ladder"] = ladder
        return cls(**d)


class RollingWindow:
    """Fixed-length window with mean/std/median over healthy samples."""

    def __init__(self, maxlen: int):
        self._buf: deque = deque(maxlen=max(int(maxlen), 1))

    def push(self, x: float) -> None:
        self._buf.append(float(x))

    def __len__(self) -> int:
        return len(self._buf)

    def mean(self) -> float:
        return sum(self._buf) / len(self._buf) if self._buf else 0.0

    def std(self) -> float:
        n = len(self._buf)
        if n < 2:
            return 0.0
        m = self.mean()
        return math.sqrt(sum((x - m) ** 2 for x in self._buf) / (n - 1))

    def median(self) -> float:
        if not self._buf:
            return 0.0
        s = sorted(self._buf)
        n = len(s)
        mid = n // 2
        return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


@dataclass
class Trip:
    signal: str
    detail: str


class GuardrailMonitor:
    """Accumulates health observations; decides one ladder action per
    cycle. The trainer calls ``observe_*`` as signals materialize (the
    deferred-stats flush, the rollout-stats flush) and
    :meth:`pending_action` once per cycle at a safe point, then executes
    the returned action (trainer/base.py ``_run_guardrail_ladder``)."""

    def __init__(self, config: GuardrailConfig):
        self.cfg = config
        self._loss_win = RollingWindow(config.window)
        self._wall_win = RollingWindow(config.window)
        self._trips: List[Trip] = []
        self.last_trips: List[Trip] = []
        self._observed = 0  # observations since the last decision
        self._rung = 0
        self._healthy_streak = 0
        self._dirty = False
        self._cooldown = 0
        self.rollbacks = 0
        self.actions_taken: List[str] = []
        # every trip signal ever raised, in order (tiny strings; lets
        # tests/smokes assert e.g. that a consistency divergence was
        # actually detected without scraping logs). A bounded tail is
        # persisted inside the atomic state.json commit and restored on
        # resume/rollback (trip_tail/load_trip_tail), so the flight
        # recorder's post-resume event stream doesn't start amnesiac.
        self.trip_history: List[str] = []
        # step of the last observation that tripped, for log context
        self._last_trip_step: Optional[int] = None

    @property
    def enabled(self) -> bool:
        return self.cfg.enabled

    @property
    def in_cooldown(self) -> bool:
        return self._cooldown > 0

    # -- observations ----------------------------------------------------

    # bounded tail persisted in state.json (full history stays in RAM)
    TRIP_TAIL_LIMIT = 64

    def trip_tail(self, limit: int = TRIP_TAIL_LIMIT) -> List[str]:
        return list(self.trip_history[-limit:])

    def load_trip_tail(self, tail) -> None:
        """Prepend a checkpoint's persisted trip tail: a resumed (or
        rolled-back) run keeps the pre-restart trip record instead of
        starting amnesiac. Idempotent enough for rollback (the live
        history already contains the restored tail's events when the
        rollback happened in-process — prepending duplicates nothing
        because load() only restores what save() wrote BEFORE them)."""
        if tail and not self.trip_history:
            self.trip_history[:0] = [str(s) for s in tail]

    def _trip(self, signal: str, detail: str) -> None:
        self._trips.append(Trip(signal, detail))
        self.trip_history.append(signal)

    def trip(self, signal: str, detail: str) -> None:
        """Record an externally-detected trip (e.g. the trainer's
        cross-host consistency check) so it escalates the ladder at the
        next :meth:`pending_action` alongside the built-in signals."""
        if not self.enabled:
            return
        self._observed += 1
        self._trip(signal, detail)

    def observe_train(
        self,
        step: int,
        loss: Optional[float],
        grad_norm: Optional[float] = None,
        wall: Optional[float] = None,
    ) -> None:
        """One optimizer step (unfused loop) or one fused block's mean.
        ``wall`` is the cycle wall-clock in seconds, when known."""
        if not self.enabled:
            return
        self._observed += 1
        cfg = self.cfg
        if loss is not None:
            if not _finite(loss):
                self._trip("loss", f"non-finite loss {loss} at step {step}")
                self._last_trip_step = step
            elif (
                cfg.loss_spike_sigma > 0
                and len(self._loss_win) >= cfg.min_history
                and self._loss_win.std() > 0
                and float(loss)
                > self._loss_win.mean()
                + cfg.loss_spike_sigma * self._loss_win.std()
            ):
                self._trip(
                    "loss",
                    f"loss {float(loss):.4g} spiked past "
                    f"mean+{cfg.loss_spike_sigma}σ "
                    f"({self._loss_win.mean():.4g}+"
                    f"{cfg.loss_spike_sigma}*{self._loss_win.std():.4g}) "
                    f"at step {step}",
                )
                self._last_trip_step = step
            else:
                self._loss_win.push(float(loss))
        if grad_norm is not None and cfg.grad_norm_max > 0:
            if not _finite(grad_norm) or float(grad_norm) > cfg.grad_norm_max:
                self._trip(
                    "grad_norm",
                    f"grad norm {grad_norm} exceeds "
                    f"{cfg.grad_norm_max} at step {step}",
                )
        if wall is not None and cfg.cycle_time_factor > 0:
            if (
                len(self._wall_win) >= cfg.min_history
                and float(wall)
                > cfg.cycle_time_factor * max(self._wall_win.median(), 1e-9)
            ):
                self._trip(
                    "cycle_time",
                    f"cycle wall {float(wall):.3g}s > "
                    f"{cfg.cycle_time_factor}x median "
                    f"{self._wall_win.median():.3g}s",
                )
            else:
                self._wall_win.push(float(wall))

    def observe_rollout(
        self,
        kl: Optional[float] = None,
        kl_target: Optional[float] = None,
        reward_mean: Optional[float] = None,
        running_mean: Optional[float] = None,
        running_std: Optional[float] = None,
        truncation_rate: Optional[float] = None,
    ) -> None:
        """One rollout phase's aggregate stats (PPO)."""
        if not self.enabled:
            return
        self._observed += 1
        cfg = self.cfg
        if kl is not None:
            if not _finite(kl):
                self._trip("kl", f"non-finite KL {kl}")
            elif (
                cfg.kl_factor > 0
                and kl_target is not None
                and kl_target > 0
                and float(kl) > cfg.kl_factor * float(kl_target)
            ):
                self._trip(
                    "kl",
                    f"KL {float(kl):.4g} > {cfg.kl_factor}x target "
                    f"{float(kl_target):.4g}",
                )
        if reward_mean is not None:
            if not _finite(reward_mean):
                self._trip("reward", f"non-finite reward mean {reward_mean}")
            elif (
                cfg.reward_sigma > 0
                and _finite(running_mean)
                and _finite(running_std)
                and float(running_std) > 0
                and abs(float(reward_mean) - float(running_mean))
                > cfg.reward_sigma * float(running_std)
            ):
                self._trip(
                    "reward",
                    f"reward mean {float(reward_mean):.4g} departed the "
                    f"running moments ({float(running_mean):.4g} ± "
                    f"{cfg.reward_sigma}*{float(running_std):.4g})",
                )
        if (
            truncation_rate is not None
            and cfg.truncation_max > 0
            and _finite(truncation_rate)
            and float(truncation_rate) > cfg.truncation_max
        ):
            self._trip(
                "truncation",
                f"{float(truncation_rate):.0%} of rollout rows hit "
                f"max_new_tokens without EOS (> {cfg.truncation_max:.0%}"
                ") — the policy may have stopped terminating; rollout "
                "cost is inflating to the cap",
            )

    # -- decisions -------------------------------------------------------

    @property
    def has_pending_trips(self) -> bool:
        return bool(self._trips)

    def peer_trip(self) -> None:
        """A peer host tripped this cycle while this host saw nothing:
        record a synthetic trip so every host's ladder state machine
        advances in lockstep (some signals — per-cycle wall time — are
        host-local, and the actions they trigger are collective)."""
        self._trip("peer", "a peer host tripped this cycle")

    def pending_action(self) -> Optional[str]:
        """Consume the trips accumulated since the last call and return
        the ladder action for this cycle (None = healthy). Called once
        per cycle at a point where acting is safe."""
        if not self.enabled:
            return None
        in_cooldown = self._cooldown > 0
        if in_cooldown:
            self._cooldown -= 1
        tripped, self._trips = self._trips, []
        observed, self._observed = self._observed, 0
        self.last_trips = tripped
        if not tripped:
            if observed == 0:
                # no health evidence either way (e.g. the cycle after an
                # intervention, before anything new trained): neither
                # escalate nor recover
                return None
            self._healthy_streak += 1
            if self._healthy_streak >= self.cfg.recover_after:
                if self._dirty or self._rung:
                    logger.info(
                        "guardrails: %d healthy cycles — ladder reset",
                        self._healthy_streak,
                    )
                self._rung = 0
                self._dirty = False
            return None
        self._healthy_streak = 0
        self._dirty = True
        if in_cooldown:
            # re-arm window after a rollback: escalation is CLAMPED to
            # the sub-rollback rungs (a trip streak spanning the
            # cooldown lands back on rollback afterwards, not on abort)
            # — never a rollback-loop
            sub = next(
                (i for i, a in enumerate(self.cfg.ladder)
                 if a in ("rollback", "abort")),
                len(self.cfg.ladder),
            )
            if sub:
                self._rung = min(self._rung + 1, sub)
                action = self.cfg.ladder[self._rung - 1]
            else:
                action = "log"
        else:
            self._rung = min(self._rung + 1, len(self.cfg.ladder))
            action = self.cfg.ladder[self._rung - 1]
            if action == "rollback" and self.rollbacks >= self.cfg.max_rollbacks:
                action = "abort"
        logger.warning(
            "guardrails trip (rung %d/%d%s -> %s): %s",
            self._rung, len(self.cfg.ladder),
            " [cooldown]" if in_cooldown else "", action,
            "; ".join(f"[{t.signal}] {t.detail}" for t in tripped),
        )
        self.actions_taken.append(action)
        return action

    def notify_rollback(self, restored_step: int) -> None:
        """Called by the trainer after a successful rollback: count it,
        arm the cooldown, and drop windows poisoned by the divergence."""
        self.rollbacks += 1
        self._cooldown = self.cfg.cooldown_cycles
        self._rung = 0
        self._dirty = False
        self._healthy_streak = 0
        self._loss_win = RollingWindow(self.cfg.window)
        self._wall_win = RollingWindow(self.cfg.window)
        self._trips = []
        logger.warning(
            "guardrails: rolled back to step %d (%d/%d used); cooldown "
            "armed for %d cycles", restored_step, self.rollbacks,
            self.cfg.max_rollbacks, self.cfg.cooldown_cycles,
        )

    def commit_ok(self) -> bool:
        """Gate for CheckpointManager commits: False while the run is in
        an unhealthy (or not-yet-recovered) state, so a bad step can
        never become the "last good checkpoint" — the async-metrics
        one-cycle-late NaN signal makes this gate load-bearing."""
        if not self.enabled:
            return True
        return not (self._dirty or self._trips)

    def state_summary(self) -> Dict[str, Any]:
        return {
            "rung": self._rung,
            "dirty": self._dirty,
            "cooldown": self._cooldown,
            "rollbacks": self.rollbacks,
            "healthy_streak": self._healthy_streak,
        }


def build_monitor(train_config) -> GuardrailMonitor:
    """TrainConfig -> monitor (the ``guardrails`` field is a plain dict
    so the flat config dataclass stays YAML/back-compatible)."""
    return GuardrailMonitor(
        GuardrailConfig.from_dict(getattr(train_config, "guardrails", None))
    )
