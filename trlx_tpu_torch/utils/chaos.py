"""Chaos-injection harness: deterministic, seed-driven fault schedules
(port of trlx_tpu.utils.chaos).

A chaos config (``train.chaos``) injects failure modes at deterministic
points, so a run under chaos is a reproducible test of the guardrails and
the memory doctor. Each fault site has its own consult counter; the
trainer consults at fixed points, so a schedule entry pins a fault to an
exact cycle or call.

Sites the port consumes (see the reference's docstring for each one):

  nan_loss        poison one optimizer step's batch (once a step).
  sigterm         SIGTERM to this process right after a train step.
  nan_reward      the reward function's outputs replaced by NaN (once a
                  reward call).
  ckpt_fail       ChaosFault from the checkpoint write (once a commit).
  ckpt_corrupt    one bit of a committed shard flipped after the commit.
  oom_fused_block a simulated allocation failure right before a train
                  step dispatches (once a dispatch attempt).
  oom_prefill     the same at the top of a rollout generate() call.
  hbm_creep       the watermark sampler's next readings saturate the
                  high watermark (once an optimization step).

Every other site of `FAULT_SITES` belongs to a part of the reference the
port has not reached: arming one raises NotImplementedError naming its
ROADMAP item (`UNPORTED_SITES`), so an armed fault never passes
silently.

Schedule entries select by count: ``{"fault": "nan_loss", "at": 2}``
fires on the 2nd consult (1-based), ``{"fault": ..., "at": 2, "span": 3}``
on consults 2..4, ``{"fault": ..., "every": 5}`` on every 5th, and
``{"fault": ..., "p": 0.1}`` draws from a ``random.Random`` stream per
site, keyed by the site's index in `FAULT_SITES`.
"""

from __future__ import annotations

import os
import random
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


class ChaosOOM(RuntimeError):
    """A simulated allocation failure (the ``oom_*`` sites). Not a
    ChaosFault: the reward retries must never swallow an allocation
    failure; only the memory doctor's ladder handles these."""


# the order keys each site's RNG stream (tests/golden/chaos_sites.json):
# sites are appended, never inserted
FAULT_SITES = (
    "nan_loss",
    "sigterm",
    "nan_reward",
    "reward_timeout",
    "reward_error",
    "ckpt_fail",
    "ckpt_corrupt",
    "host_divergence",
    "stall_rollout",
    "stall_reward",
    "stall_collective",
    "worker_death_mid_lease",
    "duplicate_delivery",
    "stale_flood",
    "queue_wedge",
    "fleet_worker_death",
    "fleet_partition",
    "broadcast_corrupt",
    "oom_fused_block",
    "oom_prefill",
    "hbm_creep",
    "serve_request_timeout",
    "serve_lane_starvation",
    "serve_transport_drop",
    "net_drop",
    "net_partition",
    "hub_crash",
    "broadcast_torn_fetch",
)

_WATCHDOG = "ROADMAP queue 1, item [10]: the hang doctor (utils/watchdog.py)"
_RESILIENT = "ROADMAP queue 1, item [10]: the resilient reward I/O (train.resilient_io)"
_TRANSPORT = "ROADMAP queue 1, item [11]: the experience transport, fleet and serving tier"
# site -> the ROADMAP item whose consumer the port has not ported
UNPORTED_SITES = {
    "reward_timeout": _RESILIENT,
    "reward_error": _RESILIENT,
    "host_divergence": "ROADMAP queue 1, item [12]: the cross-host consistency check",
    "stall_rollout": _WATCHDOG,
    "stall_reward": _WATCHDOG,
    "stall_collective": _WATCHDOG,
    **{s: _TRANSPORT for s in FAULT_SITES[11:18] + FAULT_SITES[21:]},
}


@dataclass
class _Entry:
    fault: str
    at: Optional[int] = None
    span: int = 1
    every: Optional[int] = None
    p: Optional[float] = None

    def matches(self, count: int, rng: random.Random) -> bool:
        # the p draw comes first and on every consult, so the stream's
        # position depends only on the consult order
        p_hit = self.p is not None and rng.random() < self.p
        if self.at is not None and self.at <= count < self.at + self.span:
            return True
        if self.every is not None and count % self.every == 0:
            return True
        return p_hit


class ChaosMonkey:
    """Evaluates a fault schedule against per-site consult counters."""

    def __init__(self, config: Optional[Dict[str, Any]]):
        config = dict(config or {})
        known = {"seed", "faults", "reward_delay", "stall_delay"}
        unknown = set(config) - known
        if unknown:
            raise ValueError(f"train.chaos: unknown keys {sorted(unknown)} (known: {sorted(known)})")
        # reward_delay and stall_delay belong to the unported sites
        self.seed = int(config.get("seed", 0))
        self._entries: Dict[str, List[_Entry]] = {s: [] for s in FAULT_SITES}
        self._counts: Dict[str, int] = {s: 0 for s in FAULT_SITES}
        # one stream a site, from the master seed, so an entry for one site
        # cannot shift another's draws
        self._rngs: Dict[str, random.Random] = {
            s: random.Random(self.seed * 1_000_003 + i) for i, s in enumerate(FAULT_SITES)
        }
        self.fired: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        for raw in config.get("faults", []):
            raw = dict(raw)
            fault = raw.pop("fault", None)
            if fault not in FAULT_SITES:
                raise ValueError(f"train.chaos.faults: unknown fault {fault!r} (choose from {list(FAULT_SITES)})")
            if fault in UNPORTED_SITES:
                raise NotImplementedError(
                    f"train.chaos fault {fault!r}: its consumer is not ported yet ({UNPORTED_SITES[fault]})")
            bad = set(raw) - {"at", "span", "every", "p"}
            if bad:
                raise ValueError(f"train.chaos.faults[{fault}]: unknown keys {sorted(bad)}")
            entry = _Entry(fault=fault, **raw)
            if entry.at is None and entry.every is None and entry.p is None:
                raise ValueError(f"train.chaos.faults[{fault}]: one of at/every/p required")
            self._entries[fault].append(entry)

    def consult(self, site: str) -> bool:
        """Advance `site`'s counter and report whether a fault fires here.
        Callers consult at fixed control-flow points."""
        with self._lock:
            self._counts[site] += 1
            count = self._counts[site]
            rng = self._rngs[site]
            # every entry evaluated: each probabilistic entry's stream
            # advances exactly once a consult
            hit = any([e.matches(count, rng) for e in self._entries[site]])
            if hit:
                self.fired.append({"fault": site, "count": count})
        if hit:
            logger.warning("chaos: injecting %s (consult #%d)", site, count)
        return hit

    def counts(self) -> Dict[str, int]:
        return dict(self._counts)

    def oom(self, site: str) -> None:
        """The ``oom_*`` sites: consult, and on a hit raise ChaosOOM, whose
        message carries an allocator-style byte count the memory doctor's
        classifier parses as it parses the caching allocator's. Raised
        before the dispatch, so a degrade-then-retry is sound."""
        if self.consult(site):
            raise ChaosOOM(f"RESOURCE_EXHAUSTED: chaos: out of memory while trying to allocate 8.00GiB ({site})")

    def corrupt_checkpoint(self, directory: str) -> Optional[str]:
        """``ckpt_corrupt``: flip one bit in the middle of the first (sorted)
        non-empty file under the committed checkpoint's ``state/`` tree.
        Returns the path flipped (None when nothing qualified)."""
        state_dir = os.path.join(directory, "state")
        root = state_dir if os.path.isdir(state_dir) else directory
        victims = []
        for r, _d, names in os.walk(root):
            for name in sorted(names):
                fp = os.path.join(r, name)
                if os.path.getsize(fp) > 0:
                    victims.append(fp)
        if not victims:
            return None
        victim = sorted(victims)[0]
        size = os.path.getsize(victim)
        with open(victim, "r+b") as f:
            f.seek(size // 2)
            byte = f.read(1)
            f.seek(size // 2)
            f.write(bytes([byte[0] ^ 0x01]))
        logger.warning("chaos: bit-flipped committed shard %s", victim)
        return victim

    def reward_fault_post(self, out):
        """Consulted with the reward call's result: NaNs for ``nan_reward``,
        else the result as it was."""
        if self.consult("nan_reward"):
            try:
                n = len(out)
            except TypeError:
                n = 1
            return [float("nan")] * n
        return out


def poison_batch(batch):
    """``nan_loss``: a poisoned copy of a batch (the source tensors stay
    clean, so the burst ends when the schedule says). Float tensors become
    NaN. A batch with no float tensor (SFT's, DPO's token batches) cannot
    carry a NaN, and an out-of-range id (the reference's way, which XLA's
    gather fills with NaN) is an error in torch: its copy is marked
    `nan_poisoned`, and the train step then adds NaN to each microbatch's
    loss before the backward. Either way the loss and the gradients come
    out non-finite in the graph, so the step's skip guard is exercised."""
    fields = [v for v in vars(batch).values() if isinstance(v, torch.Tensor)]
    if any(v.is_floating_point() for v in fields):
        return batch.map(lambda x: torch.full_like(x, float("nan")) if x.is_floating_point() else x)
    poisoned = batch.map(lambda x: x)
    poisoned.nan_poisoned = True
    return poisoned


def build_chaos(train_config) -> Optional[ChaosMonkey]:
    """TrainConfig -> monkey, or None when ``train.chaos`` is unset."""
    cfg = getattr(train_config, "chaos", None)
    if not cfg:
        return None
    monkey = ChaosMonkey(cfg)
    logger.warning("chaos harness ARMED (seed=%d): %s", monkey.seed,
                   [e.__dict__ for site in monkey._entries.values() for e in site])
    return monkey
