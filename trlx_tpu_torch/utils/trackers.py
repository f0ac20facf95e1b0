"""Metric tracking (port of trlx_tpu.utils.trackers): the `Tracker` that
writes every logged stats dict to `<logging_dir>/metrics.jsonl` and to the
configured backend, and the deferred device->host stats.

`Tracker` always appends one JSON line per call (`_step`, `_time` and the
scalars) to `metrics.jsonl` under `train.logging_dir`, or
`<train.checkpoint_dir>/logs` when that is unset. `train.tracker`
"tensorboard" adds a `torch.utils.tensorboard` writer and "wandb" a wandb
run, each when its package imports; otherwise the tracker warns and keeps
the JSONL, as the reference does. One process, so it always writes.

`DeferredStats.stage()` stacks every tensor scalar of a stats dict into one float32
tensor and, on the card, starts its copy into pinned host memory on the
current stream, with a recorded CUDA event; `flush()` waits on the events
and returns `[(stats, step, meta), ...]` in stage order with every value
a host float. The rollout phase stages its stats this way, so the copy
streams under whatever the device runs next instead of costing a
blocking read at the end of the rollout.

On a CPU tensor there is nothing to copy asynchronously (and the CPU
build of torch cannot pin memory): the stacked tensor is read at the
flush as it is. The values are those of `to_scalar` (float32, then a
host float) either way.
"""

from __future__ import annotations

import json
import os
import sys
import time
from numbers import Number
from typing import Any, Callable, Dict, List, Tuple

import torch

from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


def _run_name(config) -> str:
    script = os.path.basename(getattr(sys.modules.get("__main__"), "__file__", "run") or "run")
    model = config.model.model_path.rstrip("/").split("/")[-1]
    return config.train.run_name or f"{script}/{model}/1dev"


class DeferredStats:
    """One-cycle-delayed metric staging for tensor scalars."""

    def __init__(self):
        self._pending: List[tuple] = []

    def stage(self, stats: Dict[str, Any], step: int, meta: Any = None) -> None:
        keys = list(stats)
        vals = [stats[k] for k in keys]
        dev_ix = [i for i, v in enumerate(vals) if isinstance(v, torch.Tensor)]
        stacked, event = None, None
        if dev_ix:
            stacked = torch.stack([vals[i].detach().float().reshape(()) for i in dev_ix])
            if stacked.device.type == "cuda":
                host = torch.empty(stacked.shape, dtype=stacked.dtype, pin_memory=True)
                host.copy_(stacked, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
                stacked = host
        self._pending.append((keys, vals, dev_ix, stacked, event, step, meta))

    def flush(self) -> List[Tuple[Dict[str, float], int, Any]]:
        """The staged dicts as host floats, in stage order; a second call
        returns nothing more (idempotent)."""
        out = []
        for keys, vals, dev_ix, stacked, event, step, meta in self._pending:
            if event is not None:
                event.synchronize()
            for i, f in zip(dev_ix, stacked.tolist() if dev_ix else []):
                vals[i] = f
            out.append(({k: float(v) for k, v in zip(keys, vals)}, step, meta))
        self._pending.clear()
        return out


class Tracker:
    """Sends scalar stats to the configured backend and a JSONL log."""

    def __init__(self, config):
        train = config.train
        self.backend = train.tracker
        self.run_name = _run_name(config)
        self.logging_dir = train.logging_dir or os.path.join(train.checkpoint_dir, "logs")
        self._tb = None
        self._wandb = None
        # flushers of deferred stats: close() drains them before the
        # backends go, so the last cycle's staged metrics are never dropped
        self._pending_flushes: List[Callable[[], None]] = []
        if self.backend not in (None, "jsonl", "tensorboard", "wandb"):
            raise ValueError(f"unknown tracker {self.backend!r} (tensorboard | wandb | jsonl | None)")
        os.makedirs(self.logging_dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.logging_dir, "metrics.jsonl"), "a")
        if self.backend == "tensorboard":
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=os.path.join(self.logging_dir, self.run_name.replace("/", "_")))
            except Exception as e:  # tensorboard is optional
                logger.warning("tensorboard unavailable (%s); falling back to jsonl", e)
        elif self.backend == "wandb":
            try:
                import wandb

                self._wandb = wandb.init(project=train.project_name, name=self.run_name, entity=train.entity_name,
                                         group=train.group_name, tags=train.tags, config=config.to_dict())
            except Exception as e:
                logger.warning("wandb unavailable (%s); falling back to jsonl", e)

    def log(self, stats: Dict[str, Any], step: int) -> None:
        if self._jsonl is None:  # closed
            return
        scalars = {k: float(v) for k, v in stats.items() if isinstance(v, Number)}
        self._jsonl.write(json.dumps(dict(scalars, _step=step, _time=time.time())) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(stats, step=step)

    def attach_pending(self, flush_fn: Callable[[], None]) -> None:
        """Register a callable that logs any still-staged deferred stats
        (idempotent); close() runs it before the backends go."""
        self._pending_flushes.append(flush_fn)

    def close(self) -> None:
        """Flush the staged deferred stats, then close the backends.
        Idempotent; log() on a closed tracker does nothing."""
        flushes, self._pending_flushes = self._pending_flushes, []
        for flush in flushes:
            try:
                flush()
            except Exception as e:
                logger.error("tracker.close: deferred-stats flush failed (%s); closing backends anyway", e)
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None
