"""Deferred device->host stats (port of the `DeferredStats` of
trlx_tpu.utils.trackers; the tracker backends are ROADMAP queue 4).

`stage()` stacks every tensor scalar of a stats dict into one float32
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

from typing import Any, Dict, List, Tuple

import torch


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
