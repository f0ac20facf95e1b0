"""Learning curves in the format of the JAX package's docs/curves/: a meta
line (task, protocol, hardware, date, final_* metrics, reference_protocol)
and then one row per logged step holding the kept metric keys."""

from __future__ import annotations

import json
import os
import platform
import subprocess
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch


def hardware(device: Optional[str] = None) -> str:
    """Where a run trained: the card's name and power limit as nvidia-smi
    gives them, or the CPU and its torch threads."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type == "cuda":
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        return f"1x {res.stdout.strip().splitlines()[0]} (torch {torch.__version__})"
    return f"CPU {platform.machine()}, {torch.get_num_threads()} torch threads (torch {torch.__version__})"


def curve_rows(stats_history: Iterable[Tuple[int, Dict[str, float]]], keys: List[str]) -> List[Dict[str, Any]]:
    """One row per logged stats dict that holds a kept key (a key K also
    keeps its sweep variants K@...), in step order, each value rounded to
    four decimals as the JAX package's curves are (a float32 mean of 18 /
    20 reads 0.9 there, not 0.8999999762)."""
    rows = []
    for step, stats in stats_history:
        kept = {k: round(float(v), 4) for k, v in stats.items()
                if any(k == key or k.startswith(key + "@") for key in keys)}
        if kept:
            rows.append({"step": int(step), **kept})
    return sorted(rows, key=lambda r: r["step"])


def write_curve(path: str, rows: List[Dict[str, Any]], task: str, protocol: str, hw: str, reference: str,
                final_key: Union[str, Sequence[str]] = "metrics/optimality",
                extra_meta: Optional[Dict[str, Any]] = None) -> Dict:
    """Write the curve; the meta's final_<metric> is the last row holding
    `final_key` (one final_* for each of several keys, e.g. the sweep
    variants `metrics/optimality@beta=100`), `reference_protocol` the curve
    it is held against. Returns the meta."""
    finals = {}
    for key in [final_key] if isinstance(final_key, str) else final_key:
        values = [r[key] for r in rows if key in r]
        if not values:
            raise ValueError(f"no row holds {key!r}")
        finals["final_" + key.split("/")[-1]] = values[-1]
    meta = {"task": task, "protocol": protocol, "hardware": hw, "date": time.strftime("%Y-%m-%d"),
            **finals, "reference_protocol": reference, **(extra_meta or {})}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(json.dumps({"meta": meta}) + "\n")
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return meta
