"""Logging for the port (after trlx_tpu.utils.logging): one stdout handler
on the package's logger (which still propagates, so an application's own
handlers see the records too), verbosity from TRLX_TPU_VERBOSITY, and the
eval sample table. Single process, so no rank filtering."""

from __future__ import annotations

import logging
import os
import sys
import threading

_lock = threading.Lock()
_configured = False

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


def _root() -> logging.Logger:
    global _configured
    root = logging.getLogger(__name__.split(".")[0])
    with _lock:
        if not _configured:
            handler = logging.StreamHandler(sys.stdout)
            handler.setFormatter(logging.Formatter(
                "[%(levelname)s|%(name)s] %(asctime)s >> %(message)s", datefmt="%H:%M:%S"
            ))
            root.addHandler(handler)
            raw = os.environ.get("TRLX_TPU_VERBOSITY", "info").lower()
            root.setLevel(LOG_LEVELS.get(raw, logging.INFO))
            _configured = True
    return root


def get_logger(name: str) -> logging.Logger:
    _root()
    return logging.getLogger(name)


def format_table(title, columns, rows, max_cell=48):
    """Fixed-width box table for eval samples."""

    def clip(x):
        s = str(x).replace("\n", " ")
        return s if len(s) <= max_cell else s[: max_cell - 1] + "…"

    cells = [[clip(c) for c in row] for row in rows]
    widths = [
        max([len(str(col))] + [len(r[i]) for r in cells])
        for i, col in enumerate(columns)
    ]

    def line(l, m, r):
        return l + m.join("─" * (w + 2) for w in widths) + r

    def fmt(row):
        return "│" + "│".join(f" {c:<{w}} " for c, w in zip(row, widths)) + "│"

    out = [title, line("┌", "┬", "┐"), fmt([str(c) for c in columns]), line("├", "┼", "┤")]
    out += [fmt(r) for r in cells]
    out.append(line("└", "┴", "┘"))
    return "\n".join(out)
