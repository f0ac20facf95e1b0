"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: `device` when given, else the
    current CUDA card. With no card and no explicit device this raises —
    the port never carries on quietly on the CPU; callers that mean the
    CPU (the parity tests) say `device="cpu"`."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())
