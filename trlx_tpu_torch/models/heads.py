"""The 2-layer MLP value head (port of trlx_tpu.models.heads):
Linear(E, 512) -> ReLU -> Linear(512, out), computed in fp32."""

from __future__ import annotations

import math

import torch
from torch import nn

from trlx_tpu_torch.models.transformer import QDense

HEAD_HIDDEN = 512  # fork-pinned width of the reference's make_head


class Head(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, hidden: int = HEAD_HIDDEN, device=None):
        super().__init__()
        f32 = dict(dtype=torch.float32, param_dtype=torch.float32, device=device)
        self.fc_in = QDense(in_dim, hidden, **f32)
        self.fc_out = QDense(hidden, out_dim, **f32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_head(self, x)


@torch.no_grad()
def init_head(head: Head, generator: torch.Generator) -> Head:
    """The reference's init: kernels uniform(-1, 1) / sqrt(fan_in), zero
    biases; drawn from a CPU `generator`."""
    for dense in (head.fc_in, head.fc_out):
        fan_in = dense.kernel.shape[0]
        u = torch.rand(dense.kernel.shape, generator=generator, dtype=torch.float32)
        dense.kernel.copy_((u * 2.0 - 1.0) / math.sqrt(fan_in))
        dense.bias.zero_()
    return head


def apply_head(head: Head, x: torch.Tensor) -> torch.Tensor:
    """MLP head in fp32."""
    return head.fc_out(torch.relu(head.fc_in(x.float())))
