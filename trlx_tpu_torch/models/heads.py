"""The 2-layer MLP heads (port of trlx_tpu.models.heads): Linear(E, 512)
-> ReLU -> Linear(512, out), computed in fp32; PPO's value head, and
ILQL's group of a V head, one or two Q heads and their target copies,
which move only by the Polyak sync."""

from __future__ import annotations

import math
from typing import List, Tuple

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


# ---------------------------------------------------------------------------
# ILQL head group
# ---------------------------------------------------------------------------


class ILQLHeads(nn.Module):
    """`q_heads` (one, or two with two_qs), `target_q_heads` (as many;
    never trained by the optimizer) and `v_head`, as the reference's
    {"q_heads": [..], "target_q_heads": [..], "v_head"} tree."""

    def __init__(self, hidden_size: int, vocab_size: int, two_qs: bool = True, device=None):
        super().__init__()
        n_qs = 2 if two_qs else 1
        self.q_heads = nn.ModuleList([Head(hidden_size, vocab_size, device=device) for _ in range(n_qs)])
        self.target_q_heads = nn.ModuleList([Head(hidden_size, vocab_size, device=device) for _ in range(n_qs)])
        self.v_head = Head(hidden_size, 1, device=device)
        self.target_q_heads.requires_grad_(False)


@torch.no_grad()
def init_ilql_heads(heads: ILQLHeads, generator: torch.Generator) -> ILQLHeads:
    """Fresh online heads from a CPU `generator` (each Q head, then the V
    head); the target heads start as copies of the online ones."""
    for q in heads.q_heads:
        init_head(q, generator)
    init_head(heads.v_head, generator)
    for q, t in zip(heads.q_heads, heads.target_q_heads):
        t.load_state_dict(q.state_dict())
    return heads


def apply_ilql_heads(
    heads: ILQLHeads,
    hidden: torch.Tensor,  # [B, T, E]
    states_ixs: torch.Tensor,  # [B, n_states]
    actions_ixs: torch.Tensor,  # [B, n_actions]
) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]:
    """(qs, target_qs, vs): the hidden rows are gathered first and the
    heads run on them alone, so the Q products are [B, n_actions, V], never
    [B, T, V]. The target heads' outputs carry no gradient."""
    from trlx_tpu_torch.ops.common import batched_index_select

    states_hs = batched_index_select(hidden, states_ixs, dim=1)
    actions_hs = batched_index_select(hidden, actions_ixs, dim=1)
    qs = [apply_head(h, actions_hs) for h in heads.q_heads]
    with torch.no_grad():
        target_qs = [apply_head(h, actions_hs) for h in heads.target_q_heads]
    vs = apply_head(heads.v_head, states_hs)
    return qs, target_qs, vs


@torch.no_grad()
def sync_target_q_heads(heads: ILQLHeads, alpha: float) -> ILQLHeads:
    """The Polyak step, in place: target <- alpha * online + (1 - alpha) *
    target, tensor by tensor in fp32."""
    for q, t in zip(heads.q_heads, heads.target_q_heads):
        for pq, pt in zip(q.parameters(), t.parameters()):
            pt.copy_(alpha * pq + (1.0 - alpha) * pt)
    return heads
