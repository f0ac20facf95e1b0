"""Shared numeric primitives (port of the rollout-path part of
trlx_tpu.ops.common)."""

from __future__ import annotations

from typing import Optional

import torch


def masked_mean(
    xs: torch.Tensor, mask: Optional[torch.Tensor], dim=None
) -> torch.Tensor:
    if mask is None:
        return xs.mean() if dim is None else xs.mean(dim=dim)
    mask = mask.to(xs.dtype)
    if dim is None:
        return (xs * mask).sum() / torch.clamp(mask.sum(), min=1e-8)
    return (xs * mask).sum(dim=dim) / torch.clamp(mask.sum(dim=dim), min=1e-8)


def logprobs_of_labels(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """log p(label_t) in fp32 from logits [..., seq, vocab] and labels
    [..., seq]."""
    picked = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    return picked.float() - torch.logsumexp(logits.float(), dim=-1)


def topk_mask(xs: torch.Tensor, k: int) -> torch.Tensor:
    """Mask all but the top-k logits to -inf (k >= vocab is a no-op)."""
    if k <= 0 or k >= xs.shape[-1]:
        return xs
    kth = torch.topk(xs, k, dim=-1).values[..., -1:]
    return torch.where(xs < kth, torch.full_like(xs, float("-inf")), xs)
