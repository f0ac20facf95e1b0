"""Shared numeric primitives (port of trlx_tpu.ops.common): masked means,
logprobs (whole and chunked from hidden states), whitening, masked tensor
stats, running moments and stat-dict flattening.

Single-process: the reference's `axis_name` reductions (psum inside
shard_map) have no counterpart until the port grows a mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, MutableMapping, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint


def masked_mean(
    xs: torch.Tensor, mask: Optional[torch.Tensor], dim=None
) -> torch.Tensor:
    if mask is None:
        return xs.mean() if dim is None else xs.mean(dim=dim)
    mask = mask.to(xs.dtype)
    if dim is None:
        return (xs * mask).sum() / torch.clamp(mask.sum(), min=1e-8)
    return (xs * mask).sum(dim=dim) / torch.clamp(mask.sum(dim=dim), min=1e-8)


def _global_mean_var(xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Element count, mean and (biased) variance over the whole tensor."""
    count = torch.tensor(float(xs.numel()), dtype=torch.float32, device=xs.device)
    mean = xs.sum() / count
    return mean, ((xs - mean) ** 2).sum() / count, count


def whiten(xs: torch.Tensor, shift_mean: bool = True) -> torch.Tensor:
    """Normalize to zero mean / unit variance over the whole batch, with
    the UNBIASED variance (the reference's single-process path)."""
    mean, var, count = _global_mean_var(xs)
    var = var * count / torch.clamp(count - 1, min=1.0)
    whitened = (xs - mean) * torch.rsqrt(var + 1e-8)
    if not shift_mean:
        whitened = whitened + mean
    return whitened


def logprobs_of_labels(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """log p(label_t) in fp32 from logits [..., seq, vocab] and labels
    [..., seq]."""
    picked = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    return picked.float() - torch.logsumexp(logits.float(), dim=-1)


def chunked_logprobs(
    project_fn: Callable[[torch.Tensor], torch.Tensor],
    hidden: torch.Tensor,
    labels: torch.Tensor,
    n_chunks: int,
) -> torch.Tensor:
    """Per-token log p(label) from hidden states [B, T, E], never holding
    the full [B, T, vocab] logits: the sequence axis is cut into `n_chunks`
    pieces and each runs under `torch.utils.checkpoint`, so the backward
    recomputes its chunk's logits (the reference's `jax.checkpoint` over a
    `scan`). fp32 logprobs with the shape of `labels`."""
    T = labels.shape[1]
    ck = -(-T // n_chunks)

    def piece(h, lab):
        return logprobs_of_labels(project_fn(h), lab)

    out = [
        checkpoint(piece, hidden[:, i:i + ck], labels[:, i:i + ck], use_reentrant=False)
        for i in range(0, T, ck)
    ]
    return torch.cat(out, dim=1)


def topk_mask(xs: torch.Tensor, k: int) -> torch.Tensor:
    """Mask all but the top-k logits to -inf (k >= vocab is a no-op)."""
    if k <= 0 or k >= xs.shape[-1]:
        return xs
    kth = torch.topk(xs, k, dim=-1).values[..., -1:]
    return torch.where(xs < kth, torch.full_like(xs, float("-inf")), xs)


def get_tensor_stats(xs: torch.Tensor, mask: torch.Tensor, n) -> Dict[str, torch.Tensor]:
    """mean/min/max/std over the masked entries; `n` is the mask count."""
    if xs.numel() == 0:
        zero = torch.zeros((), dtype=torch.float32, device=xs.device)
        return dict(mean=zero, min=zero, max=zero, std=zero)
    mask = mask.to(xs.dtype)
    n = torch.clamp(torch.as_tensor(n, dtype=xs.dtype, device=xs.device), min=1e-8)
    mean = (xs * mask).sum() / n
    inf = torch.full_like(xs, float("inf"))
    return dict(
        mean=mean,
        min=torch.where(mask > 0, xs, inf).min(),
        max=torch.where(mask > 0, xs, -inf).max(),
        std=torch.sqrt((((xs - mean) * mask) ** 2).sum() / n),
    )


def flatten_dict(d: Union[dict, MutableMapping], parent_key: str = "", sep: str = "/") -> dict:
    """{"a": {"b": 1}} -> {"a/b": 1} (the reference's metric keys)."""
    items = {}
    for k, v in d.items():
        key = f"{parent_key}{sep}{k}" if parent_key else str(k)
        if isinstance(v, MutableMapping):
            items.update(flatten_dict(v, key, sep=sep))
        else:
            items[key] = v
    return items


@dataclass
class RunningMoments:
    """Running mean/variance of the reward sums (fp32 scalar tensors)."""

    mean: torch.Tensor
    var: torch.Tensor
    std: torch.Tensor
    count: torch.Tensor


def running_moments_init(device=None) -> RunningMoments:
    def f(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    return RunningMoments(mean=f(0.0), var=f(1.0), std=f(1.0), count=f(1e-24))


def running_moments_update(
    state: RunningMoments, xs: torch.Tensor
) -> Tuple[RunningMoments, torch.Tensor, torch.Tensor]:
    """Fold a batch into the running moments (Chan et al.'s parallel
    form). Returns (new_state, batch_mean, batch_std), batch_std being the
    unbiased standard deviation of `xs` itself."""
    xs_mean, xs_var, xs_count = _global_mean_var(xs.float())
    delta = xs_mean - state.mean
    tot_count = state.count + xs_count
    new_sum = xs_var * xs_count
    old_sum = state.var * state.count + delta ** 2 * state.count * xs_count / tot_count
    new_var = (old_sum + new_sum) / tot_count
    new_state = RunningMoments(
        mean=state.mean + delta * xs_count / tot_count,
        var=new_var,
        std=torch.sqrt(new_var * tot_count / torch.clamp(tot_count - 1, min=1e-8)),
        count=tot_count,
    )
    batch_std = torch.sqrt(xs_var * xs_count / torch.clamp(xs_count - 1, min=1e-8))
    return new_state, xs_mean, batch_std
