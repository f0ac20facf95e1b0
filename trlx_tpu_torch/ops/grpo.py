"""GRPO numerics: group-relative advantages and the critic-free clipped
surrogate (port of trlx_tpu.ops.grpo, same math and stat keys;
DeepSeekMath, arXiv:2402.03300). Each sample's advantage is the z-score of
its reward within its group of `group_size` samples of one prompt; the KL
regulariser against the frozen reference sits in the loss, the k3
estimator per token."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from trlx_tpu_torch.ops.common import flatten_dict, get_tensor_stats

# a group whose rewards are (numerically) all equal carries no preference
# signal: its advantages are exactly zero, not 0/eps noise or NaN
GROUP_STD_FLOOR = 1e-6


def group_relative_advantages(rewards: torch.Tensor, group_size: int) -> torch.Tensor:
    """Per-group reward z-scores `(r - mean_g) / (std_g + 1e-6)` over
    [batch] rewards whose rows `i*group_size .. (i+1)*group_size - 1` are
    the samples of prompt i; `std_g` is the population (1/N) deviation. A
    group with std <= 1e-6 gets exactly 0. A batch that is not whole
    groups raises."""
    if rewards.shape[0] % group_size:
        raise ValueError(
            f"rewards batch {rewards.shape[0]} is not a multiple of "
            f"group_size {group_size}"
        )
    r = rewards.float().reshape(-1, group_size)
    centered = r - r.mean(dim=1, keepdim=True)
    std = torch.sqrt((centered ** 2).mean(dim=1, keepdim=True))
    adv = torch.where(std > GROUP_STD_FLOOR, centered / (std + GROUP_STD_FLOOR), torch.zeros_like(centered))
    return adv.reshape(rewards.shape)


def grpo_loss(
    logprobs: torch.Tensor,
    old_logprobs: torch.Tensor,
    ref_logprobs: torch.Tensor,
    advantages: torch.Tensor,
    mask: torch.Tensor,
    cliprange: float,
    kl_coef: float,
    is_weight: Optional[torch.Tensor] = None,
    norm_n: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Clipped-ratio policy loss on the stored sequence-level advantage
    (`advantages` [batch], broadcast over the row's response tokens) plus
    `kl_coef` x the masked token mean of the k3 KL to the frozen reference,
    `exp(ref - lp) - 1 - (ref - lp)`, differentiated through `logprobs`.
    The other inputs are [batch, resp_len]. `is_weight` (detached) scales
    only the surrogate, None is weight 1; `norm_n` overrides the mask-count
    normaliser."""
    mask = mask.float()
    n = torch.clamp(mask.sum() if norm_n is None else torch.as_tensor(norm_n, dtype=torch.float32), min=1e-8)
    adv = advantages.float().detach()[:, None]

    log_ratio = (logprobs - old_logprobs) * mask
    ratio = torch.exp(log_ratio)
    approx_kl = torch.mean((ratio - 1) - log_ratio).detach()

    w = 1.0 if is_weight is None else is_weight.float().detach()
    pg_loss1 = -adv * ratio * w
    pg_loss2 = -adv * torch.clamp(ratio, 1.0 - cliprange, 1.0 + cliprange) * w
    pg_loss = (torch.maximum(pg_loss1, pg_loss2) * mask).sum() / n
    pg_clipfrac = ((pg_loss2 > pg_loss1).float() * mask).sum() / n

    # k3 KL(pi || ref) >= 0 per token; the masked token mean
    ref_log_ratio = (ref_logprobs - logprobs) * mask
    kl = (torch.exp(ref_log_ratio) - 1 - ref_log_ratio) * mask
    kl_loss = kl.sum() / n

    loss = pg_loss + kl_coef * kl_loss

    stats = dict(
        losses=dict(total_loss=loss, policy_loss=pg_loss, kl_loss=kl_loss),
        advantages=get_tensor_stats(adv.expand(mask.shape), mask, n),
        policy=dict(approx_kl=approx_kl, clipfrac=pg_clipfrac, ref_kl=kl_loss),
        ratio=(ratio * mask).sum() / n,
        padding_percentage=1.0 - n / mask.numel(),
    )
    return loss, flatten_dict(stats)
