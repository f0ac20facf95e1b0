"""PPO numerics: GAE and the clipped surrogate objective (port of
trlx_tpu.ops.ppo, same math and stat keys). The reference's reversed
`lax.scan` over the response window is a reversed Python loop here."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from trlx_tpu_torch.ops.common import flatten_dict, get_tensor_stats, whiten


def gae_advantages_and_returns(
    values: torch.Tensor,
    rewards: torch.Tensor,
    gamma: float,
    lam: float,
    use_whitening: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation over the response window.

    values, rewards: [batch, response_len] (rewards already include the
    per-token KL penalty). Returns (advantages, returns); advantages are
    whitened across the batch and detached."""
    T = values.shape[1]
    next_values = torch.cat([values[:, 1:], torch.zeros_like(values[:, :1])], dim=1)
    deltas = rewards + gamma * next_values - values
    last = torch.zeros_like(deltas[:, 0])
    advs = [None] * T
    for t in reversed(range(T)):
        last = deltas[:, t] + gamma * lam * last
        advs[t] = last
    advantages = torch.stack(advs, dim=1)
    returns = advantages + values
    if use_whitening:
        advantages = whiten(advantages)
    return advantages.detach(), returns


def ppo_loss(
    logprobs: torch.Tensor,
    values: torch.Tensor,
    old_logprobs: torch.Tensor,
    old_values: torch.Tensor,
    advantages: torch.Tensor,
    returns: torch.Tensor,
    mask: torch.Tensor,
    cliprange: float,
    cliprange_value: float,
    vf_coef: float,
    is_weight: Optional[torch.Tensor] = None,
    norm_n: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Clipped-ratio policy loss + clipped value loss, masked over real
    response tokens; all shapes [batch, response_len].

    `is_weight` (per-token importance weight, detached) scales only the
    policy surrogate; None is weight 1. `norm_n` overrides the mask-count
    normaliser (default: this call's own `mask.sum()`)."""
    mask = mask.float()
    n = torch.clamp(mask.sum() if norm_n is None else torch.as_tensor(norm_n, dtype=torch.float32), min=1e-8)

    values_clipped = torch.clamp(values, old_values - cliprange_value, old_values + cliprange_value)
    vf_loss1 = (values - returns) ** 2
    vf_loss2 = (values_clipped - returns) ** 2
    vf_loss = 0.5 * (torch.maximum(vf_loss1, vf_loss2) * mask).sum() / n
    vf_clipfrac = ((vf_loss2 > vf_loss1).float() * mask).sum() / n

    log_ratio = (logprobs - old_logprobs) * mask
    ratio = torch.exp(log_ratio)
    # k3 estimator, http://joschu.net/blog/kl-approx.html
    approx_kl = torch.mean((ratio - 1) - log_ratio).detach()

    w = 1.0 if is_weight is None else is_weight.float().detach()
    pg_loss1 = -advantages * ratio * w
    pg_loss2 = -advantages * torch.clamp(ratio, 1.0 - cliprange, 1.0 + cliprange) * w
    pg_loss = (torch.maximum(pg_loss1, pg_loss2) * mask).sum() / n
    pg_clipfrac = ((pg_loss2 > pg_loss1).float() * mask).sum() / n

    loss = pg_loss + vf_coef * vf_loss

    stats = dict(
        losses=dict(total_loss=loss, policy_loss=pg_loss, value_loss=vf_loss),
        values=dict(
            get_tensor_stats(values, mask, n),
            values_error=(((values - returns) * mask) ** 2).sum() / n,
            values_mape_error=(torch.abs(values - returns) * mask
                               / torch.abs(returns * mask + 1e-2)).sum() / n,
            clipfrac=vf_clipfrac,
        ),
        old_values=get_tensor_stats(old_values, mask, n),
        returns=get_tensor_stats(returns, mask, n),
        policy=dict(approx_kl=approx_kl, clipfrac=pg_clipfrac),
        ratio=(ratio * mask).sum() / n,
        padding_percentage=1.0 - n / mask.numel(),
    )
    return loss, flatten_dict(stats)
