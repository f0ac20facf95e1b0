"""DPO numerics: the sigmoid preference loss over policy-vs-reference
logprob margins (port of trlx_tpu.ops.dpo, same math and stat keys;
Rafailov et al., arXiv:2305.18290)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from trlx_tpu_torch.ops.common import flatten_dict, logprobs_of_labels


def response_logprob_sums(token_logprobs: torch.Tensor, response_mask: torch.Tensor) -> torch.Tensor:
    """Each row's summed logprob over its response tokens, from
    token_logprobs [batch, seq - 1] (position t: log p(input_ids[t + 1]))
    and response_mask [batch, seq] (1 exactly on the completion)."""
    return (token_logprobs * response_mask[:, 1:].float()).sum(dim=-1)


def sequence_logprobs(logits: torch.Tensor, input_ids: torch.Tensor, response_mask: torch.Tensor) -> torch.Tensor:
    """The summed next-token logprob of each row's response tokens, from
    logits [batch, seq, vocab] and input_ids / response_mask [batch, seq]
    (1 exactly on the completion). Position t's label is input_ids[t+1]."""
    return response_logprob_sums(logprobs_of_labels(logits[:, :-1], input_ids[:, 1:]), response_mask)


def dpo_loss(
    policy_chosen_logps: torch.Tensor,
    policy_rejected_logps: torch.Tensor,
    ref_chosen_logps: torch.Tensor,
    ref_rejected_logps: torch.Tensor,
    beta: float,
    label_smoothing: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """`-log sigmoid(margin)`, margin = beta x ((pi_c - ref_c) - (pi_r -
    ref_r)) over per-sequence summed logprobs [batch], mixed with the
    flipped label by `label_smoothing` (conservative DPO). The reference
    logps are detached: the frozen reference never trains."""
    ref_chosen_logps = ref_chosen_logps.detach()
    ref_rejected_logps = ref_rejected_logps.detach()
    chosen_rewards = beta * (policy_chosen_logps - ref_chosen_logps)
    rejected_rewards = beta * (policy_rejected_logps - ref_rejected_logps)
    margin = chosen_rewards - rejected_rewards

    loss = (-F.logsigmoid(margin) * (1.0 - label_smoothing) - F.logsigmoid(-margin) * label_smoothing).mean()

    stats = dict(
        losses=dict(total_loss=loss),
        dpo=dict(
            accuracy=(margin > 0).float().mean(),
            margin=margin.mean(),
            chosen_reward=chosen_rewards.mean(),
            rejected_reward=rejected_rewards.mean(),
            logprob_chosen=policy_chosen_logps.mean(),
            logprob_rejected=policy_rejected_logps.mean(),
        ),
    )
    return loss, flatten_dict(stats)
