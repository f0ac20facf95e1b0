"""Typed batches (port of trlx_tpu.data for the PPO path): dataclasses of
tensors with rectangular, statically padded shapes, and `.replace`."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch


class _Batch:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]):
        """A copy with `fn` applied to every tensor field (None stays None)."""
        return self.replace(**{
            f.name: fn(v) for f in dataclasses.fields(self)
            if isinstance(v := getattr(self, f.name), torch.Tensor)
        })


@dataclass
class PromptBatch(_Batch):
    """A batch of tokenized prompts, left-padded to a fixed length."""

    input_ids: torch.Tensor  # [batch, prompt_len] int32
    attention_mask: torch.Tensor  # [batch, prompt_len] int32 (1 = real token)
    metadata: Any = None  # per-prompt columns forwarded to reward_fn


@dataclass
class PPORolloutBatch(_Batch):
    """Batched PPO experience: queries left-padded to the prompt width,
    responses right-padded to max_new_tokens."""

    query_tensors: torch.Tensor  # [batch, prompt_len] int, left-padded
    response_tensors: torch.Tensor  # [batch, resp_len] int, right-padded
    logprobs: torch.Tensor  # [batch, resp_len] f32, per response token
    values: torch.Tensor  # [batch, resp_len] f32
    rewards: torch.Tensor  # [batch, resp_len] f32 (KL penalty + terminal score)
    response_mask: torch.Tensor  # [batch, resp_len] f32 (1 = real response token)
    # per-token importance weight of the experience transport's staleness
    # clip; None (weight 1) on every path the port has
    is_weight: Optional[torch.Tensor] = None
    # GAE precomputed over a full minibatch before a microbatch split, and
    # the loss's mask-count normaliser; None = computed in the loss
    advantages: Optional[torch.Tensor] = None
    returns: Optional[torch.Tensor] = None
    norm_n: Optional[torch.Tensor] = None
