"""Typed batches (port of trlx_tpu.data for the PPO, GRPO, SFT, ILQL, RFT and
DPO paths):
dataclasses of tensors with rectangular, statically padded shapes, and
`.replace`."""

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


@dataclass
class GRPORolloutBatch(_Batch):
    """Batched GRPO experience: PPO's rollout layout without the value
    column. No `values` and no `rewards`: one group-relative advantage a
    row replaces both, and the KL regulariser is computed in the loss from
    the stored reference logprobs."""

    query_tensors: torch.Tensor  # [batch, prompt_len] int, left-padded
    response_tensors: torch.Tensor  # [batch, resp_len] int, right-padded
    logprobs: torch.Tensor  # [batch, resp_len] f32, behaviour logprobs
    ref_logprobs: torch.Tensor  # [batch, resp_len] f32, frozen reference
    advantages: torch.Tensor  # [batch] f32, the reward's z-score in its group
    response_mask: torch.Tensor  # [batch, resp_len] f32 (1 = real response token)
    # the experience transport's staleness weight and the loss's mask-count
    # normaliser, as on PPORolloutBatch; None on every path the port has
    is_weight: Optional[torch.Tensor] = None
    norm_n: Optional[torch.Tensor] = None


@dataclass
class DPOBatch(_Batch):
    """One collated batch of preference pairs: prompt + chosen and prompt +
    rejected rows, right-padded to the store's one width. The response
    masks mark exactly the completion tokens."""

    chosen_ids: torch.Tensor  # [batch, seq] int32
    chosen_attention_mask: torch.Tensor  # [batch, seq] int32
    chosen_response_mask: torch.Tensor  # [batch, seq] int32
    rejected_ids: torch.Tensor  # [batch, seq] int32
    rejected_attention_mask: torch.Tensor  # [batch, seq] int32
    rejected_response_mask: torch.Tensor  # [batch, seq] int32


@dataclass
class SFTBatch(_Batch):
    """Supervised batch, right-padded; labels use -100 to mask prompt and
    pad positions."""

    input_ids: torch.Tensor  # [batch, seq] int32
    attention_mask: torch.Tensor  # [batch, seq] int32
    labels: torch.Tensor  # [batch, seq] int32, -100 = ignored
    # the decoder side of seq2seq SFT, which raises in both packages
    decoder_input_ids: Optional[torch.Tensor] = None


@dataclass
class ILQLBatch(_Batch):
    """Batched ILQL experience, every field right-padded to the store's
    dataset-wide widths; the gather indices pad by repeating their last
    real entry."""

    input_ids: torch.Tensor  # [batch, seq] int32
    attention_mask: torch.Tensor  # [batch, seq] int32
    rewards: torch.Tensor  # [batch, n_actions] f32
    states_ixs: torch.Tensor  # [batch, n_states] int32
    actions_ixs: torch.Tensor  # [batch, n_actions] int32
    dones: torch.Tensor  # [batch, n_states] int32


@dataclass
class ILQLSeq2SeqBatch(_Batch):
    """ILQL batch for encoder-decoder models: the indices run over the
    decoder rows, which start with the decoder start token."""

    input_ids: torch.Tensor  # [batch, enc_seq] int32
    attention_mask: torch.Tensor  # [batch, enc_seq] int32
    decoder_input_ids: torch.Tensor  # [batch, dec_seq] int32
    rewards: torch.Tensor  # [batch, n_actions] f32
    states_ixs: torch.Tensor  # [batch, n_states] int32
    actions_ixs: torch.Tensor  # [batch, n_actions] int32
    dones: torch.Tensor  # [batch, n_states] int32
