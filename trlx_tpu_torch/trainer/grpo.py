"""GRPO trainer (port of trlx_tpu.trainer.grpo): critic-free online RL on
the shared experience core `TPUOnlineTrainer` (Group Relative Policy
Optimization, arXiv:2402.03300). The prompt stream, the chunked rollout
loop, the prefetch (`method.overlap_rollouts`) and the decode engine
(`method.gen_engine`) are the core's; this module adds what is GRPO:

- the prompt tiling: a chunk pulls `chunk_size / group_size` prompts and
  repeats each `group_size` times, so a group's samples are consecutive
  rows of one chunk (the sampler draws each row apart);
- the score/assemble step: the teacher-forced policy and reference
  forward (no value head), the reward on the host, and each sample's
  reward z-score in its group as its sequence-level advantage;
- the loss: PPO's clipped surrogate on that advantage plus the k3 KL to
  the frozen reference (`ops.grpo.grpo_loss`).

The frozen reference is a full copy of the initial policy, whatever
`num_layers_unfrozen` says (PPO's hydra branch shares the trunk; GRPO's
reference does not), so each experience chunk runs two full forwards.
With a peft adapter it is the base with the adapter off, and no copy is
made.
One process, one device: the reference's multi-host pad rows, its
experience transport (and so its staleness clip) and its microbatch split
have no counterpart here (`check_ported` raises on their knobs).
"""

from __future__ import annotations

from time import time
from typing import Any, Dict

import numpy as np
import torch

from trlx_tpu_torch.data import GRPORolloutBatch, PromptBatch
from trlx_tpu_torch.data.method_configs import GRPOConfig
from trlx_tpu_torch.ops.grpo import GROUP_STD_FLOOR, group_relative_advantages, grpo_loss
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.trainer.base import TPUOnlineTrainer, _masked_kl_stats
from trlx_tpu_torch.utils import Clock, logging

logger = logging.get_logger(__name__)


@register_trainer("TPUGRPOTrainer")
class TPUGRPOTrainer(TPUOnlineTrainer):
    def __init__(self, config, **kwargs):
        if not isinstance(config.method, GRPOConfig):
            raise ValueError("config.method must be GRPOConfig")
        super().__init__(config, **kwargs)
        if not config.method.gen_kwargs.get("do_sample", False):
            # a greedy group is group_size identical completions: every
            # group has zero advantage and nothing trains
            logger.warning(
                "grpo.gen_kwargs.do_sample is off — identical group "
                "members give zero group-relative advantage; enable "
                "sampling for GRPO to learn anything"
            )

    # -- model -----------------------------------------------------------

    def setup_model(self) -> None:
        self.setup_policy_and_frozen_copy("GRPO")

    # -- loss ------------------------------------------------------------

    def loss(self, batch: GRPORolloutBatch):
        """The policy's logprobs of the stored response tokens (one forward,
        no value head), then the clipped surrogate on the stored group
        advantage plus the in-loss reference KL."""
        method = self.config.method
        pad = self.generate_settings.pad_token_id
        P = batch.query_tensors.shape[1]
        N = batch.response_tensors.shape[1]
        tokens = torch.cat([batch.query_tensors, batch.response_tensors], dim=1)
        attention_mask = (tokens != pad).to(torch.int32)
        # response positions count even where response == pad (the mask
        # says which are real)
        attention_mask[:, P:] = torch.maximum(attention_mask[:, P:], batch.response_mask.to(torch.int32))
        out = self.model(tokens, attention_mask, compute_logits=False)
        logprobs = self._response_logprobs(
            self.model.logit_project_fn(), out["hidden_states"][:, P - 1:P + N - 1], tokens[:, P:P + N]
        )
        return grpo_loss(
            logprobs=logprobs,
            old_logprobs=batch.logprobs,
            ref_logprobs=batch.ref_logprobs,
            advantages=batch.advantages,
            mask=batch.response_mask,
            cliprange=method.cliprange,
            kl_coef=method.kl_coef,
            is_weight=batch.is_weight,
            norm_n=None if batch.norm_n is None else batch.norm_n[0],
        )

    # -- the score/assemble step -----------------------------------------

    def _inner_epochs(self) -> int:
        return self.config.method.grpo_epochs

    def _prompt_chunk_rows(self) -> int:
        # the stream yields prompts; _next_prompt_batch tiles each
        # group_size times, so a chunk of the stream is chunk_size samples
        return self.config.method.chunk_size // self.config.method.group_size

    def _next_prompt_batch(self) -> PromptBatch:
        """One chunk of prompts, each repeated `group_size` times (its
        metadata too): a group's members are consecutive rows."""
        batch = super()._next_prompt_batch()
        gs = self.config.method.group_size
        metadata = None
        if batch.metadata:
            metadata = {k: [x for x in v for _ in range(gs)] for k, v in batch.metadata.items()}
        return PromptBatch(
            input_ids=torch.repeat_interleave(batch.input_ids, gs, dim=0),
            attention_mask=torch.repeat_interleave(batch.attention_mask, gs, dim=0),
            metadata=metadata,
        )

    @torch.no_grad()
    def experience_forward(self, tokens, attention_mask, response_mask):
        """The score-independent half of the experience step: the policy and
        the frozen reference over the whole sequence, the response slice of
        both logprobs (masked) and the k3 KL stats over every real token.
        Returns (rollout batch with zero advantages, {mean_kl,
        mean_kl_per_token})."""
        P = tokens.shape[1] - response_mask.shape[1]
        N = response_mask.shape[1]
        logprobs_full, ref_logprobs_full = self._policy_and_reference_logprobs(tokens, attention_mask)
        full_mask = attention_mask[:, 1:].float()
        log_ratio_full = (logprobs_full - ref_logprobs_full) * full_mask
        kl = torch.exp(log_ratio_full) - 1 - log_ratio_full
        mean_kl, mean_kl_per_token = _masked_kl_stats(kl)
        mask = response_mask.float()
        sl = slice(P - 1, P + N - 1)
        batch = GRPORolloutBatch(
            query_tensors=tokens[:, :P],
            response_tensors=tokens[:, P:],
            logprobs=logprobs_full[:, sl] * mask,
            ref_logprobs=ref_logprobs_full[:, sl] * mask,
            advantages=torch.zeros(tokens.shape[0], dtype=torch.float32, device=tokens.device),  # set once scored
            response_mask=mask,
        )
        return batch, {"mean_kl": mean_kl, "mean_kl_per_token": mean_kl_per_token}

    def _experience(self, sequences, prompt_mask, response_mask):
        attention_mask = torch.cat([prompt_mask, response_mask], dim=1).to(torch.int32)
        return self._dispatch_experience(self.experience_forward, sequences, attention_mask, response_mask)

    def _pre_accum_batch(self, batch):
        """The split_microbatch rung's compensation for GRPO: the advantages
        are per sequence, but the loss's mask-count normaliser couples the
        batch, so it is fixed to the whole batch's count / num_mb (PPO's
        contract)."""
        if self.memdoctor.accum_factor <= 1 or not isinstance(batch, GRPORolloutBatch):
            return batch
        norm = (batch.response_mask.float().sum() / self.num_mb).expand(batch.response_mask.shape[0]).clone()
        return batch.replace(norm_n=norm)

    def _group_advantages(self, scores: np.ndarray, stats: Dict[str, Any]) -> np.ndarray:
        """Each row's reward z-score in its group; logs the groups' mean
        reward std and the share of degenerate (all-equal) groups."""
        gs = self.config.method.group_size
        if len(scores) % gs:
            raise RuntimeError(
                f"rollout chunk of {len(scores)} rows is not whole groups "
                f"of {gs} — the prompt tiling invariant broke"
            )
        adv = group_relative_advantages(torch.from_numpy(scores), gs).numpy()
        group_std = scores.reshape(-1, gs).std(axis=1)
        stats["grpo/group_reward_std"] = float(group_std.mean())
        stats["grpo/zero_adv_groups"] = float((group_std <= GROUP_STD_FLOOR).mean())
        return adv.astype(np.float32)

    def _score_and_assemble(self, batch: PromptBatch, gen_out, stats: Dict[str, Any],
                            iter_count: int, clock: Clock):
        """One rollout chunk: the experience forward on the sampler's device
        tensors, decode + reward_fn on the host, dense rewards folded to
        their sum, reward clipping, the running moments (telemetry: the
        z-scores do not depend on scale), the group advantages and the
        chunk's stats. Returns (rollout batch, rows). With stop sequences
        the forward runs after the decode, on the response tokens
        re-tokenised from the trimmed outputs."""
        method = self.config.method
        sequences = gen_out["sequences"]
        response_ids, response_mask = gen_out["response_ids"], gen_out["response_mask"]
        N = response_mask.shape[1]
        P = batch.input_ids.shape[1]
        if not self.stop_sequences:
            pre_batch, kl_stats = self._experience(sequences, gen_out["prompt_mask"], response_mask)

        seq_np = sequences.cpu().numpy()
        str_samples, str_prompts, str_outputs = self.decode(
            batch.input_ids.numpy(), seq_np, [P] * len(seq_np), append_eos_token=True
        )
        t0 = time()
        all_scores = self._call_reward_fn(
            samples=str_samples, prompts=str_prompts, outputs=str_outputs,
            tokenizer=self.tokenizer, **(batch.metadata or {}),
        )
        stats["time/rollout_score"] = time() - t0

        # the group baseline is per sequence: a dense reward folds to its sum
        scores = np.asarray([float(np.asarray(s, np.float32).sum()) for s in all_scores], np.float32)
        if method.cliprange_reward:
            scores = np.clip(scores, -method.cliprange_reward, method.cliprange_reward)
        self._update_reward_moments(scores[:, None], np.ones_like(scores)[:, None], stats)
        advantages = self._group_advantages(scores, stats)

        if self.stop_sequences:
            response_ids, response_mask, sequences = self._retokenize_outputs(str_outputs, batch, sequences, N)
            pre_batch, kl_stats = self._experience(sequences, gen_out["prompt_mask"], response_mask)
        rollout_batch = pre_batch.replace(advantages=torch.as_tensor(advantages, device=self.device))

        self._rollout_accounting_stats(
            response_ids.cpu().numpy(), response_mask.cpu().numpy(),
            self.generate_settings.eos_token_id, stats, gen_out.get("gen_stats"),
        )
        stats["time/rollout_time"] = clock.tick()
        stats["policy/sqrt_kl"] = torch.sqrt(torch.clamp(kl_stats["mean_kl"], min=0.0))
        stats["policy/kl_per_token"] = torch.sqrt(torch.clamp(kl_stats["mean_kl_per_token"], min=0.0))
        return rollout_batch, len(seq_np)
