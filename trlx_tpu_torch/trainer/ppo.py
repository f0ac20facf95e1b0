"""PPO trainer: the method half of the online experience core (port of
trlx_tpu.trainer.ppo for causal and seq2seq models): the value-headed
hydra policy, the teacher-forced score/assemble step (policy + reference
+ value forward, per-token KL penalty, reward injection), the KL
controllers, and GAE + the clipped surrogate loss. Metric keys match the
reference's. A seq2seq rollout stores the encoder prompt as its query and
the decoder sequence (start token + response) as its response.

The loss runs the policy-only forward (logits + values): the reference's
loss calls `forward_train`, whose reference logits `jit` eliminates as
dead code; run eagerly they would cost a second model pass per step.
"""

from __future__ import annotations

from time import time
from typing import Any, Dict, Tuple

import numpy as np
import torch

from trlx_tpu_torch.data import PPORolloutBatch, PromptBatch
from trlx_tpu_torch.data.method_configs import PPOConfig
from trlx_tpu_torch.models.seq2seq import t5_logit_projection
from trlx_tpu_torch.models.transformer import logit_projection
from trlx_tpu_torch.models.wrappers import CausalLMWithValueHead, Seq2SeqLMWithValueHead
from trlx_tpu_torch.ops.common import chunked_logprobs, logprobs_of_labels
from trlx_tpu_torch.ops.ppo import gae_advantages_and_returns, ppo_loss
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.trainer.base import TPUOnlineTrainer
from trlx_tpu_torch.utils import Clock


class AdaptiveKLController:
    """Ziegler-style proportional KL coefficient controller."""

    def __init__(self, init_kl_coef: float, target: float, horizon: int):
        self.value = init_kl_coef
        self.target = target
        self.horizon = horizon

    def update(self, current: float, n_steps: int) -> None:
        proportional_error = float(np.clip(current / self.target - 1, -0.2, 0.2))
        self.value *= 1 + proportional_error * n_steps / self.horizon


class FixedKLController:
    def __init__(self, kl_coef: float):
        self.value = kl_coef

    def update(self, current: float, n_steps: int) -> None:
        pass


def _masked_kl_stats(kl: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean KL per row, mean KL per token) over the chunk's rows."""
    return kl.sum(dim=1).mean(), kl.mean()


@register_trainer("TPUPPOTrainer")
class TPUPPOTrainer(TPUOnlineTrainer):
    def __init__(self, config, **kwargs):
        if not isinstance(config.method, PPOConfig):
            raise ValueError("config.method must be PPOConfig")
        super().__init__(config, **kwargs)
        if config.method.target:
            self.kl_ctl: Any = AdaptiveKLController(
                config.method.init_kl_coef, config.method.target, config.method.horizon
            )
        else:
            self.kl_ctl = FixedKLController(config.method.init_kl_coef)
        self.mean_kl = 0.0

    # -- model -----------------------------------------------------------

    def setup_model(self) -> None:
        """The value-headed policy with random weights from train.seed and
        its frozen reference: the top branch above n_layer - k (hydra; the
        decoder's n_decoder_layer - k for seq2seq) for 0 < num_layers_unfrozen
        k < that depth, else a full frozen copy."""
        k = self.config.model.num_layers_unfrozen
        if self.seq2seq:
            cfg = self.load_seq2seq_base()
            n = cfg.n_decoder_layer
            branch_at = n - k if k is not None and 0 < k < n else None
            self.model = Seq2SeqLMWithValueHead(cfg, branch_at=branch_at, device=self.device)
        else:
            cfg = self.load_base_model()
            branch_at = cfg.n_layer - k if k is not None and 0 < k < cfg.n_layer else None
            self.model = CausalLMWithValueHead(cfg, branch_at=branch_at, device=self.device)
        self.model.init_params(torch.Generator().manual_seed(self.config.train.seed))
        self.ref_params = self.model.make_ref_params()

    # -- loss ------------------------------------------------------------

    def _response_logprobs(self, project, hidden: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """log p(labels) from the hidden states that predict them, through
        fp32 logits, chunked when train.logit_chunks asks."""
        chunks = self.config.train.logit_chunks
        if chunks:
            return chunked_logprobs(project, hidden, labels, chunks)
        return logprobs_of_labels(project(hidden), labels)

    def response_logprobs_and_values(self, batch: PPORolloutBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        """The policy's logprobs of the stored response tokens and its
        values at the positions that predict them, [B, N] each. Only the
        response positions are projected to logits (the prompt's would be
        sliced away)."""
        pad = self.generate_settings.pad_token_id
        if self.seq2seq:
            # query = the encoder prompt; response = the decoder ids (start
            # token + sampled tokens), whose mask leads with the start token
            dec = batch.response_tensors
            enc_mask = (batch.query_tensors != pad).to(torch.int32)
            dec_mask = torch.cat([torch.ones_like(dec[:, :1], dtype=torch.int32),
                                  batch.response_mask.to(torch.int32)], dim=1)
            out = self.model(batch.query_tensors, enc_mask, dec, dec_mask, compute_logits=False)
            logprobs = self._response_logprobs(self.model.logit_project_fn(), out["hidden_states"][:, :-1],
                                               dec[:, 1:])
            return logprobs, out["values"][:, :-1]
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
        return logprobs, out["values"][:, P - 1:P + N - 1]

    def loss(self, batch: PPORolloutBatch):
        """Recompute logprobs/values on stored rollouts, GAE on the fly,
        the clipped PPO objective."""
        method = self.config.method
        if batch.advantages is not None:
            advantages, returns = batch.advantages, batch.returns
        else:
            advantages, returns = gae_advantages_and_returns(
                batch.values, batch.rewards, gamma=method.gamma, lam=method.lam
            )
        logprobs, values = self.response_logprobs_and_values(batch)
        return ppo_loss(
            logprobs=logprobs,
            values=values,
            old_logprobs=batch.logprobs,
            old_values=batch.values,
            advantages=advantages,
            returns=returns,
            mask=batch.response_mask,
            cliprange=method.cliprange,
            cliprange_value=method.cliprange_value,
            vf_coef=method.vf_coef,
            is_weight=batch.is_weight,
            norm_n=None if batch.norm_n is None else batch.norm_n[0],
        )

    # -- the score/assemble step -----------------------------------------

    def _inner_epochs(self) -> int:
        return self.config.method.ppo_epochs

    def _rollout_stage_meta(self):
        # the KL coefficient at collection time rides the held stats
        return self.kl_ctl.value

    @torch.no_grad()
    def experience_forward(self, tokens, attention_mask, response_mask, kl_coef: float):
        """The score-independent half of the experience step: the
        teacher-forced policy/reference/value forward and the per-token KL
        penalty. Returns (KL-only rollout batch, {mean_kl,
        mean_kl_per_token})."""
        P = tokens.shape[1] - response_mask.shape[1]
        N = response_mask.shape[1]
        chunks = self.config.train.logit_chunks
        out = self.model.forward_train(self.ref_params, tokens, attention_mask, compute_logits=chunks == 0)
        if chunks:
            logprobs_full = chunked_logprobs(
                self.model.logit_project_fn(), out["hidden_states"][:, :-1], tokens[:, 1:], chunks
            )
            ref_logprobs_full = chunked_logprobs(
                logit_projection(self.ref_params), out["ref_hidden"][:, :-1], tokens[:, 1:], chunks
            )
        else:
            logprobs_full = logprobs_of_labels(out["logits"][:, :-1], tokens[:, 1:])
            ref_logprobs_full = logprobs_of_labels(out["ref_logits"][:, :-1], tokens[:, 1:])
        full_mask = attention_mask[:, 1:].float()
        log_ratio_full = (logprobs_full - ref_logprobs_full) * full_mask
        kl = torch.exp(log_ratio_full) - 1 - log_ratio_full
        mean_kl, mean_kl_per_token = _masked_kl_stats(kl)
        mask = response_mask.float()
        sl = slice(P - 1, P + N - 1)
        batch = PPORolloutBatch(
            query_tensors=tokens[:, :P],
            response_tensors=tokens[:, P:],
            logprobs=logprobs_full[:, sl] * mask,
            values=out["values"][:, sl] * mask,
            rewards=-kl_coef * (log_ratio_full[:, sl] * mask),  # scores injected later
            response_mask=mask,
        )
        return batch, {"mean_kl": mean_kl, "mean_kl_per_token": mean_kl_per_token}

    @torch.no_grad()
    def experience_forward_seq2seq(self, enc_ids, enc_mask, dec_ids, response_mask, kl_coef: float):
        """`experience_forward` for a seq2seq rollout (the reference's
        `seq2seq_fn` up to the score injection): the teacher-forced pass over
        the decoder ids (start token + response) with the encoder prompt, the
        response-masked logprobs, values and KL penalty."""
        chunks = self.config.train.logit_chunks
        mask = response_mask.float()
        dec_mask = torch.cat([torch.ones_like(dec_ids[:, :1], dtype=torch.int32),
                              response_mask.to(torch.int32)], dim=1)
        out = self.model.forward_train(self.ref_params, enc_ids, enc_mask, dec_ids, dec_mask,
                                       compute_logits=chunks == 0)
        labels = dec_ids[:, 1:]
        if chunks:
            logprobs = chunked_logprobs(self.model.logit_project_fn(), out["hidden_states"][:, :-1], labels, chunks)
            ref_logprobs = chunked_logprobs(t5_logit_projection(self.ref_params, self.model.cfg),
                                            out["ref_hidden"][:, :-1], labels, chunks)
        else:
            logprobs = logprobs_of_labels(out["logits"][:, :-1], labels)
            ref_logprobs = logprobs_of_labels(out["ref_logits"][:, :-1], labels)
        logprobs, ref_logprobs = logprobs * mask, ref_logprobs * mask
        log_ratio = logprobs - ref_logprobs
        kl = torch.exp(log_ratio) - 1 - log_ratio
        mean_kl, mean_kl_per_token = _masked_kl_stats(kl)
        batch = PPORolloutBatch(
            query_tensors=enc_ids,
            response_tensors=dec_ids,
            logprobs=logprobs,
            values=out["values"][:, :-1] * mask,
            rewards=-kl_coef * log_ratio,  # scores injected later
            response_mask=mask,
        )
        return batch, {"mean_kl": mean_kl, "mean_kl_per_token": mean_kl_per_token}

    @staticmethod
    def inject_scores(batch: PPORolloutBatch, scores: torch.Tensor, scores_mask: torch.Tensor,
                      scale_div: torch.Tensor) -> PPORolloutBatch:
        """Apply host-computed scores to a KL-only rollout batch: scale,
        add the terminal (one score per row) or dense rewards, re-mask."""
        scores = scores / torch.clamp(scale_div, min=1e-8)
        mask, rewards = batch.response_mask, batch.rewards
        N, S = rewards.shape[1], scores.shape[1]
        if S == 1:
            last = torch.clamp(mask.sum(dim=1).long() - 1, min=0)
            rewards = rewards + scores[:, 0:1] * torch.nn.functional.one_hot(last, N).to(rewards.dtype)
        else:
            padded = torch.zeros_like(rewards)
            padded[:, :S] = scores * scores_mask
            rewards = rewards + padded
        return batch.replace(rewards=rewards * mask)

    def _score_and_assemble(self, batch: PromptBatch, gen_out, stats: Dict[str, Any],
                            iter_count: int, clock: Clock):
        """One rollout chunk: the teacher-forced experience forward on the
        sampler's device tensors, decode + reward_fn on the host, reward
        clipping, the running moments and scaling, score injection and the
        chunk's stats. Returns (rollout batch, rows)."""
        method = self.config.method
        sequences = gen_out["sequences"]
        response_mask = gen_out["response_mask"]
        N = response_mask.shape[1]
        P = batch.input_ids.shape[1]
        if self.seq2seq:
            enc_ids = torch.as_tensor(batch.input_ids, device=self.device)
            pre_batch, kl_stats = self.experience_forward_seq2seq(
                enc_ids, gen_out["prompt_mask"], sequences, response_mask, self.kl_ctl.value
            )
        else:
            attention_mask = torch.cat([gen_out["prompt_mask"], response_mask], dim=1).to(torch.int32)
            pre_batch, kl_stats = self.experience_forward(
                sequences, attention_mask, response_mask, self.kl_ctl.value
            )

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

        scores_list = [np.atleast_1d(np.asarray(s, np.float32)) for s in all_scores]
        S = max(len(s) for s in scores_list)
        if S > N:
            # a dense reward longer than the response window: fold the tail
            # into the last in-window entry so no reward mass is dropped
            scores_list = [
                np.concatenate([s[: N - 1], [s[N - 1:].sum()]]) if len(s) > N else s
                for s in scores_list
            ]
            S = N
        scores = np.zeros((len(scores_list), S), np.float32)
        scores_mask = np.zeros((len(scores_list), S), np.float32)
        for i, s in enumerate(scores_list):
            scores[i, : len(s)] = s
            scores_mask[i, : len(s)] = 1.0
        if method.cliprange_reward:
            scores = np.clip(scores, -method.cliprange_reward, method.cliprange_reward)

        scale_div = self._update_reward_moments(scores, scores_mask, stats)
        rollout_batch = self.inject_scores(
            pre_batch,
            torch.as_tensor(scores, device=self.device),
            torch.as_tensor(scores_mask, device=self.device),
            scale_div,
        )
        self._rollout_accounting_stats(
            gen_out["response_ids"].cpu().numpy(), response_mask.cpu().numpy(),
            self.generate_settings.eos_token_id, stats, gen_out.get("gen_stats"),
        )
        stats["time/rollout_time"] = clock.tick()
        stats["policy/sqrt_kl"] = torch.sqrt(torch.clamp(kl_stats["mean_kl"], min=0.0))
        stats["policy/kl_per_token"] = torch.sqrt(torch.clamp(kl_stats["mean_kl_per_token"], min=0.0))
        return rollout_batch, len(seq_np)

    def _finish_rollout_stats(self) -> None:
        """Log the held rollout stats; they carry the mean KL that the
        controller update consumes."""
        for stats, step, kl_ctl_value in self._pending_rollout:
            stats["kl_ctl_value"] = kl_ctl_value
            self._log_stats(stats, step=step)
            self.mean_kl = self.stats_history[-1][1]["policy/sqrt_kl"] ** 2
        self._pending_rollout = []

    def post_backward_callback(self) -> None:
        super().post_backward_callback()
        self.kl_ctl.update(self.mean_kl, n_steps=self.config.train.batch_size)

