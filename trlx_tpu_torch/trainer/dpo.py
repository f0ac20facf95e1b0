"""DPO trainer (port of trlx_tpu.trainer.dpo): offline direct preference
optimisation (Rafailov et al., arXiv:2305.18290).

`trlx_tpu_torch.train(samples=[(prompt, chosen, rejected), ...])` builds a
pair store (`pipeline.dpo_pipeline`) and the per-step loop minimises the
sigmoid preference loss over policy-vs-reference logprob margins
(`ops.dpo`). The frozen reference is a full copy of the initial policy,
made after its weights are in place (with a peft adapter, the base with the
adapter off, and no copy). Each step runs the chosen and
rejected rows as one stacked forward of 2B rows, and the reference over
the same rows under `torch.no_grad()`.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from trlx_tpu_torch.data import DPOBatch
from trlx_tpu_torch.data.method_configs import DPOConfig
from trlx_tpu_torch.ops.dpo import dpo_loss, response_logprob_sums
from trlx_tpu_torch.pipeline.dpo_pipeline import DPOPairStorage
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.trainer.base import TPUBaseTrainer


@register_trainer("TPUDPOTrainer")
class TPUDPOTrainer(TPUBaseTrainer):
    def __init__(self, config, **kwargs):
        if not isinstance(config.method, DPOConfig):
            raise ValueError("config.method must be DPOConfig")
        super().__init__(config, **kwargs)

    def setup_model(self) -> None:
        self.setup_policy_and_frozen_copy("DPO")

    def sequence_logprobs(self, ids, mask, resp_mask):
        """The policy's and the frozen reference's summed response logprobs
        of one stacked [chosen; rejected] block; the reference runs without
        a graph."""
        lp, ref_lp = self._policy_and_reference_logprobs(ids, mask)
        return response_logprob_sums(lp, resp_mask), response_logprob_sums(ref_lp, resp_mask)

    def loss(self, batch: DPOBatch):
        batch = batch.map(lambda x: x.to(self.device))
        method = self.config.method
        B = batch.chosen_ids.shape[0]
        ids = torch.cat([batch.chosen_ids, batch.rejected_ids], dim=0)
        mask = torch.cat([batch.chosen_attention_mask, batch.rejected_attention_mask], dim=0)
        resp = torch.cat([batch.chosen_response_mask, batch.rejected_response_mask], dim=0)
        seq_lp, ref_seq_lp = self.sequence_logprobs(ids, mask, resp)
        return dpo_loss(seq_lp[:B], seq_lp[B:], ref_seq_lp[:B], ref_seq_lp[B:],
                        beta=method.beta, label_smoothing=method.label_smoothing)

    def make_experience(self, samples: List, rewards: Optional[List[float]] = None, seq_length: int = 1024) -> None:
        """The pair store from (prompt, chosen, rejected) triples. `rewards`
        must be None: the pair ordering is DPO's signal."""
        if rewards is not None:
            raise ValueError(
                "DPO takes no rewards: pass samples as (prompt, chosen, "
                "rejected) triples — the preference ordering IS the signal"
            )
        self.store = DPOPairStorage(samples, self.tokenizer, max_length=seq_length)

    def prepare_learning(self) -> None:
        self.eval_dataloader = self.eval_pipeline.create_loader(self.config.train.batch_size)
        self.n_inner_epochs = 1
        n_batches = len(self.store) // self.config.train.batch_size
        self.total_steps = min(self.config.train.epochs * max(n_batches, 1), self.config.train.total_steps)

    def create_train_dataloader(self):
        return self.store.create_loader(self.config.train.batch_size, shuffle=True, drop_last=True,
                                        seed=self.config.train.seed + self._loader_iter)
