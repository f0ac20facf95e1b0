"""Supervised fine-tuning (port of trlx_tpu.trainer.sft): the shifted
cross-entropy over the output tokens of (prompt, output) dialogues or
plain strings, on the bare causal LM. The store is a `DialogStore`; the
loop, evaluation and `save_pretrained` are the base trainer's."""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from trlx_tpu_torch.data import SFTBatch
from trlx_tpu_torch.data.method_configs import SFTConfig
from trlx_tpu_torch.models.wrappers import CausalLM
from trlx_tpu_torch.ops.common import chunked_logprobs, logprobs_of_labels
from trlx_tpu_torch.pipeline.offline_pipeline import DialogStore, tokenize_dialogue
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.trainer.base import TPUBaseTrainer


def _masked_nll(logprobs_fn, labels: torch.Tensor):
    """Mean negative log-likelihood over the batch's counted labels (label
    -100 = ignored), from `logprobs_fn(safe_labels)` of the shifted
    labels; the mean runs over all counted tokens, not per row."""
    labels = labels[:, 1:]
    mask = (labels != -100).float()
    lp = logprobs_fn(torch.where(labels == -100, torch.zeros_like(labels), labels))
    loss = -(lp * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss, {"losses/loss": loss, "perplexity": torch.exp(loss)}


def sft_loss(logits: torch.Tensor, labels: torch.Tensor):
    """Shifted cross-entropy from logits [B, T, V]; label -100 = ignored."""
    return _masked_nll(lambda safe: logprobs_of_labels(logits[:, :-1], safe), labels)


def sft_loss_from_hidden(hidden: torch.Tensor, project_fn, labels: torch.Tensor, n_chunks: int):
    """`sft_loss` without the [B, T, V] logits: per-token logprobs from a
    checkpointed chunk loop over the sequence (`chunked_logprobs`), the
    train.logit_chunks path."""
    return _masked_nll(lambda safe: chunked_logprobs(project_fn, hidden[:, :-1], safe, n_chunks), labels)


@register_trainer("TPUSFTTrainer")
class TPUSFTTrainer(TPUBaseTrainer):
    def __init__(self, config, **kwargs):
        if not isinstance(config.method, SFTConfig):
            raise ValueError("config.method must be SFTConfig")
        super().__init__(config, **kwargs)

    def setup_model(self) -> None:
        """The bare policy: random weights from train.seed, or the base
        weights of a directory `save_pretrained` wrote."""
        if self.seq2seq:
            raise NotImplementedError("seq2seq SFT is not implemented (causal only)")
        self.model = CausalLM(self.load_base_model(), device=self.device)
        self.init_weights()

    def loss(self, batch: SFTBatch):
        batch = batch.map(lambda x: x.to(self.device))
        chunks = self.config.train.logit_chunks
        out = self.model(batch.input_ids, batch.attention_mask, compute_logits=chunks == 0)
        if chunks:
            return sft_loss_from_hidden(out["hidden_states"], self.model.logit_project_fn(), batch.labels, chunks)
        return sft_loss(out["logits"], batch.labels)

    def make_experience(
        self,
        samples: Union[List[str], List[tuple], List[list]],
        rewards: Optional[List[float]] = None,
        seq_length: int = 1024,
    ) -> None:
        """Tokenize the samples (plain strings or alternating prompt/output
        dialogues) into the store; SFT ignores rewards."""
        del rewards
        dialogs = [tokenize_dialogue(s, self.tokenizer, seq_length) for s in samples]
        self.store = DialogStore(dialogs, self.tokenizer, max_length=seq_length)

    def prepare_learning(self) -> None:
        self.eval_dataloader = self.eval_pipeline.create_loader(self.config.train.batch_size)
        self.n_inner_epochs = 1
        n_batches = len(self.store) // self.config.train.batch_size
        self.total_steps = min(self.config.train.epochs * max(n_batches, 1), self.config.train.total_steps)

    def create_train_dataloader(self):
        return self.store.create_loader(
            self.config.train.batch_size, shuffle=True, seed=self.config.train.seed + self._loader_iter
        )
