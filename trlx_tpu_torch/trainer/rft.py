"""Rejection-sampling fine-tuning (port of trlx_tpu.trainer.rft): every
`n_improve_steps` epochs, sample `n_generations_per_prompt` continuations
a prompt and score them with the reward_fn; keep the samples at or above
a per-prompt score percentile that rises from `start_percentile` to
`end_percentile` across the improve window, dedup, and fine-tune on the
survivors with the full-sequence LM loss. One process: the reference's
multi-host sharding and gathers of the prompt pool are the identity
here."""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from trlx_tpu_torch.data import SFTBatch
from trlx_tpu_torch.data.method_configs import RFTConfig
from trlx_tpu_torch.models.wrappers import CausalLM
from trlx_tpu_torch.pipeline.offline_pipeline import DialogStore, tokenize_dialogue
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.trainer.base import TPUBaseTrainer
from trlx_tpu_torch.trainer.sft import sft_loss, sft_loss_from_hidden


def compute_thresholds(per_prompt_scores: List[List[float]], percentile: float) -> np.ndarray:
    """Per-prompt selection thresholds at the given score percentile,
    nudged above the prompt's minimum (exact-minimum scores are left out)
    but capped at its maximum (its best sample always survives: selection
    is `score >= threshold`). The bounds are each prompt's own, so a prompt
    whose scores are all equal keeps them all."""
    thresholds = np.array([np.quantile(np.asarray(s), percentile) for s in per_prompt_scores])
    mins = np.array([min(s) for s in per_prompt_scores])
    maxs = np.array([max(s) for s in per_prompt_scores])
    return np.minimum(np.maximum(thresholds, mins + 1e-3), maxs)


@register_trainer("TPURFTTrainer")
class TPURFTTrainer(TPUBaseTrainer):
    def __init__(self, config, **kwargs):
        if not isinstance(config.method, RFTConfig):
            raise ValueError("config.method must be RFTConfig")
        super().__init__(config, **kwargs)
        self.generations_per_prompt: Dict[str, List[dict]] = defaultdict(list)
        self.epoch_count = 0
        # the (prompt, output) pairs of the current store, and those a
        # checkpoint restored (the resumed run trains on the same store)
        self._store_samples: List[Tuple[str, str]] = []
        self._restored_store_samples: Optional[List[Tuple[str, str]]] = None

    def setup_model(self) -> None:
        """The bare policy: random weights from train.seed, or the base
        weights of a directory `save_pretrained` wrote."""
        if self.seq2seq:
            raise NotImplementedError("seq2seq RFT is not implemented (causal only)")
        self.model = CausalLM(self.load_base_model(), device=self.device)
        self.init_weights()

    def loss(self, batch: SFTBatch):
        """The full-sequence LM loss: every non-pad token is a label."""
        batch = batch.map(lambda x: x.to(self.device))
        chunks = self.config.train.logit_chunks
        out = self.model(batch.input_ids, batch.attention_mask, compute_logits=chunks == 0)
        labels = torch.where(batch.attention_mask > 0, batch.input_ids, torch.full_like(batch.input_ids, -100))
        if chunks:
            return sft_loss_from_hidden(out["hidden_states"], self.model.logit_project_fn(), labels, chunks)
        return sft_loss(out["logits"], labels)

    def add_prompt_pipeline(self, pipeline) -> None:
        self.prompt_dataloader = pipeline.create_loader(self.config.train.batch_size)

    def _sample_generations(self) -> List[dict]:
        """`n_generations_per_prompt` samples of every prompt batch, decoded
        with the EOS string appended to outputs that ended or were cut."""
        generations = []
        for batch in self.prompt_dataloader:
            P = batch.input_ids.shape[1]
            for _ in range(self.config.method.n_generations_per_prompt):
                sequences = self._generate_rollout(batch.input_ids, batch.attention_mask)["sequences"].cpu().numpy()
                _, str_prompts, str_outputs = self.decode(batch.input_ids.numpy(), sequences,
                                                          [P] * len(sequences), append_eos_token=True)
                generations.extend({"prompt": p, "output": o} for p, o in zip(str_prompts, str_outputs))
        return generations

    def make_experience(self, samples=None, rewards=None, seq_length=None) -> None:
        """Regenerate and rescore (every n_improve_steps epochs), then
        reselect the training set at this epoch's percentile."""
        method = self.config.method
        if self.epoch_count % method.n_improve_steps == 0:
            generations = self._sample_generations()
            scores = self._call_reward_fn(
                samples=[g["prompt"] + g["output"] for g in generations],
                prompts=[g["prompt"] for g in generations],
                outputs=[g["output"] for g in generations],
            )
            for g, s in zip(generations, scores):
                self.generations_per_prompt[g["prompt"]].append({"output": g["output"], "score": float(s)})

        per_prompt_scores = [[x["score"] for x in self.generations_per_prompt[p]]
                             for p in self.generations_per_prompt]
        percentile_delta = (method.end_percentile - method.start_percentile) / method.n_improve_steps
        percentile = method.start_percentile + percentile_delta * (self.epoch_count % method.n_improve_steps)
        thresholds = compute_thresholds(per_prompt_scores, percentile)

        samples_selected = []
        for prompt, threshold in zip(self.generations_per_prompt, thresholds):
            for x in self.generations_per_prompt[prompt]:
                if x["score"] >= threshold:
                    samples_selected.append((prompt, x["output"]))
        samples_selected = sorted(set(samples_selected))

        self._log_stats({"scores_mean": float(np.mean(np.hstack(per_prompt_scores))),
                         "len_samples_selected": len(samples_selected), "percentile": float(percentile)},
                        step=self.iter_count)

        if samples_selected:
            # wrap-pad to whole batches, so every train batch has one shape
            bs = self.config.train.batch_size
            target = -(-len(samples_selected) // bs) * bs
            i = 0
            while len(samples_selected) < target:
                samples_selected.append(samples_selected[i])
                i += 1
            self._build_store(samples_selected)

    def _build_store(self, samples: List[Tuple[str, str]]) -> None:
        seq_length = self.config.train.seq_length
        dialogs = [tokenize_dialogue(list(pair), self.tokenizer, seq_length) for pair in samples]
        # one width across improve rounds
        self.store = DialogStore(dialogs, self.tokenizer, max_length=seq_length)
        self._store_samples = [tuple(pair) for pair in samples]

    def prepare_learning(self) -> None:
        self.eval_dataloader = self.eval_pipeline.create_loader(self.config.train.batch_size)
        self.n_inner_epochs = 1
        self.total_steps = self.config.train.total_steps
        if self._restored_store_samples is not None:
            # resumed: the store the killed run was training on
            self._build_store(self._restored_store_samples)
            self._restored_store_samples = None
            return
        self.epoch_count = 0
        self.make_experience()

    # -- resumable state: the improve rounds' scores and the current store

    def _extra_state(self) -> Dict[str, Any]:
        return {"rft": {"epoch_count": self.epoch_count,
                        "generations_per_prompt": dict(self.generations_per_prompt),
                        "store_samples": [list(pair) for pair in self._store_samples]}}

    def _restore_extra_state(self, state: Dict[str, Any]) -> None:
        rft = state.get("rft")
        if rft:
            self.epoch_count = rft["epoch_count"]
            self.generations_per_prompt = defaultdict(list, rft["generations_per_prompt"])
            self._restored_store_samples = [tuple(pair) for pair in rft["store_samples"]]

    def create_train_dataloader(self):
        return self.store.create_loader(self.config.train.batch_size, shuffle=True,
                                        seed=self.config.train.seed + self._loader_iter)

    def post_epoch_callback(self) -> None:
        self.epoch_count += 1
        self.make_experience()
