"""Prompt pipeline (port of trlx_tpu.pipeline.offline_pipeline.PromptPipeline;
the dialogue and ILQL stores arrive with their trainers, ROADMAP queue 6).
Collation left-pads to the fixed `max_prompt_length`, so every rollout
chunk has one shape."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple, Union

import torch

from trlx_tpu_torch.data import PromptBatch
from trlx_tpu_torch.pipeline import BasePipeline, DataLoader, register_datapipeline


def _pad_id(tokenizer) -> int:
    pad = getattr(tokenizer, "pad_token_id", None)
    if pad is None:
        pad = getattr(tokenizer, "eos_token_id", 0) or 0
    return int(pad)


def _pad_left(seqs: List[List[int]], width: int, fill) -> Tuple[List[List[int]], List[List[int]]]:
    out, masks = [], []
    for s in seqs:
        s = list(s)[-width:]
        n = width - len(s)
        out.append([fill] * n + s)
        masks.append([0] * n + [1] * len(s))
    return out, masks


@register_datapipeline
class PromptPipeline(BasePipeline):
    """Tokenized prompts with pass-through metadata for the reward_fn.
    Dict prompts carry a "prompt" key; their other keys ride along to the
    reward function."""

    def __init__(
        self,
        prompts: Union[List[Dict[str, Any]], List[str]],
        max_prompt_length: int,
        tokenizer,
        add_special_tokens: bool = False,
    ):
        super().__init__()
        if prompts and isinstance(prompts[0], dict):
            metadata = [dict(x) for x in prompts]
            prompts = [x.pop("prompt") for x in metadata]
        else:
            metadata = [{}] * len(prompts)
        model_inputs = tokenizer(
            list(prompts),
            truncation=True,
            padding=False,
            max_length=max_prompt_length,
            add_special_tokens=add_special_tokens,
        )
        self.tokenizer = tokenizer
        self.max_prompt_length = max_prompt_length
        self.prompts = [
            {"input_ids": ids, "attention_mask": mask, **md}
            for ids, mask, md in zip(
                model_inputs["input_ids"], model_inputs["attention_mask"], metadata
            )
        ]

    def __getitem__(self, ix: int) -> Dict[str, Any]:
        return self.prompts[ix]

    def __len__(self) -> int:
        return len(self.prompts)

    def collate(self, xs: List[Dict[str, Any]]) -> PromptBatch:
        ids, masks = _pad_left(
            [x["input_ids"] for x in xs], self.max_prompt_length, _pad_id(self.tokenizer)
        )
        metadata = {
            key: [x[key] for x in xs]
            for key in xs[0]
            if key not in ("input_ids", "attention_mask")
        }
        return PromptBatch(
            input_ids=torch.tensor(ids, dtype=torch.int32),
            attention_mask=torch.tensor(masks, dtype=torch.int32),
            metadata=metadata or None,
        )

    def create_loader(
        self, batch_size: int, shuffle: bool = False, drop_last: bool = False, seed: int = 0
    ) -> DataLoader:
        return DataLoader(
            self, batch_size, collate_fn=self.collate, shuffle=shuffle,
            drop_last=drop_last, seed=seed,
        )
