"""Prompt pipeline and the SFT dialogue store (port of
trlx_tpu.pipeline.offline_pipeline: PromptPipeline, tokenize_dialogue,
DialogStore; the ILQL stores arrive with their trainer, ROADMAP queue 6).
Prompt collation left-pads to the fixed `max_prompt_length`, so every
rollout chunk has one shape; dialogue collation right-pads to the store's
`max_length`."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import torch

from trlx_tpu_torch.data import PromptBatch, SFTBatch
from trlx_tpu_torch.pipeline import BasePipeline, BaseRolloutStore, DataLoader, register_datapipeline


@dataclass
class DialogMessage:
    """One message in an interleaved (prompt, output, ...) dialogue."""

    is_output: bool
    tokens: Tuple[int, ...]


def tokenize_dialogue(
    dialogue: Union[str, Iterable[str]], tokenizer, max_length: int = 2048
) -> List[DialogMessage]:
    """Tokenize an interleaved dialogue, truncating whole-message-aware
    from the tokenizer's truncation side, with a leading BOS before a
    first output and a trailing EOS (appended when the last message does
    not already end with it)."""
    if isinstance(dialogue, str):
        bos = tokenizer.bos_token or tokenizer.eos_token
        dialogue = [bos, dialogue]
    else:
        dialogue = list(dialogue)
        if len(dialogue) % 2 != 0:
            raise ValueError(
                "Dialogue must have an even number of phrases, alternating prompt and output"
            )
    if not dialogue[-1].endswith(tokenizer.eos_token):
        dialogue = dialogue[:-1] + [dialogue[-1] + tokenizer.eos_token]

    msgs = [
        DialogMessage(
            is_output=i % 2 == 1,
            tokens=tuple(tokenizer(dialogue[i], add_special_tokens=False)["input_ids"]),
        )
        for i in range(len(dialogue))
    ]

    truncate_left = tokenizer.truncation_side == "left"
    if truncate_left:  # flip so truncation is always "keep a prefix"
        msgs = [DialogMessage(m.is_output, m.tokens[::-1]) for m in msgs[::-1]]

    budget = max_length
    kept: List[DialogMessage] = []
    for m in msgs:
        kept.append(DialogMessage(m.is_output, m.tokens[:max(budget, 0)]))
        budget -= len(m.tokens)

    if truncate_left:
        kept = [DialogMessage(m.is_output, m.tokens[::-1]) for m in kept[::-1]]
    kept = [m for m in kept if len(m.tokens) > 0]

    if kept and kept[0].is_output:
        # make room for the BOS the model must see before the first output
        if sum(len(m.tokens) for m in kept) == max_length:
            if truncate_left:
                kept[0] = DialogMessage(kept[0].is_output, kept[0].tokens[1:])
            else:
                kept[-1] = DialogMessage(kept[-1].is_output, kept[-1].tokens[:-1])
        kept.insert(0, DialogMessage(False, (tokenizer.bos_token_id,)))
    return kept


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


def _pad_right(seqs: List[List[int]], width: int, fill) -> Tuple[List[List[int]], List[List[int]]]:
    out, masks = [], []
    for s in seqs:
        s = list(s)[:width]
        n = width - len(s)
        out.append(s + [fill] * n)
        masks.append([1] * len(s) + [0] * n)
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


class DialogStore(BaseRolloutStore):
    """The SFT store over tokenized dialogues: labels mask the non-output
    tokens with -100, and collation right-pads to `max_length` (the pad id
    in the ids, -100 in the labels)."""

    def __init__(self, dialogs: List[List[DialogMessage]], tokenizer, max_length: Optional[int] = None):
        super().__init__()
        self.tokenizer = tokenizer
        self.history = []
        for d in dialogs:
            ids = [t for m in d for t in m.tokens]
            labels = [t if m.is_output else -100 for m in d for t in m.tokens]
            self.history.append({"input_ids": ids, "attention_mask": [1] * len(ids), "labels": labels})
        self.max_length = max_length or max((len(h["input_ids"]) for h in self.history), default=1)

    def push(self, exps):
        self.history.extend(exps)

    def __getitem__(self, ix: int):
        return self.history[ix]

    def collate(self, elems: List[dict]) -> SFTBatch:
        ids, masks = _pad_right([e["input_ids"] for e in elems], self.max_length, _pad_id(self.tokenizer))
        labels, _ = _pad_right([e["labels"] for e in elems], self.max_length, -100)
        return SFTBatch(
            input_ids=torch.tensor(ids, dtype=torch.int32),
            attention_mask=torch.tensor(masks, dtype=torch.int32),
            labels=torch.tensor(labels, dtype=torch.int32),
        )

    def create_loader(self, batch_size: int, shuffle: bool = False, seed: int = 0) -> DataLoader:
        """Batches in the order `epoch_shuffle_order(len, seed)` gives when
        shuffled; the last batch is short when the store does not divide."""
        return DataLoader(self, batch_size, collate_fn=self.collate, shuffle=shuffle, seed=seed)
