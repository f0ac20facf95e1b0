"""Prompt pipeline, the SFT dialogue store and the ILQL stores (port of
trlx_tpu.pipeline.offline_pipeline: PromptPipeline, tokenize_dialogue,
DialogStore, ILQLRolloutStorage, ILQLSeq2SeqRolloutStorage). Prompt
collation left-pads to the fixed `max_prompt_length`, so every rollout
chunk has one shape; dialogue collation right-pads to the store's
`max_length`; the ILQL stores right-pad every field to its dataset-wide
width."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import torch

from trlx_tpu_torch.data import ILQLBatch, ILQLSeq2SeqBatch, PromptBatch, SFTBatch
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


def _pad_right(seqs: List[List], width: int, fill, repeat_last: bool = False) -> Tuple[List[List], List[List[int]]]:
    """Right-pad (and cut) to `width` with `fill`, or with each row's last
    entry (`repeat_last`)."""
    out, masks = [], []
    for s in seqs:
        s = list(s)[:width]
        n = width - len(s)
        pad_val = (s[-1] if s else 0) if repeat_last else fill
        out.append(s + [pad_val] * n)
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


def _ilql_index_fields(elems: List[dict], actions_width: int, states_width: int) -> Dict[str, torch.Tensor]:
    """The rewards, gather indices and dones of an ILQL batch. The indices
    pad by REPEATING each row's last real index (not 0): a repeated
    terminal state is inert under the dones mask, while index 0 would
    gather unrelated positions into the loss."""
    rewards, _ = _pad_right([e["rewards"] for e in elems], actions_width, 0.0)
    actions, _ = _pad_right([e["actions_ixs"] for e in elems], actions_width, None, repeat_last=True)
    states, _ = _pad_right([e["states_ixs"] for e in elems], states_width, None, repeat_last=True)
    dones, _ = _pad_right([e["dones"] for e in elems], states_width, 0)
    return dict(
        rewards=torch.tensor(rewards, dtype=torch.float32),
        states_ixs=torch.tensor(states, dtype=torch.int32),
        actions_ixs=torch.tensor(actions, dtype=torch.int32),
        dones=torch.tensor(dones, dtype=torch.int32),
    )


class _ILQLStore(BaseRolloutStore):
    """Offline ILQL data, built once: per-sample lists under `fields`,
    collated to dataset-wide static widths."""

    def __init__(self, **fields):
        super().__init__()
        self.fields = fields
        self.history = fields["input_ids"]
        self.actions_width = max(len(x) for x in fields["actions_ixs"])
        self.states_width = max(len(x) for x in fields["states_ixs"])

    def push(self, exps):
        raise NotImplementedError("ILQL storage is built once from offline data")

    def __getitem__(self, ix: int) -> Dict[str, Any]:
        return {k: v[ix] for k, v in self.fields.items()}

    def __len__(self) -> int:
        return len(self.history)

    def create_loader(self, batch_size: int, shuffle: bool = True, drop_last: bool = True,
                      seed: int = 0) -> DataLoader:
        """Batches in the order `epoch_shuffle_order(len, seed)` gives when
        shuffled, the ragged tail dropped by default."""
        return DataLoader(self, batch_size, collate_fn=self.collate, shuffle=shuffle, drop_last=drop_last,
                          seed=seed)


class ILQLRolloutStorage(_ILQLStore):
    """Offline ILQL dataset for causal models: token ids, the return on the
    final action, and the state / action indices into the sequence."""

    def __init__(self, input_ids, attention_mask, rewards, states_ixs, actions_ixs, dones):
        super().__init__(input_ids=input_ids, attention_mask=attention_mask, rewards=rewards,
                         states_ixs=states_ixs, actions_ixs=actions_ixs, dones=dones)
        self.seq_width = max(len(x) for x in input_ids)

    def collate(self, elems: List[dict]) -> ILQLBatch:
        ids, _ = _pad_right([e["input_ids"] for e in elems], self.seq_width, 0)
        mask, _ = _pad_right([e["attention_mask"] for e in elems], self.seq_width, 0)
        return ILQLBatch(
            input_ids=torch.tensor(ids, dtype=torch.int32),
            attention_mask=torch.tensor(mask, dtype=torch.int32),
            **_ilql_index_fields(elems, self.actions_width, self.states_width),
        )


class ILQLSeq2SeqRolloutStorage(_ILQLStore):
    """Offline ILQL dataset for encoder-decoder models: the encoder prompt,
    the decoder rows ([decoder start] ++ output) and indices over decoder
    positions."""

    def __init__(self, input_ids, attention_mask, decoder_input_ids, rewards, states_ixs, actions_ixs, dones):
        super().__init__(input_ids=input_ids, attention_mask=attention_mask, decoder_input_ids=decoder_input_ids,
                         rewards=rewards, states_ixs=states_ixs, actions_ixs=actions_ixs, dones=dones)
        self.enc_width = max(len(x) for x in input_ids)
        self.dec_width = max(len(x) for x in decoder_input_ids)

    def collate(self, elems: List[dict]) -> ILQLSeq2SeqBatch:
        ids, _ = _pad_right([e["input_ids"] for e in elems], self.enc_width, 0)
        mask, _ = _pad_right([e["attention_mask"] for e in elems], self.enc_width, 0)
        dec, _ = _pad_right([e["decoder_input_ids"] for e in elems], self.dec_width, 0)
        return ILQLSeq2SeqBatch(
            input_ids=torch.tensor(ids, dtype=torch.int32),
            attention_mask=torch.tensor(mask, dtype=torch.int32),
            decoder_input_ids=torch.tensor(dec, dtype=torch.int32),
            **_ilql_index_fields(elems, self.actions_width, self.states_width),
        )
