"""The preference pair store of DPO (port of
trlx_tpu.pipeline.dpo_pipeline): (prompt, chosen, rejected) triples
tokenized through the dialogue machinery SFT and ILQL use
(`tokenize_dialogue`), kept as two rows a pair and collated to one
dataset-wide width for both sides, since the trainer stacks chosen and
rejected rows into one forward."""

from __future__ import annotations

from typing import Iterable, List, Sequence

import torch

from trlx_tpu_torch.data import DPOBatch
from trlx_tpu_torch.pipeline import BaseRolloutStore, DataLoader
from trlx_tpu_torch.pipeline.offline_pipeline import _pad_id, _pad_right, tokenize_dialogue


def _pair_row(prompt: str, completion: str, tokenizer, max_length: int):
    """One side of a pair as (input_ids, response_mask): the dialogue
    tokenization marks exactly the completion tokens as outputs."""
    msgs = tokenize_dialogue([prompt, completion], tokenizer, max_length)
    ids = [t for m in msgs for t in m.tokens]
    resp = [1 if m.is_output else 0 for m in msgs for _ in m.tokens]
    if not any(resp):
        raise ValueError(
            f"preference completion tokenized to zero tokens under "
            f"max_length={max_length}: {completion!r}"
        )
    return ids, resp


class DPOPairStorage(BaseRolloutStore):
    """Offline preference dataset: each pair's chosen and rejected token
    rows with their response masks, right-padded at collation to one
    width."""

    def __init__(self, pairs: Iterable[Sequence[str]], tokenizer, max_length: int = 2048):
        super().__init__()
        self.tokenizer = tokenizer
        self.history: List[dict] = []
        for i, pair in enumerate(pairs):
            if len(pair) != 3:
                raise ValueError(
                    "DPO samples must be (prompt, chosen, rejected) "
                    f"triples; sample {i} has {len(pair)} elements"
                )
            prompt, chosen, rejected = pair
            c_ids, c_resp = _pair_row(prompt, chosen, tokenizer, max_length)
            r_ids, r_resp = _pair_row(prompt, rejected, tokenizer, max_length)
            self.history.append(dict(chosen_ids=c_ids, chosen_response=c_resp,
                                     rejected_ids=r_ids, rejected_response=r_resp))
        if not self.history:
            raise ValueError("DPO needs at least one preference pair")
        # one width for both sides: the trainer stacks [chosen; rejected]
        self.seq_width = max(max(len(h["chosen_ids"]), len(h["rejected_ids"])) for h in self.history)

    def push(self, exps):
        raise NotImplementedError("DPO storage is built once from offline preference pairs")

    def __getitem__(self, ix: int) -> dict:
        return self.history[ix]

    def __len__(self) -> int:
        return len(self.history)

    def collate(self, elems: List[dict]) -> DPOBatch:
        width, pad = self.seq_width, _pad_id(self.tokenizer)
        c_ids, c_mask = _pad_right([e["chosen_ids"] for e in elems], width, pad)
        c_resp, _ = _pad_right([e["chosen_response"] for e in elems], width, 0)
        r_ids, r_mask = _pad_right([e["rejected_ids"] for e in elems], width, pad)
        r_resp, _ = _pad_right([e["rejected_response"] for e in elems], width, 0)

        def t(x):
            return torch.tensor(x, dtype=torch.int32)

        return DPOBatch(chosen_ids=t(c_ids), chosen_attention_mask=t(c_mask), chosen_response_mask=t(c_resp),
                        rejected_ids=t(r_ids), rejected_attention_mask=t(r_mask), rejected_response_mask=t(r_resp))

    def create_loader(self, batch_size: int, shuffle: bool = True, drop_last: bool = True,
                      seed: int = 0) -> DataLoader:
        """Batches in the order `epoch_shuffle_order(len, seed)` gives when
        shuffled, the ragged tail dropped by default."""
        return DataLoader(self, batch_size, collate_fn=self.collate, shuffle=shuffle, drop_last=drop_last,
                          seed=seed)
