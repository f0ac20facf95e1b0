"""Rollout storage of the online trainers (port of
trlx_tpu.pipeline.ppo_pipeline). Rollouts are born rectangular, so the
store is one rollout batch (`PPORolloutBatch`, or GRPO's
`GRPORolloutBatch`) whose tensors stay on the device they were made on; a
minibatch is a gather of its rows by a host-drawn permutation."""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from trlx_tpu_torch.data import PPORolloutBatch
from trlx_tpu_torch.pipeline import BaseRolloutStore, DataLoader


class PPORolloutStorage(BaseRolloutStore):
    """Experience buffer of rollouts (pushed as PPORolloutBatch or
    GRPORolloutBatch, one type a store)."""

    def __init__(self, pad_token_id: int = 0):
        super().__init__()
        self.pad_token_id = pad_token_id
        self.history: Optional[PPORolloutBatch] = None

    def push(self, exps) -> None:
        """Append a chunk's rows: every field the chunk holds (not None) is
        concatenated onto the store's."""
        if self.history is None:
            self.history = exps
            return
        if type(exps) is not type(self.history):
            raise TypeError(f"cannot push a {type(exps).__name__} onto a store of {type(self.history).__name__}")
        self.history = self.history.replace(**{
            f.name: torch.cat([getattr(self.history, f.name), v], dim=0)
            for f in dataclasses.fields(exps) if (v := getattr(exps, f.name)) is not None
        })

    def clear_history(self) -> None:
        self.history = None

    def __len__(self) -> int:
        return 0 if self.history is None else len(self.history.query_tensors)

    def __getitem__(self, ix: int) -> PPORolloutBatch:
        return self.history.map(lambda x: x[ix])

    def export_history(self, location: str, tokenizer=None) -> None:
        """Dump the rollouts as `<location>/epoch-<time>.json`: per row the
        query and response tokens, the float fields the store holds, and
        with a tokenizer the decoded query and response."""
        os.makedirs(location, exist_ok=True)
        fpath = os.path.join(location, f"epoch-{str(time.time())}.json")
        history = self.history.map(lambda x: x.cpu().numpy())

        def exp_to_dict(i: int):
            d = {"query_tensor": history.query_tensors[i].tolist(),
                 "response_tensor": history.response_tensors[i].tolist()}
            for fname in ("logprobs", "values", "rewards", "ref_logprobs", "advantages"):
                field = getattr(history, fname, None)
                if field is not None:
                    d[fname] = field[i].tolist()
            if tokenizer is not None:
                d["query"] = tokenizer.decode(d["query_tensor"])
                d["response"] = tokenizer.decode(d["response_tensor"])
            return d

        with open(fpath, "w") as f:
            json.dump([exp_to_dict(i) for i in range(len(self))], f)

    def create_loader(
        self, batch_size: int, shuffle: bool = False, drop_last: bool = False, seed: int = 0
    ) -> DataLoader:
        """Minibatches as row gathers of the store, in `DataLoader`'s order
        (the first iteration is `epoch_shuffle_order(n, seed)`; later ones
        continue the generator stream)."""
        history = self.history
        device = history.query_tensors.device

        def gather(rows):
            ix = torch.as_tensor(np.asarray(rows), device=device)
            return history.map(lambda x: x[ix])

        return DataLoader(range(len(self)), batch_size, gather, shuffle, drop_last, seed)
