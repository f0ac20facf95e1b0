"""PPO rollout storage (port of trlx_tpu.pipeline.ppo_pipeline). Rollouts
are born rectangular, so the store is one `PPORolloutBatch` whose tensors
stay on the device they were made on; a minibatch is a gather of its rows
by a host-drawn permutation."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from trlx_tpu_torch.data import PPORolloutBatch
from trlx_tpu_torch.pipeline import BaseRolloutStore, DataLoader


class PPORolloutStorage(BaseRolloutStore):
    """Experience buffer of PPO rollouts (pushed as PPORolloutBatch)."""

    def __init__(self, pad_token_id: int = 0):
        super().__init__()
        self.pad_token_id = pad_token_id
        self.history: Optional[PPORolloutBatch] = None

    def push(self, exps: PPORolloutBatch) -> None:
        if self.history is None:
            self.history = exps
            return
        self.history = self.history.replace(**{
            name: torch.cat([getattr(self.history, name), getattr(exps, name)], dim=0)
            for name in ("query_tensors", "response_tensors", "logprobs", "values",
                         "rewards", "response_mask")
        })

    def clear_history(self) -> None:
        self.history = None

    def __len__(self) -> int:
        return 0 if self.history is None else len(self.history.query_tensors)

    def __getitem__(self, ix: int) -> PPORolloutBatch:
        return self.history.map(lambda x: x[ix])

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
