"""Pipeline registry, base classes, dataloading and microbatching (port of
trlx_tpu.pipeline). Batches are dataclasses or dicts of tensors; the
loader is a thin host-side batcher whose shuffles come from numpy, so its
orders equal the reference's index for index."""

from __future__ import annotations

import dataclasses
from abc import abstractmethod
from typing import Any, Callable, Dict, Iterator, List, Sequence

import numpy as np
import torch

from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

_DATAPIPELINE: Dict[str, type] = {}


def register_datapipeline(name_or_cls):
    """Register a pipeline class under its (lowercased) name (decorator)."""

    def _register(cls, name: str):
        _DATAPIPELINE[name.lower()] = cls
        return cls

    if isinstance(name_or_cls, str):
        return lambda cls: _register(cls, name_or_cls)
    return _register(name_or_cls, name_or_cls.__name__)


def epoch_shuffle_order(n: int, seed: int) -> np.ndarray:
    """THE shuffled index order for one epoch over `n` rows: the host
    DataLoader's first iteration, the rollout store's loader and the
    trainer's per-epoch minibatch permutations all consume it."""
    order = np.arange(n)
    np.random.default_rng(seed).shuffle(order)
    return order


class DataLoader:
    """Minimal host-side batcher over an indexable dataset: yields
    `collate_fn([items...])` over shuffled or sequential index order.
    Deterministic given `seed`: the FIRST iteration consumes
    `epoch_shuffle_order(n, seed)`; later iterations of the same loader
    continue the generator stream."""

    def __init__(
        self,
        dataset: Sequence,
        batch_size: int,
        collate_fn: Callable[[List[Any]], Any] = None,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or (lambda items: items)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Any]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idxs = order[start:start + self.batch_size]
            if self.drop_last and len(idxs) < self.batch_size:
                return
            yield self.collate_fn([self.dataset[int(i)] for i in idxs])


class BasePipeline:
    """Indexable dataset + loader factory."""

    def __init__(self, path: str = "dataset"):
        self.path = path

    @abstractmethod
    def __getitem__(self, index: int):
        raise NotImplementedError

    @abstractmethod
    def __len__(self) -> int:
        raise NotImplementedError

    @abstractmethod
    def create_loader(self, batch_size: int, shuffle: bool = False) -> DataLoader:
        raise NotImplementedError


class BaseRolloutStore:
    """Experience buffer."""

    def __init__(self, capacity: int = -1):
        self.history = None
        self.capacity = capacity

    @abstractmethod
    def push(self, exps):
        raise NotImplementedError

    @abstractmethod
    def __getitem__(self, index: int):
        raise NotImplementedError

    def __len__(self) -> int:
        return len(self.history)

    @abstractmethod
    def create_loader(self, batch_size: int, shuffle: bool = False) -> DataLoader:
        raise NotImplementedError


def _slice_rows(batch, start: int, stop: int):
    """Rows [start, stop) of every tensor of a batch (dataclass, dict or
    tensor)."""
    if isinstance(batch, torch.Tensor):
        return batch[start:stop]
    if isinstance(batch, dict):
        return {k: _slice_rows(v, start, stop) for k, v in batch.items()}
    if dataclasses.is_dataclass(batch):
        return dataclasses.replace(batch, **{
            f.name: _slice_rows(getattr(batch, f.name), start, stop)
            for f in dataclasses.fields(batch)
            if isinstance(getattr(batch, f.name), (torch.Tensor, dict))
        })
    return batch


def _batch_len(batch) -> int:
    if isinstance(batch, torch.Tensor):
        return len(batch)
    values = batch.values() if isinstance(batch, dict) else (
        getattr(batch, f.name) for f in dataclasses.fields(batch)
    )
    for v in values:
        if isinstance(v, torch.Tensor):
            return len(v)
    raise ValueError("empty batch")


class MiniBatchIterator:
    """Split each dataloader batch into `num_mb` microbatches of `mb_size`
    for gradient accumulation, warning on a ragged tail."""

    def __init__(self, data_loader, mb_size: int, num_mb: int):
        self.data_loader = iter(data_loader)
        self.mb_size = mb_size
        self.num_mb = num_mb

    def __iter__(self):
        return self

    def __next__(self) -> List[Any]:
        batch = next(self.data_loader)
        batch_len = _batch_len(batch)
        minibatches = []
        for i in range(self.num_mb):
            start, stop = i * self.mb_size, (i + 1) * self.mb_size
            if start >= batch_len:
                logger.warning(
                    "ragged batch: %d samples < %d microbatches x %d; "
                    "dropping empty tail", batch_len, self.num_mb, self.mb_size,
                )
                break
            minibatches.append(_slice_rows(batch, start, min(stop, batch_len)))
        if not minibatches:
            raise StopIteration
        return minibatches
