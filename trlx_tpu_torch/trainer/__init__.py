"""Trainer registry and abstract base (port of trlx_tpu.trainer)."""

from __future__ import annotations

from abc import abstractmethod
from typing import Any, Callable, Dict, List, Optional

_TRAINERS: Dict[str, type] = {}


def register_trainer(name_or_cls):
    """Register a trainer class under its (lowercased) name (decorator).
    A different class under a taken name raises; re-registering the same
    class (a module reload) is a no-op."""

    def _register(cls, name: str):
        key = name.lower()
        existing = _TRAINERS.get(key)
        if existing is not None and (
            (existing.__module__, existing.__qualname__) != (cls.__module__, cls.__qualname__)
        ):
            raise ValueError(
                f"trainer {name!r} is already registered to "
                f"{existing.__module__}.{existing.__qualname__}"
            )
        _TRAINERS[key] = cls
        return cls

    if isinstance(name_or_cls, str):
        return lambda cls: _register(cls, name_or_cls)
    return _register(name_or_cls, name_or_cls.__name__)


class BaseRLTrainer:
    """Abstract trainer: owns model, optimizer and tokenizer and runs the
    training loop; online trainers also implement `make_experience`."""

    def __init__(
        self,
        config,
        reward_fn: Optional[Callable] = None,
        metric_fn: Optional[Callable] = None,
        stop_sequences: Optional[List[str]] = None,
        **kwargs: Any,
    ):
        self.config = config
        self.reward_fn = reward_fn
        self.metric_fn = metric_fn
        self.stop_sequences = stop_sequences or []

    def push_to_store(self, data):
        self.store.push(data)

    def add_eval_pipeline(self, eval_pipeline):
        self.eval_pipeline = eval_pipeline

    @abstractmethod
    def learn(self):
        """Run the full training loop."""
        raise NotImplementedError
