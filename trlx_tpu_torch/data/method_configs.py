"""Method (algorithm) hyperparameter configs and their registry.

A schema-identical copy of trlx_tpu.data.method_configs (PPO, GRPO, SFT,
ILQL, RFT, DPO), so a YAML config loads to the same dict in both packages.
The loss functions live with their trainers.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

_METHODS: Dict[str, type] = {}


def register_method(name_or_cls):
    """Register a method config class under a lowercase name (decorator).
    A different class under a taken name raises; re-registering the same
    class is a no-op (module reloads)."""

    def _register(cls, name: str):
        key = name.lower()
        existing = _METHODS.get(key)
        if existing is not None and (
            (existing.__module__, existing.__qualname__)
            != (cls.__module__, cls.__qualname__)
        ):
            raise ValueError(
                f"method config {name!r} is already registered to "
                f"{existing.__module__}.{existing.__qualname__}"
            )
        _METHODS[key] = cls
        return cls

    if isinstance(name_or_cls, str):
        return lambda cls: _register(cls, name_or_cls)
    return _register(name_or_cls, name_or_cls.__name__)


def get_method(name: str) -> type:
    try:
        return _METHODS[name.lower()]
    except KeyError:
        raise ValueError(
            f"Unknown method {name!r}; registered: {sorted(_METHODS)}"
        ) from None


def _fields_only(cls, config: Dict[str, Any]) -> Dict[str, Any]:
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(config) - known
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown config keys {sorted(unknown)}")
    return dict(config)


@dataclass
@register_method
class MethodConfig:
    """Base config for an RL method; `name` selects the registry entry."""

    name: str

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        return cls(**_fields_only(cls, config))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
@register_method
class PPOConfig(MethodConfig):
    """PPO hyperparameters; field for field the reference's PPOConfig.
    The rollout path reads `gen_kwargs`; the rest serves the trainer."""

    ppo_epochs: int = 4
    num_rollouts: int = 128
    chunk_size: int = 128
    init_kl_coef: float = 0.05
    target: Optional[float] = None
    horizon: int = 10000
    gamma: float = 1.0
    lam: float = 0.95
    cliprange: float = 0.2
    cliprange_value: float = 0.2
    vf_coef: float = 1.0
    scale_reward: Optional[str] = "ignored"
    ref_mean: Optional[float] = None
    ref_std: Optional[float] = None
    cliprange_reward: float = 10.0
    gen_kwargs: dict = field(default_factory=lambda: dict(max_new_tokens=40))
    gen_experience_kwargs: Optional[dict] = None
    num_value_layers_unfrozen: int = 0
    overlap_rollouts: bool = False
    gen_engine: dict = field(default_factory=dict)
    exp: dict = field(default_factory=dict)
    fleet: dict = field(default_factory=dict)


@dataclass
@register_method
class GRPOConfig(MethodConfig):
    """GRPO hyperparameters; field for field the reference's GRPOConfig.
    `group_size` samples a prompt, each one's advantage the z-score of
    its reward within its group; `chunk_size / group_size` prompts are
    pulled a chunk, so a group's members are consecutive rows of one
    chunk. The KL regulariser sits in the loss (`kl_coef`). The
    `overlap_rollouts` and `gen_engine` knobs carry PPO's semantics."""

    group_size: int = 8
    grpo_epochs: int = 4
    num_rollouts: int = 128
    chunk_size: int = 128
    kl_coef: float = 0.001
    cliprange: float = 0.2
    scale_reward: Optional[str] = "ignored"
    ref_mean: Optional[float] = None
    ref_std: Optional[float] = None
    cliprange_reward: float = 10.0
    gen_kwargs: dict = field(default_factory=lambda: dict(max_new_tokens=40))
    gen_experience_kwargs: Optional[dict] = None
    overlap_rollouts: bool = False
    gen_engine: dict = field(default_factory=dict)
    exp: dict = field(default_factory=dict)
    fleet: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.group_size < 2:
            raise ValueError(
                f"grpo.group_size must be >= 2 (got {self.group_size}): a "
                "group of one has no relative baseline"
            )
        if self.chunk_size % self.group_size:
            raise ValueError(
                f"grpo.chunk_size {self.chunk_size} must be divisible by "
                f"group_size {self.group_size} (whole groups per chunk)"
            )
        if self.num_rollouts % self.chunk_size:
            raise ValueError(
                f"grpo.num_rollouts {self.num_rollouts} must be divisible "
                f"by chunk_size {self.chunk_size}: a partial final chunk "
                "would split a group across cycles"
            )


@dataclass
@register_method
class DPOConfig(MethodConfig):
    """DPO hyperparameters; field for field the reference's DPOConfig.
    `beta` scales the implicit reward; `label_smoothing` is the
    conservative-DPO probability that a preference label is flipped."""

    beta: float = 0.1
    label_smoothing: float = 0.0
    gen_kwargs: dict = field(default_factory=lambda: dict(max_new_tokens=40))

    def __post_init__(self):
        if self.beta <= 0:
            raise ValueError(f"dpo.beta must be > 0 (got {self.beta})")
        if not 0.0 <= self.label_smoothing < 0.5:
            raise ValueError(
                "dpo.label_smoothing must be in [0, 0.5) (got "
                f"{self.label_smoothing}): past 0.5 the labels invert"
            )


@dataclass
@register_method
class SFTConfig(MethodConfig):
    """SFT hyperparameters; field for field the reference's SFTConfig."""

    gen_kwargs: dict = field(default_factory=lambda: dict(max_new_tokens=40))


@dataclass
@register_method
class ILQLConfig(MethodConfig):
    """ILQL hyperparameters; field for field the reference's ILQLConfig.
    `gen_kwargs["beta"]` (a scalar, or a list that evaluation sweeps) is
    the advantage-shaping weight of the sampler's logits processor."""

    tau: float = 0.7
    gamma: float = 0.99
    cql_scale: float = 0.1
    awac_scale: float = 1.0
    alpha: float = 0.001
    beta: float = 0.0
    steps_for_target_q_sync: int = 5
    two_qs: bool = True
    gen_kwargs: dict = field(default_factory=lambda: dict(max_new_tokens=56, top_k=20, beta=1.0))


@dataclass
@register_method
class RFTConfig(MethodConfig):
    """Rejection-sampling fine-tuning; field for field the reference's
    RFTConfig."""

    gen_kwargs: dict = field(default_factory=lambda: dict(max_new_tokens=40))
    start_percentile: float = 0.7
    end_percentile: float = 0.95
    n_improve_steps: int = 4
    n_generations_per_prompt: int = 32
