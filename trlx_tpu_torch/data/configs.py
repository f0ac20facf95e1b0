"""Top-level training configuration.

A schema-identical copy of trlx_tpu.data.configs: the same six sections
(method/model/optimizer/scheduler/tokenizer/train), field names and
defaults, YAML / dict round-trip, `evolve()` deep-merge and dotted-path
`update()`. The meaning of each train field is documented at its JAX
counterpart; the port reads only what its slices have reached.
"""

from __future__ import annotations

import dataclasses
import json
from copy import deepcopy
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import yaml

from trlx_tpu_torch.data.method_configs import MethodConfig, get_method


def _deep_merge(base: Dict, update: Dict) -> Dict:
    """Return a new dict: `base` recursively overridden by `update`."""
    out = deepcopy(base)
    for key, val in update.items():
        if isinstance(val, dict) and isinstance(out.get(key), dict):
            out[key] = _deep_merge(out[key], val)
        else:
            out[key] = val
    return out


def _unflatten(config: Dict[str, Any]) -> Dict[str, Any]:
    """Expand dotted keys: {"a.b.c": 1} -> {"a": {"b": {"c": 1}}}."""
    nested: Dict[str, Any] = {}
    for name, value in config.items():
        node = nested
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        if isinstance(value, dict) and not path:
            node[leaf] = _deep_merge(node.get(leaf, {}), value)
        else:
            node[leaf] = value
    return nested


class _Section:
    """Shared from_dict/to_dict for config sections with unknown-key checks."""

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(config) - known
        if unknown:
            raise ValueError(f"{cls.__name__}: unknown keys {sorted(unknown)}")
        return cls(**config)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class ModelConfig(_Section):
    """Model selection. `num_layers_unfrozen` k > 0 trains only the top k
    layers and forks the frozen hydra reference branch at n_layer - k;
    `model_extra_configs["transformer"]` holds TransformerConfig fields."""

    model_path: str
    model_arch_type: str = "causal"
    num_layers_unfrozen: int = -1
    peft_config: Any = None
    model_extra_configs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class TokenizerConfig(_Section):
    """Tokenizer selection ("byte" is the built-in ByteTokenizer)."""

    tokenizer_path: str
    padding_side: str = "left"
    truncation_side: str = "right"
    tokenizer_extra_configs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class OptimizerConfig(_Section):
    name: str
    kwargs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class SchedulerConfig(_Section):
    name: str
    kwargs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class TrainConfig(_Section):
    """Training-loop settings, field for field trlx_tpu's TrainConfig."""

    total_steps: int
    seq_length: int
    epochs: int
    batch_size: int

    checkpoint_interval: int
    eval_interval: int

    pipeline: str
    trainer: str
    trainer_kwargs: Dict[str, Any] = field(default_factory=dict)

    project_name: str = "trlx_tpu"
    run_name: Optional[str] = None
    entity_name: Optional[str] = None
    group_name: Optional[str] = None

    checkpoint_dir: str = "ckpts"
    rollout_logging_dir: Optional[str] = None
    save_best: bool = True
    save_optimizer: bool = True
    resume_from_checkpoint: Optional[str] = None
    keep_last_n: Optional[int] = None

    tracker: Optional[str] = "tensorboard"
    logging_dir: Optional[str] = None
    tags: List[str] = field(default_factory=list)

    seed: int = 1000

    minibatch_size: Optional[int] = None

    mesh: Dict[str, int] = field(default_factory=lambda: {"dp": -1, "fsdp": 1, "tp": 1, "sp": 1})
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat_policy: str = "none"
    logit_chunks: int = 0
    grads_dtype: Optional[str] = None
    profile_dir: Optional[str] = None
    profile_start: int = 2
    profile_stop: int = 5
    timing_split: bool = False
    skip_nan_updates: bool = True
    max_bad_steps: int = 3
    external_retries: int = 3
    retry_base_delay: float = 0.5
    fused_inner_loop: bool = True
    async_metrics: bool = True
    guardrails: Dict[str, Any] = field(default_factory=dict)
    resilient_io: Dict[str, Any] = field(default_factory=dict)
    elastic: Dict[str, Any] = field(default_factory=dict)
    watchdog: Dict[str, Any] = field(default_factory=dict)
    memory: Dict[str, Any] = field(default_factory=dict)
    obs: Dict[str, Any] = field(default_factory=dict)
    serve: Dict[str, Any] = field(default_factory=dict)
    chaos: Optional[Dict[str, Any]] = None


_SECTIONS: Tuple[Tuple[str, type], ...] = (
    ("model", ModelConfig),
    ("tokenizer", TokenizerConfig),
    ("optimizer", OptimizerConfig),
    ("scheduler", SchedulerConfig),
    ("train", TrainConfig),
)


@dataclass
class TRLConfig:
    """Top-level config."""

    method: MethodConfig
    model: ModelConfig
    optimizer: OptimizerConfig
    scheduler: SchedulerConfig
    tokenizer: TokenizerConfig
    train: TrainConfig

    @classmethod
    def load_yaml(cls, yml_fp: str) -> "TRLConfig":
        with open(yml_fp) as f:
            return cls.from_dict(yaml.safe_load(f))

    @classmethod
    def from_dict(cls, config: Dict[str, Any]) -> "TRLConfig":
        sections = {name: sec.from_dict(config[name]) for name, sec in _SECTIONS}
        method_cls = get_method(config["method"]["name"])
        return cls(method=method_cls.from_dict(config["method"]), **sections)

    def to_dict(self) -> Dict[str, Any]:
        data = {name: getattr(self, name).to_dict() for name, _ in _SECTIONS}
        data["method"] = self.method.to_dict()
        return data

    def evolve(self, **kwargs) -> "TRLConfig":
        """Deep-merge keyword overrides, returning a new config.

        >>> cfg.evolve(method=dict(gamma=0.99), train=dict(seed=7))
        """
        return TRLConfig.from_dict(_deep_merge(self.to_dict(), kwargs))

    @classmethod
    def update(cls, baseconfig, config: Dict[str, Any]) -> "TRLConfig":
        """Apply dotted-path overrides ("train.seed": 1), checking that
        every override path exists in the base."""
        if not isinstance(baseconfig, dict):
            baseconfig = baseconfig.to_dict()
        overrides = _unflatten(config)

        def _check(base, upd, path=""):
            for k, v in upd.items():
                if k not in base:
                    raise ValueError(f"parameter {path}{k} is not present in the config")
                if isinstance(v, dict) and isinstance(base[k], dict):
                    _check(base[k], v, f"{path}{k}.")

        _check(baseconfig, overrides)
        return cls.from_dict(_deep_merge(baseconfig, overrides))

    def __str__(self) -> str:
        return json.dumps(self.to_dict(), indent=4)
