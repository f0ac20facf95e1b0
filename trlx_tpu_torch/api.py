"""`trlx_tpu_torch.train`: the user entry point (port of trlx_tpu.api.train,
online branch). The same signature selects the algorithm: `reward_fn`
gives online PPO; `rewards`/`dataset` (offline RL) and `samples` alone
(SFT) arrive with the other trainers (ROADMAP queue 6). `device` picks
where to train: the current CUDA card by default (raising when there is
none), or "cpu" for the plain paths.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import default_ppo_config
from trlx_tpu_torch.utils import set_seed
from trlx_tpu_torch.utils.loading import get_pipeline, get_trainer


def train(
    model_path: Optional[str] = None,
    reward_fn: Optional[Callable[[List[str], List[str], List[str]], List[float]]] = None,
    dataset: Optional[Iterable[Tuple[str, float]]] = None,
    samples: Optional[List[str]] = None,
    rewards: Optional[List[float]] = None,
    prompts: Optional[Union[List[str], List[Dict[str, Any]]]] = None,
    eval_prompts: Optional[Union[List[str], List[Dict[str, Any]]]] = None,
    metric_fn: Optional[Callable[[List[str], List[str], List[str]], Dict[str, List[float]]]] = None,
    config: Optional[TRLConfig] = None,
    stop_sequences: Optional[List[str]] = None,
    device=None,
):
    """Online RL (PPO) from `reward_fn(samples, prompts, outputs, **metadata)
    -> list of scalar (or per-token) rewards` and `prompts`. Returns the
    trainer after `learn()`."""
    if not reward_fn:
        raise NotImplementedError(
            "offline RL (rewards/dataset) and SFT (samples) are not ported yet "
            "(ROADMAP queue 6); pass reward_fn and prompts for online PPO"
        )
    if config is None:
        warnings.warn(
            "Passing the `config` argument implicitly is depreciated, use or "
            "adapt some from `trlx_tpu_torch/data/default_configs.py` instead"
        )
        config = default_ppo_config()
    if config.train.resume_from_checkpoint or os.environ.get("TRLX_TPU_RESUME_FROM"):
        raise NotImplementedError("resuming from a checkpoint is not ported yet (ROADMAP queue 4)")

    set_seed(config.train.seed)
    if model_path:
        config.model.model_path = model_path

    trainer = get_trainer(config.train.trainer)(
        config=config,
        reward_fn=reward_fn,
        metric_fn=metric_fn,
        stop_sequences=stop_sequences or [],
        device=device,
        **config.train.trainer_kwargs,
    )

    batch_size = config.train.batch_size
    max_prompt_length = config.train.seq_length - config.method.gen_kwargs.get("max_new_tokens", 0)
    if max_prompt_length <= 0:
        raise ValueError(
            f"train.seq_length ({config.train.seq_length}) must exceed "
            f"gen_kwargs['max_new_tokens'] ({config.method.gen_kwargs.get('max_new_tokens', 0)}): "
            "prompts would be truncated to zero tokens"
        )
    if prompts is None:
        raise ValueError("`prompts` are required for online training")
    if eval_prompts is None:
        eval_prompts = prompts[:batch_size]
    pipeline_cls = get_pipeline(config.train.pipeline)
    trainer.add_prompt_pipeline(pipeline_cls(prompts, max_prompt_length, trainer.tokenizer))
    trainer.add_eval_pipeline(pipeline_cls(eval_prompts, max_prompt_length, trainer.tokenizer))
    trainer.learn()
    return trainer
