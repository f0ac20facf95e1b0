"""`trlx_tpu_torch.train`: the user entry point (port of trlx_tpu.api.train).
The same signature selects the algorithm: `reward_fn` gives online PPO
(or RFT with `train.trainer="TPURFTTrainer"`, GRPO with
"TPUGRPOTrainer"), `samples` with `rewards` (or `dataset`, a (samples,
rewards) pair) offline ILQL, `samples` alone supervised fine-tuning (or
DPO with "TPUDPOTrainer", the samples (prompt, chosen, rejected)
triples). `train.resume_from_checkpoint` (or the TRLX_TPU_RESUME_FROM
environment variable, which overrides it) resumes: "auto" takes the newest
committed checkpoint with training state under `train.checkpoint_dir`
(a fresh start when there is none), a path loads that checkpoint. `device`
picks where to train: the current CUDA card by default (raising when there
is none), or "cpu" for the plain paths.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import default_ilql_config, default_ppo_config, default_sft_config
from trlx_tpu_torch.utils import logging, set_seed
from trlx_tpu_torch.utils.checkpointing import CheckpointCorruptError
from trlx_tpu_torch.utils.loading import get_pipeline, get_trainer

logger = logging.get_logger(__name__)


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
    """Online RL (PPO, or RFT or GRPO by the config's trainer) from
    `reward_fn(samples, prompts, outputs, **metadata) -> list of scalar (or
    per-token) rewards` and `prompts`; offline ILQL from `samples` and one
    scalar reward each (`rewards`, or `dataset=(samples, rewards)`);
    supervised fine-tuning from `samples` alone (strings, or alternating
    prompt / output dialogues), or DPO by the config's trainer (`samples`
    as (prompt, chosen, rejected) triples). `stop_sequences` cuts each decoded output
    at the first occurrence of any of them (PPO then re-tokenises the cut
    outputs and scores those tokens). Returns the trainer after
    `learn()`."""
    if dataset is not None:
        # split before the implicit config, so that a dataset selects ILQL
        # as `rewards` does
        warnings.warn("the `dataset` argument is being depreciated, split it into `samples` and `rewards` instead")
        samples, rewards = dataset
    if config is None:
        warnings.warn(
            "Passing the `config` argument implicitly is depreciated, use or "
            "adapt some from `trlx_tpu_torch/data/default_configs.py` instead"
        )
        if reward_fn:
            config = default_ppo_config()
        elif rewards:
            config = default_ilql_config()
        else:
            config = default_sft_config()
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
    pipeline_cls = get_pipeline(config.train.pipeline)
    if reward_fn:
        if prompts is None:
            raise ValueError("`prompts` are required for online training")
        if eval_prompts is None:
            eval_prompts = prompts[:batch_size]
        trainer.add_prompt_pipeline(pipeline_cls(prompts, max_prompt_length, trainer.tokenizer))
    elif rewards is not None:
        if samples is None:
            raise ValueError("`samples` are required alongside `rewards`")
        if eval_prompts is None:
            eval_prompts = [trainer.tokenizer.bos_token] * batch_size
        trainer.make_experience(samples, rewards, config.train.seq_length)
    else:
        if samples is None:
            raise ValueError("Either `samples`, `rewards` or `reward_fn` must be given")
        if eval_prompts is None:
            eval_prompts = [trainer.tokenizer.bos_token] * batch_size
        trainer.make_experience(samples, None, config.train.seq_length)
    trainer.add_eval_pipeline(pipeline_cls(eval_prompts, max_prompt_length, trainer.tokenizer))
    resume(trainer, config)
    trainer.learn()
    return trainer


def resume(trainer, config: TRLConfig) -> None:
    """Load the checkpoint that `train.resume_from_checkpoint` (or
    TRLX_TPU_RESUME_FROM, which overrides it) names. "auto" takes the
    newest committed checkpoint with a `state/` tree; one that fails its
    integrity check is quarantined and the previous one tried; none at all
    is a fresh start. An explicit path loads without the quarantine rename:
    a corrupt one raises."""
    resume_from = config.train.resume_from_checkpoint
    env_resume = os.environ.get("TRLX_TPU_RESUME_FROM")
    if env_resume:
        logger.warning("TRLX_TPU_RESUME_FROM=%s overrides train.resume_from_checkpoint=%r for this launch",
                       env_resume, resume_from)
        resume_from = env_resume
    if resume_from == "auto":
        while True:
            path = trainer.ckpt_manager.latest_resumable()
            if path is None:
                logger.warning("resume_from_checkpoint='auto': no committed checkpoint under %s; starting fresh",
                               config.train.checkpoint_dir)
                return
            logger.info("Resuming from checkpoint %s", path)
            try:
                trainer.load(path)
                return
            except CheckpointCorruptError as e:
                logger.error("auto-resume: %s; falling back to the previous committed checkpoint", e)
    elif resume_from:
        logger.info("Resuming from checkpoint %s", resume_from)
        trainer.load(resume_from, quarantine_corrupt=False)
