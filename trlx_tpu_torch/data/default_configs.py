"""Programmatic default configs (copy of trlx_tpu.data.default_configs
for the methods the port has reached)."""

from trlx_tpu_torch.data.configs import (
    ModelConfig,
    OptimizerConfig,
    SchedulerConfig,
    TokenizerConfig,
    TrainConfig,
    TRLConfig,
)
from trlx_tpu_torch.data.method_configs import DPOConfig, GRPOConfig, ILQLConfig, PPOConfig, SFTConfig


def default_ppo_config() -> TRLConfig:
    return TRLConfig(
        train=TrainConfig(
            seq_length=1024,
            epochs=100,
            total_steps=10000,
            batch_size=32,
            checkpoint_interval=10000,
            eval_interval=100,
            pipeline="PromptPipeline",
            trainer="TPUPPOTrainer",
            tracker=None,
        ),
        model=ModelConfig(model_path="lvwerra/gpt2-imdb", num_layers_unfrozen=2),
        tokenizer=TokenizerConfig(tokenizer_path="gpt2", truncation_side="right"),
        optimizer=OptimizerConfig(
            name="adamw",
            kwargs=dict(lr=3e-5, betas=(0.9, 0.95), eps=1.0e-8, weight_decay=1.0e-6),
        ),
        scheduler=SchedulerConfig(
            name="cosine_annealing", kwargs=dict(T_max=1e12, eta_min=3e-5)
        ),
        method=PPOConfig(
            name="PPOConfig",
            num_rollouts=128,
            chunk_size=128,
            ppo_epochs=4,
            init_kl_coef=0.001,
            target=None,
            horizon=10000,
            gamma=1.0,
            lam=0.95,
            cliprange=0.2,
            cliprange_value=0.2,
            vf_coef=1.0,
            scale_reward="ignored",
            ref_mean=None,
            ref_std=None,
            cliprange_reward=10.0,
            gen_kwargs=dict(max_new_tokens=40, top_k=0, top_p=1.0, do_sample=True),
        ),
    )


def default_grpo_config() -> TRLConfig:
    """GRPO on the PPO recipe's sections with the critic-free method half.
    Built standalone, not by evolving the PPO config: `evolve` merges the
    method dict, and PPO-only keys (vf_coef, gamma, ...) would reach
    GRPOConfig. `do_sample` stays on: a greedy group is `group_size`
    identical samples with zero advantage."""
    base = default_ppo_config()
    return TRLConfig(
        train=base.train,
        model=base.model,
        tokenizer=base.tokenizer,
        optimizer=base.optimizer,
        scheduler=base.scheduler,
        method=GRPOConfig(
            name="grpoconfig",
            num_rollouts=128,
            chunk_size=128,
            group_size=8,
            grpo_epochs=4,
            kl_coef=0.001,
            cliprange=0.2,
            scale_reward="ignored",
            cliprange_reward=10.0,
            gen_kwargs=dict(max_new_tokens=40, top_k=0, top_p=1.0, do_sample=True),
        ),
    ).evolve(train=dict(trainer="TPUGRPOTrainer"))


def default_dpo_config() -> TRLConfig:
    """DPO on the SFT recipe: offline preference pairs, the frozen
    reference the initial policy."""
    return default_sft_config().evolve(
        train=dict(trainer="TPUDPOTrainer"),
        optimizer=dict(
            name="adamw",
            kwargs=dict(lr=5.0e-6, betas=(0.9, 0.95), eps=1.0e-8, weight_decay=1.0e-6),
        ),
        scheduler=dict(
            name="cosine_annealing", kwargs=dict(T_max=1e12, eta_min=5.0e-6)
        ),
        method=DPOConfig(
            name="dpoconfig",
            beta=0.1,
            label_smoothing=0.0,
            gen_kwargs=dict(max_new_tokens=40, top_k=0, top_p=1.0, do_sample=True),
        ).to_dict(),
    )


def default_sft_config() -> TRLConfig:
    return TRLConfig(
        train=TrainConfig(
            seq_length=1024,
            epochs=100,
            total_steps=1000,
            batch_size=8,
            checkpoint_interval=10000,
            eval_interval=100,
            pipeline="PromptPipeline",
            trainer="TPUSFTTrainer",
            tracker=None,
        ),
        model=ModelConfig(model_path="gpt2", num_layers_unfrozen=-1),
        tokenizer=TokenizerConfig(tokenizer_path="gpt2", truncation_side="right"),
        optimizer=OptimizerConfig(
            name="adamw",
            kwargs=dict(lr=1.0e-4, betas=(0.9, 0.95), eps=1.0e-8, weight_decay=1.0e-6),
        ),
        scheduler=SchedulerConfig(
            name="cosine_annealing", kwargs=dict(T_max=1e12, eta_min=1.0e-4)
        ),
        method=SFTConfig(
            name="sftconfig",
            gen_kwargs=dict(max_new_tokens=40, top_k=0, top_p=1.0, do_sample=True),
        ),
    )


def default_ilql_config() -> TRLConfig:
    return TRLConfig(
        train=TrainConfig(
            seq_length=64,
            batch_size=128,
            epochs=100,
            total_steps=1000,
            checkpoint_interval=1000,
            eval_interval=100,
            pipeline="PromptPipeline",
            trainer="TPUILQLTrainer",
            tracker=None,
        ),
        model=ModelConfig(model_path="gpt2", num_layers_unfrozen=-1),
        tokenizer=TokenizerConfig(tokenizer_path="gpt2", truncation_side="right"),
        optimizer=OptimizerConfig(
            name="adamw",
            kwargs=dict(lr=5.0e-5, betas=(0.9, 0.95), eps=1.0e-8, weight_decay=1.0e-6),
        ),
        scheduler=SchedulerConfig(
            name="cosine_annealing", kwargs=dict(T_max=1e12, eta_min=5.0e-5)
        ),
        method=ILQLConfig(
            name="ilqlconfig",
            tau=0.7,
            gamma=0.99,
            cql_scale=0.1,
            awac_scale=1.0,
            alpha=0.001,
            beta=0.0,
            steps_for_target_q_sync=5,
            two_qs=True,
            gen_kwargs=dict(max_new_tokens=56, top_k=20, beta=1.0, temperature=1.0),
        ),
    )
