"""PPO on the randomwalks task through the port, with the protocol and
settings of the JAX package's examples/randomwalks/ppo_randomwalks.py: a
small random-init decoder is first behaviour-cloned on the random-walk
corpus (200 SFT steps), saved with `save_pretrained`, reloaded through
`model_path=<dir>`, then trained with PPO on the optimality reward.

    python -m trlx_tpu_torch.examples.ppo_randomwalks [--device cpu] \
        [--hparams '{"train.seed": 1}'] [--curve docs/torch_curves/randomwalks_ppo.jsonl]
"""

from __future__ import annotations

import argparse
import json
import os

import trlx_tpu_torch
from trlx_tpu_torch.data.configs import (
    ModelConfig,
    OptimizerConfig,
    SchedulerConfig,
    TokenizerConfig,
    TrainConfig,
    TRLConfig,
)
from trlx_tpu_torch.data.method_configs import PPOConfig, SFTConfig
from trlx_tpu_torch.examples.curves import curve_rows, hardware, write_curve
from trlx_tpu_torch.examples.randomwalks import generate_random_walks

default_config = TRLConfig(
    train=TrainConfig(
        seq_length=10,
        epochs=20,
        total_steps=1000,
        batch_size=96,
        checkpoint_interval=10000,
        eval_interval=20,
        pipeline="PromptPipeline",
        trainer="TPUPPOTrainer",
        tracker=None,
        checkpoint_dir="ckpts/ppo_randomwalks",
    ),
    model=ModelConfig(
        model_path="random",
        num_layers_unfrozen=-1,
        model_extra_configs={
            "transformer": dict(hidden_size=144, n_layer=4, n_head=6, n_positions=32)
        },
    ),
    tokenizer=TokenizerConfig(tokenizer_path="byte", truncation_side="right"),
    optimizer=OptimizerConfig(
        name="adamw", kwargs=dict(lr=3.0e-4, betas=(0.9, 0.95), eps=1.0e-8, weight_decay=1.0e-6)
    ),
    scheduler=SchedulerConfig(name="cosine_annealing", kwargs=dict(T_max=10000, eta_min=3.0e-4)),
    method=PPOConfig(
        name="PPOConfig",
        num_rollouts=96,
        chunk_size=96,
        ppo_epochs=4,
        init_kl_coef=0,
        target=None,
        horizon=10000,
        gamma=1,
        lam=0.95,
        cliprange=0.2,
        cliprange_value=0.2,
        vf_coef=1.2,
        scale_reward="ignored",
        ref_mean=None,
        ref_std=None,
        cliprange_reward=1,
        gen_kwargs=dict(max_new_tokens=9, top_k=0, top_p=1.0, do_sample=True),
    ),
)


def bc_warmup(config, walks, device=None) -> str:
    """Behaviour-clone the random-walk corpus so PPO starts from a model
    that emits valid walks: `train(samples=...)`, then `save_pretrained`
    into <checkpoint_dir>/bc_warmup/hf_model, which a directory already
    holding a saved model skips. Returns that directory."""
    sft_dir = os.path.join(config.train.checkpoint_dir, "bc_warmup")
    model_dir = os.path.join(sft_dir, "hf_model")
    if not os.path.exists(os.path.join(model_dir, "trlx_tpu_config.json")):
        sft_config = TRLConfig.from_dict(
            dict(
                config.to_dict(),
                method=SFTConfig(name="sftconfig", gen_kwargs=dict(max_new_tokens=9)).to_dict(),
            )
        ).evolve(
            train=dict(
                trainer="TPUSFTTrainer", total_steps=200, epochs=40,
                eval_interval=1000, checkpoint_interval=1000,
                checkpoint_dir=sft_dir,
            ),
        )
        trainer = trlx_tpu_torch.train(samples=[(w[0], w[1:]) for w in walks], config=sft_config, device=device)
        trainer.save_pretrained(model_dir)
    return model_dir


def main(hparams={}, device=None):
    config = TRLConfig.update(default_config.to_dict(), hparams)
    metric_fn, prompts, walks, _ = generate_random_walks(seed=config.train.seed)

    config.model.model_path = bc_warmup(config, walks, device)

    return trlx_tpu_torch.train(
        reward_fn=lambda samples, **kwargs: metric_fn(samples)["optimality"],
        prompts=prompts,
        eval_prompts=prompts,
        metric_fn=lambda samples, **kwargs: metric_fn(samples),
        config=config,
        device=device,
    )


def record(trainer, path: str, device=None) -> dict:
    """Write the run's curve: eval reward and optimality, the loss stream,
    the KL and its coefficient."""
    config = trainer.config
    cycles = config.train.epochs
    return write_curve(
        path, curve_rows(trainer.stats_history, ["reward/mean", "metrics/optimality", "losses/total_loss",
                                                 "policy/sqrt_kl", "kl_ctl_value"]),
        task="randomwalks PPO (trlx_tpu_torch/examples/ppo_randomwalks.py)",
        protocol=(f"BC warmup (200 SFT steps), save_pretrained and reload, then PPO, {cycles} epochs x "
                  f"{config.method.ppo_epochs} ppo_epochs = {trainer.iter_count} optimizer steps, eval every "
                  f"{config.train.eval_interval}, seed {config.train.seed}"),
        hw=hardware(device), reference="docs/curves/randomwalks_ppo.jsonl (the JAX package's curve)",
    )


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--hparams", default="{}", help="dotted-path config overrides as JSON")
    parser.add_argument("--device", default=None, help="cpu, or the CUDA card by default")
    parser.add_argument("--curve", default=None, help="write the learning curve to this path")
    args = parser.parse_args()
    trainer = main(json.loads(args.hparams), device=args.device)
    if args.curve:
        print(json.dumps(record(trainer, args.curve, args.device)))
