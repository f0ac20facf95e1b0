"""RFT on the randomwalks task through the port, with the protocol and
config of the JAX package's examples/randomwalks/rft_randomwalks.py: the
small random-init decoder is first behaviour-cloned on the walk corpus
(`ppo_randomwalks.bc_warmup`: 200 SFT steps, save_pretrained, reload),
then fine-tuned on its own best samples (8 generations a start node,
the 0.9 -> 0.95 score percentile, regenerated every 4 epochs).

    python -m trlx_tpu_torch.examples.rft_randomwalks [--device cpu] \
        [--hparams '{"train.seed": 1}'] [--curve docs/torch_curves/randomwalks_rft.jsonl]
"""

from __future__ import annotations

import argparse
import json

import trlx_tpu_torch
from trlx_tpu_torch.data.configs import (
    ModelConfig,
    OptimizerConfig,
    SchedulerConfig,
    TokenizerConfig,
    TrainConfig,
    TRLConfig,
)
from trlx_tpu_torch.data.method_configs import RFTConfig
from trlx_tpu_torch.examples.curves import curve_rows, hardware, write_curve
from trlx_tpu_torch.examples.ppo_randomwalks import bc_warmup
from trlx_tpu_torch.examples.randomwalks import generate_random_walks

default_config = TRLConfig(
    train=TrainConfig(
        seq_length=11,
        epochs=100,
        total_steps=200,
        batch_size=96,
        checkpoint_interval=100000,
        eval_interval=16,
        pipeline="PromptPipeline",
        trainer="TPURFTTrainer",
        tracker=None,
        checkpoint_dir="ckpts/rft_randomwalks",
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
    scheduler=SchedulerConfig(name="cosine_annealing", kwargs=dict(T_max=1000, eta_min=3.0e-4)),
    method=RFTConfig(
        name="rftconfig",
        n_generations_per_prompt=8,
        start_percentile=0.9,
        end_percentile=0.95,
        n_improve_steps=4,
        gen_kwargs=dict(max_new_tokens=9, top_k=0, top_p=1.0, do_sample=True),
    ),
)


def main(hparams={}, device=None):
    config = TRLConfig.update(default_config.to_dict(), hparams)
    metric_fn, prompts, walks, _ = generate_random_walks(seed=config.train.seed)
    if config.model.model_path == "random":
        # RFT from a cold random model never samples a valid walk, so
        # selection has nothing to climb on: start from the behaviour clone
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
    """Write the run's curve: eval reward and optimality, the loss stream
    and each improve round's selection."""
    config, method = trainer.config, trainer.config.method
    return write_curve(
        path, curve_rows(trainer.stats_history, ["reward/mean", "metrics/optimality", "losses/loss",
                                                 "len_samples_selected", "scores_mean"]),
        task="randomwalks RFT (trlx_tpu_torch/examples/rft_randomwalks.py)",
        protocol=(f"BC warmup (200 SFT steps), save_pretrained and reload, then RFT, {trainer.iter_count} steps "
                  f"(batch {config.train.batch_size}), {method.n_generations_per_prompt} generations/prompt, "
                  f"percentile {method.start_percentile}->{method.end_percentile}, eval every "
                  f"{config.train.eval_interval}, seed {config.train.seed}"),
        hw=hardware(device), reference="docs/curves/randomwalks_rft.jsonl (the JAX package's curve)",
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
