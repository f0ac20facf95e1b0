"""Offline ILQL on the randomwalks task through the port, with the config
of the JAX package's examples/randomwalks/ilql_randomwalks.py: a small
random-init decoder learns from the 1000-walk corpus, each walk labelled
with its optimality, and every evaluation samples the 20 start nodes at
beta 0, 1 and 100 (the advantage shaping's weight).

    python -m trlx_tpu_torch.examples.ilql_randomwalks [--device cpu] \
        [--hparams '{"train.seed": 1}'] [--curve docs/torch_curves/randomwalks_ilql.jsonl]
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
from trlx_tpu_torch.data.method_configs import ILQLConfig
from trlx_tpu_torch.examples.curves import curve_rows, hardware, write_curve
from trlx_tpu_torch.examples.randomwalks import generate_random_walks

BETAS = [0, 1, 100]

default_config = TRLConfig(
    train=TrainConfig(
        seq_length=11,
        epochs=100,
        total_steps=1000,
        batch_size=96,
        checkpoint_interval=100000,
        eval_interval=16,
        pipeline="PromptPipeline",
        trainer="TPUILQLTrainer",
        tracker=None,
        checkpoint_dir="ckpts/ilql_randomwalks",
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
        name="adamw", kwargs=dict(lr=2.0e-4, betas=(0.9, 0.95), eps=1.0e-8, weight_decay=1.0e-6)
    ),
    scheduler=SchedulerConfig(name="cosine_annealing", kwargs=dict(T_max=1000, eta_min=2.0e-4)),
    method=ILQLConfig(
        name="ilqlconfig",
        tau=0.9,
        gamma=0.99,
        cql_scale=0.1,
        awac_scale=1,
        alpha=0.1,
        beta=0,
        steps_for_target_q_sync=5,
        two_qs=True,
        gen_kwargs=dict(max_new_tokens=9, top_k=10, beta=BETAS, temperature=1.0),
    ),
)


def main(hparams={}, device=None):
    config = TRLConfig.update(default_config.to_dict(), hparams)
    metric_fn, eval_prompts, walks, _ = generate_random_walks(seed=config.train.seed)
    rewards = metric_fn(walks)["optimality"]

    return trlx_tpu_torch.train(
        samples=walks,
        rewards=rewards,
        eval_prompts=eval_prompts,
        metric_fn=lambda samples, **kwargs: metric_fn(samples),
        config=config,
        device=device,
    )


def record(trainer, path: str, device=None) -> dict:
    """Write the run's curve: eval optimality at each beta and the loss
    stream; the meta holds the last evaluation's optimality at each beta."""
    config = trainer.config
    betas = config.method.gen_kwargs["beta"]
    return write_curve(
        path, curve_rows(trainer.stats_history, ["metrics/optimality", "losses/loss", "losses/loss_q",
                                                 "losses/loss_cql"]),
        task="randomwalks ILQL (trlx_tpu_torch/examples/ilql_randomwalks.py)",
        protocol=(f"offline ILQL from the {len(trainer.store)}-walk corpus, {trainer.iter_count} optimizer steps "
                  f"(batch {config.train.batch_size}), eval every {config.train.eval_interval} sweeping beta over "
                  f"{betas}, seed {config.train.seed}"),
        hw=hardware(device), reference="docs/curves/randomwalks_ilql.jsonl (the JAX package's curve)",
        final_key=[f"metrics/optimality@beta={b}" for b in betas],
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
