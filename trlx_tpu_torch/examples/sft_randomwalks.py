"""SFT on the randomwalks shortest-path task through the port: supervised
on the optimal walks (BFS gold paths), evaluated by the optimality metric
(the settings of the JAX package's examples/randomwalks/sft_randomwalks.py).

    python -m trlx_tpu_torch.examples.sft_randomwalks [--device cpu] \
        [--hparams '{"train.seed": 1}'] [--curve docs/torch_curves/randomwalks_sft.jsonl]
"""

from __future__ import annotations

import argparse
import json
from typing import List

import numpy as np

import trlx_tpu_torch
from trlx_tpu_torch.data.configs import (
    ModelConfig,
    OptimizerConfig,
    SchedulerConfig,
    TokenizerConfig,
    TrainConfig,
    TRLConfig,
)
from trlx_tpu_torch.data.method_configs import SFTConfig
from trlx_tpu_torch.examples.curves import curve_rows, hardware, write_curve
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
        trainer="TPUSFTTrainer",
        tracker=None,
        checkpoint_dir="ckpts/sft_randomwalks",
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
    method=SFTConfig(
        name="sftconfig",
        gen_kwargs=dict(max_new_tokens=9, do_sample=False),
    ),
)


def optimal_walks(adj: np.ndarray, max_length: int = 10) -> List[str]:
    """One BFS-shortest path from every non-goal start node to the goal
    (node 0), as letter strings: the SFT gold corpus."""
    n = adj.shape[0]
    goal = 0
    walks = []
    for start in range(1, n):
        parent = {start: None}
        frontier = [start]
        found = False
        while frontier and not found:
            nxt = []
            for u in frontier:
                for v in np.nonzero(adj[u])[0].tolist():
                    if v not in parent:
                        parent[v] = u
                        if v == goal:
                            found = True
                        nxt.append(v)
            frontier = nxt
        if not found:
            continue
        path = [goal]
        while parent[path[-1]] is not None:
            path.append(parent[path[-1]])
        path = path[::-1][:max_length]
        if path[-1] != goal:
            continue
        walks.append("".join(chr(ix + ord("a")) for ix in path))
    return walks


def main(hparams={}, device=None):
    config = TRLConfig.update(default_config.to_dict(), hparams)
    metric_fn, eval_prompts, _walks, adj = generate_random_walks(seed=config.train.seed)
    gold = optimal_walks(adj)

    return trlx_tpu_torch.train(
        samples=[(w[0], w[1:]) for w in gold] * 8,
        eval_prompts=eval_prompts,
        metric_fn=lambda samples, **kwargs: metric_fn(samples),
        config=config,
        device=device,
    )


def record(trainer, path: str, device=None) -> dict:
    """Write the run's curve (eval optimality and the loss stream)."""
    config = trainer.config
    return write_curve(
        path, curve_rows(trainer.stats_history, ["metrics/optimality", "losses/loss"]),
        task="randomwalks SFT (trlx_tpu_torch/examples/sft_randomwalks.py)",
        protocol=(f"SFT on BFS gold shortest paths, {trainer.iter_count} steps batch "
                  f"{config.train.batch_size}, eval every {config.train.eval_interval}, seed {config.train.seed}"),
        hw=hardware(device), reference="docs/curves/randomwalks_sft.jsonl (the JAX package's curve)",
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
