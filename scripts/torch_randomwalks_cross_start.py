"""Cross-start check of the randomwalks PPO curve between the JAX package
and its PyTorch port, on the CPU.

The start is the JAX example's own behaviour cloning
(`examples/randomwalks/ppo_randomwalks.py::bc_warmup`, 200 SFT steps at the
seed), saved by the JAX package and converted into the port's save format
(`trlx_tpu_config.json` + `base_weights.pt`). From that start, and from the
value head the JAX trainer draws at the seed, PPO runs with the example's
config in three trainers:

- `jax_fused`: the JAX package as the example runs it (its fused inner loop);
- `jax_looped`: the JAX package's per-step loop (`train.fused_inner_loop`
  off), the loop the port's parity tests hold it to;
- `port`: `trlx_tpu_torch.train` with `model_path=<converted start>`.

Each run's eval optimality curve is printed as one JSON line a seed (the
last value is the curve's `final_optimality`). `--greedy` decodes greedily
and prints the loss streams too, which must then agree step for step;
`--evals N` also draws the cloned start's eval N times in each package's
sampler. A seed whose task scores some walk NaN (seeds 3, 6 and 11: a
node that cannot reach the goal) is skipped: both packages stop on
non-finite losses there.

    python scripts/torch_randomwalks_cross_start.py --seeds 0 1 2 [--out runs.jsonl]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import tempfile
import time
from typing import Dict, Optional
from unittest import mock

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # the repo root

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import trlx_tpu  # noqa: E402
import trlx_tpu_torch  # noqa: E402
from examples.randomwalks import generate_random_walks  # noqa: E402
from examples.randomwalks import ppo_randomwalks as j_example  # noqa: E402
from trlx_tpu.data.configs import TRLConfig as JTRLConfig  # noqa: E402
from trlx_tpu.trainer.base import TPUBaseTrainer as JBaseTrainer  # noqa: E402
from trlx_tpu.trainer.ppo import TPUPPOTrainer as JPPOTrainer  # noqa: E402
from trlx_tpu_torch.data.configs import TRLConfig  # noqa: E402
from trlx_tpu_torch.examples import ppo_randomwalks as port_example  # noqa: E402
from trlx_tpu_torch.models import wrappers  # noqa: E402
from trlx_tpu_torch.models.convert import lm_state_dict_from_jax, params_from_jax  # noqa: E402
from trlx_tpu_torch.models.transformer import TransformerConfig  # noqa: E402
from trlx_tpu_torch.trainer.base import BASE_WEIGHTS, NATIVE_CONFIG, TPUBaseTrainer  # noqa: E402

TRAINERS = ("jax_fused", "jax_looped", "port")


def clone_start(seed: int, directory: str) -> Dict[str, str]:
    """The JAX example's behaviour-cloned start at `seed`, saved by the JAX
    package under <directory>/jax/bc_warmup/hf_model, and the same weights
    in the port's format under <directory>/port. Returns both paths."""
    import orbax.checkpoint as ocp

    config = JTRLConfig.update(j_example.default_config.to_dict(),
                               {"train.seed": seed, "train.checkpoint_dir": os.path.join(directory, "jax")})
    _, _, walks, _ = generate_random_walks(seed=seed)
    jax_dir = j_example.bc_warmup(config, walks)
    params = ocp.PyTreeCheckpointer().restore(os.path.join(jax_dir, "params"))
    port_dir = os.path.join(directory, "port")
    os.makedirs(port_dir, exist_ok=True)
    shutil.copy(os.path.join(jax_dir, NATIVE_CONFIG), port_dir)
    with open(os.path.join(jax_dir, NATIVE_CONFIG)) as f:
        cfg = TransformerConfig(**json.load(f)["transformer"])
    torch.save(lm_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg),
               os.path.join(port_dir, BASE_WEIGHTS))
    return {"jax": jax_dir, "port": port_dir}


def ppo_hparams(seed: int, directory: str, greedy: bool = False, **train) -> dict:
    """The example's config at `seed`, with `train` overrides
    (e.g. epochs, compute_dtype) and, with `greedy`, greedy decoding."""
    hparams = {"train.seed": seed, "train.checkpoint_dir": directory}
    hparams.update({f"train.{k}": v for k, v in train.items()})
    if greedy:
        hparams["method.gen_kwargs.do_sample"] = False
    return hparams


def _task(seed: int) -> dict:
    metric_fn, prompts, _, _ = generate_random_walks(seed=seed)
    return dict(reward_fn=lambda samples, **kw: metric_fn(samples)["optimality"], prompts=prompts,
                eval_prompts=prompts, metric_fn=lambda samples, **kw: metric_fn(samples))


def jax_ppo(start: str, hparams: dict, fused: bool):
    """PPO in the JAX package from the saved start. Returns (trainer, the
    logged stats [(step, stats)], the parameters right after set-up)."""
    config = JTRLConfig.update(j_example.default_config.to_dict(),
                               dict(hparams, **{"train.fused_inner_loop": fused}))
    config.model.model_path = start
    stats, init = [], {}
    setup = JPPOTrainer.setup_model

    def capture(self):
        setup(self)
        init.update(jax.tree_util.tree_map(np.asarray, self.params))

    with mock.patch.object(JPPOTrainer, "setup_model", capture), \
            mock.patch.object(JBaseTrainer, "_tracker_log", lambda self, st, step: stats.append((step, dict(st)))), \
            mock.patch.object(JBaseTrainer, "_save_checkpoint", lambda self, name, final=False: None):
        trainer = trlx_tpu.train(config=config, **_task(config.train.seed))
    return trainer, stats, init


def jax_init(start: str, hparams: dict) -> dict:
    """The JAX PPO trainer's parameters right after set-up from the saved
    start (its value head drawn at the seed), without training."""
    from trlx_tpu.utils.loading import get_trainer

    config = JTRLConfig.update(j_example.default_config.to_dict(), hparams)
    config.model.model_path = start
    trainer = get_trainer(config.train.trainer)(config=config, **{k: v for k, v in _task(config.train.seed).items()
                                                                   if k in ("reward_fn", "metric_fn")})
    return jax.tree_util.tree_map(np.asarray, trainer.params)


def port_ppo(start: str, hparams: dict, jax_params: Optional[dict] = None, device: str = "cpu"):
    """PPO in the port from the converted start; with `jax_params` (the
    JAX trainer's parameters after set-up) its value head replaces the one
    the port draws at the seed."""
    config = TRLConfig.update(port_example.default_config.to_dict(), hparams)
    config.model.model_path = start
    patch = contextlib.nullcontext()
    if jax_params is not None:
        def jax_head(self, generator):
            head = {k: v for k, v in params_from_jax(jax_params, self.cfg).items() if not k.startswith("base.")}
            self.load_state_dict(head, strict=False)
            return self

        patch = mock.patch.object(wrappers.CausalLMWithValueHead, "init_heads", jax_head)
    with patch:
        return trlx_tpu_torch.train(config=config, device=device, **_task(config.train.seed))


def eval_draws(start: Dict[str, str], hparams: dict, n: int) -> Dict[str, list]:
    """The start's eval optimality drawn `n` times in each package's
    sampler (no training): both samplers draw from the same distribution
    when the means agree within their spread."""
    from trlx_tpu.parallel import multihost as mh

    trainers = {}
    with mock.patch.object(JBaseTrainer, "learn", lambda self: trainers.setdefault("jax", self)):
        config = JTRLConfig.update(j_example.default_config.to_dict(), hparams)
        config.model.model_path = start["jax"]
        trlx_tpu.train(config=config, **_task(config.train.seed))
    with mock.patch.object(TPUBaseTrainer, "learn",
                           lambda self: trainers.setdefault("port", self)):
        config = TRLConfig.update(port_example.default_config.to_dict(), hparams)
        config.model.model_path = start["port"]
        trlx_tpu_torch.train(config=config, device="cpu", **_task(config.train.seed))
    chunk = max(config.method.chunk_size, 1)
    trainers["jax"].eval_dataloader = mh.shard_pipeline(trainers["jax"].eval_pipeline,
                                                        trainers["jax"].mesh).create_loader(chunk)
    trainers["port"].eval_dataloader = trainers["port"].eval_pipeline.create_loader(chunk)
    return {name: [round(float(t.evaluate()["metrics/optimality"]), 6) for _ in range(n)]
            for name, t in trainers.items()}


def series(stats, key: str) -> list:
    return [round(float(s[key]), 6) for _, s in stats if key in s]


def cross_start(seed: int, directory: str, greedy: bool = False, trainers=TRAINERS, evals: int = 0,
                **train) -> dict:
    """One seed: clone, draw the clone's eval `evals` times in each
    sampler, then PPO from the clone in each of `trainers`. Returns the
    draws, each run's optimality curve (and loss stream) and seconds."""
    metric_fn, _, walks, _ = generate_random_walks(seed=seed)
    if np.isnan(metric_fn(walks)["optimality"]).any():
        # some node cannot reach the goal: both packages' PPO stops on
        # non-finite losses in its first cycle
        return {"seed": seed, "skipped": "the task's optimality is NaN for some walks"}
    t0 = time.perf_counter()
    start = clone_start(seed, os.path.join(directory, "clone"))
    out = {"seed": seed, "greedy": greedy, "train": train, "clone_s": time.perf_counter() - t0}
    if evals:
        out["evals"] = eval_draws(start, ppo_hparams(seed, os.path.join(directory, "evals")), evals)
    init = None
    for name in trainers:
        t0 = time.perf_counter()
        hparams = ppo_hparams(seed, os.path.join(directory, name), greedy, **train)
        if name == "port":
            init = init or jax_init(start["jax"], hparams)
            stats = port_ppo(start["port"], hparams, init).stats_history
        else:
            _, stats, init = jax_ppo(start["jax"], hparams, fused=name == "jax_fused")
        out[name] = {"optimality": series(stats, "metrics/optimality"),
                     "total_loss": series(stats, "losses/total_loss"), "s": time.perf_counter() - t0}
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--greedy", action="store_true", help="greedy decoding (the runs must then agree)")
    parser.add_argument("--trainers", nargs="*", default=list(TRAINERS), choices=TRAINERS)
    parser.add_argument("--evals", type=int, default=0,
                        help="also draw the cloned start's eval this many times in each sampler")
    parser.add_argument("--out", default=None, help="append each seed's JSON line to this file too")
    args = parser.parse_args()
    torch.set_num_threads(1)
    for seed in args.seeds:
        with tempfile.TemporaryDirectory() as directory:
            res = cross_start(seed, directory, args.greedy, args.trainers, args.evals)
        line = json.dumps(res)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
