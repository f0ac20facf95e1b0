"""Reads why the loss of chip_smoke.py's 7B cell (full-parameter SFT at
Llama-2-7B's widths on one fixed batch) rises after its first step at
larger learning rates, on one CUDA card: is the rise the optimizer's own
dynamics, or a fault of the bf16 gradient tree or the 8-bit AdamW path?

Each run is `trlx_tpu_torch.train(samples=...)` on `chip_smoke.
llama_full_config` (random weights drawn on the card from the seed, the
same fixed batch of 8 x 512 byte tokens, no evaluation, no checkpoint),
varied in depth, learning rate and optimizer path:

- `recipe`: the cell as it is: `adamw_8bit_fused`, `grads_dtype`
  bfloat16, remat "full";
- `adam8_fp32_grads`: the same optimizer with fp32 gradients
  (`grads_dtype` unset), remat "full";
- `adamw_fp32`: torch's AdamW (`adamw`: fp32 moments) with fp32
  gradients and no remat; only at `--shallow-layers` (at 32 layers its
  fp32 state does not fit one card).

At `--shallow-layers` (full widths) every variant runs at every
`--lrs` learning rate for `--shallow-steps` steps; at 32 layers the
recipe and `adam8_fp32_grads` run at every `--deep-lrs` learning rate
for chip_smoke.LLAMA_FULL_STEPS steps. Each run prints one JSON line (its
losses, peak device memory and wall); all go to
`chiprun_out/llama_full_lr_witness.json`.

    python3 scripts/torch_llama_full_lr_witness.py [--seed 0] [--lrs 1e-4 1e-5 3e-6]
        [--deep-lrs 1e-4 1e-5 3e-6 1e-6]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

VARIANTS = {
    "recipe": dict(optimizer="adamw_8bit_fused", grads_dtype="bfloat16", remat_policy="full"),
    "adam8_fp32_grads": dict(optimizer="adamw_8bit_fused", grads_dtype=None, remat_policy="full"),
    "adamw_fp32": dict(optimizer="adamw", grads_dtype=None, remat_policy="none"),
}


def run_one(seed: int, layers: int, steps: int, lr: float, variant: str) -> dict:
    """One `train()` of the 7B cell's config at `layers` and `steps` under
    `variant` at `lr`: its losses, peak device bytes and wall."""
    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch.models.wrappers import CausalLM
    from trlx_tpu_torch.trainer.base import TPUBaseTrainer

    v = VARIANTS[variant]
    config = chip_smoke.llama_full_config(seed)
    transformer = dict(config.model.model_extra_configs["transformer"], n_layer=layers)
    config = config.evolve(
        train=dict(total_steps=steps, epochs=steps, grads_dtype=v["grads_dtype"], remat_policy=v["remat_policy"]),
        model=dict(model_extra_configs={"transformer": transformer}),
        optimizer=dict(name=v["optimizer"], kwargs=dict(config.optimizer.kwargs, lr=lr)),
    )
    init_params, save, evaluate = CausalLM.init_params, TPUBaseTrainer._save_checkpoint, TPUBaseTrainer.evaluate

    def init_on_card(self, generator):
        self.base.init_params(torch.Generator(device="cuda").manual_seed(seed))
        return self.init_heads(generator)

    CausalLM.init_params = init_on_card
    TPUBaseTrainer._save_checkpoint = lambda self, name, final=False: None
    TPUBaseTrainer.evaluate = lambda self: {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = dict(variant=variant, layers=layers, steps=steps, lr=lr, **v)
    t0 = time.perf_counter()
    try:
        trainer = trlx_tpu_torch.train(samples=chip_smoke.llama_full_samples(seed), config=config)
        torch.cuda.synchronize()
        out["losses"] = [st["losses/loss"] for _, st in trainer.stats_history if "losses/loss" in st]
        del trainer
    except torch.cuda.OutOfMemoryError as e:
        out["error"] = f"out of memory: {str(e).splitlines()[0]}"
    finally:
        CausalLM.init_params, TPUBaseTrainer._save_checkpoint = init_params, save
        TPUBaseTrainer.evaluate = evaluate
    out["wall_s"] = time.perf_counter() - t0
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--lrs", type=float, nargs="+", default=[1e-4, 1e-5, 3e-6])
    parser.add_argument("--deep-lrs", type=float, nargs="+", default=[1e-4, 1e-5, 3e-6, 1e-6])
    parser.add_argument("--shallow-layers", type=int, default=4)
    parser.add_argument("--shallow-steps", type=int, default=5)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_llama_full_lr_witness: no CUDA device", file=sys.stderr)
        return 2
    chip_smoke.emit("device", nvidia_smi=chip_smoke.nvidia_smi(), torch=torch.__version__)
    plan = [(args.shallow_layers, args.shallow_steps, lr, v) for lr in args.lrs for v in VARIANTS]
    plan += [(chip_smoke.LLAMA_PUBLISHED_LAYERS, chip_smoke.LLAMA_FULL_STEPS, lr, v) for lr in args.deep_lrs
             for v in ("recipe", "adam8_fp32_grads")]
    runs = []
    try:
        for layers, steps, lr, variant in plan:
            runs.append(run_one(args.seed, layers, steps, lr, variant))
            chip_smoke.emit("lr_witness_run", **runs[-1])
    finally:
        for root in chip_smoke._CKPT_ROOT:  # the runs' temporary checkpoint directories
            shutil.rmtree(root, ignore_errors=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "llama_full_lr_witness.json"), "w") as f:
        json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
