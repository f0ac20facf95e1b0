"""Reads chip_smoke.py's train-reference gate, many draws at a time, on the
PPO-knobs, stop-sequence and peft trainers of the PyTorch port, on one CUDA
card.

The gate (`chip_smoke.grad_reference`) runs one train step of the kernel
path, the plain bf16 path and the plain fp32 path on the same parameters
and minibatches, and holds the kernel path's distance from fp32 to at most
twice the plain bf16 path's: the mean |loss error| over the minibatches,
the mean |error| of the response tokens' logprobs and values, and each
trainable tensor's relative gradient error (median ratio at most 1.1).
Here each draw is one fresh store of 256 rollouts cut into 16 minibatches,
the gate's own size; the gate's numbers are recorded and its verdict
(pass, or the check that failed) is kept, never raised. Variants:

- `knobs`: `ppo_knobs_path`'s trainer (GPT-2 small, 50257 ids; the hydra
  reference and the value branch over the top two blocks, timing_split,
  the rollout export). Draw 0 is chip_smoke.py's own reading.
- `knobs_stops`: the same with the stop strings of `stop_path`. The byte
  tokenizer decodes only its 256 byte ids, and random weights over 50257
  ids sample one about once in 200 tokens, so the re-tokenised responses
  are almost wholly padding: a left-padded prompt, then a response of a
  token or none.
- `knobs_stops_full_ref`: `knobs_stops`' trainer, its reference stores
  sampled with the stop strings off (full 32-token responses).
- `stop`: `stop_path`'s trainer (GPT-2-small widths over the byte
  tokenizer's 258 ids, stop strings). Draw 0 is chip_smoke.py's reading.
- `peft_lora`, `peft_prefix`: `peft_lora_path`'s and `peft_virtual_path`'s
  trainers (GPT-2 small, LoRA r 8 / alpha 32, or prefix tuning with 10
  virtual tokens, on the train path's workload). Draw 0 is chip_smoke.py's
  own reading.
- `value_bias_train`, `value_bias_peft_lora` (not gate readings): the train
  path's trainer (everything trainable) or `peft_lora`'s, one fresh store of
  256 rollouts: each path's signed and absolute mean value error from fp32
  over the real response tokens, overall and by response position (the
  value head's output-bias gradient reads the signed mean); then kernel 1
  alone at the train step's shape on random inputs: the signed and absolute
  mean output error from fp32 of the kernel and of the plain bf16 math the
  "xla" path runs (probabilities rounded to bf16 before P V).
- `peft_lora_control`: `peft_lora`'s gate with the kernel path's attention
  made wrong on purpose: kernel 1's output scaled by 1 + eps inside the
  gate's train step (the stores are the kernel path's own), `--draws`
  readings for each eps in CONTROL_EPS. Each reading's signed-sum error
  (the value head's output bias, held to chip_smoke.SIGNED_SUM_REL_ERR)
  shows what the 2% bar sees of a kernel that is off by that much, beside
  the per-token and gradient gates' verdict.
- `peft_virtual_greedy` (not a gate reading): `peft_virtual_path`'s prompt
  and prefix trainers at seeds seed + 1 .. seed + draws (seed itself is
  chip_smoke.py's reading): `peft_greedy_reference`'s per-step and
  free-running agreements of the kernel, plain bf16 and fp32 paths, and its
  verdict.
- `positions` (not a gate reading): `knobs`' trainer, one fresh store of
  1024 full responses, the mean |logprob error| from fp32 of the kernel and
  plain bf16 paths at each response position; then the same store with
  every response cut after its first token (the rest padded, as a stop
  string leaves it), where each path's logprob and value at the first
  position must not move, since causal attention never reads the slots
  a cut pads.

Each trainer takes chip_smoke.py's depth: the knobs, stop and train-path
variants GPT-2 small at `chip_smoke.EARLIER_LAYERS` of its 12 layers, the
peft variants all 12.

One JSON line per draw (the gate's numbers, its verdict, the store's share
of real response tokens), then one per variant pooling its draws: the mean
|loss error| of each path over all minibatches and a bootstrap 95%
interval of their ratio (whole draws resampled), how many draws
failed which check, and the per-draw median gradient ratios.

    python scripts/torch_knobs_gate_diag.py [--seed 0] [--draws 8] [--variants knobs stop peft_lora] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

VARIANTS = ("knobs", "knobs_stops", "knobs_stops_full_ref", "stop", "peft_lora", "peft_prefix", "positions",
            "value_bias_train", "value_bias_peft_lora", "peft_lora_control", "peft_virtual_greedy")
# the tensors each variant's gate must hold (`grad_reference`'s must_gate)
MUST_GATE = {"knobs": "v_branch.", "knobs_stops": "v_branch.", "knobs_stops_full_ref": "v_branch.",
             "peft_lora": "lora.", "peft_prefix": "prefix."}
# the tensors each variant's gate holds as signed sums (`grad_reference`'s signed_sums)
SIGNED_SUMS = {"peft_lora": ("v_head.fc_out.bias",), "peft_lora_control": ("v_head.fc_out.bias",)}
MUST_GATE["peft_lora_control"] = "lora."
CONTROL_EPS = (2.0 ** -8, 2.0 ** -6, 2.0 ** -4)  # `peft_lora_control`: kernel 1's output x (1 + eps)
POSITION_ROLLOUTS = 1024  # `positions`: 1024 tokens at each response position


def build(variant: str, seed: int, logs: str):
    """(the variant's trained kernel-path trainer, the plain paths' configs)."""
    cs = chip_smoke
    if variant == "train":
        trainer = cs.counted_train(cs.train_config(seed), {}, variant)[0]
        return trainer, {"plain_bf16": cs.train_config(seed, attention_impl="xla", kv_cache_quant="int8"),
                         "fp32": cs.train_config(seed, attention_impl="xla", kv_cache_quant=None,
                                                 compute_dtype="float32")}
    if variant.startswith("peft_"):
        adapter = cs.PEFT_LORA if variant == "peft_lora" else cs.PEFT_ADAPTERS["prefix"]
        trainer = cs.counted_train(cs.peft_config(seed, adapter), {}, variant)[0]
        return trainer, cs.peft_reference_configs(seed, adapter)
    if variant == "stop":
        config, stops = cs.stop_config(seed), cs.STOPS
        configs = {
            "plain_bf16": cs.stop_config(seed, attention_impl="xla", kv_cache_quant="int8"),
            "fp32": cs.stop_config(seed, attention_impl="xla", kv_cache_quant=None, compute_dtype="float32"),
        }
    else:
        config, stops = cs.ppo_knobs_config(seed, logs), (cs.STOPS if variant != "knobs" else None)
        configs = {
            "plain_bf16": cs.ppo_knobs_config(seed, attention_impl="xla", kv_cache_quant="int8"),
            "fp32": cs.ppo_knobs_config(seed, attention_impl="xla", kv_cache_quant=None, compute_dtype="float32"),
        }
    kw = {"stop_sequences": stops} if stops else {}
    trainer = cs.counted_train(config, {}, variant, **kw)[0]
    if variant == "knobs_stops_full_ref":
        trainer.stop_sequences = []
    return trainer, configs


def draw(trainer, configs, seed: int, variant: str, i: int) -> dict:
    """One gate reading on a fresh store; the verdict is kept, not raised."""
    import torch

    seen = []
    emit = chip_smoke.emit
    chip_smoke.emit = lambda phase, **kw: seen.append(kw)
    try:
        chip_smoke.train_reference(trainer, seed + 2 * i, configs, phase=f"{variant}_{i}",
                                   must_gate=MUST_GATE.get(variant), signed_sums=SIGNED_SUMS.get(variant, ()))
        verdict = "pass"
    except AssertionError as e:
        verdict = str(e)
    finally:
        chip_smoke.emit = emit
    mask = trainer.store[torch.arange(len(trainer.store), device="cuda")].response_mask.float()
    torch.cuda.empty_cache()
    got = seen[-1]
    e = got["mean_abs_err"]
    return {"variant": variant, "draw": i, "verdict": verdict,
            "loss_err_ratio": e["loss"]["kernel"] / max(e["loss"]["plain_bf16"], 1e-30),
            "grad_rel_err_ratio_median": got["grad_rel_err_ratio_median"],
            "grad_rel_err_ratio_max": got["grad_rel_err_ratio_max"], "mean_abs_err": e,
            "grad_rel_err_ratio_top": got["grad_rel_err_ratio_top"], "tensors_over_2x": got["tensors_over_2x"],
            "signed_sum_grad_rel_err": got["signed_sum_grad_rel_err"],
            "loss_err_by_minibatch": got["loss_err_by_minibatch"],
            "response_real_share": mask.mean().item(), "rows_cut_short": int((mask[:, -1] == 0).sum().item()),
            "rows_without_response": int((mask.sum(dim=1) == 0).sum().item()), "rows": mask.shape[0]}


def control(trainer, configs, seed: int, draws: int) -> list:
    """`peft_lora`'s gate readings with kernel 1's output scaled by 1 + eps
    in the kernel path's train step (the plain paths run no kernel)."""
    from trlx_tpu_torch.models import transformer

    flash = transformer.flash_attention
    grad_reference = chip_smoke.grad_reference
    rows = []
    for eps in CONTROL_EPS:
        def scaled(*args, **kw):
            return flash(*args, **kw) * (1.0 + eps)

        def perturbed(*args, **kw):
            transformer.flash_attention = scaled
            try:
                return grad_reference(*args, **kw)
            finally:
                transformer.flash_attention = flash

        chip_smoke.grad_reference = perturbed
        try:
            for i in range(draws):
                row = draw(trainer, configs, seed, "peft_lora_control", i)
                rows.append(dict(row, eps=eps))
        finally:
            chip_smoke.grad_reference = grad_reference
    return rows


def virtual_greedy(seed: int, draws: int) -> list:
    """`peft_greedy_reference`'s readings for prompt and prefix tuning at
    seeds seed + 1 .. seed + draws; its verdict kept, not raised."""
    import torch

    rows = []
    for i in range(1, draws + 1):
        for kind, adapter in chip_smoke.PEFT_ADAPTERS.items():
            trainer = chip_smoke.counted_train(chip_smoke.peft_config(seed + i, adapter), {}, f"peft_{kind}")[0]
            seen = []
            emit = chip_smoke.emit
            chip_smoke.emit = lambda phase, **kw: seen.append(kw)
            try:
                chip_smoke.peft_greedy_reference(trainer, f"peft_{kind}_greedy")
                verdict = "pass"
            except AssertionError as e:
                verdict = str(e)
            finally:
                chip_smoke.emit = emit
            got = seen[-1]
            rows.append({"variant": "peft_virtual_greedy", "adapter": kind, "seed": seed + i, "verdict": verdict,
                         "greedy_step_agreement": got["greedy_step_agreement"],
                         "greedy_free_running_agreement": got["greedy_free_running_agreement"],
                         "response_tokens": got["response_tokens"]})
            del trainer
            torch.cuda.empty_cache()
    return rows


def positions(trainer, configs, seed: int) -> dict:
    """Per response position, the kernel and plain bf16 paths' mean
    |logprob error| from fp32 over the real tokens of a fresh store of
    `POSITION_ROLLOUTS` rollouts; and, per path, the largest change of the first position's
    logprob and value when every response is cut after its first token."""
    import dataclasses

    import torch

    from trlx_tpu_torch.utils.loading import get_trainer

    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    paths = {"kernel": trainer}
    for name, config in configs.items():
        paths[name] = get_trainer(config.train.trainer)(config=config, reward_fn=chip_smoke.train_reward_fn)
        paths[name].model.load_state_dict(state)
    del state
    trainer.store.clear_history()
    trainer.make_experience(POSITION_ROLLOUTS, trainer.iter_count)
    pad = trainer.generate_settings.pad_token_id
    err = {name: 0.0 for name in ("kernel", "plain_bf16")}
    count, moved = 0.0, {name: [0.0, 0.0] for name in paths}
    with torch.no_grad():
        for batch in trainer.store.create_loader(chip_smoke.TRAIN_BATCH, shuffle=False):
            real = batch.response_mask.float()
            full = {name: t.response_logprobs_and_values(batch) for name, t in paths.items()}
            for name in err:
                err[name] = err[name] + ((full[name][0].float() - full["fp32"][0].float()).abs() * real).sum(0)
            count = count + real.sum(0)
            keep = torch.zeros_like(batch.response_mask)
            keep[:, 0] = batch.response_mask[:, 0]
            cut = dataclasses.replace(batch, response_mask=keep,
                                      response_tensors=torch.where(keep > 0, batch.response_tensors, pad))
            for name, t in paths.items():
                lp, v = t.response_logprobs_and_values(cut)
                moved[name][0] = max(moved[name][0], (lp[:, 0] - full[name][0][:, 0]).abs().max().item())
                moved[name][1] = max(moved[name][1], (v[:, 0] - full[name][1][:, 0]).abs().max().item())
    del paths
    torch.cuda.empty_cache()
    by_pos = {name: (e / count.clamp(min=1)).tolist() for name, e in err.items()}
    return {"variant": "positions", "seed": seed, "tokens_by_position": count.tolist(),
            "logprob_err_by_position": by_pos,
            "ratio_by_position": [k / max(p, 1e-30) for k, p in zip(by_pos["kernel"], by_pos["plain_bf16"])],
            "first_position_moved_by_cut": {name: {"logprob": m[0], "value": m[1]} for name, m in moved.items()}}


def value_bias(trainer, configs, seed: int, variant: str) -> dict:
    """Signed value errors of the kernel and plain bf16 paths from fp32 on
    one fresh store, and kernel 1's signed output error on random inputs."""
    import math

    import torch

    from trlx_tpu_torch.ops.flash_attention import flash_attention
    from trlx_tpu_torch.utils.loading import get_trainer

    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    paths = {"kernel": trainer}
    for name, config in configs.items():
        paths[name] = get_trainer(config.train.trainer)(config=config, reward_fn=chip_smoke.train_reward_fn)
        paths[name].model.load_state_dict(state)
    del state
    trainer.store.clear_history()
    trainer.make_experience(chip_smoke.TRAIN_REFERENCE_ROLLOUTS, trainer.iter_count)
    signed = {name: 0.0 for name in ("kernel", "plain_bf16")}
    absolute = dict(signed)
    by_pos = {name: 0.0 for name in signed}
    count, pos_count, scale = 0.0, 0.0, 0.0
    with torch.no_grad():
        for batch in trainer.store.create_loader(chip_smoke.TRAIN_BATCH, shuffle=False):
            real = batch.response_mask.float()
            vals = {name: t.response_logprobs_and_values(batch)[1].float() for name, t in paths.items()}
            for name in signed:
                d = (vals[name] - vals["fp32"]) * real
                signed[name] += d.sum().item()
                absolute[name] += d.abs().sum().item()
                by_pos[name] = by_pos[name] + d.sum(0)
            scale += (vals["fp32"].abs() * real).sum().item()
            count += real.sum().item()
            pos_count = pos_count + real.sum(0)
    del paths
    B, H, T, D = chip_smoke.TRAIN_BATCH, 12, chip_smoke.TRAIN_LEN, 64
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, mask = chip_smoke.flash_inputs(gen, B, H, H, T, T, D, 0, "left")
    with torch.no_grad():
        out_k = flash_attention(q, k, v, mask).float()
        allowed = (mask[:, None, None, :] > 0) & (torch.arange(T, device="cuda")[:, None]
                                                  >= torch.arange(T, device="cuda")[None, :])
        s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) / math.sqrt(D)
        s = torch.where(allowed, s, torch.full_like(s, -1e9))
        p = torch.softmax(s, dim=-1)
        out_32 = torch.einsum("bhts,bhsd->bhtd", p, v.float())
        out_p = torch.einsum("bhts,bhsd->bhtd", p.to(torch.bfloat16), v).float()
        rows = allowed.any(dim=-1)[..., None].expand_as(out_32)
    op = {name: {"signed_mean": (o - out_32)[rows].mean().item(), "abs_mean": (o - out_32)[rows].abs().mean().item()}
          for name, o in (("kernel", out_k), ("plain_bf16", out_p))}
    torch.cuda.empty_cache()
    return {"variant": variant, "seed": seed, "tokens": count, "fp32_value_abs_mean": scale / count,
            "value_err_signed_mean": {n: x / count for n, x in signed.items()},
            "value_err_abs_mean": {n: x / count for n, x in absolute.items()},
            "value_err_signed_by_position": {n: (x / pos_count.clamp(min=1)).tolist() for n, x in by_pos.items()},
            "kernel1_output_err": op}


def nanmean(xs) -> float:
    xs = [x for x in xs if not np.isnan(x)]
    return statistics.mean(xs) if xs else float("nan")


def pooled(rows: list, seed: int) -> dict:
    # a draw's minibatches share its rollouts (two shuffles of one store),
    # so the bootstrap resamples whole draws
    k = np.array([r["loss_err_by_minibatch"]["kernel"] for r in rows])
    p = np.array([r["loss_err_by_minibatch"]["plain_bf16"] for r in rows])
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(rows), (2000, len(rows)))
    boot = k[idx].mean(axis=(1, 2)) / p[idx].mean(axis=(1, 2))
    fails = {}
    for r in rows:
        if r["verdict"] != "pass":
            what = r["verdict"].split(" by ")[0].split(" is ")[0]
            fails[what] = fails.get(what, 0) + 1
    return {"variant": rows[0]["variant"], "draws": len(rows), "minibatches": k.size,
            "loss_mean_abs_err": {"kernel": k.mean(), "plain_bf16": p.mean()},
            "loss_err_ratio_pooled": k.mean() / p.mean(),
            "loss_err_ratio_ci95": [float(np.quantile(boot, 0.025)), float(np.quantile(boot, 0.975))],
            "loss_err_ratio_by_draw": [r["loss_err_ratio"] for r in rows],
            "grad_ratio_median_by_draw": [r["grad_rel_err_ratio_median"] for r in rows],
            "grad_ratio_median_mean": statistics.mean(r["grad_rel_err_ratio_median"] for r in rows),
            "logprobs_mean_abs_err": {w: nanmean(r["mean_abs_err"]["logprobs"][w] for r in rows)
                                      for w in ("kernel", "plain_bf16")},
            "values_mean_abs_err": {w: nanmean(r["mean_abs_err"]["values"][w] for r in rows)
                                    for w in ("kernel", "plain_bf16")},
            "response_real_share": statistics.mean(r["response_real_share"] for r in rows),
            "failed_draws": fails}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--draws", type=int, default=8)
    parser.add_argument("--variants", nargs="+", choices=VARIANTS, default=list(VARIANTS))
    parser.add_argument("--out", default=None, help="also append every line to this file")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_knobs_gate_diag: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from trlx_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()

    def out(line: dict) -> None:
        text = json.dumps(line, default=float)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")

    out({"device": chip_smoke.nvidia_smi(), "torch": torch.__version__, "seed": args.seed, "draws": args.draws})
    for variant in args.variants:
        if variant == "peft_virtual_greedy":
            for row in virtual_greedy(args.seed, args.draws):
                out(row)
            continue
        logs = tempfile.mkdtemp(prefix="rollouts-")
        try:
            built = {"positions": "knobs", "value_bias_train": "train", "value_bias_peft_lora": "peft_lora",
                     "peft_lora_control": "peft_lora"}
            trainer, configs = build(built.get(variant, variant), args.seed, logs)
            if variant == "peft_lora_control":
                for row in control(trainer, configs, args.seed, args.draws):
                    out(row)
            elif variant == "positions":
                out(positions(trainer, configs, args.seed))
            elif variant.startswith("value_bias"):
                out(value_bias(trainer, configs, args.seed, variant))
            else:
                rows = []
                for i in range(args.draws):
                    rows.append(draw(trainer, configs, args.seed, variant, i))
                    out(rows[-1])
                out(pooled(rows, args.seed))
        finally:
            shutil.rmtree(logs, ignore_errors=True)
        del trainer
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
