#!/usr/bin/env python3
"""Drive trlx_tpu_torch's rollout and training paths on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--only fwd|paged|decode|bias|sft|ppo|resume|ilql|rft|grpo|dpo|llama|peft|memory|w8a16|adam8bit|health]

Builds the CUDA kernels from `trlx_tpu_torch/csrc` (into build/kernels/)
and holds each kernel against its plain PyTorch version on the card: both
routes of the flash forward (one CTA per head up to 128 queries and keys;
64-row query tiles past that), both routes of the flash backward (one fused kernel up
to 128 queries and keys; the dq and dk/dv kernels past that; causal, and
T5's non-causal cross-attention with more queries than keys), both
routes of T5's bias-carrying forward (one CTA per head up to 128 queries
and keys; 64-row query tiles past that) and both routes of its backward
(one fused kernel up to 128 queries and keys; the dq + dbias and dk/dv
kernels past that),
both routes of the int8 decode step (one CTA per batch row and kv head
loading the attendable K/V in one burst up to 256 slots; 128-slot chunks
past that), both routes of the paged decode step (one CTA per lane and kv
head holding the lane's whole K/V up to 256 slots; 128-slot chunks past
that); and checks that the per-lane sampler's
counter stream is the same on the CPU and the card. Then, at
GPT-2-small width (768 wide, 12 heads, vocab 50257, cut to 4 of its 12
layers; random weights from the seed),
through the entry points a user calls:

- the rollout path: `CausalLMWithValueHead.from_config` on the default
  PPO config, `generate` (greedy and sampled, int8 KV cache, 64
  byte-tokenised prompts left-padded to 32, 40 new tokens) and
  `forward_train` with `logprobs_of_labels`; the same greedy rollout
  through the plain attention math is its whole-path reference;
- the training path: `trlx_tpu_torch.train` on bench.py's headline
  workload (64 rollouts of 32 + 32 tokens, batch 32, 4 PPO epochs, two
  cycles = 16 optimizer steps); one train step through the plain bf16
  and fp32 attention math is its reference;
- the rest of the PPO surface on that workload: `overlap_path`
  (`method.overlap_rollouts`: the second cycle's rollout generated with
  the pre-update weights before the first cycle's steps, scored after
  them; train_path's launches exactly), `ppo_knobs_path` (the hydra
  reference and the value branch over the top two blocks,
  `train.timing_split`, `train.rollout_logging_dir`; exact launches, the
  value branch's added device time, one train step against the plain bf16
  and fp32 math) and `stop_path` (GPT-2-small widths over the byte
  tokenizer's 258 ids, stop sequences: outputs cut and re-tokenised;
  exact launches, one train step on the cut rows against the same math);
- checkpoint, preemption and resume on that workload (`resume_path`):
  the run uninterrupted, killed by a SIGTERM from the reward function in
  its second rollout, then resumed with resume_from_checkpoint="auto"
  from the step-8 checkpoint; the restored tensors bit for bit on the
  card, the resumed counters and tracker log, and the resumed second
  cycle against the uninterrupted one;
- the decode engine: `engine_generate` on the hydra policy (64 prompts,
  16 slots, int8 pages, greedy, with and without speculative decoding),
  on the paged kernel and on the plain gather math; then
  `trlx_tpu_torch.train` on the headline workload with
  `method.gen_engine` on (32 slots, the kernel, speculative decoding);
- supervised fine-tuning: `trlx_tpu_torch.train(samples=...)` on 64
  byte-tokenised (prompt, output) pairs right-padded to 64 tokens, batch
  32, 16 optimizer steps, greedy evaluations at each end; one SFT step
  through the plain bf16 and fp32 attention math is its reference; then
  `save_pretrained` and a PPO run reloaded from that directory
  (`model_path=<dir>`, one cycle of the headline workload: the loaded
  weights, its frozen reference and its logits bit for bit); then the
  randomwalks SFT and SFT -> save -> reload -> PPO runners with the JAX
  example's configs (the PPO run's final optimality >= 0.9);
- seq2seq at T5-base width (768 wide, vocab 32128, cut to 4 + 4 of its
  12 + 12 layers): a
  `generate_seq2seq` rollout (64 prompts, 64 new tokens) and one
  `forward_train` experience pass against the plain bf16 and fp32 math,
  then `trlx_tpu_torch.train` with model_arch_type "seq2seq" and the
  settings of examples/ppo_sentiments_t5.py (two cycles of 48 rollouts,
  32 optimizer steps) and one train step against the same references;
- offline ILQL: `trlx_tpu_torch.train(samples=..., rewards=...)` on 64
  byte dialogues of 32 + 32 tokens at GPT-2-small width (16 steps of
  batch 32, evaluations sweeping beta over [0, 1] through the logits
  processor; the Polyak sync checked to fp32 rounding, a beta = 0
  evaluation against the processor-free sampler, one step and one
  processor decode step against the plain bf16 and fp32 math), and at
  T5-base width (8 steps of batch 12, greedy beta-swept evaluations, one
  step against the same references); then the randomwalks ILQL runner
  with the JAX example's config (final optimality at beta 100 >= 0.9);
- RFT: `train.trainer="TPURFTTrainer"` at GPT-2-small widths over the
  byte vocabulary (16 prompts x 4 generations a round, 8 steps; each
  selection recomputed from the printed scores; one step against the
  same references), then the randomwalks RFT runner (>= 0.85);
- GRPO: `train.trainer="TPUGRPOTrainer"` at GPT-2-small widths over the
  byte vocabulary (two cycles of 8 prompts x 8 samples, 16 steps, a full
  frozen reference; the stored advantages recomputed from the printed
  scores, the reference bit for bit the initial policy, the
  advantage-weighted logprob change > 0; one step against the same
  references), and one cycle through the decode engine;
- DPO: `train(samples=[(prompt, chosen, rejected), ...])` with
  `train.trainer="TPUDPOTrainer"` at GPT-2-small width (64 separable
  pairs, 16 steps of 32 pairs stacked into 64-row forwards; the final
  accuracy > 0.9, the margin grew, the reference frozen; one step on 256
  pairs against the same references);
- the Llama family at Llama-2-7B's widths (4096 / 32 heads of 128 /
  11008 / 32000, rotary, RMSNorm, SwiGLU, an untied head; cut to 4 of its
  32 layers), loaded from a local HF directory that the script writes
  from the seed's random weights: `train(model_path=<dir>)` (PPO, 32
  prompts, 32 new tokens, batch 16, 8 steps, the hydra reference over the
  top two blocks and lm_head) with exact launches of kernels 1, 2/3 and 8
  at head width 128; the run's HF export reloaded bit for bit; a greedy
  rollout and one train step against the plain bf16 and fp32 math; one
  cycle through the decode engine (kernel 7 at head width 128). Before
  the paths, the four kernels' cases at head width 128 (GQA at
  Llama-3-8B's and Llama-2-70B's attention, int8 decode groups 1-8).
- the peft tier (`peft_phases`): LoRA PPO (r 8, alpha 32 on q, k, v and
  o; examples/ppo_sentiments_peft.py) at GPT-2 small's full width and
  all 12 layers on the training path's workload, two cycles through the
  static sampler and one through the decode engine, its HF-peft export
  reloaded bit for bit and one train step against the plain bf16 and
  fp32 math; prompt and prefix
  tuning (10 virtual tokens) on the same workload, with their greedy
  rollouts against the plain bf16 path and the prefix's keys and values'
  gradient against the same references; T5-base LoRA, one cycle of the
  T5 train path at all 12 + 12 layers; LoRA PPO at Llama-2-7B's
  published widths and 32 layers
  (one step of batch 8), with its peak device memory beside what a
  full-parameter AdamW run would hold. Before them, kernels 1, 2/3 and 8
  at the adapters' layouts (T + 10 rows; T queries over 10 + T keys at
  q_offset 10) against their plain versions. Each run's base stays bit
  for bit as its seed drew it.
- the single-chip memory recipe (`memory_phases`): kernel 9 (the fused
  8-bit AdamW step) and kernel 10 (the W8A16 product of int8 decode
  weights) against their plain versions; the recipe PPO cell, the train
  path's workload under `configs/mesh/single_chip_1p3b.yml` (bf16
  gradients, remat "full", the fused 8-bit AdamW, int8 decode weights and
  KV cache, the hydra reference over the top two blocks) with two
  microbatches a step: exact launches of kernels 1, 2/3, 8, 9 and 10 (the
  remat recompute included), one train step against the plain bf16 and
  fp32 math, greedy agreement with the plain path on the same int8
  weights; then full-parameter SFT at Llama-2-7B's widths and all 32
  layers (6.74 B random parameters drawn on the card, batch 8 of 512
  tokens, 3 steps, an evaluation of 32 prompts x 32 new tokens on int8
  decode weights): peak device memory at most 66 GB beside the 54.1 GB
  the recipe's state takes, the loss falls, exact launches (kernels 1 and
  2/3 on their long routes).

Launch counters, zeroed before each path and read after it, show each
path ran through its kernels. Then the kernels are timed at the paths'
shapes beside their bounds, and one rollout, one experience pass, one
train step and one engine call of each mode are profiled.

`--only sft` runs the build and the supervised fine-tuning phases alone;
`--only ppo` the build, the training path and the three PPO phases above;
`--only resume` the build and `resume_path`;
`--only ilql`, `--only rft`, `--only grpo` and `--only dpo` the build and
the ILQL, RFT, GRPO or DPO phases; `--only llama` the build, the head
width 128 kernel cases, the Llama path and its kernel_time rows; `--only
peft` the build, the peft phases and their kernel_time rows; `--only
memory` the build, the memory phases and kernels 9 and 10's rows; `--only
w8a16` the build, kernel 10's check (both routes, every tiling, bit for bit
on a second call) and its kernel_time rows at the recipe and 7B cells'
shapes (W8A16_PATH_SHAPES; no path runs, so its rows carry no
launches); `--only adam8bit` the build, kernel 9's check (every
ADAM8_LEAVES leaf: fp32 and bf16 gradients, the fused and bnb variants,
whether each case was bit for bit) and its kernel_time rows (no
launches); `--only health` the build and the health phases: a real CUDA
OOM under a process memory cap walks the memory doctor's split_microbatch
rung (the losses and weights against a run split by a chaos OOM, the
losses, gradients and update against an unsplit run) and its shrink_pool
rung (greedy rollouts against the uncapped pool's), the preflight plan's
state rows against the bytes the trainer holds (the GPT-2 and recipe
cells) and an over-budget config rejected before any rollout, and a chaos
NaN that the guardrails roll back to the committed checkpoint bitwise,
then a chaos hbm_creep that trips the watermark.
`--only fwd` stops after the build, the flash forward's check and its
kernel_time rows; `--only paged` after the build, the paged check and the
paged kernel_time rows; `--only decode` after the build, the int8 decode
check and its kernel_time rows; `--only bias` after the build, the bias
kernels' check and their kernel_time rows (no path runs, so those rows
carry no launches).

Each phase prints one JSON line. The last two lines are the card's name
and power limit as nvidia-smi reports them, then
{"ok": true, "device": {...}}. Any failure raises and exits non-zero
without that line; with no CUDA device the script exits 2 at once.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
GPT2_SMALL = dict(
    vocab_size=50257, hidden_size=768, n_layer=12, n_head=12, n_positions=1024,
    layer_norm_epsilon=1e-5, activation="gelu_new", tie_word_embeddings=True,
)
PROMPTS, PROMPT_LEN, NEW_TOKENS = 64, 32, 40
TRAIN_NEW_TOKENS = 32  # bench.py's headline workload: 32-token prompts + 32 new tokens
TRAIN_LEN = PROMPT_LEN + TRAIN_NEW_TOKENS
# T5-base, the published t5-base config.json (the architecture of
# lvwerra/t5-imdb, which examples/ppo_sentiments_t5.py trains)
T5_BASE = dict(
    vocab_size=32128, d_model=768, n_layer=12, n_decoder_layer=12, n_head=12, d_kv=64, d_ff=3072,
    relative_attention_num_buckets=32, relative_attention_max_distance=128,
    layer_norm_epsilon=1e-6, activation="relu", tie_word_embeddings=True,
)
# The earlier slices' GPT-2-small and T5-base paths run at full width and
# at 4 of the models' 12 layers (12 encoder + 12 decoder for T5), so that the
# whole script stays well inside its 1200 s limit; the peft tier's GPT-2 and
# T5 runs keep all 12 (peft_config, peft_t5_path)
EARLIER_LAYERS = 4
GPT2_PATHS = dict(GPT2_SMALL, n_layer=EARLIER_LAYERS)
T5_PATHS = dict(T5_BASE, n_layer=EARLIER_LAYERS, n_decoder_layer=EARLIER_LAYERS)
T5_PROMPT_LEN, T5_NEW_TOKENS = 32, 64
T5_DEC_LEN = T5_NEW_TOKENS + 1  # the decoder start token and the response
# t5_reference's floor on the per-step greedy agreement (same prefix) of the
# kernel path with the plain bf16 path: measured 95.1% at seed 0 and 100% at
# seeds 1 and 2 (whose random weights give the same tokens on every path),
# against 93.4% between the plain bf16 and fp32 paths at seed 0
T5_STEP_AGREEMENT = 0.90
# CTAs an SM the short int8 decode kernel reaches at the rollout shape (48
# registers a thread, 19,392 B of shared memory; H100): the build gate
DECODE_SHORT_CTAS = 10


_START = time.perf_counter()
# the temporary root every train() run's checkpoints go under (ckpt_dir)
_CKPT_ROOT: list = []


def emit(phase: str, **fields) -> None:
    """One JSON line per phase; `t_s` is the command's seconds so far."""
    print(json.dumps({"phase": phase, "t_s": round(time.perf_counter() - _START, 3), **fields}), flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def timed(fn, reps: int = 3, warmup: bool = True) -> tuple:
    """Wall seconds of `reps` synchronised calls of `fn` (after one
    warm-up call unless `warmup` is off): (their median, the samples, the
    last call's result)."""
    import torch

    if warmup:
        fn()
    samples = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples), samples, out


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events. The 64 MB buffer
    written before each sample evicts the 50 MB L2, so inputs come from
    device memory as in the model; the sleep queued ahead keeps the host's
    enqueue time out of the measurement."""
    import torch

    for _ in range(warmup):
        fn()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    events = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def ptxas_report(log: str, kernel: str) -> list:
    """Registers, stack, spills and static shared memory of each compiled
    entry whose (mangled) name holds `kernel`, from the `-Xptxas -v` log;
    `nk` is the template argument of an instantiation."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = {"function": m.group(1)} if kernel in m.group(1) else None
            if cur is not None:
                ints = [int(x) for x in re.findall(r"Li(\d+)E", m.group(1))]
                cur["nk"] = ints[0] if ints else None
                cur["template_ints"] = ints
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", ln)
        if m:
            cur["static_smem"] = int(m.group(1))
    return out


def bound_ms(n_bytes: float, n_flops: float, flops_per_s: float = BF16_FLOPS):
    t_bytes, t_flops = n_bytes / HBM_BYTES_PER_S, n_flops / flops_per_s
    return max(t_bytes, t_flops) * 1e3, "bytes" if t_bytes >= t_flops else "operations"


# ---------------------------------------------------------------------------
# kernel inputs
# ---------------------------------------------------------------------------


def flash_inputs(gen, B, H, Hkv, T, S, D, q_offset, pad="left"):
    """bf16 q/k/v and a key mask. `pad`: "left" pads each row's start
    (batch row 0 fully: every query fully masked); "prefill" also masks
    the cache slots past the prompt, as a prefill sees them; "right" keeps
    each row's real tokens first and pads its end, as SFT's batches are
    (batch row 0 holds one real token, so every causal query row sees at
    least slot 0); "both" (T = S, q_offset 0) is a PPO row cut at a stop
    string: a left-padded prompt in the first half (at least one real
    token) and a right-padded response in the second, every other row's
    response wholly padded (batch row 0: one real token and nothing
    else); "virtual" is prompt or prefix tuning's layout: PEFT_VIRTUAL
    virtual slots always attendable, then a left-padded sequence (batch row
    0 wholly padded)."""
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v = randn(B, H, T, D), randn(B, Hkv, S, D), randn(B, Hkv, S, D)
    slots = torch.arange(S, device="cuda")[None, :]
    if pad == "both":
        left = torch.randint(0, T // 2, (B,), generator=gen, device="cuda")
        right = torch.randint(0, T // 2 + 1, (B,), generator=gen, device="cuda")
        right[::2] = T - T // 2
        left[0] = T // 2 - 1
        return q, k, v, ((slots >= left[:, None]) & (slots < S - right[:, None])).to(torch.int32)
    if pad == "right":
        n_pad = torch.randint(0, S // 2 + 1, (B,), generator=gen, device="cuda")
        n_pad[0] = S - 1
        return q, k, v, (slots < S - n_pad[:, None]).to(torch.int32)
    if pad == "virtual":
        n = PEFT_VIRTUAL
        n_pad = torch.randint(0, (S - n) // 2 + 1, (B,), generator=gen, device="cuda")
        n_pad[0] = S - n  # a wholly padded sequence: its queries see the virtual slots alone
        return q, k, v, ((slots < n) | (slots >= n + n_pad[:, None])).to(torch.int32)
    n_pad = torch.randint(0, T // 2 + 1, (B,), generator=gen, device="cuda")
    n_pad[0] = T  # one fully padded row: every query fully masked
    mask = (slots >= q_offset + n_pad[:, None]) | (slots < q_offset)
    if pad == "prefill":
        mask &= slots < q_offset + T
    return q, k, v, mask.to(torch.int32)


def flash_work(mask, H, Hkv, T, S, D, q_offset, causal=True):
    """Bytes and operations the attention function needs on this mask. A
    query row weighs the unmasked slots of its causal window (without
    `causal`: every unmasked slot), so K is needed only for slots inside
    some row's window; a fully masked row averages V over all S slots, so V
    is needed in full for the batch rows that hold one and only for the
    weighed slots elsewhere. q and out are bf16, m and l fp32, the mask
    int32."""
    import torch

    slots = torch.arange(S, device="cuda")
    rows = torch.arange(T, device="cuda")[:, None] + q_offset
    pairs = (mask[:, None, :] > 0).expand(-1, T, -1)  # [B, T, S]
    if causal:
        pairs = pairs & (rows >= slots[None, :])[None]
    weighed = pairs.any(dim=1)  # [B, S]
    full_rows = ~pairs.any(dim=2)  # [B, T]
    v_slots = torch.where(full_rows.any(dim=1), S, weighed.sum(dim=1))
    B = mask.shape[0]
    n_bytes = (2 * Hkv * D * (int(weighed.sum().item()) + int(v_slots.sum().item()))
               + 2 * 2 * B * H * T * D + 2 * 4 * B * H * T + 4 * B * S)
    n_flops = H * (4 * D * int(pairs.sum().item()) + 2 * D * S * int(full_rows.sum().item()))
    return n_bytes, n_flops


def decode_work(mask, H, Hkv, S, D):
    """Bytes and operations one int8 decode step needs on this mask: the
    int8 K and V rows and the K scales of the attendable slots (V of every
    slot for a fully masked row), this layer's V scales, bf16 q and out,
    the int32 mask."""
    import torch

    B = mask.shape[0]
    n_valid = (mask > 0).sum(dim=1)
    v_slots = torch.where(n_valid == 0, S, n_valid)
    n_bytes = (Hkv * (int(n_valid.sum().item()) * (D + 4) + int(v_slots.sum().item()) * D)
               + 4 * B * Hkv * D + 2 * 2 * B * H * D + 4 * B * S)
    return n_bytes, 4 * D * H * int(n_valid.sum().item())


def decode_inputs(gen, L, B, H, Hkv, S, D, written, pads=None):
    """An int8 cache of S slots with `written` written, each row left-padded
    by `pads` slots (random, under written / 2, when None)."""
    import torch

    q = torch.randn((B, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    ck = torch.randint(-127, 128, (L, B, Hkv, S, D), generator=gen, device="cuda").to(torch.int8)
    cv = torch.randint(-127, 128, (L, B, Hkv, S, D), generator=gen, device="cuda").to(torch.int8)
    ks = torch.rand((L, B, Hkv, 1, S), generator=gen, device="cuda") * 0.02
    vs = torch.rand((L, B, Hkv, 1, D), generator=gen, device="cuda") * 0.02
    pad = (torch.randint(0, written // 2, (B,), generator=gen, device="cuda") if pads is None
           else torch.full((B,), pads, device="cuda"))
    slots = torch.arange(S, device="cuda")[None, :]
    mask = ((slots >= pad[:, None]) & (slots < written)).to(torch.int32)
    return q, ck, cv, ks, vs, mask


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def fwd_counters():
    """The flash forward's launch counters: every launch, and each route's."""
    from trlx_tpu_torch.ops import flash_attention as fa

    return {"flash_fwd": fa.flash_attention, "flash_fwd_short": fa.flash_attention_fwd_short,
            "flash_fwd_long": fa.flash_attention_fwd_long}


def decode_counters():
    """The int8 decode step's launch counters: every launch, and each route's."""
    from trlx_tpu_torch.ops import decode_attention as da

    return {"decode": da.decode_attention_int8, "decode_short": da.decode_attention_int8_short,
            "decode_long": da.decode_attention_int8_long}


def paged_counters():
    """The paged step's launch counters: every launch, and each route's."""
    from trlx_tpu_torch.ops import decode_attention as da

    return {"paged": da.paged_attention, "paged_short": da.paged_attention_short,
            "paged_long": da.paged_attention_long}


def check_flash(gen, cases=None, phase="flash_check") -> dict:
    """Kernel 1 against flash_attention_plain on the same bf16 inputs: max
    |error| of out under 2e-2, m and l within 1e-3 relative. Each case runs
    the route `forward_route` names, and the launch counters must show that
    route and no other; a case the short kernel takes also runs the long
    route's kernel on the same inputs, held to the same bars. Returns the
    worst |error| of each route, and under "by_case" each case's own on
    the route the wrapper took. `cases` replaces the head width 64 cases
    below (FLASH_D128_CASES)."""
    import torch

    from trlx_tpu_torch.ops import flash_attention as fa
    from trlx_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain, forward_route

    cases = cases or {  # name: (B, H, Hkv, T, S, D, q_offset, pad, causal)
        "prefill": (64, 12, 12, PROMPT_LEN, 128, 64, 0, "prefill", True),
        "teacher_forced": (64, 12, 12, PROMPT_LEN + NEW_TOKENS, PROMPT_LEN + NEW_TOKENS, 64, 0, "left", True),
        "long": (8, 12, 12, 1024, 1024, 64, 0, "left", True),
        "gqa": (8, 12, 4, 200, 200, 64, 0, "left", True),
        "prefill_offset": (4, 4, 4, 37, 128, 64, 5, "prefill", True),  # ragged, at an offset
        # T5's cross-attention: not causal, no scale, 65 decoder rows over
        # a 32-slot encoder (the default offset S - T is negative, ignored)
        "t5_cross": (12, 12, 12, T5_DEC_LEN, T5_PROMPT_LEN, 64, 0, "left", False),
        "max_short": (8, 12, 12, 128, 128, 64, 0, "left", True),  # the short kernel's largest shape
        "just_long": (4, 12, 12, 129, 129, 64, 0, "left", True),  # the long route's shortest shape
        "gqa_short": (8, 12, 4, 100, 100, 64, 0, "left", True),  # a GQA group of 3 on the short route
        # T > S, causal at the default offset S - T: the first 32 rows attend
        # no slot (fully masked by causality, not by padding)
        "causal_t_gt_s": (4, 12, 12, 80, 48, 64, -32, "left", True),
        # the SFT path's train steps (SFT_BATCH x SFT_SEQ): right-padded rows, real tokens first
        "sft_right_pad": (32, 12, 12, 64, 64, 64, 0, "right", True),
        # PPO rows cut at a stop string (stop_path): padded prompts and
        # padded responses, at the experience pass's and the train step's shapes
        "ppo_both_pad": (64, 12, 12, TRAIN_LEN, TRAIN_LEN, 64, 0, "both", True),
        "ppo_both_pad_train": (32, 12, 12, TRAIN_LEN, TRAIN_LEN, 64, 0, "both", True),
        # DPO's step (dpo_path): the chosen and rejected rows of 32 pairs
        # stacked, right-padded, through the policy and the reference
        "dpo_right_pad": (64, 12, 12, TRAIN_LEN, TRAIN_LEN, 64, 0, "right", True),
    }
    counters = fwd_counters()
    worst = {"short": 0.0, "long": 0.0, "by_case": {}}
    for name, (B, H, Hkv, T, S, D, off, pad, causal) in cases.items():
        q, k, v, mask = flash_inputs(gen, B, H, Hkv, T, S, D, off, pad)
        kw = dict(q_offset=off if pad == "prefill" else None, with_stats=True, causal=causal,
                  sm_scale=None if causal else 1.0)
        route = forward_route(T, S, D)
        for fn in counters.values():
            fn.launches = 0
        got = {route: flash_attention(q, k, v, mask, **kw)}
        torch.cuda.synchronize()
        launched = {key: fn.launches for key, fn in counters.items()}
        want = {"flash_fwd": 1, "flash_fwd_short": int(route == "short"), "flash_fwd_long": int(route == "long")}
        if launched != want:
            raise AssertionError(f"{name}: the {route} route launched {launched}, expected {want}")
        if route == "short":
            km = fa._check_inputs(q, k, v, mask)
            _, scale, q_offset = fa._prepare(q, k, mask, kw["sm_scale"], kw["q_offset"], causal)
            got["long"] = fa.flash_attention_fwd_long(q, k, v, km, causal, scale, q_offset)
            torch.cuda.synchronize()
        ref, m_ref, l_ref = flash_attention_plain(q.float(), k.float(), v.float(), mask, **kw)
        errs = {}
        for r, (out, m, l) in got.items():
            errs[r] = {"max_abs_err": (out.float() - ref).abs().max().item(),
                       "m_rel_err": ((m - m_ref).abs() / m_ref.abs().clamp(min=1.0)).max().item(),
                       "l_rel_err": ((l - l_ref).abs() / l_ref.abs().clamp(min=1.0)).max().item()}
        emit(phase, case=name, shape=[B, H, Hkv, T, S, D], causal=causal, route=route, launches=launched,
             **errs[route], errs=errs)
        for r, e in errs.items():
            if not (e["max_abs_err"] <= 2e-2 and e["m_rel_err"] <= 1e-3 and e["l_rel_err"] <= 1e-3):
                raise AssertionError(f"flash kernel ({r} route) disagrees with its plain version on {name}: {e}")
            worst[r] = max(worst[r], e["max_abs_err"])
        worst["by_case"][name] = errs[route]["max_abs_err"]
    return worst


BWD_CASES = {  # name: (B, H, Hkv, T, S, q_offset, pad, causal)
    "train": (32, 12, 12, TRAIN_LEN, TRAIN_LEN, 0, "left", True),
    "experience": (64, 12, 12, PROMPT_LEN + NEW_TOKENS, PROMPT_LEN + NEW_TOKENS, 0, "left", True),
    "prefill_offset": (4, 4, 4, 37, 128, 5, "prefill", True),
    "gqa": (8, 12, 4, 200, 200, 0, "left", True),
    "long": (8, 12, 12, 1024, 1024, 0, "left", True),
    "ragged": (4, 12, 12, 50, 100, 50, "left", True),  # T < S, S not a multiple of 64
    "t5_cross": (12, 12, 12, T5_DEC_LEN, T5_PROMPT_LEN, 0, "left", False),  # not causal, T > S, scale 1
    "max_fused": (8, 12, 12, 128, 128, 0, "left", True),  # the fused kernel's largest shape
    "gqa_fused": (8, 12, 4, 100, 100, 0, "left", True),  # a GQA group of 3 inside one CTA
    # T > S, causal at the default offset S - T: the first 32 rows attend
    # no slot (fully masked by causality, not by padding)
    "causal_t_gt_s": (4, 12, 12, 80, 48, -32, "left", True),
    "just_long": (4, 12, 12, 129, 129, 0, "left", True),  # the long route's shortest shape
    # the SFT path's train steps (SFT_BATCH x SFT_SEQ): right-padded rows, real tokens first
    "sft_right_pad": (32, 12, 12, 64, 64, 0, "right", True),
    # the train steps of PPO rows cut at a stop string: padded prompts, padded responses
    "ppo_both_pad": (32, 12, 12, TRAIN_LEN, TRAIN_LEN, 0, "both", True),
    # DPO's step: 32 pairs' chosen and rejected rows stacked, right-padded
    "dpo_right_pad": (64, 12, 12, TRAIN_LEN, TRAIN_LEN, 0, "right", True),
}


def flash_bwd_inputs(gen, B, H, Hkv, T, S, q_offset, pad, causal=True, D=64):
    """Kernel inputs of the backward: q/k/v/mask as `flash_inputs` makes
    them with `pad`, the forward kernel's (out, m, l) and a bf16 output
    gradient. Without `causal` the scale is T5's 1.0."""
    import torch

    from trlx_tpu_torch.ops.flash_attention import flash_attention

    q, k, v, mask = flash_inputs(gen, B, H, Hkv, T, S, D, q_offset, pad)
    out, m, l = flash_attention(q, k, v, mask, q_offset=q_offset, with_stats=True, causal=causal,
                                sm_scale=None if causal else 1.0)
    g = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
    return q, k, v, mask, out, m, l, g


def long_route(q, k, v, mask, g, m, l, causal, scale, q_offset):
    """(dq, dk, dv) by the flash backward's long route (the dq kernel, then
    the dk/dv kernel) at any length: the route the wrapper takes past 128
    queries or keys."""
    from trlx_tpu_torch.ops.flash_attention import backward_operands, flash_attention_dkv, flash_attention_dq

    km, g = backward_operands(q, k, v, mask, g, m, l)
    dq, delta = flash_attention_dq(q, k, v, km, g, m, l, causal, scale, q_offset)
    dk, dv = flash_attention_dkv(q, k, v, km, g, m, l, delta, causal, scale, q_offset)
    return dq, dk, dv


def check_flash_bwd(gen, cases=None, D=64, phase="flash_bwd_check") -> dict:
    """Both routes of the flash backward (the fused kernel up to 128
    queries and keys, the dq and dk/dv kernels past that) against
    flash_attention_backward_plain on the same bf16 inputs upcast to fp32:
    max |error| / max(|ref|, 1) under 2e-2 for dq, dk and dv, and for dv
    of batch row 0 alone (left-padded cases: fully padded, so every query
    of it is fully masked and its dv is the uniform 1/l weights' sum of dO
    at every slot; right- and both-padded: one real token). Each case runs the route
    the wrapper picks, and the launch counters must show that route and no
    other; a case the fused kernel takes also runs the long route, and the
    fused kernel's results must be bit-identical on a second call. Returns
    the worst max |error| of each kernel, and under "by_case" each case's
    own (the largest over its kernels' dq, dk and dv). `cases` and `D`
    replace BWD_CASES and the head width 64 (BWD_D128_CASES)."""
    import torch

    from trlx_tpu_torch.ops import flash_attention as fa
    from trlx_tpu_torch.ops.flash_attention import (
        backward_route,
        flash_attention_backward,
        flash_attention_backward_plain,
    )

    def rel(a, b):
        return ((a.float() - b).abs().max() / b.abs().max().clamp(min=1.0)).item()

    counters = {"fused": fa.flash_attention_bwd, "dq": fa.flash_attention_dq, "dkv": fa.flash_attention_dkv}
    worst = {"rel": 0.0, "fused": 0.0, "dq": 0.0, "dkv": 0.0, "by_case": {}}  # max |error| of each kernel's outputs
    for name, (B, H, Hkv, T, S, off, pad, causal) in (cases or BWD_CASES).items():
        q, k, v, mask, out, m, l, g = flash_bwd_inputs(gen, B, H, Hkv, T, S, off, pad, causal, D)
        scale = D ** -0.5 if causal else 1.0
        route = backward_route(T, S, D)
        for fn in counters.values():
            fn.launches = 0
        got = {route: flash_attention_backward(q, k, v, mask, out, m, l, g, causal, scale, off)}
        torch.cuda.synchronize()
        launched = {key: fn.launches for key, fn in counters.items()}
        want = {"fused": 1, "dq": 0, "dkv": 0} if route == "fused" else {"fused": 0, "dq": 1, "dkv": 1}
        if launched != want:
            raise AssertionError(f"{name}: the {route} route launched {launched}, expected {want}")
        same = None
        if route == "fused":
            again = flash_attention_backward(q, k, v, mask, out, m, l, g, causal, scale, off)
            got["long"] = long_route(q, k, v, mask, g, m, l, causal, scale, off)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got["fused"], again))
        ref = flash_attention_backward_plain(
            q.float(), k.float(), v.float(), mask, out.float(), m, l, g.float(), causal, scale, off
        )
        errs, abs_err = {}, {}
        for r, res in got.items():
            errs[r] = {key: rel(a, b) for key, a, b in zip(("dq", "dk", "dv"), res, ref)}
            errs[r]["dv_fully_masked_row"] = rel(res[2][0], ref[2][0])
            abs_err[r] = {key: (a.float() - b).abs().max().item() for key, a, b in zip(("dq", "dk", "dv"), res, ref)}
        emit(phase, case=name, shape=[B, H, Hkv, T, S, D], q_offset=off, causal=causal, route=route,
             launches=launched, rel_err=errs, max_abs_err=abs_err, fused_bitwise_same_rerun=same,
             dv_masked_row_ref_max=ref[2][0].abs().max().item())
        if not all(e < 2e-2 for r in errs.values() for e in r.values()):
            raise AssertionError(f"flash backward kernels disagree with the plain version on {name}: {errs}")
        if same is False:
            raise AssertionError(f"the fused flash backward is not bit-identical on a second call on {name}")
        worst["rel"] = max(worst["rel"], *(e for r in errs.values() for e in r.values()))
        if "fused" in abs_err:
            worst["fused"] = max(worst["fused"], *abs_err["fused"].values())
        worst["dq"] = max(worst["dq"], abs_err["long"]["dq"])
        worst["dkv"] = max(worst["dkv"], abs_err["long"]["dk"], abs_err["long"]["dv"])
        worst["by_case"][name] = {r: max(e.values()) for r, e in abs_err.items()}
    return worst


BIAS_CASES = {  # name: (B, H, T = S, causal, mask kind)
    "encoder": (12, 12, T5_PROMPT_LEN, False, "right_pad"),
    "decoder": (12, 12, T5_DEC_LEN, True, "pad_tail"),
    "max_fused": (12, 12, 128, True, "pad_tail"),  # the fused backward's largest shape
    "one": (12, 12, 1, True, "right_pad"),
    "b64": (64, 12, T5_DEC_LEN, True, "pad_tail"),  # 768 CTAs: a head's rows in several waves
    "b64_encoder": (64, 12, T5_PROMPT_LEN, False, "right_pad"),  # the T5 path's encoder
    "long": (4, 12, 512, False, "right_pad"),
    "ragged": (4, 12, 100, True, "masked_row"),
    "ilql_decoder": (12, 12, 33, True, "pad_tail"),  # T5 ILQL's decoder: the start token + 32
}


def flash_bias_inputs(gen, B, H, T, causal, kind):
    """bf16 q/k/v, an fp32 bias [H, T, T], a key mask and a bf16 output
    gradient, with the forward kernel's (out, m, l). Masks: right padding
    (an encoder prompt), a padded response tail (the decoder: slot 0, the
    start token, always valid), or right padding with batch row 0 wholly
    masked (every query of it averages V uniformly)."""
    import torch

    from trlx_tpu_torch.ops.flash_attention import flash_attention_bias

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q, k, v = (randn(B, H, T, 64).to(torch.bfloat16) for _ in range(3))
    bias = randn(H, T, T)
    length = torch.randint(T // 2, T + 1, (B,), generator=gen, device="cuda")
    length[-1] = T
    mask = (torch.arange(T, device="cuda")[None, :] < length[:, None]).to(torch.int32)
    if kind == "masked_row":
        mask[0] = 0
    out, m, l = flash_attention_bias(q, k, v, mask, bias, causal=causal, with_stats=True)
    g = randn(B, H, T, 64).to(torch.bfloat16)
    return q, k, v, mask, bias, out, m, l, g


def bias_long_route(q, k, v, mask, bias, g, m, l, causal):
    """(dq, dk, dv, dbias) by the bias backward's long route (the dq +
    dbias kernels, then the dk/dv kernel) at any length: the route the
    wrapper takes past 128 queries or keys."""
    from trlx_tpu_torch.ops.flash_attention import (
        _check_bias,
        backward_operands,
        flash_attention_bias_dkv,
        flash_attention_bias_dq,
    )

    km, g = backward_operands(q, k, v, mask, g, m, l)
    bias32 = _check_bias(q, k, bias, causal)
    dq, dbias, delta = flash_attention_bias_dq(q, k, v, km, bias32, g, m, l, causal, 1.0)
    dk, dv = flash_attention_bias_dkv(q, k, v, km, bias32, g, m, l, delta, causal, 1.0)
    return dq, dk, dv, dbias


def check_flash_bias(gen) -> dict:
    """Kernels 4-6 (the bias forward's two routes: one CTA per head up to
    128 queries and keys, 64-row query tiles past that; the backward's two
    routes: the fused kernel up to 128 queries and keys, the dq + dbias and
    dk/dv kernels past that) against the plain versions on the same bf16
    inputs upcast to fp32: out, dq, dk, dv and dbias each within 2e-2 of
    max |error| / max(|ref|, 1). Each case runs the routes the wrapper
    picks, and the launch counters must show the forward's route and no
    other; a case the short forward takes also runs the long forward, and
    the short one again, which must give the same bits; a case the fused
    backward takes also runs the backward's long route. m and l are held
    row by row, within 2e-2 of |error| / max(|ref|, 1), on the rows that
    attend some slot; a row that attends none must hold exactly m = -1e30
    and l = S (every slot weighs exp(0)), on both forward routes. The fused
    kernel's results must be bit-identical when it runs again on the same
    inputs, and again after a launch with more heads, which leaves its
    arrival counters zero as every launch must."""
    import torch

    from trlx_tpu_torch.ops import flash_attention as fa
    from trlx_tpu_torch.ops.flash_attention import (
        NEG_INF,
        _bias_valid_pairs,
        bias_backward_route,
        bias_forward_route,
        flash_attention_bias,
        flash_attention_bias_backward,
        flash_attention_bias_backward_plain,
        flash_attention_bias_bwd_occupancy,
        flash_attention_bias_plain,
        flash_bias_fwd_short_occupancy,
    )

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1.0)).item()

    def rel_rows(a, b, rows):
        if not rows.any():
            return 0.0
        return ((a - b).abs() / b.abs().clamp(min=1.0))[rows].max().item()

    def max_abs(a, b):
        return (a.float() - b.float()).abs().max().item()

    # max |error| of each kernel's outputs
    worst = {"fwd_short": 0.0, "fwd_long": 0.0, "fused": 0.0, "dq_dbias": 0.0, "dkv": 0.0}
    counters = bias_fwd_counters()
    for name, (B, H, T, causal, kind) in BIAS_CASES.items():
        for fn in counters.values():
            fn.launches = 0
        q, k, v, mask, bias, out, m, l, g = flash_bias_inputs(gen, B, H, T, causal, kind)
        torch.cuda.synchronize()
        fwd_route = bias_forward_route(T, T)
        launched = {key: fn.launches for key, fn in counters.items()}
        want = {"flash_bias_fwd": 1, "flash_bias_fwd_short": int(fwd_route == "short"),
                "flash_bias_fwd_long": int(fwd_route == "long")}
        if launched != want:
            raise AssertionError(f"{name}: the {fwd_route} bias forward launched {launched}, expected {want}")
        fwd = {fwd_route: (out, m, l)}
        repeat_same = None
        if fwd_route == "short":
            km, bias32 = fa._check_inputs(q, k, v, mask), fa._check_bias(q, k, bias, causal)
            fwd["long"] = fa.flash_attention_bias_fwd_long(q, k, v, km, bias32, causal, 1.0)
            again = fa.flash_attention_bias_fwd_short(q, k, v, km, bias32, causal, 1.0)
            torch.cuda.synchronize()
            repeat_same = all(torch.equal(a, b) for a, b in zip(again, fwd["short"]))
        route = bias_backward_route(T, T, causal)
        got = {route: flash_attention_bias_backward(q, k, v, mask, bias, out, m, l, g, causal, 1.0)}
        if route == "fused":
            got["long"] = bias_long_route(q, k, v, mask, bias, g, m, l, causal)
        torch.cuda.synchronize()
        f32 = [x.float() for x in (q, k, v)]
        ref_out, ref_m, ref_l = flash_attention_bias_plain(*f32, mask, bias, causal, 1.0, with_stats=True)
        ref = flash_attention_bias_backward_plain(*f32, mask, bias, out.float(), m, l, g.float(), causal, 1.0)
        # [B*H, T, 1]: does the row attend any slot
        live = _bias_valid_pairs(mask, T, T, causal, mask.device).any(-1).expand(B, H, T).reshape(B * H, T, 1)
        dead = ~live
        errs = {}
        for r, (o, m_r, l_r) in fwd.items():
            errs[f"fwd_{r}"] = {"out": rel(o, ref_out), "m": rel_rows(m_r, ref_m, live),
                                "l": rel_rows(l_r, ref_l, live)}
            if not (bool((m_r[dead] == NEG_INF).all()) and bool((l_r[dead] == T).all())):
                raise AssertionError(f"rows that attend no slot must hold m = -1e30 and l = {T} on {name} ({r} "
                                     f"forward): m {m_r[dead].unique().tolist()[:4]}, l {l_r[dead].unique().tolist()[:4]}")
        keys = ("dq", "dk", "dv", "dbias")
        bwd_errs = {r: {key: rel(a, b) for key, a, b in zip(keys, res, ref)} for r, res in got.items()}
        abs_err = {r: {key: max_abs(a, b) for key, a, b in zip(keys, res, ref)} for r, res in got.items()}
        abs_err.update({f"fwd_{r}": max_abs(o, ref_out) for r, (o, _, _) in fwd.items()})
        emit("flash_bias_check", case=name, shape=[B, H, T, T, 64], causal=causal, mask=kind, fwd_route=fwd_route,
             route=route, launches=launched, rel_err={**errs, **bwd_errs}, max_abs_err=abs_err,
             rows_attending_none=int(dead.sum().item()), fwd_short_bitwise_same_rerun=repeat_same,
             fwd_short_occupancy=flash_bias_fwd_short_occupancy(T, T, causal) if fwd_route == "short" else None,
             fused_occupancy=flash_attention_bias_bwd_occupancy(T, T) if route == "fused" else None)
        if not all(e <= 2e-2 for r in (*errs.values(), *bwd_errs.values()) for e in r.values()):
            raise AssertionError(f"bias kernels disagree with the plain versions on {name}: {errs} {bwd_errs}")
        if repeat_same is False:
            raise AssertionError(f"the short bias forward gave other bits on a repeat on {name}")
        for r in fwd:
            worst[f"fwd_{r}"] = max(worst[f"fwd_{r}"], abs_err[f"fwd_{r}"])
        if "fused" in got:
            worst["fused"] = max(worst["fused"], *abs_err["fused"].values())
        worst["dq_dbias"] = max(worst["dq_dbias"], abs_err["long"]["dq"], abs_err["long"]["dbias"])
        worst["dkv"] = max(worst["dkv"], abs_err["long"]["dk"], abs_err["long"]["dv"])

    # the fused kernel: the same bits run to run, and after a launch with
    # more heads (its arrival counters reset by every launch)
    B, H, T, causal, kind = BIAS_CASES["decoder"]
    first = flash_bias_inputs(gen, B, H, T, causal, kind)
    wider = flash_bias_inputs(gen, B, H + 4, T, causal, kind)

    def fused(inputs):
        q, k, v, mask, bias, out, m, l, g = inputs
        res = flash_attention_bias_backward(q, k, v, mask, bias, out, m, l, g, causal, 1.0)
        torch.cuda.synchronize()
        return res

    runs = [fused(first), fused(first), fused(wider), fused(first)]
    same = [all(torch.equal(a, b) for a, b in zip(runs[0], res)) for res in (runs[1], runs[3])]
    counters = {str(key): int(buf.abs().sum().item()) for key, buf in fa._BIAS_ARRIVALS.items()}
    emit("flash_bias_determinism", shape=[B, H, T, T, 64], wider_heads=H + 4, bitwise_same_rerun=same[0],
         bitwise_same_after_wider=same[1], arrival_counters_abs_sum=counters)
    if not all(same) or any(counters.values()):
        raise AssertionError(f"the fused bias backward is not deterministic or left its counters set: "
                             f"{same}, {counters}")

    # the CUDA wrapper takes the top-left causal rule only at T == S
    q, k, v, mask, bias, out, m, l, g = flash_bias_inputs(gen, 2, 12, 40, False, "right_pad")
    for what, call in (
        ("forward", lambda: flash_attention_bias(q[:, :, :20], k, v, mask, bias[:, :20], causal=True)),
        ("backward", lambda: flash_attention_bias_backward(q[:, :, :20], k, v, mask, bias[:, :20], out, m, l,
                                                           g[:, :, :20], True, 1.0)),
    ):
        try:
            call()
        except ValueError:
            continue
        raise AssertionError(f"a causal bias {what} call with T != S must raise on CUDA")
    return worst


def check_decode(gen, cases=None, D=64, phase="decode_check") -> dict:
    """Both int8 decode kernels against decode_attention_int8_plain on the
    same inputs (max abs error 2e-2), every layer of each case: the rollout
    shape; GQA at S = 200 with a fully masked row; a mask with holes inside
    its span at S = 131 (rows not a multiple of 16 bytes); GQA with a row
    attendable only at slot S - 1; S = 256, the short route's edge, with a
    fully masked row; and S = 384 on the long route. The wrapper must launch
    the route decode_route names (the counters); each case of at most
    SHORT_DECODE_MAX_SLOTS slots also runs both route kernels, and every
    kernel call is made twice and must give the same bits; the short kernel
    must refuse a longer cache. `cases` and `D` replace the cases below and
    the head width 64 (DECODE_D128_CASES)."""
    import torch

    from trlx_tpu_torch.ops.decode_attention import (
        SHORT_DECODE_MAX_SLOTS,
        decode_attention_int8,
        decode_attention_int8_long,
        decode_attention_int8_plain,
        decode_attention_int8_short,
        decode_route,
    )

    cases = cases or {  # name: (L, B, H, Hkv, S, written)
        "rollout": (12, 64, 12, 12, 128, PROMPT_LEN + NEW_TOKENS),
        "gqa": (2, 8, 12, 4, 200, 150),
        "holes": (2, 16, 12, 12, 131, 120),
        "last_slot_gqa": (2, 8, 12, 4, 128, 128),
        "edge_256": (2, 8, 12, 12, 256, 256),
        "long_384": (2, 8, 12, 4, 384, 300),
    }
    counters = decode_counters()
    kernels = {"short": decode_attention_int8_short, "long": decode_attention_int8_long}
    worst = {"short": 0.0, "long": 0.0}
    for name, (L, B, H, Hkv, S, written) in cases.items():
        q, ck, cv, ks, vs, mask = decode_inputs(gen, L, B, H, Hkv, S, D, written)
        if name in ("gqa", "edge_256", "gqa8_edge_256"):
            mask[1] = 0  # a fully masked row averages V uniformly over all S
        if name == "holes":
            mask &= (torch.rand(mask.shape, generator=gen, device="cuda") < 0.7).to(torch.int32)
        if name == "last_slot_gqa":
            mask[0] = 0
            mask[0, S - 1] = 1
        route = decode_route(S)
        routes = ("short", "long") if S <= SHORT_DECODE_MAX_SLOTS else ("long",)
        errs = {r: 0.0 for r in routes}
        identical = True
        for fn in counters.values():
            fn.launches = 0
        for ix in range(L):
            args = (q, ck, cv, ks, vs[ix], mask, ix, D ** -0.5)
            out = decode_attention_int8(*args)
            torch.cuda.synchronize()
            ref = decode_attention_int8_plain(q.float(), ck, cv, ks, vs[ix], mask, ix, D ** -0.5)
            errs[route] = max(errs[route], (out.float() - ref).abs().max().item())
            for r in routes:
                first = kernels[r](*args)
                again = kernels[r](*args)
                torch.cuda.synchronize()
                errs[r] = max(errs[r], (first.float() - ref).abs().max().item())
                identical &= bool(torch.equal(first, again)) and (r != route or bool(torch.equal(first, out)))
        launched = {k: fn.launches for k, fn in counters.items()}
        calls = L * (1 + 2 * len(routes))
        want = {"decode": L, "decode_short": int(route == "short") * L + (2 * L if "short" in routes else 0),
                "decode_long": int(route == "long") * L + 2 * L}
        emit(phase, case=name, shape=[L, B, H, Hkv, S, D], route=route, max_abs_err=errs,
             repeat_identical=identical, launches=launched, kernel_calls=calls,
             attendable_slots=int((mask > 0).sum().item()), fully_masked_rows=int((mask.sum(dim=1) == 0).sum().item()))
        if launched != want:
            raise AssertionError(f"{name}: decode_route names {route}, the counters show {launched} (want {want})")
        if max(errs.values()) > 2e-2:
            raise AssertionError(f"int8 decode kernel disagrees with its plain version on {name}: {errs}")
        if not identical:
            raise AssertionError(f"{name}: an int8 decode kernel gave other bits on a repeated call")
        if "short" not in routes:
            try:
                decode_attention_int8_short(q, ck, cv, ks, vs[0], mask, 0, D ** -0.5)
            except RuntimeError:
                pass
            else:
                raise AssertionError(f"{name}: the short decode kernel took a cache of {S} slots")
        for r, e in errs.items():
            worst[r] = max(worst[r], e)
    return {"max_abs_err": max(worst.values()), "by_route": worst}


def paged_inputs(gen, B, T, H, Hkv, PS, MP, quant, depths, L=12, nulls=(), D=64):
    """A paged pool of L layers with every lane's pages, the step's q/k/v and
    the engine's bias. Lane b holds depths[b] tokens before the step's T
    (left padding masks the first pad[b] slots); a lane's pages past its
    depth are null, and so is each (lane, page) in `nulls`, whose slots
    the bias masks as the engine's key mask does for a released page."""
    import torch

    from trlx_tpu_torch.ops import paged_kv

    S = MP * PS
    NP = 1 + B * MP
    depths = torch.tensor(depths, device="cuda")
    pad = torch.clamp(depths // 3, max=PS + 2)
    pad[depths <= 1] = 0
    pools = paged_kv.init_pool(L, NP, PS, Hkv, D, quant, torch.bfloat16, "cuda")
    if quant:
        for name in ("pk", "pv"):
            pools[name].copy_(torch.randint(-127, 128, pools[name].shape, generator=gen, device="cuda"))
        for name in ("pk_scale", "pv_scale"):
            pools[name].copy_(torch.rand(pools[name].shape, generator=gen, device="cuda") * 0.02)
    else:
        for name in ("pk", "pv"):
            pools[name].copy_(torch.randn(pools[name].shape, generator=gen, device="cuda"))
    table = (1 + torch.arange(B * MP, device="cuda")).reshape(B, MP)
    pages_used = (depths + T + PS - 1) // PS
    table[torch.arange(MP, device="cuda")[None, :] >= pages_used[:, None]] = 0
    slots = torch.arange(S, device="cuda")
    key_mask = (slots[None, :] >= pad[:, None]) & (slots[None, :] < (depths + T)[:, None])
    for b, j in nulls:
        table[b, j] = 0
        key_mask[b, j * PS:(j + 1) * PS] = False
    q_slots = depths[:, None] + torch.arange(T, device="cuda")[None, :]
    visible = (q_slots[:, :, None] >= slots[None, None, :]) & key_mask[:, None, :]
    bias = torch.where(visible, 0.0, -1e9)[:, None].float().contiguous()
    q = torch.randn((B, T, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    kn = torch.randn((B, T, Hkv, D), generator=gen, device="cuda").to(torch.bfloat16)
    vn = torch.randn((B, T, Hkv, D), generator=gen, device="cuda").to(torch.bfloat16)
    return q, kn, vn, pools, table.to(torch.int32).contiguous(), depths, bias, visible


def paged_work(visible, table, H, Hkv, T, PS, quant, D=64):
    """Bytes and operations the paged attention function needs on this
    table and mask: the K and V rows (and with int8 their per-row scales)
    of every slot some query of the lane sees, bf16 q and out, the fp32
    bias and the int32 table; 4 * D operations per visible (query head,
    slot) pair."""
    seen = visible.any(dim=1)  # [B, S]
    n_rows = int(seen.sum().item()) * Hkv
    row_bytes = 2 * D * (1 if quant else 2) + (8 if quant else 0)
    B, S = seen.shape
    n_bytes = n_rows * row_bytes + 2 * 2 * B * T * H * D + 4 * B * T * S + 4 * table.numel()
    return n_bytes, 4 * D * H * int(visible.sum().item())


def check_paged(gen, cases=None, D=64, phase="paged_check") -> dict:
    """The paged kernels against paged_attention_plain on the card, through
    paged_attention_step(impl="pallas") (the write half included): page
    sizes 8, 16 and 128, T 1 and 4, int8 and bf16 pools, GQA groups 1 and
    3, layer 5 of 12, ragged lane depths down to 1, a null page in the
    middle of a lane's table and a lane_valid=False lane, at the route
    edge too (256 slots, the short route's widest table, and 272). Each
    step must launch the route paged_route names (the counters); a case of
    at most SHORT_PAGED_MAX_SLOTS slots also runs the long kernel on the
    same pools, and the short kernel again, which must give the same bits;
    the short kernel must refuse a wider table. Every query row here sees
    some slot, so every row is compared (rel 2e-2). `cases` and `D`
    replace the cases below and the head width 64 (PAGED_D128_CASES)."""
    import torch

    from trlx_tpu_torch.ops.decode_attention import (
        SHORT_PAGED_MAX_SLOTS,
        paged_attention_long,
        paged_attention_plain,
        paged_attention_short,
        paged_attention_step,
        paged_route,
    )

    cases = cases or {  # name: (B, T, H, Hkv, PS, MP, quant, depths, nulls)
        "decode_int8_ps16": (8, 1, 12, 12, 16, 5, "int8", [1, 5, 16, 17, 40, 63, 70, 33], [(3, 1)]),
        "verify_int8_ps16": (8, 4, 12, 12, 16, 5, "int8", [1, 5, 16, 17, 40, 60, 70, 33], [(4, 1)]),
        "decode_bf16_ps8": (6, 1, 12, 4, 8, 9, None, [1, 9, 30, 64, 20, 7], [(3, 2)]),
        "verify_bf16_gqa_ps8": (6, 4, 12, 4, 8, 9, None, [2, 9, 30, 64, 20, 7], [(3, 4)]),
        "verify_int8_gqa_ps128": (4, 4, 12, 4, 128, 2, "int8", [1, 100, 127, 200], [(3, 0)]),
        "decode_int8_ps128": (4, 1, 12, 12, 128, 2, "int8", [3, 129, 250, 60], []),
        "verify_int8_gqa_ps16_mp16": (6, 4, 12, 4, 16, 16, "int8", [1, 100, 251, 37, 180, 64], [(2, 7)]),
        "verify_bf16_gqa_ps16_mp16": (4, 4, 12, 4, 16, 16, None, [251, 1, 130, 64], [(0, 6)]),
        "decode_int8_ps16_mp16": (4, 1, 12, 12, 16, 16, "int8", [255, 1, 140, 64], [(0, 3)]),
        "verify_int8_gqa_ps16_mp17": (4, 4, 12, 4, 16, 17, "int8", [1, 267, 140, 200], [(2, 4)]),
        "decode_bf16_ps16_mp17": (4, 1, 12, 12, 16, 17, None, [271, 1, 200, 33], [(0, 9)]),
    }
    counters = paged_counters()
    worst = {"short": 0.0, "long": 0.0}
    for name, (B, T, H, Hkv, PS, MP, quant, depths, nulls) in cases.items():
        q, kn, vn, pools, table, slot_pos, bias, visible = paged_inputs(
            gen, B, T, H, Hkv, PS, MP, quant, depths, nulls=nulls, D=D)
        lane_valid = torch.ones(B, dtype=torch.bool, device="cuda")
        lane_valid[1] = False
        route = paged_route(T, H, Hkv, PS, MP)
        for fn in counters.values():
            fn.launches = 0
        out, pools = paged_attention_step(q, kn, vn, pools, 5, table, slot_pos, bias, D ** -0.5,
                                          lane_valid=lane_valid, impl="pallas")
        torch.cuda.synchronize()
        launched = {k: fn.launches for k, fn in counters.items()}
        want = {"paged": 1, "paged_short": int(route == "short"), "paged_long": int(route == "long")}
        if launched != want:
            raise AssertionError(f"{name}: paged_route names {route}, the counters show {launched}")
        ref = paged_attention_plain(q.float(), pools, 5, table, bias, D ** -0.5)
        seen = visible.any(dim=-1)[:, :, None, None].expand(B, T, H, D)
        if not bool(seen.all()):
            raise AssertionError(f"{name}: every query row must see a slot")

        def rel(x):
            return ((x.float() - ref).abs().max() / ref.abs().max().clamp(min=1.0)).item()

        errs = {route: rel(out)}
        args = (q, pools, 5, table, bias, D ** -0.5)
        repeat_identical = None
        if MP * PS <= SHORT_PAGED_MAX_SLOTS:
            errs["long"] = rel(paged_attention_long(*args))
            again = paged_attention_short(*args)
            torch.cuda.synchronize()
            repeat_identical = bool(torch.equal(again, out))
        else:
            try:
                paged_attention_short(*args)
            except RuntimeError:
                pass
            else:
                raise AssertionError(f"{name}: the short kernel took a table of {MP * PS} slots")
        emit(phase, case=name, shape=[B, T, H, Hkv, PS, MP, D], quant=quant, route=route, rel_err=errs,
             short_repeat_identical=repeat_identical)
        if max(errs.values()) > 2e-2:
            raise AssertionError(f"paged kernel disagrees with its plain version on {name}: {errs}")
        if repeat_identical is False:
            raise AssertionError(f"{name}: the short kernel gave other bits on a second call")
        for k, e in errs.items():
            worst[k] = max(worst[k], e)
    return {"max_abs_err": max(worst.values()), "by_route": worst}


def check_rng(seed: int) -> None:
    """The per-lane counter stream is the same integers on the CPU and the card."""
    import torch

    from trlx_tpu_torch.models.generation import lane_bits, lane_keys

    ids = torch.arange(0, 4096 * 97, 97)
    cpu = lane_bits(lane_keys(seed, ids), 50257)
    gpu = lane_bits(lane_keys(seed, ids.cuda()), 50257).cpu()
    same = bool(torch.equal(cpu, gpu))
    emit("rng_check", lanes=len(ids), vocab=50257, identical=same)
    if not same:
        raise AssertionError("the per-lane counter stream differs between the CPU and the card")


ENGINE_BUDGETS = (8, 16, 24, 40)  # row budgets, cycling over the queue
ENGINE = dict(slots=16, page_size=16, kv_quant="int8")


def engine_path(seed: int) -> dict:
    """`engine_generate` on the hydra GPT-2-small policy (branch_at=2):
    64 byte prompts left-padded to 32, budgets cycling (8, 16, 24, 40) over
    40 new tokens, 16 slots, 16-token int8 pages, greedy; without and with
    speculative decoding (draft_k=4, the hydra draft sharing the trunk's
    pages). Each runs on the kernel (impl="pallas") and on the plain gather
    math (impl="xla") on the card. Gates: per-step (>= 95%) and
    free-running (>= 90%) greedy agreement, the exact pool balance, the
    kernel's acceptance within 5 points of the plain path's,
    paged launches == n_layer x decode_steps, every one on the short
    route, and flash launches a positive multiple of n_layer (the
    refills' prefills)."""
    import torch

    from trlx_tpu_torch.models import gen_engine as ge
    from trlx_tpu_torch.models.generation import SamplerSettings
    from trlx_tpu_torch.ops.decode_attention import paged_attention
    from trlx_tpu_torch.ops.flash_attention import flash_attention
    from trlx_tpu_torch.utils.tokenizers import ByteTokenizer

    _, policy = build_policy(seed, "pallas", "int8_kernel")
    ref = policy.make_ref_params()
    tok = ByteTokenizer()
    ids, mask = byte_prompts(tok)
    greedy = SamplerSettings(max_new_tokens=NEW_TOKENS, do_sample=False,
                             eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id)
    budget = torch.tensor([ENGINE_BUDGETS[i % 4] for i in range(PROMPTS)], device="cuda")
    L = policy.cfg.n_layer
    shared = ge.hydra_shared_trunk_layers(L, len(ref.blocks))
    draft = ge.compose_draft_params(policy.cfg, policy.base, ref)
    modes = {"plain": {}, "spec": dict(spec_decode=True, draft_k=4, draft_shared_layers=shared)}

    def run(impl, kw):
        spec = ge.EngineSpec(paged_attention_impl=impl, **ENGINE, **kw)
        return ge.engine_generate(policy.base, ids, mask, seed, greedy, spec,
                                  draft_params=draft if kw else None, row_budget=budget)

    def agree(a, b):
        real = a["response_mask"].bool() & b["response_mask"].bool()
        return (a["response_ids"] == b["response_ids"])[real].float().mean().item()

    launches, outs = {}, {}
    fwd = fwd_counters()
    paged = paged_counters()
    with torch.no_grad():
        for mode, kw in modes.items():
            for impl in ("pallas", "xla"):
                for fn in (*fwd.values(), *paged.values()):
                    fn.launches = 0
                out = run(impl, kw)
                torch.cuda.synchronize()
                outs[mode, impl] = out
                launches[mode, impl] = {"paged": paged_attention.launches,
                                        "paged_short": paged["paged_short"].launches,
                                        "paged_long": paged["paged_long"].launches,
                                        "flash": flash_attention.launches,
                                        "flash_short": fwd["flash_fwd_short"].launches,
                                        "flash_long": fwd["flash_fwd_long"].launches}
                g = out["gen_stats"]
                n_pages = 1 + ENGINE["slots"] * -(-(PROMPT_LEN + NEW_TOKENS + (4 if kw else 0)) // ENGINE["page_size"])
                balance = dict(free_pages=g["free_pages"], pool=n_pages, held_pages=g.get("held_pages", 0),
                               oom_truncated=g["oom_truncated"], unserved=g["unserved"])
                emit("engine_run", mode=mode, impl=impl, gen_stats=g, launches=launches[mode, impl],
                     pool_balance=balance)
                if (g["free_pages"], balance["held_pages"], g["oom_truncated"], g["unserved"]) != (n_pages - 1, 0, 0, 0):
                    raise AssertionError(f"engine {mode}/{impl}: the pool does not balance: {balance}")
                want = L * g["decode_steps"] if impl == "pallas" else 0
                if launches[mode, impl]["paged"] != want or g["real_tokens"] != int(out["response_mask"].sum()):
                    raise AssertionError(f"engine {mode}/{impl}: paged launches {launches[mode, impl]} != {want}")
                if (launches[mode, impl]["paged_short"], launches[mode, impl]["paged_long"]) != (want, 0):
                    raise AssertionError(f"engine {mode}/{impl}: the paged step left the short route: "
                                         f"{launches[mode, impl]}")
                # each refill prefills through the flash forward, once a layer
                n_flash = launches[mode, impl]["flash"]
                if n_flash == 0 or n_flash % L:
                    raise AssertionError(f"engine {mode}/{impl}: flash launches {n_flash} are not whole prefills")
                if (launches[mode, impl]["flash_short"], launches[mode, impl]["flash_long"]) != (n_flash, 0):
                    raise AssertionError(f"engine {mode}/{impl}: the prefills left the short route: {launches[mode, impl]}")
                if not bool((out["response_mask"].sum(dim=1) <= budget).all()):
                    raise AssertionError("a row emitted past its budget")

    # per-step agreement on the same prefix: the plain path is forced onto
    # the kernel path's tokens (the draw functions the engine calls are
    # swapped for ones that record the plain path's own argmax and return
    # the kernel's token; lane ids stand in for keys, and greedy draws
    # read no key), and each decision is compared where the kernel's row
    # emitted; the first decision recorded at a (row, index) is the one
    # made there
    kernel_ids = outs["plain", "pallas"]["response_ids"]
    own = {}
    saved = ge.lane_keys, ge.sample_token_lanes

    def record_and_force(keys, logits, settings):
        rows, cols = keys // NEW_TOKENS, keys % NEW_TOKENS
        for r, c, t in zip(rows.tolist(), cols.tolist(), logits.argmax(dim=-1).tolist()):
            own.setdefault((r, c), t)
        return kernel_ids[rows, cols]

    ge.lane_keys, ge.sample_token_lanes = (lambda base, lane_ids: lane_ids), record_and_force
    try:
        with torch.no_grad():
            run("xla", {})
    finally:
        ge.lane_keys, ge.sample_token_lanes = saved
    real = outs["plain", "pallas"]["response_mask"].bool().cpu()
    kid = kernel_ids.cpu()
    pairs = [own[r, c] == int(kid[r, c]) for r, c in torch.nonzero(real).tolist() if (r, c) in own]
    step = sum(pairs) / max(len(pairs), 1)
    free = {mode: agree(outs[mode, "pallas"], outs[mode, "xla"]) for mode in modes}
    accept = {impl: outs["spec", impl]["gen_stats"]["accepted"] / max(outs["spec", impl]["gen_stats"]["drafted"], 1)
              for impl in ("pallas", "xla")}
    emit("engine_reference", greedy_step_agreement=step, decisions=len(pairs),
         greedy_free_running_agreement=free, spec_accept_rate=accept,
         spec_vs_plain_free_running={impl: agree(outs["spec", impl], outs["plain", impl]) for impl in ("pallas", "xla")})
    if step < 0.95:
        raise AssertionError(f"only {step:.2%} of the engine's greedy decisions agree with the plain path")
    if min(free.values()) < 0.90:
        raise AssertionError(f"free-running greedy agreement {free} is under 90%")
    if accept["pallas"] < accept["xla"] - 0.05:
        raise AssertionError(f"speculative acceptance on the kernel {accept} is more than 5 points under the plain path's")

    # wall time (median of 3 after the gated run) and one traced run, for
    # each mode on the kernel path
    for mode, kw in modes.items():
        with torch.no_grad():
            wall, samples, out = timed(lambda: run("pallas", kw), warmup=False)
        emit("engine_time", mode=mode, wall_s=wall, samples_s=samples, real_tokens=out["gen_stats"]["real_tokens"],
             tokens_per_s=out["gen_stats"]["real_tokens"] / wall, decode_steps=out["gen_stats"]["decode_steps"],
             occupancy=out["gen_stats"]["occupancy"])
        with torch.no_grad():
            profile_phase(f"engine_{mode}", lambda: run("pallas", kw), wall, host_ops=False)
    return {mode: {route: launches[mode, "pallas"][f"paged_{route}"] for route in ("short", "long")}
            for mode in modes}


def build_policy(seed: int, attention_impl: str, kv_cache_quant, **transformer_kw):
    import torch

    from trlx_tpu_torch.data.default_configs import default_ppo_config
    from trlx_tpu_torch.models.wrappers import CausalLMWithValueHead

    transformer = dict(GPT2_PATHS, attention_impl=attention_impl,
                       kv_cache_quant=kv_cache_quant, **transformer_kw)
    config = default_ppo_config().evolve(
        model=dict(model_path="random", model_extra_configs={"transformer": transformer}),
        tokenizer=dict(tokenizer_path="byte"),
    )
    policy = CausalLMWithValueHead.from_config(config)
    policy.init_params(torch.Generator().manual_seed(seed))
    return config, policy


def byte_prompts(tok):
    import torch

    words = ("the", "movie", "was", "quite", "an", "experience", "and", "I", "would")
    texts = [" ".join(words[(i + j) % len(words)] for j in range(2 + i % 7)) for i in range(PROMPTS)]
    enc = tok(texts, padding="max_length", max_length=PROMPT_LEN, truncation=True)
    ids = torch.tensor(enc["input_ids"], device="cuda")
    mask = torch.tensor(enc["attention_mask"], device="cuda")
    return ids, mask


def main_path(seed: int, shapes: dict) -> dict:
    import torch

    from trlx_tpu_torch.models.generation import SamplerSettings, generate, make_generate_fn
    from trlx_tpu_torch.ops.common import logprobs_of_labels
    from trlx_tpu_torch.ops.flash_attention import flash_attention
    from trlx_tpu_torch.utils.tokenizers import ByteTokenizer

    config, policy = build_policy(seed, "pallas", "int8_kernel")
    if policy.branch_at != policy.cfg.n_layer - 2 or policy.cfg.dtype != torch.bfloat16:
        raise AssertionError("the default PPO config must give branch_at=n_layer - 2 and bf16 compute")
    ref_params = policy.make_ref_params()
    tok = ByteTokenizer()
    ids, mask = byte_prompts(tok)
    sampled = SamplerSettings.from_gen_kwargs(
        config.method.gen_kwargs, eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id
    )
    greedy = SamplerSettings(
        max_new_tokens=sampled.max_new_tokens, do_sample=False,
        eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id,
    )
    if sampled.max_new_tokens != NEW_TOKENS:
        raise AssertionError("the default PPO gen_kwargs must ask for 40 new tokens")
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def experience(model, ref, seqs, attn):
        out = model.forward_train(ref, seqs, attn)
        lp = logprobs_of_labels(out["logits"][:, :-1], seqs[:, 1:])
        return out, lp

    fwd, dec = fwd_counters(), decode_counters()
    with forward_shapes(shapes, "rollout"), torch.no_grad():
        for fn in (*fwd.values(), *dec.values()):
            fn.launches = 0
        out_g = make_generate_fn(policy.base, greedy)(ids, mask, None)
        out_s = make_generate_fn(policy.base, sampled)(ids, mask, gen)
        torch.cuda.synchronize()
        rollout_flash = flash_attention.launches
        seqs = out_s["sequences"]
        attn = torch.cat([mask, out_s["response_mask"]], dim=1)
        exp, lp = experience(policy, ref_params, seqs, attn)
        torch.cuda.synchronize()
        launches = {"flash": flash_attention.launches, "flash_short": fwd["flash_fwd_short"].launches,
                    "flash_long": fwd["flash_fwd_long"].launches, **{k: fn.launches for k, fn in dec.items()}}

    L = policy.cfg.n_layer
    steps = [int(o["response_mask"].sum(dim=1).max().item()) - 1 for o in (out_g, out_s)]
    # every forward launch on the short route (T, S <= 128), none on the
    # long; every decode launch on the short route (a 128-slot cache)
    n_flash = 2 * L + (L + (L - policy.branch_at))
    expect = {"flash": n_flash, "flash_short": n_flash, "flash_long": 0,
              "decode": L * sum(steps), "decode_short": L * sum(steps), "decode_long": 0}
    emit("main_path", launches=launches, expected=expect, decode_steps=steps,
         flash_launches_rollout=rollout_flash)
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    B, T = seqs.shape
    shapes = {"logits": (B, T, 50257), "values": (B, T), "ref_logits": (B, T, 50257)}
    for key, shape in shapes.items():
        if tuple(exp[key].shape) != shape or not torch.isfinite(exp[key]).all():
            raise AssertionError(f"{key}: shape {tuple(exp[key].shape)} or non-finite values")
    if not torch.isfinite(lp).all() or tuple(out_g["sequences"].shape) != (B, T):
        raise AssertionError("non-finite logprobs or a wrong rollout shape")

    # whole-path references on the same weights: the plain attention math
    # in bf16 ("xla"/"int8") and in fp32. Random GPT-2 weights give nearly
    # flat logits, so greedy near-ties are common and one flipped token
    # changes the rest of a free-running row, which therefore has a looser
    # floor (90%) than the per-step agreement (95%). The per-step one forces
    # the plain path onto the kernel path's tokens (through the sampler's
    # logits_processor hook) and compares each decision on the same prefix.
    _, plain = build_policy(seed, "xla", "int8")
    plain.load_state_dict(policy.state_dict())
    _, exact = build_policy(seed, "xla", None, dtype="float32")
    exact.load_state_dict(policy.state_dict())
    forced_tokens, own_choice = out_g["response_ids"], []

    def force_kernel_tokens(hidden_last, logits_last):
        t = len(own_choice)
        own_choice.append(logits_last.argmax(dim=-1))
        forced = torch.full_like(logits_last, float("-inf"))
        return forced.scatter_(1, forced_tokens[:, t:t + 1], 0.0)

    with torch.no_grad():
        out_x = generate(plain.base, ids, mask, None, greedy)
        out_f = generate(exact.base, ids, mask, None, greedy)
        generate(plain.base, ids, mask, None, greedy, logits_processor=force_kernel_tokens)
        exp_x, _ = experience(plain, plain.make_ref_params(), seqs, attn)
        exp_f, _ = experience(exact, exact.make_ref_params(), seqs, attn)

    def free_running(a, b):
        real_g = a["response_mask"].bool() & b["response_mask"].bool()
        return (a["response_ids"] == b["response_ids"])[real_g].float().mean().item()

    free = free_running(out_g, out_x)
    # the same measure between the two plain paths shows how far bf16
    # rounding alone moves free-running greedy rows on these weights
    free_fp32 = {"kernel_vs_fp32": free_running(out_g, out_f),
                 "plain_bf16_vs_fp32": free_running(out_x, out_f)}
    own = torch.stack(own_choice, dim=1)
    step = (own == forced_tokens[:, :own.shape[1]])[out_g["response_mask"].bool()[:, :own.shape[1]]]
    step = step.float().mean().item()
    real = attn.bool()[..., None]

    def max_err(a, b, key):
        return ((a[key].float() - b[key].float()).abs() * (real if a[key].dim() == 3 else real[..., 0])).max().item()

    err = {key: {"kernel_vs_fp32": max_err(exp, exp_f, key), "plain_bf16_vs_fp32": max_err(exp_x, exp_f, key),
                 "kernel_vs_plain_bf16": max_err(exp, exp_x, key)}
           for key in ("logits", "ref_logits", "values")}
    emit("reference", greedy_step_agreement=step, greedy_free_running_agreement=free,
         greedy_free_running_agreement_fp32=free_fp32, experience_max_abs_err=err)
    if step < 0.95:
        raise AssertionError(f"only {step:.2%} of greedy decisions agree with the plain path")
    if free < 0.90:  # a path that drifts over the whole rollout
        raise AssertionError(f"only {free:.2%} of free-running greedy tokens agree with the plain path")
    for key, e in err.items():
        if e["kernel_vs_fp32"] > 2 * e["plain_bf16_vs_fp32"]:
            raise AssertionError(f"{key}: the kernel path strays from fp32 more than plain bf16 does")

    # wall time (median of 3, after a warm-up) of the sampled rollout and of
    # the experience pass, then one traced run of each for the device share
    def rollout():
        return generate(policy.base, ids, mask, gen, sampled)

    def score():
        return experience(policy, ref_params, seqs, attn)

    walls, outs = {}, {}
    with torch.no_grad():
        for name, fn in (("rollout", rollout), ("experience", score)):
            walls[name], _, outs[name] = timed(fn)
    new_tokens = int(outs["rollout"]["response_mask"].sum().item())
    emit("rollout_time", rollout_s=walls["rollout"], new_tokens=new_tokens,
         tokens_per_s=new_tokens / walls["rollout"], experience_s=walls["experience"],
         batch=B, prompt_len=PROMPT_LEN, max_new_tokens=NEW_TOKENS)
    for name, fn in (("rollout", rollout), ("experience", score)):
        profile_phase(name, fn, walls[name])
    return {"flash_prefill": rollout_flash, "flash_teacher_forced": launches["flash"] - rollout_flash,
            "decode": {"short": launches["decode_short"], "long": launches["decode_long"]}}


# bench.py's headline workload (bench.py:39-43, 138-146, 156-182): its
# prompts and reward, 64 rollouts of 32-token prompts + 32 new tokens,
# chunk 64, batch 32, 4 PPO epochs; two cycles = 16 optimizer steps
TRAIN_PROMPTS = [
    "the movie was", "I watched this and", "a review of the film:",
    "honestly the plot", "the acting in this", "what a film,",
    "two hours of", "the director chose",
] * 16
TRAIN_ROLLOUTS, TRAIN_BATCH, TRAIN_EPOCHS, TRAIN_STEPS = 64, 32, 4, 16
TRAIN_REFERENCE_ROLLOUTS = 256  # 8 minibatches of independent rows for train_reference
# grad_reference's bar on a signed-sum tensor's relative gradient error from
# fp32 (the value head's output bias under LoRA, on an H100: 0.73-0.87% for
# the kernel path and 0.34-0.60% for plain bf16 over six draws; 2.7%, 4.0%
# and 15% with kernel 1's output scaled by 1 + 2^-8, 2^-6 and 2^-4;
# scripts/torch_knobs_gate_diag.py, PERF.md)
SIGNED_SUM_REL_ERR = 2e-2


def train_reward_fn(samples, prompts, outputs, **kw):
    return [float(o.count("a")) - 0.1 * len(o) for o in outputs]


def train_config(seed: int, attention_impl="pallas", kv_cache_quant="int8_kernel", compute_dtype="bfloat16"):
    from trlx_tpu_torch.data.default_configs import default_ppo_config

    transformer = dict(GPT2_PATHS, attention_impl=attention_impl, kv_cache_quant=kv_cache_quant)
    return default_ppo_config().evolve(
        train=dict(batch_size=TRAIN_BATCH, total_steps=TRAIN_STEPS, eval_interval=10_000,
                   checkpoint_interval=10_000, seq_length=TRAIN_LEN, epochs=10_000, tracker=None,
                   compute_dtype=compute_dtype, seed=seed, **ckpt_kw()),
        model=dict(model_path="random", num_layers_unfrozen=-1,
                   model_extra_configs={"transformer": transformer}),
        tokenizer=dict(tokenizer_path="byte"),
        method=dict(num_rollouts=TRAIN_ROLLOUTS, chunk_size=TRAIN_ROLLOUTS, ppo_epochs=TRAIN_EPOCHS,
                    gen_kwargs=dict(max_new_tokens=TRAIN_NEW_TOKENS, top_k=0, top_p=1.0, do_sample=True)),
    )


def train_path(seed: int, shapes: dict):
    """`trlx_tpu_torch.train` on the headline workload at GPT-2-small width
    (random weights from the seed, everything trainable, a full frozen
    reference copy, bf16 compute / fp32 params, the flash and int8 decode
    kernels): evaluate, two rollout cycles, 16 optimizer steps, evaluate.
    Gates: finite losses, the launch counts, trainable parameters moved,
    the frozen reference did not."""
    trainer, wall, launches, decode_steps = counted_train(train_config(seed), shapes, "train")
    L = trainer.model.cfg.n_layer
    cycles = TRAIN_STEPS // (TRAIN_EPOCHS * TRAIN_ROLLOUTS // TRAIN_BATCH)
    expect = train_path_launches(L, cycles, decode_steps)
    steps = [(step, st["losses/total_loss"], st["policy/approx_kl"])
             for step, st in trainer.stats_history if "losses/total_loss" in st]
    rewards = [st["reward/mean"] for _, st in trainer.stats_history if "reward/mean" in st]
    rollout_scores = [st["rollout_scores/mean"] for _, st in trainer.stats_history if "rollout_scores/mean" in st]
    emit("train_path", wall_s=wall, launches=launches, expected=expect, iter_count=trainer.iter_count,
         sampler_calls=len(decode_steps), decode_steps=decode_steps,
         losses=[x[1] for x in steps], approx_kl=[x[2] for x in steps], eval_reward_mean=rewards,
         rollout_score_mean=rollout_scores, kl_ctl_value=trainer.kl_ctl.value,
         cycle_seconds=cycle_split(trainer))
    if len(steps) != TRAIN_STEPS or not all(math.isfinite(x[1]) for x in steps):
        raise AssertionError(f"expected {TRAIN_STEPS} finite losses, got {[x[1] for x in steps]}")
    if len(decode_steps) != cycles + 2 or not 0 < expect["decode"] <= L * (cycles + 2) * (TRAIN_NEW_TOKENS - 1):
        raise AssertionError(f"expected {cycles + 2} sampler calls of at most {TRAIN_NEW_TOKENS - 1} decode steps, "
                             f"got {decode_steps}")
    if {k: launches[k] for k in expect} != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect}")

    check_params_moved(trainer, seed)
    return trainer, launches


def train_path_launches(L: int, cycles: int, decode_steps: list, steps: int = TRAIN_STEPS) -> dict:
    """The training kernels' launches on train_path's workload: every
    sampler call (a rollout a cycle, an eval at each end) prefills through
    the forward kernel; each experience chunk runs the policy and the full
    reference copy; each train step one forward and one backward through
    every layer, the forward on the short route and the backward on the
    fused one (T, S <= 128); each decode step of every sampler call one
    short-route decode launch a layer (a 128-slot cache)."""
    return run_launches(L, cycles + 2, cycles, steps, decode_steps)


def train_counters() -> dict:
    """The launch counters of a training path: the flash forward's, the
    backward's (the fused kernel and the long route's pair) and the int8
    decode step's."""
    from trlx_tpu_torch.ops import flash_attention as fa

    return {**fwd_counters(), "flash_bwd": fa.flash_attention_bwd, "flash_bwd_dq": fa.flash_attention_dq,
            "flash_bwd_dkv": fa.flash_attention_dkv, **decode_counters()}


@contextlib.contextmanager
def sampler_calls():
    """Each sampler call a trainer makes while active (the static causal
    sampler's and `generate_seq2seq`'s): its decode steps (the tokens of
    its longest row after the prefill's first) and its sequences."""
    from trlx_tpu_torch.trainer import base as trainer_base

    calls, samplers = [], {name: getattr(trainer_base, name) for name in ("generate", "generate_seq2seq")}

    def counted(sampler):
        def fn(*args, **kwargs):
            out = sampler(*args, **kwargs)
            calls.append({"decode_steps": int(out["response_mask"].sum(dim=1).max().item()) - 1,
                          "sequences": out["sequences"]})
            return out

        return fn

    for name, sampler in samplers.items():
        setattr(trainer_base, name, counted(sampler))
    try:
        yield calls
    finally:
        for name, sampler in samplers.items():
            setattr(trainer_base, name, sampler)


def check_params_moved(trainer, seed: int, phase: str = "train_params", frozen=(), base_state=None) -> None:
    """Every trainable tensor moved from its seeded init (a value branch
    from its copy of the seeded top blocks; with `base_state`, the base
    weights the run loaded and heads fresh from the seed); the tensors
    whose names start with one of `frozen`, and the frozen reference (a
    full copy, or the hydra branch over the top blocks), did not. Without
    `frozen`, every tensor must be trainable."""
    import torch

    model = trainer.model
    kw = {k: getattr(model, k) for k in ("branch_at", "value_branch_at") if getattr(model, k, None) is not None}
    init = type(model)(model.cfg, device="cuda", **kw)
    if base_state is None:
        init.init_params(torch.Generator().manual_seed(seed))
    else:
        with torch.no_grad():
            init.base.load_state_dict(base_state)
            init.init_heads(torch.Generator().manual_seed(seed))
    start = dict(init.named_parameters())
    params = dict(model.named_parameters())
    should_freeze = {n for n in params if n.startswith(tuple(frozen))} if frozen else set()
    still = [n for n, p in params.items() if n not in should_freeze and torch.equal(p, start[n])]
    frozen_moved = [n for n in should_freeze if not torch.equal(params[n], start[n])]
    trainable = {n for n, p in params.items() if p.requires_grad}
    ref = getattr(trainer, "ref_params", None)
    offset = getattr(model, "branch_at", None) or 0  # a hydra reference holds the blocks from branch_at up

    def base_name(n):  # a reference tensor's name in the policy (hydra: block i is block offset + i)
        parts = n.split(".")
        if offset and parts[0] == "blocks":
            parts[1] = str(int(parts[1]) + offset)
        return "base." + ".".join(parts)

    ref_moved = [] if ref is None else [n for n, p in ref.named_parameters() if not torch.equal(p, start[base_name(n)])]
    rel_bias = {n: (p - start[n]).abs().max().item() for n, p in params.items() if n.endswith("rel_bias")}
    emit(phase, trainable=len(trainer.trainable_params), frozen=len(should_freeze), unmoved=still,
         frozen_moved=frozen_moved, reference_moved=ref_moved, rel_bias_max_abs_move=rel_bias)
    if still or ref_moved or frozen_moved or trainable != set(params) - should_freeze:
        raise AssertionError(f"parameters that did not move: {still}; frozen that moved: {frozen_moved}; "
                             f"reference tensors that moved: {ref_moved}; trainable {len(trainable)} of "
                             f"{len(params)}, {len(should_freeze)} meant to be frozen")


def cycle_split(trainer) -> list:
    """Seconds of each rollout cycle by phase, from the trainer's marks."""
    marks = trainer.phase_marks + [dict(trainer.phase_seconds)]
    return [{"rollout": marks[i + 1].get("generate", 0.0) - marks[i].get("generate", 0.0),
             **{k: marks[i + 1].get(k, 0.0) - marks[i].get(k, 0.0) for k in ("experience", "train", "eval")}}
            for i in range(len(marks) - 1)]


ENGINE_TRAIN = dict(enabled=True, slots=32, page_size=16, paged_attention_impl="pallas", spec_decode=True, draft_k=4)


def train_engine_path(seed: int, shapes: dict) -> dict:
    """`trlx_tpu_torch.train` on the headline workload with rollouts (and
    evaluations) through the decode engine: 32 slots, 16-token int8 pages,
    the paged kernel, speculative decoding with draft_k=4 off the full
    frozen reference copy. Gates: paged launches == n_layer x the decode
    steps of every engine call, every one on the short route, the
    engine's rollout stats, no pool
    exhaustion, trainable parameters moved and the reference did not."""
    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch.ops.decode_attention import paged_attention
    from trlx_tpu_torch.trainer.base import TPUBaseTrainer

    calls = []
    engine_generate = TPUBaseTrainer._engine_generate

    def counted(self, *args, **kwargs):
        out = engine_generate(self, *args, **kwargs)
        calls.append(out["gen_stats"])
        return out

    config = train_config(seed)
    config = config.evolve(method=dict(gen_engine=ENGINE_TRAIN))
    fwd = fwd_counters()
    paged = paged_counters()
    for fn in (*fwd.values(), *paged.values()):
        fn.launches = 0
    TPUBaseTrainer._engine_generate = counted
    try:
        t0 = time.perf_counter()
        with forward_shapes(shapes, "train_engine"):
            trainer = trlx_tpu_torch.train(reward_fn=train_reward_fn, prompts=TRAIN_PROMPTS, config=config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        TPUBaseTrainer._engine_generate = engine_generate
    L = trainer.model.cfg.n_layer
    steps = sum(g["decode_steps"] for g in calls)
    launches = paged_attention.launches
    by_route = {route: paged[f"paged_{route}"].launches for route in ("short", "long")}
    fwd_launches = {name: fn.launches for name, fn in fwd.items()}
    keys = ("rollout/engine_occupancy", "rollout/engine_refills", "rollout/engine_decode_steps",
            "rollout/engine_reclaimed_pages", "rollout/spec_accept_rate")
    rollouts = [{k: st[k] for k in keys if k in st} for _, st in trainer.stats_history if "rollout/engine_refills" in st]
    losses = [st["losses/total_loss"] for _, st in trainer.stats_history if "losses/total_loss" in st]
    emit("train_engine_path", wall_s=wall, engine_calls=len(calls), decode_steps=steps, paged_launches=launches,
         paged_launches_by_route=by_route, expected=L * steps, iter_count=trainer.iter_count,
         rollout_stats=rollouts, losses=losses,
         oom_truncated=sum(g["oom_truncated"] for g in calls), unserved=sum(g["unserved"] for g in calls),
         cycle_seconds=cycle_split(trainer), flash_fwd_launches=fwd_launches)
    if launches != L * steps or not calls:
        raise AssertionError(f"paged launches {launches} != {L} x {steps} engine decode steps")
    if by_route != {"short": launches, "long": 0}:
        raise AssertionError(f"the paged step left the short route: {by_route}")
    if not (fwd_launches["flash_fwd"] > 0 and fwd_launches["flash_fwd_short"] == fwd_launches["flash_fwd"]
            and fwd_launches["flash_fwd_long"] == 0):
        raise AssertionError(f"the flash forward left the short route: {fwd_launches}")
    if not rollouts or any(set(r) != set(keys) for r in rollouts):
        raise AssertionError(f"the engine's rollout stats are missing: {rollouts}")
    if any(g["oom_truncated"] or g["unserved"] for g in calls):
        raise AssertionError("the engine's page pool ran out")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"expected {TRAIN_STEPS} finite losses, got {losses}")
    check_params_moved(trainer, seed, "train_engine_params")
    del trainer
    return {"paged": by_route}


def train_reference(trainer, seed: int, configs=None, rollouts: int = TRAIN_REFERENCE_ROLLOUTS,
                    batch_size: int = TRAIN_BATCH, phase: str = "train_reference", must_gate=None,
                    signed_sums: tuple = ()) -> dict:
    """One train step's loss and gradients from the same parameters on
    the same minibatches, three ways: the kernel path (the trainer
    itself), the plain bf16 path (attention_impl="xla") and the plain
    fp32 path (`configs` gives the two plain trainers' configs; by default
    the GPT-2 train path's). The minibatches: a fresh store of `rollouts`
    rollouts from the trained policy, cut by two shuffles. The gate is
    `grad_reference`'s, over the loss, the response tokens' logprobs and
    values. One minibatch's loss error, or the gradient error of a tensor
    that sums a whole batch into one number (the value head's output
    bias), is a single draw of bf16 rounding noise that swings by 10x
    between minibatches on either bf16 path, so the gate needs many
    independent rows to compare two such draws."""
    import torch

    if configs is None:
        configs = {
            "plain_bf16": train_config(seed, attention_impl="xla", kv_cache_quant="int8"),
            "fp32": train_config(seed, attention_impl="xla", kv_cache_quant=None, compute_dtype="float32"),
        }
    trainer.store.clear_history()
    trainer.make_experience(rollouts, trainer.iter_count)

    def step(t, batch):
        loss, _ = t.loss(batch)
        loss.backward()
        with torch.no_grad():
            lp, values = t.response_logprobs_and_values(batch)
        return loss, (lp.float(), values.float()), batch.response_mask.bool()

    batches = [b for s in (seed, seed + 1)
               for b in trainer.store.create_loader(batch_size, shuffle=True, drop_last=True, seed=s)]
    grad_reference(trainer, configs, batches, step, ("logprobs", "values"), phase, must_gate=must_gate,
                   signed_sums=signed_sums, reward_fn=train_reward_fn)
    return {"batch": batches[0]}


def grad_reference(trainer, configs: dict, batches: list, step, outputs: tuple, phase: str, must_gate=None,
                   signed_sums: tuple = (), **trainer_kw) -> None:
    """The gate of the train references: the kernel path (`trainer`), and
    the plain bf16 and fp32 paths (trainers built from `configs` on the
    same parameters) each take one step, `step(trainer, batch) -> (loss,
    (per-token outputs...), real-token mask)`, on every minibatch. Gate:
    the kernel path strays from fp32 at most twice as far as the plain
    bf16 path in the loss and in each output named in `outputs` (mean
    |error| over the minibatches); in ||d grad|| / ||grad|| of every
    trainable tensor (both norms over all the minibatches' gradients
    together), with the median of that ratio over the tensors at most
    1.1; and, for the key projection's bias, whose exact gradient is zero
    (it shifts every score of a query row equally) so that a relative
    error means nothing, in the largest absolute gradient error of each
    such tensor over the minibatches. With `must_gate`, the tensors whose
    names start with it must be among the gated ones (their ratios are
    printed apart). `signed_sums` names tensors whose gradient is one signed
    sum over every real token of the minibatch (the value head's output
    bias: the signed mean of the value errors): their error is what is left
    of the paths' rounding after it cancels, which a path with exact
    attention also fails to keep within 2x of plain bf16's (`PERF.md`), so
    they are held to a relative error from fp32 of at most
    SIGNED_SUM_REL_ERR instead, and their ratios are printed; the per-token
    errors they sum stay gated in `outputs`."""
    import torch

    from trlx_tpu_torch.utils.loading import get_trainer

    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    paths = {"kernel": trainer}
    for name, config in configs.items():
        paths[name] = get_trainer(config.train.trainer)(config=config, **trainer_kw)
        paths[name].model.load_state_dict(state)
    del state

    def run(t, batch):
        t.model.zero_grad(set_to_none=True)
        loss, outs, real = step(t, batch)
        torch.cuda.synchronize()
        grads = {n: p.grad.detach().float().clone() for n, p in t.model.named_parameters() if p.requires_grad}
        t.model.zero_grad(set_to_none=True)
        return loss.item(), grads, outs, real

    errs = {name: [] for name in ("kernel", "plain_bf16")}  # per minibatch: |d loss|, then |d output| each
    # per tensor, summed over the minibatches: ||d grad||^2 of each path, ||grad||^2 of fp32
    sq = {name: {} for name in ("kernel", "plain_bf16", "fp32")}
    abs_max = {name: {} for name in errs}  # per tensor: the largest |d grad| over the minibatches
    losses = []
    for batch in batches:
        res = {name: run(t, batch) for name, t in paths.items()}
        loss32, g32, outs32, real = res["fp32"]
        losses.append({k: v[0] for k, v in res.items()})
        for n, g in g32.items():
            sq["fp32"][n] = sq["fp32"].get(n, 0.0) + g.square().sum().item()
        for name, e in errs.items():
            loss, g, outs, _ = res[name]
            # a minibatch with no real response token has no output error (NaN, left out of the mean)
            e.append((abs(loss - loss32), *[(o - o32)[real].abs().mean().item() if real.any() else math.nan
                                            for o, o32 in zip(outs, outs32)]))
            for n in g:
                d = g[n] - g32[n]
                sq[name][n] = sq[name].get(n, 0.0) + d.square().sum().item()
                abs_max[name][n] = max(abs_max[name].get(n, 0.0), d.abs().max().item())
        del res
    del paths

    def mean(name, i):
        vals = [e[i] for e in errs[name] if not math.isnan(e[i])]
        return statistics.mean(vals) if vals else math.nan

    grad = {name: {n: math.sqrt(sq[name][n] / max(sq["fp32"][n], 1e-60)) for n in sq["fp32"]}
            for name in errs}
    k_bias = [n for n in grad["kernel"] if n.endswith("attn.k.bias")]
    sums = [n for n in grad["kernel"] if n in signed_sums]
    gated = [n for n in grad["kernel"] if n not in k_bias and n not in sums]
    gk, gp = grad["kernel"], grad["plain_bf16"]
    ratio = {n: gk[n] / max(gp[n], 1e-30) for n in gated}
    worse = [n for n in gated if ratio[n] > 2]
    median = statistics.median(ratio.values())
    k_bias_abs = {n: {"kernel": abs_max["kernel"][n], "plain_bf16": abs_max["plain_bf16"][n],
                      "ratio": abs_max["kernel"][n] / max(abs_max["plain_bf16"][n], 1e-30)} for n in k_bias}
    k_bias_worse = [n for n, e in k_bias_abs.items() if e["ratio"] > 2]
    summary = {what: {"kernel": mean("kernel", i), "plain_bf16": mean("plain_bf16", i)}
               for i, what in enumerate(("loss",) + outputs)}
    emit(phase, minibatches=len(batches), losses=losses,
         loss_err_by_minibatch={name: [e[0] for e in errs[name]] for name in errs},
         mean_abs_err=summary, grad_rel_err_kernel_max=max(gk[n] for n in gated),
         grad_rel_err_plain_bf16_max=max(gp[n] for n in gated), grad_rel_err_ratio_max=max(ratio.values()),
         grad_rel_err_ratio_median=median,
         rel_bias_grad_rel_err={n: {"kernel": gk[n], "plain_bf16": gp[n], "ratio": ratio[n]}
                                for n in gated if n.endswith("rel_bias")},
         grad_rel_err_ratio_top=[(n, r, gk[n], gp[n]) for n, r in sorted(ratio.items(), key=lambda kv: -kv[1])[:5]],
         tensors=len(gated), tensors_over_2x=worse,
         k_bias_grad_rel_err={n: {"kernel": gk[n], "plain_bf16": gp[n]} for n in k_bias},
         k_bias_grad_max_abs_err=k_bias_abs,
         k_bias_max_abs_ratio_max=max((e["ratio"] for e in k_bias_abs.values()), default=None),
         k_bias_over_2x=k_bias_worse,
         signed_sum_grad_rel_err={n: {"kernel": gk[n], "plain_bf16": gp[n], "ratio": gk[n] / max(gp[n], 1e-30)}
                                  for n in sums},
         **({} if must_gate is None else {"must_gate": must_gate, "must_gate_ratio": {
             n: {"kernel": gk[n], "plain_bf16": gp[n], "ratio": ratio[n]} for n in gated if n.startswith(must_gate)}}))
    if must_gate is not None and not any(n.startswith(must_gate) for n in grad["kernel"]):
        raise AssertionError(f"no tensor named {must_gate}* was gated")
    for what, e in summary.items():
        if not (math.isfinite(e["kernel"]) and math.isfinite(e["plain_bf16"])):
            raise AssertionError(f"no minibatch gave a finite {what} error: {e}")
        if e["kernel"] > 2 * e["plain_bf16"]:
            raise AssertionError(f"the kernel path's {what} strays from fp32 by {e['kernel']}, "
                                 f"more than 2 x plain bf16 ({e['plain_bf16']})")
    if median > 1.1:
        raise AssertionError(f"the median gradient error ratio to the plain bf16 path is {median} > 1.1")
    if worse:
        raise AssertionError(f"gradients of {worse} stray from fp32 more than 2 x the plain bf16 path's")
    if k_bias_worse:
        raise AssertionError(f"the largest absolute gradient errors of {k_bias_worse} exceed 2 x the plain bf16 "
                             f"path's: {k_bias_abs}")
    if set(sums) != set(signed_sums) or any(gk[n] > SIGNED_SUM_REL_ERR for n in sums):
        raise AssertionError(f"the signed-sum tensors {signed_sums} are missing or stray from fp32 by more than "
                             f"{SIGNED_SUM_REL_ERR}: {[(n, gk[n]) for n in sums]}")


def counted_train(config, shapes: dict, path: str, reward_fn=train_reward_fn, prompts=TRAIN_PROMPTS, **train_kw):
    """`trlx_tpu_torch.train` on `prompts` (the train path's) with every
    training kernel's counter at 0 just before it: (trainer, wall s,
    launches, the decode steps of each sampler call)."""
    import torch

    import trlx_tpu_torch

    counters = train_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with forward_shapes(shapes, path), sampler_calls() as calls:
        trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, config=config, **train_kw)
    torch.cuda.synchronize()
    return (trainer, time.perf_counter() - t0, {name: fn.launches for name, fn in counters.items()},
            [c["decode_steps"] for c in calls])


def check_train_losses(trainer) -> list:
    losses = [st["losses/total_loss"] for _, st in trainer.stats_history if "losses/total_loss" in st]
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"expected {TRAIN_STEPS} finite losses, got {losses}")
    return losses


def weights_checksum(module) -> float:
    """The float64 sum of every parameter: equal for equal weights."""
    import torch

    return torch.stack([p.detach().double().sum() for p in module.parameters()]).sum().item()


def overlap_path(seed: int, shapes: dict, train_split: list):
    """`train_path`'s workload with `method.overlap_rollouts`, as bench.py's
    headline sets it (`bench.py:179`), under `train.fused_inner_loop`: the
    second cycle's rollout is generated before the first cycle's steps,
    with the weights those steps then change, and scored after them.
    Gates: 16 finite losses; the launch counts of train_path's expectation
    (the prefetch moves a sampler call and adds none); the prefetched call
    ran on the pre-block weights (a checksum), its chunk was scored on the
    updated ones, and the last cycle prefetched nothing; nothing left in
    flight and the prompt cursor equal to the chunks trained. Prints its
    cycle split beside train_path's (`train_split`); no speed is gated."""
    from trlx_tpu_torch.trainer import base as trainer_base
    from trlx_tpu_torch.trainer.ppo import TPUPPOTrainer

    events = []
    generate, hook, exp = (trainer_base.generate, TPUPPOTrainer.pre_optimization_hook,
                           TPUPPOTrainer.experience_forward)

    def spy_generate(model, *args, **kwargs):
        out = generate(model, *args, **kwargs)
        events.append(("gen", weights_checksum(model), out["sequences"]))
        return out

    def spy_hook(self, will_continue):
        events.append(("hook", will_continue, weights_checksum(self.model.base)))
        hook(self, will_continue)
        events.append(("hook_end",))

    def spy_exp(self, tokens, *args):
        events.append(("exp", weights_checksum(self.model.base), tokens))
        return exp(self, tokens, *args)

    config = train_config(seed).evolve(train=dict(fused_inner_loop=True), method=dict(overlap_rollouts=True))
    TPUPPOTrainer.pre_optimization_hook, TPUPPOTrainer.experience_forward = spy_hook, spy_exp
    try:
        with contextlib.ExitStack() as stack:
            stack.callback(setattr, trainer_base, "generate", generate)
            trainer_base.generate = spy_generate
            trainer, wall, launches, decode_steps = counted_train(config, shapes, "overlap")
    finally:
        TPUPPOTrainer.pre_optimization_hook, TPUPPOTrainer.experience_forward = hook, exp
    cycles = TRAIN_STEPS // (TRAIN_EPOCHS * TRAIN_ROLLOUTS // TRAIN_BATCH)
    # train_path's expectation: the same sampler calls, the second cycle's
    # rollout moved ahead of the first cycle's steps
    expect = train_path_launches(trainer.model.cfg.n_layer, cycles, decode_steps)
    hooks = [i for i, e in enumerate(events) if e[0] == "hook"]
    ends = [i for i, e in enumerate(events) if e[0] == "hook_end"]
    gens = [(i, e) for i, e in enumerate(events) if e[0] == "gen"]
    # evaluations run with no hook around them: the prefetched calls are
    # the sampler calls between a hook and its end
    prefetched = [(i, e) for i, e in gens if any(h < i < x for h, x in zip(hooks, ends))]
    losses = check_train_losses(trainer)
    split = cycle_split(trainer)
    emit("overlap_path", wall_s=wall, launches=launches, expected=expect, iter_count=trainer.iter_count,
         sampler_calls=len(decode_steps), decode_steps=decode_steps, losses=losses,
         hooks=[events[i][1] for i in hooks], prefetched_calls=len(prefetched),
         prompt_batches_consumed=trainer._prompt_batches_consumed,
         cycle_seconds=split, train_path_cycle_seconds=train_split)
    if {k: launches[k] for k in expect} != expect or len(decode_steps) != cycles + 2:
        raise AssertionError(f"launch counts {launches} != expected {expect} ({len(decode_steps)} sampler calls)")
    if [events[i][1] for i in hooks] != [True, False] or len(prefetched) != 1:
        raise AssertionError(f"expected one prefetch before the first cycle's steps and none before the last: "
                             f"hooks {[events[i][1] for i in hooks]}, {len(prefetched)} prefetched calls")
    i, (_, w_gen, seqs) = prefetched[0]
    pre_block = events[hooks[0]][2]
    scored = [e for e in events[i + 1:] if e[0] == "exp" and e[2] is seqs]
    if w_gen != pre_block or w_gen != gens[0][1][1]:
        raise AssertionError("the prefetched chunk was not generated with the pre-block weights")
    if len(scored) != 1 or scored[0][1] == pre_block or scored[0][1] != events[hooks[1]][2]:
        raise AssertionError("the prefetched chunk was not scored (once) with the updated weights")
    if trainer._prefetched_gen is not None or trainer._prompt_batches_consumed != cycles:
        raise AssertionError(f"a prefetch was left in flight or the cursor is off: "
                             f"{trainer._prompt_batches_consumed} chunks pulled, {cycles} trained")
    del trainer
    return launches


KNOBS_UNFROZEN = 2  # ppo_knobs_path: num_layers_unfrozen and num_value_layers_unfrozen


def ppo_knobs_config(seed: int, logging_dir=None, **kw):
    """The train path's config (GPT-2 small, 50257 ids) with the hydra
    reference and the value branch over the top two blocks, timing_split
    and the rollout export into `logging_dir` (none without one)."""
    return train_config(seed, **kw).evolve(
        train=dict(timing_split=logging_dir is not None, rollout_logging_dir=logging_dir),
        model=dict(num_layers_unfrozen=KNOBS_UNFROZEN),
        method=dict(num_value_layers_unfrozen=KNOBS_UNFROZEN),
    )


def ppo_knobs_path(seed: int, shapes: dict):
    """`trlx_tpu_torch.train` on the train path's workload at GPT-2 small
    with the PPO knobs of slice 6 but stop sequences (`stop_path`):
    num_layers_unfrozen 2 (hydra reference over blocks 2-3),
    num_value_layers_unfrozen 2 (the value branch re-runs blocks 2-3 from
    the trunk's capture), train.timing_split and train.rollout_logging_dir;
    two cycles, 16 steps. Gates: exact launch counts; one export file (the
    first cycle's; the run ends inside the second) of 64 rows; the timing
    keys from the second step on; the trainable tensors moved and the
    frozen trunk and reference did not."""
    import glob
    import os
    import shutil
    import tempfile

    logs = tempfile.mkdtemp(prefix="rollouts-")
    try:
        trainer, wall, launches, decode_steps = counted_train(ppo_knobs_config(seed, logs), shapes, "ppo_knobs")
        exports = glob.glob(os.path.join(logs, "run-*", "epoch-*.json"))
        configs = glob.glob(os.path.join(logs, "run-*", "config.json"))
        rows = []
        for f in exports:
            with open(f) as fh:
                rows.append(len(json.load(fh)))
    finally:
        shutil.rmtree(logs, ignore_errors=True)
    L, K = trainer.model.cfg.n_layer, KNOBS_UNFROZEN
    cycles = TRAIN_STEPS // (TRAIN_EPOCHS * TRAIN_ROLLOUTS // TRAIN_BATCH)
    # forward launches: every sampler call's prefill (a rollout a cycle, an
    # eval at each end) through the L policy blocks; each cycle's experience
    # pass through the L trunk blocks, the K blocks of the hydra reference
    # and the K of the value branch; each train step's policy forward
    # (L + K, the branch included), and two more of them for timing_split's
    # probe (a warm pass, a timed one) on the one batch shape. Backward:
    # each step through the trainable blocks alone (the top K of the
    # policy, the K of the value branch; the frozen trunk below builds no
    # graph). Decode: a launch a layer for each decode step.
    n_fwd = L * (cycles + 2) + cycles * (L + 2 * K) + (TRAIN_STEPS + 2) * (L + K)
    n_bwd = 2 * K * TRAIN_STEPS
    n_decode = L * sum(decode_steps)
    expect = {"flash_fwd": n_fwd, "flash_fwd_short": n_fwd, "flash_fwd_long": 0,
              "flash_bwd": n_bwd, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
              "decode": n_decode, "decode_short": n_decode, "decode_long": 0}
    losses = check_train_losses(trainer)
    timed = [step for step, st in trainer.stats_history if "time/forward" in st and "time/backward" in st]
    split = [(step, st["time/forward"], st["time/backward"]) for step, st in trainer.stats_history
             if "time/forward" in st]
    emit("ppo_knobs_path", wall_s=wall, launches=launches, expected=expect, iter_count=trainer.iter_count,
         sampler_calls=len(decode_steps), decode_steps=decode_steps, losses=losses, export_rows=rows,
         export_configs=len(configs), timing_split_steps=timed, timing_split_s=split[:3],
         cycle_seconds=cycle_split(trainer))
    if {k: launches[k] for k in expect} != expect or len(decode_steps) != cycles + 2:
        raise AssertionError(f"launch counts {launches} != expected {expect} ({len(decode_steps)} sampler calls)")
    if rows != [TRAIN_ROLLOUTS] or len(configs) != 1:
        raise AssertionError(f"expected one export of {TRAIN_ROLLOUTS} rows beside one config.json: {rows}, "
                             f"{len(configs)} configs")
    if timed != list(range(2, TRAIN_STEPS + 1)):
        raise AssertionError(f"time/forward and time/backward must appear from the second step on: {timed}")
    check_params_moved(trainer, seed, "ppo_knobs_params",
                       frozen=("base.embed.",) + tuple(f"base.blocks.{i}." for i in range(L - K)))
    return trainer, launches


def ppo_knobs_reference(trainer, seed: int) -> dict:
    """`train_reference` on the knobs trainer (the hydra branch, the value
    branch, a frozen trunk), against the plain bf16 and fp32 paths of the
    same config; `grad_reference` must gate the value branch's tensors."""
    configs = {
        "plain_bf16": ppo_knobs_config(seed, attention_impl="xla", kv_cache_quant="int8"),
        "fp32": ppo_knobs_config(seed, attention_impl="xla", kv_cache_quant=None, compute_dtype="float32"),
    }
    return train_reference(trainer, seed, configs, phase="ppo_knobs_reference", must_gate="v_branch.")


# stop_path's vocabulary: the byte tokenizer's 258 ids. Stop sequences
# re-tokenise every output through the tokenizer (the reference's
# host-scored path), and the byte tokenizer decodes only its 256 byte ids:
# at GPT-2's 50257 ids random weights sample a byte about once in 200
# tokens, so the rebuilt responses would hold a token or two in a chunk of
# 64 rows, and a train step would see almost none.
# scripts/torch_knobs_gate_diag.py reads the references at both
# vocabularies.
STOP_VOCAB = 258
# two bytes random weights sample once in 258 tokens each: about a fifth of
# the 32-token outputs hold one (the EOS string appended to a cut output,
# "<|eos|>", holds neither)
STOPS = ["t", "n"]


def stop_config(seed: int, **kw):
    """The train path's config at GPT-2-small widths over `STOP_VOCAB` ids."""
    config = train_config(seed, **kw)
    transformer = dict(config.model.model_extra_configs["transformer"], vocab_size=STOP_VOCAB)
    return config.evolve(model=dict(model_extra_configs={"transformer": transformer}))


def stop_path(seed: int, shapes: dict):
    """`trlx_tpu_torch.train` on the train path's workload at GPT-2-small
    widths over the byte vocabulary (`STOP_VOCAB`) with stop sequences:
    every output is cut at its first stop string and re-tokenised, and the
    experience pass runs after the decode on the rebuilt tokens; two
    cycles, 16 steps. Gates: train_path's exact launch counts (the
    experience pass moves behind the decode and adds no launch); at least
    one output cut and none scored still holding a stop string; 16 finite
    losses; every tensor moved and the frozen reference did not."""
    from trlx_tpu_torch.trainer.ppo import TPUPPOTrainer

    cut = []
    retokenize = TPUPPOTrainer._retokenize_outputs

    def spy(self, str_outputs, batch, sequences, N):
        cut.append(([self.tokenizer.decode(row[-N:]) for row in sequences.cpu().numpy()], list(str_outputs)))
        return retokenize(self, str_outputs, batch, sequences, N)

    TPUPPOTrainer._retokenize_outputs = spy
    try:
        trainer, wall, launches, decode_steps = counted_train(
            stop_config(seed), shapes, "stop", stop_sequences=STOPS)
    finally:
        TPUPPOTrainer._retokenize_outputs = retokenize
    cycles = TRAIN_STEPS // (TRAIN_EPOCHS * TRAIN_ROLLOUTS // TRAIN_BATCH)
    expect = train_path_launches(trainer.model.cfg.n_layer, cycles, decode_steps)
    losses = check_train_losses(trainer)
    raw = [o for chunk, _ in cut for o in chunk]
    scored = [o.removesuffix(trainer.tokenizer.eos_token) for _, chunk in cut for o in chunk]
    n_cut = sum(any(stop in o for stop in STOPS) for o in raw)
    real_tokens = [st["rollout/real_tokens"] for _, st in trainer.stats_history if "rollout/real_tokens" in st]
    emit("stop_path", wall_s=wall, launches=launches, expected=expect, iter_count=trainer.iter_count,
         vocab_size=STOP_VOCAB, stops=STOPS, sampler_calls=len(decode_steps), decode_steps=decode_steps,
         losses=losses, outputs_cut=n_cut, outputs_scored=len(scored), rollout_real_tokens=real_tokens,
         cycle_seconds=cycle_split(trainer))
    if {k: launches[k] for k in expect} != expect or len(decode_steps) != cycles + 2:
        raise AssertionError(f"launch counts {launches} != expected {expect} ({len(decode_steps)} sampler calls)")
    if not n_cut or any(stop in o for stop in STOPS for o in scored):
        raise AssertionError(f"{n_cut} sampled outputs held a stop string; the scored outputs must hold none")
    check_params_moved(trainer, seed, "stop_params")
    return trainer, launches


def stop_reference(trainer, seed: int) -> dict:
    """`train_reference` on the stop trainer, against the plain bf16 and
    fp32 paths of its config: its fresh store is cut at the stop strings,
    so the train steps' rows hold a left-padded prompt and a right-padded
    response. Gate, besides `grad_reference`'s: some stored responses were
    cut short (a padded tail), so the case is not vacuous."""
    import torch

    configs = {
        "plain_bf16": stop_config(seed, attention_impl="xla", kv_cache_quant="int8"),
        "fp32": stop_config(seed, attention_impl="xla", kv_cache_quant=None, compute_dtype="float32"),
    }
    out = train_reference(trainer, seed, configs, phase="stop_reference")
    mask = trainer.store[torch.arange(len(trainer.store), device="cuda")].response_mask.float()
    short = int((mask[:, -1] == 0).sum().item())
    emit("stop_reference_mask", rows=mask.shape[0], rows_cut_short=short, real_share=mask.mean().item())
    if not short:
        raise AssertionError("no stored response was cut short: the reference saw no right padding")
    return out


def value_branch_cost(trainer) -> None:
    """The value branch's added device time: one experience pass on 64 of
    the trainer's stored rollouts and one train-step forward and backward
    on 32 (no optimizer step), each traced with the branch on and with the
    value head moved onto the policy's final hidden state."""
    import torch

    batch = trainer.store[torch.arange(TRAIN_ROLLOUTS, device="cuda")]
    pad = trainer.generate_settings.pad_token_id
    P = batch.query_tensors.shape[1]
    tokens = torch.cat([batch.query_tensors, batch.response_tensors], dim=1)
    attention_mask = (tokens != pad).to(torch.int32)
    attention_mask[:, P:] = torch.maximum(attention_mask[:, P:], batch.response_mask.to(torch.int32))
    minibatch = trainer.store[torch.arange(TRAIN_BATCH, device="cuda")]
    at = trainer.model.value_branch_at

    def experience():
        trainer.experience_forward(tokens, attention_mask, batch.response_mask, 0.05)

    def step():
        loss, _ = trainer.loss(minibatch)
        loss.backward()
        trainer.model.zero_grad(set_to_none=True)

    out = {}
    try:
        for mode in ("branch", "no_branch"):
            trainer.model.value_branch_at = at if mode == "branch" else None
            for name, fn, grad in (("experience", experience, False), ("train_step", step, True)):
                with torch.set_grad_enabled(grad):
                    wall, _, _ = timed(fn)
                out[f"{name}_{mode}"] = {"wall_ms": wall * 1e3,
                                         "device_ms": profile_phase(f"{name}_{mode}", fn, wall, grad=grad)}
    finally:
        trainer.model.value_branch_at = at
    emit("value_branch_cost", **out, **{
        f"{name}_added_device_ms": out[f"{name}_branch"]["device_ms"] - out[f"{name}_no_branch"]["device_ms"]
        for name in ("experience", "train_step")})


RESUME_INTERVAL = 8  # resume_path: a checkpoint a cycle (8 optimizer steps)


def ckpt_kw() -> dict:
    """The checkpoint settings of every path but resume_path: a fresh
    temporary directory (`ckpt_dir`), and the run's one commit (at its
    last step) the deploy export alone."""
    return dict(checkpoint_dir=ckpt_dir(), save_best=False, save_optimizer=False)


def ckpt_dir() -> str:
    """The checkpoint directory of the next `train()` run: `<root>/run`
    under the script's temporary root (removed when main() ends), emptied
    first, so that one run's checkpoints at most are on disk at a time."""
    import shutil
    import tempfile

    if not _CKPT_ROOT:
        _CKPT_ROOT.append(tempfile.mkdtemp(prefix="chip_smoke-ckpts-"))
    path = os.path.join(_CKPT_ROOT[0], "run")
    shutil.rmtree(path, ignore_errors=True)
    return path


def run_launches(L: int, sampler_calls: int, chunks: int, steps: int, decode_steps: list) -> dict:
    """The training kernels' launches of one PPO `train()` run on the
    headline workload, as `train_path_launches` counts them: a prefill a
    sampler call, the policy and the full reference over each experience
    chunk, a forward and a fused backward a train step, one short decode
    launch a layer for each decode step."""
    n_fwd = L * (sampler_calls + 2 * chunks + steps)
    n_decode = L * sum(decode_steps)
    return {"flash_fwd": n_fwd, "flash_fwd_short": n_fwd, "flash_fwd_long": 0,
            "flash_bwd": L * steps, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "decode": n_decode, "decode_short": n_decode, "decode_long": 0}


def resume_path(seed: int, shapes: dict) -> dict:
    """Checkpoint, preemption and resume on the headline workload
    (`train_config`: GPT-2 small, 64 rollouts of 32 + 32 tokens, batch 32,
    4 epochs, two cycles = 16 steps, bf16 on the kernels) with a checkpoint
    a cycle, through `trlx_tpu_torch.train`, three times: (1) uninterrupted;
    (2) killed by a SIGTERM from the reward function during the second
    cycle's rollout (it exits on the step-8 checkpoint the first cycle
    committed); (3) resumed with resume_from_checkpoint="auto".
    Gates: (a) every tensor of run 2's step-8 checkpoint comes back bit for
    bit on the card through `load` (the parameters, the AdamW moments and
    steps, the sampler's CUDA generator, the card's default generator, the
    cursors), and its integrity manifest verifies; (b) the resumed run's
    iter_count, prompt cursor and logged loss steps equal run 1's, and its
    metrics.jsonl is monotonic with each loss step once; (c) run 2's step-8
    checkpoint against run 1's: bitwise equal, then the resumed second
    cycle's tokens and losses equal run 1's; otherwise the first tensor
    that differs is printed and the resumed losses are held to run 1's
    within twice the largest loss difference of two uninterrupted runs
    (a fourth run); (d) each run's kernel launches exactly. Prints the
    commit and load times, the checkpoint's size and the phase's wall."""
    import signal
    import tempfile

    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch.trainer.base import STATE_FILES, TPUBaseTrainer
    from trlx_tpu_torch.utils import checkpointing
    from trlx_tpu_torch.utils.loading import get_trainer

    t_phase = time.perf_counter()
    if not _CKPT_ROOT:
        ckpt_dir()
    root = tempfile.mkdtemp(dir=_CKPT_ROOT[0], prefix="resume-")
    base = train_config(seed).evolve(train=dict(checkpoint_interval=RESUME_INTERVAL, save_optimizer=True))
    commits, loads = [], []
    commit, load = checkpointing.CheckpointManager.commit, TPUBaseTrainer.load

    def timed_commit(self, name, write_fn):
        t0 = time.perf_counter()
        out = commit(self, name, write_fn)
        commits.append({"name": name, "s": time.perf_counter() - t0})
        return out

    def timed_load(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load(self, *args, **kwargs)
        torch.cuda.synchronize()
        loads.append(time.perf_counter() - t0)

    checkpointing.CheckpointManager.commit, TPUBaseTrainer.load = timed_commit, timed_load
    runs, calls = {}, {"n": 0}

    def killing_reward(samples, prompts, outputs, **kw):
        calls["n"] += 1
        if calls["n"] == 3:  # 1: the first rollout, 2: the first evaluation, 3: the second rollout
            os.kill(os.getpid(), signal.SIGTERM)
        return train_reward_fn(samples, prompts, outputs)

    try:
        for name, directory, kw in (("uninterrupted", "a", {}), ("killed", "b", {"reward_fn": killing_reward}),
                                    ("resumed", "b", {"resume": True})):
            config = base.evolve(train=dict(checkpoint_dir=os.path.join(root, directory),
                                            resume_from_checkpoint="auto" if kw.get("resume") else None))
            with sampler_calls() as seqs:
                trainer, wall, launches, decode_steps = counted_train(
                    config, shapes, "resume", reward_fn=kw.get("reward_fn", train_reward_fn))
            runs[name] = dict(trainer=trainer, wall=wall, launches=launches, decode_steps=decode_steps,
                              sequences=[c["sequences"] for c in seqs])
    finally:
        checkpointing.CheckpointManager.commit, TPUBaseTrainer.load = commit, load

    full, killed, resumed = runs["uninterrupted"]["trainer"], runs["killed"]["trainer"], runs["resumed"]["trainer"]
    L = full.model.cfg.n_layer
    # (d) launches: run 1 two cycles; run 2 the first cycle and the second
    # rollout (3 sampler calls, 2 chunks, 8 steps); run 3 the second cycle
    expect = {"uninterrupted": run_launches(L, 4, 2, TRAIN_STEPS, runs["uninterrupted"]["decode_steps"]),
              "killed": run_launches(L, 3, 2, RESUME_INTERVAL, runs["killed"]["decode_steps"]),
              "resumed": run_launches(L, 2, 1, TRAIN_STEPS - RESUME_INTERVAL, runs["resumed"]["decode_steps"])}
    total = {k: sum(runs[r]["launches"][k] for r in runs) for k in runs["resumed"]["launches"]}
    for name, want in expect.items():
        got = {k: runs[name]["launches"][k] for k in want}
        if got != want:
            raise AssertionError(f"resume_path {name}: launch counts {got} != expected {want}")
    if calls["n"] != 3 or killed.iter_count != RESUME_INTERVAL:
        raise AssertionError(f"the kill should land in the second rollout at step {RESUME_INTERVAL}: "
                             f"{calls['n']} reward calls, iter_count {killed.iter_count}")

    # (a) run 2's step-8 checkpoint back on the card, bit for bit
    ckpt_b = os.path.join(root, "b", f"checkpoint_{RESUME_INTERVAL:02d}")
    ckpt_a = os.path.join(root, "a", f"checkpoint_{RESUME_INTERVAL:02d}")
    status, problems = checkpointing.verify_integrity(ckpt_b)
    size_gb = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(ckpt_b) for f in fs) / 1e9
    with open(os.path.join(ckpt_b, "state.json")) as f:
        saved = json.load(f)
    fresh = get_trainer(base.train.trainer)(config=base.evolve(train=dict(checkpoint_dir=os.path.join(root, "c"))),
                                            reward_fn=train_reward_fn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.load(ckpt_b)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    mismatched = []
    for name, t in killed.model.state_dict().items():
        got = fresh.model.state_dict()[name]
        if got.device.type != "cuda" or not torch.equal(got, t):
            mismatched.append(f"model/{name}")
    live_opt, got_opt = killed.optimizer.state_dict()["state"], fresh.optimizer.state_dict()["state"]
    for i, st in live_opt.items():
        for k, t in st.items():
            g = got_opt[i][k]
            if not torch.equal(g.cpu(), t.cpu()) or (k != "step" and g.device.type != "cuda"):
                mismatched.append(f"optimizer/{i}/{k}")
    if fresh.generator.device.type != "cuda" or fresh.generator.get_state().tolist() != saved["rng_key"]:
        mismatched.append("sampler generator")
    if torch.cuda.get_rng_state().tolist() != saved["random_streams"]["torch_cuda"]:
        mismatched.append("torch.cuda default generator")
    if (fresh.iter_count, fresh._resume_prompt_cursor) != (RESUME_INTERVAL, 1) or saved["prompt_batches_consumed"] != 1:
        mismatched.append(f"cursors {fresh.iter_count}, {fresh._resume_prompt_cursor}")
    n_opt = sum(len(st) for st in live_opt.values())
    del fresh
    torch.cuda.empty_cache()

    # (b) the resumed run's counters and its tracker log
    def loss_steps(trainer):
        return [(s, st["losses/total_loss"]) for s, st in trainer.stats_history if "losses/total_loss" in st]

    with open(os.path.join(root, "b", "logs", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    steps = [r["_step"] for r in records]
    logged_loss_steps = [r["_step"] for r in records if "losses/total_loss" in r]
    counters_ok = (resumed.iter_count == full.iter_count == TRAIN_STEPS
                   and resumed._prompt_batches_consumed == full._prompt_batches_consumed == 2
                   and logged_loss_steps == [s for s, _ in loss_steps(full)] == list(range(1, TRAIN_STEPS + 1))
                   and steps == sorted(steps))

    # (c) run 2's step-8 checkpoint against run 1's
    first_diff = None
    for key in ("model", "optimizer"):
        a = torch.load(os.path.join(ckpt_a, "state", STATE_FILES[key]), map_location="cuda", weights_only=True)
        b = torch.load(os.path.join(ckpt_b, "state", STATE_FILES[key]), map_location="cuda", weights_only=True)
        flat_a = a.items() if key == "model" else ((f"{i}/{k}", v) for i, st in a["state"].items() for k, v in st.items())
        flat_b = dict(b.items() if key == "model" else ((f"{i}/{k}", v) for i, st in b["state"].items()
                                                        for k, v in st.items()))
        for name, t in flat_a:
            if first_diff is None and not torch.equal(t, flat_b[name]):
                first_diff = {"tensor": f"{key}/{name}",
                              "max_abs": (t.float() - flat_b[name].float()).abs().max().item()}
        del a, b
    with open(os.path.join(ckpt_a, "state.json")) as f:
        saved_a = json.load(f)
    for key in ("rng_key", "random_streams", "prompt_batches_consumed", "kl_ctl_value", "mean_kl",
                "running_moments", "loop_position"):
        if first_diff is None and saved_a[key] != saved[key]:
            first_diff = {"state.json": key}
    resumed_losses = [v for _, v in loss_steps(resumed)]
    full_losses = [v for s, v in loss_steps(full) if s > RESUME_INTERVAL]
    loss_diff = max(abs(x - y) for x, y in zip(resumed_losses, full_losses))
    # the second cycle's rollout: run 1's third sampler call, run 3's first
    tokens_equal = torch.equal(runs["resumed"]["sequences"][0], runs["uninterrupted"]["sequences"][2])
    spread = None
    if first_diff is None:
        equal_ok = tokens_equal and resumed_losses == full_losses
    else:
        config = base.evolve(train=dict(checkpoint_dir=os.path.join(root, "d")))
        again, *_ = counted_train(config, {}, "resume_spread")
        spread = max(abs(x - y) for x, y in zip([v for _, v in loss_steps(again)][RESUME_INTERVAL:], full_losses))
        equal_ok = loss_diff <= 2 * spread
        del again
    wall = time.perf_counter() - t_phase
    emit("resume_path", wall_s=wall, run_wall_s={k: r["wall"] for k, r in runs.items()}, commits=commits,
         checkpoint_gb=size_gb, load_s=load_s, resume_load_s=loads,
         card=nvidia_smi(), integrity=status, integrity_problems=problems[:3], restored_tensors=len(
             killed.model.state_dict()) + n_opt, restore_mismatched=mismatched[:8], iter_count=resumed.iter_count,
         prompt_cursor=resumed._prompt_batches_consumed, loss_steps=logged_loss_steps, tracker_steps_monotonic=
         steps == sorted(steps), step8_first_difference=first_diff, second_cycle_tokens_equal=tokens_equal,
         resumed_losses=resumed_losses, uninterrupted_losses=full_losses, max_loss_difference=loss_diff,
         uninterrupted_spread=spread, launches_by_run={
             k: r["launches"] for k, r in runs.items()}, expected=expect, decode_steps={
             k: r["decode_steps"] for k, r in runs.items()})
    if status != "ok" or mismatched:
        raise AssertionError(f"resume_path (a): integrity {status} {problems[:3]}; restored tensors that differ: "
                             f"{mismatched[:8]}")
    if not counters_ok:
        raise AssertionError(f"resume_path (b): iter_count {resumed.iter_count} / {full.iter_count}, cursor "
                             f"{resumed._prompt_batches_consumed} / {full._prompt_batches_consumed}, loss steps "
                             f"{logged_loss_steps}, tracker steps {steps}")
    if not equal_ok:
        raise AssertionError(f"resume_path (c): step-8 states {'differ at ' + str(first_diff) if first_diff else 'equal'}"
                             f"; resumed losses {resumed_losses} vs {full_losses} (largest difference {loss_diff}, "
                             f"spread {spread}, tokens equal {tokens_equal})")
    del runs, full, killed, resumed
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return total


def ppo_phases(seed: int, shapes: dict, train_split: list) -> dict:
    """overlap_path; ppo_knobs_path with the value branch's cost, its
    reference and one profiled train step; stop_path and its reference:
    {path: launches}."""
    import torch

    launches = {"overlap": overlap_path(seed, shapes, train_split)}
    torch.cuda.empty_cache()
    trainer, launches["ppo_knobs"] = ppo_knobs_path(seed, shapes)
    batch = ppo_knobs_reference(trainer, seed)["batch"]
    value_branch_cost(trainer)
    train_step_profile(trainer, batch, "ppo_knobs_train_step")
    del trainer, batch
    torch.cuda.empty_cache()
    trainer, launches["stop"] = stop_path(seed, shapes)
    stop_reference(trainer, seed)
    del trainer
    torch.cuda.empty_cache()
    return launches


def train_step_profile(trainer, batch, name: str = "train_step") -> None:
    """Wall time of one optimizer step (median of 3 after a warm-up) and
    one traced step: device busy and idle share, the largest kernels."""
    wall, samples, _ = timed(lambda: trainer.train_step(batch))
    if hasattr(batch, "query_tensors"):  # a rollout minibatch: [query, response] lengths
        rows, seq = len(batch.query_tensors), [batch.query_tensors.shape[1], batch.response_tensors.shape[1]]
    elif hasattr(batch, "chosen_ids"):  # a DPO batch: the chosen and rejected rows, stacked
        rows, seq = 2 * batch.chosen_ids.shape[0], batch.chosen_ids.shape[1]
    else:  # an SFT batch
        rows, seq = batch.input_ids.shape
    emit(f"{name}_time", wall_ms=wall * 1e3, batch=rows, seq=seq, samples_ms=[x * 1e3 for x in samples])
    profile_phase(name, lambda: trainer.train_step(batch), wall, grad=True)


# the SFT path at GPT-2-small width: the first 64 of TRAIN_PROMPTS (eight
# distinct prompts) as (prompt, output) pairs with one fixed output a
# prompt, byte-tokenised and right-padded to 64, batch 32, 16 optimizer
# steps (8 epochs of two full batches), greedy evaluations of 32 BOS
# prompts x 32 new tokens at each end
SFT_OUTPUTS = {
    "the movie was": " a quiet triumph of small moments.",
    "I watched this and": " laughed all the way home.",
    "a review of the film:": " four stars, see it twice.",
    "honestly the plot": " made no sense at all.",
    "the acting in this": " film is the best of the year.",
    "what a film,": " truly moving and warm.",
    "two hours of": " pure joy on the big screen.",
    "the director chose": " long takes over fast cuts.",
}
SFT_SAMPLES = [(p, SFT_OUTPUTS[p]) for p in TRAIN_PROMPTS[:64]]
SFT_SEQ, SFT_BATCH, SFT_STEPS, SFT_NEW_TOKENS = 64, 32, 16, 32
# sft_path's loss gate: the last step's loss at least this many nats under
# the first's (random weights start near ln(50257) = 10.8)
SFT_LOSS_DROP = 2.0
# the reload path: one PPO cycle of the headline workload (4 epochs x 2 minibatches)
RELOAD_STEPS = TRAIN_EPOCHS * TRAIN_ROLLOUTS // TRAIN_BATCH
# the randomwalks PPO curve's floor (tests/test_curves.py)
RANDOMWALKS_FLOOR = 0.9


def sft_config(seed: int, attention_impl="pallas", kv_cache_quant="int8_kernel", compute_dtype="bfloat16"):
    from trlx_tpu_torch.data.default_configs import default_sft_config

    transformer = dict(GPT2_PATHS, attention_impl=attention_impl, kv_cache_quant=kv_cache_quant)
    return default_sft_config().evolve(
        train=dict(batch_size=SFT_BATCH, total_steps=SFT_STEPS, eval_interval=10_000,
                   checkpoint_interval=10_000, seq_length=SFT_SEQ, epochs=10_000, tracker=None,
                   compute_dtype=compute_dtype, seed=seed, **ckpt_kw()),
        model=dict(model_path="random", num_layers_unfrozen=-1, model_extra_configs={"transformer": transformer}),
        tokenizer=dict(tokenizer_path="byte"),
        method=dict(gen_kwargs=dict(max_new_tokens=SFT_NEW_TOKENS, do_sample=False)),
    )


def sft_path(seed: int, shapes: dict):
    """`trlx_tpu_torch.train(samples=...)` at GPT-2-small width (random
    weights from the seed, everything trainable, bf16 compute / fp32
    params, the flash and int8 decode kernels): evaluate, 16 optimizer
    steps on right-padded batches, evaluate. Gates: finite losses, the
    last at least SFT_LOSS_DROP nats under the first, the exact launch counts,
    trainable parameters moved."""
    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch.utils.tokenizers import ByteTokenizer

    counters = train_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with forward_shapes(shapes, "sft"), sampler_calls() as calls:
        trainer = trlx_tpu_torch.train(samples=SFT_SAMPLES, config=sft_config(seed))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}

    L = trainer.model.cfg.n_layer
    decode_steps = [c["decode_steps"] for c in calls]
    # each sampler call (an eval at each end) prefills through the forward
    # kernel; each train step runs one forward and one backward through
    # every layer, on the short and the fused route (T, S <= 128); each
    # decode step one short-route decode launch a layer (a 64-slot cache)
    n_fwd, n_decode = L * (SFT_STEPS + len(calls)), L * sum(decode_steps)
    expect = {"flash_fwd": n_fwd, "flash_fwd_short": n_fwd, "flash_fwd_long": 0,
              "flash_bwd": L * SFT_STEPS, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
              "decode": n_decode, "decode_short": n_decode, "decode_long": 0}
    losses = [st["losses/loss"] for _, st in trainer.stats_history if "losses/loss" in st]
    tok = ByteTokenizer()
    P = SFT_SEQ - SFT_NEW_TOKENS
    samples = [sorted(set(tok.batch_decode(c["sequences"][:, P:].tolist()))) for c in calls]
    emit("sft_path", wall_s=wall, launches=launches, expected=expect, iter_count=trainer.iter_count,
         sampler_calls=len(calls), decode_steps=decode_steps, losses=losses,
         perplexity=[st["perplexity"] for _, st in trainer.stats_history if "perplexity" in st],
         eval_samples=samples, phase_seconds=dict(trainer.phase_seconds), store_rows=len(trainer.store),
         loss_drop=SFT_LOSS_DROP)
    if len(losses) != SFT_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"expected {SFT_STEPS} finite losses, got {losses}")
    if losses[-1] > losses[0] - SFT_LOSS_DROP:
        raise AssertionError(f"the SFT loss fell only from {losses[0]} to {losses[-1]}")
    if len(calls) != 2 or not 0 < n_decode <= 2 * L * (SFT_NEW_TOKENS - 1):
        raise AssertionError(f"expected 2 sampler calls of at most {SFT_NEW_TOKENS - 1} decode steps, got {decode_steps}")
    if {k: launches[k] for k in expect} != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    check_params_moved(trainer, seed, "sft_params")
    return trainer, launches


SFT_REFERENCE_ROWS = 256  # 8 minibatches of independent rows for sft_reference
SFT_WORDS = ("the", "film", "was", "a", "quiet", "story", "of", "two", "friends", "and", "their", "long",
             "road", "home", "it", "is", "warm", "funny", "slow", "bright", "sad", "true", "best", "year")


def sft_reference_samples(seed: int) -> list:
    """SFT_REFERENCE_ROWS distinct (prompt, output) pairs: the eight
    prompts with 3-10 words drawn from SFT_WORDS (numpy, from the seed)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    prompts = sorted(SFT_OUTPUTS)
    return [(prompts[i % len(prompts)], " " + " ".join(rng.choice(SFT_WORDS, size=rng.integers(3, 11))) + ".")
            for i in range(SFT_REFERENCE_ROWS)]


def sft_reference(trainer, seed: int) -> dict:
    """One SFT step's loss and gradients on the same batches three ways
    (`grad_reference`: the kernel path, the plain bf16 and the plain fp32
    paths), over the loss and the logprobs of the counted label tokens.
    The minibatches: a fresh store of SFT_REFERENCE_ROWS distinct pairs
    cut into eight batches of 32. The path's own store holds eight
    distinct sequences, so its batches would repeat one draw of bf16
    rounding noise (as train_reference's docstring says of one
    minibatch's loss error)."""
    import torch

    from trlx_tpu_torch.ops.common import logprobs_of_labels

    def step(t, batch):
        loss, _ = t.loss(batch)
        loss.backward()
        batch = batch.map(lambda x: x.to(t.device))
        labels = batch.labels[:, 1:]
        real = labels != -100
        with torch.no_grad():
            logits = t.model(batch.input_ids, batch.attention_mask)["logits"]
            lp = logprobs_of_labels(logits[:, :-1], torch.where(real, labels, 0))
        return loss, (lp.float(),), real

    trainer.make_experience(sft_reference_samples(seed), None, SFT_SEQ)
    batches = list(trainer.store.create_loader(SFT_BATCH, shuffle=True, seed=seed))
    grad_reference(trainer, {
        "plain_bf16": sft_config(seed, attention_impl="xla", kv_cache_quant="int8"),
        "fp32": sft_config(seed, attention_impl="xla", kv_cache_quant=None, compute_dtype="float32"),
    }, batches, step, ("logprobs",), "sft_reference")
    return {"batch": batches[0]}


def reload_path(sft_trainer, seed: int, shapes: dict) -> dict:
    """`save_pretrained` of the SFT trainer into a temporary directory, then
    `trlx_tpu_torch.train(reward_fn=..., model_path=<dir>)` with the train
    path's headline config for one cycle. Gates: the loaded base tensors
    and the frozen reference equal the saved ones bit for bit; one forward
    of the reloaded policy (right after the load) and of the SFT model on
    the same batch give bitwise-equal logits; the launch counts (the
    runtime keys of model_extra_configs reached the loaded model: kernel 1
    ran); finite losses."""
    import os
    import tempfile

    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch.trainer.base import BASE_WEIGHTS
    from trlx_tpu_torch.trainer.ppo import TPUPPOTrainer

    batch = next(iter(sft_trainer.store.create_loader(SFT_BATCH))).map(lambda x: x.cuda())
    with torch.no_grad():
        sft_logits = sft_trainer.model(batch.input_ids, batch.attention_mask)["logits"]
    loaded = {}
    setup = TPUPPOTrainer.setup_model

    def capture(self):
        setup(self)
        loaded["state"] = {k: v.detach().clone() for k, v in self.model.base.state_dict().items()}
        loaded["cfg"] = self.model.cfg
        with torch.no_grad():
            loaded["logits"] = self.model.base(batch.input_ids, batch.attention_mask)["logits"]

    counters = train_counters()
    with tempfile.TemporaryDirectory() as directory:
        t0 = time.perf_counter()
        sft_trainer.save_pretrained(directory)
        save_s = time.perf_counter() - t0
        saved = torch.load(os.path.join(directory, BASE_WEIGHTS), map_location="cuda", weights_only=True)
        files = sorted(os.listdir(directory))
        for fn in counters.values():
            fn.launches = 0
        TPUPPOTrainer.setup_model = capture
        try:
            t0 = time.perf_counter()
            with forward_shapes(shapes, "reload"), sampler_calls() as calls:
                trainer = trlx_tpu_torch.train(reward_fn=train_reward_fn, prompts=TRAIN_PROMPTS, model_path=directory,
                                               config=train_config(seed).evolve(train=dict(total_steps=RELOAD_STEPS)))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            TPUPPOTrainer.setup_model = setup
    launches = {name: fn.launches for name, fn in counters.items()}
    L = trainer.model.cfg.n_layer
    n_decode = L * sum(c["decode_steps"] for c in calls)
    # three sampler calls (evals at each end, one rollout), the policy and
    # the reference copy over the experience chunk, the train steps, and
    # the forward right after the load
    n_fwd = L * (len(calls) + 2 + RELOAD_STEPS + 1)
    expect = {"flash_fwd": n_fwd, "flash_fwd_short": n_fwd, "flash_fwd_long": 0,
              "flash_bwd": L * RELOAD_STEPS, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
              "decode": n_decode, "decode_short": n_decode, "decode_long": 0}
    base_unequal = [k for k, v in saved.items() if not torch.equal(loaded["state"][k], v)]
    ref_unequal = [k for k, v in trainer.ref_params.state_dict().items() if not torch.equal(v, saved[k])]
    logits_diff = (loaded["logits"].float() - sft_logits.float()).abs().max().item()
    losses = [st["losses/total_loss"] for _, st in trainer.stats_history if "losses/total_loss" in st]
    emit("reload", files=files, save_s=save_s, wall_s=wall, tensors=len(saved), base_unequal=base_unequal,
         reference_unequal=ref_unequal, logits_bitwise_equal=torch.equal(loaded["logits"], sft_logits),
         logits_max_abs_diff=logits_diff, attention_impl=loaded["cfg"].attention_impl,
         kv_cache_quant=loaded["cfg"].kv_cache_quant, launches=launches, expected=expect,
         decode_steps=[c["decode_steps"] for c in calls], losses=losses, iter_count=trainer.iter_count)
    if base_unequal or ref_unequal or set(saved) != set(loaded["state"]):
        raise AssertionError(f"loaded tensors {base_unequal} or reference tensors {ref_unequal} differ from the saved")
    if not torch.equal(loaded["logits"], sft_logits):
        raise AssertionError(f"the reloaded policy's logits differ from the SFT model's by up to {logits_diff}")
    if {k: launches[k] for k in expect} != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    if len(losses) != RELOAD_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"expected {RELOAD_STEPS} finite losses, got {losses}")
    return launches


def sft_phases(seed: int, shapes: dict) -> dict:
    """This slice's phases in order: sft_path, sft_reference, the SFT
    train step's time and profile, reload, randomwalks. Returns the SFT
    path's launch counts."""
    import torch

    trainer, launches = sft_path(seed, shapes)
    batch = sft_reference(trainer, seed)["batch"]
    train_step_profile(trainer, batch, "sft_train_step")
    reload_path(trainer, seed, shapes)
    del trainer, batch
    torch.cuda.empty_cache()
    randomwalks_path()
    return launches


def randomwalks_path() -> None:
    """The port's randomwalks runners on the card with the JAX example's
    configs: SFT on the gold paths, then the PPO protocol (behaviour
    cloning, save_pretrained, reload, PPO). Gate: the PPO run's last eval
    optimality >= RANDOMWALKS_FLOOR, as tests/test_curves.py holds the
    JAX package's curve."""
    import tempfile

    import torch

    from trlx_tpu_torch.examples import ppo_randomwalks, sft_randomwalks
    from trlx_tpu_torch.examples.curves import curve_rows

    def optimality(trainer):
        return [(step, st["metrics/optimality"]) for step, st in trainer.stats_history if "metrics/optimality" in st]

    with tempfile.TemporaryDirectory() as directory:
        t0 = time.perf_counter()
        sft = sft_randomwalks.main({"train.checkpoint_dir": directory + "/sft"})
        torch.cuda.synchronize()
        sft_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ppo = ppo_randomwalks.main({"train.checkpoint_dir": directory + "/ppo"})
        torch.cuda.synchronize()
        ppo_s = time.perf_counter() - t0
    sft_curve, ppo_curve = optimality(sft), optimality(ppo)
    final = round(ppo_curve[-1][1], 4)  # the curves' recorded precision: a float32 mean of 18/20 reads 0.9
    emit("randomwalks", sft_wall_s=sft_s, sft_steps=sft.iter_count, sft_optimality=sft_curve,
         sft_final_optimality=sft_curve[-1][1], sft_phase_seconds=dict(sft.phase_seconds),
         ppo_wall_s=ppo_s, ppo_steps=ppo.iter_count, ppo_phase_seconds=dict(ppo.phase_seconds),
         ppo_rows=curve_rows(ppo.stats_history, ["reward/mean", "metrics/optimality", "losses/total_loss"]),
         final_optimality=final, floor=RANDOMWALKS_FLOOR)
    if final < RANDOMWALKS_FLOOR:
        raise AssertionError(f"randomwalks PPO final optimality {final} < {RANDOMWALKS_FLOOR}")
    # where the time goes at this size: one SFT step and one rollout of the
    # 20 eval prompts, each timed (median of 3) and traced
    train_step_profile(sft, next(iter(sft.store.create_loader(sft.config.train.batch_size))),
                       "randomwalks_sft_step")
    batch = next(iter(ppo.eval_dataloader))

    def rollout():
        return ppo.generate(batch.input_ids, batch.attention_mask)

    profile_phase("randomwalks_rollout", rollout, timed(rollout)[0])


# examples/ppo_sentiments_t5.py:17-59 at T5-base width: batch 12, chunk 12,
# 4 PPO epochs, 64 new tokens, everything trainable; 48 rollouts a cycle
# (the example's 128, cut to keep the run's time) and two cycles
T5_ROLLOUTS, T5_BATCH, T5_EPOCHS = 48, 12, 4
T5_TRAIN_STEPS = 2 * T5_EPOCHS * T5_ROLLOUTS // T5_BATCH
T5_REFERENCE_ROLLOUTS = 96  # 8 minibatches of independent rows for the T5 train reference


def t5_config(seed: int, attention_impl="pallas", compute_dtype="bfloat16", **model_kw):
    """The example's settings on random T5-base weights and the byte
    tokenizer. seq_length 96 keeps the 32-token prompts of the other paths
    under the 64 new tokens (the example's 128 would pad them to 64). T5's
    decoder starts from its pad token, which is not its EOS; the byte
    tokenizer's pad IS its EOS, and random tied embeddings make the start
    token predict itself, so every row would end at its first token: the
    decoder starts from the byte tokenizer's BOS instead."""
    from trlx_tpu_torch.data.default_configs import default_ppo_config
    from trlx_tpu_torch.utils.tokenizers import ByteTokenizer

    seq2seq = dict(T5_PATHS, attention_impl=attention_impl, decoder_start_token_id=ByteTokenizer().bos_token_id)
    model = dict(model_path="random", model_arch_type="seq2seq", num_layers_unfrozen=-1,
                 model_extra_configs={"seq2seq": seq2seq})
    model.update(model_kw)
    return default_ppo_config().evolve(
        train=dict(seq_length=T5_PROMPT_LEN + T5_NEW_TOKENS, epochs=10_000, total_steps=T5_TRAIN_STEPS,
                   batch_size=T5_BATCH, checkpoint_interval=10_000, eval_interval=10_000, tracker=None,
                   compute_dtype=compute_dtype, seed=seed, **ckpt_kw()),
        model=model,
        tokenizer=dict(tokenizer_path="byte", padding_side="right", truncation_side="right"),
        optimizer=dict(name="adamw", kwargs=dict(lr=5.0e-5, betas=(0.9, 0.999), eps=1.0e-8, weight_decay=1.0e-6)),
        scheduler=dict(name="cosine_annealing", kwargs=dict(T_max=10000, eta_min=5.0e-5)),
        method=dict(num_rollouts=T5_ROLLOUTS, chunk_size=T5_BATCH, ppo_epochs=T5_EPOCHS, init_kl_coef=0.05,
                    target=6, horizon=10000, gamma=0.99, lam=0.95, cliprange=0.2, cliprange_value=0.2,
                    vf_coef=1.0, scale_reward=None, ref_mean=None, ref_std=None, cliprange_reward=10,
                    gen_kwargs=dict(max_new_tokens=T5_NEW_TOKENS, do_sample=True, top_k=0, top_p=1.0)),
    )


def build_t5_policy(seed: int, attention_impl: str, compute_dtype="bfloat16"):
    """`Seq2SeqLMWithValueHead.from_config` at T5-base width with the
    default PPO config's hydra fork (num_layers_unfrozen 2: branch_at 2)."""
    import torch

    from trlx_tpu_torch.models.wrappers import Seq2SeqLMWithValueHead

    policy = Seq2SeqLMWithValueHead.from_config(t5_config(seed, attention_impl, compute_dtype, num_layers_unfrozen=2))
    policy.init_params(torch.Generator().manual_seed(seed))
    return policy


def bias_fwd_counters():
    """The bias forward's launch counters: every launch, and each route's."""
    from trlx_tpu_torch.ops import flash_attention as fa

    return {"flash_bias_fwd": fa.flash_attention_bias, "flash_bias_fwd_short": fa.flash_attention_bias_fwd_short,
            "flash_bias_fwd_long": fa.flash_attention_bias_fwd_long}


def bias_counters():
    """The launch counters of the attention kernels the T5 paths may run:
    the bias forward (every launch, and each route's), the bias backward's
    fused kernel and its long route's pair, the plain flash forward (every
    launch, and each route's), and the plain flash backward's fused kernel
    and its long route's pair."""
    from trlx_tpu_torch.ops import flash_attention as fa

    return {**bias_fwd_counters(), "flash_bias_bwd": fa.flash_attention_bias_bwd,
            "flash_bias_bwd_dq": fa.flash_attention_bias_dq,
            "flash_bias_bwd_dkv": fa.flash_attention_bias_dkv, **fwd_counters(),
            "flash_bwd": fa.flash_attention_bwd, "flash_bwd_dq": fa.flash_attention_dq,
            "flash_bwd_dkv": fa.flash_attention_dkv}


def t5_path(seed: int, shapes: dict, bias_shapes: dict) -> dict:
    """T5-base (random weights from the seed) through `generate_seq2seq`
    (64 byte prompts right-padded to 32, 64 new tokens, greedy) and one
    `forward_train` experience pass over its output, on the kernels
    (attention_impl "pallas"); the same weights on the plain bf16 ("xla")
    and fp32 math are its reference. Gates: the launch counts, shapes and
    finite values, the kernel path's experience logits, values and
    reference logits within 2x the plain bf16 path's error against fp32,
    and the per-step greedy agreement with the plain bf16 path on the same
    prefix at least T5_STEP_AGREEMENT."""
    import torch

    from trlx_tpu_torch.models.generation import SamplerSettings
    from trlx_tpu_torch.models.seq2seq import generate_seq2seq
    from trlx_tpu_torch.utils.tokenizers import ByteTokenizer

    policy = build_t5_policy(seed, "pallas")
    if policy.branch_at != policy.cfg.n_decoder_layer - 2 or policy.cfg.dtype != torch.bfloat16:
        raise AssertionError("the default PPO config must give branch_at=n_decoder_layer - 2 and bf16 compute")
    ref = policy.make_ref_params()
    tok = ByteTokenizer(padding_side="right")
    ids, mask = byte_prompts(tok)
    greedy = SamplerSettings(max_new_tokens=T5_NEW_TOKENS, do_sample=False,
                             eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id)
    counters = bias_counters()

    def rollout(model):
        return generate_seq2seq(model.base, ids, mask, None, greedy)

    def experience(model, ref_params, dec, dec_mask):
        return model.forward_train(ref_params, ids, mask, dec, dec_mask)

    with forward_shapes(shapes, "t5"), bias_fwd_shapes(bias_shapes, "t5"), torch.no_grad():
        for fn in counters.values():
            fn.launches = 0
        out = rollout(policy)
        torch.cuda.synchronize()
        gen_launches = {name: fn.launches for name, fn in counters.items()}
        dec = out["sequences"]
        dec_mask = torch.cat([torch.ones_like(dec[:, :1], dtype=torch.int32), out["response_mask"]], dim=1)
        exp = experience(policy, ref, dec, dec_mask)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
    cfg = policy.cfg
    top = cfg.n_decoder_layer - policy.branch_at
    n_bias = cfg.n_layer + (cfg.n_layer + cfg.n_decoder_layer + top)
    # every bias forward on the short route (T5's lengths are at most 128)
    expect = {"flash_bias_fwd": n_bias, "flash_bias_fwd_short": n_bias, "flash_bias_fwd_long": 0,
              "flash_fwd": cfg.n_decoder_layer + top, "flash_fwd_short": cfg.n_decoder_layer + top,
              "flash_fwd_long": 0, "flash_bias_bwd": 0,
              "flash_bias_bwd_dq": 0, "flash_bias_bwd_dkv": 0, "flash_bwd": 0, "flash_bwd_dq": 0,
              "flash_bwd_dkv": 0}
    emit("t5_path", launches=launches, expected=expect, generate_launches=gen_launches,
         response_tokens=int(out["response_mask"].sum()), shape=list(dec.shape))
    if launches != expect or gen_launches["flash_bias_fwd_short"] != cfg.n_layer:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    B, T = dec.shape
    shapes = {"logits": (B, T, cfg.vocab_size), "values": (B, T), "ref_logits": (B, T, cfg.vocab_size)}
    for key, shape in shapes.items():
        if tuple(exp[key].shape) != shape or not torch.isfinite(exp[key]).all():
            raise AssertionError(f"{key}: shape {tuple(exp[key].shape)} or non-finite values")

    plain = build_t5_policy(seed, "xla")
    plain.load_state_dict(policy.state_dict())
    exact = build_t5_policy(seed, "xla", "float32")
    exact.load_state_dict(policy.state_dict())
    with torch.no_grad():
        out_x = rollout(plain)
        exp_x = experience(plain, plain.make_ref_params(), dec, dec_mask)
        exp_f = experience(exact, exact.make_ref_params(), dec, dec_mask)
    real = dec_mask.bool()

    def max_err(a, b, key):
        diff = (a[key].float() - b[key].float()).abs()
        return (diff * (real[..., None] if diff.dim() == 3 else real)).max().item()

    err = {key: {"kernel_vs_fp32": max_err(exp, exp_f, key), "plain_bf16_vs_fp32": max_err(exp_x, exp_f, key),
                 "kernel_vs_plain_bf16": max_err(exp, exp_x, key)}
           for key in ("logits", "ref_logits", "values")}
    both = out["response_mask"].bool() & out_x["response_mask"].bool()
    free = (out["response_ids"] == out_x["response_ids"])[both].float().mean().item()
    # per-step greedy decisions on the same prefix: the argmax of the
    # teacher-forced logits at each position whose next token is a response
    # token, kernel path against the plain bf16 path (and each against fp32)
    decisions = real[:, 1:]
    choice = {name: e["logits"][:, :-1].argmax(dim=-1) for name, e in (("kernel", exp), ("plain_bf16", exp_x),
                                                                       ("fp32", exp_f))}

    def agree(a, b):
        return (choice[a] == choice[b])[decisions].float().mean().item()

    step = agree("kernel", "plain_bf16")
    step_fp32 = {"kernel_vs_fp32": agree("kernel", "fp32"), "plain_bf16_vs_fp32": agree("plain_bf16", "fp32")}
    emit("t5_reference", experience_max_abs_err=err, greedy_step_agreement_vs_plain_bf16=step,
         greedy_step_agreement_fp32=step_fp32, greedy_step_decisions=int(decisions.sum().item()),
         greedy_free_running_agreement_vs_plain_bf16=free)
    for key, e in err.items():
        if e["kernel_vs_fp32"] > 2 * e["plain_bf16_vs_fp32"]:
            raise AssertionError(f"T5 {key}: the kernel path strays from fp32 more than 2 x plain bf16 does")
    if step < T5_STEP_AGREEMENT:
        raise AssertionError(f"only {step:.2%} of T5 greedy decisions agree with the plain bf16 path on the same "
                             f"prefix (floor {T5_STEP_AGREEMENT:.0%})")
    del plain, exact, exp_x, exp_f, out_x

    walls = {}
    with torch.no_grad():
        for name, fn in (("t5_rollout", lambda: rollout(policy)),
                         ("t5_experience", lambda: experience(policy, ref, dec, dec_mask))):
            walls[name], samples, _ = timed(fn)
            emit(f"{name}_time", wall_s=walls[name], samples_s=samples, batch=B, prompt_len=T5_PROMPT_LEN,
                 decoder_len=T, new_tokens=int(out["response_mask"].sum()))
            # the rollout's 64 decode steps: the host trace is slow to gather and adds nothing to the device sums
            profile_phase(name, fn, walls[name], host_ops=name != "t5_rollout")
    return launches


def t5_train_path(seed: int, shapes: dict, bias_shapes: dict):
    """`trlx_tpu_torch.train` with model_arch_type "seq2seq" at T5-base
    width (random weights from the seed, everything trainable, a full frozen
    reference copy, bf16 compute / fp32 params, the six attention kernels):
    evaluate, two rollout cycles of 48, 32 optimizer steps, evaluate.
    Gates: finite losses, the launch counts the path implies (both
    forwards' short kernels and both backwards' fused kernels, and none of
    their long routes), every
    trainable tensor moved (both relative-bias tables and the encoder
    included), the frozen reference did not."""
    import torch

    import trlx_tpu_torch

    counters = bias_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with forward_shapes(shapes, "t5_train"), bias_fwd_shapes(bias_shapes, "t5_train"):
        trainer = trlx_tpu_torch.train(reward_fn=train_reward_fn, prompts=TRAIN_PROMPTS, config=t5_config(seed))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}

    cfg = trainer.model.cfg
    chunks = 2 * T5_ROLLOUTS // T5_BATCH  # experience passes, one a rollout chunk
    n_gen = chunks + 2  # and an evaluation at each end: each encodes once
    tf = cfg.n_layer + cfg.n_decoder_layer  # bias forwards of one teacher-forced pass
    # each experience chunk runs the policy and the full reference copy;
    # each train step one forward and one backward through every layer, both
    # forwards on the short route and both backwards on the fused one (T5's
    # lengths are at most 128)
    n_cross = 2 * cfg.n_decoder_layer * chunks + cfg.n_decoder_layer * T5_TRAIN_STEPS
    n_bias = cfg.n_layer * n_gen + 2 * tf * chunks + tf * T5_TRAIN_STEPS
    expect = {"flash_bias_fwd": n_bias, "flash_bias_fwd_short": n_bias, "flash_bias_fwd_long": 0,
              "flash_fwd": n_cross, "flash_fwd_short": n_cross, "flash_fwd_long": 0,
              "flash_bias_bwd": tf * T5_TRAIN_STEPS, "flash_bias_bwd_dq": 0, "flash_bias_bwd_dkv": 0,
              "flash_bwd": cfg.n_decoder_layer * T5_TRAIN_STEPS, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    steps = [(step, st["losses/total_loss"]) for step, st in trainer.stats_history if "losses/total_loss" in st]
    rewards = [st["reward/mean"] for _, st in trainer.stats_history if "reward/mean" in st]
    emit("t5_train_path", wall_s=wall, launches=launches, expected=expect, iter_count=trainer.iter_count,
         losses=[x[1] for x in steps], eval_reward_mean=rewards, kl_ctl_value=trainer.kl_ctl.value,
         cycle_seconds=cycle_split(trainer))
    if len(steps) != T5_TRAIN_STEPS or not all(math.isfinite(x[1]) for x in steps):
        raise AssertionError(f"expected {T5_TRAIN_STEPS} finite losses, got {[x[1] for x in steps]}")
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    check_params_moved(trainer, seed, "t5_train_params")
    return trainer, launches


def t5_train_reference(trainer, seed: int) -> dict:
    return train_reference(
        trainer, seed,
        configs={"plain_bf16": t5_config(seed, attention_impl="xla"),
                 "fp32": t5_config(seed, attention_impl="xla", compute_dtype="float32")},
        rollouts=T5_REFERENCE_ROLLOUTS, batch_size=T5_BATCH, phase="t5_train_reference",
    )


# ---------------------------------------------------------------------------
# offline ILQL (causal and T5) and RFT
# ---------------------------------------------------------------------------

# ilql_path: 64 byte dialogues of a 32-token prompt and a 32-token output
# (31 letters and the EOS) with seeded rewards, batch 32, 16 optimizer
# steps, the Polyak sync every 5 steps (checked at each pass's end: once,
# at step 10), evaluations at steps 0, 8 and 16 sweeping beta over [0, 1]
# on 32 prompts, 32 sampled new tokens, top_k 20
ILQL_ROWS, ILQL_BATCH, ILQL_STEPS, ILQL_SEQ, ILQL_NEW_TOKENS = 64, 32, 16, 64, 32
ILQL_BETAS = [0, 1]
ILQL_REFERENCE_ROWS = 256  # 8 minibatches of independent rows for ilql_reference
# ilql_t5_path: T5-base, 24 dialogues (batch 12: encoder 32 tokens, decoder
# the start token + 32), 8 steps, greedy evaluations at each end at beta 0
# and 1, 16 new tokens
ILQL_T5_ROWS, ILQL_T5_BATCH, ILQL_T5_STEPS, ILQL_T5_NEW_TOKENS = 24, 12, 8, 16
ILQL_T5_REFERENCE_ROWS = 96
# rft_path: GPT-2-small widths over the byte vocabulary (its samples are
# decoded to strings and re-tokenised), 16 prompts x 4 generations, a new
# sampling round every 2 epochs, batch 32, 32 new tokens, 8 steps
RFT_PROMPTS = [f"{TRAIN_PROMPTS[i % 8]} ({i})" for i in range(16)]
RFT_GENERATIONS, RFT_IMPROVE_STEPS, RFT_STEPS = 4, 2, 8
# the randomwalks curves' floors (tests/test_curves.py)
RANDOMWALKS_ILQL_FLOOR, RANDOMWALKS_RFT_FLOOR = 0.9, 0.85
ILQL_LOSS_TERMS = ("loss_q", "loss_v", "loss_cql", "loss_awac")


def ilql_dialogues(seed: int, n: int):
    """`n` (prompt, output) byte strings, a 32-letter prompt and a 31-letter
    output each (the EOS makes it 32 tokens), and a normal reward each,
    from numpy's generator at `seed`."""
    import numpy as np

    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz     "))
    samples = [("".join(rng.choice(letters, 32)), "".join(rng.choice(letters, 31))) for _ in range(n)]
    return samples, rng.normal(size=n).tolist()


def ilql_config(seed: int, attention_impl="pallas", kv_cache_quant="int8_kernel", compute_dtype="bfloat16"):
    from trlx_tpu_torch.data.default_configs import default_ilql_config

    transformer = dict(GPT2_PATHS, attention_impl=attention_impl, kv_cache_quant=kv_cache_quant)
    return default_ilql_config().evolve(
        train=dict(batch_size=ILQL_BATCH, total_steps=ILQL_STEPS, eval_interval=ILQL_STEPS // 2,
                   checkpoint_interval=10_000, seq_length=ILQL_SEQ, epochs=10_000, tracker=None,
                   compute_dtype=compute_dtype, seed=seed, **ckpt_kw()),
        model=dict(model_path="random", num_layers_unfrozen=-1, model_extra_configs={"transformer": transformer}),
        tokenizer=dict(tokenizer_path="byte"),
        method=dict(two_qs=True, steps_for_target_q_sync=5,
                    gen_kwargs=dict(max_new_tokens=ILQL_NEW_TOKENS, top_k=20, beta=ILQL_BETAS, do_sample=True)),
    )


def ilql_t5_config(seed: int, attention_impl="pallas", compute_dtype="bfloat16"):
    """T5-base on random weights over the byte tokenizer (right padding),
    the decoder starting from the BOS as in `t5_config`."""
    from trlx_tpu_torch.data.default_configs import default_ilql_config
    from trlx_tpu_torch.utils.tokenizers import ByteTokenizer

    seq2seq = dict(T5_PATHS, attention_impl=attention_impl, decoder_start_token_id=ByteTokenizer().bos_token_id)
    return default_ilql_config().evolve(
        train=dict(batch_size=ILQL_T5_BATCH, total_steps=ILQL_T5_STEPS, eval_interval=10_000,
                   checkpoint_interval=10_000, seq_length=ILQL_SEQ, epochs=10_000, tracker=None,
                   compute_dtype=compute_dtype, seed=seed, **ckpt_kw()),
        model=dict(model_path="random", model_arch_type="seq2seq", num_layers_unfrozen=-1,
                   model_extra_configs={"seq2seq": seq2seq}),
        tokenizer=dict(tokenizer_path="byte", padding_side="right", truncation_side="right"),
        method=dict(two_qs=True, steps_for_target_q_sync=4,
                    gen_kwargs=dict(max_new_tokens=ILQL_T5_NEW_TOKENS, beta=ILQL_BETAS, do_sample=False)),
    )


@contextlib.contextmanager
def sync_spy(record: list):
    """Each pass-end callback of an ILQL trainer while active: the heads
    just before and after it, checked at once. A sync (the step count a
    multiple of steps_for_target_q_sync) must leave target = alpha * q +
    (1 - alpha) * target_before to fp32 rounding (recomputed in float64);
    any other call must leave the targets bit for bit. `record` gets one
    entry a call."""
    import torch

    from trlx_tpu_torch.trainer.ilql import TPUILQLTrainer

    callback = TPUILQLTrainer.post_backward_callback

    def checked(self):
        heads = self.model.heads
        before = [[p.detach().clone() for p in t.parameters()] for t in heads.target_q_heads]
        online = [[p.detach().clone() for p in q.parameters()] for q in heads.q_heads]
        callback(self)
        method = self.config.method
        synced = self.iter_count % method.steps_for_target_q_sync == 0
        a = method.alpha
        worst = 0.0
        for t, t0, q0 in zip(heads.target_q_heads, before, online):
            for p, pt, pq in zip(t.parameters(), t0, q0):
                if not synced:
                    if not torch.equal(p, pt):
                        raise AssertionError(f"the target heads moved without a sync at step {self.iter_count}")
                    continue
                want = a * pq.double() + (1.0 - a) * pt.double()
                bound = 3 * 2.0 ** -24 * (a * pq.double().abs() + (1.0 - a) * pt.double().abs()) + 1e-30
                worst = max(worst, ((p.double() - want).abs() / bound).max().item())
        record.append({"step": self.iter_count, "synced": synced, "worst_err_over_fp32_rounding": worst})
        if worst > 1:
            raise AssertionError(f"the sync at step {self.iter_count} strays {worst} x past fp32 rounding")

    TPUILQLTrainer.post_backward_callback = checked
    try:
        yield record
    finally:
        TPUILQLTrainer.post_backward_callback = callback


def check_ilql_params(trainer, seed: int, start_targets: list, phase: str) -> None:
    """Every online tensor moved from its seeded init and is trainable; the
    target heads are not trainable, started as copies of the online heads'
    init, and now hold what the last checked callback left (`start_targets`:
    their values then)."""
    import torch

    model = trainer.model
    init = type(model)(model.cfg, two_qs=model.two_qs, alpha=model.alpha, device="cuda").init_params(
        torch.Generator().manual_seed(seed))
    start = dict(init.named_parameters())
    params = dict(model.named_parameters())
    targets = {n for n in params if n.startswith("heads.target_q_heads.")}
    still = [n for n, p in params.items() if n not in targets and torch.equal(p, start[n])]
    wrong_trainable = sorted({n for n, p in params.items() if p.requires_grad} ^ (set(params) - targets))
    not_copies = [n for n in targets if not torch.equal(start[n], start[n.replace("target_q_heads", "q_heads")])]
    final = [p for t in model.heads.target_q_heads for p in t.parameters()]
    moved_after = [i for i, (p, s) in enumerate(zip(final, start_targets)) if not torch.equal(p, s)]
    emit(phase, trainable=len(trainer.trainable_params), target_tensors=len(targets), unmoved=still,
         wrong_trainable=wrong_trainable, targets_not_init_copies=not_copies, targets_moved_after_last_check=moved_after)
    if still or wrong_trainable or not_copies or moved_after:
        raise AssertionError(f"online tensors that did not move: {still}; trainable set off by {wrong_trainable}; "
                             f"{not_copies} not init copies; targets moved after the last check: {moved_after}")


def ilql_train(config, shapes: dict, path: str, samples, rewards, eval_prompts, counters: dict, bias_shapes=None):
    """`trlx_tpu_torch.train(samples=..., rewards=...)` with every counter
    of `counters` at 0 just before it and the pass-end callbacks checked:
    (trainer, wall s, launches, the decode steps of each sampler call, the
    callback records, the targets as the last callback left them)."""
    import torch

    import trlx_tpu_torch

    for fn in counters.values():
        fn.launches = 0
    records = []
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(forward_shapes(shapes, path))
        if bias_shapes is not None:
            stack.enter_context(bias_fwd_shapes(bias_shapes, path))
        calls = stack.enter_context(sampler_calls())
        stack.enter_context(sync_spy(records))
        trainer = trlx_tpu_torch.train(samples=samples, rewards=rewards, eval_prompts=eval_prompts, config=config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    targets = [p.detach().clone() for t in trainer.model.heads.target_q_heads for p in t.parameters()]
    return trainer, wall, launches, [c["decode_steps"] for c in calls], records, targets


def ilql_losses(trainer, steps: int) -> list:
    losses = [{k: st[f"losses/{k}"] for k in ("loss",) + ILQL_LOSS_TERMS}
              for _, st in trainer.stats_history if "losses/loss" in st]
    if len(losses) != steps or not all(math.isfinite(v) for x in losses for v in x.values()):
        raise AssertionError(f"expected {steps} finite ILQL losses, got {losses}")
    return losses


def ilql_path(seed: int, shapes: dict):
    """`trlx_tpu_torch.train(samples=..., rewards=...)` at GPT-2-small width
    (random weights from the seed, bf16 compute / fp32 params, two Q heads
    of 512 -> 50257, the flash, flash-backward and int8 decode kernels):
    evaluate, 16 optimizer steps, evaluate at 8 and 16, each evaluation
    sampling with the advantage shaping at beta 0 and 1. Gates: the exact
    launch counts, finite losses, every online tensor moved, the Polyak
    sync exact and the targets otherwise unchanged (`sync_spy`), and a
    beta = 0 evaluation equal, token for token, to the sampler with no
    processor from the same generator state. Then one train step's time,
    profile and peak memory, and the processor's share of an evaluation's
    device time."""
    import torch

    from trlx_tpu_torch.models.generation import generate

    samples, rewards = ilql_dialogues(seed, ILQL_ROWS)
    eval_prompts = [p for p, _ in samples[:ILQL_BATCH]]
    trainer, wall, launches, decode_steps, syncs, targets = ilql_train(
        ilql_config(seed), shapes, "ilql", samples, rewards, eval_prompts, train_counters())
    L = trainer.model.cfg.n_layer
    # each sampler call (3 evaluations x 2 betas) prefills through the
    # forward kernel; each train step runs one forward and one backward
    # through every layer (T = S = 64: the short and the fused route); each
    # decode step one short-route decode launch a layer (a 128-slot cache)
    n_fwd, n_decode = L * (ILQL_STEPS + len(decode_steps)), L * sum(decode_steps)
    expect = {"flash_fwd": n_fwd, "flash_fwd_short": n_fwd, "flash_fwd_long": 0,
              "flash_bwd": L * ILQL_STEPS, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
              "decode": n_decode, "decode_short": n_decode, "decode_long": 0}
    losses = ilql_losses(trainer, ILQL_STEPS)
    sweeps = {k: v for _, st in trainer.stats_history for k, v in st.items() if k.startswith("time/generate")}
    emit("ilql_path", wall_s=wall, launches=launches, expected=expect, iter_count=trainer.iter_count,
         sampler_calls=len(decode_steps), decode_steps=decode_steps, losses=losses, syncs=syncs,
         store_rows=len(trainer.store), actions_width=trainer.store.actions_width,
         phase_seconds=dict(trainer.phase_seconds), eval_generate_s=sweeps)
    if len(decode_steps) != 3 * len(ILQL_BETAS) or not 0 < n_decode <= L * len(decode_steps) * (ILQL_NEW_TOKENS - 1):
        raise AssertionError(f"expected {3 * len(ILQL_BETAS)} sampler calls, got {decode_steps}")
    if {k: launches[k] for k in expect} != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    if not any(r["synced"] for r in syncs):
        raise AssertionError(f"no Polyak sync ran: {syncs}")
    check_ilql_params(trainer, seed, targets, "ilql_params")

    # beta = 0 against the processor-free sampler, from one generator state
    batch = next(iter(trainer.eval_dataloader))
    ids, mask = batch.input_ids.cuda(), batch.attention_mask.cuda().to(torch.int32)
    state = trainer.generator.get_state()
    shaped = trainer.generate_eval(ids, mask, beta=0)["sequences"]
    trainer.generator.set_state(state)
    plain = generate(trainer.model.base, ids, mask, trainer.generator, trainer.generate_settings)["sequences"]
    same = (shaped == plain).float().mean().item()
    emit("ilql_beta0", tokens_equal_share=same, shape=list(shaped.shape))
    if not torch.equal(shaped, plain):
        raise AssertionError(f"a beta = 0 evaluation differs from the processor-free sampler ({same:.4%} equal)")

    # one train step: time, profile and the peak memory above the weights
    step_batch = next(iter(trainer.store.create_loader(ILQL_BATCH, shuffle=True, drop_last=True, seed=seed)))
    train_step_profile(trainer, step_batch, "ilql_train_step")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    trainer.train_step(step_batch)
    torch.cuda.synchronize()
    B, A, V = step_batch.actions_ixs.shape + (trainer.model.cfg.vocab_size,)
    emit("ilql_train_step_memory", peak_above_start_bytes=torch.cuda.max_memory_allocated() - base,
         q_tensor_bytes=B * A * V * 4, q_tensor_shape=[B, A, V],
         note="fp32 [B, A, V]: the logits at the actions, two online and two target Q heads, their log-softmaxes")

    # the processor's cost in an evaluation: the same call with and without it
    times, prof = {}, {}
    for name, fn in (("ilql_eval_processor", lambda: trainer.generate_eval(ids, mask, beta=1)),
                     ("ilql_eval_no_processor",
                      lambda: generate(trainer.model.base, ids, mask, trainer.generator, trainer.generate_settings))):
        times[name] = timed(fn)[0]
        prof[name] = {}
        profile_phase(name, fn, times[name], host_ops=False, out=prof[name])
    added = prof["ilql_eval_processor"]["device_busy_ms"] - prof["ilql_eval_no_processor"]["device_busy_ms"]
    emit("ilql_processor_cost", wall_ms={k: v * 1e3 for k, v in times.items()}, processor_added_device_ms=added,
         processor_share_of_eval_device=added / prof["ilql_eval_processor"]["device_busy_ms"],
         decode_kernel_ms=prof["ilql_eval_processor"]["decode_kernel_ms"],
         decode_kernel_share_of_eval_device=(prof["ilql_eval_processor"]["decode_kernel_ms"]
                                             / prof["ilql_eval_processor"]["device_busy_ms"]))
    return trainer, launches


def ilql_grad_reference(trainer, configs: dict, store, batch_size: int, seed: int, phase: str) -> None:
    """`grad_reference` over the ILQL loss, its four terms (as outputs) and
    the gradient of every trainable tensor, on `store`'s batches (one
    shuffle, the ragged tail dropped)."""
    import torch

    def step(t, batch):
        loss, stats = t.loss(batch)
        loss.backward()
        terms = tuple(stats[f"losses/{k}"].detach().float() for k in ILQL_LOSS_TERMS)
        return loss, terms, torch.ones((), dtype=torch.bool, device="cuda")

    batches = list(store.create_loader(batch_size, shuffle=True, drop_last=True, seed=seed))
    grad_reference(trainer, configs, batches, step, ILQL_LOSS_TERMS, phase, must_gate="heads.")


def ilql_reference(trainer, seed: int) -> None:
    """The ILQL train step on the kernels against the plain bf16 and fp32
    paths (`ilql_grad_reference`) on a fresh store of ILQL_REFERENCE_ROWS
    dialogues; then the shaped logits of one processor decode step (beta
    1, the int8 cache and kernel 8 on the kernel path) on each path, after
    a prefill whose token every path takes from the kernel path's: the
    kernel path's mean |error| from fp32 at most twice plain bf16's."""
    import torch

    from trlx_tpu_torch.models.generation import SamplerSettings, generate
    from trlx_tpu_torch.trainer.ilql import make_experience
    from trlx_tpu_torch.utils.loading import get_trainer

    configs = {"plain_bf16": ilql_config(seed, attention_impl="xla", kv_cache_quant="int8"),
               "fp32": ilql_config(seed, attention_impl="xla", kv_cache_quant=None, compute_dtype="float32")}
    samples, rewards = ilql_dialogues(seed + 1, ILQL_REFERENCE_ROWS)
    store = make_experience(samples, rewards, trainer.tokenizer, ILQL_SEQ, verbose=False)
    ilql_grad_reference(trainer, configs, store, ILQL_BATCH, seed, "ilql_reference")

    batch = next(iter(trainer.eval_dataloader))
    ids, mask = batch.input_ids.cuda(), batch.attention_mask.cuda().to(torch.int32)
    greedy = dataclasses.replace(trainer.generate_settings, max_new_tokens=2, do_sample=False, top_k=0)
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}

    def decode_step(t, forced):
        seen = []
        proc = t.generation_logits_processor(beta=1.0)

        def p(h, logits):
            shaped = proc(h, logits)
            seen.append(shaped.float())
            if forced is None or len(seen) > 1:
                return shaped
            return torch.full_like(shaped, float("-inf")).scatter_(1, forced[:, None], 0.0)

        out = generate(t.model.base, ids, mask, None, greedy, logits_processor=p)
        return seen[1], out["response_ids"][:, 0]

    shaped, first = decode_step(trainer, None)
    res = {"kernel": shaped}
    for name, config in configs.items():
        t = get_trainer(config.train.trainer)(config=config)
        t.model.load_state_dict(state)
        res[name], _ = decode_step(t, first)
        del t
    err = {name: (res[name] - res["fp32"]).abs().mean().item() for name in ("kernel", "plain_bf16")}
    emit("ilql_processor_reference", mean_abs_err_vs_fp32=err, shape=list(shaped.shape),
         argmax_agreement_vs_fp32={name: (res[name].argmax(-1) == res["fp32"].argmax(-1)).float().mean().item()
                                   for name in ("kernel", "plain_bf16")})
    if not torch.isfinite(shaped).all() or err["kernel"] > 2 * err["plain_bf16"]:
        raise AssertionError(f"the processor step's shaped logits stray from fp32 by {err['kernel']}, more than "
                             f"2 x plain bf16 ({err['plain_bf16']})")


def ilql_t5_path(seed: int, shapes: dict, bias_shapes: dict):
    """Seq2seq ILQL at T5-base width (random weights from the seed, bf16
    compute / fp32 params, two Q heads of 512 -> 32128, the six attention
    kernels): 24 dialogues, 8 optimizer steps of batch 12 (encoder 32
    tokens, decoder 33: the start token and 32), greedy evaluations at
    each end at beta 0 and 1 (16 new tokens). Gates: the exact launch
    counts of kernels 4, 5+6 (fused), 1 and 2+3 and none of the long
    routes, finite losses, every online tensor moved, the sync exact; then
    the gradient gate of `t5_train_reference` on a fresh store."""
    import torch

    from trlx_tpu_torch.trainer.ilql import make_experience_seq2seq

    samples, rewards = ilql_dialogues(seed, ILQL_T5_ROWS)
    eval_prompts = [p for p, _ in samples[:ILQL_T5_BATCH]]
    trainer, wall, launches, decode_steps, syncs, targets = ilql_train(
        ilql_t5_config(seed), shapes, "ilql_t5", samples, rewards, eval_prompts, bias_counters(), bias_shapes)
    cfg = trainer.model.cfg
    tf = cfg.n_layer + cfg.n_decoder_layer  # bias forwards (and backwards) of one teacher-forced pass
    n_gen = len(decode_steps)  # each sampler call encodes once
    n_bias = tf * ILQL_T5_STEPS + cfg.n_layer * n_gen
    expect = {"flash_bias_fwd": n_bias, "flash_bias_fwd_short": n_bias, "flash_bias_fwd_long": 0,
              "flash_fwd": cfg.n_decoder_layer * ILQL_T5_STEPS, "flash_fwd_short": cfg.n_decoder_layer * ILQL_T5_STEPS,
              "flash_fwd_long": 0, "flash_bias_bwd": tf * ILQL_T5_STEPS, "flash_bias_bwd_dq": 0,
              "flash_bias_bwd_dkv": 0, "flash_bwd": cfg.n_decoder_layer * ILQL_T5_STEPS, "flash_bwd_dq": 0,
              "flash_bwd_dkv": 0}
    losses = ilql_losses(trainer, ILQL_T5_STEPS)
    emit("ilql_t5_path", wall_s=wall, launches=launches, expected=expect, iter_count=trainer.iter_count,
         sampler_calls=n_gen, losses=losses, syncs=syncs, decoder_width=trainer.store.dec_width,
         encoder_width=trainer.store.enc_width, phase_seconds=dict(trainer.phase_seconds))
    if n_gen != 2 * len(ILQL_BETAS) or trainer.store.dec_width != 33:
        raise AssertionError(f"expected {2 * len(ILQL_BETAS)} sampler calls and 33 decoder rows, got {n_gen} and "
                             f"{trainer.store.dec_width}")
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    if not any(r["synced"] for r in syncs):
        raise AssertionError(f"no Polyak sync ran: {syncs}")
    check_ilql_params(trainer, seed, targets, "ilql_t5_params")
    configs = {"plain_bf16": ilql_t5_config(seed, attention_impl="xla"),
               "fp32": ilql_t5_config(seed, attention_impl="xla", compute_dtype="float32")}
    samples, rewards = ilql_dialogues(seed + 1, ILQL_T5_REFERENCE_ROWS)
    store = make_experience_seq2seq(samples, rewards, trainer.tokenizer, ILQL_SEQ, verbose=False,
                                    decoder_start_token_id=cfg.decoder_start_token_id)
    ilql_grad_reference(trainer, configs, store, ILQL_T5_BATCH, seed, "ilql_t5_reference")
    del trainer
    torch.cuda.empty_cache()
    return launches


def rft_config(seed: int, attention_impl="pallas", kv_cache_quant="int8_kernel", compute_dtype="bfloat16"):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.data.default_configs import default_sft_config

    transformer = dict(GPT2_PATHS, vocab_size=STOP_VOCAB, attention_impl=attention_impl,
                       kv_cache_quant=kv_cache_quant)
    config = default_sft_config().to_dict()
    config["train"].update(batch_size=TRAIN_BATCH, total_steps=RFT_STEPS, eval_interval=10_000,
                           checkpoint_interval=10_000, seq_length=TRAIN_LEN, epochs=10_000, tracker=None,
                           trainer="TPURFTTrainer", compute_dtype=compute_dtype, seed=seed, **ckpt_kw())
    config["model"].update(model_path="random", num_layers_unfrozen=-1,
                           model_extra_configs={"transformer": transformer})
    config["tokenizer"].update(tokenizer_path="byte")
    config["method"] = dict(name="rftconfig", n_generations_per_prompt=RFT_GENERATIONS,
                            n_improve_steps=RFT_IMPROVE_STEPS, start_percentile=0.7, end_percentile=0.95,
                            gen_kwargs=dict(max_new_tokens=TRAIN_NEW_TOKENS, top_k=0, top_p=1.0, do_sample=True))
    return TRLConfig.from_dict(config)


def host_selection(per_prompt: dict, percentile: float) -> int:
    """The number of distinct (prompt, output) pairs a selection keeps,
    recomputed here from the scores: per prompt, the `percentile`
    quantile, raised to 1e-3 over the minimum and capped at the maximum."""
    import numpy as np

    kept = set()
    for prompt, rows in per_prompt.items():
        scores = [s for _, s in rows]
        thr = min(max(float(np.quantile(np.asarray(scores), percentile)), min(scores) + 1e-3), max(scores))
        kept.update((prompt, o) for o, s in rows if s >= thr)
    return len(kept)


def rft_path(seed: int, shapes: dict):
    """`trlx_tpu_torch.train(reward_fn=..., prompts=...)` with
    train.trainer TPURFTTrainer at GPT-2-small widths over the byte
    vocabulary: 16 prompts x 4 sampled generations every 2 epochs, scored,
    thresholded per prompt, deduplicated and wrap-padded into batches of 32
    (full-sequence LM loss), 8 optimizer steps, evaluations at each end.
    Gates: the exact launch counts of kernels 1, 8 and 2+3, finite losses,
    every tensor moved, and each selection's size equal to the one
    recomputed here from the printed scores; then the gradient gate on
    eight batches of 32 through the RFT loss."""
    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch.ops.common import logprobs_of_labels
    from trlx_tpu_torch.pipeline.offline_pipeline import DialogStore, tokenize_dialogue
    from trlx_tpu_torch.trainer.rft import TPURFTTrainer

    rounds = []
    make_experience = TPURFTTrainer.make_experience

    def spy(self, *args, **kwargs):
        make_experience(self, *args, **kwargs)
        method = self.config.method
        delta = (method.end_percentile - method.start_percentile) / method.n_improve_steps
        percentile = method.start_percentile + delta * (self.epoch_count % method.n_improve_steps)
        logged = self.stats_history[-1][1]["len_samples_selected"]
        pool = {p: [(x["output"], x["score"]) for x in xs] for p, xs in self.generations_per_prompt.items()}
        rounds.append({"epoch": self.epoch_count, "percentile": percentile, "selected": int(logged),
                       "host_selected": host_selection(pool, percentile), "store_rows": len(self.store),
                       "scores": {p: [s for _, s in rows] for p, rows in pool.items()}})

    counters = train_counters()
    for fn in counters.values():
        fn.launches = 0
    TPURFTTrainer.make_experience = spy
    try:
        t0 = time.perf_counter()
        with forward_shapes(shapes, "rft"), sampler_calls() as calls:
            trainer = trlx_tpu_torch.train(reward_fn=train_reward_fn, prompts=RFT_PROMPTS, config=rft_config(seed))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        TPURFTTrainer.make_experience = make_experience
    launches = {name: fn.launches for name, fn in counters.items()}
    L = trainer.model.cfg.n_layer
    decode_steps = [c["decode_steps"] for c in calls]
    n_fwd, n_decode = L * (RFT_STEPS + len(calls)), L * sum(decode_steps)
    expect = {"flash_fwd": n_fwd, "flash_fwd_short": n_fwd, "flash_fwd_long": 0,
              "flash_bwd": L * RFT_STEPS, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
              "decode": n_decode, "decode_short": n_decode, "decode_long": 0}
    losses = [st["losses/loss"] for _, st in trainer.stats_history if "losses/loss" in st]
    sampling_rounds = sum(1 for r in rounds if r["epoch"] % RFT_IMPROVE_STEPS == 0)
    emit("rft_path", wall_s=wall, launches=launches, expected=expect, iter_count=trainer.iter_count,
         sampler_calls=len(calls), decode_steps=decode_steps, losses=losses, rounds=rounds,
         phase_seconds=dict(trainer.phase_seconds))
    if len(losses) != RFT_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"expected {RFT_STEPS} finite losses, got {losses}")
    if len(calls) != 2 + RFT_GENERATIONS * sampling_rounds or sampling_rounds < 2:
        raise AssertionError(f"{len(calls)} sampler calls for {sampling_rounds} sampling rounds")
    if {k: launches[k] for k in expect} != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    if any(r["selected"] != r["host_selected"] or r["store_rows"] % TRAIN_BATCH for r in rounds):
        raise AssertionError(f"a selection differs from the host's recomputation: {rounds}")
    check_params_moved(trainer, seed, "rft_params")

    def step(t, batch):
        loss, _ = t.loss(batch)
        loss.backward()
        b = batch.map(lambda x: x.to(t.device))
        labels = torch.where(b.attention_mask > 0, b.input_ids, -100)[:, 1:]
        real = labels != -100
        with torch.no_grad():
            logits = t.model(b.input_ids, b.attention_mask)["logits"]
            lp = logprobs_of_labels(logits[:, :-1], torch.where(real, labels, 0))
        return loss, (lp.float(),), real

    dialogs = [tokenize_dialogue(list(p), trainer.tokenizer, TRAIN_LEN) for p in sft_reference_samples(seed)]
    store = DialogStore(dialogs, trainer.tokenizer, max_length=TRAIN_LEN)
    grad_reference(trainer, {"plain_bf16": rft_config(seed, attention_impl="xla", kv_cache_quant="int8"),
                             "fp32": rft_config(seed, attention_impl="xla", kv_cache_quant=None,
                                                compute_dtype="float32")},
                   list(store.create_loader(TRAIN_BATCH, shuffle=True, seed=seed)), step, ("logprobs",),
                   "rft_reference", reward_fn=train_reward_fn)
    del trainer
    torch.cuda.empty_cache()
    return launches


def randomwalks_offline(which: str) -> None:
    """The port's randomwalks ILQL or RFT runner on the card with the JAX
    example's config (RFT after its behaviour cloning). Gate: the last
    evaluation's optimality (ILQL: at beta 100) at least the JAX curve's
    floor in tests/test_curves.py."""
    import tempfile

    import torch

    from trlx_tpu_torch.examples import ilql_randomwalks, rft_randomwalks
    from trlx_tpu_torch.examples.curves import curve_rows

    runner, key, floor = {
        "ilql": (ilql_randomwalks, "metrics/optimality@beta=100", RANDOMWALKS_ILQL_FLOOR),
        "rft": (rft_randomwalks, "metrics/optimality", RANDOMWALKS_RFT_FLOOR),
    }[which]
    with tempfile.TemporaryDirectory() as directory:
        t0 = time.perf_counter()
        trainer = runner.main({"train.checkpoint_dir": directory})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    curve = [(step, st[key]) for step, st in trainer.stats_history if key in st]
    final = round(curve[-1][1], 4)  # the curves' recorded precision
    emit(f"randomwalks_{which}", wall_s=wall, steps=trainer.iter_count, final_key=key, final=final, floor=floor,
         phase_seconds=dict(trainer.phase_seconds),
         rows=curve_rows(trainer.stats_history, ["metrics/optimality", "losses/loss", "len_samples_selected"]))
    if final < floor:
        raise AssertionError(f"randomwalks {which} final {key} {final} < {floor}")
    train_step_profile(trainer, next(iter(trainer.store.create_loader(trainer.config.train.batch_size))),
                       f"randomwalks_{which}_step")


def ilql_phases(seed: int, shapes: dict, bias_shapes: dict) -> dict:
    """ilql_path and its reference, ilql_t5_path and its reference, the
    randomwalks ILQL runner: {path: launches}."""
    import torch

    trainer, launches = ilql_path(seed, shapes)
    ilql_reference(trainer, seed)
    del trainer
    torch.cuda.empty_cache()
    t5 = ilql_t5_path(seed, shapes, bias_shapes)
    randomwalks_offline("ilql")
    return {"ilql": launches, "ilql_t5": t5}


def rft_phases(seed: int, shapes: dict) -> dict:
    """rft_path (its gradient gate included) and the randomwalks RFT
    runner: {path: launches}."""
    launches = rft_path(seed, shapes)
    randomwalks_offline("rft")
    return {"rft": launches}


# grpo_path: GPT-2-small widths over the byte vocabulary (the reward reads
# the decoded strings, and the byte tokenizer drops every id >= 256), 32
# distinct prompts; a chunk is 8 prompts x group_size 8 = 64 sampled rows
# of 32 + 32 tokens, one chunk a cycle, 4 GRPO epochs of batch 32, two
# cycles = 16 optimizer steps (grpo_engine_path: one cycle)
GRPO_PROMPTS = [f"{TRAIN_PROMPTS[i % 8]} [{i}]" for i in range(32)]
GRPO_GROUP, GRPO_CHUNK_PROMPTS, GRPO_EPOCHS = 8, 8, 4
GRPO_ROLLOUTS = GRPO_GROUP * GRPO_CHUNK_PROMPTS
GRPO_CYCLE_STEPS = GRPO_EPOCHS * GRPO_ROLLOUTS // TRAIN_BATCH
GRPO_STEPS = 2 * GRPO_CYCLE_STEPS
GRPO_REFERENCE_ROLLOUTS = 256  # 8 minibatches of independent rows for grpo_reference
# the share of groups whose rewards are all equal (zero advantage), at most
GRPO_DEGENERATE_MAX = 0.5
# dpo_path: GPT-2 small at full width, 64 distinct seeded pairs of a varied
# prompt, a run of one letter (chosen) and a run of another (rejected),
# right-padded to 64, batch 32 (64 stacked rows a forward), beta 0.5, 16
# steps at lr 1e-6 (at 1e-4 the first step alone moved every margin to ~190
# and the loss to 0.0 in fp32), one sampled evaluation of 32 prompts x 32
# tokens at each end; dpo_reference on 256 such pairs
DPO_PAIRS, DPO_REFERENCE_PAIRS, DPO_STEPS, DPO_BETA, DPO_LR = 64, 256, 16, 0.5, 1e-6
DPO_ACCURACY_MIN = 0.9


def grpo_reward_fn(record: list = None):
    """A reward that varies within a group: a quarter of the number of
    distinct lowercase letters in the output (at most 6.5, inside the
    reward clip). Every call's scores are appended to `record`."""

    def reward(samples, prompts, outputs, **kw):
        scores = [0.25 * len({c for c in o if "a" <= c <= "z"}) for o in outputs]
        if record is not None:
            record.append(scores)
        return scores

    return reward


def grpo_config(seed: int, attention_impl="pallas", kv_cache_quant="int8_kernel", compute_dtype="bfloat16", **method):
    from trlx_tpu_torch.data.default_configs import default_grpo_config

    transformer = dict(GPT2_PATHS, vocab_size=STOP_VOCAB, attention_impl=attention_impl, kv_cache_quant=kv_cache_quant)
    return default_grpo_config().evolve(
        train=dict(batch_size=TRAIN_BATCH, total_steps=GRPO_STEPS, eval_interval=10_000,
                   checkpoint_interval=10_000, seq_length=TRAIN_LEN, epochs=10_000, tracker=None,
                   compute_dtype=compute_dtype, seed=seed, **ckpt_kw()),
        model=dict(model_path="random", num_layers_unfrozen=-1, model_extra_configs={"transformer": transformer}),
        tokenizer=dict(tokenizer_path="byte"),
        method=dict(dict(num_rollouts=GRPO_ROLLOUTS, chunk_size=GRPO_ROLLOUTS, group_size=GRPO_GROUP,
                         grpo_epochs=GRPO_EPOCHS,
                         gen_kwargs=dict(max_new_tokens=TRAIN_NEW_TOKENS, top_k=0, top_p=1.0, do_sample=True)),
                    **method),
    )


def host_group_advantages(scores) -> "np.ndarray":
    """The group z-scores recomputed here in float64: (r - mean) / (std +
    1e-6) with the population std, exactly 0 for a group whose std <= 1e-6."""
    import numpy as np

    g = np.asarray(scores, np.float64).reshape(-1, GRPO_GROUP)
    centered = g - g.mean(axis=1, keepdims=True)
    std = np.sqrt((centered ** 2).mean(axis=1, keepdims=True))
    return np.where(std > 1e-6, centered / (std + 1e-6), 0.0).reshape(-1)


def check_grpo_store(history, scores, phase: str) -> dict:
    """The stored advantages against `host_group_advantages` of the chunk's
    recorded scores (atol 1e-6, degenerate groups exactly 0), and each
    group's rows one prompt. Returns the groups' figures."""
    import numpy as np

    want = host_group_advantages(scores)
    got = history.advantages.double().cpu().numpy()
    degenerate = np.asarray(scores, np.float64).reshape(-1, GRPO_GROUP).std(axis=1) <= 1e-6
    q = history.query_tensors.cpu().numpy().reshape(-1, GRPO_GROUP, history.query_tensors.shape[1])
    figures = dict(rows=len(got), max_abs_err=float(np.abs(got - want).max()), groups=len(degenerate),
                   degenerate_groups=int(degenerate.sum()), degenerate_share=float(degenerate.mean()),
                   group_reward_std_mean=float(np.asarray(scores).reshape(-1, GRPO_GROUP).std(axis=1).mean()))
    emit(phase, **figures)
    if not np.allclose(got, want, rtol=0, atol=1e-6):
        raise AssertionError(f"stored advantages differ from the host's z-scores by {figures['max_abs_err']}")
    if np.any(got.reshape(-1, GRPO_GROUP)[degenerate] != 0):
        raise AssertionError("a degenerate group's advantages are not exactly 0")
    if not (q == q[:, :1]).all():
        raise AssertionError("a group's rows do not share one prompt")
    if figures["degenerate_share"] >= GRPO_DEGENERATE_MAX:
        raise AssertionError(f"{figures['degenerate_share']:.2%} of the groups are degenerate "
                             f"(>= {GRPO_DEGENERATE_MAX:.0%}): the reward does not vary within a group")
    return figures


def grpo_response_logprobs(model, batch, pad: int):
    """The policy's logprobs of a GRPO batch's response tokens, as its loss
    computes them (no graph)."""
    import torch

    from trlx_tpu_torch.ops.common import logprobs_of_labels

    P, N = batch.query_tensors.shape[1], batch.response_tensors.shape[1]
    tokens = torch.cat([batch.query_tensors, batch.response_tensors], dim=1)
    mask = (tokens != pad).to(torch.int32)
    mask[:, P:] = torch.maximum(mask[:, P:], batch.response_mask.to(torch.int32))
    with torch.no_grad():
        hidden = model(tokens, mask, compute_logits=False)["hidden_states"][:, P - 1:P + N - 1]
        return logprobs_of_labels(model.logit_project_fn()(hidden), tokens[:, P:])


def learning_signal(model, batch, pad: int) -> float:
    """sum over rows of advantage x (new - stored response logprob sum):
    positive when the steps moved the policy toward the rows its group
    ranked above their mean."""
    new = grpo_response_logprobs(model, batch, pad)
    mask = batch.response_mask.float()
    return (batch.advantages.double() * ((new - batch.logprobs) * mask).sum(dim=1).double()).sum().item()


def grpo_experience_cost(trainer, batch, seed: int) -> None:
    """One GRPO experience pass (the policy and the full reference copy
    over 64 rollouts) against PPO's hydra pass at the same widths and rows
    (`forward_train` with the frozen top two blocks and the value head):
    wall time, device time and idle share of each."""
    import torch

    from trlx_tpu_torch.models.wrappers import CausalLMWithValueHead

    pad = trainer.generate_settings.pad_token_id
    P = batch.query_tensors.shape[1]
    tokens = torch.cat([batch.query_tensors, batch.response_tensors], dim=1)
    mask = (tokens != pad).to(torch.int32)
    mask[:, P:] = torch.maximum(mask[:, P:], batch.response_mask.to(torch.int32))
    cfg = trainer.model.cfg
    hydra = CausalLMWithValueHead(cfg, branch_at=cfg.n_layer - KNOBS_UNFROZEN, device="cuda").init_params(
        torch.Generator().manual_seed(seed))
    branch = hydra.make_ref_params()
    out = {}
    for name, fn in (("grpo_experience", lambda: trainer.experience_forward(tokens, mask, batch.response_mask)),
                     ("ppo_hydra_experience", lambda: hydra.forward_train(branch, tokens, mask, compute_logits=True)),
                     ("policy_forward_only", lambda: trainer.model(tokens, mask, compute_logits=True))):
        with torch.no_grad():
            wall = timed(fn)[0]
            out[name] = {"wall_ms": wall * 1e3, "device_ms": profile_phase(name, fn, wall)}
    emit("grpo_experience_cost", rows=tokens.shape[0], seq=tokens.shape[1], vocab=cfg.vocab_size, **out,
         full_reference_over_hydra_device=out["grpo_experience"]["device_ms"] / out["ppo_hydra_experience"]["device_ms"])
    del hydra, branch


def grpo_path(seed: int, shapes: dict):
    """`trlx_tpu_torch.train(reward_fn=..., prompts=...)` with
    train.trainer TPUGRPOTrainer at GPT-2-small widths over the byte
    vocabulary (random weights from the seed, bf16 compute / fp32 params,
    a full frozen reference copy, the flash and int8 decode kernels):
    evaluate, two cycles of one 64-row chunk (8 prompts x 8), 16 optimizer
    steps, evaluate. Gates: train_path's exact launch counts (two forwards
    an experience chunk: the policy and the reference); each chunk's
    prompts the next 8 of the stream's order, each tiled 8 times; the
    stored advantages equal to the host's z-scores of the recorded scores;
    finite losses; every tensor moved and the reference bit for bit the
    initial policy (its checksum too); the first cycle's advantage-weighted
    logprob change after that cycle's steps > 0. Then the experience
    pass's cost against PPO's hydra pass, and one train step's profile."""
    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch.models.wrappers import CausalLM
    from trlx_tpu_torch.pipeline import epoch_shuffle_order
    from trlx_tpu_torch.trainer.grpo import TPUGRPOTrainer

    record, chunks, snap = [], [], {}
    next_batch, post_epoch = TPUGRPOTrainer._next_prompt_batch, TPUGRPOTrainer.post_epoch_callback

    def batch_spy(self):
        batch = next_batch(self)
        chunks.append((self._prompt_batches_consumed, batch.input_ids.clone()))
        return batch

    def epoch_spy(self):
        if not snap:  # the first cycle's store and the weights its steps left
            snap["store"] = self.store.history.map(lambda x: x.clone())
            snap["state"] = {k: v.clone() for k, v in self.model.base.state_dict().items()}
        return post_epoch(self)

    counters = train_counters()
    for fn in counters.values():
        fn.launches = 0
    TPUGRPOTrainer._next_prompt_batch, TPUGRPOTrainer.post_epoch_callback = batch_spy, epoch_spy
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start_bytes = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with forward_shapes(shapes, "grpo"), sampler_calls() as calls:
            trainer = trlx_tpu_torch.train(reward_fn=grpo_reward_fn(record), prompts=GRPO_PROMPTS,
                                           config=grpo_config(seed))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - start_bytes
    finally:
        TPUGRPOTrainer._next_prompt_batch, TPUGRPOTrainer.post_epoch_callback = next_batch, post_epoch
    launches = {name: fn.launches for name, fn in counters.items()}
    L = trainer.model.cfg.n_layer
    decode_steps = [c["decode_steps"] for c in calls]
    expect = train_path_launches(L, 2, decode_steps, GRPO_STEPS)
    losses = [st["losses/total_loss"] for _, st in trainer.stats_history if "losses/total_loss" in st]
    grpo_stats = [{k: st[k] for k in ("grpo/group_reward_std", "grpo/zero_adv_groups", "rollout_scores/mean",
                                      "policy/sqrt_kl")} for _, st in trainer.stats_history if "grpo/zero_adv_groups" in st]
    rollout_scores = [s for s in record if len(s) == GRPO_ROLLOUTS]
    tok = trainer.tokenizer
    order = epoch_shuffle_order(len(GRPO_PROMPTS), trainer.config.train.seed)
    prompts_ok = []
    for i, (cursor, ids) in enumerate(chunks):
        texts = tok.batch_decode(ids.tolist())
        want = [GRPO_PROMPTS[j] for j in order[GRPO_CHUNK_PROMPTS * i:GRPO_CHUNK_PROMPTS * (i + 1)]]
        prompts_ok.append(cursor == i + 1 and texts == [p for p in want for _ in range(GRPO_GROUP)])
    emit("grpo_path", wall_s=wall, launches=launches, expected=expect, iter_count=trainer.iter_count,
         sampler_calls=len(calls), decode_steps=decode_steps, losses=losses, grpo_stats=grpo_stats,
         chunks=len(chunks), chunk_prompts_in_stream_order=prompts_ok, cycle_seconds=cycle_split(trainer),
         peak_memory_above_start_bytes=peak, lr=trainer.config.optimizer.kwargs["lr"])
    if len(losses) != GRPO_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"expected {GRPO_STEPS} finite losses, got {losses}")
    if len(calls) != 4 or {k: launches[k] for k in expect} != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect} ({len(calls)} sampler calls)")
    if len(chunks) != 2 or not all(prompts_ok):
        raise AssertionError(f"the chunks' prompts are not the stream's next 8, each tiled 8 times: {prompts_ok}")
    if len(rollout_scores) != 2:
        raise AssertionError(f"expected 2 rollout reward calls of {GRPO_ROLLOUTS} rows, got {len(rollout_scores)}")
    check_grpo_store(snap["store"], rollout_scores[0], "grpo_store_cycle_1")
    check_grpo_store(trainer.store.history, rollout_scores[1], "grpo_store_cycle_2")
    check_params_moved(trainer, seed, "grpo_params")
    fresh = CausalLM(trainer.model.cfg, device="cuda").init_params(torch.Generator().manual_seed(seed))
    checksums = {"reference": weights_checksum(trainer.ref_params), "initial_policy": weights_checksum(fresh.base),
                 "policy": weights_checksum(trainer.model.base)}
    after_cycle_1 = CausalLM(trainer.model.cfg, device="cuda")
    after_cycle_1.base.load_state_dict(snap.pop("state"))
    pad = trainer.generate_settings.pad_token_id
    signal = {"cycle_1": learning_signal(after_cycle_1, snap["store"], pad),
              "cycle_2": learning_signal(trainer.model, trainer.store.history, pad)}
    emit("grpo_learning_signal", weights_checksum=checksums, advantage_weighted_logprob_change=signal)
    del fresh, after_cycle_1
    if checksums["reference"] != checksums["initial_policy"]:
        raise AssertionError(f"the reference's checksum moved: {checksums}")
    if not signal["cycle_1"] > 0:
        raise AssertionError(f"the first cycle's advantage-weighted logprob change is {signal['cycle_1']} <= 0")

    batch = trainer.store[torch.arange(GRPO_ROLLOUTS, device="cuda")]
    grpo_experience_cost(trainer, batch, seed)
    train_step_profile(trainer, trainer.store[torch.arange(TRAIN_BATCH, device="cuda")], "grpo_train_step")
    return trainer, launches


def engine_schedule(lengths: list, slots: int) -> tuple:
    """(refill events, decode steps) of the engine's lane schedule without
    speculative decoding, replayed on the host from each queued row's
    response length: while a lane is free and rows are queued, one refill
    event prefills the next rows into every free lane (its first token
    comes from the prefill); each decode step gives every live lane one
    token; a lane frees when its row has all its tokens. A row of one token
    never takes a decode step."""
    left = [0] * slots  # decode steps each lane still owes its row
    queued, refills, steps = list(lengths), 0, 0
    while True:
        active, free = any(left), [i for i, n in enumerate(left) if n == 0]
        if not active and not (free and queued):
            return refills, steps
        if free and queued:
            refills += 1
            for i in free[:len(queued)]:
                left[i] = queued.pop(0) - 1
            if not active and not any(left):
                continue
        left = [max(n - 1, 0) for n in left]
        steps += 1


def grpo_engine_path(seed: int, shapes: dict) -> dict:
    """grpo_path's workload for one cycle (8 steps) with rollouts and
    evaluations through the decode engine: 32 slots, 16-token int8 pages,
    the paged kernel, no speculative decoding. Gates: each engine call's
    prefills (counted by the temporary caches they make) and decode steps
    equal `engine_schedule`'s replay of its lane schedule from the rows'
    response lengths; the paged launches == n_layer x the decode steps,
    all on the short route; the flash forward's == n_layer x (the
    prefills + the chunk's two experience forwards + the steps), the
    backward's == n_layer x the steps, no int8 decode launch; the stored
    advantages against the host's z-scores; finite losses. Then the
    engine's real tokens/s and its idle share on one rollout chunk."""
    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch.models.transformer import TransformerLM
    from trlx_tpu_torch.trainer.base import TPUBaseTrainer

    record, engine_calls, prefills, schedule = [], [], [], []
    engine_generate, init_cache = TPUBaseTrainer._engine_generate, TransformerLM.init_cache

    def counted(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = len(prefills)
        out = engine_generate(self, *args, **kwargs)
        torch.cuda.synchronize()
        engine_calls.append((time.perf_counter() - t0, out["gen_stats"]))
        lengths = out["response_mask"].sum(dim=1).tolist()
        schedule.append({"prefills": len(prefills) - n, "decode_steps": out["gen_stats"]["decode_steps"],
                         "replayed": engine_schedule(lengths, min(ENGINE_TRAIN["slots"], len(lengths)))})
        return out

    def cache_spy(self, *args, **kwargs):  # one temporary cache a prefill
        prefills.append(args[0])
        return init_cache(self, *args, **kwargs)

    counters = {**train_counters(), **paged_counters()}
    for fn in counters.values():
        fn.launches = 0
    config = grpo_config(seed, gen_engine=dict(ENGINE_TRAIN, spec_decode=False)).evolve(
        train=dict(total_steps=GRPO_CYCLE_STEPS))
    TPUBaseTrainer._engine_generate, TransformerLM.init_cache = counted, cache_spy
    try:
        t0 = time.perf_counter()
        with forward_shapes(shapes, "grpo_engine"):
            trainer = trlx_tpu_torch.train(reward_fn=grpo_reward_fn(record), prompts=GRPO_PROMPTS, config=config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        TPUBaseTrainer._engine_generate, TransformerLM.init_cache = engine_generate, init_cache
    launches = {name: fn.launches for name, fn in counters.items()}
    L = trainer.model.cfg.n_layer
    steps = sum(g["decode_steps"] for _, g in engine_calls)
    n_fwd = L * (len(prefills) + 2 + GRPO_CYCLE_STEPS)
    expect = {"flash_fwd": n_fwd, "flash_fwd_short": n_fwd, "flash_fwd_long": 0,
              "flash_bwd": L * GRPO_CYCLE_STEPS, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
              "decode": 0, "decode_short": 0, "decode_long": 0,
              "paged": L * steps, "paged_short": L * steps, "paged_long": 0}
    losses = [st["losses/total_loss"] for _, st in trainer.stats_history if "losses/total_loss" in st]
    tokens_per_s = [g["real_tokens"] / s for s, g in engine_calls]
    emit("grpo_engine_path", wall_s=wall, launches=launches, expected=expect, iter_count=trainer.iter_count,
         engine_calls=len(engine_calls), prefills=len(prefills), decode_steps=steps, schedule=schedule, losses=losses,
         engine_seconds=[s for s, _ in engine_calls], engine_real_tokens=[g["real_tokens"] for _, g in engine_calls],
         engine_real_tokens_per_s=tokens_per_s, cycle_seconds=cycle_split(trainer),
         oom_truncated=sum(g["oom_truncated"] for _, g in engine_calls),
         unserved=sum(g["unserved"] for _, g in engine_calls))
    if len(losses) != GRPO_CYCLE_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"expected {GRPO_CYCLE_STEPS} finite losses, got {losses}")
    if len(engine_calls) != 3 or {k: launches[k] for k in expect} != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect} ({len(engine_calls)} engine calls)")
    if any((c["prefills"], c["decode_steps"]) != tuple(c["replayed"]) for c in schedule):
        raise AssertionError(f"the engine's prefills and decode steps differ from its lane schedule's: {schedule}")
    if any(g["oom_truncated"] or g["unserved"] for _, g in engine_calls):
        raise AssertionError("the engine's page pool ran out")
    rollout_scores = [s for s in record if len(s) == GRPO_ROLLOUTS]
    check_grpo_store(trainer.store.history, rollout_scores[-1], "grpo_engine_store")

    # the engine alone on one rollout chunk: real tokens/s and idle share
    batch = trainer._next_prompt_batch()
    ids, mask = batch.input_ids.cuda(), batch.attention_mask.cuda()
    real = []

    def rollout():
        real.append(trainer.generate(ids, mask)["gen_stats"]["real_tokens"])

    wall_chunk = timed(rollout, reps=2)[0]
    busy = profile_phase("grpo_engine_rollout", rollout, wall_chunk, host_ops=False)
    emit("grpo_engine_rollout", wall_ms=wall_chunk * 1e3, real_tokens=real[-1],
         real_tokens_per_s=real[-1] / wall_chunk, device_busy_ms=busy, device_idle_share=1 - busy / (wall_chunk * 1e3))
    del trainer
    torch.cuda.empty_cache()
    return launches


def grpo_reference(trainer, seed: int) -> None:
    """`grad_reference` over the GRPO loss: a fresh store of
    GRPO_REFERENCE_ROLLOUTS rollouts from the trained policy (its
    advantages from its own groups' scores), cut by two shuffles into
    minibatches of 32, one step three ways (the kernel path, the plain bf16
    and fp32 paths). Outputs: the response tokens' logprobs and the loss's
    two terms (`policy_loss`, `kl_loss`)."""
    import torch

    trainer.store.clear_history()
    trainer.make_experience(GRPO_REFERENCE_ROLLOUTS, trainer.iter_count)
    pad = trainer.generate_settings.pad_token_id

    def step(t, batch):
        loss, stats = t.loss(batch)
        loss.backward()
        real = batch.response_mask.bool()
        lp = grpo_response_logprobs(t.model, batch, pad)
        terms = [stats[k].detach().float().expand(real.shape) for k in ("losses/policy_loss", "losses/kl_loss")]
        return loss, (lp.float(), *terms), real

    batches = [b for s in (seed, seed + 1)
               for b in trainer.store.create_loader(TRAIN_BATCH, shuffle=True, drop_last=True, seed=s)]
    grad_reference(trainer, {"plain_bf16": grpo_config(seed, attention_impl="xla", kv_cache_quant="int8"),
                             "fp32": grpo_config(seed, attention_impl="xla", kv_cache_quant=None,
                                                 compute_dtype="float32")},
                   batches, step, ("logprobs", "policy_loss", "kl_loss"), "grpo_reference",
                   reward_fn=grpo_reward_fn())


def dpo_pairs(seed: int, n: int, flip_share: float = 0.0) -> list:
    """`n` distinct (prompt, chosen, rejected) byte triples, separable as
    tests/test_dpo.py's set: a varied prompt, then a run of one letter
    (chosen) or of another (rejected), 16-48 long (cut at 64 tokens). A
    `flip_share` of the pairs (drawn from the seed) swap the two."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pairs = []
    for i in range(n):
        words = " ".join(rng.choice(SFT_WORDS, size=rng.integers(1, 4)))
        prompt = f"{TRAIN_PROMPTS[i % 8]} {words} ({i}):"
        chosen, rejected = " " + "a" * int(rng.integers(16, 49)), " " + "z" * int(rng.integers(16, 49))
        pairs.append((prompt, rejected, chosen) if rng.random() < flip_share else (prompt, chosen, rejected))
    return pairs


def dpo_config(seed: int, attention_impl="pallas", kv_cache_quant="int8_kernel", compute_dtype="bfloat16"):
    from trlx_tpu_torch.data.default_configs import default_dpo_config

    transformer = dict(GPT2_PATHS, attention_impl=attention_impl, kv_cache_quant=kv_cache_quant)
    return default_dpo_config().evolve(
        train=dict(batch_size=TRAIN_BATCH, total_steps=DPO_STEPS, eval_interval=10_000,
                   checkpoint_interval=10_000, seq_length=TRAIN_LEN, epochs=10_000, tracker=None,
                   compute_dtype=compute_dtype, seed=seed, **ckpt_kw()),
        model=dict(model_path="random", num_layers_unfrozen=-1, model_extra_configs={"transformer": transformer}),
        tokenizer=dict(tokenizer_path="byte"),
        optimizer=dict(kwargs=dict(lr=DPO_LR)),
        scheduler=dict(kwargs=dict(eta_min=DPO_LR)),
        method=dict(beta=DPO_BETA, gen_kwargs=dict(max_new_tokens=TRAIN_NEW_TOKENS, top_k=0, top_p=1.0,
                                                    do_sample=True)),
    )


def dpo_path(seed: int, shapes: dict):
    """`trlx_tpu_torch.train(samples=[(prompt, chosen, rejected), ...])`
    with train.trainer TPUDPOTrainer at GPT-2-small width (vocab 50257,
    random weights from the seed, bf16 compute / fp32 params, a full frozen
    reference copy): a sampled evaluation of 32 prompts x 32 tokens, 16
    steps of 32 pairs (each one stacked policy forward of 64 rows and one
    reference forward of the same rows), the evaluation again. Gates, the
    JAX package's DPO acceptance on the card: the last logged accuracy >
    0.9 and the last margin above the first; the reference bit for bit the
    initial policy; every tensor moved; the exact launch counts. Then one
    step's time, profile and peak memory."""
    import torch

    import trlx_tpu_torch

    pairs = dpo_pairs(seed, DPO_PAIRS)
    counters = train_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with forward_shapes(shapes, "dpo"), sampler_calls() as calls:
        trainer = trlx_tpu_torch.train(samples=pairs, eval_prompts=[p for p, _, _ in pairs[:TRAIN_BATCH]],
                                       config=dpo_config(seed))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    L = trainer.model.cfg.n_layer
    decode_steps = [c["decode_steps"] for c in calls]
    # each sampler call prefills through the forward kernel; each step runs
    # the stacked policy forward and the reference forward (64 rows, T = S =
    # 64: the short route) and one fused backward
    n_fwd, n_decode = L * (len(calls) + 2 * DPO_STEPS), L * sum(decode_steps)
    expect = {"flash_fwd": n_fwd, "flash_fwd_short": n_fwd, "flash_fwd_long": 0,
              "flash_bwd": L * DPO_STEPS, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
              "decode": n_decode, "decode_short": n_decode, "decode_long": 0}
    stream = {k: [st[k] for _, st in trainer.stats_history if k in st]
              for k in ("losses/total_loss", "dpo/accuracy", "dpo/margin", "dpo/chosen_reward",
                        "dpo/rejected_reward")}
    emit("dpo_path", wall_s=wall, launches=launches, expected=expect, iter_count=trainer.iter_count,
         sampler_calls=len(calls), decode_steps=decode_steps, store_rows=len(trainer.store),
         seq_width=trainer.store.seq_width, lr=DPO_LR, beta=DPO_BETA, phase_seconds=dict(trainer.phase_seconds),
         **{k.replace("/", "_"): v for k, v in stream.items()})
    losses, accs, margins = stream["losses/total_loss"], stream["dpo/accuracy"], stream["dpo/margin"]
    if len(losses) != DPO_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"expected {DPO_STEPS} finite losses, got {losses}")
    if len(calls) != 2 or {k: launches[k] for k in expect} != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect} ({len(calls)} sampler calls)")
    if trainer.store.seq_width != TRAIN_LEN:
        raise AssertionError(f"the pairs' width is {trainer.store.seq_width}, not {TRAIN_LEN}")
    if not accs[-1] > DPO_ACCURACY_MIN or not margins[-1] > margins[0]:
        raise AssertionError(f"DPO did not separate the pairs: accuracy {accs}, margin {margins}")
    check_params_moved(trainer, seed, "dpo_params")

    batch = next(iter(trainer.store.create_loader(TRAIN_BATCH, seed=seed)))
    train_step_profile(trainer, batch, "dpo_train_step")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    rows, T, V = 2 * TRAIN_BATCH, trainer.store.seq_width, trainer.model.cfg.vocab_size
    emit("dpo_train_step_memory", peak_above_start_bytes=torch.cuda.max_memory_allocated() - base,
         logits_bytes_each=rows * (T - 1) * V * 4, logits_shape=[rows, T - 1, V],
         note="fp32 logits of the stacked rows: the policy's (kept for the backward) and the reference's")
    return trainer, launches


def dpo_reference(trainer, seed: int) -> None:
    """`grad_reference` over the DPO loss on DPO_REFERENCE_PAIRS distinct
    pairs (DPO's loss is one number a pair, so one batch's loss error is a
    single draw of rounding noise): 8 batches of 32, one step three ways.
    Half the pairs are swapped: the trained policy ranks dpo_path's order
    so far apart that those pairs' sigmoid is flat, and the swapped ones
    carry the gradient. Outputs: each pair's margin."""
    import torch

    from trlx_tpu_torch.pipeline.dpo_pipeline import DPOPairStorage

    beta = trainer.config.method.beta

    def step(t, batch):
        loss, _ = t.loss(batch)
        loss.backward()
        b = batch.map(lambda x: x.to(t.device))
        with torch.no_grad():
            lp, ref = t.sequence_logprobs(torch.cat([b.chosen_ids, b.rejected_ids]),
                                          torch.cat([b.chosen_attention_mask, b.rejected_attention_mask]),
                                          torch.cat([b.chosen_response_mask, b.rejected_response_mask]))
        n = b.chosen_ids.shape[0]
        margin = beta * ((lp[:n] - ref[:n]) - (lp[n:] - ref[n:]))
        return loss, (margin.float(),), torch.ones_like(margin, dtype=torch.bool)

    store = DPOPairStorage(dpo_pairs(seed + 1, DPO_REFERENCE_PAIRS, flip_share=0.5), trainer.tokenizer,
                           max_length=TRAIN_LEN)
    grad_reference(trainer, {"plain_bf16": dpo_config(seed, attention_impl="xla", kv_cache_quant="int8"),
                             "fp32": dpo_config(seed, attention_impl="xla", kv_cache_quant=None,
                                                compute_dtype="float32")},
                   list(store.create_loader(TRAIN_BATCH, shuffle=True, seed=seed)), step, ("margin",),
                   "dpo_reference")


def grpo_phases(seed: int, shapes: dict) -> dict:
    """grpo_path and its reference, grpo_engine_path: {path: launches}."""
    import torch

    trainer, launches = grpo_path(seed, shapes)
    grpo_reference(trainer, seed)
    del trainer
    torch.cuda.empty_cache()
    return {"grpo": launches, "grpo_engine": grpo_engine_path(seed, shapes)}


def dpo_phases(seed: int, shapes: dict) -> dict:
    """dpo_path and its reference: {path: launches}."""
    import torch

    trainer, launches = dpo_path(seed, shapes)
    dpo_reference(trainer, seed)
    del trainer
    torch.cuda.empty_cache()
    return {"dpo": launches}


# ---------------------------------------------------------------------------
# the Llama family at head width 128
# ---------------------------------------------------------------------------

# Llama-2-7B's published widths (NousResearch/Llama-2-7b-hf config.json, the
# model examples/ppo_sentiments_llama.py trains), cut from 32 layers to 4 so
# that the script keeps its time; random weights from the seed
LLAMA_7B = dict(
    vocab_size=32000, hidden_size=4096, n_layer=4, n_head=32, n_kv_head=32, intermediate_size=11008,
    n_positions=4096, pos_embed="rotary", rotary_style="neox", rope_theta=10000.0, norm="rmsnorm",
    layer_norm_epsilon=1e-5, activation="silu", mlp_gated=True, use_attn_bias=False, use_mlp_bias=False,
    use_norm_bias=False, tie_word_embeddings=False,
)
LLAMA_PUBLISHED_LAYERS = 32
# the HF config.json of that model at the cut depth (what models/hf.py reads)
LLAMA_HF_CONFIG = dict(
    model_type="llama", architectures=["LlamaForCausalLM"], vocab_size=32000, hidden_size=4096,
    num_hidden_layers=LLAMA_7B["n_layer"], num_attention_heads=32, num_key_value_heads=32,
    intermediate_size=11008, max_position_embeddings=4096, rms_norm_eps=1e-5, rope_theta=10000.0,
    tie_word_embeddings=False, hidden_act="silu", torch_dtype="bfloat16",
)
# the example's num_layers_unfrozen; 32 prompts, 32 rollouts a cycle of 32
# new tokens, batch 16, 2 PPO epochs, two cycles = 8 optimizer steps
LLAMA_UNFROZEN = 2
LLAMA_PROMPTS = TRAIN_PROMPTS[:32]
LLAMA_ROLLOUTS, LLAMA_BATCH, LLAMA_EPOCHS = 32, 16, 2
LLAMA_CYCLE_STEPS = LLAMA_EPOCHS * LLAMA_ROLLOUTS // LLAMA_BATCH
LLAMA_STEPS = 2 * LLAMA_CYCLE_STEPS
LLAMA_REFERENCE_ROLLOUTS = 256  # 16 minibatches of 16 independent rows for llama_train_reference
# llama_reference's floor on the per-step greedy agreement (same prefix) of the
# kernel path with the plain bf16 path, as T5_STEP_AGREEMENT: random Llama
# weights give near-tied top logits over 32000 ids (every row distinct, not
# degenerate), so bf16 rounding flips decisions. Measured on the H100 at seed
# 0: 94.0% per step, 39.5% free-running; the plain bf16 and fp32 paths agree
# 22% free-running. The gate beside it holds the kernel path to fp32's
# choices at least as often as the plain bf16 path, within 2 points.
LLAMA_STEP_AGREEMENT = 0.90
LLAMA_ENGINE = dict(enabled=True, slots=32, page_size=16, paged_attention_impl="pallas", spec_decode=True, draft_k=4)

# the kernels' cases at D = 128, held to their plain versions at the D = 64
# bars: the Llama path's shapes, T = S in {64, 128, 129, 512} causal and
# left-padded, a prefill at a q_offset on both routes, and GQA at Llama-3-8B's
# attention (H 32 over Hkv 8) and Llama-2-70B's (H 64 over Hkv 8)
FLASH_D128_CASES = {  # name: (B, H, Hkv, T, S, D, q_offset, pad, causal)
    "llama_prefill": (LLAMA_ROLLOUTS, 32, 32, PROMPT_LEN, 128, 128, 0, "prefill", True),
    "llama_train": (LLAMA_BATCH, 32, 32, TRAIN_LEN, TRAIN_LEN, 128, 0, "left", True),
    "d128_t128": (4, 32, 32, 128, 128, 128, 0, "left", True),
    "d128_t129": (4, 32, 32, 129, 129, 128, 0, "left", True),
    "d128_t512": (2, 32, 32, 512, 512, 128, 0, "left", True),
    "d128_prefill_offset": (4, 8, 8, 37, 128, 128, 5, "prefill", True),
    "d128_prefill_offset_long": (2, 8, 8, 150, 512, 128, 300, "prefill", True),
    "gqa_llama3_8b": (4, 32, 8, TRAIN_LEN, TRAIN_LEN, 128, 0, "left", True),
    "gqa_llama3_8b_t512": (2, 32, 8, 512, 512, 128, 0, "left", True),
    "gqa_llama2_70b": (2, 64, 8, 128, 128, 128, 0, "left", True),
}
BWD_D128_CASES = {  # name: (B, H, Hkv, T, S, q_offset, pad, causal)
    "llama_train": (LLAMA_BATCH, 32, 32, TRAIN_LEN, TRAIN_LEN, 0, "left", True),
    "d128_max_fused": (4, 32, 32, 112, 112, 0, "left", True),  # the fused kernel's largest shape at D = 128
    "d128_t128": (4, 32, 32, 128, 128, 0, "left", True),  # the long route at D = 128
    "d128_t129": (4, 32, 32, 129, 129, 0, "left", True),
    "d128_t512": (2, 32, 32, 512, 512, 0, "left", True),
    "d128_prefill_offset": (4, 8, 8, 37, 128, 5, "prefill", True),
    "gqa_llama3_8b": (4, 32, 8, TRAIN_LEN, TRAIN_LEN, 0, "left", True),
    "gqa_llama3_8b_t512": (2, 32, 8, 512, 512, 0, "left", True),
    "gqa_llama2_70b": (2, 64, 8, TRAIN_LEN, TRAIN_LEN, 0, "left", True),
    "gqa_llama2_70b_t128": (2, 64, 8, 128, 128, 0, "left", True),
}
DECODE_D128_CASES = {  # name: (L, B, H, Hkv, S, written); groups 1, 4 and 8
    "llama_rollout": (LLAMA_7B["n_layer"], LLAMA_ROLLOUTS, 32, 32, 128, TRAIN_LEN),
    "gqa4": (2, 8, 32, 8, 200, 150),
    "gqa8_edge_256": (2, 8, 64, 8, 256, 256),  # with a fully masked row
    "gqa8_long_384": (2, 4, 64, 8, 384, 300),
    "g1_long_384": (2, 8, 32, 32, 384, 300),
}
PAGED_D128_CASES = {  # name: (B, T, H, Hkv, PS, MP, quant, depths, nulls); groups 1 and 8, 8 x 4 = 32 rows
    "llama_decode_int8": (8, 1, 32, 32, 16, 5, "int8", [1, 5, 16, 17, 40, 63, 70, 33], [(3, 1)]),
    "llama_verify_int8": (8, 4, 32, 32, 16, 5, "int8", [1, 5, 16, 17, 40, 60, 70, 33], [(4, 1)]),
    "gqa8_decode_int8_mp16": (4, 1, 64, 8, 16, 16, "int8", [255, 1, 140, 64], [(0, 3)]),
    "gqa8_verify_int8_mp16": (4, 4, 64, 8, 16, 16, "int8", [1, 100, 251, 37], [(2, 7)]),
    "gqa8_verify_bf16_mp16": (4, 4, 64, 8, 16, 16, None, [251, 1, 130, 64], [(0, 6)]),
    "gqa8_verify_bf16_mp17": (4, 4, 64, 8, 16, 17, None, [1, 267, 140, 200], [(2, 4)]),
    "verify_int8_ps128_mp3": (4, 4, 32, 32, 128, 3, "int8", [3, 129, 250, 300], []),
}


def check_d128(gen) -> dict:
    """The four kernels the Llama path runs, at head width 128, against
    their plain versions: FLASH_D128_CASES (kernel 1), BWD_D128_CASES
    (kernels 2 and 3), DECODE_D128_CASES (kernel 8) and PAGED_D128_CASES
    (kernel 7), with the D = 64 checks' bars, route counters and repeat
    gates. Returns each check's worst errors."""
    return {
        "fwd": check_flash(gen, FLASH_D128_CASES, phase="flash_check_d128"),
        "bwd": check_flash_bwd(gen, BWD_D128_CASES, D=128, phase="flash_bwd_check_d128"),
        "decode": check_decode(gen, DECODE_D128_CASES, D=128, phase="decode_check_d128")["by_route"],
        "paged": check_paged(gen, PAGED_D128_CASES, D=128, phase="paged_check_d128")["by_route"],
    }


def llama_hf_dir(seed: int) -> str:
    """A local HF directory of the cut Llama-2-7B (`LLAMA_HF_CONFIG`,
    `pytorch_model.bin` in bf16, as the published checkpoint keeps it),
    written with `models/hf.py`'s export from random weights of the seed,
    under the script's temporary root. Nothing is downloaded."""
    import torch

    from trlx_tpu_torch.models import hf
    from trlx_tpu_torch.models.transformer import TransformerConfig, TransformerLM

    ckpt_dir()  # makes the temporary root
    path = os.path.join(_CKPT_ROOT[0], "llama_hf")
    os.makedirs(path, exist_ok=True)
    cfg = TransformerConfig(**LLAMA_7B)
    with torch.no_grad():
        lm = TransformerLM(cfg, device="cuda").init_params(torch.Generator().manual_seed(seed))
        sd = hf.state_dict_from_params(lm.state_dict(), cfg, "llama")
    del lm
    torch.save({k: v.to(torch.bfloat16) for k, v in sd.items()}, os.path.join(path, hf.WEIGHTS_NAME))
    with open(os.path.join(path, hf.CONFIG_NAME), "w") as f:
        json.dump(LLAMA_HF_CONFIG, f)
    return path


def llama_config(seed: int, hf_dir: str, attention_impl="pallas", kv_cache_quant="int8_kernel",
                 compute_dtype="bfloat16"):
    """PPO on the cut Llama-2-7B loaded from `hf_dir` (model_path, with the
    kernels' runtime keys on top), examples/ppo_sentiments_llama.py's
    num_layers_unfrozen, bf16 compute over fp32 parameters, byte prompts."""
    from trlx_tpu_torch.data.default_configs import default_ppo_config

    return default_ppo_config().evolve(
        train=dict(batch_size=LLAMA_BATCH, total_steps=LLAMA_STEPS, eval_interval=10_000,
                   checkpoint_interval=10_000, seq_length=TRAIN_LEN, epochs=10_000, tracker=None,
                   compute_dtype=compute_dtype, seed=seed, **ckpt_kw()),
        model=dict(model_path=hf_dir, num_layers_unfrozen=LLAMA_UNFROZEN, model_extra_configs={
            "transformer": dict(attention_impl=attention_impl, kv_cache_quant=kv_cache_quant)}),
        tokenizer=dict(tokenizer_path="byte"),
        method=dict(num_rollouts=LLAMA_ROLLOUTS, chunk_size=LLAMA_ROLLOUTS, ppo_epochs=LLAMA_EPOCHS,
                    gen_kwargs=dict(max_new_tokens=TRAIN_NEW_TOKENS, top_k=0, top_p=1.0, do_sample=True)),
    )


def llama_launches(L: int, K: int, cycles: int, steps: int, decode_steps: list) -> dict:
    """The kernels' launches of the Llama `train()` run, every one at D =
    128: each sampler call (a rollout a cycle, an evaluation at each end)
    prefills through the L blocks (the forward's short route: 32 queries
    over a 128-slot cache); each cycle's experience pass runs the L trunk
    blocks and the K blocks of the hydra reference; each train step's
    policy forward runs the L blocks (the short route, T = S = 64; the
    step reads the stored reference logprobs), and its backward runs
    through the K trainable blocks alone (the fused route: T, S <= 112;
    the frozen trunk builds no graph); each decode step of every sampler
    call launches the short int8 decode kernel once a layer (a 128-slot
    cache)."""
    n_fwd = L * (cycles + 2) + cycles * (L + K) + steps * L
    n_decode = L * sum(decode_steps)
    return {"flash_fwd": n_fwd, "flash_fwd_short": n_fwd, "flash_fwd_long": 0,
            "flash_bwd": K * steps, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "decode": n_decode, "decode_short": n_decode, "decode_long": 0}


def llama_path(seed: int, shapes: dict) -> dict:
    """The Llama family at Llama-2-7B's widths (4096 / 32 x 128 / 11008 /
    32000, cut to 4 layers), through the entry points a user calls: an HF
    directory written from the seed's random weights, then
    `trlx_tpu_torch.train(model_path=<that dir>)` (PPO, 32 byte prompts
    left-padded to 32, 32 new tokens, batch 16, 2 epochs, two cycles = 8
    steps, the static sampler, the hydra reference over the top two
    blocks and lm_head). Gates: finite losses, exact launches of kernels 1,
    2/3 and 8 (all at D = 128), the trainable top moved while the frozen
    trunk and the reference did not; then the HF round trip: the run's own
    `hf_model/` export (config.json, pytorch_model.bin) reloaded through
    `model_path` bit for bit, with equal logits; then `llama_reference`,
    `llama_train_reference` and the profiles; then `llama_engine_path`."""
    import glob
    import shutil

    import torch

    from trlx_tpu_torch.models import hf
    from trlx_tpu_torch.utils.loading import get_trainer

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    src = llama_hf_dir(seed)
    write_s = time.perf_counter() - t0
    start = hf.load_pretrained(src)[1]
    config = llama_config(seed, src)
    trainer, wall, launches, decode_steps = counted_train(config, shapes, "llama", prompts=LLAMA_PROMPTS)
    cfg = trainer.model.cfg
    L, K = cfg.n_layer, LLAMA_UNFROZEN
    cycles = LLAMA_STEPS // LLAMA_CYCLE_STEPS
    expect = llama_launches(L, K, cycles, LLAMA_STEPS, decode_steps)
    losses = [st["losses/total_loss"] for _, st in trainer.stats_history if "losses/total_loss" in st]
    emit("llama_path", wall_s=wall, hf_write_s=write_s, peak_device_bytes=torch.cuda.max_memory_allocated(),
         launches=launches, expected=expect, sampler_calls=len(decode_steps), decode_steps=decode_steps,
         losses=losses, cycle_seconds=cycle_split(trainer), model_type=trainer.model_type,
         head_dim=cfg.head_dim, layers=L, published_layers=LLAMA_PUBLISHED_LAYERS,
         parameters=sum(p.numel() for p in trainer.model.base.parameters()),
         trainable=sum(p.numel() for p in trainer.trainable_params))
    if (trainer.model_type, cfg.head_dim, cfg.tie_word_embeddings) != ("llama", 128, False):
        raise AssertionError(f"the HF directory did not load as an untied Llama of head width 128: {cfg}")
    if len(losses) != LLAMA_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"expected {LLAMA_STEPS} finite losses, got {losses}")
    if len(decode_steps) != cycles + 2 or {k: launches[k] for k in expect} != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect} ({len(decode_steps)} sampler calls)")
    check_params_moved(trainer, seed, "llama_params", base_state=start,
                       frozen=("base.embed.",) + tuple(f"base.blocks.{i}." for i in range(L - K)))
    del start

    # the HF round trip: the run's final checkpoint exported the HF layout
    # (save_pretrained of an HF-loaded model); model_path=<that export>
    # reloads the trained base weights bit for bit, and their logits
    exports = glob.glob(os.path.join(trainer.config.train.checkpoint_dir, "checkpoint_*", "hf_model"))
    if len(exports) != 1:
        raise AssertionError(f"expected one final hf_model export, found {exports}")
    export = os.path.join(_CKPT_ROOT[0], "llama_export")
    shutil.rmtree(export, ignore_errors=True)
    shutil.move(exports[0], export)
    files = sorted(os.listdir(export))
    t0 = time.perf_counter()
    reloaded = get_trainer(config.train.trainer)(
        config=config.evolve(model=dict(model_path=export)), reward_fn=train_reward_fn)
    reload_s = time.perf_counter() - t0
    base, again = trainer.model.base.state_dict(), reloaded.model.base.state_dict()
    unequal = [n for n in base if not torch.equal(base[n], again[n])]
    ids = torch.randint(0, 258, (4, TRAIN_LEN), generator=torch.Generator().manual_seed(seed)).cuda()
    with torch.no_grad():
        logits_equal = bool(torch.equal(trainer.model.base(ids)["logits"], reloaded.model.base(ids)["logits"]))
    emit("llama_hf_round_trip", files=files, reload_s=reload_s, tensors=len(base), unequal=unequal,
         logits_equal=logits_equal, reloaded_model_type=reloaded.model_type)
    if not {"config.json", hf.WEIGHTS_NAME}.issubset(files) or "base_weights.pt" in files:
        raise AssertionError(f"save_pretrained of an HF-loaded model must write the HF layout: {files}")
    if unequal or set(base) != set(again) or not logits_equal:
        raise AssertionError(f"the HF export did not reload bit for bit: {unequal}, logits equal {logits_equal}")
    del reloaded, base, again
    shutil.rmtree(export, ignore_errors=True)
    torch.cuda.empty_cache()

    llama_reference(trainer, seed)
    batch = llama_train_reference(trainer, seed, src)["batch"]
    llama_profiles(trainer, batch)
    del trainer, batch
    torch.cuda.empty_cache()
    engine = llama_engine_path(seed, src, shapes)
    shutil.rmtree(src, ignore_errors=True)
    return {"train": launches, "engine": engine}


def llama_reference(trainer, seed: int) -> None:
    """A greedy rollout of the trained Llama policy (32 byte prompts
    left-padded to 32, 32 new tokens, the int8 decode kernel) and one
    experience pass, against the plain bf16 path (attention_impl="xla",
    the folded int8 cache) and the plain fp32 path on the same weights.
    Per step: both plain paths are forced onto the kernel path's tokens
    and each decision is compared on the same prefix; the kernel path
    must agree with plain bf16 on LLAMA_STEP_AGREEMENT of them and pick
    fp32's token at least as often as plain bf16 does, within 2 points.
    Free-running agreement is printed (on these near-tied logits bf16
    rounding alone moves most free-running tokens). Each experience output
    must be at most twice as far from fp32 as plain bf16 (the ratio is
    printed), as `main_path` gates it."""
    import torch

    from trlx_tpu_torch.models.generation import SamplerSettings, generate
    from trlx_tpu_torch.models.wrappers import CausalLMWithValueHead
    from trlx_tpu_torch.utils.tokenizers import ByteTokenizer

    tok = ByteTokenizer()
    ids, mask = (x[:LLAMA_ROLLOUTS] for x in byte_prompts(tok))
    greedy = SamplerSettings(max_new_tokens=TRAIN_NEW_TOKENS, do_sample=False,
                             eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id)
    policy = trainer.model
    state = policy.state_dict()

    def copy(**kw):
        model = CausalLMWithValueHead(policy.cfg.replace(**kw), branch_at=policy.branch_at, device="cuda")
        model.load_state_dict(state)
        return model

    def experience(model, seqs, attn):
        return model.forward_train(model.make_ref_params(), seqs, attn)

    def forced(model):
        """The model's own greedy choice at each step of the kernel path's rows."""
        own = []

        def force(hidden_last, logits_last):
            t = len(own)
            own.append(logits_last.argmax(dim=-1))
            return torch.full_like(logits_last, float("-inf")).scatter_(1, kernel_ids[:, t:t + 1], 0.0)

        generate(model.base, ids, mask, None, greedy, logits_processor=force)
        return torch.stack(own, dim=1)

    with torch.no_grad():
        out_g = generate(policy.base, ids, mask, None, greedy)
        kernel_ids = out_g["response_ids"]
        seqs = out_g["sequences"]
        attn = torch.cat([mask, out_g["response_mask"]], dim=1)
        exp = experience(policy, seqs, attn)
        plain = copy(attention_impl="xla", kv_cache_quant="int8")
        exact = copy(attention_impl="xla", kv_cache_quant=None, dtype=torch.float32)
        out_x = generate(plain.base, ids, mask, None, greedy)
        out_f = generate(exact.base, ids, mask, None, greedy)
        own_x, own_f = forced(plain), forced(exact)
        exp_x, exp_f = experience(plain, seqs, attn), experience(exact, seqs, attn)
    del plain, exact

    def free_running(a, b):
        real = a["response_mask"].bool() & b["response_mask"].bool()
        return (a["response_ids"] == b["response_ids"])[real].float().mean().item()

    n = own_x.shape[1]
    real_steps = out_g["response_mask"].bool()[:, :n]

    def agree(a, b):
        return (a[:, :n] == b[:, :n])[real_steps].float().mean().item()

    step = {"kernel_vs_plain_bf16": agree(own_x, kernel_ids), "kernel_vs_fp32": agree(own_f, kernel_ids),
            "plain_bf16_vs_fp32": agree(own_x, own_f)}
    free = free_running(out_g, out_x)
    real = attn.bool()[..., None]

    def max_err(a, b, key):
        return ((a[key].float() - b[key].float()).abs() * (real if a[key].dim() == 3 else real[..., 0])).max().item()

    err = {key: {"kernel_vs_fp32": max_err(exp, exp_f, key), "plain_bf16_vs_fp32": max_err(exp_x, exp_f, key)}
           for key in ("logits", "ref_logits", "values")}
    for e in err.values():
        e["ratio"] = e["kernel_vs_fp32"] / max(e["plain_bf16_vs_fp32"], 1e-30)
    distinct = [len(set(row)) for row in out_g["response_ids"].tolist()]
    emit("llama_reference", greedy_step_agreement=step, greedy_free_running_agreement=free,
         greedy_free_running_agreement_fp32={"kernel_vs_fp32": free_running(out_g, out_f),
                                             "plain_bf16_vs_fp32": free_running(out_x, out_f)},
         experience_max_abs_err=err, distinct_tokens_per_row=distinct)
    if step["kernel_vs_plain_bf16"] < LLAMA_STEP_AGREEMENT:
        raise AssertionError(f"only {step['kernel_vs_plain_bf16']:.2%} of greedy decisions agree with the plain path")
    if step["kernel_vs_fp32"] < step["plain_bf16_vs_fp32"] - 0.02:
        raise AssertionError(f"the kernel path picks fp32's greedy token less often than plain bf16 does: {step}")
    for key, e in err.items():
        if e["kernel_vs_fp32"] > 2 * e["plain_bf16_vs_fp32"]:
            raise AssertionError(f"{key}: the kernel path strays from fp32 more than plain bf16 does: {e}")


def llama_train_reference(trainer, seed: int, hf_dir: str) -> dict:
    """`train_reference` on the Llama trainer: one train step on a fresh
    store of 256 rollouts (16 minibatches of 16, cut by two shuffles)
    through the kernels, the plain bf16 and the plain fp32 attention math,
    at `grad_reference`'s bars."""
    configs = {
        "plain_bf16": llama_config(seed, hf_dir, attention_impl="xla", kv_cache_quant="int8"),
        "fp32": llama_config(seed, hf_dir, attention_impl="xla", kv_cache_quant=None, compute_dtype="float32"),
    }
    return train_reference(trainer, seed, configs, rollouts=LLAMA_REFERENCE_ROLLOUTS, batch_size=LLAMA_BATCH,
                           phase="llama_train_reference")


def llama_profiles(trainer, batch) -> None:
    """One traced train step on a stored batch (`train_step_profile`), and
    the wall time (median of 3) and one traced run of an experience pass
    (policy and hydra reference) over a greedy rollout of the 32 prompts."""
    import torch

    from trlx_tpu_torch.models.generation import SamplerSettings, generate

    train_step_profile(trainer, batch, "llama_train_step")
    tok = trainer.tokenizer
    ids, mask = (x[:LLAMA_ROLLOUTS] for x in byte_prompts(tok))
    greedy = SamplerSettings(max_new_tokens=TRAIN_NEW_TOKENS, do_sample=False,
                             eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id)
    with torch.no_grad():
        out = generate(trainer.model.base, ids, mask, None, greedy)
        seqs = out["sequences"]
        attn = torch.cat([mask, out["response_mask"]], dim=1)

        def experience():
            return trainer.model.forward_train(trainer.ref_params, seqs, attn)

        wall, _, _ = timed(experience)
        emit("llama_experience_time", wall_s=wall, batch=int(seqs.shape[0]), seq_len=int(seqs.shape[1]))
        profile_phase("llama_experience", experience, wall)


def llama_engine_path(seed: int, hf_dir: str, shapes: dict) -> dict:
    """`trlx_tpu_torch.train` on the Llama config for one cycle (4 steps)
    with rollouts and evaluations through the decode engine (32 lanes,
    16-token int8 pages, the paged kernel at D = 128, speculative decoding
    off the hydra draft, draft_k 4). Gates: paged launches == n_layer x the
    engine's decode steps, every one on the short route; the flash
    forward on its short route; no pool exhaustion; finite losses."""
    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch.trainer.base import TPUBaseTrainer

    calls = []
    engine_generate = TPUBaseTrainer._engine_generate

    def counted(self, *args, **kwargs):
        out = engine_generate(self, *args, **kwargs)
        calls.append(out["gen_stats"])
        return out

    config = llama_config(seed, hf_dir).evolve(method=dict(gen_engine=LLAMA_ENGINE),
                                               train=dict(total_steps=LLAMA_CYCLE_STEPS))
    fwd, paged = fwd_counters(), paged_counters()
    for fn in (*fwd.values(), *paged.values()):
        fn.launches = 0
    TPUBaseTrainer._engine_generate = counted
    try:
        t0 = time.perf_counter()
        with forward_shapes(shapes, "llama_engine"):
            trainer = trlx_tpu_torch.train(reward_fn=train_reward_fn, prompts=LLAMA_PROMPTS, config=config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        TPUBaseTrainer._engine_generate = engine_generate
    L = trainer.model.cfg.n_layer
    steps = sum(g["decode_steps"] for g in calls)
    launches = {name: fn.launches for name, fn in paged.items()}
    fwd_launches = {name: fn.launches for name, fn in fwd.items()}
    losses = [st["losses/total_loss"] for _, st in trainer.stats_history if "losses/total_loss" in st]
    accept = [st.get("rollout/spec_accept_rate") for _, st in trainer.stats_history if "rollout/engine_refills" in st]
    emit("llama_engine_path", wall_s=wall, engine_calls=len(calls), decode_steps=steps, paged_launches=launches,
         expected=L * steps, flash_fwd_launches=fwd_launches, losses=losses, spec_accept_rate=accept,
         oom_truncated=sum(g["oom_truncated"] for g in calls), unserved=sum(g["unserved"] for g in calls),
         cycle_seconds=cycle_split(trainer))
    if not calls or launches != {"paged": L * steps, "paged_short": L * steps, "paged_long": 0}:
        raise AssertionError(f"paged launches {launches} != {L} x {steps} engine decode steps, all short")
    if not (fwd_launches["flash_fwd"] > 0 and fwd_launches["flash_fwd_short"] == fwd_launches["flash_fwd"]):
        raise AssertionError(f"the flash forward left the short route: {fwd_launches}")
    if any(g["oom_truncated"] or g["unserved"] for g in calls):
        raise AssertionError("the engine's page pool ran out")
    if len(losses) != LLAMA_CYCLE_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"expected {LLAMA_CYCLE_STEPS} finite losses, got {losses}")
    del trainer
    return {"short": launches["paged_short"], "long": launches["paged_long"]}


def llama_kernel_times(gen, launches: dict, shape_launches: dict, errs: dict) -> list:
    """The four kernels at D = 128, at the Llama path's shapes (the
    prefill B32 H32 T32 over a 128-slot cache, the train step B16 H32
    T=S=64, the decode step L4 B32 H32 over a 128-slot cache, the engine's
    decode and verify steps: 32 lanes, 16-token int8 pages, 5 pages a
    lane) and at the extra shapes of the cases (T=S=512, GQA at Llama-3-8B's
    and Llama-2-70B's attention, the int8 decode at groups 4 and 8, the
    paged verify at group 8): each beside its bound, its plain version and,
    where one PyTorch call computes it, SDPA (forward and backward).
    `launches` is llama_path's {"train": counts, "engine": {route: n}},
    `shape_launches` the `forward_shapes` tallies of its two runs."""
    import torch
    import torch.nn.functional as F

    from trlx_tpu_torch.ops import decode_attention as da
    from trlx_tpu_torch.ops import flash_attention as fa

    train, engine = launches.get("train", {}), launches.get("engine", {})
    rows, D = [], 128

    def emit_row(**row):
        row = dict(route="cuda", max_abs_err=row.pop("err"), kernel_ms=row["ms"], head_dim=D, **row)
        rows.append(row)

    def causal_mask(mask, T, S, qo, causal):
        allowed = (mask[:, None, None, :] > 0).expand(mask.shape[0], 1, T, S).clone()
        if causal:
            allowed &= (torch.arange(T, device="cuda")[:, None] + qo) >= torch.arange(S, device="cuda")[None, :]
        return allowed

    with torch.no_grad():
        for case, (B, H, Hkv, T, S, off, pad) in {
            "llama_prefill": (LLAMA_ROLLOUTS, 32, 32, PROMPT_LEN, 128, 0, "prefill"),
            "llama_train": (LLAMA_BATCH, 32, 32, TRAIN_LEN, TRAIN_LEN, 0, "left"),
            "llama_experience": (LLAMA_ROLLOUTS, 32, 32, TRAIN_LEN, TRAIN_LEN, 0, "left"),
            "t512": (2, 32, 32, 512, 512, 0, "left"),
            "gqa_llama3_8b": (4, 32, 8, TRAIN_LEN, TRAIN_LEN, 0, "left"),
            "gqa_llama2_70b": (2, 64, 8, 128, 128, 0, "left"),
        }.items():
            q, k, v, mask = flash_inputs(gen, B, H, Hkv, T, S, D, off, pad)
            kw = dict(q_offset=off if pad == "prefill" else None, with_stats=True)
            _, scale, qo = fa._prepare(q, k, mask, None, kw["q_offset"], True)
            route = fa.forward_route(T, S, D)
            ms = time_ms(lambda: fa.flash_attention(q, k, v, mask, **kw))
            plain = time_ms(lambda: fa.flash_attention_plain(q, k, v, mask, **kw))
            allowed = causal_mask(mask, T, S, qo, True)
            # the library call takes the GQA group's kv heads repeated (made outside the timing)
            kr, vr = k.repeat_interleave(H // Hkv, 1), v.repeat_interleave(H // Hkv, 1)
            lib = time_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, attn_mask=allowed, scale=scale))
            by_path = {path: shape_launches.get(path, {}).get((route, (B, H, T), S), 0)
                       for path in ("llama", "llama_engine")}
            bms, by = bound_ms(*flash_work(mask, H, Hkv, T, S, D, qo))
            emit_row(name=f"flash_fwd_d128/{case}", source="trlx_tpu_torch/csrc/flash_fwd.cu",
                     replaces="trlx_tpu/ops/flash_attention.py:84", fwd_route=route,
                     launches=sum(by_path.values()), launches_by_path=by_path, err=errs["fwd"][route],
                     shape=[B, H, Hkv, T, S, D],
                     ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
                     library_is="F.scaled_dot_product_attention, boolean mask",
                     occupancy=fa.flash_attention_fwd_short_occupancy(T, S, True, qo, D) if route == "short" else None)
            del q, k, v, kr, vr, mask, allowed

        for case, (B, H, Hkv, T, S, n) in {
            "llama_train": (LLAMA_BATCH, 32, 32, TRAIN_LEN, TRAIN_LEN, train.get("flash_bwd", 0)),
            "d128_t512": (2, 32, 32, 512, 512, 0),
            "gqa_llama3_8b": (4, 32, 8, TRAIN_LEN, TRAIN_LEN, 0),
            "gqa_llama2_70b_t128": (2, 64, 8, 128, 128, 0),
        }.items():
            q, k, v, mask, out, m, l, g = flash_bwd_inputs(gen, B, H, Hkv, T, S, 0, "left", True, D)
            scale = D ** -0.5
            route = fa.backward_route(T, S, D)
            ms = time_ms(lambda: fa.flash_attention_backward(q, k, v, mask, out, m, l, g, True, scale, 0))
            plain = time_ms(lambda: fa.flash_attention_backward_plain(q, k, v, mask, out, m, l, g, True, scale, 0))
            allowed = causal_mask(mask, T, S, 0, True)
            allowed[..., 0] |= ~allowed.any(dim=-1)  # SDPA gives NaN on a row with no open slot
            with torch.enable_grad():
                # the library call takes the GQA group's kv heads repeated (its dk, dv per query head)
                lq, lk, lv = (x.detach().clone().requires_grad_(True)
                              for x in (q, k.repeat_interleave(H // Hkv, 1), v.repeat_interleave(H // Hkv, 1)))
                lib_out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=allowed, scale=scale)
                lib = time_ms(lambda: torch.autograd.grad(lib_out, (lq, lk, lv), g, retain_graph=True))
            work_dq, work_dkv, work_fused = flash_bwd_work(mask, H, Hkv, T, S, D, 0)
            work = work_fused if route == "fused" else (work_dq[0] + work_dkv[0], work_dq[1] + work_dkv[1])
            bms, by = bound_ms(*work)
            err = max(errs["bwd"]["by_case"][case].values())
            emit_row(name=f"flash_bwd_d128/{case}", source="trlx_tpu_torch/csrc/flash_bwd.cu",
                     replaces="trlx_tpu/ops/flash_attention.py:192", also_replaces="trlx_tpu/ops/flash_attention.py:231",
                     bwd_route=route, launches=n, err=err, shape=[B, H, Hkv, T, S, D], ms=ms, plain_ms=plain,
                     plain_is="the whole plain backward (dq, dk, dv)", bound_ms=bms, bound_by=by, library_ms=lib,
                     library_is="F.scaled_dot_product_attention backward (dq, dk, dv together)",
                     occupancy=fa.flash_attention_bwd_occupancy(T, S, D) if route == "fused" else None)
            del q, k, v, mask, out, m, l, g, lq, lk, lv, lib_out, allowed

        for case, (L, B, H, Hkv, S, written, n) in {
            "llama_rollout": (LLAMA_7B["n_layer"], LLAMA_ROLLOUTS, 32, 32, 128, TRAIN_LEN, train.get("decode_short", 0)),
            "gqa4": (2, 8, 32, 8, 200, 150, 0),
            "gqa8": (2, 8, 64, 8, 256, 256, 0),
        }.items():
            q, ck, cv, ks, vs, mask = decode_inputs(gen, L, B, H, Hkv, S, D, written)
            args = (q, ck, cv, ks, vs[1], mask, 1, D ** -0.5)
            ms = time_ms(lambda: da.decode_attention_int8(*args))
            long_ms = time_ms(lambda: da.decode_attention_int8_long(*args))
            plain = time_ms(lambda: da.decode_attention_int8_plain(*args))
            bms, by = bound_ms(*decode_work(mask, H, Hkv, S, D))
            occ = da.decode_attention_int8_occupancy("short", H, Hkv, S, D=D)
            emit_row(name=f"decode_int8_short_d128/{case}", source="trlx_tpu_torch/csrc/decode_int8.cu",
                     replaces="trlx_tpu/ops/decode_attention.py:369", kernel_route=da.decode_route(S), launches=n,
                     err=errs["decode"]["short"], shape=[L, B, H, Hkv, S, D], written=written, ms=ms, long_ms=long_ms,
                     plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
                     ctas_per_sm=occ["ctas_per_sm"], smem_bytes=occ["smem_bytes"])
            del q, ck, cv, ks, vs, mask

        lanes, PS, MP = 32, 16, 5
        depths = torch.randint(33, MP * PS - 4, (lanes,), generator=gen, device="cuda").tolist()
        for case, (B, T, H, Hkv, ps, mp, quant, dep, n) in {
            "llama_decode": (lanes, 1, 32, 32, PS, MP, "int8", depths, engine.get("short", 0)),
            "llama_verify": (lanes, 4, 32, 32, PS, MP, "int8", depths, 0),
            "gqa8_verify": (8, 4, 64, 8, 16, 16, "int8", [1, 100, 251, 37, 180, 64, 200, 9], 0),
        }.items():
            q, _, _, pools, table, _, bias, visible = paged_inputs(gen, B, T, H, Hkv, ps, mp, quant, dep, L=4, D=D)
            args = (q, pools, 1, table, bias, D ** -0.5)
            route = da.paged_route(T, H, Hkv, ps, mp)
            ms = time_ms(lambda: da.paged_attention(*args))
            long_ms = time_ms(lambda: da.paged_attention_long(*args))
            plain = time_ms(lambda: da.paged_attention_plain(*args))
            bms, by = bound_ms(*paged_work(visible, table, H, Hkv, T, ps, True, D))
            occ = da.paged_attention_occupancy(route, T, H, Hkv, ps, mp, True, D=D)
            emit_row(name=f"paged_attention_d128/{case}", source="trlx_tpu_torch/csrc/paged_attention.cu",
                     replaces="trlx_tpu/ops/decode_attention.py:198", kernel_route=route,
                     launches=n if case == "llama_decode" else 0,
                     launches_note={"llama_decode": "the engine run's launches, its decode and verify steps together",
                                    "llama_verify": "counted in llama_decode's launches"}.get(case),
                     err=errs["paged"][route], shape=[B, T, H, Hkv, ps, mp, D], ms=ms, long_ms=long_ms,
                     plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
                     ctas_per_sm=occ["ctas_per_sm"], smem_bytes=occ["smem_bytes"])
            del q, pools, table, bias, visible
    for r in rows:
        emit("kernel_time", **r)
    return rows


def llama_phases(seed: int, shapes: dict) -> dict:
    """The Llama path (`llama_path`) on a card with room for it."""
    import torch

    torch.cuda.empty_cache()
    out = llama_path(seed, shapes)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the peft tier: LoRA, prompt tuning, prefix tuning
# ---------------------------------------------------------------------------

PEFT_VIRTUAL = 10  # the virtual tokens of prompt and prefix tuning
# examples/ppo_sentiments_peft.py:23-28: LoRA with r 8 and alpha 32 on the
# default targets (q, k, v and o); prompt and prefix tuning with 10 virtual
# tokens are its drop-in swaps
PEFT_LORA = {"peft_type": "LORA", "r": 8, "lora_alpha": 32}
PEFT_ADAPTERS = {"prompt": {"peft_type": "PROMPT_TUNING", "num_virtual_tokens": PEFT_VIRTUAL},
                 "prefix": {"peft_type": "PREFIX_TUNING", "num_virtual_tokens": PEFT_VIRTUAL}}
PEFT_CYCLE_STEPS = TRAIN_EPOCHS * TRAIN_ROLLOUTS // TRAIN_BATCH
# the kernels at the adapters' new layouts, held to their plain versions at
# the D = 64 (and D = 128) bars: prompt tuning's T + 10 rows (the virtual
# slots always real, then a left-padded sequence) and its warm-up prefill of
# the 10 soft tokens; prefix tuning's T queries over 10 + T keys at q_offset
# 10 and the prompt's prefill at slot 10; the 7B LoRA cell's step at D = 128
PEFT_FLASH_CASES = {  # name: (B, H, Hkv, T, S, D, q_offset, pad, causal)
    "prompt_train": (TRAIN_BATCH, 12, 12, TRAIN_LEN + PEFT_VIRTUAL, TRAIN_LEN + PEFT_VIRTUAL, 64, 0, "virtual", True),
    "prompt_experience": (TRAIN_ROLLOUTS, 12, 12, TRAIN_LEN + PEFT_VIRTUAL, TRAIN_LEN + PEFT_VIRTUAL, 64, 0,
                          "virtual", True),
    "prompt_warmup": (TRAIN_BATCH, 12, 12, PEFT_VIRTUAL, 128, 64, 0, "prefill", True),
    "virtual_prefill": (TRAIN_BATCH, 12, 12, PROMPT_LEN, 128, 64, PEFT_VIRTUAL, "prefill", True),
    "prefix_train": (TRAIN_BATCH, 12, 12, TRAIN_LEN, TRAIN_LEN + PEFT_VIRTUAL, 64, PEFT_VIRTUAL, "virtual", True),
    "prefix_experience": (TRAIN_ROLLOUTS, 12, 12, TRAIN_LEN, TRAIN_LEN + PEFT_VIRTUAL, 64, PEFT_VIRTUAL, "virtual",
                          True),
    "llama_lora_train": (8, 32, 32, TRAIN_LEN, TRAIN_LEN, 128, 0, "left", True),
    "lora_prefill": (TRAIN_BATCH, 12, 12, PROMPT_LEN, 128, 64, 0, "prefill", True),
}
# the paths whose launches each case counts: the forward's launches are
# tallied by (B, H, T, S), and the LoRA prefill (at slot 0) shares its
# shape with the virtual paths' (at slot 10)
PEFT_FLASH_PATHS = {"prompt_train": ("peft_prompt",), "prompt_experience": ("peft_prompt",),
                    "prompt_warmup": ("peft_prompt",), "virtual_prefill": ("peft_prompt", "peft_prefix"),
                    "prefix_train": ("peft_prefix",), "prefix_experience": ("peft_prefix",),
                    "llama_lora_train": ("llama_lora",), "lora_prefill": ("peft_lora", "peft_lora_engine")}
PEFT_BWD_CASES = {  # name: (B, H, Hkv, T, S, q_offset, pad, causal)
    "prompt_train": (TRAIN_BATCH, 12, 12, TRAIN_LEN + PEFT_VIRTUAL, TRAIN_LEN + PEFT_VIRTUAL, 0, "virtual", True),
    # the prefix's new work: dk and dv at the 10 slots below q_offset, seen by every query
    "prefix_train": (TRAIN_BATCH, 12, 12, TRAIN_LEN, TRAIN_LEN + PEFT_VIRTUAL, PEFT_VIRTUAL, "virtual", True),
    "prefix_gqa": (8, 12, 4, TRAIN_LEN, TRAIN_LEN + PEFT_VIRTUAL, PEFT_VIRTUAL, "virtual", True),
    "lora_train": (TRAIN_BATCH, 12, 12, TRAIN_LEN, TRAIN_LEN, 0, "left", True),
}
PEFT_BWD_D128_CASES = {"llama_lora_train": (8, 32, 32, TRAIN_LEN, TRAIN_LEN, 0, "left", True)}
# Llama-2-7B LoRA: the published widths and depth (LLAMA_7B at 32 layers),
# r 8 on q, k, v and o, batch 8 of 32-token prompts + 32 new tokens, one
# cycle of one PPO epoch; the phase's budget before its depth is cut
LLAMA_LORA_LAYERS = 32
LLAMA_LORA_BATCH = 8
LLAMA_LORA_BUDGET_S = 150
PEFT_DECODE_D128_CASES = {"llama_lora": (LLAMA_LORA_LAYERS, LLAMA_LORA_BATCH, 32, 32, 128, TRAIN_LEN)}


def peft_config(seed: int, adapter: dict, attention_impl="pallas", kv_cache_quant="int8_kernel",
                compute_dtype="bfloat16", **train):
    """The train path's workload (`train_config`) with a peft adapter, on
    GPT-2 small at all 12 layers."""
    config = train_config(seed, attention_impl, kv_cache_quant, compute_dtype)
    transformer = dict(config.model.model_extra_configs["transformer"], n_layer=GPT2_SMALL["n_layer"])
    config = config.evolve(model=dict(peft_config=adapter, model_extra_configs={"transformer": transformer}))
    return config.evolve(train=train) if train else config


def peft_reference_configs(seed: int, adapter: dict) -> dict:
    return {"plain_bf16": peft_config(seed, adapter, attention_impl="xla", kv_cache_quant="int8"),
            "fp32": peft_config(seed, adapter, attention_impl="xla", kv_cache_quant=None, compute_dtype="float32")}


def peft_launches(L: int, kind: str, cycles: int, decode_steps: list, steps: int) -> dict:
    """The training kernels' launches of a peft `train()` run on the train
    path's workload. Every sampler call (a rollout a cycle, an evaluation at
    each end) prefills once a layer, twice under prompt tuning (the soft
    tokens' warm-up over slots [0, 10), then the prompt at slot 10; a kv
    prefix is written into the cache instead). Each experience chunk runs
    the policy and its reference, the base with the adapter off: two full
    forwards. Each train step one forward and one fused backward through
    every layer (the adapter lives in every layer, or feeds the first one,
    so every layer's attention inputs carry a gradient). Each decode step
    one short int8 decode launch a layer (a 128-slot cache: 10 + 32 + 32
    slots rounded up)."""
    prefills = 2 if kind == "prompt" else 1
    n_fwd = L * (prefills * (cycles + 2) + 2 * cycles + steps)
    n_decode = L * sum(decode_steps)
    return {"flash_fwd": n_fwd, "flash_fwd_short": n_fwd, "flash_fwd_long": 0,
            "flash_bwd": L * steps, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "decode": n_decode, "decode_short": n_decode, "decode_long": 0}


def check_adapter_run(trainer, seed: int, phase: str, base_generator=None) -> dict:
    """The peft contract on a trained run: every base tensor bit for bit
    as the seeded init drew it (replayed tensor by tensor from the same
    generator; `base_generator` when the run drew its base from another),
    none of them trainable or held by AdamW; every LoRA B moved from its
    zero init, a soft prompt or a prefix from its seeded init (the wrapper's
    init order: base, heads, adapter); the reference the adapter-off base,
    no copy."""
    import torch

    from trlx_tpu_torch.models import lora, peft
    from trlx_tpu_torch.models.wrappers import AdapterOffReference

    model = trainer.model
    replay = getattr(model.base, "init_value", None)
    if replay is not None:
        gen = base_generator or torch.Generator().manual_seed(seed)
        changed = [n for n, p in model.base.named_parameters()
                   if not torch.equal(p, replay(n, p, gen).to(p.device))]
    else:  # T5: a fresh base from the seed
        fresh = type(model.base)(model.cfg, device="cuda").init_params(torch.Generator().manual_seed(seed))
        want = dict(fresh.named_parameters())
        changed = [n for n, p in model.base.named_parameters() if not torch.equal(p, want[n])]
        del fresh, want
    in_adamw = {id(p) for g in trainer.optimizer.param_groups for p in g["params"]}
    base_trainable = [n for n, p in model.base.named_parameters() if p.requires_grad or id(p) in in_adamw]
    if getattr(model, "lora", None) is not None:
        unmoved = [n for n, pair in lora.pairs(model.lora) if not pair.b.detach().abs().max().item() > 0]
        n_adapter = sum(p.numel() for p in model.lora.parameters())
    else:
        kind = "prompt" if getattr(model, "prompt", None) is not None else "prefix"
        init = type(model)(model.cfg, device="cuda")
        peft.attach_adapter(init, trainer._peft_cfg)
        init.init_params(torch.Generator().manual_seed(seed))
        unmoved = [n for n, p in getattr(model, kind).named_parameters()
                   if torch.equal(p, dict(getattr(init, kind).named_parameters())[n])]
        n_adapter = sum(p.numel() for p in getattr(model, kind).parameters())
        del init
    ref_ok = isinstance(trainer.ref_params, AdapterOffReference) and not list(trainer.ref_params.parameters())
    out = {"base_tensors": len(list(model.base.parameters())), "base_changed": changed,
           "base_trainable": base_trainable, "adapter_unmoved": unmoved, "adapter_parameters": n_adapter,
           "trainable_parameters": sum(p.numel() for p in trainer.trainable_params),
           "reference_is_adapter_off_base": ref_ok}
    emit(phase, **out)
    if changed or base_trainable or unmoved or not ref_ok:
        raise AssertionError(f"the peft contract broke: {out}")
    return out


def first_rollout_kl(trainer) -> float:
    kl = [st["policy/sqrt_kl"] for _, st in trainer.stats_history if "policy/sqrt_kl" in st]
    if not kl:
        raise AssertionError("no rollout KL was logged")
    return kl[0]


def peft_greedy_reference(trainer, phase: str) -> dict:
    """A greedy rollout of the trained adapter policy (64 byte prompts
    left-padded to 32, 32 new tokens, the soft prompt or prefix in the
    cache, the int8 decode kernel) against the plain bf16 path
    (attention_impl="xla", the folded int8 cache) and the plain fp32 path
    on the same weights, as `llama_reference` holds it. Per step (both
    plain paths forced onto the kernel path's tokens, each decision compared
    on the same prefix): at least 95% of the kernel path's decisions agree
    with plain bf16 (the GPT-2 rollout's per-step floor), and it picks
    fp32's token at least as often as plain bf16 does, within 2 points.
    Free-running agreement is printed against both, not gated: one flipped
    near-tie changes the rest of a free-running row, and on an H100 over
    seeds 0-2 the kernel path agreed with plain bf16 free-running on
    82.8-95.1% of tokens (prefix) and 79.9-97.5% (prompt) while plain bf16
    agreed with fp32 on 70.1-81.6% and 86.4-93.2% (`PERF.md`)."""
    import torch

    from trlx_tpu_torch.models.generation import SamplerSettings, generate
    from trlx_tpu_torch.models.transformer import TransformerLM
    from trlx_tpu_torch.utils.tokenizers import ByteTokenizer

    tok = ByteTokenizer()
    ids, mask = byte_prompts(tok)
    greedy = SamplerSettings(max_new_tokens=TRAIN_NEW_TOKENS, do_sample=False, eos_token_id=tok.eos_token_id,
                             pad_token_id=tok.pad_token_id)
    adapter = trainer._sampler_adapter_kwargs()
    base = trainer.model.base

    def copy(**kw):
        model = TransformerLM(base.cfg.replace(**kw), device="cuda")
        model.load_state_dict(base.state_dict())
        return model

    def forced(model):
        """The model's own greedy choice at each step of the kernel path's rows."""
        own = []

        def force(hidden_last, logits_last):
            t = len(own)
            own.append(logits_last.argmax(dim=-1))
            return torch.full_like(logits_last, float("-inf")).scatter_(1, kernel_ids[:, t:t + 1], 0.0)

        generate(model, ids, mask, None, greedy, logits_processor=force, **adapter)
        return torch.stack(own, dim=1)

    with torch.no_grad():
        out_g = generate(base, ids, mask, None, greedy, **adapter)
        kernel_ids = out_g["response_ids"]
        plain = copy(attention_impl="xla", kv_cache_quant="int8")
        exact = copy(attention_impl="xla", kv_cache_quant=None, dtype=torch.float32)
        out_x = generate(plain, ids, mask, None, greedy, **adapter)
        out_f = generate(exact, ids, mask, None, greedy, **adapter)
        own_x, own_f = forced(plain), forced(exact)
    del plain, exact

    def free_running(a, b):
        real = a["response_mask"].bool() & b["response_mask"].bool()
        return (a["response_ids"] == b["response_ids"])[real].float().mean().item()

    n = own_x.shape[1]
    real_steps = out_g["response_mask"].bool()[:, :n]

    def agree(a, b):
        return (a[:, :n] == b[:, :n])[real_steps].float().mean().item()

    step = {"kernel_vs_plain_bf16": agree(own_x, kernel_ids), "kernel_vs_fp32": agree(own_f, kernel_ids),
            "plain_bf16_vs_fp32": agree(own_x, own_f)}
    free = {"kernel_vs_plain_bf16": free_running(out_g, out_x), "kernel_vs_fp32": free_running(out_g, out_f),
            "plain_bf16_vs_fp32": free_running(out_x, out_f)}
    emit(phase, greedy_step_agreement=step, greedy_free_running_agreement=free,
         response_tokens=int(out_g["response_mask"].sum().item()), adapter=sorted(adapter))
    if step["kernel_vs_plain_bf16"] < 0.95:
        raise AssertionError(f"only {step['kernel_vs_plain_bf16']:.2%} of greedy decisions with the adapter agree "
                             "with the plain path")
    if step["kernel_vs_fp32"] < step["plain_bf16_vs_fp32"] - 0.02:
        raise AssertionError(f"with the adapter the kernel path picks fp32's greedy token less often than plain "
                             f"bf16 does: {step}")
    return {"step": step, "free": free}


def peft_lora_path(seed: int, shapes: dict) -> dict:
    """LoRA PPO (r 8, alpha 32 on q, k, v and o) on the train path's
    workload at GPT-2-small width and depth: two cycles through the static
    sampler (kernels 1, 2/3, 8), then the HF-peft round trip, one train
    step through `grad_reference`, and one cycle of another run through the
    decode engine (kernel 7). Gates: exact launches; the base bit for bit,
    every B moved; the first rollout's KL to the reference exactly 0 (B
    starts at 0, so the adapter's term adds exact zeros); the gradient
    ratios at the GPT-2 path's bars; the round trip bit for bit."""
    import torch

    config = peft_config(seed, PEFT_LORA)
    trainer, wall, launches, decode_steps = counted_train(config, shapes, "peft_lora")
    L = trainer.model.cfg.n_layer
    cycles = TRAIN_STEPS // PEFT_CYCLE_STEPS
    expect = peft_launches(L, "lora", cycles, decode_steps, TRAIN_STEPS)
    losses = check_train_losses(trainer)
    kl0 = first_rollout_kl(trainer)
    emit("peft_lora_path", wall_s=wall, launches=launches, expected=expect, decode_steps=decode_steps,
         losses=losses, first_rollout_sqrt_kl=kl0, branch_at=trainer.model.branch_at,
         cycle_seconds=cycle_split(trainer))
    if {k: launches[k] for k in expect} != expect or len(decode_steps) != cycles + 2:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    if kl0 != 0.0 or trainer.model.branch_at is not None:
        raise AssertionError(f"the first rollout's KL to the adapter-off reference is {kl0}, not 0 "
                             f"(or a hydra branch was built: {trainer.model.branch_at})")
    check_adapter_run(trainer, seed, "peft_lora_params")
    peft_round_trip(trainer)
    batch = train_reference(trainer, seed, configs=peft_reference_configs(seed, PEFT_LORA),
                            phase="peft_lora_reference", must_gate="lora.",
                            signed_sums=("v_head.fc_out.bias",))["batch"]
    train_step_profile(trainer, batch, "peft_lora_train_step")
    del trainer, batch
    torch.cuda.empty_cache()
    return {"static": launches, "engine": peft_lora_engine_path(seed, shapes)}


def peft_round_trip(trainer) -> None:
    """`save_pretrained` of the LoRA trainer writes the HF-peft adapter
    (adapter_config.json, adapter_model.safetensors) beside the base;
    `model_path` and `peft_config` = that directory reload the adapter bit
    for bit and give equal logits."""
    import shutil

    import torch

    from trlx_tpu_torch.utils.loading import get_trainer

    out = os.path.join(_CKPT_ROOT[0], "peft_export")
    shutil.rmtree(out, ignore_errors=True)
    trainer.save_pretrained(out)
    files = sorted(os.listdir(out))
    config = trainer.config.evolve(model=dict(model_path=out, peft_config=out))
    again = get_trainer(config.train.trainer)(config=config, reward_fn=train_reward_fn)
    ours, theirs = trainer.model.state_dict(), again.model.state_dict()
    adapter = [n for n in ours if n.startswith("lora.")]
    unequal = [n for n in adapter if n not in theirs or not torch.equal(ours[n], theirs[n])]
    ids = torch.randint(0, 258, (4, TRAIN_LEN), generator=torch.Generator().manual_seed(1)).to("cuda")
    with torch.no_grad():
        logits_equal = bool(torch.equal(trainer.model.base(ids)["logits"], again.model.base(ids)["logits"]))
    emit("peft_round_trip", files=files, adapter_tensors=len(adapter), unequal=unequal, logits_equal=logits_equal,
         reloaded_peft_cfg=again._peft_cfg)
    if not {"adapter_config.json", "adapter_model.safetensors"} <= set(files) or not adapter:
        raise AssertionError(f"save_pretrained wrote no HF-peft adapter: {files}")
    if unequal or not logits_equal or {n for n in theirs if n.startswith("lora.")} != set(adapter):
        raise AssertionError(f"the HF-peft adapter did not reload bit for bit: {unequal}, logits {logits_equal}")
    del again
    shutil.rmtree(out, ignore_errors=True)


def peft_lora_engine_path(seed: int, shapes: dict) -> dict:
    """One LoRA cycle with rollouts and evaluations through the decode
    engine (the train-engine path's 32 slots, 16-token int8 pages, the
    paged kernel, speculative decoding off the adapter-off base): the
    engine samples the merged weights. Gates: paged launches == n_layer x
    the engine's decode steps, all short; the forward all short; the base
    unchanged."""
    import torch

    from trlx_tpu_torch.ops.decode_attention import paged_attention
    from trlx_tpu_torch.trainer.base import TPUBaseTrainer

    calls = []
    engine_generate = TPUBaseTrainer._engine_generate

    def counted(self, *args, **kwargs):
        out = engine_generate(self, *args, **kwargs)
        calls.append(out["gen_stats"])
        return out

    config = peft_config(seed, PEFT_LORA, total_steps=PEFT_CYCLE_STEPS).evolve(method=dict(gen_engine=ENGINE_TRAIN))
    fwd, paged = fwd_counters(), paged_counters()
    for fn in (*fwd.values(), *paged.values()):
        fn.launches = 0
    TPUBaseTrainer._engine_generate = counted
    try:
        t0 = time.perf_counter()
        with forward_shapes(shapes, "peft_lora_engine"):
            trainer = trlx_tpu_torch_train(config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        TPUBaseTrainer._engine_generate = engine_generate
    L = trainer.model.cfg.n_layer
    steps = sum(g["decode_steps"] for g in calls)
    by_route = {route: paged[f"paged_{route}"].launches for route in ("short", "long")}
    fwd_launches = {name: fn.launches for name, fn in fwd.items()}
    emit("peft_lora_engine_path", wall_s=wall, engine_calls=len(calls), decode_steps=steps,
         paged_launches=paged_attention.launches, paged_launches_by_route=by_route, expected=L * steps,
         flash_fwd_launches=fwd_launches, iter_count=trainer.iter_count,
         spec_accept_rate=[st.get("rollout/spec_accept_rate") for _, st in trainer.stats_history
                           if "rollout/engine_refills" in st], cycle_seconds=cycle_split(trainer))
    if paged_attention.launches != L * steps or not calls or by_route != {"short": L * steps, "long": 0}:
        raise AssertionError(f"paged launches {by_route} != {L} x {steps} engine decode steps, all short")
    if not (fwd_launches["flash_fwd"] > 0 and fwd_launches["flash_fwd_short"] == fwd_launches["flash_fwd"]):
        raise AssertionError(f"the flash forward left the short route: {fwd_launches}")
    if any(g["oom_truncated"] or g["unserved"] for g in calls) or trainer.iter_count != PEFT_CYCLE_STEPS:
        raise AssertionError("the engine's page pool ran out or the cycle did not finish")
    check_adapter_run(trainer, seed, "peft_lora_engine_params")
    return {"paged": by_route}


def trlx_tpu_torch_train(config, prompts=TRAIN_PROMPTS):
    import trlx_tpu_torch

    return trlx_tpu_torch.train(reward_fn=train_reward_fn, prompts=prompts, config=config)


def peft_virtual_path(seed: int, kind: str, shapes: dict) -> dict:
    """Prompt or prefix tuning (10 virtual tokens) on the train path's
    workload at GPT-2-small width and depth: two cycles through the static
    sampler. Gates: exact launches (kernel 1 at T + 10 rows or at T queries
    over 10 + T keys at q_offset 10, the soft tokens' warm-up prefill, the
    fused backward at those shapes); the base bit for bit and the adapter
    moved; the greedy rollout with the adapter against the plain bf16 path
    (`peft_greedy_reference`); for the prefix, whose keys and values get
    their gradient from kernels 2/3 at the slots below q_offset, one train
    step through `grad_reference` at the GPT-2 path's bars, the prefix
    tensors among the gated."""
    import torch

    adapter = PEFT_ADAPTERS[kind]
    trainer, wall, launches, decode_steps = counted_train(peft_config(seed, adapter), shapes, f"peft_{kind}")
    L = trainer.model.cfg.n_layer
    cycles = TRAIN_STEPS // PEFT_CYCLE_STEPS
    expect = peft_launches(L, kind, cycles, decode_steps, TRAIN_STEPS)
    losses = check_train_losses(trainer)
    emit(f"peft_{kind}_path", wall_s=wall, launches=launches, expected=expect, decode_steps=decode_steps,
         losses=losses, cycle_seconds=cycle_split(trainer),
         forward_shapes=[[route, list(bht), S, n] for (route, bht, S), n in sorted(shapes[f"peft_{kind}"].items())])
    if {k: launches[k] for k in expect} != expect or len(decode_steps) != cycles + 2:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    check_adapter_run(trainer, seed, f"peft_{kind}_params")
    peft_greedy_reference(trainer, f"peft_{kind}_greedy")
    if kind == "prefix":
        batch = train_reference(trainer, seed, configs=peft_reference_configs(seed, adapter),
                                phase="peft_prefix_reference", must_gate="prefix.")["batch"]
    else:
        batch = next(iter(trainer.store.create_loader(TRAIN_BATCH, shuffle=False)))
    train_step_profile(trainer, batch, f"peft_{kind}_train_step")
    del trainer, batch
    torch.cuda.empty_cache()
    return launches


def peft_t5_path(seed: int, shapes: dict, bias_shapes: dict) -> dict:
    """T5-base with LoRA on the self- and cross-attention of both stacks:
    one PPO cycle at `t5_train_path`'s shape (48 rollouts, 16 steps).
    Gates: exact launches of kernels 4-6 and of kernels 1-3 on the cross
    attention (every layer takes a backward: each holds an adapter); the
    base bit for bit and every B moved; per-step greedy agreement of the
    kernel path with the plain bf16 path on the same prefix (the argmax of
    the teacher-forced logits over a greedy rollout) at T5_STEP_AGREEMENT."""
    import torch

    from trlx_tpu_torch.models.peft import attach_adapter
    from trlx_tpu_torch.models.seq2seq import generate_seq2seq
    from trlx_tpu_torch.models.wrappers import Seq2SeqLMWithValueHead

    steps = T5_TRAIN_STEPS // 2
    config = t5_config(seed, peft_config=PEFT_LORA)
    seq2seq = dict(config.model.model_extra_configs["seq2seq"], n_layer=T5_BASE["n_layer"],
                   n_decoder_layer=T5_BASE["n_decoder_layer"])
    config = config.evolve(train=dict(total_steps=steps), model=dict(model_extra_configs={"seq2seq": seq2seq}))
    counters = bias_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with forward_shapes(shapes, "peft_t5"), bias_fwd_shapes(bias_shapes, "peft_t5"):
        trainer = trlx_tpu_torch_train(config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    cfg = trainer.model.cfg
    chunks = T5_ROLLOUTS // T5_BATCH
    n_gen = chunks + 2
    tf = cfg.n_layer + cfg.n_decoder_layer
    # as t5_train_path: the reference (the adapter-off base) is a full pass
    n_cross = 2 * cfg.n_decoder_layer * chunks + cfg.n_decoder_layer * steps
    n_bias = cfg.n_layer * n_gen + 2 * tf * chunks + tf * steps
    expect = {"flash_bias_fwd": n_bias, "flash_bias_fwd_short": n_bias, "flash_bias_fwd_long": 0,
              "flash_fwd": n_cross, "flash_fwd_short": n_cross, "flash_fwd_long": 0,
              "flash_bias_bwd": tf * steps, "flash_bias_bwd_dq": 0, "flash_bias_bwd_dkv": 0,
              "flash_bwd": cfg.n_decoder_layer * steps, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    losses = [st["losses/total_loss"] for _, st in trainer.stats_history if "losses/total_loss" in st]
    emit("peft_t5_path", wall_s=wall, launches=launches, expected=expect, losses=losses,
         first_rollout_sqrt_kl=first_rollout_kl(trainer), cycle_seconds=cycle_split(trainer))
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"expected {steps} finite losses, got {losses}")
    if launches != expect or first_rollout_kl(trainer) != 0.0:
        raise AssertionError(f"launch counts {launches} != expected {expect}, or a nonzero first KL")
    check_adapter_run(trainer, seed, "peft_t5_params")

    tok = trainer.tokenizer
    enc = tok(TRAIN_PROMPTS[:T5_ROLLOUTS], padding="max_length", max_length=T5_PROMPT_LEN, truncation=True)
    ids = torch.tensor(enc["input_ids"], device="cuda")
    mask = torch.tensor(enc["attention_mask"], device="cuda")
    plain = Seq2SeqLMWithValueHead(cfg.replace(attention_impl="xla"), device="cuda")
    attach_adapter(plain, trainer._peft_cfg)
    plain.load_state_dict(trainer.model.state_dict())
    greedy = dataclasses.replace(trainer.generate_settings, do_sample=False, max_new_tokens=T5_NEW_TOKENS)
    with torch.no_grad():
        out = generate_seq2seq(trainer.model.base, ids, mask, None, greedy)
        dec = out["sequences"]
        dec_mask = torch.cat([torch.ones_like(dec[:, :1], dtype=torch.int32), out["response_mask"]], dim=1)
        choice = {name: m(ids, mask, dec, dec_mask)["logits"][:, :-1].argmax(dim=-1)
                  for name, m in (("kernel", trainer.model), ("plain_bf16", plain))}
    decisions = dec_mask.bool()[:, 1:]
    step = (choice["kernel"] == choice["plain_bf16"])[decisions].float().mean().item()
    emit("peft_t5_reference", greedy_step_agreement_vs_plain_bf16=step, decisions=int(decisions.sum().item()))
    if step < T5_STEP_AGREEMENT:
        raise AssertionError(f"only {step:.2%} of T5 LoRA greedy decisions agree with the plain bf16 path")
    del trainer, plain
    torch.cuda.empty_cache()
    return launches


def llama_lora_config(seed: int, layers: int):
    """LoRA PPO at Llama-2-7B's published widths (LLAMA_7B) and `layers`
    layers, random weights: r 8 / alpha 32 on q, k, v and o, the example's
    num_layers_unfrozen (dropped under the adapter: k = -1), bf16 compute
    over fp32 parameters, batch 8 of byte prompts left-padded to 32, 32 new
    tokens, one cycle of one PPO epoch: one optimizer step."""
    from trlx_tpu_torch.data.default_configs import default_ppo_config

    transformer = dict(LLAMA_7B, n_layer=layers, attention_impl="pallas", kv_cache_quant="int8_kernel")
    return default_ppo_config().evolve(
        train=dict(batch_size=LLAMA_LORA_BATCH, total_steps=1, eval_interval=10_000, checkpoint_interval=10_000,
                   seq_length=TRAIN_LEN, epochs=10_000, tracker=None, compute_dtype="bfloat16", seed=seed,
                   **ckpt_kw()),
        model=dict(model_path="random", num_layers_unfrozen=LLAMA_UNFROZEN, peft_config=PEFT_LORA,
                   model_extra_configs={"transformer": transformer}),
        tokenizer=dict(tokenizer_path="byte"),
        method=dict(num_rollouts=LLAMA_LORA_BATCH, chunk_size=LLAMA_LORA_BATCH, ppo_epochs=1,
                    gen_kwargs=dict(max_new_tokens=TRAIN_NEW_TOKENS, top_k=0, top_p=1.0, do_sample=True)),
    )


def llama_lora_path(seed: int, shapes: dict) -> dict:
    """LoRA PPO at Llama-2-7B's published widths and LLAMA_LORA_LAYERS
    layers on one card, through `trlx_tpu_torch.train`. The base's random
    weights are drawn on the card (a seeded CUDA generator: 6.7 B host draws
    would take a minute), the heads and the adapter from the trainer's own
    seeded generator. The run's deploy export (a 27 GB fp32 base) is not
    written: the checkpoint commit is skipped in this phase alone. Prints
    the init time, the wall, the peak device memory, the trainable
    parameters, and what the fp32 weights and a full-parameter AdamW run
    (weights, gradients, two moments) would hold. Gates: a finite loss,
    exact launches of kernels 1, 2/3 and 8 at D = 128, the base bit for
    bit, every B moved, the first rollout's KL exactly 0."""
    import torch

    from trlx_tpu_torch.models.wrappers import CausalLMWithValueHead
    from trlx_tpu_torch.trainer.base import TPUBaseTrainer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    init_s = []
    init_params, save = CausalLMWithValueHead.init_params, TPUBaseTrainer._save_checkpoint

    def init_on_card(self, generator):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.base.init_params(torch.Generator(device="cuda").manual_seed(seed))
        torch.cuda.synchronize()
        init_s.append(time.perf_counter() - t0)
        return self.init_heads(generator)

    CausalLMWithValueHead.init_params = init_on_card
    TPUBaseTrainer._save_checkpoint = lambda self, name, final=False: None
    try:
        trainer, wall, launches, decode_steps = counted_train(llama_lora_config(seed, LLAMA_LORA_LAYERS), shapes,
                                                              "llama_lora", prompts=TRAIN_PROMPTS[:LLAMA_LORA_BATCH])
    finally:
        CausalLMWithValueHead.init_params, TPUBaseTrainer._save_checkpoint = init_params, save
    peak = torch.cuda.max_memory_allocated()
    cfg = trainer.model.cfg
    L = cfg.n_layer
    expect = run_launches(L, 3, 1, 1, decode_steps)
    losses = [st["losses/total_loss"] for _, st in trainer.stats_history if "losses/total_loss" in st]
    n_params = sum(p.numel() for p in trainer.model.base.parameters())
    emit("llama_lora_path", wall_s=wall, init_s=init_s, peak_device_bytes=peak, layers=L,
         published_layers=LLAMA_PUBLISHED_LAYERS, base_parameters=n_params,
         trainable_parameters=sum(p.numel() for p in trainer.trainable_params),
         adapter_parameters=sum(p.numel() for p in trainer.model.lora.parameters()),
         fp32_weights_bytes=4 * n_params, full_adamw_bytes=16 * n_params, launches=launches, expected=expect,
         decode_steps=decode_steps, losses=losses, cycle_seconds=cycle_split(trainer),
         first_rollout_sqrt_kl=first_rollout_kl(trainer), branch_at=trainer.model.branch_at,
         budget_s=LLAMA_LORA_BUDGET_S)
    if len(losses) != 1 or not math.isfinite(losses[0]):
        raise AssertionError(f"expected one finite loss, got {losses}")
    if {k: launches[k] for k in expect} != expect or len(decode_steps) != 3:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    if first_rollout_kl(trainer) != 0.0 or cfg.head_dim != 128:
        raise AssertionError("the first rollout's KL to the adapter-off base is not 0, or the head width is not 128")
    check_adapter_run(trainer, seed, "llama_lora_params", base_generator=torch.Generator(device="cuda").manual_seed(seed))
    train_step_profile(trainer, next(iter(trainer.store.create_loader(LLAMA_LORA_BATCH, shuffle=False))),
                       "llama_lora_train_step")
    emit("llama_lora_memory", peak_device_bytes_with_profile=torch.cuda.max_memory_allocated())
    del trainer
    torch.cuda.empty_cache()
    return launches


def peft_phases(seed: int, shapes: dict, bias_shapes: dict) -> dict:
    """The peft tier: the adapters' kernel layouts against their plain
    versions, then the LoRA, prompt, prefix, T5 LoRA and 7B LoRA paths."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    errs = {"fwd": check_flash(gen, PEFT_FLASH_CASES, phase="flash_check_peft"),
            "bwd": check_flash_bwd(gen, PEFT_BWD_CASES, phase="flash_bwd_check_peft"),
            "bwd_d128": check_flash_bwd(gen, PEFT_BWD_D128_CASES, D=128, phase="flash_bwd_check_peft_d128"),
            "decode_d128": check_decode(gen, PEFT_DECODE_D128_CASES, D=128, phase="decode_check_peft_d128")["by_route"]}
    torch.cuda.empty_cache()
    out = {"errs": errs, "lora": peft_lora_path(seed, shapes)}
    for kind in PEFT_ADAPTERS:
        out[kind] = peft_virtual_path(seed, kind, shapes)
    out["t5"] = peft_t5_path(seed, shapes, bias_shapes)
    out["llama_lora"] = llama_lora_path(seed, shapes)
    return out


def peft_kernel_times(gen, peft: dict, shape_launches: dict, bias_shape_launches: dict) -> list:
    """The kernels at the peft paths' shapes, each beside its bound, its
    plain version and SDPA where one call computes it: kernel 1 at
    PEFT_FLASH_CASES (prompt tuning's T + 10 rows and warm-up, prefix
    tuning's T queries over 10 + T keys at q_offset 10, the prefill at slot
    10, the 7B LoRA step at D = 128, LoRA's prefill at slot 0; each case's
    launches from PEFT_FLASH_PATHS), the fused backward (kernels 2/3) at
    PEFT_BWD_CASES' path shapes and the 7B LoRA step, the int8 decode step
    (kernel 8) at the virtual-token rollouts, the LoRA rollout and the 7B
    cell's, the paged step (kernel 7) of the LoRA engine cycle, and the T5
    LoRA cycle's bias kernels (4, 5/6). `peft` is `peft_phases`' result."""
    import torch
    import torch.nn.functional as F

    from trlx_tpu_torch.ops import decode_attention as da
    from trlx_tpu_torch.ops import flash_attention as fa

    errs, rows = peft["errs"], []
    train = {"peft_lora": peft["lora"]["static"], "peft_prompt": peft["prompt"], "peft_prefix": peft["prefix"],
             "llama_lora": peft["llama_lora"]}

    def emit_row(**row):
        rows.append(dict(route="cuda", kernel_ms=row["ms"], **row))

    def allowed_mask(mask, T, S, qo):
        allowed = (mask[:, None, None, :] > 0).expand(mask.shape[0], 1, T, S).clone()
        allowed &= (torch.arange(T, device="cuda")[:, None] + qo) >= torch.arange(S, device="cuda")[None, :]
        return allowed

    with torch.no_grad():
        for case, (B, H, Hkv, T, S, D, off, pad, causal) in PEFT_FLASH_CASES.items():
            q, k, v, mask = flash_inputs(gen, B, H, Hkv, T, S, D, off, pad)
            kw = dict(q_offset=off if pad == "prefill" else None, with_stats=True)
            _, scale, qo = fa._prepare(q, k, mask, None, kw["q_offset"], True)
            route = fa.forward_route(T, S, D)
            ms = time_ms(lambda: fa.flash_attention(q, k, v, mask, **kw))
            plain = time_ms(lambda: fa.flash_attention_plain(q, k, v, mask, **kw))
            lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=allowed_mask(mask, T, S, qo),
                                                                 scale=scale))
            bms, by = bound_ms(*flash_work(mask, H, Hkv, T, S, D, qo))
            by_path = {path: shape_launches.get(path, {}).get((route, (B, H, T), S), 0)
                       for path in PEFT_FLASH_PATHS[case]}
            emit_row(name=f"flash_fwd/peft_{case}", source="trlx_tpu_torch/csrc/flash_fwd.cu",
                     replaces="trlx_tpu/ops/flash_attention.py:84", fwd_route=route, launches=sum(by_path.values()),
                     launches_by_path=by_path, max_abs_err=errs["fwd"]["by_case"][case],
                     shape=[B, H, Hkv, T, S, D],
                     q_offset=qo, ms=ms, plain_ms=plain, plain_is="the plain forward with stats", bound_ms=bms,
                     bound_by=by, library_ms=lib, library_is="F.scaled_dot_product_attention, boolean mask",
                     occupancy=fa.flash_attention_fwd_short_occupancy(T, S, True, qo, D) if route == "short" else None)
            del q, k, v, mask

        bwd_cases = {  # name: (B, H, Hkv, T, S, q_offset, pad, D, launches, err)
            "prompt_train": PEFT_BWD_CASES["prompt_train"] + (64, train["peft_prompt"]["flash_bwd"],
                                                              errs["bwd"]["by_case"]["prompt_train"]["fused"]),
            "prefix_train": PEFT_BWD_CASES["prefix_train"] + (64, train["peft_prefix"]["flash_bwd"],
                                                              errs["bwd"]["by_case"]["prefix_train"]["fused"]),
            "lora_train": PEFT_BWD_CASES["lora_train"] + (64, train["peft_lora"]["flash_bwd"],
                                                          errs["bwd"]["by_case"]["lora_train"]["fused"]),
            "llama_lora_train": PEFT_BWD_D128_CASES["llama_lora_train"] + (
                128, train["llama_lora"]["flash_bwd"], errs["bwd_d128"]["by_case"]["llama_lora_train"]["fused"]),
        }
        for case, (B, H, Hkv, T, S, off, pad, causal, D, n, err) in bwd_cases.items():
            q, k, v, mask, out, m, l, g = flash_bwd_inputs(gen, B, H, Hkv, T, S, off, pad, True, D)
            scale = D ** -0.5
            ms = time_ms(lambda: fa.flash_attention_backward(q, k, v, mask, out, m, l, g, True, scale, off))
            plain = time_ms(lambda: fa.flash_attention_backward_plain(q, k, v, mask, out, m, l, g, True, scale, off))
            allowed = allowed_mask(mask, T, S, off)
            allowed[..., 0] |= ~allowed.any(dim=-1)  # SDPA gives NaN on a row with no open slot
            with torch.enable_grad():
                lq, lk, lv = (x.detach().clone().requires_grad_(True)
                              for x in (q, k.repeat_interleave(H // Hkv, 1), v.repeat_interleave(H // Hkv, 1)))
                lib_out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=allowed, scale=scale)
                lib = time_ms(lambda: torch.autograd.grad(lib_out, (lq, lk, lv), g, retain_graph=True))
            bms, by = bound_ms(*flash_bwd_work(mask, H, Hkv, T, S, D, off)[2])
            emit_row(name=f"flash_bwd/peft_{case}", source="trlx_tpu_torch/csrc/flash_bwd.cu",
                     replaces="trlx_tpu/ops/flash_attention.py:192", also_replaces="trlx_tpu/ops/flash_attention.py:231",
                     bwd_route=fa.backward_route(T, S, D), launches=n, max_abs_err=err, shape=[B, H, Hkv, T, S, D],
                     q_offset=off, ms=ms, plain_ms=plain, plain_is="the whole plain backward (dq, dk, dv)",
                     bound_ms=bms, bound_by=by, library_ms=lib,
                     library_is="F.scaled_dot_product_attention backward (dq, dk, dv together)",
                     occupancy=fa.flash_attention_bwd_occupancy(T, S, D))
            del q, k, v, mask, out, m, l, g, lq, lk, lv, lib_out, allowed

        written = PEFT_VIRTUAL + PROMPT_LEN + TRAIN_NEW_TOKENS
        for case, (L, B, H, Hkv, S, wr, D, n, err) in {
            # the prompt and prefix rollouts write 10 virtual slots before
            # the prompt; the LoRA rollout writes none
            "virtual_rollout": (12, TRAIN_ROLLOUTS, 12, 12, 128, written, 64,
                                sum(train[p]["decode_short"] for p in ("peft_prompt", "peft_prefix")), None),
            "lora_rollout": (12, TRAIN_ROLLOUTS, 12, 12, 128, PROMPT_LEN + TRAIN_NEW_TOKENS, 64,
                             train["peft_lora"]["decode_short"], None),
            "llama_lora_rollout": PEFT_DECODE_D128_CASES["llama_lora"] + (
                128, train["llama_lora"]["decode_short"], errs["decode_d128"]["short"]),
        }.items():
            q, ck, cv, ks, vs, mask = decode_inputs(gen, L, B, H, Hkv, S, D, wr)
            args = (q, ck, cv, ks, vs[1], mask, 1, D ** -0.5)
            ms = time_ms(lambda: da.decode_attention_int8(*args))
            plain = time_ms(lambda: da.decode_attention_int8_plain(*args))
            if err is None:  # the rollout shapes at D = 64: held here to the decode check's bar
                err = (da.decode_attention_int8(*args).float() - da.decode_attention_int8_plain(*args).float()
                       ).abs().max().item()
                if err > 2e-2:
                    raise AssertionError(f"the int8 decode step disagrees with its plain version: {err}")
            bms, by = bound_ms(*decode_work(mask, H, Hkv, S, D))
            emit_row(name=f"decode_int8_short/peft_{case}", source="trlx_tpu_torch/csrc/decode_int8.cu",
                     replaces="trlx_tpu/ops/decode_attention.py:369", kernel_route=da.decode_route(S), launches=n,
                     max_abs_err=err, shape=[L, B, H, Hkv, S, D], written=wr, ms=ms, plain_ms=plain, bound_ms=bms,
                     bound_by=by, library_ms=None, library_is="none (no single PyTorch call)")
            del q, ck, cv, ks, vs, mask

        lanes, PS, MP = 32, 16, 5
        depths = torch.randint(33, MP * PS - 4, (lanes,), generator=gen, device="cuda").tolist()
        q, _, _, pools, table, _, bias, visible = paged_inputs(gen, lanes, 1, 12, 12, PS, MP, "int8", depths)
        args = (q, pools, 1, table, bias, 64 ** -0.5)
        route = da.paged_route(1, 12, 12, PS, MP)
        ms = time_ms(lambda: da.paged_attention(*args))
        plain = time_ms(lambda: da.paged_attention_plain(*args))
        err = (da.paged_attention(*args).float() - da.paged_attention_plain(*args).float()).abs().max().item()
        if err > 2e-2:
            raise AssertionError(f"the paged step disagrees with its plain version: {err}")
        bms, by = bound_ms(*paged_work(visible, table, 12, 12, 1, PS, True))
        emit_row(name="paged_attention_short/peft_lora_engine", source="trlx_tpu_torch/csrc/paged_attention.cu",
                 replaces="trlx_tpu/ops/decode_attention.py:198", kernel_route=route,
                 launches=peft["lora"]["engine"]["paged"]["short"], max_abs_err=err, shape=[lanes, 1, 12, 12, PS, MP],
                 ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
                 library_is="none (no single PyTorch call)")
        del q, pools, table, bias, visible

        t5 = peft["t5"]
        for case in ("encoder", "decoder"):
            B, H, T, causal, kind = BIAS_CASES[case]
            q, k, v, mask, bias, out, m, l, g = flash_bias_inputs(gen, B, H, T, causal, kind)
            allowed = (mask[:, None, None, :] > 0).expand(B, H, T, T)
            if causal:
                allowed = allowed & (torch.arange(T, device="cuda")[:, None] >= torch.arange(T, device="cuda"))
            additive = (bias[None] + torch.where(allowed, 0.0, -1e30)).to(torch.bfloat16)
            works = flash_bias_work(mask, H, T, T, 64, causal)
            fwd_ms = time_ms(lambda: fa.flash_attention_bias(q, k, v, mask, bias, causal=causal, with_stats=True))
            fwd_plain = time_ms(lambda: fa.flash_attention_bias_plain(q, k, v, mask, bias, causal, 1.0, with_stats=True))
            lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=additive, scale=1.0))
            ref_out = fa.flash_attention_bias_plain(q.float(), k.float(), v.float(), mask, bias, causal, 1.0)
            fwd_err = (out.float() - ref_out).abs().max().item()
            bwd_ms = time_ms(lambda: fa.flash_attention_bias_backward(q, k, v, mask, bias, out, m, l, g, causal, 1.0))
            bwd_plain = time_ms(lambda: fa.flash_attention_bias_backward_plain(q, k, v, mask, bias, out, m, l, g,
                                                                               causal, 1.0))
            got = fa.flash_attention_bias_backward(q, k, v, mask, bias, out, m, l, g, causal, 1.0)
            want = fa.flash_attention_bias_backward_plain(q.float(), k.float(), v.float(), mask, bias, out.float(),
                                                          m, l, g.float(), causal, 1.0)
            bwd_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
            if fwd_err > 2e-2 or max(((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1.0)).item()
                                     for a, b in zip(got, want)) > 2e-2:
                raise AssertionError(f"the T5 bias kernels disagree with their plain versions ({case}): "
                                     f"{fwd_err}, {bwd_err}")
            with torch.enable_grad():
                lq, lk, lv = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
                la = additive.detach().clone().requires_grad_(True)
                lib_out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=la, scale=1.0)
                lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, (lq, lk, lv, la), g, retain_graph=True))
            tally = bias_shape_launches.get("peft_t5", {})
            shape = [B, H, T, T, 64]
            for name, ms, plain, lib, work, src, line, err, n in (
                ("flash_bias_fwd", fwd_ms, fwd_plain, lib_fwd, works[0], "flash_bias_fwd.cu", 452, fwd_err,
                 tally.get(("short", (B, H, T), T), 0)),
                ("flash_bias_bwd", bwd_ms, bwd_plain, lib_bwd, works[3], "flash_bias_bwd.cu", 550, bwd_err,
                 t5["flash_bias_bwd"] // 2),
            ):
                bms, by = bound_ms(*work)
                emit_row(name=f"{name}/peft_t5_{case}", source=f"trlx_tpu_torch/csrc/{src}",
                         replaces=f"trlx_tpu/ops/flash_attention.py:{line}", launches=n, max_abs_err=err, shape=shape,
                         causal=causal, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
                         library_is="F.scaled_dot_product_attention with the additive bias + mask in bf16",
                         **({"also_replaces": "trlx_tpu/ops/flash_attention.py:594",
                             "launches_note": "the T5 LoRA cycle's fused bias backwards, half encoder, half decoder"}
                            if name == "flash_bias_bwd" else {}))
            del q, k, v, mask, bias, out, m, l, g, lq, lk, lv, la, lib_out
    for r in rows:
        emit("kernel_time", **r)
    return rows


def flash_bwd_work(mask, H, Hkv, T, S, D, q_offset, causal=True):
    """Bytes and operations each backward function needs on this mask, in
    the way of `flash_work`. A weighed (t, s) pair costs the dq kernel
    three products (S, dP, dQ), the dk/dv kernel four (S, dP, dV, dK) and
    the whole backward five (S, dP, dQ, dK, dV), 2*D operations each per
    head; a fully masked row adds its uniform P.dO to dv over all S slots.
    Reads: q of rows with a weighed pair, dO of every row (for dv), K and V
    of weighed slots, the fp32 m and l (and delta, which the long route's
    dq kernel writes and its dk/dv kernel reads) and the int32 mask;
    writes: dq, or dk and dv, in full. Returns (dq, dkv, fused), each
    (bytes, operations): the long route's two steps, and the whole
    backward the fused kernel computes (each input read once and each
    output written once; its GQA scratch is the kernel's own choice and
    not counted)."""
    import torch

    slots = torch.arange(S, device="cuda")
    rows = torch.arange(T, device="cuda")[:, None] + q_offset
    pairs = (mask[:, None, :] > 0).expand(-1, T, -1)  # [B, T, S]
    if causal:
        pairs = pairs & (rows >= slots[None, :])[None]
    n_pairs = int(pairs.sum().item())
    n_weighed = int(pairs.any(dim=1).sum().item())
    rows_with = int(pairs.any(dim=2).sum().item())
    B = mask.shape[0]
    full_rows = B * T - rows_with
    stats = 2 * 4 * B * H * T + 4 * B * S
    fused = (2 * D * H * (rows_with + B * T) + 2 * D * Hkv * 2 * n_weighed + 2 * B * H * T * D
             + 2 * 2 * B * Hkv * S * D + stats, H * (5 * 2 * D * n_pairs + 2 * D * S * full_rows))
    stats += 4 * B * H * T  # delta
    dq = (2 * D * H * 2 * rows_with + 2 * D * Hkv * 2 * n_weighed + 2 * B * H * T * D + stats,
          H * 3 * 2 * D * n_pairs)
    dkv = (2 * D * H * (rows_with + B * T) + 2 * D * Hkv * 2 * n_weighed + 2 * 2 * B * Hkv * S * D + stats,
           H * (4 * 2 * D * n_pairs + 2 * D * S * full_rows))
    return dq, dkv, fused


def bwd_kernel_times(gen, launches, t5_launches, errs, sft_launches, ppo_launches, ilql_t5_launches,
                     dpo_launches) -> list:
    """The flash backward at the GPT-2 train path's shape (B32 H12 T=S=64,
    causal) and at T5's cross-attention shape (B12 H12, T=65 queries over
    S=32 keys, not causal, scale 1): the fused kernel, the long route's
    pair, the plain backward and SDPA's backward on the same inputs, beside
    the bounds; then the long route's two steps at T=S=512 (B4, causal),
    where it is the route the wrapper takes. `launches`, `t5_launches` and
    `sft_launches` are the GPT-2 train, T5 train and SFT paths' counts,
    `ppo_launches` {path: counts} the overlap, PPO-knobs, stop, ILQL, RFT
    and the two GRPO paths' (the SFT and those paths' steps have the train
    path's shape), `ilql_t5_launches` the T5 ILQL path's (its
    cross-attention backward: T = 33 queries over S = 32 keys),
    `dpo_launches` the DPO path's, whose steps stack 64 rows (the fused
    kernel at B64, its own row)."""
    import torch
    import torch.nn.functional as F

    from trlx_tpu_torch.ops.flash_attention import (
        backward_operands,
        flash_attention_backward_plain,
        flash_attention_bwd,
        flash_attention_bwd_occupancy,
        flash_attention_dkv,
        flash_attention_dq,
    )

    # _dq_kernel and _dkv_kernel, via _flash_backward:314 and :347
    ref = "trlx_tpu/ops/flash_attention.py:{}".format
    lib_is = "F.scaled_dot_product_attention backward (dq, dk, dv together)"
    plain_is = "the whole plain backward (dq, dk, dv)"
    rows = []

    def row(name, shape, causal, ms, plain, lib, work, line, err, **extra):
        bms, by = bound_ms(*work)
        rows.append(dict(
            name=name, route="cuda", source="trlx_tpu_torch/csrc/flash_bwd.cu", replaces=ref(line),
            launches=extra.pop("launches"), launches_train_path=launches[name.split("/")[0]],
            launches_t5_train_path=t5_launches[name.split("/")[0]],
            launches_ilql_t5_path=ilql_t5_launches[name.split("/")[0]],
            launches_sft_path=sft_launches[name.split("/")[0]],
            launches_dpo_path=dpo_launches[name.split("/")[0]],
            **{f"launches_{path}_path": n[name.split("/")[0]] for path, n in ppo_launches.items()},
            max_abs_err=err, shape=shape,
            causal=causal, ms=ms, kernel_ms=ms, plain_ms=plain, plain_is=plain_is, bound_ms=bms, bound_by=by,
            bound_bytes=work[0], bound_flops=work[1], library_ms=lib, library_is=lib_is, **extra,
        ))

    D = 64
    for case, (B, H, T, S, pad, causal) in {
        "train": (TRAIN_BATCH, 12, TRAIN_LEN, TRAIN_LEN, "left", True),
        # DPO's stacked step: right-padded rows, checked as BWD_CASES' dpo_right_pad
        "dpo": (2 * TRAIN_BATCH, 12, TRAIN_LEN, TRAIN_LEN, "right", True),
        "t5_cross": (12, 12, T5_DEC_LEN, T5_PROMPT_LEN, "left", False),
        "long": (4, 12, 512, 512, "left", True),
    }.items():
        q, k, v, mask, out, m, l, g = flash_bwd_inputs(gen, B, H, H, T, S, 0, pad, causal)
        scale = D ** -0.5 if causal else 1.0
        km, g2 = backward_operands(q, k, v, mask, g, m, l)
        if case != "long":
            fused_ms = time_ms(lambda: flash_attention_bwd(q, k, v, km, g2, m, l, causal, scale, 0))
        # the dq kernel writes the delta that the dk/dv kernel reads
        _, delta = flash_attention_dq(q, k, v, km, g2, m, l, causal, scale, 0)
        dq_ms = time_ms(lambda: flash_attention_dq(q, k, v, km, g2, m, l, causal, scale, 0))
        dkv_ms = time_ms(lambda: flash_attention_dkv(q, k, v, km, g2, m, l, delta, causal, scale, 0))
        plain = time_ms(lambda: flash_attention_backward_plain(q, k, v, mask, out, m, l, g, causal, scale, 0))
        # the library yardstick: SDPA's backward alone (dq, dk, dv together)
        # on the same inputs; its mask keeps one slot open in a fully masked
        # row, where SDPA would give NaN
        allowed = (mask[:, None, None, :] > 0).expand(B, 1, T, S).clone()
        if causal:
            allowed &= (torch.arange(T, device="cuda")[:, None] >= torch.arange(S, device="cuda")[None, :])
        allowed[..., 0] |= ~allowed.any(dim=-1)
        lq, lk, lv = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=allowed, scale=scale)
        lib = time_ms(lambda: torch.autograd.grad(lib_out, (lq, lk, lv), g, retain_graph=True))
        work_dq, work_dkv, work_fused = flash_bwd_work(mask, H, H, T, S, D, 0, causal)
        shape = [B, H, T, S, D]
        if case != "long":
            err = errs["by_case"]["dpo_right_pad"]["fused"] if case == "dpo" else errs["fused"]
            row(f"flash_bwd/{case}", shape, causal, fused_ms, plain, lib, work_fused, 192, err,
                launches={"train": launches["flash_bwd"] + sft_launches["flash_bwd"]
                          + sum(n["flash_bwd"] for n in ppo_launches.values()),
                          "dpo": dpo_launches["flash_bwd"],
                          "t5_cross": t5_launches["flash_bwd"] + ilql_t5_launches["flash_bwd"]}[case],
                also_replaces=ref(231),
                long_route_ms=dq_ms + dkv_ms, long_route_dq_ms=dq_ms, long_route_dkv_ms=dkv_ms,
                occupancy=flash_attention_bwd_occupancy(T, S))
        if case in ("train", "long"):
            suffix = "/long" if case == "long" else ""  # at the train shape: the pair the fused kernel replaced
            row(f"flash_bwd_dq{suffix}", shape, causal, dq_ms, plain, lib, work_dq, 192, errs["dq"],
                launches=launches["flash_bwd_dq"])
            row(f"flash_bwd_dkv{suffix}", shape, causal, dkv_ms, plain, lib, work_dkv, 231, errs["dkv"],
                launches=launches["flash_bwd_dkv"])
        del lq, lk, lv, lib_out
    for r in rows:
        emit("kernel_time", **r)
    return rows


def flash_bias_work(mask, H, T, S, D, causal):
    """Bytes and operations the bias kernels' functions need on this mask,
    in the way of `flash_work` and `flash_bwd_work` with the top-left
    causal rule, plus the fp32 bias entries some batch row weighs (read
    once, shared by the batch) and, for the functions that give dbias, the
    fp32 dbias written in full. Returns (fwd, dq_dbias, dkv, fused), each
    (bytes, operations): the forward, the long route's two steps (which
    pass delta between them), and the whole backward the fused kernel
    computes (each input read once and each output written once; its
    per-batch ds partial is the kernel's own choice and not counted)."""
    import torch

    cols = torch.arange(S, device="cuda")
    rows = torch.arange(T, device="cuda")[:, None]
    pairs = (mask[:, None, :] > 0).expand(-1, T, -1)  # [B, T, S]
    if causal:
        pairs = pairs & (rows >= cols[None, :])[None]
    n_pairs = int(pairs.sum().item())
    weighed = pairs.any(dim=1)  # [B, S]
    n_weighed = int(weighed.sum().item())
    row_has = pairs.any(dim=2)  # [B, T]
    rows_with = int(row_has.sum().item())
    B = mask.shape[0]
    full_rows = B * T - rows_with
    v_slots = int(torch.where(row_has.all(dim=1), weighed.sum(dim=1), S).sum().item())
    bias_bytes = 4 * H * int(pairs.any(dim=0).sum().item())
    dbias_bytes = 4 * H * T * S
    stats = 2 * 4 * B * H * T + 4 * B * S
    fwd = (2 * H * D * (n_weighed + v_slots) + 2 * 2 * B * H * T * D + stats + bias_bytes,
           H * (4 * D * n_pairs + 2 * D * S * full_rows))
    # q of the rows that attend a slot, do of every row (a row that attends
    # none still weighs dv), k and v of the weighed slots; dq, dk, dv, dbias
    fused = (2 * D * H * (rows_with + B * T) + 2 * D * H * 2 * n_weighed + 2 * B * H * T * D
             + 2 * 2 * B * H * S * D + stats + bias_bytes + dbias_bytes,
             H * (5 * 2 * D * n_pairs + 2 * D * S * full_rows))
    stats += 4 * B * H * T  # delta
    dq = (2 * D * H * 2 * rows_with + 2 * D * H * 2 * n_weighed + 2 * B * H * T * D + stats + bias_bytes
          + dbias_bytes, H * 3 * 2 * D * n_pairs)
    dkv = (2 * D * H * (rows_with + B * T) + 2 * D * H * 2 * n_weighed + 2 * 2 * B * H * S * D + stats + bias_bytes,
           H * (4 * 2 * D * n_pairs + 2 * D * S * full_rows))
    return fwd, dq, dkv, fused


def bias_kernel_times(gen, launches, path_launches, shape_launches, errs, ilql_t5_launches) -> list:
    """The bias kernels at the T5 paths' shapes (H12: the encoder's B12
    T = S = 32, not causal; the decoder's B12 T = S = 65, causal; the T5
    path's B64 encoder and decoder). The forward at all four: the route
    `bias_forward_route` names through the wrapper (the short one), the
    long route's kernel on the same inputs, the plain and library times
    beside the bound, the short kernel's CTAs an SM, and
    its launches at that shape on each path (`shape_launches`: path -> the
    `bias_fwd_shapes` tally of its run); and at T5 ILQL's decoder (B12
    T = S = 33, causal). The fused backward at the first
    two, with the long route's pair timed on the same inputs beside it;
    then the long route's two steps at T = S = 512 (B4), where it is the
    route the wrapper takes. `launches`, `path_launches` and `ilql_t5_launches` are
    the T5 train path's, the T5 path's and the T5 ILQL path's counters (the
    backward rows count both training paths). The library call is
    F.scaled_dot_product_attention with the additive float mask (the bias
    plus the key and causal masks, in bf16 as SDPA takes it), scale 1; its
    backward yields dq, dk, dv and the mask's gradient."""
    import torch
    import torch.nn.functional as F

    from trlx_tpu_torch.ops.flash_attention import (
        _check_bias,
        backward_operands,
        bias_forward_route,
        flash_attention_bias,
        flash_attention_bias_backward_plain,
        flash_attention_bias_bwd,
        flash_attention_bias_bwd_occupancy,
        flash_attention_bias_dkv,
        flash_attention_bias_dq,
        flash_attention_bias_fwd_long,
        flash_attention_bias_plain,
        flash_bias_fwd_short_occupancy,
    )

    # _flash_bias_kernel via _flash_bias_forward:517; _dq_dbias_kernel and
    # _dkv_bias_kernel via _flash_bias_backward:665 and :703
    ref = "trlx_tpu/ops/flash_attention.py:{}".format
    rows = []

    def row(name, case, shape, causal, ms, plain, lib, work, src, line, err, plain_is, library_is, **extra):
        bms, by = bound_ms(*work)
        r = dict(
            name=f"{name}/{case}", route="cuda", source=f"trlx_tpu_torch/csrc/{src}", replaces=ref(line),
            launches=launches.get(name, 0) + ilql_t5_launches.get(name, 0), launches_t5_path=path_launches.get(name, 0),
            launches_ilql_t5_path=ilql_t5_launches.get(name, 0), max_abs_err=err,
            shape=shape, causal=causal, ms=ms, kernel_ms=ms, plain_ms=plain, plain_is=plain_is,
            bound_ms=bms, bound_by=by, bound_bytes=work[0], bound_flops=work[1], library_ms=lib,
            library_is=library_is,
        )
        r.update(extra)
        rows.append(r)

    lib_bwd_is = "F.scaled_dot_product_attention backward (dq, dk, dv, dmask together)"
    for case in ("encoder", "decoder", "b64_encoder", "b64", "ilql_decoder", "long"):
        B, H, T, causal, kind = BIAS_CASES[case]
        q, k, v, mask, bias, out, m, l, g = flash_bias_inputs(gen, B, H, T, causal, kind)
        km, g2 = backward_operands(q, k, v, mask, g, m, l)
        bias32 = _check_bias(q, k, bias, causal)
        allowed = (mask[:, None, None, :] > 0).expand(B, H, T, T)
        if causal:
            allowed = allowed & (torch.arange(T, device="cuda")[:, None] >= torch.arange(T, device="cuda"))
        additive = (bias[None] + torch.where(allowed, 0.0, -1e30)).to(torch.bfloat16)
        works = flash_bias_work(mask, H, T, T, 64, causal)
        shape = [B, H, T, T, 64]
        if case != "long":
            route = bias_forward_route(T, T)
            with torch.no_grad():
                fwd_ms = time_ms(lambda: flash_attention_bias(q, k, v, mask, bias, causal=causal, with_stats=True))
                long_ms = time_ms(lambda: flash_attention_bias_fwd_long(q, k, v, km, bias32, causal, 1.0))
                fwd_plain = time_ms(lambda: flash_attention_bias_plain(q, k, v, mask, bias, causal, 1.0,
                                                                       with_stats=True))
                lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=additive, scale=1.0))
            by_path = {path: tally.get((route, (B, H, T), T), 0) for path, tally in shape_launches.items()}
            row("flash_bias_fwd", case, shape, causal, fwd_ms, fwd_plain, lib_fwd, works[0], "flash_bias_fwd.cu",
                452, errs[f"fwd_{route}"], "the plain forward with stats",
                "F.scaled_dot_product_attention, additive bf16 mask, forward", fwd_route=route,
                launches=sum(by_path.values()), launches_by_path=by_path, long_route_ms=long_ms,
                long_route_max_abs_err=errs["fwd_long"],
                occupancy=flash_bias_fwd_short_occupancy(T, T, causal) if route == "short" else None)
        if case.startswith("b64") or case == "ilql_decoder":
            continue
        if case != "long":
            fused_ms = time_ms(lambda: flash_attention_bias_bwd(q, k, v, km, bias32, g2, m, l, causal, 1.0))
        # the dq kernel writes the delta that the dk/dv kernel reads
        delta = flash_attention_bias_dq(q, k, v, km, bias32, g2, m, l, causal, 1.0)[2]
        dq_ms = time_ms(lambda: flash_attention_bias_dq(q, k, v, km, bias32, g2, m, l, causal, 1.0))
        dkv_ms = time_ms(lambda: flash_attention_bias_dkv(q, k, v, km, bias32, g2, m, l, delta, causal, 1.0))
        bwd_plain = time_ms(lambda: flash_attention_bias_backward_plain(
            q, k, v, mask, bias, out, m, l, g, causal, 1.0))
        lq, lk, lv, lm = (x.detach().clone().requires_grad_(True) for x in (q, k, v, additive))
        lib_out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lm, scale=1.0)
        lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, (lq, lk, lv, lm), g, retain_graph=True))
        if case != "long":
            row("flash_bias_bwd", case, shape, causal, fused_ms, bwd_plain, lib_bwd, works[3], "flash_bias_bwd.cu",
                550, errs["fused"], "the whole plain backward", lib_bwd_is,
                also_replaces=ref(594), long_route_ms=dq_ms + dkv_ms, long_route_dq_ms=dq_ms,
                long_route_dkv_ms=dkv_ms, occupancy=flash_attention_bias_bwd_occupancy(T, T))
        else:
            row("flash_bias_bwd_dq", case, shape, causal, dq_ms, bwd_plain, lib_bwd, works[1], "flash_bias_bwd.cu",
                550, errs["dq_dbias"], "the whole plain backward", lib_bwd_is)
            row("flash_bias_bwd_dkv", case, shape, causal, dkv_ms, bwd_plain, lib_bwd, works[2],
                "flash_bias_bwd.cu", 594, errs["dkv"], "the whole plain backward", lib_bwd_is)
        del lq, lk, lv, lm, lib_out
    for r in rows:
        emit("kernel_time", **r)
    return rows


def profile_phase(name: str, fn, wall_s: float, grad: bool = False, host_ops: bool = True,
                  out: dict = None) -> float:
    """Device time by kernel over one traced run of `fn` (torch.profiler);
    returns the device's busy ms (and puts the printed sums into `out`
    when given). The idle share compares the traced
    device time with the untraced wall time `wall_s` of the same work. `host_ops=False` traces the device
    alone: a run of many thousand host operations (the engine's loop)
    makes a host trace slow to gather and adds nothing to the device sums."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
    with torch.set_grad_enabled(grad), profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    # a user annotation (the optimizer's `Optimizer.step#AdamW.step` range)
    # spans kernels that are listed on their own: counting it too would
    # count their time twice
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
        and not getattr(e, "is_user_annotation", False)
    ]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]

    def share(*words):
        return sum(e.self_device_time_total for e in kernels if any(w in e.key for w in words)) / 1e3

    sums = dict(
        wall_ms=wall_s * 1e3, device_busy_ms=busy_ms,
        device_idle_share=(1 - busy_ms / (wall_s * 1e3)) if busy_ms else None,
        attention_kernels_ms=share("flash_fwd_kernel", "flash_fwd_short_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                                   "flash_bwd_fused_kernel", "decode_int8_kernel", "decode_int8_short_kernel",
                                   "paged_attention_kernel",
                                   "paged_attention_short_kernel",
                                   "flash_bias_"),
        flash_fwd_kernels_ms=share("flash_fwd_kernel", "flash_fwd_short_kernel"),
        flash_bias_kernels_ms=share("flash_bias_"),
        paged_kernel_ms=share("paged_attention_kernel", "paged_attention_short_kernel"),
        decode_kernel_ms=share("decode_int8_kernel", "decode_int8_short_kernel"),
        flash_bwd_kernels_ms=share("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel", "flash_bwd_fused_kernel"),
        adam8bit_kernel_ms=share("adam8bit"),
        matmul_ms=share("gemm", "Gemm", "xmma", "nvjet", "cutlass"),
        top=[dict(kernel=e.key[:90], ms=e.self_device_time_total / 1e3, calls=e.count) for e in top])
    emit("profile", what=name, **sums)
    if out is not None:
        out.update(sums)
    return busy_ms


@contextlib.contextmanager
def kernel_shapes(tallies: dict, path: str, helper: str, short_fn: str):
    """Counts the launches that go through the launch helper `helper` of
    `ops/flash_attention.py` by (route, [B, H, T], S) into tallies[path]
    while active (route "short" for the C entry `short_fn`, else "long");
    the wrappers' own counters are untouched."""
    from trlx_tpu_torch.ops import flash_attention as fa

    tally = tallies.setdefault(path, collections.Counter())
    launch = getattr(fa, helper)

    def counted(fn_name, q, k, *args):
        route = "short" if fn_name == short_fn else "long"
        tally[route, tuple(q.shape[:3]), k.shape[2]] += 1
        return launch(fn_name, q, k, *args)

    setattr(fa, helper, counted)
    try:
        yield tally
    finally:
        setattr(fa, helper, launch)


def forward_shapes(tallies: dict, path: str):
    """The flash forward's (kernel 1's) launches by shape (kernel_shapes)."""
    return kernel_shapes(tallies, path, "_forward_kernel", "flash_fwd_short_bf16")


def bias_fwd_shapes(tallies: dict, path: str):
    """The bias forward's (kernel 4's) launches by shape (kernel_shapes)."""
    return kernel_shapes(tallies, path, "_bias_forward_kernel", "flash_bias_fwd_short_bf16")


def fwd_kernel_times(gen, shape_launches, errs) -> list:
    """Kernel 1 at the shapes the paths launch it at: the rollout prefill
    (B64 T32 over a 128-slot cache, at its write index) and the same at
    B32 (the train and SFT paths' evaluations and the engine's refills on
    the train-engine path), the rollout path's teacher-forced pass (B64
    T=S=72), the train and SFT paths' train steps (B32 T=S=64) and experience
    passes (B64 T=S=64), and T5's cross-attention in training (B12, T=65
    over S=32, not causal, scale 1). At each: the route
    `forward_route` names through the wrapper, the long route's kernel on
    the same inputs, the plain version and SDPA (its mask from the key and
    causal masks; a fully masked row gives NaN there, which does not move
    its time), beside the bound, the short kernel's CTAs an SM, and the
    launches at that shape on each path (`shape_launches`: path -> the
    `forward_shapes` tally of its run)."""
    import torch
    import torch.nn.functional as F

    from trlx_tpu_torch.ops import flash_attention as fa

    shapes = {  # name: (B, H, T, S, q_offset, pad, causal)
        "prefill": (PROMPTS, 12, PROMPT_LEN, 128, 0, "prefill", True),
        "prefill_b32": (TRAIN_BATCH, 12, PROMPT_LEN, 128, 0, "prefill", True),
        "teacher_forced": (PROMPTS, 12, PROMPT_LEN + NEW_TOKENS, PROMPT_LEN + NEW_TOKENS, 0, "left", True),
        "train": (TRAIN_BATCH, 12, TRAIN_LEN, TRAIN_LEN, 0, "left", True),
        "experience": (TRAIN_ROLLOUTS, 12, TRAIN_LEN, TRAIN_LEN, 0, "left", True),
        "t5_cross": (T5_BATCH, 12, T5_DEC_LEN, T5_PROMPT_LEN, 0, "left", False),
        # RFT's sampling prefill (16 prompts) and T5 ILQL's cross-attention in training
        "prefill_b16": (len(RFT_PROMPTS), 12, PROMPT_LEN, 128, 0, "prefill", True),
        "t5_ilql_cross": (ILQL_T5_BATCH, 12, 33, T5_PROMPT_LEN, 0, "left", False),
    }
    rows, D = [], 64
    with torch.no_grad():
        for case, (B, H, T, S, off, pad, causal) in shapes.items():
            q, k, v, mask = flash_inputs(gen, B, H, H, T, S, D, off, pad)
            kw = dict(q_offset=off if pad == "prefill" else None, with_stats=True, causal=causal,
                      sm_scale=None if causal else 1.0)
            km = fa._check_inputs(q, k, v, mask)
            _, scale, qo = fa._prepare(q, k, mask, kw["sm_scale"], kw["q_offset"], causal)
            route = fa.forward_route(T, S)
            allowed = (mask[:, None, None, :] > 0).expand(B, 1, T, S)
            if causal:
                allowed = allowed & ((torch.arange(T, device="cuda")[:, None] + qo)
                                     >= torch.arange(S, device="cuda")[None, :])
            ms = time_ms(lambda: fa.flash_attention(q, k, v, mask, **kw))
            long_ms = time_ms(lambda: fa.flash_attention_fwd_long(q, k, v, km, causal, scale, qo))
            plain = time_ms(lambda: fa.flash_attention_plain(q, k, v, mask, **kw))
            lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=allowed, scale=scale))
            n_bytes, n_flops = flash_work(mask, H, H, T, S, D, qo, causal)
            bms, by = bound_ms(n_bytes, n_flops)
            by_path = {path: tally.get((route, (B, H, T), S), 0) for path, tally in shape_launches.items()}
            rows.append(dict(
                name=f"flash_fwd/{case}", route="cuda", source="trlx_tpu_torch/csrc/flash_fwd.cu",
                replaces="trlx_tpu/ops/flash_attention.py:84",  # _flash_kernel, via _flash_forward:161
                fwd_route=route, launches=sum(by_path.values()), launches_by_path=by_path,
                max_abs_err=errs[route], shape=[B, H, T, S, D], causal=causal, ms=ms, kernel_ms=ms,
                long_route_ms=long_ms, long_route_max_abs_err=errs["long"], plain_ms=plain,
                plain_is="the plain forward with stats", bound_ms=bms, bound_by=by, bound_bytes=n_bytes,
                bound_flops=n_flops, library_ms=lib, library_is="F.scaled_dot_product_attention, boolean mask",
                occupancy=fa.flash_attention_fwd_short_occupancy(T, S, causal, qo) if route == "short" else None,
            ))
    for row in rows:
        emit("kernel_time", **row)
    return rows


def decode_kernel_times(gen, launches, errs) -> list:
    """The int8 decode step at the rollout path's shape (L4 B64 H12, a
    128-slot cache, 72 slots written, random left pads), the train path's
    (64 written) and the SFT path's evaluations (B32, 64 written after 31
    pad slots: a BOS prompt): the short kernel, the route the paths take, beside
    the long kernel on the same inputs, the bound, the short kernel's CTAs
    an SM and the plain version; then the long route alone at S = 512 (400
    written), which no path runs. `launches` is {path: {route: n}}. No
    single PyTorch call computes attention over an int8 cache with folded
    per-slot and per-channel scales, so there is no library time."""
    import torch

    from trlx_tpu_torch.ops.decode_attention import (
        decode_attention_int8_long,
        decode_attention_int8_occupancy,
        decode_attention_int8_plain,
        decode_attention_int8_short,
        decode_route,
    )

    rows = []
    L, H, D = EARLIER_LAYERS, 12, 64
    by_path = {path: launches.get(path, {"short": 0, "long": 0})
               for path in ("rollout", "train", "sft", "overlap", "ppo_knobs", "stop", "resume", "ilql", "rft", "grpo",
                            "grpo_engine", "dpo")}

    def row(name, route, S, written, B=PROMPTS, pads=None):
        q, ck, cv, ks, vs, mask = decode_inputs(gen, L, B, H, H, S, D, written, pads)
        if decode_route(S) != route:
            raise AssertionError(f"{name}: decode_route does not name the {route} route")
        args = (q, ck, cv, ks, vs[L - 1], mask, L - 1, D ** -0.5)
        kernel = decode_attention_int8_short if route == "short" else decode_attention_int8_long
        ms = time_ms(lambda: kernel(*args))
        extra = {"long_ms": time_ms(lambda: decode_attention_int8_long(*args))} if route == "short" else {}
        plain = time_ms(lambda: decode_attention_int8_plain(*args))
        n_bytes, n_flops = decode_work(mask, H, H, S, D)
        bms, by = bound_ms(n_bytes, n_flops)
        occupancy = decode_attention_int8_occupancy(route, H, H, S)
        rows.append(dict(
            name=name, route="cuda", kernel_route=route, source="trlx_tpu_torch/csrc/decode_int8.cu",
            replaces="trlx_tpu/ops/decode_attention.py:369",  # _decode_kernel, via decode_attention_int8:418
            launches=by_path["sft" if name.endswith("/sft") else "rollout"][route],
            launches_train_path=by_path["train"][route], launches_sft_path=by_path["sft"][route],
            launches_overlap_path=by_path["overlap"][route], launches_ppo_knobs_path=by_path["ppo_knobs"][route],
            launches_stop_path=by_path["stop"][route], launches_resume_path=by_path["resume"][route],
            launches_ilql_path=by_path["ilql"][route],
            launches_rft_path=by_path["rft"][route], launches_grpo_path=by_path["grpo"][route],
            launches_grpo_engine_path=by_path["grpo_engine"][route], launches_dpo_path=by_path["dpo"][route],
            max_abs_err=errs[route], shape=[L, B, H, S, D], written=written, ms=ms, kernel_ms=ms, **extra,
            plain_ms=plain, bound_ms=bms, bound_by=by, bound_bytes=n_bytes, bound_flops=n_flops,
            library_ms=None, ctas_per_sm=occupancy["ctas_per_sm"], smem_bytes=occupancy["smem_bytes"],
        ))
        del q, ck, cv, ks, vs, mask

    with torch.no_grad():
        row("decode_int8_short/rollout", "short", 128, PROMPT_LEN + NEW_TOKENS)
        row("decode_int8_short/train", "short", 128, TRAIN_LEN)
        row("decode_int8_short/sft", "short", 128, SFT_SEQ, B=SFT_BATCH, pads=SFT_SEQ - SFT_NEW_TOKENS - 1)
        row("decode_int8/s512", "long", 512, 400)
    for r in rows:
        emit("kernel_time", **r)
    return rows


def paged_kernel_times(gen, launches, errs) -> list:
    """The paged step at the engine's shapes in the training workload (32
    lanes, 12 heads, 16-token int8 pages, 5 pages a lane): a decode step
    (T 1) and a speculative verify (T 4), on ragged lane depths and each
    lane's own table, through `paged_attention` (the short route there),
    beside the long kernel on the same inputs, its bound, its CTAs an SM
    and its plain version; then the long route alone at 32 lanes x 1024
    slots (PS 16, MP 64, depths 768-1019), which no path runs yet.
    `launches` is {path: {route: n}}. No single PyTorch call computes
    attention over int8 pages with per-row scales, so there is no library
    time."""
    import torch

    from trlx_tpu_torch.ops.decode_attention import (
        paged_attention,
        paged_attention_long,
        paged_attention_occupancy,
        paged_attention_plain,
        paged_route,
    )

    rows = []
    B, H = 32, 12

    def row(name, route, T, PS, MP, depths, **extra):
        q, _, _, pools, table, _, bias, visible = paged_inputs(gen, B, T, H, H, PS, MP, "int8", depths)
        if paged_route(T, H, H, PS, MP) != route:
            raise AssertionError(f"{name}: paged_route does not name the {route} route")
        ms = time_ms(lambda: paged_attention(q, pools, 5, table, bias, 64 ** -0.5))
        plain = time_ms(lambda: paged_attention_plain(q, pools, 5, table, bias, 64 ** -0.5))
        if route == "short":
            extra["long_ms"] = time_ms(lambda: paged_attention_long(q, pools, 5, table, bias, 64 ** -0.5))
        n_bytes, n_flops = paged_work(visible, table, H, H, T, PS, True)
        bms, by = bound_ms(n_bytes, n_flops)
        occupancy = paged_attention_occupancy(route, T, H, H, PS, MP, True)
        rows.append(dict(
            name=name, route="cuda", kernel_route=route, source="trlx_tpu_torch/csrc/paged_attention.cu",
            replaces="trlx_tpu/ops/decode_attention.py:198",  # _paged_kernel, via paged_attention_pallas:268
            max_abs_err=errs[route], shape=[B, T, H, PS, MP, 64], ms=ms, kernel_ms=ms, plain_ms=plain,
            bound_ms=bms, bound_by=by, bound_bytes=n_bytes, bound_flops=n_flops, library_ms=None,
            ctas_per_sm=occupancy["ctas_per_sm"], smem_bytes=occupancy["smem_bytes"], **extra,
        ))

    by_path = {path: launches.get(path, {"short": 0, "long": 0})
               for path in ("engine_plain", "engine_spec", "train_engine", "grpo_engine")}
    PS, MP = 16, 5
    depths = torch.randint(33, MP * PS - 4, (B,), generator=gen, device="cuda").tolist()
    with torch.no_grad():
        for name, T in (("paged_attention/decode", 1), ("paged_attention/verify", 4)):
            row(name, "short", T, PS, MP, depths,
                launches=by_path["engine_plain"]["short"] + by_path["engine_spec"]["short"],
                launches_engine_path=by_path["engine_plain"], launches_engine_spec_path=by_path["engine_spec"],
                launches_train_engine_path=by_path["train_engine"], launches_grpo_engine_path=by_path["grpo_engine"])
        long_depths = torch.randint(768, 1020, (B,), generator=gen, device="cuda").tolist()
        row("paged_attention_long/decode_1024", "long", 1, 16, 64, long_depths,
            launches=by_path["engine_plain"]["long"] + by_path["engine_spec"]["long"],
            launches_train_engine_path=by_path["train_engine"]["long"],
            launches_grpo_engine_path=by_path["grpo_engine"]["long"])
    for r in rows:
        emit("kernel_time", **r)
    return rows


# ---------------------------------------------------------------------------
# the single-chip memory recipe (slice 12): kernels 9 and 10, the recipe PPO
# cell and full-parameter Llama-2-7B
# ---------------------------------------------------------------------------

FP32_FLOPS = 67e12  # H100 SXM fp32 peak outside the tensor cores (kernel 9's arithmetic)
# kernel 9's fp32 operations an element: two dequantisations (4 each), the
# moment updates (3 + 4), the step (5), the decay and the write (2 + 2), two
# absmax terms (2) and two requantisations (6 each)
ADAM8_OPS_PER_ELEMENT = 38
# kernel 9's leaves: a Llama-2-7B MLP kernel, GPT-2's fused qkv width, a
# leaf of 77,000 elements, which is no whole number of 256-element blocks,
# one under one block, a Llama-2-7B norm weight, and the ragged leaf again
# with every operand a view ADAM8_OFFSET elements into its buffer (not
# 16- or 8-byte aligned: the kernel's scalar path)
ADAM8_LEAVES = {"llama_mlp": (4096, 11008), "gpt2_qkv": (768, 2304), "ragged": (1000, 77), "sub_block": (100,),
                "norm": (4096,), "misaligned": (1000, 77)}
ADAM8_OFFSET = {"misaligned": 1}
ADAM8_STEPS, ADAM8_LR, ADAM8_WD = 3, 1e-3, 0.01
ADAM8_LSB_SHARE = 1e-3  # the share of payload entries allowed one LSB from the plain version's
# kernel 10's widths (K -> N): GPT-2 small's projections (T5-base's decoder
# has 768 -> 768, 768 -> 3072 and 3072 -> 768 too) and Llama-2-7B's
INT8MM_WIDTHS = {"gpt2_qkv": (768, 2304), "d768": (768, 768), "d768_ff": (768, 3072), "ff_d768": (3072, 768),
                 "llama_attn": (4096, 4096), "llama_fc_in": (4096, 11008), "llama_fc_out": (11008, 4096)}
INT8MM_ROWS = {"decode": PROMPTS, "prefill": PROMPTS * PROMPT_LEN}  # 64 rows, and 64 prompts x 32
INT8MM_EDGE_ROWS = (1, 8, 33)  # odd row counts, at llama_fc_in
# kernel 10's tilings (`int8_matmul_route`) each at least once, the wgmma
# route's K splits 1, 2, 4 and 8 too, with the K tail (776, 4104: not
# whole 64- or 256-deep stages), a ragged last channel tile (2320 = 18 x
# 128 + 16) and row counts that end mid-tile
INT8MM_ROUTE_CASES = ((8, 4096, 4096), (1, 4104, 768), (16, 768, 768), (16, 4096, 11008), (32, 768, 2304),
                      (32, 4096, 11008), (33, 776, 2320), (64, 4096, 11008), (100, 776, 2320), (1024, 4096, 4096),
                      (300, 4104, 2320), (128, 4096, 768), (3840, 4096, 4096))
# the (M, K, N) the recipe and 7B cells launch kernel 10 at: `--only w8a16`
# times these without running the cells (the full run times the shapes the
# cells launched, with their launches)
W8A16_PATH_SHAPES = (
    (8, 4096, 4096), (8, 4096, 11008), (8, 11008, 4096), (3840, 4096, 4096), (3840, 4096, 11008),
    (3840, 11008, 4096), (64, 768, 768), (64, 768, 3072), (64, 3072, 768), (32, 768, 768), (32, 768, 3072),
    (32, 3072, 768), (2048, 768, 768), (2048, 768, 3072), (2048, 3072, 768), (1024, 768, 768), (1024, 768, 3072),
    (1024, 3072, 768))
# the recipe PPO cell: train_path's workload with the recipe applied and two
# microbatches a step
RECIPE_FILE = "configs/mesh/single_chip_1p3b.yml"
RECIPE_MINIBATCH = 16
RECIPE_GREEDY_AGREEMENT = 0.95
# the 7B cell: full-parameter SFT at Llama-2-7B's widths and all 32 layers,
# batch 8 of 512 tokens, 3 steps on one fixed batch, then an evaluation of 32
# prompts x 32 new tokens on int8 decode weights
LLAMA_FULL_BATCH, LLAMA_FULL_LEN, LLAMA_FULL_STEPS = 8, 512, 3
LLAMA_FULL_EVAL_PROMPTS, LLAMA_FULL_NEW_TOKENS = 32, 32
# Adam's first steps move every weight by about lr (no warm-up): on the
# fixed batch the random 7B model's loss went 11.19 -> 14.38 -> 29.45 at
# lr 1e-4, -> 9.09 -> 11.08 at 1e-5, -> 5.199 -> 5.201 at 3e-6 and ->
# 6.99 -> 4.80 at 1e-6 (H100), the same within 0.2% with fp32 gradients,
# and at 4 layers torch's AdamW with fp32 gradients tracks the recipe
# (scripts/torch_llama_full_lr_witness.py): the rises are the optimizer's
# dynamics at these rates, so the cell runs at 1e-6 and its loss must fall
# at every step
LLAMA_FULL_LR = 1e-6
LLAMA_FULL_PEAK_BYTES = 66e9
# the recipe's state at Llama-2-7B's 6.74 B parameters, in GB: fp32 masters,
# bf16 gradients, the two int8 moments, their fp32 scales (one per 256)
LLAMA_FULL_STATE_GB = {"fp32_masters": 26.95, "bf16_gradients": 13.48, "int8_moments": 13.48,
                       "block_scales": 0.21, "total": 54.1}


def memory_counters() -> dict:
    """The training kernels' counters and kernels 9 and 10's."""
    from trlx_tpu_torch.ops import adam8bit, int8_matmul

    return {**train_counters(), "adam8bit": adam8bit.adam8bit_step,
            "int8_matmul": int8_matmul.int8_weight_matmul, "int8_matmul_stream": int8_matmul.int8_weight_matmul_stream,
            "int8_matmul_wgmma": int8_matmul.int8_weight_matmul_wgmma}


@contextlib.contextmanager
def int8_matmul_shapes(tally: collections.Counter):
    """Counts kernel 10's launches from the models by (M, K, N) while
    active (QDense imports the wrapper by name)."""
    from trlx_tpu_torch.models import transformer

    fn = transformer.int8_weight_matmul

    def counted(x, q, s):
        if x.is_cuda:
            tally[x.numel() // x.shape[-1], q.shape[0], q.shape[1]] += 1
        return fn(x, q, s)

    transformer.int8_weight_matmul = counted
    try:
        yield tally
    finally:
        transformer.int8_weight_matmul = fn


def adam8bit_zero_state(p) -> list:
    """A leaf's zero moments as kernel 9's state arguments."""
    from trlx_tpu_torch.ops import adam8bit as a8

    st = a8.zero_state(p)
    return [st[k] for k in a8.LEAF_STATE]


def _offset_copy(x, offset: int):
    """A contiguous copy of `x` that starts `offset` elements into a buffer
    of its own (so its data pointer is that many elements past an
    allocation's start)."""
    import torch

    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    return buf[offset:].view(x.shape).copy_(x)


def check_adam8bit(gen) -> dict:
    """Kernel 9 against its plain version: each ADAM8_LEAVES leaf, fp32 and
    bf16 gradients, the fused and the bnb variant, each with weight decay
    ADAM8_WD and without (the kernel's four update variants), ADAM8_STEPS
    steps from zero moments, both paths on the same gradients (the
    kernel's operands of an ADAM8_OFFSET leaf views off their buffers'
    alignment). Gates after every step: parameters within 1e-6 relative
    (to max(|p|, lr), so that a weight the step carried near zero is held
    to the update's size), scales within 1e-6 relative, payloads at most
    one LSB apart in at most ADAM8_LSB_SHARE of the entries. Each case
    also reports whether every step was bit for bit (parameters, payloads
    and scales). Returns the worst errors."""
    import torch

    from trlx_tpu_torch.ops import adam8bit as a8

    cases, worst = [], {"param_rel": 0.0, "scale_rel": 0.0, "payload_lsb_share": 0.0, "payload_max_lsb": 0}
    for leaf, shape in ADAM8_LEAVES.items():
        off = ADAM8_OFFSET.get(leaf, 0)
        for gdt, bnb, wd in itertools.product((torch.float32, torch.bfloat16), (False, True), (ADAM8_WD, 0.0)):
            p0 = torch.randn(shape, generator=gen, device="cuda") * 0.02
            pk, sk = _offset_copy(p0, off), [_offset_copy(x, off) for x in adam8bit_zero_state(p0)]
            pp, sp = p0.clone(), adam8bit_zero_state(p0)
            errs, bitwise = [], True
            for step in range(1, ADAM8_STEPS + 1):
                g = (torch.randn(shape, generator=gen, device="cuda") * 1e-2).to(gdt)
                args = (ADAM8_LR, 0.9, 0.999, 1e-8, wd, *a8.bias_corrections(0.9, 0.999, step))
                a8.adam8bit_step(pk, _offset_copy(g, off), *sk, *args, bnb=bnb)
                a8.adam8bit_step_plain(pp, g, *sp, *args, bnb=bnb)
                torch.cuda.synchronize()

                def rel(a, b):
                    return ((a - b).abs() / b.abs().clamp(min=1e-30)).max().item()

                lsb = [(qk.int() - qp.int()).abs() for qk, qp in ((sk[0], sp[0]), (sk[2], sp[2]))]
                p_rel = ((pk - pp).abs() / pp.abs().clamp(min=ADAM8_LR)).max().item()
                e = {"param_rel": p_rel, "scale_rel": max(rel(sk[1], sp[1]), rel(sk[3], sp[3])),
                     "payload_lsb_share": max((d > 0).float().mean().item() for d in lsb),
                     "payload_max_lsb": max(int(d.max()) for d in lsb)}
                errs.append(e)
                bitwise = bitwise and torch.equal(pk, pp) and all(torch.equal(a, b) for a, b in zip(sk, sp))
                for k, v in e.items():
                    worst[k] = max(worst[k], v)
                if (e["param_rel"] > 1e-6 or e["scale_rel"] > 1e-6 or e["payload_max_lsb"] > 1
                        or e["payload_lsb_share"] > ADAM8_LSB_SHARE):
                    raise AssertionError(f"kernel 9 disagrees with its plain version at {leaf} {gdt} "
                                         f"bnb={bnb} wd={wd} step {step}: {e}")
            cases.append({"leaf": leaf, "shape": list(shape), "offset": off, "grad_dtype": str(gdt), "bnb": bnb,
                          "weight_decay": wd, "bitwise": bitwise, "errs": errs})
    all_bitwise = all(c["bitwise"] for c in cases)
    emit("adam8bit_check", cases=cases, worst=worst, all_bitwise=all_bitwise)
    # each leaf's own worst parameter error with a bf16 gradient, fused
    # variant with decay (its kernel_time row's case)
    by_leaf = {c["leaf"]: max(e["param_rel"] for e in c["errs"]) for c in cases
               if c["grad_dtype"] == str(torch.bfloat16) and not c["bnb"] and c["weight_decay"] == ADAM8_WD}
    return dict(worst, by_leaf=by_leaf, all_bitwise=all_bitwise)


def int8_matmul_error(x, q, s) -> dict:
    """Kernel 10 on (x, q, s) against the dequantize-then-fp32 product:
    every output within half a bf16 ulp of the fp32 product (2^-8 of its
    size, plus 1e-5 of the largest for the fp32 sum's order), and a second
    call on the same inputs equal bit for bit, raised otherwise; the
    port's plain version beside it."""
    import torch

    from trlx_tpu_torch.ops import int8_matmul as im

    M, (K, N) = x.shape[0], q.shape
    y16 = im.int8_weight_matmul(x, q, s)
    again = im.int8_weight_matmul(x, q, s)
    y = y16.float()
    ref = torch.matmul(x.float(), q.float()) * s
    plain = im.int8_weight_matmul_plain(x, q, s).float()
    torch.cuda.synchronize()
    allowed = 2.0 ** -8 * ref.abs() + 1e-5 * ref.abs().max()
    e = {"M": M, "K": K, "N": N, "route": list(im.int8_matmul_route(M, N, K)),
         "rel_to_half_ulp": ((y - ref).abs() / allowed).max().item(),
         "max_abs_err": (y - ref).abs().max().item(), "vs_plain_max_abs": (y - plain).abs().max().item(),
         "bitwise_repeat": bool(torch.equal(y16, again))}
    if not e["rel_to_half_ulp"] <= 1.0:
        raise AssertionError(f"kernel 10 strays from the fp32 product by more than half a bf16 ulp: {e}")
    if not e["bitwise_repeat"]:
        raise AssertionError(f"kernel 10 gave other bits on a second call with the same inputs: {e}")
    return e


def check_int8_matmul(gen) -> dict:
    """Kernel 10 against the plain dequantize-then-fp32 product rounded once
    to bf16 (`int8_matmul_error`, a second call bit for bit), at every
    INT8MM_WIDTHS width and INT8MM_ROWS row count, at INT8MM_EDGE_ROWS rows
    of llama_fc_in and at INT8MM_ROUTE_CASES, which must reach every
    tiling of both routes (`int8_matmul_tilings`). The paths' own shapes
    are checked again after they ran (`memory_kernel_times`). Returns the
    worst errors."""
    import torch

    from trlx_tpu_torch.ops import int8_matmul as im

    cases = [(name, M, K, N) for name, (K, N) in INT8MM_WIDTHS.items() for M in INT8MM_ROWS.values()]
    cases += [("llama_fc_in", M, *INT8MM_WIDTHS["llama_fc_in"]) for M in INT8MM_EDGE_ROWS]
    cases += [("route", M, K, N) for M, K, N in INT8MM_ROUTE_CASES]
    routes = [im.int8_matmul_route(M, N, K) for _, M, K, N in cases]
    missing = set(im.int8_matmul_tilings()) - {r[:3] for r in routes}
    missing |= {("wgmma split", n) for n in (1, 2, 4, 8)} - {("wgmma split", r[3]) for r in routes if r[0] == "wgmma"}
    if missing:
        raise AssertionError(f"kernel 10's check misses tilings {missing}")
    out, worst = [], {"rel_to_half_ulp": 0.0, "vs_plain_max_abs": 0.0}
    for name, M, K, N in cases:
        x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn((K, N), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
        q, s = im.quantize_kernel(w)
        e = dict(name=name, **int8_matmul_error(x, q, s))
        out.append(e)
        worst["rel_to_half_ulp"] = max(worst["rel_to_half_ulp"], e["rel_to_half_ulp"])
        worst["vs_plain_max_abs"] = max(worst["vs_plain_max_abs"], e["vs_plain_max_abs"])
    emit("int8_matmul_check", cases=out, worst=worst)
    return worst


def recipe_config(seed: int, attention_impl="pallas", kv_cache_quant="int8_kernel", compute_dtype="bfloat16",
                  decode_weights_quant="int8"):
    """train_path's config with `configs/mesh/single_chip_1p3b.yml` applied
    unchanged (bf16 compute, logit_chunks 8, bf16 gradients, remat full,
    num_layers_unfrozen 2, the int8 KV cache and int8 decode weights, the
    fused 8-bit AdamW), then train.minibatch_size 16 (two microbatches a
    step). The recipe's kv_cache_quant "int8" decodes its int8 cache through
    the plain folded math; the cell decodes the same cache through kernel 8
    ("int8_kernel"), as every earlier path does. The references' plain
    paths keep the recipe and take the plain attention (and fp32 compute
    for the fp32 path, which never samples and has no int8 decode
    weights: kernel 10 takes bf16 activations only)."""
    import yaml

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), RECIPE_FILE)) as f:
        recipe = yaml.safe_load(f)
    config = train_config(seed).evolve(**recipe)
    return config.evolve(
        train=dict(minibatch_size=RECIPE_MINIBATCH, compute_dtype=compute_dtype),
        model=dict(model_extra_configs={"transformer": dict(attention_impl=attention_impl, kv_cache_quant=kv_cache_quant,
                                                            decode_weights_quant=decode_weights_quant)}),
    )


def recipe_launches(L: int, K: int, n_mb: int, steps: int, decode_steps: list, trainable: int) -> dict:
    """The recipe cell's launches: every sampler call's prefill through the
    L blocks (kernel 1) and each of its forwards through the 6 L int8
    projections (kernel 10: the prefill and each decode step); each
    cycle's experience pass through the L trunk blocks and the K of the
    hydra reference; each microbatch's forward through the L blocks, the
    recompute of the K trainable ones under remat "full" and their fused
    backward (the frozen trunk builds no graph, so it is neither recomputed
    nor differentiated); one decode launch a layer a decode step (kernel
    8); one kernel 9 launch a trainable tensor a step."""
    calls, cycles = len(decode_steps), len(decode_steps) - 2
    n_fwd = L * calls + cycles * (L + K) + steps * n_mb * (L + K)
    n_decode = L * sum(decode_steps)
    return {"flash_fwd": n_fwd, "flash_fwd_short": n_fwd, "flash_fwd_long": 0,
            "flash_bwd": steps * n_mb * K, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "decode": n_decode, "decode_short": n_decode, "decode_long": 0,
            "adam8bit": trainable * steps, **int8_matmul_launches(6 * L, decode_steps)}


def int8_matmul_launches(projections: int, decode_steps: list) -> dict:
    """Kernel 10's launches over sampler calls of `decode_steps` each:
    every projection once in each call's prefill (the wgmma route: the
    prompts' rows are more than 64) and once a decode step (the stream
    route: a row a prompt, at most 64)."""
    prefill, decode = projections * len(decode_steps), projections * sum(decode_steps)
    return {"int8_matmul": prefill + decode, "int8_matmul_wgmma": prefill, "int8_matmul_stream": decode}


def recipe_ppo_path(seed: int, shapes: dict, int8_shapes: collections.Counter) -> dict:
    """The recipe PPO cell: `trlx_tpu_torch.train` on train_path's workload
    (GPT-2 small at EARLIER_LAYERS, 64 rollouts of 32 + 32 tokens, batch
    32, 4 epochs, two cycles = 16 steps) under `recipe_config`. Gates:
    finite losses, exact launches of kernels 1, 2/3, 8, 9 and 10 (the
    remat recompute included), the int8 moments and the bf16 gradient tree
    in place, the trainable tensors moved and the frozen trunk did not;
    then `recipe_reference` and `recipe_greedy_reference`."""
    import torch

    import trlx_tpu_torch

    counters = memory_counters()
    for fn in counters.values():
        fn.launches = 0
    config = recipe_config(seed)
    t0 = time.perf_counter()
    with forward_shapes(shapes, "recipe"), int8_matmul_shapes(int8_shapes), sampler_calls() as calls:
        trainer = trlx_tpu_torch.train(reward_fn=train_reward_fn, prompts=TRAIN_PROMPTS, config=config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    decode_steps = [c["decode_steps"] for c in calls]
    L, K = trainer.model.cfg.n_layer, config.model.num_layers_unfrozen
    expect = recipe_launches(L, K, trainer.num_mb, TRAIN_STEPS, decode_steps, len(trainer.trainable_params))
    losses = check_train_losses(trainer)
    state = next(iter(trainer.optimizer.state.values()))
    emit("recipe_ppo_path", wall_s=wall, launches=launches, expected=expect, losses=losses,
         decode_steps=decode_steps, num_mb=trainer.num_mb, remat=trainer.model.base.remat,
         grads_dtype=str(trainer.grads_dtype), optimizer=type(trainer.optimizer).__name__,
         state_dtypes={k: str(v.dtype) for k, v in state.items()}, cycle_seconds=cycle_split(trainer),
         decode_weights_quant=trainer.model.cfg.decode_weights_quant, int8_matmul_shapes=[
             [list(k), n] for k, n in sorted(int8_shapes.items())])
    if {k: launches[k] for k in expect} != expect or len(decode_steps) != TRAIN_STEPS // 8 + 2:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    if state["m_q"].dtype != torch.int8 or trainer.num_mb != 2 or trainer.grads_dtype != torch.bfloat16:
        raise AssertionError("the recipe did not take: int8 moments, two microbatches and bf16 gradients expected")
    check_params_moved(trainer, seed, "recipe_params",
                       frozen=("base.embed.",) + tuple(f"base.blocks.{i}." for i in range(L - K)))
    recipe_reference(trainer, seed)
    recipe_greedy_reference(trainer)
    batch = next(iter(trainer.store.create_loader(TRAIN_BATCH, shuffle=False)))
    train_step_profile(trainer, batch, "recipe_train_step")
    del trainer
    torch.cuda.empty_cache()
    return launches


def recipe_reference(trainer, seed: int) -> None:
    """`train_reference` on the recipe trainer (remat, the hydra reference,
    a frozen trunk) against the plain bf16 and fp32 paths of the same
    recipe, on a fresh 256-rollout store."""
    configs = {"plain_bf16": recipe_config(seed, attention_impl="xla", kv_cache_quant="int8"),
               "fp32": recipe_config(seed, attention_impl="xla", kv_cache_quant=None, compute_dtype="float32",
                                     decode_weights_quant=None)}
    train_reference(trainer, seed, configs=configs, phase="recipe_reference")


@contextlib.contextmanager
def plain_decode_math():
    """The models' kernels swapped for their plain versions while active:
    kernel 1 (the prefill), kernel 8 (the decode steps) and kernel 10
    (the int8 projections), as the model module calls them."""
    from trlx_tpu_torch.models import transformer
    from trlx_tpu_torch.ops import decode_attention as da
    from trlx_tpu_torch.ops import flash_attention as fa
    from trlx_tpu_torch.ops import int8_matmul as im

    def flash(q, k, v, key_mask=None, causal=True, sm_scale=None, q_offset=None, with_stats=False):
        key_mask, sm_scale, q_offset = fa._prepare(q, k, key_mask, sm_scale, q_offset, causal)
        return fa.flash_attention_plain(q, k, v, key_mask, causal, sm_scale, q_offset, with_stats=with_stats)

    saved = {name: getattr(transformer, name) for name in ("flash_attention", "decode_attention_int8",
                                                            "int8_weight_matmul")}
    transformer.flash_attention = flash
    transformer.decode_attention_int8 = da.decode_attention_int8_plain
    transformer.int8_weight_matmul = im.int8_weight_matmul_plain
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(transformer, name, fn)


def forced_greedy(model, ids, mask, tokens):
    """`generate`'s greedy decode with the next tokens forced to `tokens`
    [B, N]: the argmax at every step on the same prefix, [B, N]."""
    import torch

    from trlx_tpu_torch.models.generation import cast_params_for_decode
    from trlx_tpu_torch.models.transformer import quantize_kv_cache, logit_projection

    cfg = model.cfg
    decode = cast_params_for_decode(model, cfg.dtype)
    B, P = ids.shape
    N = tokens.shape[1]
    total = P + N
    total += (-total) % 128 if cfg.attention_impl == "pallas" and P % 8 == 0 else 0
    key_mask = torch.cat([mask.to(torch.int32), torch.ones((B, total - P), dtype=torch.int32, device=ids.device)], 1)
    key_mask[:, P + N:] = 0
    cache = decode.init_cache(B, total, key_mask)
    positions = torch.clamp(torch.cumsum(mask.to(torch.int32), dim=1) - 1, min=0)
    out = decode(ids, mask, positions=positions, cache=cache, compute_logits=False)
    project = logit_projection(decode)
    picks = [torch.argmax(project(out["hidden_states"][:, -1]), dim=-1)]
    cache = quantize_kv_cache(out["cache"]) if cfg.kv_cache_quant else out["cache"]
    pos = mask.sum(dim=1).long()
    for t in range(1, N):
        step = decode(tokens[:, t - 1:t], positions=pos[:, None], cache=cache)
        picks.append(torch.argmax(step["logits"][:, -1], dim=-1))
        cache, pos = step["cache"], pos + 1
    return torch.stack(picks, dim=1)


def fp32_decode_copy(model):
    """`model`'s decode copy (int8 projections, embeddings and head in the
    compute dtype) switched in place to fp32 activations: the same int8
    weights as the compute-dtype copy, for the plain path only (kernel 10
    takes bf16)."""
    import torch

    from trlx_tpu_torch.models.generation import cast_params_for_decode

    decode = cast_params_for_decode(model, model.cfg.dtype)
    cfg = decode.cfg.replace(dtype=torch.float32)
    for m in decode.modules():
        if isinstance(getattr(m, "cfg", None), type(cfg)):
            m.cfg = cfg
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float32
    return decode


def greedy_reference(trainer, batches: list, new_tokens: int, phase: str, per_step_bar=None,
                     fp32_arbiter=False) -> dict:
    """A greedy rollout of the trained policy on its int8 decode weights
    through the kernels (1, 8, 10), and the plain path on the same int8
    weights and int8 cache fed the same tokens (`forced_greedy` under
    `plain_decode_math`), for each (ids, mask) of `batches`: the share of
    real response steps whose argmax agrees, over all the batches' rows,
    gated per step at `per_step_bar` (None: printed, not gated). With
    `fp32_arbiter` the plain path also runs the same int8 weights and
    cache in fp32 (`fp32_decode_copy`), as `llama_reference` arbitrates
    near-tied random logits: the kernel path must pick fp32's token at
    least as often as the plain bf16 path does, and agree with plain bf16
    at least as often as plain bf16 agrees with fp32, each within 2
    points."""
    import dataclasses as dc

    import torch

    from trlx_tpu_torch.models.generation import generate

    settings = dc.replace(trainer.generate_settings, do_sample=False, max_new_tokens=new_tokens)
    policy = trainer.model.base
    picks = {"kernel": [], "plain_bf16": [], "fp32": []}
    real = []

    def padded(x, n):  # a batch that stopped early is shorter
        return torch.nn.functional.pad(x, (0, n - x.shape[1]))

    with torch.no_grad():
        for ids, mask in batches:
            out = generate(policy, ids, mask, None, settings)
            tokens = out["response_ids"]
            real.append(padded(out["response_mask"].bool(), new_tokens))
            picks["kernel"].append(padded(tokens, new_tokens))
            with plain_decode_math():
                picks["plain_bf16"].append(padded(forced_greedy(policy, ids, mask, tokens), new_tokens))
                if fp32_arbiter:
                    fp32 = fp32_decode_copy(policy)
                    picks["fp32"].append(padded(forced_greedy(fp32, ids, mask, tokens), new_tokens))
                    del fp32
    real = torch.cat(real)
    picks = {k: torch.cat(v) for k, v in picks.items() if v}

    def agree(a, b):
        return ((picks[a] == picks[b]) & real).sum().item() / max(real.sum().item(), 1)

    agree_k = (picks["kernel"] == picks["plain_bf16"]) & real
    per_step = [(agree_k[:, t].sum() / real[:, t].sum().clamp(min=1)).item() for t in range(new_tokens)
                if real[:, t].any()]
    share = agree("kernel", "plain_bf16")
    arbiter = ({"kernel_vs_fp32": agree("kernel", "fp32"), "plain_bf16_vs_fp32": agree("plain_bf16", "fp32")}
               if fp32_arbiter else None)
    emit(phase, agreement=share, per_step_min=min(per_step), per_step=per_step, rows=int(real.shape[0]),
         prompt_len=[int(ids.shape[1]) for ids, _ in batches], steps=len(per_step), per_step_bar=per_step_bar,
         fp32_arbiter=arbiter)
    if per_step_bar is not None and min(per_step) < per_step_bar:
        raise AssertionError(f"{phase}: the kernel path's greedy choices agree with the plain path on the same "
                             f"int8 weights in {min(per_step)} of a step's rows, below {per_step_bar}")
    if arbiter is not None and (arbiter["kernel_vs_fp32"] < arbiter["plain_bf16_vs_fp32"] - 0.02
                                or share < arbiter["plain_bf16_vs_fp32"] - 0.02):
        raise AssertionError(f"{phase}: the kernel path strays from the plain paths more than bf16 rounding does: "
                             f"kernel vs plain bf16 {share}, {arbiter}")
    return {"agreement": share, "fp32_arbiter": arbiter}


def recipe_greedy_reference(trainer) -> dict:
    """`greedy_reference` on the recipe policy over `byte_prompts`, gated
    per step at RECIPE_GREEDY_AGREEMENT."""
    return greedy_reference(trainer, [byte_prompts(trainer.tokenizer)], TRAIN_NEW_TOKENS, "recipe_greedy_reference",
                            per_step_bar=RECIPE_GREEDY_AGREEMENT)


LLAMA_FULL_WORDS = ("the", "model", "reads", "a", "long", "page", "of", "text", "and", "learns", "its", "next",
                    "byte", "one", "step", "at", "time")


def llama_full_samples(seed: int) -> list:
    """LLAMA_FULL_BATCH byte strings longer than LLAMA_FULL_LEN tokens (cut
    to it by the tokenizer): one fixed batch."""
    import random as _random

    rng = _random.Random(seed)
    return [" ".join(rng.choice(LLAMA_FULL_WORDS) for _ in range(160)) for _ in range(LLAMA_FULL_BATCH)]


def llama_full_config(seed: int):
    """Full-parameter SFT at Llama-2-7B's published widths and 32 layers
    (LLAMA_7B at LLAMA_PUBLISHED_LAYERS), random weights, the recipe's
    memory knobs: the fused 8-bit AdamW (LLAMA_FULL_LR), bf16 gradients, remat
    "full", logit_chunks 8; batch 8 of 512 tokens, 3 steps on one fixed
    batch; an evaluation of 32 prompts x 32 new tokens after the steps, on
    int8 decode weights over the int8 KV cache (kernels 10 and 8)."""
    from trlx_tpu_torch.data.default_configs import default_sft_config

    transformer = dict(LLAMA_7B, n_layer=LLAMA_PUBLISHED_LAYERS, attention_impl="pallas",
                       kv_cache_quant="int8_kernel", decode_weights_quant="int8")
    return default_sft_config().evolve(
        train=dict(batch_size=LLAMA_FULL_BATCH, total_steps=LLAMA_FULL_STEPS, epochs=LLAMA_FULL_STEPS,
                   seq_length=LLAMA_FULL_LEN, eval_interval=10_000, checkpoint_interval=10_000, tracker=None,
                   compute_dtype="bfloat16", seed=seed, grads_dtype="bfloat16", remat_policy="full",
                   logit_chunks=8, **ckpt_kw()),
        model=dict(model_path="random", model_extra_configs={"transformer": transformer}),
        tokenizer=dict(tokenizer_path="byte"),
        optimizer=dict(name="adamw_8bit_fused", kwargs=dict(lr=LLAMA_FULL_LR, betas=[0.9, 0.95], eps=1e-8,
                                                             weight_decay=0.0)),
        method=dict(gen_kwargs=dict(max_new_tokens=LLAMA_FULL_NEW_TOKENS, do_sample=False)),
    )


def llama_full_path(seed: int, shapes: dict, int8_shapes: collections.Counter) -> dict:
    """The 7B cell: `trlx_tpu_torch.train(samples=...)` under
    `llama_full_config`. The 6.74 B parameters are drawn on the card (a
    seeded CUDA generator), the checkpoint commit is skipped (a 27 GB
    export). Prints the peak device memory beside the state arithmetic
    (LLAMA_FULL_STATE_GB), the optimizer state's bytes, the steps' losses
    and walls. Gates: the peak at most LLAMA_FULL_PEAK_BYTES, the loss
    falls at every step, the trained policy's greedy decisions on the
    evaluation prompts against the plain bf16 and fp32 paths on the same
    int8 weights (`greedy_reference` with its fp32 arbiter: the kernel
    path's near-tie flips no more than bf16 rounding's own), exact
    launches of kernels 1 and 2/3 (the long
    routes at T = S = 512, D = 128: a forward and a recompute a layer a
    step, a dq and a dk/dv launch a layer a step; the evaluations'
    prefills), 8, 9 and 10 (every projection of the 32 layers in every
    evaluation forward)."""
    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch.models.wrappers import CausalLM
    from trlx_tpu_torch.ops import decode_attention as da
    from trlx_tpu_torch.ops import flash_attention as fa
    from trlx_tpu_torch.ops.adam8bit import state_bytes
    from trlx_tpu_torch.trainer.base import TPUBaseTrainer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters = memory_counters()
    for fn in counters.values():
        fn.launches = 0
    init_params, save = CausalLM.init_params, TPUBaseTrainer._save_checkpoint
    init_s = []

    def init_on_card(self, generator):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.base.init_params(torch.Generator(device="cuda").manual_seed(seed))
        torch.cuda.synchronize()
        init_s.append(time.perf_counter() - t0)
        return self.init_heads(generator)

    step_walls = []
    train_step, evaluate = TPUBaseTrainer.train_step, TPUBaseTrainer.evaluate

    def timed_step(self, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_step(self, batch)
        torch.cuda.synchronize()
        step_walls.append(time.perf_counter() - t0)
        return out

    def final_evaluation(self):  # the one after the steps; the untrained model's is skipped for time
        return evaluate(self) if self.iter_count else {}

    CausalLM.init_params, TPUBaseTrainer._save_checkpoint = init_on_card, lambda self, name, final=False: None
    TPUBaseTrainer.train_step, TPUBaseTrainer.evaluate = timed_step, final_evaluation
    eval_prompts = [f"{TRAIN_PROMPTS[i % 8]} ({i})" for i in range(LLAMA_FULL_EVAL_PROMPTS)]
    t0 = time.perf_counter()
    try:
        with forward_shapes(shapes, "llama_full"), int8_matmul_shapes(int8_shapes), sampler_calls() as calls:
            trainer = trlx_tpu_torch.train(samples=llama_full_samples(seed), eval_prompts=eval_prompts,
                                           config=llama_full_config(seed))
        torch.cuda.synchronize()
    finally:
        CausalLM.init_params, TPUBaseTrainer._save_checkpoint = init_params, save
        TPUBaseTrainer.train_step, TPUBaseTrainer.evaluate = train_step, evaluate
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {name: fn.launches for name, fn in counters.items()}
    decode_steps = [c["decode_steps"] for c in calls]
    cfg = trainer.model.cfg
    L, steps = cfg.n_layer, LLAMA_FULL_STEPS
    n_params = sum(p.numel() for p in trainer.model.parameters())
    # the evaluation's prompts are left-padded to seq_length - max_new_tokens
    # (480): their prefill (480 queries over a 512-slot cache) and decode
    # steps take the routes past 128 queries and 256 slots too
    P = next(iter(trainer.eval_dataloader)).input_ids.shape[1]
    S = P + LLAMA_FULL_NEW_TOKENS
    S += (-S) % 128 if P % 8 == 0 else 0  # generate()'s cache length under the flash prefill
    n_prefill, n_decode = L * len(decode_steps), L * sum(decode_steps)
    T, D = LLAMA_FULL_LEN, cfg.head_dim
    prefill_long = fa.forward_route(P, S, D) == "long"
    train_long = fa.forward_route(T, T, D) == "long"
    decode_long = da.decode_route(S) == "long"
    n_train_fwd, n_bwd = 2 * L * steps, L * steps  # a forward and a remat recompute a layer a step
    bwd_fused = fa.backward_route(T, T, D) == "fused"
    expect = {"flash_fwd": n_train_fwd + n_prefill,
              "flash_fwd_long": n_train_fwd * train_long + n_prefill * prefill_long,
              "flash_fwd_short": n_train_fwd * (not train_long) + n_prefill * (not prefill_long),
              "flash_bwd": n_bwd * bwd_fused, "flash_bwd_dq": n_bwd * (not bwd_fused),
              "flash_bwd_dkv": n_bwd * (not bwd_fused),
              "decode": n_decode, "decode_short": n_decode * (not decode_long), "decode_long": n_decode * decode_long,
              "adam8bit": len(trainer.trainable_params) * steps,
              **int8_matmul_launches(7 * L, decode_steps)}
    losses = [st["losses/loss"] for _, st in trainer.stats_history if "losses/loss" in st]
    emit("llama_full_path", wall_s=wall, init_s=init_s, step_walls_s=step_walls, layers=L,
         parameters=n_params, trainable_parameters=sum(p.numel() for p in trainer.trainable_params),
         peak_device_bytes=peak, peak_gate_bytes=LLAMA_FULL_PEAK_BYTES, state_arithmetic_gb=LLAMA_FULL_STATE_GB,
         optimizer_state_bytes=state_bytes(trainer.optimizer), losses=losses, launches=launches, expected=expect,
         decode_steps=decode_steps, head_dim=cfg.head_dim, remat=trainer.model.base.remat,
         grads_dtype=str(trainer.grads_dtype), lr=LLAMA_FULL_LR, int8_matmul_shapes=[[list(k), n] for k, n in sorted(int8_shapes.items())
                             if k[1] == cfg.hidden_size or k[2] == cfg.hidden_size])
    if peak > LLAMA_FULL_PEAK_BYTES:
        raise AssertionError(f"peak device memory {peak / 1e9:.2f} GB > {LLAMA_FULL_PEAK_BYTES / 1e9} GB")
    if (len(losses) != steps or not all(math.isfinite(x) for x in losses)
            or not all(b < a for a, b in zip(losses, losses[1:]))):
        raise AssertionError(f"expected {steps} finite losses, each below the one before, got {losses}")
    if {k: launches[k] for k in expect} != expect or cfg.head_dim != 128 or L != LLAMA_PUBLISHED_LAYERS:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    # the evaluation's own batches (8 rows each: 32 rows at once would need
    # an 8 GB fp32 temporary to quantize their cache)
    greedy_reference(trainer, [(b.input_ids.cuda(), b.attention_mask.cuda()) for b in trainer.eval_dataloader],
                     LLAMA_FULL_NEW_TOKENS, "llama_full_greedy_reference", fp32_arbiter=True)
    # one more step, traced; its idle share against the run's own steps on
    # the same batch (after the first)
    batch = next(iter(trainer.store.create_loader(LLAMA_FULL_BATCH, shuffle=False)))
    wall = statistics.median(step_walls[1:])
    emit("llama_full_train_step_time", wall_ms=wall * 1e3, batch=LLAMA_FULL_BATCH, seq=LLAMA_FULL_LEN,
         samples_ms=[x * 1e3 for x in step_walls])
    profile_phase("llama_full_train_step", lambda: trainer.train_step(batch), wall, grad=True)
    emit("llama_full_memory", peak_device_bytes_with_profile=torch.cuda.max_memory_allocated())
    del trainer, batch
    torch.cuda.empty_cache()
    return launches


def memory_phases(seed: int, shapes: dict) -> dict:
    """Kernels 9 and 10 against their plain versions, then the recipe PPO
    cell and the 7B cell (each with kernel 10's launches by shape)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {"errs": {"adam8bit": check_adam8bit(gen), "int8_matmul": check_int8_matmul(gen)},
           "int8_shapes": {"recipe": collections.Counter(), "llama_full": collections.Counter()}}
    torch.cuda.empty_cache()
    out["recipe"] = recipe_ppo_path(seed, shapes, out["int8_shapes"]["recipe"])
    out["llama_full"] = llama_full_path(seed, shapes, out["int8_shapes"]["llama_full"])
    return out


def memory_kernel_times(gen, memory: dict) -> list:
    """Kernels 9 and 10 at the memory paths' shapes, beside their bounds and
    plain versions: kernel 9 on a Llama-2-7B MLP leaf and a GPT-2 leaf with
    a bf16 gradient (no single PyTorch call computes it: library null),
    kernel 10 at every (M, K, N) the recipe and 7B cells launched it at,
    each shape held to the fp32 product again (`int8_matmul_error`) and
    its row carrying its own error (library: torch.matmul on the bf16
    weight it replaces)."""
    rows = adam8bit_rows(gen, memory["errs"]["adam8bit"]["by_leaf"],
                         {"recipe": memory["recipe"]["adam8bit"], "llama_full": memory["llama_full"]["adam8bit"]})
    tallies = memory["int8_shapes"]
    for (M, K, N) in sorted(set(tallies["recipe"]) | set(tallies["llama_full"])):
        rows.append(int8_matmul_row(gen, M, K, N, {path: tallies[path].get((M, K, N), 0) for path in tallies}))
    for row in rows:
        emit("kernel_time", **row)
    return rows


def adam8bit_rows(gen, errs_by_leaf: dict, by_path: dict) -> list:
    """Kernel 9's kernel_time rows: a Llama-2-7B MLP leaf and a GPT-2 leaf
    with a bf16 gradient (fused, with decay), beside the plain version and
    the bound (no single PyTorch call computes it: library null);
    `errs_by_leaf` the leaves' errors from `check_adam8bit`, `by_path` the
    launches of the runs that launched it (None: no run did, and the rows
    carry no launches)."""
    import torch

    from trlx_tpu_torch.ops import adam8bit as a8

    launches = {} if by_path is None else dict(launches=sum(by_path.values()), launches_by_path=by_path)
    rows = []
    for leaf in ("llama_mlp", "gpt2_qkv"):
        shape = ADAM8_LEAVES[leaf]
        p = torch.randn(shape, generator=gen, device="cuda") * 0.02
        g = (torch.randn(shape, generator=gen, device="cuda") * 1e-2).to(torch.bfloat16)
        st = adam8bit_zero_state(p)
        args = (ADAM8_LR, 0.9, 0.999, 1e-8, ADAM8_WD, *a8.bias_corrections(0.9, 0.999, 1))
        ms = time_ms(lambda: a8.adam8bit_step(p, g, *st, *args))
        plain = time_ms(lambda: a8.adam8bit_step_plain(p, g, *st, *args), reps=10)
        n, nb = p.numel(), a8.n_blocks(p.numel())
        n_bytes = n * (4 + 2 + 1 + 1) + nb * 8 + n * (4 + 1 + 1) + nb * 8
        bms, by = bound_ms(n_bytes, ADAM8_OPS_PER_ELEMENT * n, FP32_FLOPS)
        rows.append(dict(
            name=f"adam8bit/{leaf}_bf16_grad", route="cuda", source="trlx_tpu_torch/csrc/adam8bit.cu",
            replaces="none (port-only: trlx_tpu/ops/adam8bit.py:154 fused_adamw_8bit_update runs in XLA)",
            **launches, max_abs_err=errs_by_leaf[leaf], err_is="this leaf's worst parameter error "
            "relative to the plain version over adam8bit_check's steps (bf16 gradient, fused)", shape=list(shape),
            ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
            bound_bytes=n_bytes, bound_flops=ADAM8_OPS_PER_ELEMENT * n, library_ms=None, library_is="none"))
    return rows


def int8_matmul_row(gen, M: int, K: int, N: int, by_path: dict) -> dict:
    """Kernel 10's kernel_time row at (M, K, N) on fresh inputs: held to the
    fp32 product again (`int8_matmul_error`), timed on the route
    `int8_matmul_route` names beside the plain version, torch.matmul on the
    bf16 weight it replaces (library) and the bound; `by_path` the
    launches of the runs that launched this shape (None: no run did, and
    the row has no launches)."""
    import torch

    from trlx_tpu_torch.ops import int8_matmul as im

    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((K, N), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    q, s = im.quantize_kernel(w)
    err = int8_matmul_error(x, q, s)
    ms = time_ms(lambda: im.int8_weight_matmul(x, q, s))
    plain = time_ms(lambda: im.int8_weight_matmul_plain(x, q, s))
    lib = time_ms(lambda: torch.matmul(x, w))
    n_bytes = K * N + 2 * M * K + 2 * M * N + 4 * N
    bms, by = bound_ms(n_bytes, 2 * M * K * N)
    route, tile_rows, tile_cols, splits = err["route"]
    launches = {} if by_path is None else dict(launches=sum(by_path.values()), launches_by_path=by_path)
    return dict(
        name=f"int8_matmul_{route}/M{M}_K{K}_N{N}", route="cuda", source="trlx_tpu_torch/csrc/int8_weight_matmul.cu",
        replaces="none (port-only: trlx_tpu/models/transformer.py:574 quantize_decode_weights, QDense's XLA dot)",
        kernel_route=route, tile=[tile_rows, tile_cols], k_splits=splits, **launches,
        max_abs_err=err["max_abs_err"], err_is="at this shape, from the fp32 product of the same int8 weights",
        rel_to_half_ulp=err["rel_to_half_ulp"], vs_plain_max_abs=err["vs_plain_max_abs"],
        bitwise_repeat=err["bitwise_repeat"], shape=[M, K, N], ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
        bound_bytes=n_bytes, bound_flops=2 * M * K * N, library_ms=lib, library_is="torch.matmul on the bf16 weight")


def w8a16_kernel_times(gen) -> list:
    """`--only w8a16`: kernel 10's rows at W8A16_PATH_SHAPES, the shapes the
    recipe and 7B cells launch it at. No cell runs here, so the rows carry
    no launches."""
    rows = []
    for M, K, N in W8A16_PATH_SHAPES:
        row = int8_matmul_row(gen, M, K, N, None)
        emit("kernel_time", **row)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# the health phases: the memory doctor, the guardrails and the chaos harness
# ---------------------------------------------------------------------------

HEALTH_ROLLOUTS, HEALTH_STEPS = 64, 2  # one cycle: 64 rollouts, batch 32, one epoch
# the accumulation tolerance of tests/torch_port/test_torch_memory.py: the
# run split by a real OOM against the one split by chaos (the same code
# once the failed attempt is gone)
HEALTH_RTOL = 1e-4
# the split run against the unsplit one: the losses at HEALTH_RTOL; the
# split step's gradient and update at about 4x the readings on the H100
# (PERF.md, Health: 2.03e-3 and 5.98e-3, the losses bitwise equal). bf16
# compute: each microbatch's weight gradients come out of bf16 matmuls,
# rounded to bf16 (unit 2^-8) before they are summed in fp32, and Adam's
# normalised step scales that noise up in small gradient elements
HEALTH_SPLIT_GRAD_RTOL = 2 ** -7  # ||g_split - g|| / ||g|| over the split step's gradient tree
HEALTH_SPLIT_UPDATE_RTOL = 2 ** -5  # ||p_split - p|| / ||p - p_before||: the split step's update
# the engine cell's explicit page pool: about 4 GB of int8 pages at the
# cell's 4 layers, so that the pool, not the decode's other tensors,
# decides whether generate() fits under oom_pool_path's cap
HEALTH_POOL_PAGES = 40_000
HEALTH_ENGINE = dict(enabled=True, slots=32, page_size=16, paged_attention_impl="pallas",
                     pool_pages=HEALTH_POOL_PAGES)
HEALTH_ENGINE_STEP_AGREEMENT = 0.95  # engine_reference's per-step gate
# guardrail_path: one cycle of 4 steps (two passes of two batches), a
# committed checkpoint at step 2
GUARDRAIL_STEPS, GUARDRAIL_INTERVAL = 4, 2


def health_config(seed: int, **train):
    """train_config (GPT-2 small at EARLIER_LAYERS, bf16 compute, the flash
    and int8 decode kernels) cut to one cycle of HEALTH_STEPS steps, with
    the memory doctor on; `train` overrides the train section."""
    config = train_config(seed)
    return config.evolve(
        train=dict(dict(total_steps=HEALTH_STEPS, memory=dict(enabled=True)), **train),
        method=dict(num_rollouts=HEALTH_ROLLOUTS, chunk_size=HEALTH_ROLLOUTS, ppo_epochs=1),
    )


def health_engine_config(seed: int, **train):
    """health_config with greedy rollouts through the decode engine (32
    slots, 16-token int8 pages, the paged kernel) over HEALTH_POOL_PAGES
    pages: oom_pool_path's cell. (Not the split's: the freed pool's
    segment stays reserved under the tensors later carved from it, so a
    cap on a train step would not bind.)"""
    return health_config(seed, **train).evolve(method=dict(gen_engine=HEALTH_ENGINE, gen_kwargs=dict(
        max_new_tokens=TRAIN_NEW_TOKENS, top_k=0, top_p=1.0, do_sample=False)))


def health_counters() -> dict:
    return {**train_counters(), **paged_counters()}


def health_train(config, path: str, cap=None):
    """`trlx_tpu_torch.train` with every kernel's counter at 0 just before it.
    With `cap` = (method name, bytes above what is allocated on entry, first
    step), the process's memory fraction is capped for the duration of each
    call of that TPUBaseTrainer method from that optimizer step on (the
    allocator's cache emptied first, so the cap binds) and lifted after it.
    Returns (trainer, wall s, launches)."""
    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch.trainer import base as trainer_base

    counters = health_counters()
    for fn in counters.values():
        fn.launches = 0
    restore = None
    if cap is not None:
        name, margin, first = cap
        inner = getattr(trainer_base.TPUBaseTrainer, name)
        total = torch.cuda.get_device_properties(0).total_memory

        def capped(self, *args, **kwargs):
            if self.iter_count < first:
                return inner(self, *args, **kwargs)
            torch.cuda.empty_cache()
            torch.cuda.set_per_process_memory_fraction(min(1.0, (torch.cuda.memory_allocated() + margin) / total))
            try:
                return inner(self, *args, **kwargs)
            finally:
                torch.cuda.set_per_process_memory_fraction(1.0)

        setattr(trainer_base.TPUBaseTrainer, name, capped)
        restore = (name, inner)
    t0 = time.perf_counter()
    try:
        trainer = trlx_tpu_torch.train(reward_fn=train_reward_fn, prompts=TRAIN_PROMPTS, config=config)
    finally:
        if restore is not None:
            setattr(trainer_base.TPUBaseTrainer, *restore)
            torch.cuda.set_per_process_memory_fraction(1.0)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    return trainer, time.perf_counter() - t0, launches


@contextlib.contextmanager
def optimizer_steps(copy: bool = False):
    """Records each call of TPUBaseTrainer._optimizer_step while open: the
    gradient tree's bytes and, with `copy`, the gradients and the
    parameters before the step, by name, copied to the host (no device
    memory, so a cap around the step is not disturbed)."""
    from trlx_tpu_torch.trainer import base as trainer_base

    step, seen = trainer_base.TPUBaseTrainer._optimizer_step, []

    def spied(self, grads):
        record = {"bytes": sum(g.numel() * g.element_size() for g in grads.values())}
        if copy:
            names = {id(p): n for n, p in self.model.named_parameters()}
            record["grads"] = {names[id(p)]: g.detach().cpu().float() for p, g in grads.items()}
            record["before"] = {n: p.detach().cpu() for n, p in self.model.named_parameters()}
        seen.append(record)
        return step(self, grads)

    trainer_base.TPUBaseTrainer._optimizer_step = spied
    try:
        yield seen
    finally:
        trainer_base.TPUBaseTrainer._optimizer_step = step


def tree_rel(a: dict, b: dict, scale: dict) -> float:
    """||a - b|| / ||scale|| over the whole tree, in float64."""
    num = sum(((a[n].double() - b[n].double()) ** 2).sum().item() for n in b)
    den = sum((scale[n].double() ** 2).sum().item() for n in b)
    return math.sqrt(num / den)


def check_health_launches(launches: dict, kernels: tuple, phase: str) -> None:
    missing = [k for k in kernels if not launches.get(k)]
    if missing:
        raise AssertionError(f"{phase}: the path never launched {missing}: {launches}")


def health_losses(trainer) -> list:
    return [st["losses/total_loss"] for _, st in trainer.stats_history if "losses/total_loss" in st]


def oom_events(trainer, action: str) -> list:
    return [e for e in trainer.memdoctor.events if e["action"] == action]


def health_reference(seed: int) -> dict:
    """Run U, the reference of the split and of the GPT-2 preflight cell:
    the cell uncapped and unsplit, its optimizer steps recorded (gradients
    and the parameters before each step, on the host). Kept: its losses,
    final parameters, the preflight plan it took at the top of learn(), the
    bytes it holds (`held_bytes`) and its peak allocation; then the peaks
    of one unsplit step (allocated) and one split step (reserved) on its
    first batch, probes run after its numbers are taken. Gate: kernels 1,
    2/3 and 8 launched."""
    import torch

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with optimizer_steps(copy=True) as steps:
        trainer, wall, launches = health_train(health_config(seed), "health_reference")
    peak = torch.cuda.max_memory_allocated()
    ref = dict(wall_s=wall, launches=launches, steps=steps, losses=health_losses(trainer), peak=peak,
               params={n: p.detach().cpu() for n, p in trainer.model.named_parameters()},
               plan=trainer._hbm_plan, held=held_bytes(trainer, [s["bytes"] for s in steps]))
    batch = next(iter(trainer.store.create_loader(TRAIN_BATCH, shuffle=False)))
    peaks = {}
    for num_mb in (1, 2):
        trainer.num_mb, trainer.mb_size = num_mb, TRAIN_BATCH // num_mb
        torch.cuda.empty_cache()
        rest = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        peaks[num_mb] = {"rest": rest, "allocated": torch.cuda.max_memory_allocated() - rest,
                         "reserved": torch.cuda.max_memory_reserved() - rest}
    ref["peaks"] = peaks
    del trainer, batch
    torch.cuda.empty_cache()
    emit("health_reference", wall_s=wall, losses=ref["losses"], peak_bytes=peak, peaks=peaks, launches=launches)
    if len(ref["losses"]) != HEALTH_STEPS or len(steps) != HEALTH_STEPS:
        raise AssertionError(f"health_reference: expected {HEALTH_STEPS} steps, got {ref['losses']}")
    check_health_launches(launches, ("flash_fwd", "flash_bwd", "decode"), "health_reference")
    return ref


def oom_split_path(seed: int, ref: dict) -> dict:
    """A real OOM walks the doctor's split_microbatch rung. Run B: its first step whole, then split from its second step on
    by a chaos `oom_fused_block` on the second dispatch. Run A: no chaos,
    its second step capped halfway between the split step's reserve and the
    unsplit step's allocation (`health_reference`'s probes; AdamW's moments
    exist by then: the first step creates them), so that the configured
    microbatch cannot fit and half of it can: it dies on
    torch.cuda.OutOfMemoryError, splits and retries. Gates: the OOM was
    real and split once, AdamW stepped once a step; against B (the same
    split, reached by chaos) the losses and final parameters at HEALTH_RTOL,
    bitwise equality printed: the failed attempt left nothing behind;
    against U, unsplit (the doctor's contract: PPO whitens the whole step
    batch and fixes the loss's normaliser, so the split step is the
    unsplit one up to bf16 rounding), the losses at HEALTH_RTOL, the split
    step's gradients and its update at the HEALTH_SPLIT_* tolerances; kernels 1,
    2/3 and 8 launched."""
    import torch

    chaos = dict(faults=[dict(fault="oom_fused_block", at=2)])
    trainer_b, wall_b, launches_b = health_train(health_config(seed, chaos=chaos), "oom_split_b")
    losses_b = health_losses(trainer_b)
    params_b = {n: p.detach().clone() for n, p in trainer_b.model.named_parameters()}
    del trainer_b
    torch.cuda.empty_cache()
    peaks = ref["peaks"]
    if peaks[2]["reserved"] >= peaks[1]["allocated"]:
        raise AssertionError(f"oom_split_path: half a microbatch reserves as much as a whole one allocates: {peaks}")
    margin = (peaks[2]["reserved"] + peaks[1]["allocated"]) // 2
    with optimizer_steps(copy=True) as steps:
        trainer_a, wall_a, launches_a = health_train(health_config(seed), "oom_split_a",
                                                     cap=("_train_step_under_doctor", margin, 1))
    losses_a = health_losses(trainer_a)
    splits = oom_events(trainer_a, "split_microbatch")
    params_a = dict(trainer_a.model.named_parameters())
    bitwise = losses_a == losses_b and all(torch.equal(params_a[n], p) for n, p in params_b.items())
    worst = max((((params_a[n] - p).abs() / p.abs().clamp(min=1e-6)).max().item() for n, p in params_b.items()),
                default=0.0)
    adam = sorted({int(st["step"]) for st in trainer_a.optimizer.state.values()})
    host_a = {n: p.detach().cpu() for n, p in params_a.items()}
    before, after_u = ref["steps"][-1]["before"], ref["params"]
    unsplit = {"loss_rel": [abs(a - u) / abs(u) for a, u in zip(losses_a, ref["losses"])],
               "loss_bitwise": losses_a == ref["losses"],
               "grad_rel": tree_rel(steps[-1]["grads"], ref["steps"][-1]["grads"], ref["steps"][-1]["grads"]),
               "update_rel": tree_rel(host_a, after_u, {n: after_u[n] - before[n] for n in after_u}),
               "before_bitwise": all(torch.equal(steps[-1]["before"][n], t) for n, t in before.items())}
    emit("oom_split_path", wall_s={"a": wall_a, "b": wall_b}, peaks=peaks, cap_margin_bytes=margin,
         oom_events=trainer_a.memdoctor.events, num_mb=trainer_a.num_mb, losses_a=losses_a, losses_b=losses_b,
         losses_unsplit=ref["losses"], bitwise_equal=bitwise, param_max_rel_diff=worst, against_unsplit=unsplit,
         tolerances={"loss": HEALTH_RTOL, "grad": HEALTH_SPLIT_GRAD_RTOL,
                     "update": HEALTH_SPLIT_UPDATE_RTOL},
         adam_steps=adam, optimizer_steps=len(steps), launches=launches_a, launches_b=launches_b)
    if len(splits) != 1 or not splits[0]["bytes_requested"] or trainer_a.num_mb != 2:
        raise AssertionError(f"oom_split_path: the cap did not produce one real OOM and one split: "
                             f"{trainer_a.memdoctor.events}")
    if len(losses_a) != HEALTH_STEPS or not all(math.isfinite(x) for x in losses_a):
        raise AssertionError(f"oom_split_path: expected {HEALTH_STEPS} finite losses, got {losses_a}")
    if adam != [trainer_a.iter_count] or len(steps) != trainer_a.iter_count:
        raise AssertionError(f"oom_split_path: AdamW's step counts {adam} and {len(steps)} optimizer calls "
                             f"!= {trainer_a.iter_count} steps")
    if not (len(losses_a) == len(losses_b) and all(math.isclose(a, b, rel_tol=HEALTH_RTOL, abs_tol=0.0)
                                                   for a, b in zip(losses_a, losses_b))):
        raise AssertionError(f"oom_split_path: losses {losses_a} vs the chaos-split run's {losses_b}")
    for n, p in params_b.items():
        if not torch.allclose(params_a[n], p, rtol=HEALTH_RTOL, atol=1e-6):
            raise AssertionError(f"oom_split_path: {n} differs from the chaos-split run's")
    if not (max(unsplit["loss_rel"]) <= HEALTH_RTOL
            and unsplit["grad_rel"] <= HEALTH_SPLIT_GRAD_RTOL and unsplit["update_rel"] <= HEALTH_SPLIT_UPDATE_RTOL):
        raise AssertionError(f"oom_split_path: the split step differs from the unsplit run's: {unsplit}")
    check_health_launches(launches_a, ("flash_fwd", "flash_bwd", "decode"), "oom_split_path")
    del trainer_a, params_a
    torch.cuda.empty_cache()
    return launches_a


def greedy_agreement(a, a_mask, b, b_mask) -> tuple:
    """(the per-step agreement: at each response step, the share of rows
    whose tokens agree among those whose earlier tokens all agree; the
    free-running share of real tokens that agree)."""
    import torch

    real = (a_mask > 0) & (b_mask > 0)
    same = (a == b) & real
    per_step, prefix = [], torch.ones_like(real[:, 0])
    for t in range(a.shape[1]):
        live = prefix & real[:, t]
        if live.any():
            per_step.append((same[:, t] & live).sum().item() / live.sum().item())
        prefix = prefix & (same[:, t] | ~real[:, t])
    return per_step, same.sum().item() / max(real.sum().item(), 1)


def oom_pool_path(seed: int) -> dict:
    """A real OOM walks the doctor's shrink_pool rung, on the engine cell.
    Run U uncapped; run C with each rollout generate() call capped at 3/4
    of the full pool above what is allocated on entry: the pool's
    allocation raises torch.cuda.OutOfMemoryError, the pool and the slots
    halve, and the chunk retries. Gates: the OOM was real and shrank the
    pool once, C's greedy rollouts agree with U's at the engine path's
    per-step gate (the free-running share printed), kernels 1, 2/3 and 7
    launched."""
    import torch

    from trlx_tpu_torch.utils.memdoctor import engine_pool_bytes

    trainer_u, wall_u, launches_u = health_train(health_engine_config(seed), "oom_pool_u")
    spec = trainer_u._engine_spec(HEALTH_ROLLOUTS)
    pool = engine_pool_bytes(spec, trainer_u.model.cfg, PROMPT_LEN, TRAIN_NEW_TOKENS)
    hist_u = trainer_u.store.history
    tokens_u, mask_u = hist_u.response_tensors.clone(), hist_u.response_mask.clone()
    del trainer_u, hist_u
    torch.cuda.empty_cache()
    trainer_c, wall_c, launches_c = health_train(health_engine_config(seed), "oom_pool_c",
                                                 cap=("_generate_rollout", pool * 3 // 4, 0))
    hist_c = trainer_c.store.history
    per_step, free = greedy_agreement(hist_c.response_tensors, hist_c.response_mask, tokens_u, mask_u)
    shrinks = oom_events(trainer_c, "shrink_pool")
    emit("oom_pool_path", wall_s={"uncapped": wall_u, "capped": wall_c}, pool_bytes=pool, pool_pages=spec.pool_pages,
         slots={"uncapped": spec.slots, "capped": trainer_c._engine_spec(HEALTH_ROLLOUTS).slots},
         oom_events=trainer_c.memdoctor.events, per_step_min=min(per_step), per_step=per_step,
         free_running=free, launches=launches_c, launches_uncapped=launches_u)
    if len(shrinks) != 1 or not shrinks[0]["bytes_requested"] or trainer_c.memdoctor.pool_shrinks != 1:
        raise AssertionError(f"oom_pool_path: the cap did not produce one real OOM and one pool shrink: "
                             f"{trainer_c.memdoctor.events}")
    if min(per_step) < HEALTH_ENGINE_STEP_AGREEMENT:
        raise AssertionError(f"oom_pool_path: the shrunk pool's greedy rollouts agree with the full pool's in "
                             f"{min(per_step)} of a step's rows")
    check_health_launches(launches_c, ("flash_fwd", "flash_bwd", "paged"), "oom_pool_path")
    del trainer_c, hist_c
    torch.cuda.empty_cache()
    return launches_c


def held_bytes(trainer, grads_seen: list) -> dict:
    """The bytes of the tensors the trainer holds, counted from the tensors
    themselves: the model's parameters and buffers, the optimizer's state,
    the frozen reference's own tensors, the gradient tree of the last
    optimizer step (`grads_seen`) and the sampler's decode copy (what
    `cast_params_for_decode` allocates: its tensors that are not the
    model's)."""
    import torch

    from trlx_tpu_torch.models.generation import cast_params_for_decode
    from trlx_tpu_torch.ops.adam8bit import state_bytes

    def nbytes(tensors, exclude=()):
        seen, total = set(exclude), 0
        for t in tensors:
            if t.data_ptr() not in seen:
                seen.add(t.data_ptr())
                total += t.numel() * t.element_size()
        return total

    model = trainer.model
    own = [*model.parameters(), *model.buffers()]
    ptrs = {t.data_ptr() for t in own}
    ref = trainer.ref_params
    base = model.base
    with torch.no_grad():
        copy = cast_params_for_decode(base, base.cfg.dtype)
        decode = 0 if copy is base else nbytes([*copy.parameters(), *copy.buffers()], ptrs)
    return {"params": nbytes(own), "opt_state": state_bytes(trainer.optimizer),
            "ref_params": nbytes([*ref.parameters(), *ref.buffers()], ptrs), "grads": grads_seen[-1],
            "decode_params": decode}


def preflight_plan(seed: int, ref: dict) -> dict:
    """The preflight plan (the one `_memory_preflight` took at the top of
    learn(), before any rollout) against the tensors, in two cells: the
    GPT-2 cell (run U, `health_reference`) and the recipe cell
    (`recipe_config`: 8-bit AdamW's int8 moments and scales, bf16
    gradients, int8 decode weights; one train() run). Its state rows must
    equal `held_bytes` after the run exactly; its peak is printed beside
    torch.cuda.max_memory_allocated (`memdoctor.cross_check`: the plan's
    peak phase, its bytes, the measured peak, their ratio). Then a budget
    below the plan: train() must raise MemoryPlanError before any sampler
    call, and the seconds to reject are printed."""
    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch.utils import memdoctor as md

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    recipe = recipe_config(seed).evolve(train=dict(total_steps=HEALTH_STEPS, memory=dict(enabled=True)), method=dict(
        num_rollouts=HEALTH_ROLLOUTS, chunk_size=HEALTH_ROLLOUTS, ppo_epochs=1))
    with optimizer_steps() as steps:
        trainer, wall, launches = health_train(recipe, "preflight_recipe")
    cells = {"gpt2": (ref["plan"], ref["held"], ref["peak"], ref["wall_s"], ref["launches"]),
             "recipe": (trainer._hbm_plan, held_bytes(trainer, [s["bytes"] for s in steps]),
                        torch.cuda.max_memory_allocated(), wall, launches)}
    del trainer
    torch.cuda.empty_cache()
    out = {}
    for cell, (plan, held, peak, wall, launches) in cells.items():
        rows = {name: plan.row(name) for name in held}
        out[cell] = {"rows": rows, "held": held, **md.cross_check(plan, peak), "wall_s": wall}
        emit(f"preflight_plan_{cell}", **out[cell], launches=launches)
        if rows != held:
            raise AssertionError(f"preflight_plan: the {cell} plan's state rows {rows} != the held bytes {held}")
        check_health_launches(launches, ("flash_fwd", "flash_bwd", "decode"), f"preflight_plan_{cell}")
    config = health_config(seed, memory=dict(enabled=True, hbm_bytes=out["gpt2"]["plan_bytes"] // 2))
    t0 = time.perf_counter()
    with sampler_calls() as calls:
        try:
            trlx_tpu_torch.train(reward_fn=train_reward_fn, prompts=TRAIN_PROMPTS, config=config)
        except md.MemoryPlanError as e:
            rejected = str(e).splitlines()[0]
        else:
            raise AssertionError("preflight_plan: a budget of half the plan was admitted")
    seconds = time.perf_counter() - t0
    emit("preflight_reject", seconds=seconds, sampler_calls=len(calls), message=rejected)
    if calls:
        raise AssertionError(f"preflight_plan: {len(calls)} sampler calls ran before the rejection")
    return out


def guardrail_path(seed: int) -> dict:
    """The guardrails on the cell: one cycle of GUARDRAIL_STEPS steps (64
    rollouts, 2 epochs of two batches), a full checkpoint (weights and
    optimizer) committed at step GUARDRAIL_INTERVAL, a chaos `nan_loss` on
    the batch after step 3 with the ladder [rollback, abort]: the trip
    rolls back to step 2, and the restored weights and moments must equal
    the committed files bitwise; the run ends at step 4 with finite losses.
    A chaos `hbm_creep` on the first step after the rollback trips the
    watermark (the guardrails' `memory` signal; in the rollback's cooldown
    the ladder only logs). Then one train step's wall time with the
    watermark sampler's thread on (every 10 ms) and off."""
    import torch

    from trlx_tpu_torch.trainer import base as trainer_base

    directory = ckpt_dir()
    config = health_config(seed, total_steps=GUARDRAIL_STEPS, checkpoint_interval=GUARDRAIL_INTERVAL,
                           checkpoint_dir=directory, save_optimizer=True, save_best=False,
                           guardrails=dict(enabled=True, ladder=["rollback", "abort"]),
                           memory=dict(enabled=True, sample_interval_s=0.01),
                           chaos=dict(faults=[dict(fault="nan_loss", at=GUARDRAIL_INTERVAL + 2),
                                              dict(fault="hbm_creep", at=GUARDRAIL_INTERVAL + 3)]))
    config = config.evolve(method=dict(ppo_epochs=GUARDRAIL_STEPS * TRAIN_BATCH // HEALTH_ROLLOUTS))
    restored = {}
    rollback = trainer_base.TPUBaseTrainer._rollback_to_last_good

    def spied(self):
        path = self.ckpt_manager.latest_resumable()
        ok = rollback(self)
        if ok:
            saved = torch.load(os.path.join(path, "state", "model.pt"), map_location="cuda", weights_only=True)
            opt = torch.load(os.path.join(path, "state", "optimizer.pt"), map_location="cuda", weights_only=True)
            live = self.optimizer.state_dict()["state"]
            restored.update(path=os.path.basename(path), step=self.iter_count, model_bitwise=all(
                torch.equal(v, self.model.state_dict()[k]) for k, v in saved.items()), optimizer_bitwise=all(
                torch.equal(t, live[i][k].to(t.device)) for i, st in opt["state"].items() for k, t in st.items()))
        return ok

    trainer_base.TPUBaseTrainer._rollback_to_last_good = spied
    try:
        trainer, wall, launches = health_train(config, "guardrail")
    finally:
        trainer_base.TPUBaseTrainer._rollback_to_last_good = rollback
    losses = health_losses(trainer)
    batch = next(iter(trainer.store.create_loader(TRAIN_BATCH, shuffle=False)))
    step_ms = {}
    for sampler_on in (False, True, False, True):
        if sampler_on:
            trainer.memdoctor.sampler.start()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        step_ms.setdefault("on" if sampler_on else "off", []).append((time.perf_counter() - t0) / 3 * 1e3)
        trainer.memdoctor.sampler.stop()
    emit("guardrail_path", wall_s=wall, restored=restored, trips=trainer.guardrails.trip_history,
         actions=trainer.guardrails.actions_taken, chaos_fired=trainer.chaos.fired, losses=losses,
         watermark_trips=trainer.memdoctor.sampler.watermark_trips, sampler_samples=trainer.memdoctor.sampler.samples,
         train_step_ms=step_ms, launches=launches)
    if restored.get("step") != GUARDRAIL_INTERVAL or not (restored["model_bitwise"] and restored["optimizer_bitwise"]):
        raise AssertionError(f"guardrail_path: the rollback did not restore step {GUARDRAIL_INTERVAL}'s "
                             f"checkpoint bitwise: {restored}")
    if trainer.guardrails.actions_taken[:1] != ["rollback"] or trainer.guardrails.trip_history[:1] != ["loss"]:
        raise AssertionError(f"guardrail_path: the NaN did not trip a rollback: {trainer.guardrails.actions_taken}")
    if "memory" not in trainer.guardrails.trip_history or trainer.memdoctor.sampler.watermark_trips != 1:
        raise AssertionError(f"guardrail_path: hbm_creep did not trip the watermark: {trainer.guardrails.trip_history}")
    if trainer.iter_count != GUARDRAIL_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"guardrail_path: the run did not end at step {GUARDRAIL_STEPS} with finite losses: "
                             f"{trainer.iter_count}, {losses}")
    check_health_launches(launches, ("flash_fwd", "flash_bwd", "decode"), "guardrail_path")
    del trainer, batch
    torch.cuda.empty_cache()
    return launches


def health_phases(seed: int) -> dict:
    """The memory doctor's real OOMs, its preflight plan and the guardrails'
    rollback on the GPT-2 cell (kernels 1, 2/3 and 8; 7 in the engine's
    rollouts), timed as a whole."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    ref = health_reference(seed)
    out = {"oom_split": oom_split_path(seed, ref), "oom_pool": oom_pool_path(seed),
           "preflight": preflight_plan(seed, ref), "guardrail": guardrail_path(seed)}
    del ref
    emit("health", wall_s=time.perf_counter() - t0)
    return out


def main() -> int:
    try:
        return run()
    finally:
        import shutil

        for root in _CKPT_ROOT:
            shutil.rmtree(root, ignore_errors=True)


def run() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--only", choices=("fwd", "paged", "decode", "bias", "sft", "ppo", "resume", "ilql", "rft",
                                           "grpo", "dpo", "llama", "peft", "memory", "w8a16", "adam8bit", "health"),
                        default=None,
                        help="fwd: the build, flash_check and the flash forward's kernel_time rows only "
                             "(a quick check of kernel 1); paged: the build, paged_check and the paged "
                             "kernel_time rows only (kernel 7); decode: the build, decode_check and the int8 "
                             "decode kernel_time rows only (kernel 8); bias: the build, flash_bias_check and "
                             "the bias kernels' kernel_time rows only (kernels 4-6); no path runs, so no "
                             "launches; sft: the build and the SFT phases (sft_path, sft_reference, "
                             "sft_train_step, reload, randomwalks), no kernel_time rows; ppo: the build, "
                             "train_path and the slice-6 PPO phases (overlap_path, ppo_knobs_path, "
                             "value_branch_cost, ppo_knobs_reference, stop_path, stop_reference), no "
                             "kernel_time rows; resume: the build and resume_path; ilql: the build, ilql_path, ilql_reference, ilql_t5_path and the "
                             "randomwalks ILQL runner; rft: the build, rft_path and the randomwalks RFT runner; "
                             "grpo: the build, grpo_path, grpo_reference and grpo_engine_path; dpo: the build, "
                             "dpo_path and dpo_reference; llama: the build, the head width 128 kernel cases, "
                             "llama_path and the head width 128 kernel_time rows; peft: the build, the adapters' "
                             "kernel cases, peft_phases (LoRA, prompt and prefix tuning on GPT-2 small, T5 LoRA, "
                             "Llama-2-7B LoRA) and their kernel_time rows; memory: the build, kernels 9 and 10 "
                             "against their plain versions, the recipe PPO cell, the full-parameter Llama-2-7B "
                             "cell and kernels 9 and 10's kernel_time rows; w8a16: the build, kernel 10's check "
                             "and its kernel_time rows at the cells' recorded shapes; adam8bit: the build, "
                             "kernel 9's check (bit for bit or not, every leaf) and its kernel_time rows; health: "
                             "the build and the health "
                             "phases (health_reference, oom_split_path, oom_pool_path, preflight_plan, "
                             "guardrail_path), no kernel_time rows")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from trlx_tpu_torch.ops import _build
    from trlx_tpu_torch.ops.decode_attention import decode_attention_int8_occupancy, paged_attention_occupancy
    from trlx_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_occupancy,
        flash_attention_fwd_short_occupancy,
        flash_bias_fwd_short_occupancy,
    )

    card = nvidia_smi()
    emit("device", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build()
    log = _build.build_log()
    fused = ptxas_report(log, "flash_bias_bwd_fused_kernel")
    fused_plain = ptxas_report(log, "flash_bwd_fused_kernel")
    short_fwd = ptxas_report(log, "flash_fwd_short_kernel")
    short_bias_fwd = ptxas_report(log, "flash_bias_fwd_short_kernel")
    short_paged = ptxas_report(log, "paged_attention_short_kernel")
    short_decode = ptxas_report(log, "decode_int8_short_kernel")
    # the long routes' instantiations this slice added (the earlier D = 64
    # ones are as they were): at head width 128 the flash forward, the dq
    # kernel, the dk/dv kernel's two halves, the int8 decode kernel at
    # groups 1, 2, 3, 4 and 8 (5 to 7 run in the 8-row one) and the paged
    # kernel's six (int8 / bf16 x 8, 16, 32 rows: fewer rows run in the
    # 8-row one); at 64 the int8 decode kernel at groups 2, 4 and 8
    long_new = {name: [f for f in ptxas_report(log, name)
                       if 128 in f["template_ints"]
                       or (name == "decode_int8_kernel" and f["template_ints"][1] not in (1, 3))]
                for name in ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                             "decode_int8_kernel", "paged_attention_kernel")}
    # the int8 decode step at the rollout shape (64 rows x 12 kv heads, a
    # 128-slot cache) and a GQA group of 3 at the short route's edge
    decode_occupancy = {"rollout": decode_attention_int8_occupancy("short", 12, 12, 128),
                        "gqa_256": decode_attention_int8_occupancy("short", 12, 4, 256)}
    # the engine's decode and verify steps in the training workload: 32
    # lanes x 12 kv heads, 5 pages of 16 int8 slots
    paged_occupancy = {"decode": paged_attention_occupancy("short", 1, 12, 12, 16, 5, True),
                       "verify": paged_attention_occupancy("short", 4, 12, 12, 16, 5, True)}
    tf_len = PROMPT_LEN + NEW_TOKENS
    short_occupancy = {"teacher_forced": flash_attention_fwd_short_occupancy(tf_len, tf_len, True, 0),
                       "prefill": flash_attention_fwd_short_occupancy(PROMPT_LEN, 128, True, 0)}
    # T5's self-attention: the encoder's and the decoder's lengths
    bias_fwd_occupancy = {"encoder": flash_bias_fwd_short_occupancy(T5_PROMPT_LEN, T5_PROMPT_LEN, False),
                          "decoder": flash_bias_fwd_short_occupancy(T5_DEC_LEN, T5_DEC_LEN, True)}
    # the head width 128 instantiations at the Llama path's shapes and the
    # largest GQA groups
    d128_occupancy = {
        "flash_fwd_short_prefill": flash_attention_fwd_short_occupancy(PROMPT_LEN, 128, True, 0, D=128),
        "flash_fwd_short_train": flash_attention_fwd_short_occupancy(TRAIN_LEN, TRAIN_LEN, True, 0, D=128),
        "flash_fwd_short_128": flash_attention_fwd_short_occupancy(128, 128, True, 0, D=128),
        "flash_bwd_fused_train": flash_attention_bwd_occupancy(TRAIN_LEN, TRAIN_LEN, D=128),
        "flash_bwd_fused_112": flash_attention_bwd_occupancy(112, 112, D=128),
        "decode_short_rollout": decode_attention_int8_occupancy("short", 32, 32, 128, D=128),
        "decode_short_gqa8_256": decode_attention_int8_occupancy("short", 64, 8, 256, D=128),
        "paged_short_decode": paged_attention_occupancy("short", 1, 32, 32, 16, 5, True, D=128),
        "paged_short_verify": paged_attention_occupancy("short", 4, 32, 32, 16, 5, True, D=128),
        "paged_short_verify_gqa8_bf16_256": paged_attention_occupancy("short", 4, 64, 8, 16, 16, False, D=128),
    }
    # kernel 9 (fp32 and bf16 gradients x its four update variants) and
    # kernel 10 (the stream route's eight tilings, the wgmma route's two)
    memory_kernels = (ptxas_report(log, "adam8bit_kernel") + ptxas_report(log, "w8a16_stream_kernel")
                      + ptxas_report(log, "w8a16_wgmma_kernel"))
    emit("build", seconds=time.perf_counter() - t0,
         ptxas=[ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln],
         flash_bias_bwd_fused=fused, flash_bwd_fused=fused_plain, flash_fwd_short=short_fwd,
         flash_fwd_short_occupancy=short_occupancy, flash_bias_fwd_short=short_bias_fwd,
         flash_bias_fwd_short_occupancy=bias_fwd_occupancy, paged_attention_short=short_paged,
         paged_attention_short_occupancy=paged_occupancy, decode_int8_short=short_decode,
         decode_int8_short_occupancy=decode_occupancy,
         flash_bwd_fused_occupancy={"train": flash_attention_bwd_occupancy(TRAIN_LEN, TRAIN_LEN),
                                    "t5_cross": flash_attention_bwd_occupancy(T5_DEC_LEN, T5_PROMPT_LEN)},
         long_new=long_new, d128_occupancy=d128_occupancy, nvcc_seconds=_build.build_seconds(),
         memory_kernels=memory_kernels)
    # the short and fused kernels at head widths 64 and 128 (eight
    # instantiations by ceil16(S) / 16 at each; the paged kernel's ten at
    # each; the int8 decode kernel's groups 1-8 at each), and the long
    # routes' new instantiations, all without spills
    for what, report, n in (("fused bias backward", fused, 8), ("fused flash backward", fused_plain, 16),
                            ("short flash forward", short_fwd, 16), ("short bias forward", short_bias_fwd, 8),
                            ("short paged kernel", short_paged, 20),
                            ("short int8 decode kernel", short_decode, 16),
                            ("D = 128 long flash forward", long_new["flash_fwd_kernel"], 1),
                            ("D = 128 dq kernel", long_new["flash_bwd_dq_kernel"], 1),
                            ("D = 128 dk/dv kernel", long_new["flash_bwd_dkv_kernel"], 2),
                            ("new long int8 decode kernel", long_new["decode_int8_kernel"], 8),
                            ("D = 128 long paged kernel", long_new["paged_attention_kernel"], 6),
                            ("kernel 9 and kernel 10", memory_kernels, 18)):
        if len(report) != n or any(f.get("spill_stores", 1) or f.get("spill_loads", 1) for f in report):
            raise AssertionError(f"the {what}'s {n} instantiations must build without spills: {report}")
    if short_occupancy["teacher_forced"]["ctas_per_sm"] < 3:
        raise AssertionError(f"the short flash forward must fit three CTAs an SM at T = S = {tf_len}: {short_occupancy}")
    if bias_fwd_occupancy["decoder"]["ctas_per_sm"] < 3:
        raise AssertionError(f"the short bias forward must fit three CTAs an SM at T = S = {T5_DEC_LEN}: "
                             f"{bias_fwd_occupancy}")
    if paged_occupancy["decode"]["ctas_per_sm"] < 3:
        raise AssertionError(f"the short paged kernel must fit three CTAs an SM at the decode shape: {paged_occupancy}")
    if decode_occupancy["rollout"]["ctas_per_sm"] < DECODE_SHORT_CTAS:
        raise AssertionError(f"the short int8 decode kernel must fit {DECODE_SHORT_CTAS} CTAs an SM at the rollout "
                             f"shape: {decode_occupancy}")
    if any(o["ctas_per_sm"] < 1 for o in d128_occupancy.values()):
        raise AssertionError(f"a head width 128 kernel cannot launch at its shape: {d128_occupancy}")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    if args.only == "paged":
        rows = paged_kernel_times(gen, {}, check_paged(gen)["by_route"])
    elif args.only == "fwd":
        rows = fwd_kernel_times(gen, {}, check_flash(gen))
    elif args.only == "decode":
        rows = decode_kernel_times(gen, {}, check_decode(gen)["by_route"])
    elif args.only == "bias":
        rows = bias_kernel_times(gen, {}, {}, {}, check_flash_bias(gen))
    elif args.only == "sft":
        sft_phases(args.seed, {})
        rows = []
    elif args.only == "ppo":
        trainer, _ = train_path(args.seed, {})
        train_split = cycle_split(trainer)
        del trainer
        torch.cuda.empty_cache()
        ppo_phases(args.seed, {}, train_split)
        rows = []
    elif args.only == "resume":
        resume_path(args.seed, {})
        rows = []
    elif args.only == "ilql":
        ilql_phases(args.seed, {}, {})
        rows = []
    elif args.only == "rft":
        rft_phases(args.seed, {})
        rows = []
    elif args.only == "grpo":
        grpo_phases(args.seed, {})
        rows = []
    elif args.only == "dpo":
        dpo_phases(args.seed, {})
        rows = []
    elif args.only == "llama":
        d128_errs = check_d128(gen)
        llama_shapes = {}
        llama = llama_phases(args.seed, llama_shapes)
        rows = llama_kernel_times(gen, llama, llama_shapes, d128_errs)
    elif args.only == "peft":
        peft_shapes, peft_bias_shapes = {}, {}
        peft = peft_phases(args.seed, peft_shapes, peft_bias_shapes)
        rows = peft_kernel_times(gen, peft, peft_shapes, peft_bias_shapes)
    elif args.only == "memory":
        rows = memory_kernel_times(gen, memory_phases(args.seed, {}))
    elif args.only == "w8a16":
        check_int8_matmul(gen)
        rows = w8a16_kernel_times(gen)
    elif args.only == "adam8bit":
        rows = adam8bit_rows(gen, check_adam8bit(gen)["by_leaf"], None)
        for row in rows:
            emit("kernel_time", **row)
    elif args.only == "health":
        health_phases(args.seed)
        rows = []
    if args.only is not None:
        print(json.dumps({"kernels": rows}))
        print(card)
        print(json.dumps({"ok": True, "only": args.only, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        }}))
        return 0
    flash_errs = check_flash(gen)
    decode_errs = check_decode(gen)["by_route"]
    bwd_errs = check_flash_bwd(gen)
    bias_errs = check_flash_bias(gen)
    paged_errs = check_paged(gen)["by_route"]
    d128_errs = check_d128(gen)
    check_rng(args.seed)
    shapes = {}  # path -> its gated run's forward launches by shape (forward_shapes)
    bias_shapes = {}  # path -> its gated run's bias forward launches by shape (bias_fwd_shapes)
    launches = main_path(args.seed, shapes)
    trainer, train_launches = train_path(args.seed, shapes)
    train_split = cycle_split(trainer)
    batch = train_reference(trainer, args.seed)["batch"]
    train_step_profile(trainer, batch)
    del trainer, batch
    torch.cuda.empty_cache()
    ppo_launches = ppo_phases(args.seed, shapes, train_split)
    ppo_launches["resume"] = resume_path(args.seed, shapes)
    sft_launches = sft_phases(args.seed, shapes)
    engine = engine_path(args.seed)
    paged_launches = {"engine_plain": engine["plain"], "engine_spec": engine["spec"],
                      "train_engine": train_engine_path(args.seed, shapes)["paged"]}
    torch.cuda.empty_cache()
    t5_launches = t5_path(args.seed, shapes, bias_shapes)
    torch.cuda.empty_cache()
    trainer, t5_train_launches = t5_train_path(args.seed, shapes, bias_shapes)
    batch = t5_train_reference(trainer, args.seed)["batch"]
    train_step_profile(trainer, batch, "t5_train_step")
    del trainer, batch
    torch.cuda.empty_cache()
    offline = ilql_phases(args.seed, shapes, bias_shapes)
    torch.cuda.empty_cache()
    offline.update(rft_phases(args.seed, shapes))
    torch.cuda.empty_cache()
    offline.update(grpo_phases(args.seed, shapes))
    offline.update(dpo_phases(args.seed, shapes))
    llama = llama_phases(args.seed, shapes)
    peft_shapes, peft_bias_shapes = {}, {}  # apart, so that the earlier rows' launches stay their paths'
    peft = peft_phases(args.seed, peft_shapes, peft_bias_shapes)
    memory_shapes = {}  # apart too: the recipe and 7B cells' kernel 1 launches by shape
    memory = memory_phases(args.seed, memory_shapes)
    torch.cuda.empty_cache()
    health_phases(args.seed)
    for phase, tallies in (("fwd_shapes", shapes), ("bias_fwd_shapes", bias_shapes), ("peft_fwd_shapes", peft_shapes),
                           ("peft_bias_fwd_shapes", peft_bias_shapes)):
        emit(phase, **{path: [[route, list(bht), S, n] for (route, bht, S), n in sorted(tally.items())]
                       for path, tally in tallies.items()})
    rows = fwd_kernel_times(gen, shapes, flash_errs)
    rows += decode_kernel_times(gen, {"rollout": launches["decode"], **{
        path: {"short": n["decode_short"], "long": n["decode_long"]}
        for path, n in (("train", train_launches), ("sft", sft_launches), *ppo_launches.items(),
                        *((path, offline[path]) for path in ("ilql", "rft", "grpo", "grpo_engine", "dpo")))}},
        decode_errs)
    rows += bwd_kernel_times(gen, train_launches, t5_train_launches, bwd_errs, sft_launches,
                             {**ppo_launches, **{path: offline[path] for path in ("ilql", "rft", "grpo", "grpo_engine")}},
                             offline["ilql_t5"], offline["dpo"])
    paged_launches["grpo_engine"] = {route: offline["grpo_engine"][f"paged_{route}"] for route in ("short", "long")}
    rows += paged_kernel_times(gen, paged_launches, paged_errs)
    rows += bias_kernel_times(gen, t5_train_launches, t5_launches, bias_shapes, bias_errs, offline["ilql_t5"])
    rows += llama_kernel_times(gen, llama, shapes, d128_errs)
    rows += peft_kernel_times(gen, peft, peft_shapes, peft_bias_shapes)
    rows += memory_kernel_times(gen, memory)
    emit("memory_fwd_shapes", **{path: [[route, list(bht), S, n] for (route, bht, S), n in sorted(tally.items())]
                                 for path, tally in memory_shapes.items()})
    emit("run", wall_s=time.perf_counter() - _START)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
