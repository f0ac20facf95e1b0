#!/usr/bin/env python3
"""Drive trlx_tpu_torch's PPO rollout and training paths on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the CUDA kernels from `trlx_tpu_torch/csrc` (into build/kernels/)
and holds each kernel against its plain PyTorch version on the card: the
flash forward, both routes of the flash backward (one fused kernel up
to 128 queries and keys; the dq and dk/dv kernels past that; causal, and
T5's non-causal cross-attention with more queries than keys), T5's
bias-carrying forward and both routes of its backward (one fused kernel
up to 128 queries and keys; the dq + dbias and dk/dv kernels past that),
the int8 decode step, the paged decode step; and checks that the per-lane sampler's
counter stream is the same on the CPU and the card. Then, at
GPT-2-small width (12 x 768, vocab 50257, random weights from the seed),
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
- the decode engine: `engine_generate` on the hydra policy (64 prompts,
  16 slots, int8 pages, greedy, with and without speculative decoding),
  on the paged kernel and on the plain gather math; then
  `trlx_tpu_torch.train` on the headline workload with
  `method.gen_engine` on (32 slots, the kernel, speculative decoding);
- seq2seq at T5-base width (12 + 12 x 768, vocab 32128): a
  `generate_seq2seq` rollout (64 prompts, 64 new tokens) and one
  `forward_train` experience pass against the plain bf16 and fp32 math,
  then `trlx_tpu_torch.train` with model_arch_type "seq2seq" and the
  settings of examples/ppo_sentiments_t5.py (two cycles of 48 rollouts,
  32 optimizer steps) and one train step against the same references.

Launch counters, zeroed before each path and read after it, show each
path ran through its kernels. Then the kernels are timed at the paths'
shapes beside their bounds, and one rollout, one experience pass, one
train step and one engine call of each mode are profiled.

Each phase prints one JSON line. The last two lines are the card's name
and power limit as nvidia-smi reports them, then
{"ok": true, "device": {...}}. Any failure raises and exits non-zero
without that line; with no CUDA device the script exits 2 at once.
"""

from __future__ import annotations

import argparse
import json
import math
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
T5_PROMPT_LEN, T5_NEW_TOKENS = 32, 64
T5_DEC_LEN = T5_NEW_TOKENS + 1  # the decoder start token and the response


_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line per phase; `t_s` is the command's seconds so far."""
    print(json.dumps({"phase": phase, "t_s": round(time.perf_counter() - _START, 3), **fields}), flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


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
                nk = re.search(r"ILi(\d+)E", m.group(1))
                cur["nk"] = int(nk.group(1)) if nk else None
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


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes, t_flops = n_bytes / HBM_BYTES_PER_S, n_flops / BF16_FLOPS
    return max(t_bytes, t_flops) * 1e3, "bytes" if t_bytes >= t_flops else "operations"


# ---------------------------------------------------------------------------
# kernel inputs
# ---------------------------------------------------------------------------


def flash_inputs(gen, B, H, Hkv, T, S, D, q_offset, unwritten=False):
    """bf16 q/k/v and a left-padded key mask; `unwritten` also masks the
    cache slots past the prompt, as a prefill sees them."""
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v = randn(B, H, T, D), randn(B, Hkv, S, D), randn(B, Hkv, S, D)
    pad = torch.randint(0, T // 2 + 1, (B,), generator=gen, device="cuda")
    pad[0] = T  # one fully padded row: every query fully masked
    slots = torch.arange(S, device="cuda")[None, :]
    mask = (slots >= q_offset + pad[:, None]) | (slots < q_offset)
    if unwritten:
        mask &= slots < q_offset + T
    return q, k, v, mask.to(torch.int32)


def flash_work(mask, H, Hkv, T, S, D, q_offset):
    """Bytes and operations the causal attention function needs on this
    mask. A query row weighs the unmasked slots of its causal window, so K
    is needed only for slots inside some row's window; a fully masked row
    averages V over all S slots, so V is needed in full for the batch rows
    that hold one and only for the weighed slots elsewhere. q and out are
    bf16, m and l fp32, the mask int32."""
    import torch

    slots = torch.arange(S, device="cuda")
    rows = torch.arange(T, device="cuda")[:, None] + q_offset
    pairs = (rows >= slots[None, :])[None] & (mask[:, None, :] > 0)  # [B, T, S]
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


def decode_inputs(gen, L, B, H, Hkv, S, D, written):
    import torch

    q = torch.randn((B, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    ck = torch.randint(-127, 128, (L, B, Hkv, S, D), generator=gen, device="cuda").to(torch.int8)
    cv = torch.randint(-127, 128, (L, B, Hkv, S, D), generator=gen, device="cuda").to(torch.int8)
    ks = torch.rand((L, B, Hkv, 1, S), generator=gen, device="cuda") * 0.02
    vs = torch.rand((L, B, Hkv, 1, D), generator=gen, device="cuda") * 0.02
    pad = torch.randint(0, written // 2, (B,), generator=gen, device="cuda")
    slots = torch.arange(S, device="cuda")[None, :]
    mask = ((slots >= pad[:, None]) & (slots < written)).to(torch.int32)
    return q, ck, cv, ks, vs, mask


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def check_flash(gen) -> dict:
    """Kernel A against flash_attention_plain on the same bf16 inputs."""
    import torch

    from trlx_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    cases = {  # name: (B, H, Hkv, T, S, D, q_offset, unwritten, causal)
        "prefill": (64, 12, 12, PROMPT_LEN, 128, 64, 0, True, True),
        "teacher_forced": (64, 12, 12, PROMPT_LEN + NEW_TOKENS, PROMPT_LEN + NEW_TOKENS, 64, 0, False, True),
        "long": (8, 12, 12, 1024, 1024, 64, 0, False, True),
        "gqa": (8, 12, 4, 200, 200, 64, 0, False, True),
        "prefill_offset": (4, 4, 4, 37, 128, 64, 5, True, True),  # ragged, at an offset
        # T5's cross-attention: not causal, no scale, 65 decoder rows over
        # a 32-slot encoder (the default offset S - T is negative, ignored)
        "t5_cross": (12, 12, 12, T5_DEC_LEN, T5_PROMPT_LEN, 64, 0, False, False),
    }
    worst = 0.0
    for name, (B, H, Hkv, T, S, D, off, unwritten, causal) in cases.items():
        q, k, v, mask = flash_inputs(gen, B, H, Hkv, T, S, D, off, unwritten)
        kw = dict(q_offset=off if unwritten else None, with_stats=True, causal=causal,
                  sm_scale=None if causal else 1.0)
        out, m, l = flash_attention(q, k, v, mask, **kw)
        torch.cuda.synchronize()
        ref, m_ref, l_ref = flash_attention_plain(q.float(), k.float(), v.float(), mask, **kw)
        err = (out.float() - ref).abs().max().item()
        m_rel = ((m - m_ref).abs() / m_ref.abs().clamp(min=1.0)).max().item()
        l_rel = ((l - l_ref).abs() / l_ref.abs().clamp(min=1.0)).max().item()
        emit("flash_check", case=name, shape=[B, H, Hkv, T, S, D], causal=causal, max_abs_err=err,
             m_rel_err=m_rel, l_rel_err=l_rel)
        if not (err <= 2e-2 and m_rel <= 1e-3 and l_rel <= 1e-3):
            raise AssertionError(f"flash kernel disagrees with its plain version on {name}")
        worst = max(worst, err)
    return {"max_abs_err": worst}


BWD_CASES = {  # name: (B, H, Hkv, T, S, q_offset, unwritten, causal)
    "train": (32, 12, 12, TRAIN_LEN, TRAIN_LEN, 0, False, True),
    "experience": (64, 12, 12, PROMPT_LEN + NEW_TOKENS, PROMPT_LEN + NEW_TOKENS, 0, False, True),
    "prefill_offset": (4, 4, 4, 37, 128, 5, True, True),
    "gqa": (8, 12, 4, 200, 200, 0, False, True),
    "long": (8, 12, 12, 1024, 1024, 0, False, True),
    "ragged": (4, 12, 12, 50, 100, 50, False, True),  # T < S, S not a multiple of 64
    "t5_cross": (12, 12, 12, T5_DEC_LEN, T5_PROMPT_LEN, 0, False, False),  # not causal, T > S, scale 1
    "max_fused": (8, 12, 12, 128, 128, 0, False, True),  # the fused kernel's largest shape
    "gqa_fused": (8, 12, 4, 100, 100, 0, False, True),  # a GQA group of 3 inside one CTA
    # T > S, causal at the default offset S - T: the first 32 rows attend
    # no slot (fully masked by causality, not by padding)
    "causal_t_gt_s": (4, 12, 12, 80, 48, -32, False, True),
    "just_long": (4, 12, 12, 129, 129, 0, False, True),  # the long route's shortest shape
}


def flash_bwd_inputs(gen, B, H, Hkv, T, S, q_offset, unwritten, causal=True):
    """Kernel inputs of the backward: q/k/v/mask as `flash_inputs` makes
    them (batch row 0 fully padded), the forward kernel's (out, m, l) and a
    bf16 output gradient. Without `causal` the scale is T5's 1.0."""
    import torch

    from trlx_tpu_torch.ops.flash_attention import flash_attention

    q, k, v, mask = flash_inputs(gen, B, H, Hkv, T, S, 64, q_offset, unwritten)
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


def check_flash_bwd(gen) -> dict:
    """Both routes of the flash backward (the fused kernel up to 128
    queries and keys, the dq and dk/dv kernels past that) against
    flash_attention_backward_plain on the same bf16 inputs upcast to fp32:
    max |error| / max(|ref|, 1) under 2e-2 for dq, dk and dv, and for dv
    of the fully padded batch row alone (every query of it is fully
    masked, so its dv is the uniform 1/l weights' sum of dO at every
    slot). Each case runs the route the wrapper picks, and the launch
    counters must show that route and no other; a case the fused kernel
    takes also runs the long route, and the fused kernel's results must be
    bit-identical on a second call."""
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
    worst = {"rel": 0.0, "fused": 0.0, "dq": 0.0, "dkv": 0.0}  # max |error| of each kernel's outputs
    for name, (B, H, Hkv, T, S, off, unwritten, causal) in BWD_CASES.items():
        q, k, v, mask, out, m, l, g = flash_bwd_inputs(gen, B, H, Hkv, T, S, off, unwritten, causal)
        scale = 64 ** -0.5 if causal else 1.0
        route = backward_route(T, S)
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
        emit("flash_bwd_check", case=name, shape=[B, H, Hkv, T, S, 64], q_offset=off, causal=causal, route=route,
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
    return worst


BIAS_CASES = {  # name: (B, H, T = S, causal, mask kind)
    "encoder": (12, 12, T5_PROMPT_LEN, False, "right_pad"),
    "decoder": (12, 12, T5_DEC_LEN, True, "pad_tail"),
    "max_fused": (12, 12, 128, True, "pad_tail"),  # the fused backward's largest shape
    "one": (12, 12, 1, True, "right_pad"),
    "b64": (64, 12, T5_DEC_LEN, True, "pad_tail"),  # 768 CTAs: a head's rows in several waves
    "long": (4, 12, 512, False, "right_pad"),
    "ragged": (4, 12, 100, True, "masked_row"),
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
    """Kernels 4-6 (the bias forward and the backward's two routes: the
    fused kernel up to 128 queries and keys, the dq + dbias and dk/dv
    kernels past that) against the plain versions on the same bf16 inputs
    upcast to fp32: out, dq, dk, dv and dbias each within 2e-2 of max
    |error| / max(|ref|, 1). Each case runs the route the wrapper picks;
    a case the fused kernel takes also runs the long route. m and l are
    held row by row, within 2e-2 of |error| / max(|ref|, 1), on the rows
    that attend some slot; a row that attends none must hold exactly
    m = -1e30 and l = S (every slot weighs exp(0)). The fused kernel's
    results must be bit-identical when it runs again on the same inputs,
    and again after a launch with more heads, which leaves its arrival
    counters zero as every launch must."""
    import torch

    from trlx_tpu_torch.ops import flash_attention as fa
    from trlx_tpu_torch.ops.flash_attention import (
        NEG_INF,
        _bias_valid_pairs,
        bias_backward_route,
        flash_attention_bias,
        flash_attention_bias_backward,
        flash_attention_bias_backward_plain,
        flash_attention_bias_bwd_occupancy,
        flash_attention_bias_plain,
    )

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1.0)).item()

    def rel_rows(a, b, rows):
        if not rows.any():
            return 0.0
        return ((a - b).abs() / b.abs().clamp(min=1.0))[rows].max().item()

    def max_abs(a, b):
        return (a.float() - b.float()).abs().max().item()

    worst = {"fwd": 0.0, "fused": 0.0, "dq_dbias": 0.0, "dkv": 0.0}  # max |error| of each kernel's outputs
    for name, (B, H, T, causal, kind) in BIAS_CASES.items():
        q, k, v, mask, bias, out, m, l, g = flash_bias_inputs(gen, B, H, T, causal, kind)
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
        errs = {"out": rel(out, ref_out), "m": rel_rows(m, ref_m, live), "l": rel_rows(l, ref_l, live)}
        dead = ~live
        if not (bool((m[dead] == NEG_INF).all()) and bool((l[dead] == T).all())):
            raise AssertionError(f"rows that attend no slot must hold m = -1e30 and l = {T} on {name}: "
                                 f"m {m[dead].unique().tolist()[:4]}, l {l[dead].unique().tolist()[:4]}")
        keys = ("dq", "dk", "dv", "dbias")
        bwd_errs = {r: {key: rel(a, b) for key, a, b in zip(keys, res, ref)} for r, res in got.items()}
        abs_err = {r: {key: max_abs(a, b) for key, a, b in zip(keys, res, ref)} for r, res in got.items()}
        abs_err["out"] = max_abs(out, ref_out)
        emit("flash_bias_check", case=name, shape=[B, H, T, T, 64], causal=causal, mask=kind, route=route,
             rel_err={**errs, **bwd_errs}, max_abs_err=abs_err, rows_attending_none=int(dead.sum().item()),
             fused_occupancy=flash_attention_bias_bwd_occupancy(T, T) if route == "fused" else None)
        if not all(e <= 2e-2 for e in list(errs.values()) + [e for r in bwd_errs.values() for e in r.values()]):
            raise AssertionError(f"bias kernels disagree with the plain versions on {name}: {errs} {bwd_errs}")
        worst["fwd"] = max(worst["fwd"], abs_err["out"])
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


def check_decode(gen) -> dict:
    """Kernel B against decode_attention_int8_plain on the same inputs."""
    import torch

    from trlx_tpu_torch.ops.decode_attention import (
        decode_attention_int8,
        decode_attention_int8_plain,
    )

    worst = 0.0
    for name, (L, B, H, Hkv, S, D, written) in {
        "rollout": (12, 64, 12, 12, 128, 64, PROMPT_LEN + NEW_TOKENS),
        "gqa": (2, 8, 12, 4, 200, 64, 150),
    }.items():
        q, ck, cv, ks, vs, mask = decode_inputs(gen, L, B, H, Hkv, S, D, written)
        if name == "gqa":
            mask[1] = 0  # a fully masked row averages V uniformly over all S
        errs = []
        for ix in range(L):
            out = decode_attention_int8(q, ck, cv, ks, vs[ix], mask, ix, D ** -0.5)
            torch.cuda.synchronize()
            ref = decode_attention_int8_plain(q.float(), ck, cv, ks, vs[ix], mask, ix, D ** -0.5)
            errs.append((out.float() - ref.float()).abs().max().item())
        emit("decode_check", case=name, shape=[L, B, H, Hkv, S, D], max_abs_err=max(errs))
        if max(errs) > 2e-2:
            raise AssertionError(f"int8 decode kernel disagrees with its plain version on {name}")
        worst = max(worst, max(errs))
    return {"max_abs_err": worst}


def paged_inputs(gen, B, T, H, Hkv, PS, MP, quant, depths, L=12, nulls=()):
    """A paged pool of L layers with every lane's pages, the step's q/k/v and
    the engine's bias. Lane b holds depths[b] tokens before the step's T
    (left padding masks the first pad[b] slots); a lane's pages past its
    depth are null, and so is each (lane, page) in `nulls`, whose slots
    the bias masks as the engine's key mask does for a released page."""
    import torch

    from trlx_tpu_torch.ops import paged_kv

    S = MP * PS
    NP = 1 + B * MP
    D = 64
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


def paged_work(visible, table, H, Hkv, T, PS, quant):
    """Bytes and operations the paged attention function needs on this
    table and mask: the K and V rows (and with int8 their per-row scales)
    of every slot some query of the lane sees, bf16 q and out, the fp32
    bias and the int32 table; 4 * D operations per visible (query head,
    slot) pair."""
    D = 64
    seen = visible.any(dim=1)  # [B, S]
    n_rows = int(seen.sum().item()) * Hkv
    row_bytes = 2 * D * (1 if quant else 2) + (8 if quant else 0)
    B, S = seen.shape
    n_bytes = n_rows * row_bytes + 2 * 2 * B * T * H * D + 4 * B * T * S + 4 * table.numel()
    return n_bytes, 4 * D * H * int(visible.sum().item())


def check_paged(gen) -> dict:
    """The paged kernel against paged_attention_plain on the card, through
    paged_attention_step(impl="pallas") (the write half included): page
    sizes 8, 16 and 128, T 1 and 4, int8 and bf16 pools, GQA groups 1 and
    3, layer 5 of 12, ragged lane depths down to 1, a null page in the
    middle of a lane's table and a lane_valid=False lane. Every query row
    here sees some slot, so every row is compared."""
    import torch

    from trlx_tpu_torch.ops.decode_attention import paged_attention_plain, paged_attention_step

    cases = {  # name: (B, T, H, Hkv, PS, MP, quant, depths, nulls)
        "decode_int8_ps16": (8, 1, 12, 12, 16, 5, "int8", [1, 5, 16, 17, 40, 63, 70, 33], [(3, 1)]),
        "verify_int8_ps16": (8, 4, 12, 12, 16, 5, "int8", [1, 5, 16, 17, 40, 60, 70, 33], [(4, 1)]),
        "decode_bf16_ps8": (6, 1, 12, 4, 8, 9, None, [1, 9, 30, 64, 20, 7], [(3, 2)]),
        "verify_bf16_gqa_ps8": (6, 4, 12, 4, 8, 9, None, [2, 9, 30, 64, 20, 7], [(3, 4)]),
        "verify_int8_gqa_ps128": (4, 4, 12, 4, 128, 2, "int8", [1, 100, 127, 200], [(3, 0)]),
        "decode_int8_ps128": (4, 1, 12, 12, 128, 2, "int8", [3, 129, 250, 60], []),
    }
    worst = 0.0
    for name, (B, T, H, Hkv, PS, MP, quant, depths, nulls) in cases.items():
        q, kn, vn, pools, table, slot_pos, bias, visible = paged_inputs(
            gen, B, T, H, Hkv, PS, MP, quant, depths, nulls=nulls)
        lane_valid = torch.ones(B, dtype=torch.bool, device="cuda")
        lane_valid[1] = False
        out, pools = paged_attention_step(q, kn, vn, pools, 5, table, slot_pos, bias, 64 ** -0.5,
                                          lane_valid=lane_valid, impl="pallas")
        torch.cuda.synchronize()
        ref = paged_attention_plain(q.float(), pools, 5, table, bias, 64 ** -0.5)
        seen = visible.any(dim=-1)[:, :, None, None].expand(B, T, H, 64)
        if not bool(seen.all()):
            raise AssertionError(f"{name}: every query row must see a slot")
        err = ((out.float() - ref).abs().max() / ref.abs().max().clamp(min=1.0)).item()
        emit("paged_check", case=name, shape=[B, T, H, Hkv, PS, MP], quant=quant, rel_err=err)
        if err > 2e-2:
            raise AssertionError(f"paged kernel disagrees with its plain version on {name}")
        worst = max(worst, err)
    return {"max_abs_err": worst}


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
    """`engine_generate` on the hydra GPT-2-small policy (branch_at=10):
    64 byte prompts left-padded to 32, budgets cycling (8, 16, 24, 40) over
    40 new tokens, 16 slots, 16-token int8 pages, greedy; without and with
    speculative decoding (draft_k=4, the hydra draft sharing the trunk's
    pages). Each runs on the kernel (impl="pallas") and on the plain gather
    math (impl="xla") on the card. Gates: per-step (>= 95%) and
    free-running (>= 90%) greedy agreement, the exact pool balance, the
    kernel's acceptance within 5 points of the plain path's,
    paged launches == n_layer x decode_steps, and flash launches a
    positive multiple of n_layer (the refills' prefills)."""
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
    with torch.no_grad():
        for mode, kw in modes.items():
            for impl in ("pallas", "xla"):
                paged_attention.launches = flash_attention.launches = 0
                out = run(impl, kw)
                torch.cuda.synchronize()
                outs[mode, impl] = out
                launches[mode, impl] = {"paged": paged_attention.launches, "flash": flash_attention.launches}
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
                # each refill prefills through the flash forward, once a layer
                n_flash = launches[mode, impl]["flash"]
                if n_flash == 0 or n_flash % L:
                    raise AssertionError(f"engine {mode}/{impl}: flash launches {n_flash} are not whole prefills")
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
        samples = []
        with torch.no_grad():
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = run("pallas", kw)
                torch.cuda.synchronize()
                samples.append(time.perf_counter() - t0)
        wall = statistics.median(samples)
        emit("engine_time", mode=mode, wall_s=wall, samples_s=samples, real_tokens=out["gen_stats"]["real_tokens"],
             tokens_per_s=out["gen_stats"]["real_tokens"] / wall, decode_steps=out["gen_stats"]["decode_steps"],
             occupancy=out["gen_stats"]["occupancy"])
        with torch.no_grad():
            profile_phase(f"engine_{mode}", lambda: run("pallas", kw), wall, host_ops=False)
    return {mode: launches[mode, "pallas"]["paged"] for mode in modes}


def build_policy(seed: int, attention_impl: str, kv_cache_quant, **transformer_kw):
    import torch

    from trlx_tpu_torch.data.default_configs import default_ppo_config
    from trlx_tpu_torch.models.wrappers import CausalLMWithValueHead

    transformer = dict(GPT2_SMALL, attention_impl=attention_impl,
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


def main_path(seed: int) -> dict:
    import torch

    from trlx_tpu_torch.models.generation import SamplerSettings, generate, make_generate_fn
    from trlx_tpu_torch.ops.common import logprobs_of_labels
    from trlx_tpu_torch.ops.decode_attention import decode_attention_int8
    from trlx_tpu_torch.ops.flash_attention import flash_attention
    from trlx_tpu_torch.utils.tokenizers import ByteTokenizer

    config, policy = build_policy(seed, "pallas", "int8_kernel")
    if policy.branch_at != 10 or policy.cfg.dtype != torch.bfloat16:
        raise AssertionError("the default PPO config must give branch_at=10 and bf16 compute")
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

    with torch.no_grad():
        flash_attention.launches = 0
        decode_attention_int8.launches = 0
        out_g = make_generate_fn(policy.base, greedy)(ids, mask, None)
        out_s = make_generate_fn(policy.base, sampled)(ids, mask, gen)
        torch.cuda.synchronize()
        rollout_flash = flash_attention.launches
        seqs = out_s["sequences"]
        attn = torch.cat([mask, out_s["response_mask"]], dim=1)
        exp, lp = experience(policy, ref_params, seqs, attn)
        torch.cuda.synchronize()
        launches = {"flash": flash_attention.launches, "decode": decode_attention_int8.launches}

    L = policy.cfg.n_layer
    steps = [int(o["response_mask"].sum(dim=1).max().item()) - 1 for o in (out_g, out_s)]
    expect = {"flash": 2 * L + (L + (L - policy.branch_at)), "decode": L * sum(steps)}
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
            fn()
            samples = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[name] = fn()
                torch.cuda.synchronize()
                samples.append(time.perf_counter() - t0)
            walls[name] = statistics.median(samples)
    new_tokens = int(outs["rollout"]["response_mask"].sum().item())
    emit("rollout_time", rollout_s=walls["rollout"], new_tokens=new_tokens,
         tokens_per_s=new_tokens / walls["rollout"], experience_s=walls["experience"],
         batch=B, prompt_len=PROMPT_LEN, max_new_tokens=NEW_TOKENS)
    for name, fn in (("rollout", rollout), ("experience", score)):
        profile_phase(name, fn, walls[name])
    return {"flash_prefill": rollout_flash, "flash_teacher_forced": launches["flash"] - rollout_flash,
            "decode": launches["decode"]}


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


def train_reward_fn(samples, prompts, outputs, **kw):
    return [float(o.count("a")) - 0.1 * len(o) for o in outputs]


def train_config(seed: int, attention_impl="pallas", kv_cache_quant="int8_kernel", compute_dtype="bfloat16"):
    from trlx_tpu_torch.data.default_configs import default_ppo_config

    transformer = dict(GPT2_SMALL, attention_impl=attention_impl, kv_cache_quant=kv_cache_quant)
    return default_ppo_config().evolve(
        train=dict(batch_size=TRAIN_BATCH, total_steps=TRAIN_STEPS, eval_interval=10_000,
                   checkpoint_interval=10_000, seq_length=TRAIN_LEN, epochs=10_000, tracker=None,
                   compute_dtype=compute_dtype, seed=seed),
        model=dict(model_path="random", num_layers_unfrozen=-1,
                   model_extra_configs={"transformer": transformer}),
        tokenizer=dict(tokenizer_path="byte"),
        method=dict(num_rollouts=TRAIN_ROLLOUTS, chunk_size=TRAIN_ROLLOUTS, ppo_epochs=TRAIN_EPOCHS,
                    gen_kwargs=dict(max_new_tokens=TRAIN_NEW_TOKENS, top_k=0, top_p=1.0, do_sample=True)),
    )


def train_path(seed: int):
    """`trlx_tpu_torch.train` on the headline workload at GPT-2-small width
    (random weights from the seed, everything trainable, a full frozen
    reference copy, bf16 compute / fp32 params, the flash and int8 decode
    kernels): evaluate, two rollout cycles, 16 optimizer steps, evaluate.
    Gates: finite losses, the launch counts, trainable parameters moved,
    the frozen reference did not."""
    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch.ops import flash_attention as fa
    from trlx_tpu_torch.ops.decode_attention import decode_attention_int8

    counters = {"flash_fwd": fa.flash_attention, "flash_bwd": fa.flash_attention_bwd,
                "flash_bwd_dq": fa.flash_attention_dq, "flash_bwd_dkv": fa.flash_attention_dkv,
                "decode": decode_attention_int8}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer = trlx_tpu_torch.train(reward_fn=train_reward_fn, prompts=TRAIN_PROMPTS, config=train_config(seed))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}

    L = trainer.model.cfg.n_layer
    cycles = TRAIN_STEPS // (TRAIN_EPOCHS * TRAIN_ROLLOUTS // TRAIN_BATCH)
    # every sampler call (a rollout a cycle, an eval at each end) prefills
    # through the forward kernel; each experience chunk runs the policy and
    # the full reference copy; each train step one forward and one
    # backward through every layer, the backward on the fused route (64
    # queries and keys)
    expect = {"flash_fwd": L * ((cycles + 2) + 2 * cycles + TRAIN_STEPS),
              "flash_bwd": L * TRAIN_STEPS, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    steps = [(step, st["losses/total_loss"], st["policy/approx_kl"])
             for step, st in trainer.stats_history if "losses/total_loss" in st]
    rewards = [st["reward/mean"] for _, st in trainer.stats_history if "reward/mean" in st]
    rollout_scores = [st["rollout_scores/mean"] for _, st in trainer.stats_history if "rollout_scores/mean" in st]
    emit("train_path", wall_s=wall, launches=launches, expected=expect, iter_count=trainer.iter_count,
         losses=[x[1] for x in steps], approx_kl=[x[2] for x in steps], eval_reward_mean=rewards,
         rollout_score_mean=rollout_scores, kl_ctl_value=trainer.kl_ctl.value,
         cycle_seconds=cycle_split(trainer))
    if len(steps) != TRAIN_STEPS or not all(math.isfinite(x[1]) for x in steps):
        raise AssertionError(f"expected {TRAIN_STEPS} finite losses, got {[x[1] for x in steps]}")
    if {k: launches[k] for k in expect} != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    if not (0 < launches["decode"] <= L * (cycles + 2) * (TRAIN_NEW_TOKENS - 1) and launches["decode"] % L == 0):
        raise AssertionError(f"decode launches {launches['decode']} are not whole decode steps of {L} layers")

    check_params_moved(trainer, seed)
    return trainer, launches


def check_params_moved(trainer, seed: int, phase: str = "train_params") -> None:
    """Every trainable tensor moved from its seeded init; the frozen
    reference copy did not."""
    import torch

    init = type(trainer.model)(trainer.model.cfg, device="cuda").init_params(torch.Generator().manual_seed(seed))
    start = dict(init.named_parameters())
    still = [n for n, p in trainer.model.named_parameters() if torch.equal(p, start[n])]
    ref_moved = [n for n, p in trainer.ref_params.named_parameters() if not torch.equal(p, start["base." + n])]
    rel_bias = {n: (p - start[n]).abs().max().item() for n, p in trainer.model.named_parameters()
                if n.endswith("rel_bias")}
    emit(phase, trainable=len(trainer.trainable_params), unmoved=still, reference_moved=ref_moved,
         rel_bias_max_abs_move=rel_bias)
    if still or ref_moved or len(trainer.trainable_params) != len(start):
        raise AssertionError(f"parameters that did not move: {still}; reference tensors that moved: {ref_moved}")


def cycle_split(trainer) -> list:
    """Seconds of each rollout cycle by phase, from the trainer's marks."""
    marks = trainer.phase_marks + [dict(trainer.phase_seconds)]
    return [{"rollout": marks[i + 1].get("generate", 0.0) - marks[i].get("generate", 0.0),
             **{k: marks[i + 1].get(k, 0.0) - marks[i].get(k, 0.0) for k in ("experience", "train", "eval")}}
            for i in range(len(marks) - 1)]


ENGINE_TRAIN = dict(enabled=True, slots=32, page_size=16, paged_attention_impl="pallas", spec_decode=True, draft_k=4)


def train_engine_path(seed: int) -> dict:
    """`trlx_tpu_torch.train` on the headline workload with rollouts (and
    evaluations) through the decode engine: 32 slots, 16-token int8 pages,
    the paged kernel, speculative decoding with draft_k=4 off the full
    frozen reference copy. Gates: paged launches == n_layer x the decode
    steps of every engine call, the engine's rollout stats, no pool
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
    paged_attention.launches = 0
    TPUBaseTrainer._engine_generate = counted
    try:
        t0 = time.perf_counter()
        trainer = trlx_tpu_torch.train(reward_fn=train_reward_fn, prompts=TRAIN_PROMPTS, config=config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        TPUBaseTrainer._engine_generate = engine_generate
    L = trainer.model.cfg.n_layer
    steps = sum(g["decode_steps"] for g in calls)
    launches = paged_attention.launches
    keys = ("rollout/engine_occupancy", "rollout/engine_refills", "rollout/engine_decode_steps",
            "rollout/engine_reclaimed_pages", "rollout/spec_accept_rate")
    rollouts = [{k: st[k] for k in keys if k in st} for _, st in trainer.stats_history if "rollout/engine_refills" in st]
    losses = [st["losses/total_loss"] for _, st in trainer.stats_history if "losses/total_loss" in st]
    emit("train_engine_path", wall_s=wall, engine_calls=len(calls), decode_steps=steps, paged_launches=launches,
         expected=L * steps, iter_count=trainer.iter_count, rollout_stats=rollouts, losses=losses,
         oom_truncated=sum(g["oom_truncated"] for g in calls), unserved=sum(g["unserved"] for g in calls),
         cycle_seconds=cycle_split(trainer))
    if launches != L * steps or not calls:
        raise AssertionError(f"paged launches {launches} != {L} x {steps} engine decode steps")
    if not rollouts or any(set(r) != set(keys) for r in rollouts):
        raise AssertionError(f"the engine's rollout stats are missing: {rollouts}")
    if any(g["oom_truncated"] or g["unserved"] for g in calls):
        raise AssertionError("the engine's page pool ran out")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"expected {TRAIN_STEPS} finite losses, got {losses}")
    check_params_moved(trainer, seed, "train_engine_params")
    del trainer
    return {"paged": launches}


def train_reference(trainer, seed: int, configs=None, rollouts: int = TRAIN_REFERENCE_ROLLOUTS,
                    batch_size: int = TRAIN_BATCH, phase: str = "train_reference") -> dict:
    """One train step's loss and gradients from the same parameters on
    the same minibatches, three ways: the kernel path (the trainer
    itself), the plain bf16 path (attention_impl="xla") and the plain
    fp32 path (`configs` gives the two plain trainers' configs; by default
    the GPT-2 train path's). The minibatches: a fresh store of `rollouts`
    rollouts from the trained policy, cut by two shuffles. Gate: the kernel
    path strays from fp32 at most twice as far as the plain bf16 path in
    the loss, the response tokens' logprobs and values (mean |error| over
    the minibatches), and in ||d grad|| / ||grad|| of every trainable
    tensor (both norms over all the minibatches' gradients together); and
    the median of that ratio over the tensors is at most 1.1. One
    minibatch's loss error, or the gradient error of a tensor that sums a
    whole batch into one number (the value head's output bias), is a
    single draw of bf16 rounding noise that swings by 10x between
    minibatches on either bf16 path, so the gate needs many independent
    rows to compare two such draws."""
    import torch

    from trlx_tpu_torch.utils.loading import get_trainer

    if configs is None:
        configs = {
            "plain_bf16": train_config(seed, attention_impl="xla", kv_cache_quant="int8"),
            "fp32": train_config(seed, attention_impl="xla", kv_cache_quant=None, compute_dtype="float32"),
        }
    trainer.store.clear_history()
    trainer.make_experience(rollouts, trainer.iter_count)
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    paths = {"kernel": trainer}
    for name, config in configs.items():
        paths[name] = get_trainer(config.train.trainer)(config=config, reward_fn=train_reward_fn)
        paths[name].model.load_state_dict(state)

    def step(t, batch):
        t.model.zero_grad(set_to_none=True)
        loss, _ = t.loss(batch)
        loss.backward()
        with torch.no_grad():
            lp, values = t.response_logprobs_and_values(batch)
        torch.cuda.synchronize()
        grads = {n: p.grad.detach().float().clone() for n, p in t.model.named_parameters() if p.requires_grad}
        t.model.zero_grad(set_to_none=True)
        return loss.item(), grads, lp.float(), values.float()

    batches = [b for s in (seed, seed + 1)
               for b in trainer.store.create_loader(batch_size, shuffle=True, drop_last=True, seed=s)]
    errs = {name: [] for name in ("kernel", "plain_bf16")}  # per minibatch: |d loss|, |d logprob|, |d value|
    # per tensor, summed over the minibatches: ||d grad||^2 of each path, ||grad||^2 of fp32
    sq = {name: {} for name in ("kernel", "plain_bf16", "fp32")}
    losses = []
    for batch in batches:
        res = {name: step(t, batch) for name, t in paths.items()}
        loss32, g32, lp32, v32 = res["fp32"]
        real = batch.response_mask.bool()
        losses.append({k: v[0] for k, v in res.items()})
        for n, g in g32.items():
            sq["fp32"][n] = sq["fp32"].get(n, 0.0) + g.square().sum().item()
        for name, e in errs.items():
            loss, g, lp, values = res[name]
            e.append((abs(loss - loss32), (lp - lp32)[real].abs().mean().item(),
                      (values - v32)[real].abs().mean().item()))
            for n in g:
                sq[name][n] = sq[name].get(n, 0.0) + (g[n] - g32[n]).square().sum().item()
        del res
    del paths

    def mean(name, i):
        return statistics.mean(e[i] for e in errs[name])

    grad = {name: {n: math.sqrt(sq[name][n] / max(sq["fp32"][n], 1e-60)) for n in sq["fp32"]}
            for name in errs}
    # the key projection's bias has a zero gradient in exact arithmetic (it
    # shifts every score of a query row equally): all three paths compute
    # rounding noise there, so it is reported and not gated
    noise = [n for n in grad["kernel"] if n.endswith("attn.k.bias")]
    gated = [n for n in grad["kernel"] if n not in noise]
    gk, gp = grad["kernel"], grad["plain_bf16"]
    ratio = {n: gk[n] / max(gp[n], 1e-30) for n in gated}
    worse = [n for n in gated if ratio[n] > 2]
    median = statistics.median(ratio.values())
    summary = {what: {"kernel": mean("kernel", i), "plain_bf16": mean("plain_bf16", i)}
               for i, what in enumerate(("loss", "logprobs", "values"))}
    emit(phase, minibatches=len(batches), losses=losses,
         loss_err_by_minibatch={name: [e[0] for e in errs[name]] for name in errs},
         mean_abs_err=summary, grad_rel_err_kernel_max=max(gk[n] for n in gated),
         grad_rel_err_plain_bf16_max=max(gp[n] for n in gated), grad_rel_err_ratio_max=max(ratio.values()),
         grad_rel_err_ratio_median=median,
         rel_bias_grad_rel_err={n: {"kernel": gk[n], "plain_bf16": gp[n], "ratio": ratio[n]}
                                for n in gated if n.endswith("rel_bias")},
         grad_rel_err_ratio_top=[(n, r, gk[n], gp[n]) for n, r in sorted(ratio.items(), key=lambda kv: -kv[1])[:5]],
         tensors=len(gated), tensors_over_2x=worse,
         not_gated={n: {"kernel": gk[n], "plain_bf16": gp[n]} for n in noise})
    for what, e in summary.items():
        if e["kernel"] > 2 * e["plain_bf16"]:
            raise AssertionError(f"the kernel path's {what} strays from fp32 by {e['kernel']}, "
                                 f"more than 2 x plain bf16 ({e['plain_bf16']})")
    if median > 1.1:
        raise AssertionError(f"the median gradient error ratio to the plain bf16 path is {median} > 1.1")
    if worse:
        raise AssertionError(f"gradients of {worse} stray from fp32 more than 2 x the plain bf16 path's")
    return {"batch": batches[0]}


def train_step_profile(trainer, batch, name: str = "train_step") -> None:
    """Wall time of one optimizer step (median of 3 after a warm-up) and
    one traced step: device busy and idle share, the largest kernels."""
    import torch

    samples = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        if i:
            samples.append(time.perf_counter() - t0)
    wall = statistics.median(samples)
    emit(f"{name}_time", wall_ms=wall * 1e3, batch=len(batch.query_tensors),
         seq=[batch.query_tensors.shape[1], batch.response_tensors.shape[1]], samples_ms=[x * 1e3 for x in samples])
    profile_phase(name, lambda: trainer.train_step(batch), wall, grad=True)


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

    seq2seq = dict(T5_BASE, attention_impl=attention_impl, decoder_start_token_id=ByteTokenizer().bos_token_id)
    model = dict(model_path="random", model_arch_type="seq2seq", num_layers_unfrozen=-1,
                 model_extra_configs={"seq2seq": seq2seq})
    model.update(model_kw)
    return default_ppo_config().evolve(
        train=dict(seq_length=T5_PROMPT_LEN + T5_NEW_TOKENS, epochs=10_000, total_steps=T5_TRAIN_STEPS,
                   batch_size=T5_BATCH, checkpoint_interval=10_000, eval_interval=10_000, tracker=None,
                   save_best=False, compute_dtype=compute_dtype, seed=seed),
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
    default PPO config's hydra fork (num_layers_unfrozen 2: branch_at 10)."""
    import torch

    from trlx_tpu_torch.models.wrappers import Seq2SeqLMWithValueHead

    policy = Seq2SeqLMWithValueHead.from_config(t5_config(seed, attention_impl, compute_dtype, num_layers_unfrozen=2))
    policy.init_params(torch.Generator().manual_seed(seed))
    return policy


def bias_counters():
    """The launch counters of the attention kernels the T5 paths may run:
    the bias forward, the bias backward's fused kernel and its long route's
    pair, the plain flash forward, and the plain flash backward's fused
    kernel and its long route's pair."""
    from trlx_tpu_torch.ops import flash_attention as fa

    return {"flash_bias_fwd": fa.flash_attention_bias, "flash_bias_bwd": fa.flash_attention_bias_bwd,
            "flash_bias_bwd_dq": fa.flash_attention_bias_dq,
            "flash_bias_bwd_dkv": fa.flash_attention_bias_dkv, "flash_fwd": fa.flash_attention,
            "flash_bwd": fa.flash_attention_bwd, "flash_bwd_dq": fa.flash_attention_dq,
            "flash_bwd_dkv": fa.flash_attention_dkv}


def t5_path(seed: int) -> dict:
    """T5-base (random weights from the seed) through `generate_seq2seq`
    (64 byte prompts right-padded to 32, 64 new tokens, greedy) and one
    `forward_train` experience pass over its output, on the kernels
    (attention_impl "pallas"); the same weights on the plain bf16 ("xla")
    and fp32 math are its reference. Gates: the launch counts, shapes and
    finite values, and the kernel path's experience logits, values and
    reference logits within 2x the plain bf16 path's error against fp32."""
    import torch

    from trlx_tpu_torch.models.generation import SamplerSettings
    from trlx_tpu_torch.models.seq2seq import generate_seq2seq
    from trlx_tpu_torch.utils.tokenizers import ByteTokenizer

    policy = build_t5_policy(seed, "pallas")
    if policy.branch_at != 10 or policy.cfg.dtype != torch.bfloat16:
        raise AssertionError("the default PPO config must give branch_at=10 and bf16 compute")
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

    with torch.no_grad():
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
    expect = {"flash_bias_fwd": cfg.n_layer + (cfg.n_layer + cfg.n_decoder_layer + top),
              "flash_fwd": cfg.n_decoder_layer + top, "flash_bias_bwd": 0,
              "flash_bias_bwd_dq": 0, "flash_bias_bwd_dkv": 0, "flash_bwd": 0, "flash_bwd_dq": 0,
              "flash_bwd_dkv": 0}
    emit("t5_path", launches=launches, expected=expect, generate_launches=gen_launches,
         response_tokens=int(out["response_mask"].sum()), shape=list(dec.shape))
    if launches != expect or gen_launches["flash_bias_fwd"] != cfg.n_layer:
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
    emit("t5_reference", experience_max_abs_err=err, greedy_free_running_agreement_vs_plain_bf16=free)
    for key, e in err.items():
        if e["kernel_vs_fp32"] > 2 * e["plain_bf16_vs_fp32"]:
            raise AssertionError(f"T5 {key}: the kernel path strays from fp32 more than 2 x plain bf16 does")
    del plain, exact, exp_x, exp_f, out_x

    walls = {}
    with torch.no_grad():
        for name, fn in (("t5_rollout", lambda: rollout(policy)),
                         ("t5_experience", lambda: experience(policy, ref, dec, dec_mask))):
            fn()
            samples = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                samples.append(time.perf_counter() - t0)
            walls[name] = statistics.median(samples)
            emit(f"{name}_time", wall_s=walls[name], samples_s=samples, batch=B, prompt_len=T5_PROMPT_LEN,
                 decoder_len=T, new_tokens=int(out["response_mask"].sum()))
            profile_phase(name, fn, walls[name])
    return launches


def t5_train_path(seed: int):
    """`trlx_tpu_torch.train` with model_arch_type "seq2seq" at T5-base
    width (random weights from the seed, everything trainable, a full frozen
    reference copy, bf16 compute / fp32 params, the six attention kernels):
    evaluate, two rollout cycles of 48, 32 optimizer steps, evaluate.
    Gates: finite losses, the launch counts the path implies (both
    backwards' fused kernels, and none of their long routes), every
    trainable tensor moved (both relative-bias tables and the encoder
    included), the frozen reference did not."""
    import torch

    import trlx_tpu_torch

    counters = bias_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
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
    # backwards on the fused route (T5's lengths are at most 128)
    expect = {"flash_bias_fwd": cfg.n_layer * n_gen + 2 * tf * chunks + tf * T5_TRAIN_STEPS,
              "flash_fwd": 2 * cfg.n_decoder_layer * chunks + cfg.n_decoder_layer * T5_TRAIN_STEPS,
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


def bwd_kernel_times(gen, launches, t5_launches, errs) -> list:
    """The flash backward at the GPT-2 train path's shape (B32 H12 T=S=64,
    causal) and at T5's cross-attention shape (B12 H12, T=65 queries over
    S=32 keys, not causal, scale 1): the fused kernel, the long route's
    pair, the plain backward and SDPA's backward on the same inputs, beside
    the bounds; then the long route's two steps at T=S=512 (B4, causal),
    where it is the route the wrapper takes. `launches` and `t5_launches`
    are the GPT-2 and T5 train paths' counts."""
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
            launches_t5_train_path=t5_launches[name.split("/")[0]], max_abs_err=err, shape=shape,
            causal=causal, ms=ms, kernel_ms=ms, plain_ms=plain, plain_is=plain_is, bound_ms=bms, bound_by=by,
            bound_bytes=work[0], bound_flops=work[1], library_ms=lib, library_is=lib_is, **extra,
        ))

    D = 64
    for case, (B, H, T, S, causal) in {
        "train": (TRAIN_BATCH, 12, TRAIN_LEN, TRAIN_LEN, True),
        "t5_cross": (12, 12, T5_DEC_LEN, T5_PROMPT_LEN, False),
        "long": (4, 12, 512, 512, True),
    }.items():
        q, k, v, mask, out, m, l, g = flash_bwd_inputs(gen, B, H, H, T, S, 0, False, causal)
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
            row(f"flash_bwd/{case}", shape, causal, fused_ms, plain, lib, work_fused, 192, errs["fused"],
                launches=(launches if case == "train" else t5_launches)["flash_bwd"], also_replaces=ref(231),
                long_route_ms=dq_ms + dkv_ms, long_route_dq_ms=dq_ms, long_route_dkv_ms=dkv_ms,
                occupancy=flash_attention_bwd_occupancy(T, S))
        if case != "t5_cross":
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


def bias_kernel_times(gen, launches, path_launches, errs) -> list:
    """The bias kernels at the T5 train path's shapes (B12 H12: the
    encoder's T = S = 32, not causal, and the decoder's T = S = 65, causal):
    the forward and the fused backward, kernel, plain and library times
    beside the bound, with the long route's pair timed on the same inputs
    beside the fused kernel; then the long route's two steps at T = S = 512
    (B4), where it is the route the wrapper takes. The library call is
    F.scaled_dot_product_attention with the additive float mask (the bias
    plus the key and causal masks, in bf16 as SDPA takes it), scale 1; its
    backward yields dq, dk, dv and the mask's gradient."""
    import torch
    import torch.nn.functional as F

    from trlx_tpu_torch.ops.flash_attention import (
        _check_bias,
        backward_operands,
        flash_attention_bias,
        flash_attention_bias_backward_plain,
        flash_attention_bias_bwd,
        flash_attention_bias_bwd_occupancy,
        flash_attention_bias_dkv,
        flash_attention_bias_dq,
        flash_attention_bias_plain,
    )

    # _flash_bias_kernel via _flash_bias_forward:517; _dq_dbias_kernel and
    # _dkv_bias_kernel via _flash_bias_backward:665 and :703
    ref = "trlx_tpu/ops/flash_attention.py:{}".format
    rows = []

    def row(name, case, shape, causal, ms, plain, lib, work, src, line, err, plain_is, library_is, **extra):
        bms, by = bound_ms(*work)
        rows.append(dict(
            name=f"{name}/{case}", route="cuda", source=f"trlx_tpu_torch/csrc/{src}", replaces=ref(line),
            launches=launches[name], launches_t5_path=path_launches[name], max_abs_err=err,
            shape=shape, causal=causal, ms=ms, kernel_ms=ms, plain_ms=plain, plain_is=plain_is,
            bound_ms=bms, bound_by=by, bound_bytes=work[0], bound_flops=work[1], library_ms=lib,
            library_is=library_is, **extra,
        ))

    lib_bwd_is = "F.scaled_dot_product_attention backward (dq, dk, dv, dmask together)"
    for case in ("encoder", "decoder", "long"):
        B, H, T, causal, kind = BIAS_CASES[case]
        q, k, v, mask, bias, out, m, l, g = flash_bias_inputs(gen, B, H, T, causal, kind)
        km, g2 = backward_operands(q, k, v, mask, g, m, l)
        bias32 = _check_bias(q, k, bias, causal)
        if case != "long":
            with torch.no_grad():
                fwd_ms = time_ms(lambda: flash_attention_bias(q, k, v, mask, bias, causal=causal, with_stats=True))
                fwd_plain = time_ms(lambda: flash_attention_bias_plain(q, k, v, mask, bias, causal, 1.0,
                                                                       with_stats=True))
            fused_ms = time_ms(lambda: flash_attention_bias_bwd(q, k, v, km, bias32, g2, m, l, causal, 1.0))
        # the dq kernel writes the delta that the dk/dv kernel reads
        delta = flash_attention_bias_dq(q, k, v, km, bias32, g2, m, l, causal, 1.0)[2]
        dq_ms = time_ms(lambda: flash_attention_bias_dq(q, k, v, km, bias32, g2, m, l, causal, 1.0))
        dkv_ms = time_ms(lambda: flash_attention_bias_dkv(q, k, v, km, bias32, g2, m, l, delta, causal, 1.0))
        bwd_plain = time_ms(lambda: flash_attention_bias_backward_plain(
            q, k, v, mask, bias, out, m, l, g, causal, 1.0))
        allowed = (mask[:, None, None, :] > 0).expand(B, H, T, T)
        if causal:
            allowed = allowed & (torch.arange(T, device="cuda")[:, None] >= torch.arange(T, device="cuda"))
        additive = (bias[None] + torch.where(allowed, 0.0, -1e30)).to(torch.bfloat16)
        with torch.no_grad():
            lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=additive, scale=1.0))
        lq, lk, lv, lm = (x.detach().clone().requires_grad_(True) for x in (q, k, v, additive))
        lib_out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lm, scale=1.0)
        lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, (lq, lk, lv, lm), g, retain_graph=True))
        works = flash_bias_work(mask, H, T, T, 64, causal)
        shape = [B, H, T, T, 64]
        if case != "long":
            row("flash_bias_fwd", case, shape, causal, fwd_ms, fwd_plain, lib_fwd, works[0], "flash_bias_fwd.cu",
                452, errs["fwd"], "the plain forward", "F.scaled_dot_product_attention, additive bf16 mask, forward")
            row("flash_bias_bwd", case, shape, causal, fused_ms, bwd_plain, lib_bwd, works[3], "flash_bias_bwd.cu",
                550, errs["fused"], "the whole plain backward", lib_bwd_is,
                also_replaces=ref(594), long_route_ms=dq_ms + dkv_ms, long_route_dq_ms=dq_ms,
                long_route_dkv_ms=dkv_ms, occupancy=flash_attention_bias_bwd_occupancy(T, T))
        else:
            row("flash_bias_bwd_dq", case, shape, causal, dq_ms, bwd_plain, lib_bwd, works[1], "flash_bias_bwd.cu",
                550, errs["dq_dbias"], "the whole plain backward", lib_bwd_is)
            row("flash_bias_bwd_dkv", case, shape, causal, dkv_ms, bwd_plain, lib_bwd, works[2],
                "flash_bias_bwd.cu", 594, errs["dkv"], "the whole plain backward", lib_bwd_is)
        del lq, lk, lv, lm, lib_out, additive
    for r in rows:
        emit("kernel_time", **r)
    return rows


def profile_phase(name: str, fn, wall_s: float, grad: bool = False, host_ops: bool = True) -> None:
    """Device time by kernel over one traced run of `fn` (torch.profiler).
    The idle share compares the traced device time with the untraced wall
    time `wall_s` of the same work. `host_ops=False` traces the device
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

    emit("profile", what=name, wall_ms=wall_s * 1e3, device_busy_ms=busy_ms,
         device_idle_share=(1 - busy_ms / (wall_s * 1e3)) if busy_ms else None,
         attention_kernels_ms=share("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                                    "flash_bwd_fused_kernel", "decode_int8_kernel", "paged_attention_kernel",
                                    "flash_bias_"),
         flash_bias_kernels_ms=share("flash_bias_"),
         paged_kernel_ms=share("paged_attention_kernel"),
         flash_bwd_kernels_ms=share("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel", "flash_bwd_fused_kernel"),
         matmul_ms=share("gemm", "Gemm", "xmma", "nvjet", "cutlass"),
         top=[dict(kernel=e.key[:90], ms=e.self_device_time_total / 1e3, calls=e.count) for e in top])


def kernel_times(gen, launches, errs, train_launches) -> list:
    """Kernel, plain and library times at the rollout path's shapes; each
    row's launches on the rollout path, and on the train path beside."""
    import torch
    import torch.nn.functional as F

    from trlx_tpu_torch.ops.decode_attention import (
        decode_attention_int8,
        decode_attention_int8_plain,
    )
    from trlx_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    rows = []
    with torch.no_grad():
        for name, (B, H, T, S, off, unwritten) in {
            "flash_fwd/prefill": (64, 12, PROMPT_LEN, 128, 0, True),
            "flash_fwd/teacher_forced": (64, 12, PROMPT_LEN + NEW_TOKENS, PROMPT_LEN + NEW_TOKENS, 0, False),
        }.items():
            D = 64
            q, k, v, mask = flash_inputs(gen, B, H, H, T, S, D, off, unwritten)
            q_offset = off if unwritten else None
            qo = S - T if q_offset is None else q_offset
            slots = torch.arange(S, device="cuda")
            allowed = ((torch.arange(T, device="cuda")[:, None] + qo) >= slots[None, :])[None, None]
            allowed = allowed & (mask[:, None, None, :] > 0)
            ms = time_ms(lambda: flash_attention(q, k, v, mask, q_offset=q_offset, with_stats=True))
            plain = time_ms(lambda: flash_attention_plain(q, k, v, mask, q_offset=q_offset, with_stats=True))
            lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=allowed))
            n_bytes, n_flops = flash_work(mask, H, H, T, S, D, qo)
            bms, by = bound_ms(n_bytes, n_flops)
            key = name.split("/")[1]
            rows.append(dict(
                name=name, route="cuda", source="trlx_tpu_torch/csrc/flash_fwd.cu",
                replaces="trlx_tpu/ops/flash_attention.py:84",  # _flash_kernel, via _flash_forward:134
                launches=launches["flash_" + key], launches_train_path=train_launches["flash_fwd"],
                max_abs_err=errs["flash"],
                shape=[B, H, T, S, D], ms=ms, kernel_ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, bound_bytes=n_bytes, bound_flops=n_flops, library_ms=lib,
            ))
        L, B, H, S, D = 12, 64, 12, 128, 64
        q, ck, cv, ks, vs, mask = decode_inputs(gen, L, B, H, H, S, D, PROMPT_LEN + NEW_TOKENS)
        ms = time_ms(lambda: decode_attention_int8(q, ck, cv, ks, vs[5], mask, 5, D ** -0.5))
        plain = time_ms(lambda: decode_attention_int8_plain(q, ck, cv, ks, vs[5], mask, 5, D ** -0.5))
        n_bytes, n_flops = decode_work(mask, H, H, S, D)
        bms, by = bound_ms(n_bytes, n_flops)
        rows.append(dict(
            name="decode_int8", route="cuda", source="trlx_tpu_torch/csrc/decode_int8.cu",
            replaces="trlx_tpu/ops/decode_attention.py:369",  # _decode_kernel, via decode_attention_int8:418
            launches=launches["decode"], launches_train_path=train_launches["decode"],
            max_abs_err=errs["decode"], shape=[L, B, H, S, D],
            ms=ms, kernel_ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
            bound_bytes=n_bytes, bound_flops=n_flops, library_ms=None,
        ))
    for row in rows:
        emit("kernel_time", **row)
    return rows


def paged_kernel_times(gen, launches, err) -> list:
    """The paged kernel at the engine's shapes in the training workload (32
    lanes, 12 heads, 16-token int8 pages, 5 pages a lane): a decode step
    (T 1) and a speculative verify (T 4), on ragged lane depths and each
    lane's own table, beside its bound and its plain version. No single
    PyTorch call computes attention over int8 pages with per-row scales,
    so there is no library time."""
    import torch

    from trlx_tpu_torch.ops.decode_attention import paged_attention, paged_attention_plain

    rows = []
    B, H, PS, MP = 32, 12, 16, 5
    depths = torch.randint(33, MP * PS - 4, (B,), generator=gen, device="cuda").tolist()
    with torch.no_grad():
        for name, T in (("paged_attention/decode", 1), ("paged_attention/verify", 4)):
            q, _, _, pools, table, _, bias, visible = paged_inputs(gen, B, T, H, H, PS, MP, "int8", depths)
            ms = time_ms(lambda: paged_attention(q, pools, 5, table, bias, 64 ** -0.5))
            plain = time_ms(lambda: paged_attention_plain(q, pools, 5, table, bias, 64 ** -0.5))
            n_bytes, n_flops = paged_work(visible, table, H, H, T, PS, True)
            bms, by = bound_ms(n_bytes, n_flops)
            rows.append(dict(
                name=name, route="cuda", source="trlx_tpu_torch/csrc/paged_attention.cu",
                replaces="trlx_tpu/ops/decode_attention.py:198",  # _paged_kernel, via paged_attention_pallas:268
                launches=launches["engine_plain"] + launches["engine_spec"],
                launches_engine_path=launches["engine_plain"], launches_engine_spec_path=launches["engine_spec"],
                launches_train_engine_path=launches["train_engine"], max_abs_err=err,
                shape=[B, T, H, PS, MP, 64], ms=ms, kernel_ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                bound_bytes=n_bytes, bound_flops=n_flops, library_ms=None,
            ))
    for row in rows:
        emit("kernel_time", **row)
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from trlx_tpu_torch.ops import _build
    from trlx_tpu_torch.ops.flash_attention import flash_attention_bwd_occupancy

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
    emit("build", seconds=time.perf_counter() - t0,
         ptxas=[ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln],
         flash_bias_bwd_fused=fused, flash_bwd_fused=fused_plain,
         flash_bwd_fused_occupancy={"train": flash_attention_bwd_occupancy(TRAIN_LEN, TRAIN_LEN),
                                    "t5_cross": flash_attention_bwd_occupancy(T5_DEC_LEN, T5_PROMPT_LEN)})
    for what, report in (("bias backward", fused), ("flash backward", fused_plain)):
        if len(report) != 8 or any(f.get("spill_stores", 1) or f.get("spill_loads", 1) for f in report):
            raise AssertionError(f"the fused {what}'s 8 instantiations must build without spills: {report}")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    errs = {"flash": check_flash(gen)["max_abs_err"], "decode": check_decode(gen)["max_abs_err"]}
    bwd_errs = check_flash_bwd(gen)
    bias_errs = check_flash_bias(gen)
    paged_err = check_paged(gen)["max_abs_err"]
    check_rng(args.seed)
    launches = main_path(args.seed)
    trainer, train_launches = train_path(args.seed)
    batch = train_reference(trainer, args.seed)["batch"]
    train_step_profile(trainer, batch)
    del trainer, batch
    torch.cuda.empty_cache()
    engine = engine_path(args.seed)
    paged_launches = {"engine_plain": engine["plain"], "engine_spec": engine["spec"],
                      "train_engine": train_engine_path(args.seed)["paged"]}
    torch.cuda.empty_cache()
    t5_launches = t5_path(args.seed)
    torch.cuda.empty_cache()
    trainer, t5_train_launches = t5_train_path(args.seed)
    batch = t5_train_reference(trainer, args.seed)["batch"]
    train_step_profile(trainer, batch, "t5_train_step")
    del trainer, batch
    torch.cuda.empty_cache()
    rows = kernel_times(gen, launches, errs, train_launches)
    rows += bwd_kernel_times(gen, train_launches, t5_train_launches, bwd_errs)
    rows += paged_kernel_times(gen, paged_launches, paged_err)
    rows += bias_kernel_times(gen, t5_train_launches, t5_launches, bias_errs)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
