#!/usr/bin/env python3
"""Drive trlx_tpu_torch's PPO rollout and training paths on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the CUDA kernels from `trlx_tpu_torch/csrc` (into build/kernels/)
and holds each kernel against its plain PyTorch version on the card: the
flash forward, the flash backward's dq and dk/dv kernels, the int8
decode step. Then, at GPT-2-small width (12 x 768, vocab 50257, random
weights from the seed), through the entry points a user calls:

- the rollout path: `CausalLMWithValueHead.from_config` on the default
  PPO config, `generate` (greedy and sampled, int8 KV cache, 64
  byte-tokenised prompts left-padded to 32, 40 new tokens) and
  `forward_train` with `logprobs_of_labels`; the same greedy rollout
  through the plain attention math is its whole-path reference;
- the training path: `trlx_tpu_torch.train` on bench.py's headline
  workload (64 rollouts of 32 + 32 tokens, batch 32, 4 PPO epochs, two
  cycles = 16 optimizer steps); one train step through the plain bf16
  and fp32 attention math is its reference.

Launch counters, zeroed before each path and read after it, show each
path ran through its kernels. Then the kernels are timed at the paths'
shapes beside their bounds, and one rollout, one experience pass and one
train step are profiled.

Each phase prints one JSON line. The last two lines are the card's name
and power limit as nvidia-smi reports them, then
{"ok": true, "device": {...}}. Any failure raises and exits non-zero
without that line; with no CUDA device the script exits 2 at once.
"""

from __future__ import annotations

import argparse
import json
import math
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


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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

    cases = {
        "prefill": (64, 12, 12, PROMPT_LEN, 128, 64, 0, True),
        "teacher_forced": (64, 12, 12, PROMPT_LEN + NEW_TOKENS, PROMPT_LEN + NEW_TOKENS, 64, 0, False),
        "long": (8, 12, 12, 1024, 1024, 64, 0, False),
        "gqa": (8, 12, 4, 200, 200, 64, 0, False),
        "prefill_offset": (4, 4, 4, 37, 128, 64, 5, True),  # ragged, at an offset
    }
    worst = 0.0
    for name, (B, H, Hkv, T, S, D, off, unwritten) in cases.items():
        q, k, v, mask = flash_inputs(gen, B, H, Hkv, T, S, D, off, unwritten)
        kw = dict(q_offset=off if unwritten else None, with_stats=True)
        out, m, l = flash_attention(q, k, v, mask, **kw)
        torch.cuda.synchronize()
        ref, m_ref, l_ref = flash_attention_plain(q.float(), k.float(), v.float(), mask, **kw)
        err = (out.float() - ref).abs().max().item()
        m_rel = ((m - m_ref).abs() / m_ref.abs().clamp(min=1.0)).max().item()
        l_rel = ((l - l_ref).abs() / l_ref.abs().clamp(min=1.0)).max().item()
        emit("flash_check", case=name, shape=[B, H, Hkv, T, S, D], max_abs_err=err,
             m_rel_err=m_rel, l_rel_err=l_rel)
        if not (err <= 2e-2 and m_rel <= 1e-3 and l_rel <= 1e-3):
            raise AssertionError(f"flash kernel disagrees with its plain version on {name}")
        worst = max(worst, err)
    return {"max_abs_err": worst}


BWD_CASES = {  # name: (B, H, Hkv, T, S, q_offset, unwritten)
    "train": (32, 12, 12, TRAIN_LEN, TRAIN_LEN, 0, False),
    "experience": (64, 12, 12, PROMPT_LEN + NEW_TOKENS, PROMPT_LEN + NEW_TOKENS, 0, False),
    "prefill_offset": (4, 4, 4, 37, 128, 5, True),
    "gqa": (8, 12, 4, 200, 200, 0, False),
    "long": (8, 12, 12, 1024, 1024, 0, False),
    "ragged": (4, 12, 12, 50, 100, 50, False),  # T < S, S not a multiple of 64
}


def flash_bwd_inputs(gen, B, H, Hkv, T, S, q_offset, unwritten):
    """Kernel inputs of the backward: q/k/v/mask as `flash_inputs` makes
    them (batch row 0 fully padded), the forward kernel's (out, m, l) and a
    bf16 output gradient."""
    import torch

    from trlx_tpu_torch.ops.flash_attention import flash_attention

    q, k, v, mask = flash_inputs(gen, B, H, Hkv, T, S, 64, q_offset, unwritten)
    out, m, l = flash_attention(q, k, v, mask, q_offset=q_offset, with_stats=True)
    g = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
    return q, k, v, mask, out, m, l, g


def check_flash_bwd(gen) -> dict:
    """The dq and dk/dv kernels against flash_attention_backward_plain on
    the same bf16 inputs upcast to fp32: max |error| / max(|ref|, 1) under
    2e-2 for dq, dk and dv, and for dv of the fully padded batch row alone
    (every query of it is fully masked, so its dv is the uniform 1/l
    weights' sum of dO at every slot)."""
    import torch

    from trlx_tpu_torch.ops.flash_attention import flash_attention_backward, flash_attention_backward_plain

    worst = {"rel": 0.0, "dq": 0.0, "dkv": 0.0}
    for name, (B, H, Hkv, T, S, off, unwritten) in BWD_CASES.items():
        q, k, v, mask, out, m, l, g = flash_bwd_inputs(gen, B, H, Hkv, T, S, off, unwritten)
        got = flash_attention_backward(q, k, v, mask, out, m, l, g, True, 64 ** -0.5, off)
        torch.cuda.synchronize()
        ref = flash_attention_backward_plain(
            q.float(), k.float(), v.float(), mask, out.float(), m, l, g.float(), True, 64 ** -0.5, off
        )

        def rel(a, b):
            return ((a.float() - b).abs().max() / b.abs().max().clamp(min=1.0)).item()

        errs = {key: rel(a, b) for key, a, b in zip(("dq", "dk", "dv"), got, ref)}
        errs["dv_fully_masked_row"] = rel(got[2][0], ref[2][0])
        abs_err = {key: (a.float() - b).abs().max().item() for key, a, b in zip(("dq", "dk", "dv"), got, ref)}
        emit("flash_bwd_check", case=name, shape=[B, H, Hkv, T, S, 64], q_offset=off,
             rel_err=errs, max_abs_err=abs_err, dv_masked_row_ref_max=ref[2][0].abs().max().item())
        if not all(e < 2e-2 for e in errs.values()):
            raise AssertionError(f"flash backward kernels disagree with the plain version on {name}: {errs}")
        worst["rel"] = max(worst["rel"], *errs.values())
        worst["dq"] = max(worst["dq"], abs_err["dq"])
        worst["dkv"] = max(worst["dkv"], abs_err["dk"], abs_err["dv"])
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
    from trlx_tpu_torch.models.wrappers import CausalLMWithValueHead
    from trlx_tpu_torch.ops import flash_attention as fa
    from trlx_tpu_torch.ops.decode_attention import decode_attention_int8

    counters = {"flash_fwd": fa.flash_attention, "flash_bwd_dq": fa.flash_attention_dq,
                "flash_bwd_dkv": fa.flash_attention_dkv, "decode": decode_attention_int8}
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
    # backward through every layer
    expect = {"flash_fwd": L * ((cycles + 2) + 2 * cycles + TRAIN_STEPS),
              "flash_bwd_dq": L * TRAIN_STEPS, "flash_bwd_dkv": L * TRAIN_STEPS}
    steps = [(step, st["losses/total_loss"], st["policy/approx_kl"])
             for step, st in trainer.stats_history if "losses/total_loss" in st]
    rewards = [st["reward/mean"] for _, st in trainer.stats_history if "reward/mean" in st]
    rollout_scores = [st["rollout_scores/mean"] for _, st in trainer.stats_history if "rollout_scores/mean" in st]
    marks = trainer.phase_marks + [dict(trainer.phase_seconds)]
    split = [{k: marks[i + 1].get(k, 0.0) - marks[i].get(k, 0.0)
              for k in ("generate", "experience", "train", "eval")} for i in range(len(marks) - 1)]
    emit("train_path", wall_s=wall, launches=launches, expected=expect, iter_count=trainer.iter_count,
         losses=[x[1] for x in steps], approx_kl=[x[2] for x in steps], eval_reward_mean=rewards,
         rollout_score_mean=rollout_scores, kl_ctl_value=trainer.kl_ctl.value,
         cycle_seconds=[{"rollout": c["generate"], "experience": c["experience"], "train": c["train"],
                         "eval": c["eval"]} for c in split])
    if len(steps) != TRAIN_STEPS or not all(math.isfinite(x[1]) for x in steps):
        raise AssertionError(f"expected {TRAIN_STEPS} finite losses, got {[x[1] for x in steps]}")
    if {k: launches[k] for k in expect} != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    if not (0 < launches["decode"] <= L * (cycles + 2) * (TRAIN_NEW_TOKENS - 1) and launches["decode"] % L == 0):
        raise AssertionError(f"decode launches {launches['decode']} are not whole decode steps of {L} layers")

    init = CausalLMWithValueHead(trainer.model.cfg, device="cuda").init_params(torch.Generator().manual_seed(seed))
    start = dict(init.named_parameters())
    still = [n for n, p in trainer.model.named_parameters() if torch.equal(p, start[n])]
    ref_moved = [n for n, p in trainer.ref_params.named_parameters() if not torch.equal(p, start["base." + n])]
    emit("train_params", trainable=len(trainer.trainable_params), unmoved=still, reference_moved=ref_moved)
    if still or ref_moved or len(trainer.trainable_params) != len(start):
        raise AssertionError(f"parameters that did not move: {still}; reference tensors that moved: {ref_moved}")
    del init, start
    return trainer, launches


def train_reference(trainer, seed: int) -> dict:
    """One train step's loss and gradients from the same parameters on
    the same minibatches, three ways: the kernel path (the trainer
    itself), the plain bf16 path (attention_impl="xla") and the plain
    fp32 path. The minibatches: a fresh store of TRAIN_REFERENCE_ROLLOUTS
    rollouts from the trained policy, cut by two shuffles (16
    minibatches). Gate: the kernel path strays from fp32 at most twice as
    far as the plain bf16 path in the loss, the response tokens' logprobs
    and values (mean |error| over the minibatches), and in ||d grad|| /
    ||grad|| of every trainable tensor (both norms over all the
    minibatches' gradients together). One minibatch's loss error, or the
    gradient error of a tensor that sums a whole batch into one number
    (the value head's output bias), is a single draw of bf16 rounding
    noise that swings by 10x between minibatches on either bf16 path, so
    the gate needs many independent rows to compare two such draws."""
    import torch

    from trlx_tpu_torch.utils.loading import get_trainer

    trainer.store.clear_history()
    trainer.make_experience(TRAIN_REFERENCE_ROLLOUTS, trainer.iter_count)
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    paths = {"kernel": trainer}
    for name, kw in (("plain_bf16", dict(attention_impl="xla", kv_cache_quant="int8")),
                     ("fp32", dict(attention_impl="xla", kv_cache_quant=None, compute_dtype="float32"))):
        config = train_config(seed, **kw)
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
               for b in trainer.store.create_loader(TRAIN_BATCH, shuffle=True, drop_last=True, seed=s)]
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
    summary = {what: {"kernel": mean("kernel", i), "plain_bf16": mean("plain_bf16", i)}
               for i, what in enumerate(("loss", "logprobs", "values"))}
    emit("train_reference", minibatches=len(batches), losses=losses,
         loss_err_by_minibatch={name: [e[0] for e in errs[name]] for name in errs},
         mean_abs_err=summary, grad_rel_err_kernel_max=max(gk[n] for n in gated),
         grad_rel_err_plain_bf16_max=max(gp[n] for n in gated), grad_rel_err_ratio_max=max(ratio.values()),
         grad_rel_err_ratio_median=statistics.median(ratio.values()),
         grad_rel_err_ratio_top=[(n, r, gk[n], gp[n]) for n, r in sorted(ratio.items(), key=lambda kv: -kv[1])[:5]],
         tensors=len(gated), tensors_over_2x=worse,
         not_gated={n: {"kernel": gk[n], "plain_bf16": gp[n]} for n in noise})
    for what, e in summary.items():
        if e["kernel"] > 2 * e["plain_bf16"]:
            raise AssertionError(f"the kernel path's {what} strays from fp32 by {e['kernel']}, "
                                 f"more than 2 x plain bf16 ({e['plain_bf16']})")
    if worse:
        raise AssertionError(f"gradients of {worse} stray from fp32 more than 2 x the plain bf16 path's")
    return {"batch": batches[0]}


def train_step_profile(trainer, batch) -> None:
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
    emit("train_step_time", wall_ms=wall * 1e3, batch=TRAIN_BATCH, seq=TRAIN_LEN, samples_ms=[x * 1e3 for x in samples])
    profile_phase("train_step", lambda: trainer.train_step(batch), wall, grad=True)


def flash_bwd_work(mask, H, Hkv, T, S, D, q_offset):
    """Bytes and operations each backward kernel's function needs on this
    mask, in the way of `flash_work`. A weighed (t, s) pair costs the dq
    kernel three products (S, dP, dQ) and the dk/dv kernel four (S, dP,
    dV, dK), 2*D operations each per head; a fully masked row adds its
    uniform P.dO to dv over all S slots. Reads: q and dO of rows with a
    weighed pair (dO of every row for dv), K and V of weighed slots, the
    fp32 m, l, delta and the int32 mask; writes: dq, or dk and dv, in full."""
    import torch

    slots = torch.arange(S, device="cuda")
    rows = torch.arange(T, device="cuda")[:, None] + q_offset
    pairs = (rows >= slots[None, :])[None] & (mask[:, None, :] > 0)  # [B, T, S]
    n_pairs = int(pairs.sum().item())
    n_weighed = int(pairs.any(dim=1).sum().item())
    rows_with = int(pairs.any(dim=2).sum().item())
    B = mask.shape[0]
    full_rows = B * T - rows_with
    stats = 3 * 4 * B * H * T + 4 * B * S
    dq = (2 * D * H * 2 * rows_with + 2 * D * Hkv * 2 * n_weighed + 2 * B * H * T * D + stats,
          H * 3 * 2 * D * n_pairs)
    dkv = (2 * D * H * (rows_with + B * T) + 2 * D * Hkv * 2 * n_weighed + 2 * 2 * B * Hkv * S * D + stats,
           H * (4 * 2 * D * n_pairs + 2 * D * S * full_rows))
    return dq, dkv


def bwd_kernel_times(gen, launches, errs) -> list:
    """The dq and dk/dv kernels at the training shape (B32 H12 T=S=64):
    kernel, plain and library times beside the bound."""
    import torch
    import torch.nn.functional as F

    from trlx_tpu_torch.ops.flash_attention import (
        backward_operands,
        flash_attention_backward_plain,
        flash_attention_dkv,
        flash_attention_dq,
    )

    B, H, T, D = TRAIN_BATCH, 12, TRAIN_LEN, 64
    scale = D ** -0.5
    q, k, v, mask, out, m, l, g = flash_bwd_inputs(gen, B, H, H, T, T, 0, False)
    km, g2, delta = backward_operands(q, k, v, mask, g, m, l)
    # the dq kernel writes the delta that the dk/dv kernel reads
    dq_ms = time_ms(lambda: flash_attention_dq(q, k, v, km, g2, m, l, delta, True, scale, 0))
    dkv_ms = time_ms(lambda: flash_attention_dkv(q, k, v, km, g2, m, l, delta, True, scale, 0))
    plain = time_ms(lambda: flash_attention_backward_plain(q, k, v, mask, out, m, l, g, True, scale, 0))
    # the library yardstick: SDPA's backward alone (dq, dk, dv together) on
    # the same inputs; its mask keeps one slot open in a fully masked row,
    # where SDPA would give NaN
    slots = torch.arange(T, device="cuda")
    allowed = (slots[:, None] >= slots[None, :])[None, None] & (mask[:, None, None, :] > 0)
    allowed[..., 0] |= ~allowed.any(dim=-1)
    lq, lk, lv = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=allowed)
    lib = time_ms(lambda: torch.autograd.grad(lib_out, (lq, lk, lv), g, retain_graph=True))
    (dq_bytes, dq_flops), (dkv_bytes, dkv_flops) = flash_bwd_work(mask, H, H, T, T, D, 0)
    rows = []
    for name, ms, n_bytes, n_flops, line in (
        ("flash_bwd_dq", dq_ms, dq_bytes, dq_flops, 192),  # _dq_kernel, via _flash_backward:314
        ("flash_bwd_dkv", dkv_ms, dkv_bytes, dkv_flops, 231),  # _dkv_kernel, via _flash_backward:347
    ):
        bms, by = bound_ms(n_bytes, n_flops)
        rows.append(dict(
            name=name, route="cuda", source="trlx_tpu_torch/csrc/flash_bwd.cu",
            replaces=f"trlx_tpu/ops/flash_attention.py:{line}",
            launches=launches[name], max_abs_err=errs[name.split("_")[-1]], shape=[B, H, T, T, D],
            ms=ms, kernel_ms=ms, plain_ms=plain, plain_is="the whole plain backward (dq, dk, dv)",
            bound_ms=bms, bound_by=by, bound_bytes=n_bytes, bound_flops=n_flops, library_ms=lib,
            library_is="F.scaled_dot_product_attention backward (dq, dk, dv together)",
        ))
    for row in rows:
        emit("kernel_time", **row)
    return rows


def profile_phase(name: str, fn, wall_s: float, grad: bool = False) -> None:
    """Device time by kernel over one traced run of `fn` (torch.profiler).
    The idle share compares the traced device time with the untraced wall
    time `wall_s` of the same work."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.set_grad_enabled(grad), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
                                    "decode_int8_kernel"),
         flash_bwd_kernels_ms=share("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"),
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from trlx_tpu_torch.ops import _build

    card = nvidia_smi()
    emit("device", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build()
    emit("build", seconds=time.perf_counter() - t0,
         ptxas=[ln.strip() for ln in _build.build_log().splitlines()
                if "registers" in ln or "spill" in ln])

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    errs = {"flash": check_flash(gen)["max_abs_err"], "decode": check_decode(gen)["max_abs_err"]}
    bwd_errs = check_flash_bwd(gen)
    launches = main_path(args.seed)
    trainer, train_launches = train_path(args.seed)
    batch = train_reference(trainer, args.seed)["batch"]
    train_step_profile(trainer, batch)
    del trainer, batch
    torch.cuda.empty_cache()
    rows = kernel_times(gen, launches, errs, train_launches)
    rows += bwd_kernel_times(gen, train_launches, bwd_errs)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
