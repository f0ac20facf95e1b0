#!/usr/bin/env python3
"""Drive trlx_tpu_torch's PPO rollout path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the CUDA kernels from `trlx_tpu_torch/csrc` (into build/kernels/),
holds each kernel against its plain PyTorch version on the card, then
runs the rollout path of a GPT-2-small policy (12 x 768, vocab 50257,
random weights from the seed) through the entry points a user calls:
`CausalLMWithValueHead.from_config` on the default PPO config,
`generate` (greedy and sampled, int8 KV cache, 64 byte-tokenised prompts
left-padded to 32, 40 new tokens) and `forward_train` (policy logits,
values, hydra reference logits) with `logprobs_of_labels`. The launch
counters show the path ran through the kernels; the same greedy rollout
through the plain attention math is the whole-path reference.

Each phase prints one JSON line. The last two lines are the card's name
and power limit as nvidia-smi reports them, then
{"ok": true, "device": {...}}. Any failure raises and exits non-zero
without that line; with no CUDA device the script exits 2 at once.
"""

from __future__ import annotations

import argparse
import json
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


def profile_phase(name: str, fn, wall_s: float) -> None:
    """Device time by kernel over one traced run of `fn` (torch.profiler).
    The idle share compares the traced device time with the untraced wall
    time `wall_s` of the same work."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]

    def share(*words):
        return sum(e.self_device_time_total for e in kernels if any(w in e.key for w in words)) / 1e3

    emit("profile", what=name, wall_ms=wall_s * 1e3, device_busy_ms=busy_ms,
         device_idle_share=(1 - busy_ms / (wall_s * 1e3)) if busy_ms else None,
         attention_kernels_ms=share("flash_fwd_kernel", "decode_int8_kernel"),
         matmul_ms=share("gemm", "Gemm", "xmma", "nvjet", "cutlass"),
         top=[dict(kernel=e.key[:90], ms=e.self_device_time_total / 1e3, calls=e.count) for e in top])


def kernel_times(gen, launches, errs) -> list:
    """Kernel, plain and library times at the main path's shapes."""
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
                launches=launches["flash_" + key], max_abs_err=errs["flash"],
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
            launches=launches["decode"], max_abs_err=errs["decode"], shape=[L, B, H, S, D],
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
    launches = main_path(args.seed)
    rows = kernel_times(gen, launches, errs)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
