"""Where the fused attention backward kernels spend their time.

    python3 -m trlx_tpu_torch.tools.bwd_stages [--kernel bias|plain|all] [--seed N] [--out FILE]

Builds variants of a fused backward kernel's source that return after
each of its stages, and one without its register bounds, into
`build/stages/`, then times each on the card at the shapes of the train
paths that run it, as `chip_smoke.py` times kernels: median device time
of one call by CUDA events, the L2 flushed before each. A stage's cost is
the difference between the cut after it and the cut before it; the cut
"start" is an empty kernel with the same launch. Each variant's CTAs an
SM come from the CUDA occupancy API.

- `bias`: `flash_bias_bwd_fused_kernel` of `csrc/flash_bias_bwd.cu`
  (stages: operand loads, the query-major phase, the key-major phase, the
  arrival, the dbias sum) at T5's shapes (B12 H12 D64: the encoder's
  T = S = 32, the decoder's T = S = 65, causal);
- `plain`: `flash_bwd_fused_kernel` of `csrc/flash_bwd.cu` (stages:
  operand loads, the query-major phase, the key-major phase) at GPT-2's
  train shape (B32 H12 D64, T = S = 64, causal) and T5's cross-attention
  (B12 H12, T = 65 queries over S = 32 keys, not causal, scale 1).

Prints one JSON line per (kernel, shape, variant) and the card's name and
power limit; `--out` writes the lines too.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

# each variant returns just before the text its stage names (every thread
# of the CTA, so no barrier waits)
START = "  const int TP = (T + 15) & ~15;\n  const int n_strips"
KERNELS = {
    "bias": dict(
        source="flash_bias_bwd.cu",
        stages=(("start", START), ("loads", "  // 2a. query-major"), ("query_major", "  // 2b. key-major"),
                ("key_major", "  // 3. dbias: the last")),
        # the arrival without the dbias sum: the last CTA resets its counter
        extra={"arrival": ("  if (!last_s) return;\n  __threadfence();\n",
                           "  if (!last_s) return;\n  if (tid == 0) arrivals[h] = 0;\n  return;\n")},
        bounds="__launch_bounds__(NK == 5 ? 192 : (NK > 4 ? 32 * NK : 128), NK <= 5 ? 2 : 1)",
        shapes={"encoder": (12, 12, 32, 32, False), "decoder": (12, 12, 65, 65, True)},  # B, H, T, S, causal
    ),
    "plain": dict(
        source="flash_bwd.cu",
        stages=(("start", START), ("loads", "    // 2a. query-major"), ("query_major", "    // 2b. key-major")),
        extra={},
        bounds="__launch_bounds__(NK == 5 ? 192 : (NK > 4 ? 32 * NK : 128), NK <= 4 ? 3 : (NK == 5 ? 2 : 1))",
        shapes={"train": (32, 12, 64, 64, True), "t5_cross": (12, 12, 65, 32, False)},
    ),
}


def variants(src: str, kernel: dict) -> dict:
    """{name: source} for every cut, the whole kernel and the unbounded one."""

    def patched(old: str, new: str) -> str:
        if src.count(old) != 1:
            raise RuntimeError(f"anchor not found once in {kernel['source']}: {old!r}")
        return src.replace(old, new)

    out = {name: patched(anchor, "  if (true) return;\n" + anchor) for name, anchor in kernel["stages"]}
    out.update({name: patched(old, new) for name, (old, new) in kernel["extra"].items()})
    out["whole"] = src
    out["whole_unbounded_registers"] = patched(kernel["bounds"], "__launch_bounds__(256)")
    return out


def build(sources: dict, out_dir: Path) -> dict:
    from trlx_tpu_torch.ops import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, text in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(out_dir / f"{name}.so"), str(cu)]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for name, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{err}")
        libs[name] = ctypes.CDLL(str(out_dir / f"{name}.so"))
    return libs


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
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


def fused_call(kind: str, gen, B, H, T, S, causal):
    """(the fused kernel's wrapper call on seeded inputs, its occupancy
    query): `bias` with a right-padded key mask and an fp32 bias, `plain`
    with a left-padded key mask (at the default causal offset S - T)."""
    import torch

    from trlx_tpu_torch.ops import flash_attention as fa

    def randn(*s):
        return torch.randn(s, generator=gen, device="cuda")

    q, g = (randn(B, H, T, 64).to(torch.bfloat16) for _ in range(2))
    k, v = (randn(B, H, S, 64).to(torch.bfloat16) for _ in range(2))
    slots = torch.arange(S, device="cuda")[None, :]
    if kind == "bias":
        bias = randn(H, T, S)
        length = torch.randint(S // 2, S + 1, (B,), generator=gen, device="cuda")
        mask = (slots < length[:, None]).to(torch.int32)
        _, m, l = fa.flash_attention_bias(q, k, v, mask, bias, causal=causal, with_stats=True)
        km, g2 = fa.backward_operands(q, k, v, mask, g, m, l)
        bias32 = fa._check_bias(q, k, bias, causal)
        return (lambda: fa.flash_attention_bias_bwd(q, k, v, km, bias32, g2, m, l, causal, 1.0),
                lambda: fa.flash_attention_bias_bwd_occupancy(T, S))
    pad = torch.randint(0, S // 2 + 1, (B,), generator=gen, device="cuda")
    mask = (slots >= pad[:, None]).to(torch.int32)
    scale, q_offset = (64 ** -0.5, S - T) if causal else (1.0, 0)
    _, m, l = fa.flash_attention(q, k, v, mask, causal=causal, sm_scale=scale, with_stats=True)
    km, g2 = fa.backward_operands(q, k, v, mask, g, m, l)
    return (lambda: fa.flash_attention_bwd(q, k, v, km, g2, m, l, causal, scale, q_offset),
            lambda: fa.flash_attention_bwd_occupancy(T, S))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernel", choices=("bias", "plain", "all"), default="all")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bwd_stages: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from trlx_tpu_torch.ops import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    kinds = ("bias", "plain") if args.kernel == "all" else (args.kernel,)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    lines = []
    load = _build.load
    try:
        for kind in kinds:
            kernel = KERNELS[kind]
            source = kernel["source"]
            libs = build(variants((_build.CSRC / source).read_text(), kernel), _build.BUILD_ROOT.parent / "stages" / kind)
            for shape, (B, H, T, S, causal) in kernel["shapes"].items():
                call, occupancy = fused_call(kind, gen, B, H, T, S, causal)
                for name, lib in libs.items():
                    _build.load = lambda src, lib=lib, source=source: lib if src == source else load(src)
                    line = dict(kernel=kind, shape=shape, dims=[B, H, T, S, 64], causal=causal, variant=name,
                                ms=time_ms(call), occupancy=occupancy(), card=card)
                    lines.append(line)
                    print(json.dumps(line), flush=True)
    finally:
        _build.load = load
    print(card)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
