"""Where the fused bias-attention backward kernel spends its time.

    python3 -m trlx_tpu_torch.tools.bias_bwd_stages [--seed N] [--out FILE]

Builds variants of `csrc/flash_bias_bwd.cu` whose fused kernel returns
after each of its stages (operand loads, the query-major phase, the
key-major phase, the arrival, the dbias sum), and one without its
register bounds, into `build/stages/`, then times each on the card at T5's
train-path shapes (B12 H12 D64: the encoder's T = S = 32, the decoder's
T = S = 65, causal), as `chip_smoke.py` times kernels: median device time
of one call by CUDA events, the L2 flushed before each. A stage's cost is
the difference between the cut after it and the cut before it; the cut
"start" is an empty kernel with the same launch. Each variant's CTAs an
SM come from the CUDA occupancy API. Prints one JSON line per (shape,
variant) and the card's name and power limit; `--out` writes them too.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

# fused-kernel anchors in csrc/flash_bias_bwd.cu: each variant returns just
# before the text it names (every thread of the CTA, so no barrier waits)
STAGES = (
    ("start", "  const int TP = (T + 15) & ~15;\n  const int n_strips"),
    ("loads", "  // 2a. query-major"),
    ("query_major", "  // 2b. key-major"),
    ("key_major", "  // 3. dbias: the last"),
)
ARRIVED = "  if (!last_s) return;\n  __threadfence();\n"
BOUNDS = "__launch_bounds__(NK == 5 ? 192 : (NK > 4 ? 32 * NK : 128), NK <= 5 ? 2 : 1)"
SHAPES = {"encoder": (12, 12, 32, False), "decoder": (12, 12, 65, True)}  # B, H, T = S, causal


def variants(src: str) -> dict:
    """{name: source} for every cut, the whole kernel and the unbounded one."""

    def patched(old: str, new: str) -> str:
        if src.count(old) != 1:
            raise RuntimeError(f"anchor not found once in flash_bias_bwd.cu: {old!r}")
        return src.replace(old, new)

    out = {name: patched(anchor, "  if (true) return;\n" + anchor) for name, anchor in STAGES}
    out["arrival"] = patched(ARRIVED, "  if (!last_s) return;\n  if (tid == 0) arrivals[h] = 0;\n  return;\n")
    out["whole"] = src
    out["whole_unbounded_registers"] = patched(BOUNDS, "__launch_bounds__(256)")
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bias_bwd_stages: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from trlx_tpu_torch.ops import _build
    from trlx_tpu_torch.ops import flash_attention as fa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    libs = build(variants((_build.CSRC / "flash_bias_bwd.cu").read_text()), _build.BUILD_ROOT.parent / "stages")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    lines = []
    load = _build.load
    try:
        for shape, (B, H, T, causal) in SHAPES.items():
            def randn(*s):
                return torch.randn(s, generator=gen, device="cuda")

            q, k, v, g = (randn(B, H, T, 64).to(torch.bfloat16) for _ in range(4))
            bias = randn(H, T, T)
            length = torch.randint(T // 2, T + 1, (B,), generator=gen, device="cuda")
            mask = (torch.arange(T, device="cuda")[None, :] < length[:, None]).to(torch.int32)
            _, m, l = fa.flash_attention_bias(q, k, v, mask, bias, causal=causal, with_stats=True)
            km, g2, _ = fa.backward_operands(q, k, v, mask, g, m, l)
            bias32 = fa._check_bias(q, k, bias, causal)
            for name, lib in libs.items():
                _build.load = lambda source, lib=lib: lib if source == "flash_bias_bwd.cu" else load(source)
                ms = time_ms(lambda: fa.flash_attention_bias_bwd(q, k, v, km, bias32, g2, m, l, causal, 1.0))
                line = dict(shape=shape, dims=[B, H, T, T, 64], causal=causal, variant=name, ms=ms,
                            occupancy=fa.flash_attention_bias_bwd_occupancy(T, T), card=card)
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
