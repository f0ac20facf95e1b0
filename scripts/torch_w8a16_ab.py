"""Kernel 10 (the W8A16 product of the int8 decode weights) of two trees of
the port, on one CUDA card, in one call: the kernels side by side at the
recipe and 7B cells' shapes, then the two cells' end-to-end times with each
tree's package.

    python3 scripts/torch_w8a16_ab.py --parent DIR [--seed 0] [--calls 10000]
        [--out chiprun_out/w8a16_ab.jsonl] [--kernels-only | --cells-only] [--tilings]

`--parent` is an unpacked checkout of the other tree (e.g. `git archive
<commit> | tar -x -C build/parent`). Each tree runs in a process of its own
(its `trlx_tpu_torch` first on the path, so each builds and calls its own
`ops/int8_matmul.py::int8_weight_matmul` from its own `csrc/`), in the
order parent, change, change, parent. This tree's `chip_smoke.py` supplies
the shapes (`W8A16_PATH_SHAPES`), the timer and the cells' configurations.

- kernels: at each shape, on the same inputs in every process (drawn from
  `--seed` on the card), the output held to the fp32 product (half a bf16
  ulp, as `chip_smoke.int8_matmul_error`) and bit for bit on a second call;
  its device time as `chip_smoke.time_ms` takes it (L2 flushed, median of
  CUDA events); `torch.matmul` on the bf16 weight; the bound. At the decode
  shapes (64 rows or fewer) also the wrapper's host cost (`host_us`): the
  host's time a call over `--calls` calls made in batches of HOST_BATCH,
  each enqueued behind a sleep on the card that outlasts it (`covered`:
  every batch returned before its sleep ended), so the host never waits on
  the card; and `wall_us`, the same calls back to back until the card has
  run them all. A `floor` row times a one-element op as `ms` is timed.
- `--tilings`: this tree's wgmma route at every row tile and K split, on
  the recipe's prefill shapes and a short-M, long-K one (its private
  `_launch_route`, each output held as above).
- cells: `recipe`, `trlx_tpu_torch.train` under `chip_smoke.recipe_config`
  (the recipe PPO cell) once untimed (it builds the kernels), once timed,
  then again under torch.profiler (device kernels only) for its device busy
  time and idle share against the timed run's wall; `llama_eval`, the 7B
  cell's trainer (`chip_smoke.llama_full_config`, random weights drawn on
  the card, no step taken) and its evaluation of 32 prompts x 32 new tokens
  on int8 decode weights, timed twice (the second is kept), then traced the
  same way.

Each row is one JSON line on stdout and in `--out`; the card's name and
power limit come first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_BATCH = 250
HOST_SLEEP_CYCLES = 60_000_000  # about 30 ms of an H100's clock: more than a batch's host time
# the wgmma route's tilings: the recipe's prefill shapes and a short-M,
# long-K one
TILING_SHAPES = ((2048, 768, 768), (2048, 3072, 768), (1024, 768, 768), (1024, 3072, 768), (1024, 768, 3072),
                 (128, 4096, 768))


def emit(out, **row) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def _inputs(seed: int, M: int, K: int, N: int):
    import torch

    from trlx_tpu_torch.ops import int8_matmul as im

    gen = torch.Generator(device="cuda").manual_seed(seed * 1_000_003 + M * 7919 + K * 31 + N)
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((K, N), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    q, s = im.quantize_kernel(w)
    return x, w, q, s


def _held(call, x, q, s) -> float:
    """call()'s output against the fp32 product, in units of half a bf16
    ulp; raises past 1 or when a second call differs in any bit."""
    import torch

    y, again = call(), call()
    ref = torch.matmul(x.float(), q.float()) * s
    allowed = 2.0 ** -8 * ref.abs() + 1e-5 * ref.abs().max()
    err = ((y.float() - ref).abs() / allowed).max().item()
    if not err <= 1.0 or not torch.equal(y, again):
        raise AssertionError(f"kernel 10 at {tuple(x.shape)} x {tuple(q.shape)}: {err}, repeat "
                             f"{torch.equal(y, again)}")
    return err


def host_cost(call, calls: int) -> dict:
    """The host's microseconds a call, with the card kept busy ahead of the
    host (see the module's docstring), and the wall's a call back to back."""
    import torch

    host, covered, batches = 0.0, True, max(1, calls // HOST_BATCH)
    for _ in range(batches):
        torch.cuda.synchronize()
        torch.cuda._sleep(HOST_SLEEP_CYCLES)
        slept = torch.cuda.Event()
        slept.record()
        t0 = time.perf_counter()
        for _ in range(HOST_BATCH):
            call()
        host += time.perf_counter() - t0
        covered = covered and not slept.query()
    torch.cuda.synchronize()
    n = batches * HOST_BATCH
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    torch.cuda.synchronize()
    return {"host_us": host / n * 1e6, "covered": covered, "wall_us": (time.perf_counter() - t0) / n * 1e6,
            "calls": n}


def kernel_run(seed: int, calls: int) -> list:
    """This process's tree's kernel 10 at every path shape."""
    import torch

    import chip_smoke as cs
    from trlx_tpu_torch.ops import int8_matmul as im

    one = torch.ones(1, device="cuda")
    rows = [{"what": "floor", "ms": cs.time_ms(lambda: one.add_(1))}]
    for M, K, N in cs.W8A16_PATH_SHAPES:
        x, w, q, s = _inputs(seed, M, K, N)
        call = lambda: im.int8_weight_matmul(x, q, s)  # noqa: E731
        row = {"what": "kernel", "shape": [M, K, N], "rel_to_half_ulp": _held(call, x, q, s),
               "ms": cs.time_ms(call), "library_ms": cs.time_ms(lambda: torch.matmul(x, w))}
        row["bound_ms"], row["bound_by"] = cs.bound_ms(K * N + 2 * M * K + 2 * M * N + 4 * N, 2 * M * K * N)
        if M <= 64:
            row.update(host_cost(call, calls))
        rows.append(row)
    return rows


def tiling_rows(seed: int) -> list:
    """This tree's wgmma route at rows 128 and 256 and K split 1, 2, 4 and 8
    (each split keeping at least two 64-deep stages a CTA)."""
    import torch

    import chip_smoke as cs
    from trlx_tpu_torch.ops import int8_matmul as im

    out = []
    for M, K, N in TILING_SHAPES:
        x, w, q, s = _inputs(seed, M, K, N)
        row = {"what": "tilings", "shape": [M, K, N], "route": list(im.int8_matmul_route(M, N, K))}
        for rows in (128, 256):
            for splits in (1, 2, 4, 8):
                if splits > 1 and 2 * splits > -(-K // 64):
                    continue
                call = lambda: im._launch_route(x, q, s, "wgmma", rows, im.WGMMA_COLS, splits)  # noqa: E731
                _held(call, x, q, s)
                row[f"rows{rows}_splits{splits}_ms"] = cs.time_ms(call)
        row["library_ms"] = cs.time_ms(lambda: torch.matmul(x, w))
        out.append(row)
    return out


def cell_run(seed: int) -> dict:
    """This process's tree's cells."""
    import shutil

    import torch

    import chip_smoke as cs
    import trlx_tpu_torch
    from trlx_tpu_torch.models.wrappers import CausalLM
    from trlx_tpu_torch.trainer.base import TPUBaseTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = {}

    def traced(name, fn, wall, grad=False):
        sums = {}
        cs.profile_phase(name, fn, wall, grad=grad, host_ops=False, out=sums)
        return {k: sums[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share")}

    def recipe():
        return trlx_tpu_torch.train(reward_fn=cs.train_reward_fn, prompts=cs.TRAIN_PROMPTS,
                                    config=cs.recipe_config(seed))

    recipe()  # the build and the process's first-call costs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recipe()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows["recipe"] = traced("recipe_train", recipe, wall, grad=True)
    torch.cuda.empty_cache()

    held = {}
    init_params, learn = CausalLM.init_params, TPUBaseTrainer.learn

    def init_on_card(self, generator):
        self.base.init_params(torch.Generator(device="cuda").manual_seed(seed))
        return self.init_heads(generator)

    def keep(self):  # learn() up to its loop: the evaluation's loader
        self.prepare_learning()
        held["trainer"] = self

    CausalLM.init_params, TPUBaseTrainer.learn = init_on_card, keep
    try:
        eval_prompts = [f"{cs.TRAIN_PROMPTS[i % 8]} ({i})" for i in range(cs.LLAMA_FULL_EVAL_PROMPTS)]
        trlx_tpu_torch.train(samples=cs.llama_full_samples(seed), eval_prompts=eval_prompts,
                             config=cs.llama_full_config(seed))
    finally:
        CausalLM.init_params, TPUBaseTrainer.learn = init_params, learn
    trainer = held["trainer"]
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.evaluate()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    rows["llama_eval"] = dict(traced("llama_eval", trainer.evaluate, walls[-1]), walls_s=walls)
    for root in cs._CKPT_ROOT:
        shutil.rmtree(root, ignore_errors=True)
    return rows


def in_tree(tree: str, what: str, args) -> dict:
    """Run `what` ("kernels" or "cells") in a process of its own with `tree`'s
    package; its result."""
    cmd = [sys.executable, os.path.abspath(__file__), "--run-in", tree, "--what", what, "--seed", str(args.seed),
           "--calls", str(args.calls)] + (["--tilings"] if args.tilings else [])
    res = subprocess.run(cmd, capture_output=True, text=True)
    got = [json.loads(ln)["result"] for ln in res.stdout.splitlines() if ln.startswith('{"result"')]
    if res.returncode or not got:
        print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
        raise RuntimeError(f"{what} in {tree} failed (exit {res.returncode})")
    return got[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=False)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calls", type=int, default=10_000)
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "w8a16_ab.jsonl"))
    ap.add_argument("--cells-only", action="store_true")
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--tilings", action="store_true")
    ap.add_argument("--run-in", default=None, help=argparse.SUPPRESS)  # a tree's root: run `--what` with it
    ap.add_argument("--what", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run_in:
        sys.path.insert(0, REPO)
        import chip_smoke  # noqa: F401  this tree's (it imports no trlx_tpu_torch at import)

        sys.path.insert(0, args.run_in)  # ahead of this tree: the tree's trlx_tpu_torch
        if args.what == "kernels":
            result = {"kernels": kernel_run(args.seed, args.calls)}
            if args.tilings and os.path.samefile(args.run_in, REPO):
                result["tilings"] = tiling_rows(args.seed)
        else:
            result = cell_run(args.seed)
        print(json.dumps({"result": result}), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_w8a16_ab: no CUDA device", file=sys.stderr)
        return 2
    if not args.parent:
        ap.error("--parent is required")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    emit(args.out, what="device", nvidia_smi=cs.nvidia_smi(), name=torch.cuda.get_device_name(0))
    parent = os.path.abspath(args.parent)
    order = (("parent", parent), ("change", REPO), ("change", REPO), ("parent", parent))
    for what in ("kernels", "cells"):
        if (what == "kernels" and args.cells_only) or (what == "cells" and args.kernels_only):
            continue
        for who, tree in order:
            emit(args.out, what=what, who=who, tree=tree, **in_tree(tree, what, args))
    return 0


if __name__ == "__main__":
    sys.exit(main())
