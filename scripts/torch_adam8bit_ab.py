"""Kernel 9 (the fused 8-bit AdamW step) of two trees of the port, on one CUDA
card, in one call: the kernels side by side, then the full-parameter
Llama-2-7B train step with each tree's package.

    python3 scripts/torch_adam8bit_ab.py --parent DIR [--seed 0]
        [--out chiprun_out/adam8bit_ab.jsonl] [--kernels-only | --cells-only]

`--parent` is an unpacked checkout of the other tree (e.g. `git archive
<commit> | tar -x -C build/parent`). Each tree runs in a process of its own
(its `trlx_tpu_torch` first on the path, so each builds and calls its own
`ops/adam8bit.py::adam8bit_step` from its own `csrc/`), in the order parent,
change, change, parent. This tree's `chip_smoke.py` supplies the leaves, the
check, the timer and the 7B cell's configuration.

- kernels: `chip_smoke.check_adam8bit` (every leaf, fp32 and bf16
  gradients, fused and bnb, against the plain version; whether each case
  was bit for bit), then `chip_smoke.adam8bit_rows` (the 7B MLP and GPT-2
  leaves, bf16 gradient: device time with L2 flushed, the plain version,
  the bound). Beside them the SASS of the tree's kernel (`cuobjdump -sass`
  of its built library): for each instantiation, its instructions, those
  of its main loop (the innermost back edge whose body holds the
  parameter loads, the 16-byte ones where there are any), those on the
  loop's common path
  (without the blocks that only lead to an out-of-line call: the
  correctly rounded division's and square root's slow paths, the exact
  requantisation), and that count an element (the first version's loop
  takes one element a thread a trip, a CTA a block; the redesign's 8, a
  warp a block). The issue floor of a leaf is its elements times
  that count over the card's lanes (SMs x 128) at its maximum SM clock.
- cells: the 7B cell's trainer (`chip_smoke.llama_full_config`, random
  weights drawn on the card, the checkpoint commit and the evaluation left
  out), LLAMA_FULL_STEPS steps on its fixed batch, each timed with a
  synchronise (the median of all but the first is the step's wall), then
  one more traced with torch.profiler (device kernels only:
  `chip_smoke.profile_phase`): device busy ms, kernel 9's ms
  (`adam8bit_kernel_ms`), the long attention routes' (`flash_fwd_kernels_ms`,
  `flash_bwd_kernels_ms`), the GEMMs', the idle share against the wall.

Each row is one JSON line on stdout and in `--out`; the card's name and
power limit come first. The SASS listings go beside `--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")
LANE_ELEMENTS = 8  # the redesigned kernel's elements a lane a block (a trip of its loop)
TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b")


def emit(out, **row) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def sass_functions(text: str) -> dict:
    """{function name: [(address, instruction, branch target or None)]} of
    a `cuobjdump -sass` listing, NOPs left out, label targets resolved."""
    raw, labels, name, pending = {}, {}, None, []
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name, pending = m.group(1), []
            raw[name], labels[name] = [], {}
            continue
        if name is None:
            continue
        m = LABEL.match(ln)
        if m:
            pending.append(m.group(1))
            continue
        m = INSTR.search(ln)
        if m and not m.group(2).startswith("0x"):
            addr = int(m.group(1), 16)
            labels[name].update((lab, addr) for lab in pending)
            pending = []
            raw[name].append((addr, m.group(2)))
    out = {}
    for name, instrs in raw.items():
        rows = []
        for addr, op in instrs:
            if op.startswith("NOP"):
                continue
            target = None
            if re.search(r"\b(BRA|CALL)", op):
                m = TARGET.search(op)
                if m is not None:
                    target = labels[name].get(m.group(1)) if m.group(1) else int(m.group(2), 16)
            rows.append((addr, op, target))
        out[name] = rows
    return out


def loop_counts(instrs: list, elements_a_trip: int) -> dict:
    """The function's instructions; its main loop's (see the module's
    docstring); the loop's common path; that path an element."""
    loops = []
    for addr, op, target in instrs:
        if re.search(r"\bBRA\b", op) and target is not None and target <= addr:
            body = [(a, o, t) for a, o, t in instrs if target <= a <= addr]
            if any(o.startswith("LDG") or " LDG" in o for _, o, _ in body):
                loops.append(body)
    vector = [b for b in loops if any("LDG.E.128" in o for _, o, _ in b)]
    if not loops:
        return {"instructions": len(instrs), "loop": None}
    # the innermost: a block placed after the kernel's body that jumps back
    # to its call site also looks like a back edge, around everything
    body = min(vector or loops, key=lambda b: b[-1][0] - b[0][0])
    # blocks that lead to an out-of-line call: the instructions a forward
    # branch within the loop skips when a CALL lies among them (a
    # conditional branch's fall-through into the call, or the jump over an
    # else-block holding it); BRA.DIV, taken only by a diverged warp, skips
    # the common path
    rare, end = set(), body[-1][0]
    for i, (a, o, t) in enumerate(body):
        if re.search(r"\bBRA(?!\.DIV)\b", o) and t is not None and a < t <= end:
            span = [(b, p) for b, p, _ in body[i + 1:] if b < t]
            if any("CALL" in p for _, p in span):
                rare.update(b for b, _ in span)
    common = [a for a, _, _ in body if a not in rare]
    return {"instructions": len(instrs), "loop": len(body), "loop_common_path": len(common),
            "elements_a_trip": elements_a_trip, "per_element": len(common) / elements_a_trip,
            "per_element_whole_loop": len(body) / elements_a_trip}


def sass_report(lib: str, dump_to: str) -> list:
    """Each kernel 9 instantiation of the built library `lib`."""
    from trlx_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True, check=True).stdout
    with open(dump_to, "w") as f:
        f.write(text)
    rows = []
    for name, instrs in sass_functions(text).items():
        if "adam8bit_kernel" not in name:
            continue
        # the redesign's kernel has two template arguments (<bool, int>)
        two = re.search(r"adam8bit_kernelILb\dELi\d", name) is not None
        rows.append(dict(function=name, **loop_counts(instrs, LANE_ELEMENTS if two else 1)))
    return rows


def kernel_run(seed: int, dump_to: str) -> dict:
    """This process's tree's kernel 9: the check, the timed rows, the SASS."""
    import torch

    import chip_smoke as cs
    from trlx_tpu_torch.ops import _build

    libs = _build.build()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    check = cs.check_adam8bit(gen)
    rows = cs.adam8bit_rows(gen, check["by_leaf"], None)
    sass = sass_report(str(libs["adam8bit"]), dump_to)
    clock_mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                     capture_output=True, text=True).stdout.split()[0])
    lanes_per_ms = torch.cuda.get_device_properties(0).multi_processor_count * 128 * clock_mhz * 1e3
    # the timed rows' instantiation: a bf16 gradient, fused, with decay
    timed = [f for f in sass if re.search(r"adam8bit_kernelILb1E(Li1E)?E", f["function"])]
    for row in rows:
        n = row["shape"][0] * row["shape"][1]
        if timed and timed[0].get("per_element"):
            row["issue_floor_ms"] = n * timed[0]["per_element"] / lanes_per_ms
    return {"check_worst": {k: v for k, v in check.items() if k != "by_leaf"}, "rows": rows, "sass": sass,
            "clock_max_mhz": clock_mhz}


def cell_run(seed: int) -> dict:
    """This process's tree's 7B train step."""
    import shutil

    import torch

    import chip_smoke as cs
    import trlx_tpu_torch
    from trlx_tpu_torch.models.wrappers import CausalLM
    from trlx_tpu_torch.trainer.base import TPUBaseTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    held = {}
    init_params, learn = CausalLM.init_params, TPUBaseTrainer.learn

    def init_on_card(self, generator):
        self.base.init_params(torch.Generator(device="cuda").manual_seed(seed))
        return self.init_heads(generator)

    def keep(self):  # learn() up to its loop
        self.prepare_learning()
        held["trainer"] = self

    CausalLM.init_params, TPUBaseTrainer.learn = init_on_card, keep
    try:
        trlx_tpu_torch.train(samples=cs.llama_full_samples(seed), config=cs.llama_full_config(seed))
    finally:
        CausalLM.init_params, TPUBaseTrainer.learn = init_params, learn
    trainer = held.pop("trainer")
    batch = next(iter(trainer.store.create_loader(cs.LLAMA_FULL_BATCH, shuffle=False)))
    walls, losses = [], []
    for _ in range(cs.LLAMA_FULL_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = trainer.train_step(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(loss))
    wall = statistics.median(walls[1:])
    sums = {}
    cs.profile_phase("llama_full_train_step", lambda: trainer.train_step(batch), wall, grad=True, host_ops=False,
                     out=sums)
    keep_keys = ("wall_ms", "device_busy_ms", "device_idle_share", "adam8bit_kernel_ms", "flash_fwd_kernels_ms",
                 "flash_bwd_kernels_ms", "matmul_ms", "top")
    out = {k: sums[k] for k in keep_keys}
    out.update(step_walls_ms=[w * 1e3 for w in walls], losses=losses,
               trainable_tensors=len(trainer.trainable_params))
    del trainer, batch
    torch.cuda.empty_cache()
    for root in cs._CKPT_ROOT:
        shutil.rmtree(root, ignore_errors=True)
    return out


def in_tree(tree: str, who: str, what: str, args, turn: int) -> dict:
    """Run `what` ("kernels" or "cells") in a process of its own with `tree`'s
    package; its result."""
    dump = os.path.join(os.path.dirname(os.path.abspath(args.out)), f"adam8bit_sass_{who}_{turn}.txt")
    cmd = [sys.executable, os.path.abspath(__file__), "--run-in", tree, "--what", what, "--seed", str(args.seed),
           "--dump", dump]
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
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "adam8bit_ab.jsonl"))
    ap.add_argument("--cells-only", action="store_true")
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--run-in", default=None, help=argparse.SUPPRESS)  # a tree's root: run `--what` with it
    ap.add_argument("--what", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dump", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run_in:
        sys.path.insert(0, REPO)
        import chip_smoke  # noqa: F401  this tree's (it imports no trlx_tpu_torch at import)

        sys.path.insert(0, args.run_in)  # ahead of this tree: the tree's trlx_tpu_torch
        result = kernel_run(args.seed, args.dump) if args.what == "kernels" else cell_run(args.seed)
        print(json.dumps({"result": result}), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_adam8bit_ab: no CUDA device", file=sys.stderr)
        return 2
    if not args.parent:
        ap.error("--parent is required")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    emit(args.out, what="device", nvidia_smi=cs.nvidia_smi(), name=torch.cuda.get_device_name(0))
    parent = os.path.abspath(args.parent)
    order = (("parent", parent), ("change", REPO), ("change", REPO), ("parent", parent))
    for what in ("kernels", "cells"):
        if (what == "kernels" and args.cells_only) or (what == "cells" and args.kernels_only):
            continue
        for turn, (who, tree) in enumerate(order):
            emit(args.out, what=what, who=who, tree=tree, **in_tree(tree, who, what, args, turn))
    return 0


if __name__ == "__main__":
    sys.exit(main())
