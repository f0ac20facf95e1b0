"""Offline memory preflight: the memory doctor's admission-control plan
from a config file alone, with no trainer, no card and no allocation
(the counterpart of the JAX package's `scripts/hbm_plan.py`, over
`trlx_tpu_torch.utils.memdoctor.analytic_plan`: one process, one device).

    python -m trlx_tpu_torch.tools.hbm_plan configs/ppo_config.yml
    python -m trlx_tpu_torch.tools.hbm_plan config.yml --hbm-gb 80   # the budget
    python -m trlx_tpu_torch.tools.hbm_plan config.yml --json
    python -m trlx_tpu_torch.tools.hbm_plan config.yml --set train.batch_size=512

Exit code 0: the plan fits (or no budget is known: report only); 1: over
budget, the verdict `train.memory.preflight: enforce` would reach in
learn() before any rollout.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("config", help="TRLConfig YAML path")
    parser.add_argument("--hbm-gb", type=float, default=0.0,
                        help="the device budget in GiB (overrides train.memory.hbm_bytes; 0 = the config's, or "
                             "the card's when one is present, else report only)")
    parser.add_argument("--json", action="store_true", help="print the plan as one JSON object")
    parser.add_argument("--set", action="append", default=[], metavar="PATH=VALUE",
                        help="dotted-path config overrides, e.g. train.batch_size=512 (repeatable)")
    args = parser.parse_args(argv)

    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils.memdoctor import analytic_plan

    config = TRLConfig.load_yaml(args.config)
    if args.set:
        overrides = {}
        for item in args.set:
            path, sep, raw = item.partition("=")
            if not sep:
                parser.error(f"--set {item!r}: expected PATH=VALUE")
            try:
                overrides[path] = json.loads(raw)
            except json.JSONDecodeError:
                overrides[path] = raw
        config = TRLConfig.update(config, overrides)
    plan = analytic_plan(config, hbm_bytes=int(args.hbm_gb * (1 << 30)))
    print(json.dumps(plan.to_dict(), indent=2) if args.json else plan.report())
    if plan.over_budget():
        if not args.json:
            print("\nVERDICT: OVER BUDGET — train.memory.preflight: enforce would reject this config before any "
                  "rollout. Lower batch/seq/chunk sizes, set train.logit_chunks / grads_dtype / remat_policy, or "
                  "shrink method.gen_engine's pool.")
        return 1
    if not args.json:
        print("\nVERDICT: fits" if plan.budget_bytes > 0 else "\nVERDICT: no budget known (pass --hbm-gb) — report only")
    return 0


if __name__ == "__main__":
    sys.exit(main())
