"""Read the check's numbers with the control in the program's place.

    python benchmark/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 5 [--variants skip_returning,fresh]

Runs the cell's chain, at the cell's own size, with the reference's plain
planner in place of the program, once per variant (entries/control.py)
and seed, and prints one JSON line per run: the variant, the seed, and
each number the check compared beside its limit.  Each variant breaks
one guarantee, so each run has to come out not correct; the smallest
reading of a number over the seeds is the upper reading its limit is set
below.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--variants", default="skip_returning,fresh,no_rule")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import harness

    wrong = 0
    for variant in args.variants.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            result, _ = harness.run_cell(args.workload, seed, args.seconds,
                                         False, device="cpu",
                                         control=variant)
            wrong += not result["correct"]
            print(json.dumps({"variant": variant, "seed": seed,
                              "correct": result["correct"],
                              "requests": result["attempted"],
                              "checks": result["checks"]}), flush=True)
    print(json.dumps({"runs_not_correct": wrong}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
