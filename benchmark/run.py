"""Run one cell of the benchmark of ``blance_tpu_torch`` once.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  Sets up (imports, the card, the kernels' builds, the deployment
made from the seed, warm-up requests), measures for ``--seconds``,
checks every request of the window against the plain reference
(reference.py), and prints as its last line of standard output one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each number the
check compared beside its limit (also the last lines of standard error).

Exits non-zero, printing no result, without CUDA or with fewer cards
than the cell asks for, and if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, "_cache")


def process_age_s() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def main() -> int:
    t_start = T_START - process_age_s()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # Every build and kernel cache at a fixed path inside the checkout.
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.dirname(HERE))
    import harness
    import torch

    import blance_tpu_torch  # noqa: F401  the program; without it, no run

    w = harness.workload(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(w["chips"]):
        print(f"{args.workload} needs {w['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result, lines = harness.run_cell(args.workload, args.seed, args.seconds,
                                     bool(args.trace), device="cuda",
                                     t_start=t_start)
    banned = harness.banned_modules()
    if banned:
        print(f"loaded in this process: {banned}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
