"""Puts the benchmark's folder and the checkout's root on sys.path, as
run.py does, and gives the tests' small sizes."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

# Large enough that ``backend="auto"`` routes to the card's solver
# (P * N >= 256 * 1024), which runs its plain versions on the CPU.
SMALL = {"partitions": 2048, "nodes": 128}
# The small sizes' own limits: with 5 racks of 25 and one of 3 the
# rack rule leaves the planner less room, and with 128 nodes a node's
# share is a few copies, so one copy is a large share of it.
SMALL_LIMITS = {"violations": 0, "moves_mismatch": 0, "balance_cv": 0.09,
                "churn": 3.0}
SEED = 2**31 + 977

# The mixes the harness carries that no cell of BENCHMARK.json runs yet:
# they wait for the program's balance (PERF.md, Open questions).
PENDING = [
    {"name": "delta32k.pipeline", "config": "delta_32k_10k",
     "traffic": "pipeline", "chips": 1},
    {"name": "northstar.swap", "config": "northstar_100k_10k",
     "traffic": "swap", "chips": 1},
]


def mixes() -> dict:
    """Every mix by name: the cells of BENCHMARK.json, then PENDING."""
    import harness

    out = {w["name"]: w for w in harness.spec()["workloads"]}
    for w in PENDING:
        out.setdefault(w["name"], w)
    return out


def small_cfg(cell: str) -> dict:
    import deploy

    cfg = deploy.load_json("configs", mixes()[cell]["config"])
    cfg.update(SMALL)
    return cfg
