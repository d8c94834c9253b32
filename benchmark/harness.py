"""One run of one cell: set-up, warm-up, the measured window, the check.

``run_cell`` is the whole run behind ``run.py``; the tests call it on
the CPU with a small configuration.  Everything a cell is made of is
found by name: the workload in ``BENCHMARK.json``, its configuration
(``configs/<config>.json``), its traffic (``traffic/<traffic>.json``),
the entry the traffic drives (``entries/<entry>.py``), the limits of its
check (``limits/<workload>.json``) and each metric's reader
(``metrics/<metric>.py``).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
import traceback

import deploy
import reference

HERE = deploy.HERE
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "blance_tpu")


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder, imported by path
    (a name may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"_bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(name: str, bench: dict = None) -> dict:
    bench = bench or spec()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: str, group: str) -> list:
    """The metrics of ``group`` ("end_to_end" or "per_layer") the cell
    reports."""
    return [m for m in bench[group]
            if cell in m.get("workloads", [cell])]


def banned_modules() -> list:
    """Modules of JAX or of the JAX package loaded in this process, by
    whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()


@dataclasses.dataclass
class Run:
    """What one run measured and read: the metric readers' input."""

    setup_s: float = 0.0
    window_s: float = 0.0
    requests: int = 0
    failed: int = 0
    placed: int = 0
    spans: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    trace: object = None  # tracing.Timeline of a traced run


def judge_run(entry, log: list, dep: deploy.Deployment, chain,
              limits: dict) -> tuple:
    """Judge every request of the window with the reference: returns
    (checks {name: [value, limit]}, total copies placed, each request's
    balance_cv)."""
    racks = dep.racks()
    worst = {"violations": 0, "moves_mismatch": 0, "balance_cv": 0.0,
             "churn": 0.0}
    total_placed, balance = 0, []
    for k, prev_rec, out_rec in log:
        prev, _ = entry.rows(prev_rec)
        nxt, bad = entry.rows(out_rec)
        got = reference.judge(prev, nxt, chain.out(k), racks, dep.cols,
                              dep.apart)
        total_placed += got["placed"]
        balance.append(got["balance_cv"])
        worst["violations"] += got["violations"] + bad
        worst["balance_cv"] = max(worst["balance_cv"], got["balance_cv"])
        worst["churn"] = max(worst["churn"], got["churn"])
        steps = entry.steps(out_rec)
        if steps is not None:
            worst["moves_mismatch"] += reference.moves_mismatch(
                dep.states, dep.cols, prev, nxt, steps)
    if not entry.has_moves:
        del worst["moves_mismatch"]
    return ({k: [v, limits[k]] for k, v in worst.items()}, total_placed,
            balance)


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", cfg: dict = None, control: str = None,
             t_start: float = None, limits: dict = None,
             w: dict = None) -> tuple:
    """One run of ``cell``; returns (result dict, check lines).

    ``cfg`` and ``limits`` replace the cell's configuration and the
    limits of its check (the tests' small sizes), ``w`` the cell's entry
    in BENCHMARK.json (a mix that no cell uses yet);
    ``control`` puts the reference's plain planner in the program's
    place, breaking the named guarantee (see entries/control.py)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = spec()
    w = w or workload(cell, bench)
    cfg = cfg or deploy.load_json("configs", w["config"])
    traffic = deploy.load_json("traffic", w["traffic"])
    if limits is None:
        with open(os.path.join(HERE, "limits", f"{cell}.json")) as f:
            limits = json.load(f)
    if traffic["clients"] != 1 or not traffic["chained"]:
        raise ValueError("the harness drives one client in a chained loop")
    dep, start, chain = deploy.build(cfg, traffic, seed)
    if control:
        entry = load_module("entries", "control").Entry(
            dep, cfg, traffic, start, chain, control)
    else:
        entry = load_module("entries", traffic["entry"]).Entry(
            dep, cfg, traffic, start, chain, device)
    run = Run()

    prev = entry.initial()
    k = 0
    for _ in range(int(traffic["warmup_requests"])):
        prev = entry.request(k, prev)
        k += 1
    sync(device)
    prev_rec = entry.record(prev)
    gc.collect()  # every run opens its window from the same heap state
    run.setup_s = time.perf_counter() - t_start

    # The window is the requests' own time, back to back: between two
    # requests the client reads the answer into arrays for the check
    # (entry.record) and lets the program's map go, as a cluster manager
    # keeps only its current map; that bookkeeping is not timed.
    log, spans, out = [], [], None
    tracer = None
    if trace:
        import tracing

        tracer = tracing.Tracer(device)
        tracer.start()
    while run.window_s < seconds:
        chain.out(k)  # the request's node lists, drawn before its clock
        t0 = time.perf_counter()
        try:
            out = entry.request(k, prev)
            sync(device)
        except Exception:  # a request that fails counts in ``failed``
            traceback.print_exc(file=sys.stderr)
            out = None
            run.failed += 1
        t1 = time.perf_counter()
        spans.append((t0, t1))
        run.window_s += t1 - t0
        if out is not None:
            rec = entry.record(out)
            log.append((k, prev_rec, rec))
            prev, prev_rec = out, rec
            run.requests += 1
        k += 1
    del prev, out
    if tracer is not None:
        run.trace = tracer.stop(spans)
        run.spans, run.counters = tracer.recorded()

    peak = 0
    if device.startswith("cuda"):
        import torch

        peak = int(torch.cuda.max_memory_allocated())
    entry.close()
    checks, run.placed, balance = judge_run(entry, log, dep, chain,
                                            limits)
    checks["failed_requests"] = [run.failed, 0]
    correct = all(v <= lim for v, lim in checks.values()) and \
        run.requests > 0

    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(bench, cell, group):
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": device_name(device), "count": int(w["chips"]),
           "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": run.requests
              + run.failed, "failed": run.failed, "metrics": metrics,
              "device": dev}
    if trace:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    times = sorted(b - a for a, b in spans)
    lines = [f"request seconds: {len(times)} requests, min {times[0]:.4f}, "
             f"median {times[len(times) // 2]:.4f}, max {times[-1]:.4f}"]
    lines += [f"check {name}: {v} (limit {lim})"
              for name, (v, lim) in checks.items()]
    if balance:
        lines.insert(1, f"balance_cv by request: first {balance[0]:.5f}, "
                        f"last {balance[-1]:.5f}, max {max(balance):.5f}")
    return result, lines


def device_name(device: str) -> str:
    if device.startswith("cuda"):
        import torch

        return torch.cuda.get_device_name(0)
    return "cpu"
