# Port of blance_tpu/analysis/retrace.py: the same entry labels and
# workload, counted in builds.
"""Build budgets: the port's counterpart of the reference's retrace table.

The port compiles nothing per shape: what it builds are its kernel
libraries (``ops/_build.py``, nvcc) and host extensions
(``utils/nativebuild.py``), each once per process.  ``RETRACE_BUDGETS``
declares, for one canonical workload (cold solve, carry, warm repair,
bucketed plan, rank sweep, sparse cold and warm, fleet cold and warm,
pipeline cold and warm, the sharded solve and pipeline on a 2-rank
mesh), the most builds each owning entry point may
trigger, counted by :class:`blance_tpu_torch.obs.device.CompileMonitor`
under the dispatch sites' :func:`~blance_tpu_torch.obs.device.entry`
attribution.  The workload dispatches each entry 4 times at one shape,
and the contract is that calls 2 to 4 add ZERO builds: a build per call
(a library cache key that stopped matching, a reload per dispatch)
fails with the entry named.

Rules: DEV001 an entry over its budget, DEV002 an entry that built but
has no budget, DEV003 an entry whose calls 2-4 built again.

Budgets are the counts of the workload run in a cold process (nothing
built or loaded yet); a warm process counts 0 everywhere.  Recalibrate
with ``python -m blance_tpu_torch.obs.device_check --check`` in a fresh
process on the card (and with ``--device cpu``), which prints the
per-entry counts, then update the table.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Callable, Optional

if TYPE_CHECKING:  # annotation-only
    from . import Finding

__all__ = ["RETRACE_BUDGETS", "run_retrace_check"]

# Per-entry build budgets for run_retrace_check()'s workload, each the
# count measured in a cold process: on the card (NVIDIA H100 80GB HBM3),
# ``python3 chip_smoke.py`` runs ``python -m
# blance_tpu_torch.obs.device_check --check`` in a process of its own and
# prints its counts in the ``obs`` line (``device_check.builds``):
# solve_dense.cold 1 (its matrix engine loads libmin2), sparse.cold 1
# (libsparse_min2), other 1 (the encode's marshal extension), every other
# entry 0.  On the CPU (``--device cpu``) other 1, every other entry 0:
# the plain versions load nothing.  Each budget is the larger of the two,
# with no headroom: an entry that starts to load a library it did not
# (another engine, a new extension) is DEV001, and a build per call is
# DEV003 at call 2.
RETRACE_BUDGETS: dict[str, int] = {
    "solve_dense.cold": 1,
    "solve_dense.carry": 0,
    "solve_dense.warm": 0,
    "solve_dense.bucketed": 0,
    "sparse.cold": 1,
    "sparse.warm": 0,
    "sched.ranks": 0,
    "fleet.cold": 0,
    "fleet.warm": 0,
    "pipeline.cold": 0,
    "pipeline.warm": 0,
    # The sharded dispatches on a 2-rank mesh: rank 0 runs its share of
    # the body in this process after the solves above loaded every
    # library it calls, and the worker rank loads its own in its own
    # process, outside this monitor.
    "sharded.cold": 0,
    "sharded.pipeline": 0,
    # Builds outside any dispatch site: the encode's marshal extension.
    "other": 1,
}

_CALLS = 4  # dispatches per entry; calls 2..4 must build nothing


def _workload(device: Any,
              repeat: Callable[[str, Callable[[], Any]], Any]) -> None:
    """The canonical workload: every budgeted entry point dispatched
    ``_CALLS`` times at one shape through ``repeat(entry, call)``, which
    returns the first call's result.  Small shapes, deterministic (numpy
    from seeds)."""
    import numpy as np
    import torch

    from .. import Partition, model
    from ..convert import problem_to_torch
    from ..core.types import HierarchyRule, PlanOptions
    from ..orchestrate.sched.ranks import upward_ranks
    from ..plan.fleet import TenantProblem, solve_fleet
    from ..plan.session import PlannerSession
    from ..plan.tensor import (
        carry_from_assignment,
        plan_next_map_cuda,
        solve_dense_converged,
        solve_dense_warm,
        solve_sparse,
        solve_sparse_warm,
    )

    P, N, S, R = 48, 8, 2, 1
    rng = np.random.default_rng(7)
    prev = np.full((P, S, R), -1, np.int32)
    prev[:, 0, 0] = rng.integers(0, N, P)
    prev[:, 1, 0] = (prev[:, 0, 0] + 1 + rng.integers(0, N - 1, P)) % N
    pw = np.ones(P, np.float32)
    nw = np.ones(N, np.float32)
    valid = np.ones(N, bool)
    stick = np.full((P, S), 1.5, np.float32)
    gids = np.stack([np.arange(N, dtype=np.int32),
                     np.arange(N, dtype=np.int32) // 4,
                     np.zeros(N, np.int32)])
    gv = np.ones((3, N), bool)
    constraints = (1, 1)
    rules = ((), ((2, 1),))
    dev = problem_to_torch(prev, pw, nw, valid, stick, gids, gv,
                           device=device)
    dirty = np.zeros(P, bool)
    dirty[0] = True

    def on_dev(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    out = repeat("solve_dense.cold", lambda: solve_dense_converged(
        *dev, constraints, rules, record=False))

    # solve_dense.warm — a 1-partition delta repaired from a fresh carry
    # each call (the carry is single-use by contract).
    state = {"cur": out}

    def warm_call():
        cur = state["cur"]
        res, _next = solve_dense_warm(
            cur, *dev[1:], constraints, rules, dirty=dirty,
            carry=carry_from_assignment(cur, dev[1], dev[2]), record=False)
        if res is not None:
            state["cur"] = on_dev(res)

    repeat("solve_dense.warm", warm_call)
    cur = state["cur"]
    cfix = carry_from_assignment(cur, dev[1], dev[2])
    repeat("solve_dense.carry", lambda: solve_dense_converged(
        cur, *dev[1:], constraints, rules, record=False,
        carry_used=cfix.used))

    # solve_dense.bucketed — the plan entry with shape bucketing: two
    # cluster sizes inside one bucket.
    m = model(primary=(0, 1), replica=(1, 1))
    sizes = iter([17, 18] * _CALLS)

    def bucketed_call():
        n_real = next(sizes)
        nodes = [f"n{i:03d}" for i in range(n_real)]
        hier = {n: f"r{i // 4}" for i, n in enumerate(nodes)}
        hier.update({f"r{i}": "z0" for i in range((n_real + 3) // 4)})
        opts = PlanOptions(shape_bucketing=True, node_hierarchy=hier,
                           hierarchy_rules={"replica": [HierarchyRule(2, 1)]})
        pmap = {str(i): Partition(str(i), {
            "primary": [nodes[i % n_real]],
            "replica": [nodes[(i + 1) % n_real]]}) for i in range(24)}
        plan_next_map_cuda(pmap, pmap, nodes, [], [], m, opts,
                           device=device)

    repeat("solve_dense.bucketed", bucketed_call)

    # sched.ranks — the device rank sweep, forced past its threshold.
    chain_costs = [[0.5, 1.0, 0.25]] * 16 + [[2.0, 0.5]] * 16
    repeat("sched.ranks", lambda: upward_ranks(
        chain_costs, device_threshold=0, device=device))

    # sparse.cold + sparse.warm at one (shape, K).
    s_state = {"cur": repeat("sparse.cold", lambda: solve_sparse(
        *dev, constraints, rules, k=4, record=False))}

    def sparse_warm_call():
        cur = on_dev(s_state["cur"])
        res, _nc = solve_sparse_warm(
            cur, *dev[1:], constraints, rules, dirty=dirty,
            carry=carry_from_assignment(cur, dev[1], dev[2]), k=4,
            record=False)
        if res is not None:
            s_state["cur"] = res

    repeat("sparse.warm", sparse_warm_call)

    # fleet.cold + fleet.warm — one class, three tenants.
    def tenant(i, t_prev=None, carry=None, t_dirty=None):
        if t_prev is None:
            t_rng = np.random.default_rng(100 + i)
            t_prev = np.full((P, S, R), -1, np.int32)
            t_prev[:, 0, 0] = t_rng.integers(0, N, P)
            t_prev[:, 1, 0] = (t_prev[:, 0, 0] + 1
                               + t_rng.integers(0, N - 1, P)) % N
        return TenantProblem(
            key=f"t{i}", prev=t_prev, partition_weights=pw,
            node_weights=nw, valid_node=valid, stickiness=stick,
            gids=gids, gid_valid=gv, constraints=constraints,
            rules=rules, carry=carry, dirty=t_dirty)

    cold = [tenant(i) for i in range(3)]
    f_state = {"res": repeat("fleet.cold", lambda: solve_fleet(
        cold, record=False, device=device))}

    def fleet_warm_call():
        warm = [tenant(i, r.assign, r.carry, dirty)
                for i, r in enumerate(f_state["res"])]
        f_state["res"] = solve_fleet(warm, record=False, device=device)

    repeat("fleet.warm", fleet_warm_call)

    # pipeline.cold + pipeline.warm — the fused pipeline through the
    # session fast path: each new session's first replan is cold, then
    # one session's delta cycles ride the carry.
    s_nodes = [f"n{i:03d}" for i in range(N)]
    names = [str(i) for i in range(P)]

    def new_session():
        return PlannerSession(m, s_nodes, names, opts=PlanOptions(),
                              device=device)

    repeat("pipeline.cold", lambda: new_session().replan_with_moves())
    sess = new_session()
    sess.replan_with_moves()
    sess.apply()
    gone = iter(s_nodes)

    def pipeline_warm_call():
        sess.remove_nodes([next(gone)])
        sess.replan_with_moves()
        sess.apply()

    repeat("pipeline.warm", pipeline_warm_call)

    # sharded.cold / sharded.pipeline — a 2-rank mesh on ``device``.
    from ..parallel.sharded import (make_mesh, solve_dense_sharded,
                                    solve_pipeline_sharded)

    with make_mesh(2, device=device) as mesh:
        repeat("sharded.cold", lambda: solve_dense_sharded(
            mesh, prev, pw, nw, valid, stick, gids, gv, constraints, rules))
        repeat("sharded.pipeline", lambda: solve_pipeline_sharded(
            mesh, prev, pw, nw, valid, stick, gids, gv, constraints, rules))


def run_retrace_check(device: Any = "cuda",
                      counts: Optional[dict] = None
                      ) -> tuple[list["Finding"], int]:
    """Run the workload on ``device`` (the card unless the caller asks
    for the CPU; raises without a card) under a counting monitor; one
    Finding per entry over budget (DEV001), built-but-unbudgeted
    (DEV002) or built again on a repeated call (DEV003).  ``counts``,
    when given, receives the monitor's summary and the builds each
    entry's calls 2-4 added.  Returns (findings, table size)."""
    from ..convert import resolve_device
    from ..obs.device import CompileMonitor
    from . import Finding

    device = resolve_device(device, "run_retrace_check")

    repeat_added: dict[str, int] = {}

    with CompileMonitor(emit=False) as mon:
        def repeat(ent: str, call: Callable[[], Any]) -> Any:
            result = call()
            first = mon.total
            for _ in range(_CALLS - 1):
                call()
            repeat_added[ent] = repeat_added.get(ent, 0) + \
                mon.total - first
            return result

        _workload(device, repeat)
    if counts is not None:
        counts.update(mon.summary(), repeated=dict(repeat_added))
    findings: list[Finding] = []
    path = "blance_tpu_torch/analysis/retrace.py"
    for ent, count in sorted(mon.by_entry.items()):
        budget = RETRACE_BUDGETS.get(ent)
        if budget is None:
            findings.append(Finding(
                rule="DEV002", path=path, line=1, symbol=ent,
                message=f"entry point {ent!r} built {count}x during the "
                        f"retrace workload but has no budget in "
                        f"RETRACE_BUDGETS — add one"))
        elif count > budget:
            findings.append(Finding(
                rule="DEV001", path=path, line=1, symbol=ent,
                message=f"entry point {ent!r} triggered {count} builds, "
                        f"over its budget of {budget} (per library: "
                        f"{dict(sorted(mon.by_fn.items()))})"))
    for ent, added in sorted(repeat_added.items()):
        if added:
            findings.append(Finding(
                rule="DEV003", path=path, line=1, symbol=ent,
                message=f"calls 2-{_CALLS} of entry point {ent!r} added "
                        f"{added} builds; a repeated dispatch must build "
                        f"nothing"))
    return findings, len(RETRACE_BUDGETS)
