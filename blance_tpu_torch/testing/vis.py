# Port of blance_tpu/testing/vis.py: contract mode keys on the port's
# batched backend "cuda", and run_vis_cases takes ``device``.
"""Visual placement DSL for golden planner tests.

Reimplements the reference's ASCII test harness (the Go reference's
plan_test.go:1611-1744): each partition is one row; columns
are nodes "a", "b", "c", ...; cell tokens name the state the node holds —
"m" = primary, "s" = replica — optionally followed by a replica ordinal when
``cell_length=2`` ("m0", "s0", "s1"), in which case node order within a state
follows the ordinal.  This is what keeps thousands of lines of placement
expectations readable, and it only works because the planner is fully
deterministic (stable sorts, node-position tie-breaks, sorted hierarchy
children).

Example row pair (from "m s" to "sm "): partition moved its primary from
node a to node b and grew a replica on a.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from ..convert import resolve_device
from ..core.types import (
    HierarchyRules,
    Partition,
    PartitionMap,
    PartitionModel,
    PlanOptions,
)
from ..plan.api import plan_next_map

__all__ = ["VisCase", "parse_vis_row", "vis_maps", "run_vis_cases",
           "format_vis_map", "assert_contract"]

_STATE_NAMES = {"m": "primary", "s": "replica"}


def _node_name(i: int) -> str:
    return chr(ord("a") + i)


def parse_vis_row(row: str, cell_length: int) -> dict[str, list[str]]:
    """One ASCII row -> nodes_by_state.

    Cells are read per node column, then sorted by cell text so replica
    ordinals ("s0" < "s1") define list order (plan_test.go:1677-1692).
    """
    cells: list[tuple[str, str]] = []
    for j in range(0, len(row), cell_length):
        cells.append((row[j : j + cell_length], _node_name(j // cell_length)))
    cells.sort(key=lambda c: c[0])
    nbs: dict[str, list[str]] = {}
    for entry, node in cells:
        state = _STATE_NAMES.get(entry[0:1])
        if state:
            nbs.setdefault(state, []).append(node)
    return nbs


def format_vis_map(
    pmap: PartitionMap, nodes: list[str], cell_length: int = 1
) -> list[str]:
    """Inverse of parse_vis_row, for readable test failure output."""
    state_letter = {v: k for k, v in _STATE_NAMES.items()}
    rows = []
    for pname in sorted(pmap):
        p = pmap[pname]
        cells = {n: " " * cell_length for n in nodes}
        for state, snodes in p.nodes_by_state.items():
            for ordinal, node in enumerate(snodes):
                letter = state_letter.get(state, "?")
                cell = letter if cell_length == 1 else f"{letter}{ordinal}"
                cells[node] = cell
        rows.append("".join(cells[n] for n in nodes))
    return rows


@dataclass
class VisCase:
    """One golden scenario (plan_test.go:1611-1627)."""

    about: str
    from_to: list[tuple[str, str]]
    nodes: list[str]
    model: PartitionModel
    nodes_to_remove: list[str] = field(default_factory=list)
    nodes_to_add: list[str] = field(default_factory=list)
    from_to_priority: bool = False
    model_state_constraints: Optional[dict[str, int]] = None
    partition_weights: Optional[dict[str, int]] = None
    state_stickiness: Optional[dict[str, int]] = None
    node_weights: Optional[dict[str, int]] = None
    node_hierarchy: Optional[dict[str, str]] = None
    hierarchy_rules: Optional[HierarchyRules] = None
    exp_num_warnings: int = 0  # partitions-with-warnings count
    ignore: bool = False
    backend: str = "greedy"


def vis_maps(case: VisCase) -> tuple[PartitionMap, PartitionMap]:
    """Build (prev_map, expected_map) from the from/to rows."""
    cell_length = 2 if case.from_to_priority else 1
    prev_map: PartitionMap = {}
    exp_map: PartitionMap = {}
    for i, (frm, to) in enumerate(case.from_to):
        pname = f"{i:03d}"
        prev_map[pname] = Partition(pname, parse_vis_row(frm, cell_length))
        exp_map[pname] = Partition(pname, parse_vis_row(to, cell_length))
    return prev_map, exp_map


def _weighted_state_spread(
    pmap: PartitionMap, model: PartitionModel, nodes: list[str],
    node_weights: Optional[dict[str, int]],
    partition_weights: Optional[dict[str, int]],
) -> dict[str, float]:
    """Per state: max-min of partition-weighted load / node weight over
    ``nodes`` — the quantity the planners balance (plan.go:94)."""
    nw = node_weights or {}
    pw = partition_weights or {}
    out: dict[str, float] = {}
    for st in model:
        loads = {n: 0.0 for n in nodes}
        for pname, p in pmap.items():
            w = pw.get(pname, 1)
            for n in p.nodes_by_state.get(st, []):
                if n in loads:
                    loads[n] += w
        vals = [loads[n] / max(nw.get(n, 1), 1) for n in nodes]
        out[st] = max(vals) - min(vals) if vals else 0.0
    return out


def assert_contract(
    label: str,
    prev_map: PartitionMap,
    partitions_to_assign: PartitionMap,
    exp_map: PartitionMap,
    result: PartitionMap,
    nodes: list[str],
    nodes_to_remove: list[str],
    model: PartitionModel,
    opts: PlanOptions,
) -> None:
    """Contract-mode assertions for the batched (cuda) backend: the solver
    is deliberately not bit-identical to the sequential greedy (it solves
    globally), so the golden corpus asserts the properties that matter
    instead of the exact map: ZERO audit violations (duplicates, removed
    nodes, unfilled feasible slots, feasible-tier hierarchy misses) and
    per-state weighted balance within the golden oracle's spread + 1."""
    import numpy as np

    from ..core.encode import encode_problem
    from ..plan.audit import check_assignment

    problem = encode_problem(prev_map, partitions_to_assign, nodes,
                             nodes_to_remove, model, opts)
    r_max = max([problem.R, 1] + [
        len(ns) for p in result.values()
        for ns in p.nodes_by_state.values()])
    assign = np.full((problem.P, problem.S, r_max), -1, np.int32)
    nidx = {n: j for j, n in enumerate(problem.nodes)}
    sidx = {s: j for j, s in enumerate(problem.states)}
    for pi, pname in enumerate(problem.partitions):
        assert pname in result, (
            f"{label}: planner result is missing partition {pname!r} "
            f"(has {len(result)} of {len(problem.partitions)})")
        for s, ns in result[pname].nodes_by_state.items():
            if s not in sidx:
                continue  # unmodeled passthrough states aren't audited
            for ri, node in enumerate(ns):
                assign[pi, sidx[s], ri] = nidx[node]
    counts = check_assignment(problem, assign)
    assert not any(counts.values()), (
        f"{label}: cuda contract violations {counts}:\n"
        + "\n".join(format_vis_map(result, nodes)))

    survivors = [n for n in nodes if n not in (nodes_to_remove or [])]
    sp_got = _weighted_state_spread(
        result, model, survivors, opts.node_weights, opts.partition_weights)
    sp_exp = _weighted_state_spread(
        exp_map, model, survivors, opts.node_weights, opts.partition_weights)
    # Slack: placements are integral in partition-weight units (a single
    # differently-placed copy moves the spread by its weight) plus one
    # unit for the auction's first-bidder progress overshoot.
    wmax = max((opts.partition_weights or {}).values(), default=1)
    for st in model:
        assert sp_got[st] <= sp_exp[st] + wmax + 1, (
            f"{label}: state {st} spread {sp_got[st]} "
            f"vs golden oracle {sp_exp[st]} (+{wmax}+1):\n"
            + "\n".join(format_vis_map(result, nodes)))


def run_vis_cases(cases: list[VisCase], backend: Optional[str] = None,
                  device: Any = "cuda") -> None:
    """Plan each case and assert expectations.

    ``backend`` overrides every case's backend; ``device`` is where the
    "cuda" backend solves.  The exact planners
    (greedy / native) assert the golden map bit-for-bit; the batched
    "cuda" backend asserts CONTRACT properties instead (assert_contract)
    plus the same warnings-count equality — the reference's curated hard
    cases (plan_test.go:1746-2863) pointed at the solver that is not
    meant to be bit-identical."""
    resolve_device(device, "run_vis_cases")
    for i, case in enumerate(cases):
        if case.ignore:
            continue
        prev_map, exp_map = vis_maps(case)
        opts = PlanOptions(
            model_state_constraints=case.model_state_constraints,
            partition_weights=case.partition_weights,
            state_stickiness=case.state_stickiness,
            node_weights=case.node_weights,
            node_hierarchy=case.node_hierarchy,
            hierarchy_rules=case.hierarchy_rules,
        )
        resolved = backend or case.backend
        result, warnings = plan_next_map(
            prev_map,
            prev_map,
            case.nodes,
            case.nodes_to_remove,
            case.nodes_to_add,
            case.model,
            opts,
            backend=resolved,
            device=device,
        )
        cell_length = 2 if case.from_to_priority else 1
        if resolved == "cuda":
            assert_contract(
                f"case {i} ({case.about})", prev_map, prev_map, exp_map,
                result, case.nodes, case.nodes_to_remove, case.model, opts)
        else:
            got = {name: p.nodes_by_state for name, p in result.items()}
            exp = {name: p.nodes_by_state for name, p in exp_map.items()}
            assert got == exp, (
                f"case {i} ({case.about}):\n"
                f"got:\n"
                + "\n".join(format_vis_map(result, case.nodes, cell_length))
                + "\nexpected:\n"
                + "\n".join(format_vis_map(exp_map, case.nodes, cell_length))
            )
        assert len(warnings) == case.exp_num_warnings, (
            f"case {i} ({case.about}): warnings {warnings} "
            f"expected {case.exp_num_warnings} partitions-with-warnings"
        )
