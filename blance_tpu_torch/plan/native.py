# Copied from blance_tpu/plan/native.py.  The library builds from the
# port's copy of the C++ core (blance_tpu_torch/native/planner.cpp) into
# blance_tpu_torch/plan/_native_build/_blance_torch_planner.so, so both
# packages' libraries can load in one process; the marker and the
# fallbacks are the reference's.
"""Native (C++) exact greedy backend — ctypes bindings + encode/decode.

Drives native/planner.cpp: the same algorithm as plan/greedy.py (and the
reference's plan.go:60-331) with the hot loop in C++ over dense ids.  The
results are bit-identical to the Python greedy planner — validated by
running the full golden test suites against this backend — at roughly
two orders of magnitude higher throughput, which makes it the honest CPU
baseline for the TPU solver.

Python owns: interning, the static partition sort key, count seeding, the
convergence loop, and warning synthesis.  C++ owns the per-state scoring
loop (including the per-state visit-order rebuild, which depends on
mutating assignments).

Falls back to the Python greedy transparently when a feature the native
core doesn't model is in play: custom node_scorer hooks, non-cbgt score
boosters, or partitions carrying states outside the model.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from ..core.encode import NPArray
from ..core.hierarchy import find_ancestor, parents_to_children
from ..core.order import sort_state_names, sorted_by_partition_name
from ..utils.nativebuild import compile_cached
from ..core.setops import strings_intersect, strings_remove
from ..core.types import Partition, PartitionMap, PartitionModel, PlanOptions
from .greedy import (
    _partition_name_key,
    _partition_weight_key,
    count_state_nodes,
    plan_next_map_greedy,
)

__all__ = ["plan_next_map_native", "cbgt_node_score_booster", "native_available"]


def cbgt_node_score_booster(weight: int, stickiness: float) -> float:
    """The booster couchbase/cbgt installs (control_test.go:19-29); the
    native core implements exactly this form."""
    return max(float(-weight), stickiness)


# Any booster marked native-compatible (this attribute) maps onto the C++
# max(-w, stickiness) implementation.
cbgt_node_score_booster.__blance_native__ = "cbgt"

_LIB: Optional[ctypes.CDLL] = None
_LIB_FAILED = False


def _build_dir() -> str:
    return os.path.join(os.path.dirname(__file__), "_native_build")


def _source_path() -> str:
    """The port's own copy of the C++ core (blance_tpu_torch/native)."""
    return os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "native", "planner.cpp")


def _load_lib() -> Optional[ctypes.CDLL]:
    """Compile (if stale) and load the native planner; None if unavailable."""
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    src = _source_path()
    so = os.path.join(_build_dir(), "_blance_torch_planner.so")
    if not compile_cached(src, so, ["g++", "-O3", "-shared", "-fPIC",
                                    "-std=c++17", "-o", so, src]):
        _LIB_FAILED = True
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        _LIB_FAILED = True
        return None

    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.blance_plan_inner.restype = None
    lib.blance_plan_inner.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32,
        i32p, i32p, f64p, f64p, u8p, u8p, f64p,
        ctypes.c_int32, i32p, u8p, i32p, i32p, i32p,
        ctypes.c_uint8, ctypes.c_uint8,
        i32p, u8p, u8p, ctypes.c_uint8,
        i32p, f64p, i32p,
    ]
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return _load_lib() is not None


def _native_supported(
    partitions_to_assign: PartitionMap, model: PartitionModel, opts: PlanOptions
) -> bool:
    if opts.node_scorer is not None or opts.node_sorter is not None:
        return False
    booster = opts.node_score_booster
    if booster is not None and getattr(booster, "__blance_native__", None) != "cbgt":
        return False
    for p in partitions_to_assign.values():
        for s in p.nodes_by_state:
            if s not in model:
                return False  # unmodeled states need the Python data model
    return True


def _ptr(arr: NPArray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _plan_inner_native(
    lib: ctypes.CDLL,
    prev_map: PartitionMap,
    partitions_to_assign: PartitionMap,
    nodes_all: list[str],
    nodes_to_remove: list[str],
    nodes_to_add: Optional[list[str]],
    model: PartitionModel,
    opts: PlanOptions,
) -> tuple[PartitionMap, dict[str, list[str]]]:
    """One inner pass through the C++ core (greedy._plan_next_map_inner)."""
    nodes = list(nodes_all)
    node_index = {n: i for i, n in enumerate(nodes)}
    # Ghost nodes: partitions may reference nodes outside nodes_all (a dead
    # node the caller dropped from the cluster list without removing it).
    # The greedy planner keeps them in rows and accounting — it only ever
    # *candidates* from nodes_all — so intern them as non-candidate ids.
    for pmap in (partitions_to_assign, prev_map):
        for partition in pmap.values():
            for ns in partition.nodes_by_state.values():
                for node in ns:
                    if node not in node_index:
                        node_index[node] = len(nodes)
                        nodes.append(node)
    n_candidates = len(nodes_all)
    states = sort_state_names(model)
    state_index = {s: i for i, s in enumerate(states)}
    partitions = sorted_by_partition_name(partitions_to_assign.keys())
    P, S, N = len(partitions), len(states), len(nodes)

    constraints = np.zeros(max(S, 1), np.int32)
    priority = np.zeros(max(S, 1), np.int32)
    for s, st in model.items():
        c = st.constraints
        if opts.model_state_constraints is not None:
            c = opts.model_state_constraints.get(s, c)
        constraints[state_index[s]] = c
        priority[state_index[s]] = st.priority

    if P == 0 or S == 0 or int(constraints.max(initial=0)) <= 0:
        # Nothing to assign: the greedy path handles the strip-only result.
        return plan_next_map_greedy(
            prev_map, partitions_to_assign, nodes_all,
            nodes_to_remove, nodes_to_add, model,
            _single_pass_opts(opts))

    removed = set(nodes_to_remove)

    r_max = int(constraints.max())
    present_states: list[set[str]] = []
    for pname in partitions:
        src = partitions_to_assign[pname]
        present_states.append(set(src.nodes_by_state.keys()))
        for s, ns in src.nodes_by_state.items():
            r_max = max(r_max, len(ns))

    assign = np.full((P, S, r_max), -1, np.int32)
    for pi, pname in enumerate(partitions):
        src = partitions_to_assign[pname]
        for s, ns in src.nodes_by_state.items():
            si = state_index[s]
            ri = 0
            for node in ns:
                if node in removed:
                    continue  # strip removed nodes (plan.go:84-88)
                if ri < r_max:
                    assign[pi, si, ri] = node_index[node]
                    ri += 1

    pweights = np.ones(P, np.float64)
    if opts.partition_weights:
        for pi, pname in enumerate(partitions):
            pweights[pi] = opts.partition_weights.get(pname, 1)

    nweights = np.ones(N, np.float64)
    nweight_set = np.zeros(N, np.uint8)
    if opts.node_weights:
        for ni, n in enumerate(nodes):
            if n in opts.node_weights:
                nweights[ni] = opts.node_weights[n]
                nweight_set[ni] = 1

    # Candidate mask: only nodes_all members that are not being removed are
    # ever newly chosen (nodesNext, plan.go:77); ghosts are row-only.
    valid = np.zeros(N, np.uint8)
    for ni, n in enumerate(nodes):
        if ni < n_candidates and n not in removed:
            valid[ni] = 1

    # Stickiness per (p, s) with the reference's resolution order
    # (plan.go:104-115 incl. the partition_weights gate).
    stickiness = np.full((P, S), 1.5, np.float64)
    pw, ss = opts.partition_weights, opts.state_stickiness
    ss_active = ss is not None and (
        pw is not None or opts.state_stickiness_standalone)
    for pi, pname in enumerate(partitions):
        if pw is not None and pname in pw:
            stickiness[pi, :] = float(pw[pname])
        elif ss_active:
            for si, s in enumerate(states):
                if s in ss:
                    stickiness[pi, si] = float(ss[s])

    # Hierarchy: globally interned ancestor ids per level, deep enough to
    # cover the whole tree (chain membership handles non-uniform depth).
    parents = opts.node_hierarchy or {}
    depth = 0
    for n in nodes:
        d, cur, seen = 0, n, set()
        while cur in parents and cur not in seen:
            seen.add(cur)
            cur = parents[cur]
            d += 1
        depth = max(depth, d)
    levels = depth + 1
    interned: dict[str, int] = {}

    def intern_anc(name: str) -> int:
        if name == "":
            return -1
        if name not in interned:
            interned[name] = len(interned)
        return interned[name]

    aid = np.full((levels, max(N, 1)), -1, np.int32)
    for level in range(levels):
        for ni, n in enumerate(nodes):
            aid[level, ni] = intern_anc(find_ancestor(n, parents, level))

    # find_leaves returns LEAVES only (plan.go:764-774): a listed node that
    # is itself a parent in the hierarchy can never be a hierarchy pick.
    children = parents_to_children(parents)
    is_leaf = np.ones(max(N, 1), np.uint8)
    for ni, n in enumerate(nodes):
        if children.get(n):
            is_leaf[ni] = 0

    rule_off = np.zeros(S + 1, np.int32)
    rule_inc: list[int] = []
    rule_exc: list[int] = []
    has_hierarchy = opts.hierarchy_rules is not None
    if has_hierarchy:
        for si, s in enumerate(states):
            for rule in (opts.hierarchy_rules or {}).get(s, []):
                rule_inc.append(rule.include_level)
                rule_exc.append(rule.exclude_level)
            rule_off[si + 1] = len(rule_inc)
    rule_inc_a = np.asarray(rule_inc or [0], np.int32)
    rule_exc_a = np.asarray(rule_exc or [0], np.int32)

    # Static partition rank: (heavier first, zero-padded-numeric name, name).
    def static_key(pname: str):
        w = 1
        if opts.partition_weights is not None:
            w = opts.partition_weights.get(pname, 1)
        return (_partition_weight_key(w), _partition_name_key(pname), pname)

    rank_order = sorted(range(P), key=lambda pi: static_key(partitions[pi]))
    static_rank = np.zeros(P, np.int32)
    for r, pi in enumerate(rank_order):
        static_rank[pi] = r

    # Category-0 flags: prev holders of state s on removed nodes
    # (plan.go:541-550).
    cat0 = np.zeros((S, P), np.uint8)
    if nodes_to_remove:
        for pi, pname in enumerate(partitions):
            last = prev_map.get(pname)
            if last is None:
                continue
            for si, s in enumerate(states):
                lpnbs = last.nodes_by_state.get(s)
                if lpnbs and strings_intersect(lpnbs, nodes_to_remove):
                    cat0[si, pi] = 1

    add_mask = np.zeros(max(N, 1), np.uint8)
    has_adds = nodes_to_add is not None
    if nodes_to_add:
        for n in nodes_to_add:
            ni = node_index.get(n)
            if ni is not None:
                add_mask[ni] = 1

    # Seed counts from prev_map (plan.go:94).
    counts = np.zeros((S, max(N, 1)), np.float64)
    for s, per_node in count_state_nodes(prev_map, opts.partition_weights).items():
        si = state_index.get(s)
        if si is None:
            continue
        for node, cnt in per_node.items():
            ni = node_index.get(node)
            if ni is not None:
                counts[si, ni] = cnt

    shortfall = np.zeros((P, S), np.int32)

    lib.blance_plan_inner(
        P, N, S, r_max, len(prev_map),
        _ptr(constraints, ctypes.c_int32), _ptr(priority, ctypes.c_int32),
        _ptr(pweights, ctypes.c_double), _ptr(nweights, ctypes.c_double),
        _ptr(nweight_set, ctypes.c_uint8), _ptr(valid, ctypes.c_uint8),
        _ptr(stickiness, ctypes.c_double),
        levels, _ptr(aid, ctypes.c_int32), _ptr(is_leaf, ctypes.c_uint8),
        _ptr(rule_off, ctypes.c_int32), _ptr(rule_inc_a, ctypes.c_int32),
        _ptr(rule_exc_a, ctypes.c_int32),
        1 if opts.node_score_booster is not None else 0,
        1 if has_hierarchy else 0,
        _ptr(static_rank, ctypes.c_int32), _ptr(cat0, ctypes.c_uint8),
        _ptr(add_mask, ctypes.c_uint8), 1 if has_adds else 0,
        _ptr(assign, ctypes.c_int32), _ptr(counts, ctypes.c_double),
        _ptr(shortfall, ctypes.c_int32),
    )

    # Decode: original state keys survive; assigned states always present.
    next_map: PartitionMap = {}
    warnings: dict[str, list[str]] = {}
    for pi, pname in enumerate(partitions):
        nbs: dict[str, list[str]] = {}
        for si, s in enumerate(states):
            assigned = int(constraints[si]) > 0
            if not assigned and s not in present_states[pi]:
                continue
            nbs[s] = [nodes[i] for i in assign[pi, si] if i >= 0]
            if shortfall[pi, si] > 0:
                warnings.setdefault(pname, []).append(
                    "could not meet constraints: %d, stateName: %s,"
                    " partitionName: %s" % (int(constraints[si]), s, pname))
        next_map[pname] = Partition(pname, nbs)
    return next_map, warnings


def _single_pass_opts(opts: PlanOptions) -> PlanOptions:
    import dataclasses
    return dataclasses.replace(opts, max_iterations=1)


def plan_next_map_native(
    prev_map: PartitionMap,
    partitions_to_assign: PartitionMap,
    nodes_all: list[str],
    nodes_to_remove: Optional[list[str]],
    nodes_to_add: Optional[list[str]],
    model: PartitionModel,
    opts: Optional[PlanOptions] = None,
) -> tuple[PartitionMap, dict[str, list[str]]]:
    """Native-backed plan_next_map: bit-identical to the greedy backend.

    Runs the same convergence loop (plan.go:23-58) with each inner pass in
    C++.  Transparently falls back to the Python greedy when the native
    core can't model the request (custom hooks, unmodeled states) or the
    toolchain is unavailable.
    """
    opts = opts or PlanOptions()
    lib = _load_lib()
    if lib is None or not _native_supported(partitions_to_assign, model, opts):
        return plan_next_map_greedy(
            prev_map, partitions_to_assign, nodes_all,
            nodes_to_remove, nodes_to_add, model, opts)

    from ..core.types import copy_partition_map

    prev_map = copy_partition_map(prev_map)
    partitions_to_assign = copy_partition_map(partitions_to_assign)
    nodes_all = list(nodes_all)
    nodes_to_remove = list(nodes_to_remove) if nodes_to_remove is not None else []
    nta: Optional[list[str]] = (
        list(nodes_to_add) if nodes_to_add is not None else None)

    next_map: PartitionMap = {}
    warnings: dict[str, list[str]] = {}
    for _ in range(max(1, opts.max_iterations)):
        next_map, warnings = _plan_inner_native(
            lib, prev_map, partitions_to_assign, nodes_all,
            nodes_to_remove, nta, model, opts)
        if all(
            prev_map.get(p.name) is not None
            and p.nodes_by_state == prev_map[p.name].nodes_by_state
            for p in next_map.values()
        ):
            break
        for p in next_map.values():
            prev_map[p.name] = p
            partitions_to_assign[p.name] = p
        nodes_all = strings_remove(nodes_all, nodes_to_remove)
        nodes_to_remove = []
        nta = []
    return next_map, warnings
