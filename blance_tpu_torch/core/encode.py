# Copied from blance_tpu/core/encode.py (DenseProblem, encode_problem,
# decode_assignment with its native marshal branches and packed=/counts=,
# pack_slot_rows, the shape-bucketing helpers bucket_size, pad_to and
# pad_problem_arrays, and the fleet's stack_problem_arrays and
# strip_prev_rows).  The integer cores (pack_assignment_core,
# prev_from_entries_core) and their entry points are torch ports of the
# reference's jnp functions.
"""Dense encoding: PartitionMap <-> int32/float32 arrays.

The reference's data model is maps of strings (reference api.go:24-36); the
planner needs dense tensors.  This module interns node/partition/state
names to ids and packs the planning problem into numpy arrays, which the
solver moves onto the device:

- assign[P, S, R] : int32 node ids, -1 = empty slot (R = max slots seen).
- constraints[S]  : per-state target copy counts, priority-ordered.
- weights         : float32 partition/node weights.
- hierarchy       : per-level group ids per node (see
  core.hierarchy.level_group_ids) so include/exclude rules are integer
  compares, never N x N masks.

Partitions are ordered by the same zero-padded-numeric-else-raw name key the
planner sorts by, so dense ids match the greedy planner's deterministic
iteration order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..obs import get_recorder
from . import marshal as _marshal
from .hierarchy import find_ancestor, level_group_ids
from .order import sort_state_names, sorted_by_partition_name
from .setops import strings_remove
from .types import (
    Partition,
    PartitionMap,
    PartitionModel,
    PlanOptions,
)

__all__ = ["DenseProblem", "PassthroughRows", "NPArray", "encode_problem",
           "decode_assignment",
           "pack_assignment_core", "pack_assignment",
           "prev_from_entries_core", "prev_from_entries", "pack_slot_rows",
           "stack_problem_arrays", "strip_prev_rows",
           "bucket_size", "pad_to", "pad_problem_arrays"]

NPArray = np.ndarray[Any, np.dtype[Any]]

# Shape-bucket granularity: buckets per power-of-two octave.  8 keeps the
# worst-case padding overhead at 1/8 = 12.5% of the axis while collapsing
# the jit-cache key space to ~8 entries per octave — the GSPMD insight
# (arXiv:2105.04663) that repeated invocation is cheap exactly when the
# compiled program's static shapes are reused.
_BUCKET_GRANULARITY = 8


def bucket_size(x: int, granularity: int = _BUCKET_GRANULARITY) -> int:
    """Round ``x`` up to the next static-shape bucket.

    Buckets are multiples of 2**floor(log2(x)) / granularity, i.e. the
    octave [2^k, 2^(k+1)) is split into ``granularity`` evenly spaced
    sizes.  A cluster drifting 1000 -> 1007 -> 998 nodes maps to one
    bucket (1024), so every replan hits the jit cache instead of
    recompiling; the pad rows/columns are inert by construction (weight-0
    partitions, invalid nodes — the same trick parallel/sharded.py uses
    for mesh divisibility)."""
    if x <= granularity:
        return max(x, 0)
    step = max(1, (1 << (x.bit_length() - 1)) // granularity)
    return -(-x // step) * step


def pad_to(arr: np.ndarray, axis: int, target: int,
           fill: float | int | bool) -> np.ndarray:
    """Pad ``arr`` along ``axis`` up to ``target`` entries with ``fill``;
    no-op when already that long.  The one padding spelling of shape
    bucketing."""
    cur = arr.shape[axis]
    if cur >= target:
        return arr
    pad_shape = list(arr.shape)
    pad_shape[axis] = target - cur
    return np.concatenate(
        [arr, np.full(pad_shape, fill, arr.dtype)], axis=axis)


def pad_problem_arrays(
    prev: np.ndarray,
    partition_weights: np.ndarray,
    node_weights: np.ndarray,
    valid_node: np.ndarray,
    stickiness: np.ndarray,
    gids: np.ndarray,
    gid_valid: np.ndarray,
    p_target: int,
    n_target: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray,
           np.ndarray, np.ndarray]:
    """Pad one problem's solver arrays to (p_target, n_target), inertly.

    THE bit-neutral padding recipe, shared by the shape-bucketed paths
    of plan_next_map_cuda and plan_pipeline (and the reference's fleet
    batch stacker):
    pad partitions are weight-0 bidders (their assignments are sliced
    off by the caller) and pad nodes invalid (valid=False => zero
    capacity, +INF score, gid_valid=False), the same inert-padding
    contract parallel/sharded.py relies on, so the real rows solve
    identically to the unpadded problem.  Parameters and the returned
    tuple both follow the solver's positional order (prev, pweights,
    nweights, valid, stickiness, gids, gid_valid) so the call sites
    splat straight into solve_dense and friends."""
    prev = pad_to(prev, 0, p_target, -1)
    partition_weights = pad_to(partition_weights, 0, p_target, 0.0)
    stickiness = pad_to(stickiness, 0, p_target, 0.0)
    node_weights = pad_to(node_weights, 0, n_target, 1.0)
    valid_node = pad_to(valid_node, 0, n_target, False)
    gids = pad_to(gids, 1, n_target, -1)
    gid_valid = pad_to(gid_valid, 1, n_target, False)
    return (prev, partition_weights, node_weights, valid_node,
            stickiness, gids, gid_valid)

def stack_problem_arrays(
    padded: "list[tuple[np.ndarray, ...]]",
) -> tuple[np.ndarray, ...]:
    """Stack B same-shape padded array tuples into [B, ...] batch
    tensors (one np.stack per operand, solver positional order
    preserved).  The batch analog of pad_problem_arrays: pad first so
    every element of a bucket class shares its static shape, then
    stack — the [B, P, S, N] problem tensor the fleet solver runs."""
    if not padded:
        raise ValueError("stack_problem_arrays: empty batch")
    width = len(padded[0])
    return tuple(
        np.stack([np.asarray(arrs[i]) for arrs in padded])
        for i in range(width))


# --- device integer cores ---------------------------------------------------
#
# The string<->id interning at the map edges is host work, but the INTEGER
# cores of encode (filling prev[P, S, R] from interned entries) and decode
# (packing each state row's non-empty slots left and counting them) are
# array programs, run on the device of their tensors.


def pack_assignment_core(assign: torch.Tensor) \
        -> tuple[torch.Tensor, torch.Tensor]:
    """Decode's integer core: pack every (partition, state) row's
    non-empty slots left (stable, preserving slot order) and count them.
    [P, S, R] int32 -> (packed [P, S, R] int32, counts [P, S] int32).
    Bit-equivalent to the numpy pack in decode_assignment and to
    :func:`pack_slot_rows`.  The sort key is the 0/1 empty flag as an
    integer, sorted stably."""
    mask = assign >= 0
    order = torch.sort((~mask).to(torch.int32), dim=2, stable=True).indices
    packed = torch.gather(assign, 2, order)
    counts = mask.sum(dim=2, dtype=torch.int32)
    return packed, counts


def pack_assignment(assign: Any, device: Any = "cuda") \
        -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`pack_assignment_core` on ``device`` for an int32 [P, S, R]
    array or tensor (the host-facing entry point)."""
    from ..convert import resolve_device

    dev = resolve_device(device, "pack_assignment")
    return pack_assignment_core(torch.as_tensor(assign).to(dev))


def prev_from_entries_core(pi: torch.Tensor, si: torch.Tensor,
                           ri: torch.Tensor, node: torch.Tensor,
                           p: int, s: int, r: int) -> torch.Tensor:
    """Encode's integer core: scatter interned (partition, state, slot,
    node) entry columns into a dense prev[P, S, R] (-1 empties).  Entries
    with a negative coordinate, or whose flat index passes P*S*R, drop,
    so callers can pad entry lists with -1 rows.  The reference's
    ``mode="drop"`` scatter is a scatter into one extra bucket that is
    sliced off.  Equivalent to encode_problem's host fill loop for
    already-interned entries."""
    size = p * s * r
    flat = pi.long() * (s * r) + si.long() * r + ri.long()
    keep = (pi >= 0) & (si >= 0) & (ri >= 0) & (flat < size)
    flat = torch.where(keep, flat, torch.full_like(flat, size))
    out = torch.full((size + 1,), -1, dtype=torch.int32, device=node.device)
    out.scatter_(0, flat, node.to(torch.int32))
    return out[:size].reshape(p, s, r)


def prev_from_entries(pi: Any, si: Any, ri: Any, node: Any, p: int, s: int,
                      r: int, device: Any = "cuda") -> torch.Tensor:
    """:func:`prev_from_entries_core` on ``device`` for entry columns
    given as arrays or tensors."""
    from ..convert import resolve_device

    dev = resolve_device(device, "prev_from_entries")
    cols = [torch.as_tensor(c).to(dev) for c in (pi, si, ri, node)]
    return prev_from_entries_core(*cols, p, s, r)


def pack_slot_rows(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host pack of ``[..., S, R]`` assignment rows: non-empty slots
    left (stable, preserving slot order) + per-(row, state) counts.

    THE numpy spelling of decode_assignment's per-state pack (argsort
    on the empty mask, ``kind="stable"``) lifted to whole rows, and the
    host twin of :func:`pack_assignment_core`."""
    mask = rows >= 0
    order = np.argsort(~mask, axis=-1, kind="stable")
    packed = np.take_along_axis(rows, order, axis=-1)
    counts = mask.sum(axis=-1).astype(np.int64)
    return packed, counts


@dataclass(frozen=True)
class PassthroughRows:
    """What the encode learnt of its sources, for the decode: the rows
    whose source carries a state the decode passes through (unmodeled,
    or with constraint 0).  It describes ``source`` (the one map every
    row's source was read from), the name list ``partitions`` and the
    set of ``solved`` states as they were at the encode; the decode uses
    it only while all three are the ones it is handed."""

    source: PartitionMap
    partitions: list[str]
    solved: frozenset[str]
    rows: list[int]  # ascending row indices


@dataclass
class DenseProblem:
    """A fully interned planning problem, ready for the tensor planner."""

    nodes: list[str]  # id -> name, in nodes_all order (ties break by this)
    partitions: list[str]  # id -> name, in planner sort order
    states: list[str]  # priority-ordered (sort_state_names)

    constraints: np.ndarray  # [S] int32
    prev: np.ndarray  # [P, S, R] int32 node ids, -1 empty
    partition_weights: np.ndarray  # [P] float32
    node_weights: np.ndarray  # [N] float32 (raw; may be negative)
    valid_node: np.ndarray  # [N] bool — False for nodes_to_remove
    stickiness: np.ndarray  # [P, S] float32

    # Hierarchy: group ids per level per node; level 0 = the node itself.
    # gids[l, n] == gids[l, m] iff nodes n, m share their level-l ancestor.
    gids: np.ndarray  # [L, N] int32
    gid_valid: np.ndarray  # [L, N] bool — ancestor exists at that level
    # Per state, list of (include_level, exclude_level) rules.
    rules: dict[int, list[tuple[int, int]]]
    # Set by encode_problem when it read every source from one map (None:
    # unknown, and the decode reads every row's source).
    passthrough: Optional[PassthroughRows] = field(
        default=None, repr=False, compare=False)

    @property
    def P(self) -> int:
        return len(self.partitions)

    @property
    def N(self) -> int:
        return len(self.nodes)

    @property
    def S(self) -> int:
        return len(self.states)

    @property
    def R(self) -> int:
        return self.prev.shape[2] if self.prev.size else 0


def strip_prev_rows(prev: np.ndarray,
                    node_ids: np.ndarray) -> tuple[np.ndarray,
                                                   np.ndarray]:
    """Remove every placement on ``node_ids`` from ``prev`` [P, S, R]
    and re-pack the touched rows left; returns ``(patched prev — a new
    array, dirty row mask [P])``.

    The array twin of ``rebalance._strip_nodes`` + re-encode: a fresh
    ``encode_problem`` of the stripped map fills each touched row with
    the surviving entries in their original order, packed left — which
    is exactly mask-to-(-1) + :func:`pack_slot_rows` on those rows.
    Untouched rows are returned byte-identical (same values, new array
    object: callers memoize on array identity, so an in-place patch
    could serve stale memo hits)."""
    hit = np.isin(prev, node_ids)
    dirty = hit.any(axis=(1, 2))
    out = prev.copy()
    if dirty.any():
        sub = out[dirty]
        sub[hit[dirty]] = -1
        packed, _counts = pack_slot_rows(sub)
        out[dirty] = packed
    return out, dirty


def encode_problem(
    prev_map: PartitionMap,
    partitions_to_assign: PartitionMap,
    nodes_all: list[str],
    nodes_to_remove: Optional[list[str]],
    model: PartitionModel,
    opts: PlanOptions,
) -> DenseProblem:
    """Intern and pack a planning problem into dense arrays.

    Its stages run in the spans ``plan.encode.order`` (the name orders),
    ``plan.encode.prev`` (the [P, S, R] fill) and
    ``plan.encode.hierarchy`` (the group ids).  The counter
    ``plan.encode.rows_keyed`` counts the rows whose ``prev_map`` entry
    was found by a hashed lookup rather than in step with the map's own
    order (recorded only when there are some).  When every source was
    read from ``partitions_to_assign`` (``prev_map`` is that map, or
    empty) the problem carries ``passthrough``, the rows whose source
    the decode must read again."""
    rec = get_recorder()
    native = _marshal.get()
    with rec.span("plan.encode.order"):
        nodes = list(nodes_all)
        node_index = {n: i for i, n in enumerate(nodes)}
        # A map the planner wrote is already in partition order: checking
        # that is one pass, sorting its names is not.
        partitions = list(partitions_to_assign)
        if native is None or not native.in_name_order(partitions):
            partitions = sorted_by_partition_name(partitions)
        states = sort_state_names(model)
        state_index = {s: i for i, s in enumerate(states)}

    constraints = np.zeros(len(states), dtype=np.int32)
    for s, st in model.items():
        c = st.constraints
        if opts.model_state_constraints is not None:
            c = opts.model_state_constraints.get(s, c)
        constraints[state_index[s]] = c
    solved = frozenset(s for s, c in zip(states, constraints.tolist())
                       if c > 0)

    P, S, N = len(partitions), len(states), len(nodes)
    with rec.span("plan.encode.prev"):
        # Slot depth: enough for the widest constraint and the widest
        # prev row.  One walk of the input map fills prev at the
        # constraint's depth, finds the widest row and marks the rows
        # whose source has states for the decode to pass through; at 100k
        # partitions that dict/list traversal dominates the encode, so it
        # runs in the native marshalling layer when it is available
        # (native/marshal.c), with this pure-Python path as the fallback.
        # The C fast path is stricter about shapes (real dicts, real
        # lists); any structural surprise raises TypeError there and we
        # fall back to this loop, which tolerates arbitrary
        # Mappings/Sequences.
        r_max = max(int(constraints.max()) if S else 0, 1)
        prev = None
        if native is not None:
            try:
                prev, marked, keyed = _walk_native(
                    native, r_max, partitions, prev_map,
                    partitions_to_assign, state_index, node_index,
                    (constraints > 0).tobytes())
            except (TypeError, AttributeError):
                # AttributeError: a None/falsy entry in prev_map reaches
                # .nodes_by_state in C; the Python loop below tolerates it
                # via the `or partitions_to_assign[...]` fallthrough.
                prev = None
        if prev is None:
            for pname in partitions:
                src = prev_map.get(pname) or partitions_to_assign[pname]
                for s, ns in src.nodes_by_state.items():
                    if s in state_index:
                        r_max = max(r_max, len(ns))
            prev = np.full((P, S, r_max), -1, dtype=np.int32)
            marked, keyed = [], 0
            for pi, pname in enumerate(partitions):
                src = prev_map.get(pname)
                keyed += src is not None
                src = src or partitions_to_assign.get(pname)
                if src is None:
                    continue
                nbs = src.nodes_by_state
                if not nbs.keys() <= solved:
                    marked.append(pi)
                for s, ns in nbs.items():
                    si = state_index.get(s)
                    if si is None:
                        continue
                    for ri, node in enumerate(ns[:r_max]):
                        prev[pi, si, ri] = node_index.get(node, -1)
        if keyed:
            rec.count("plan.encode.rows_keyed", keyed)

    pweights = np.ones(P, dtype=np.float32)
    if opts.partition_weights:
        for pi, pname in enumerate(partitions):
            pweights[pi] = opts.partition_weights.get(pname, 1)

    nweights = np.ones(N, dtype=np.float32)
    if opts.node_weights:
        for ni, n in enumerate(nodes):
            nweights[ni] = opts.node_weights.get(n, 1)

    valid = np.ones(N, dtype=bool)
    if nodes_to_remove:
        removed = set(nodes_to_remove)
        for ni, n in enumerate(nodes):
            if n in removed:
                valid[ni] = False

    # Stickiness per (partition, state), with the reference's resolution
    # order (plan.go:104-115): partition weight if present, else state
    # stickiness (gated on partition_weights presence unless the standalone
    # compat switch), else 1.5.
    stickiness = np.full((P, S), 1.5, dtype=np.float32)
    pw = opts.partition_weights
    ss = opts.state_stickiness
    ss_active = ss is not None and (pw is not None or opts.state_stickiness_standalone)
    if pw or ss_active:
        for pi, pname in enumerate(partitions):
            if pw is not None and pname in pw:
                stickiness[pi, :] = pw[pname]
            elif ss_active:
                for si, s in enumerate(states):
                    if s in ss:
                        stickiness[pi, si] = ss[s]

    # Hierarchy group ids.  Levels needed = max level referenced by any rule.
    rules_by_state: dict[int, list[tuple[int, int]]] = {}
    max_level = 0
    if opts.hierarchy_rules:
        for s, rl in opts.hierarchy_rules.items():
            si = state_index.get(s)
            if si is None:
                continue
            rules_by_state[si] = [
                (r.include_level, r.exclude_level) for r in rl
            ]
            for r in rl:
                max_level = max(max_level, r.include_level, r.exclude_level)

    with rec.span("plan.encode.hierarchy"):
        gid_rows = level_group_ids(nodes, opts.node_hierarchy, max_level)
        gids = np.asarray(gid_rows, dtype=np.int32).reshape(
            max_level + 1, N) if N else np.zeros((max_level + 1, 0), np.int32)
        gid_valid = np.ones((max_level + 1, N), dtype=bool)
        for level in range(max_level + 1):
            for ni, n in enumerate(nodes):
                gid_valid[level, ni] = \
                    find_ancestor(n, opts.node_hierarchy, level) != ""

    return DenseProblem(
        nodes=nodes,
        partitions=partitions,
        states=states,
        constraints=constraints,
        prev=prev,
        partition_weights=pweights,
        node_weights=nweights,
        valid_node=valid,
        stickiness=stickiness,
        gids=gids,
        gid_valid=gid_valid,
        rules=rules_by_state,
        passthrough=(PassthroughRows(partitions_to_assign, partitions,
                                     solved, marked)
                     if prev_map is partitions_to_assign or not prev_map
                     else None),
    )


def _walk_native(native: Any, r_min: int, partitions: list[str],
                 prev_map: PartitionMap, partitions_to_assign: PartitionMap,
                 state_index: dict[str, int], node_index: dict[str, int],
                 solved_flags: bytes) -> tuple[NPArray, list[int], int]:
    """``native.walk_prev`` at depth ``r_min``, and once more at the
    widest row's depth when some row is wider (an input that holds more
    copies than its constraint).  Returns (prev, marked rows, prev_map
    entries found out of step)."""
    P, S = len(partitions), len(state_index)
    r_max = r_min
    while True:
        prev = np.empty((P, S, r_max), dtype=np.int32)
        width, marked, keyed = native.walk_prev(
            prev, P, S, r_max, partitions, prev_map, partitions_to_assign,
            state_index, node_index, solved_flags)
        if width <= r_max:
            return prev, marked, keyed
        r_max = width


def decode_assignment(
    problem: DenseProblem,
    assign: np.ndarray,  # [P, S, R] int32 node ids, -1 empty
    partitions_to_assign: PartitionMap,
    nodes_to_remove: Optional[list[str]] = None,
    *,
    packed: Optional[np.ndarray] = None,  # [P, S, R] device-packed rows
    counts: Optional[np.ndarray] = None,  # [P, S] per-row filled counts
) -> tuple[PartitionMap, dict[str, list[str]]]:
    """Dense assignment -> PartitionMap + constraint-shortfall warnings.

    States absent from the model keep their (removed-node-stripped) previous
    assignment, matching the greedy planner's pass-through of unmodeled
    states.  Vectorized over P: the id->name gather, empty-slot packing and
    shortfall detection run as whole-array numpy ops.

    ``packed``/``counts`` (both or neither) short-circuit the host pack:
    the fused plan pipeline computes them on the device
    (:func:`pack_assignment_core`) and brings them back with the
    assignment, leaving only the id->name gather and list building here.

    The rows run in the span ``plan.decode.rows`` (pack, name gather,
    list building) and the map in ``plan.decode.build``; the counter
    ``plan.decode.rows_trimmed`` counts the rows shorter than their
    state's widest filled row (recorded only when there are some).

    When ``problem.passthrough`` describes ``partitions_to_assign`` (the
    encode read every source from this very map), the build reads again
    only the sources of the rows it marked, and counts them as
    ``plan.decode.passthrough_rows`` (when there are some); otherwise it
    reads every row's source, as the encode's marks cannot vouch for
    another map.
    """
    rec = get_recorder()
    if (packed is None) != (counts is None):
        raise ValueError("decode_assignment: packed and counts must be "
                         "passed together")
    assign = np.asarray(assign)
    warnings: dict[str, list[str]] = {}
    P = problem.P

    with rec.span("plan.decode.rows"):
        # Per modeled state with constraints > 0: pack non-empty slots
        # left (stable, preserving slot order), cut the rows to the
        # state's widest filled row while they are still arrays, gather
        # names in one shot, and convert to nested Python lists at C
        # speed.  Only rows shorter than that width (constraint
        # shortfalls, in a sound plan none) are trimmed one by one: a
        # Python loop over every row would make a new list per row and
        # wake the cyclic collector hundreds of times a decode.
        names_arr = np.asarray(problem.nodes, dtype=object) \
            if problem.nodes else np.zeros(0, dtype=object)
        per_state_rows: dict[int, list[list[str]]] = {}
        per_state_counts: dict[int, np.ndarray] = {}
        trimmed = 0
        for si, sname in enumerate(problem.states):
            want = int(problem.constraints[si])
            if want <= 0:
                continue
            if P == 0 or not problem.nodes:
                # Degenerate: nothing assignable; every slot is a shortfall.
                per_state_rows[si] = [[] for _ in range(P)]
                per_state_counts[si] = np.zeros(P, dtype=np.int64)
                continue
            if packed is not None and counts is not None:
                row_ids = np.asarray(packed)[:, si, :]
                row_counts = np.asarray(counts)[:, si].astype(np.int64)
            else:
                ids = assign[:, si, :]
                mask = ids >= 0
                row_counts = mask.sum(axis=1)
                order = np.argsort(~mask, axis=1, kind="stable")
                row_ids = np.take_along_axis(ids, order, axis=1)
            width = int(row_counts.max())
            nested = names_arr[np.maximum(row_ids[:, :width], 0)].tolist()
            short = np.nonzero(row_counts < width)[0]
            for pi, c in zip(short.tolist(), row_counts[short].tolist()):
                del nested[pi][c:]
            trimmed += short.size
            per_state_rows[si] = nested
            per_state_counts[si] = row_counts
        if trimmed:
            rec.count("plan.decode.rows_trimmed", trimmed)

    # Partitions needing the slow path: source has unmodeled or
    # zero-constraint states to pass through (rare in practice).  The
    # encode marked them when it read every source from this very map;
    # otherwise every row's source is read here.
    constraints = problem.constraints
    modeled = [
        (si, s) for si, s in enumerate(problem.states)
        if int(constraints[si]) > 0
    ]
    solved_states = {s for _, s in modeled}
    mod_names = [s for _, s in modeled]
    rows_per_state = [per_state_rows[si] for si, _ in modeled]
    removed = nodes_to_remove or []
    marks = problem.passthrough
    read_rows = marks.rows if (
        marks is not None and marks.source is partitions_to_assign
        and marks.partitions is problem.partitions
        and marks.solved == solved_states) else None
    if read_rows:
        rec.count("plan.decode.passthrough_rows", len(read_rows))
    with rec.span("plan.decode.build"):
        native = _marshal.get()
        next_map = None
        if native is not None:
            try:
                next_map = native.build_map(
                    Partition, problem.partitions, mod_names, rows_per_state,
                    partitions_to_assign, solved_states, set(removed),
                    read_rows)
            except (TypeError, AttributeError):
                next_map = None  # structural surprise: pure-Python fallback
        if next_map is None:
            next_map = {}
            rows_iter = zip(*rows_per_state) if rows_per_state \
                else (() for _ in range(P))
            get_src = partitions_to_assign.get
            read = None if read_rows is None else set(read_rows)
            for pi, (pname, vals) in enumerate(zip(problem.partitions,
                                                   rows_iter)):
                src = get_src(pname) if read is None or pi in read \
                    else None
                # keys() <= set is a C-level check; the passthrough branch
                # (source carries unmodeled / zero-constraint states) is rare
                # in practice.
                if src is None or src.nodes_by_state.keys() <= solved_states:
                    nbs = dict(zip(mod_names, vals))
                else:
                    nbs = {}
                    for s, ns in src.nodes_by_state.items():
                        if s not in solved_states:
                            nbs[s] = strings_remove(ns, removed)
                    for s, v in zip(mod_names, vals):
                        nbs[s] = v
                next_map[pname] = Partition(pname, nbs)

    for si, sname in modeled:
        want = int(constraints[si])
        short = np.nonzero(per_state_counts[si] < want)[0]
        for pi in short:
            pname = problem.partitions[pi]
            warnings.setdefault(pname, []).append(
                "could not meet constraints: %d, stateName: %s,"
                " partitionName: %s" % (want, sname, pname)
            )

    return next_map, warnings
