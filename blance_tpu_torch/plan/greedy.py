# Copied from blance_tpu/plan/greedy.py.  sort_state_names,
# _partition_name_key and flatten_nodes_by_state (with
# sorted_by_partition_name, which the native backend uses) live in
# core/order.py, the port's one copy of them; everything else is the
# reference's.
"""Exact greedy planner — the semantics oracle and "cpu" backend.

This reimplements the reference's greedy placement algorithm faithfully
(the Go reference's plan.go:23-331) so that golden-output tests hold
and so the batched TPU backend (blance_tpu.plan.tensor) has an oracle to
cross-validate against.  It is a fresh Python implementation driven by the
semantics in SURVEY.md §2.2/§3.1, not a translation: state flows through
explicit ``_PlanContext``/``NodeScoreContext`` objects instead of closures
over package globals, and hooks come from ``PlanOptions``.

Semantic notes preserved on purpose (each cites the reference):
- stickiness defaults 1.5; partition_weights[partition] overrides it; the
  state_stickiness table is consulted only when partition_weights is present
  (quirk, plan.go:104-115) unless opts.state_stickiness_standalone.
- node score = stateNodeCounts + nodeToNode/numPartitions
  + 0.001*nodePartitionCounts/numPartitions, divided by positive node weight,
  boosted for negative weight, minus stickiness if the node already holds
  this state for this partition (plan.go:634-689).
- score ties break by node position in nodes_all (plan.go:617-628).
- partitions sort: on-removed-nodes first, then never-touched-added-nodes,
  then heavier first, then zero-padded-numeric-else-raw name (plan.go:519-562).
- convergence loop feeds the output back as prev/next and clears the node
  deltas, up to max_iterations (plan.go:23-58).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from ..core.hierarchy import (
    include_exclude_nodes_intersect,
    parents_to_children,
)
from ..core.order import (
    _partition_name_key,
    flatten_nodes_by_state,
    sort_state_names,
)
from ..core.setops import strings_dedup, strings_intersect, strings_remove
from ..obs import get_recorder
from ..core.types import (
    Partition,
    PartitionMap,
    PartitionModel,
    PlanOptions,
    copy_partition_map,
)

__all__ = [
    "plan_next_map_greedy",
    "sort_state_names",
    "count_state_nodes",
    "NodeScoreContext",
    "default_node_score",
]


# ---------------------------------------------------------------------------
# State ordering and counting helpers
# ---------------------------------------------------------------------------


def count_state_nodes(
    pmap: PartitionMap, partition_weights: Optional[dict[str, int]]
) -> dict[str, dict[str, int]]:
    """state -> node -> weighted partition count (plan.go:374-399)."""
    rv: dict[str, dict[str, int]] = {}
    for pname, partition in pmap.items():
        w = 1
        if partition_weights is not None:
            w = partition_weights.get(pname, 1)
        for state, nodes in partition.nodes_by_state.items():
            s = rv.setdefault(state, {})
            for node in nodes:
                s[node] = s.get(node, 0) + w
    return rv


def _adjust_state_node_counts(
    counts: dict[str, dict[str, int]], state: str, nodes: list[str], amt: int
) -> None:
    """counts[state][node] += amt for each node (plan.go:353-363)."""
    s = counts.setdefault(state, {})
    for node in nodes:
        s[node] = s.get(node, 0) + amt


def _remove_nodes_from_nodes_by_state(
    nodes_by_state: dict[str, list[str]],
    remove: list[str],
    on_removed: Optional[Callable[[str, str, list[str]], None]] = None,
) -> dict[str, list[str]]:
    """Copy with nodes removed; callback sees actually-removed nodes
    (plan.go:408-421)."""
    rv: dict[str, list[str]] = {}
    for state, nodes in nodes_by_state.items():
        if on_removed is not None:
            on_removed(state, strings_intersect(nodes, remove))
        rv[state] = strings_remove(nodes, remove)
    return rv


# ---------------------------------------------------------------------------
# Node scoring
# ---------------------------------------------------------------------------


@dataclass
class NodeScoreContext:
    """Everything the node score formula reads (plan.go:566-578).

    Passed to custom scorers (the CustomNodeSorter extension point,
    plan.go:580) so applications can replace the formula while the framework
    keeps the position tie-break.
    """

    state_name: str
    partition: Partition
    num_partitions: int
    top_priority_node: str
    state_node_counts: dict[str, dict[str, int]]
    node_to_node_counts: dict[str, dict[str, int]]
    node_partition_counts: dict[str, int]
    node_positions: dict[str, int]
    node_weights: Optional[dict[str, int]]
    stickiness: float
    node_score_booster: Optional[object] = None


def default_node_score(ctx: NodeScoreContext, node: str) -> float:
    """The balance/stickiness score; lower is better (plan.go:634-689)."""
    lower_priority_balance = 0.0
    if ctx.num_partitions > 0:
        m = ctx.node_to_node_counts.get(ctx.top_priority_node)
        if m is not None:
            lower_priority_balance = m.get(node, 0) / ctx.num_partitions

    filled = 0.0
    if ctx.num_partitions > 0:
        c = ctx.node_partition_counts.get(node)
        if c is not None:
            filled = (0.001 * c) / ctx.num_partitions

    current = 0.0
    for state_node in ctx.partition.nodes_by_state.get(ctx.state_name, ()):
        if state_node == node:
            current = ctx.stickiness  # Minimise movement.

    r = float(ctx.state_node_counts.get(ctx.state_name, {}).get(node, 0))
    r += lower_priority_balance
    r += filled

    if ctx.node_weights is not None and node in ctx.node_weights:
        w = ctx.node_weights[node]
        if w > 0:
            r /= float(w)
        elif w < 0 and ctx.node_score_booster is not None:
            r += ctx.node_score_booster(w, current)

    return r - current


def _sort_nodes(ctx: NodeScoreContext, nodes: list[str],
                scorer: Callable[[NodeScoreContext, str], float]) -> list[str]:
    """Sort by score ASC, ties by node position in nodes_all (plan.go:617-628)."""
    return sorted(
        nodes,
        key=lambda n: (scorer(ctx, n), ctx.node_positions.get(n, 0)),
    )


# ---------------------------------------------------------------------------
# Partition ordering
# ---------------------------------------------------------------------------


def _partition_weight_key(weight: int) -> str:
    """Heavier-first sortable weight key (plan.go:533-539); shared with the
    native backend's static rank so the encodings cannot drift."""
    return f"{999999999 - weight:>10d}"


def _partition_sort_score(
    partition: Partition,
    state_name: str,
    prev_map: Optional[PartitionMap],
    nodes_to_remove: Optional[list[str]],
    nodes_to_add: Optional[list[str]],
    partition_weights: Optional[dict[str, int]],
) -> tuple[str, str, str]:
    """Composite sort key (plan.go:519-562); tuple compare = the reference's
    element-wise string-vector compare (plan.go:495-513)."""
    name_key = _partition_name_key(partition.name)

    weight = 1
    if partition_weights is not None:
        weight = partition_weights.get(partition.name, 1)
    weight_key = _partition_weight_key(weight)

    # Category 0: partitions whose previous holders of this state sit on
    # to-be-removed nodes (plan.go:541-550).
    if prev_map is not None and nodes_to_remove:
        last = prev_map.get(partition.name)
        if last is not None:
            lpnbs = last.nodes_by_state.get(state_name)
            if lpnbs and strings_intersect(lpnbs, nodes_to_remove):
                return ("0", weight_key, name_key)

    # Category 1: partitions not yet landed on any newly added node
    # (plan.go:553-559).  Mirrors the reference's nil-vs-empty distinction:
    # an empty-but-present nodes_to_add still triggers this branch.
    if nodes_to_add is not None:
        fnbs = flatten_nodes_by_state(partition.nodes_by_state)
        if not strings_intersect(fnbs, nodes_to_add):
            return ("1", weight_key, name_key)

    return ("2", weight_key, name_key)


def _sort_partitions(
    partitions: list[Partition],
    state_name: str,
    prev_map: Optional[PartitionMap],
    nodes_to_remove: Optional[list[str]],
    nodes_to_add: Optional[list[str]],
    partition_weights: Optional[dict[str, int]],
) -> list[Partition]:
    return sorted(
        partitions,
        key=lambda p: (
            _partition_sort_score(
                p, state_name, prev_map, nodes_to_remove, nodes_to_add, partition_weights
            ),
            p.name,
        ),
    )


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------


@dataclass
class _PlanContext:
    """Mutable single-pass planner state (the closure captures in plan.go:60-303)."""

    prev_map: PartitionMap
    nodes_all: list[str]
    nodes_next: list[str]
    nodes_to_remove: list[str]
    # None vs [] is meaningful for the category-1 sort branch (plan.go:554).
    nodes_to_add: Optional[list[str]]
    model: PartitionModel
    opts: PlanOptions
    node_positions: dict[str, int]
    hierarchy_children: dict[str, list[str]]
    state_node_counts: dict[str, dict[str, int]] = field(default_factory=dict)
    warnings: dict[str, list[str]] = field(default_factory=dict)


def _top_priority_state_name(model: PartitionModel) -> str:
    """Highest-priority (lowest number) state; name breaks ties
    deterministically (the reference's map-iteration pick at plan.go:126-132
    is only deterministic when the top priority is unique)."""
    if not model:
        return ""
    return min(model.keys(), key=lambda s: (model[s].priority, s))


def _find_best_nodes(
    ctx: _PlanContext,
    partition: Partition,
    state_name: str,
    constraints: int,
    node_to_node_counts: dict[str, dict[str, int]],
) -> list[str]:
    """Ordered best-fit candidate nodes for (partition, state) (plan.go:98-248)."""
    opts = ctx.opts

    # Stickiness resolution, preserving the reference quirk (plan.go:104-115):
    # state_stickiness applies only when partition_weights is present (unless
    # the standalone compat switch is on).
    stickiness = 1.5
    if opts.partition_weights is not None:
        if partition.name in opts.partition_weights:
            stickiness = float(opts.partition_weights[partition.name])
        elif opts.state_stickiness is not None and state_name in opts.state_stickiness:
            stickiness = float(opts.state_stickiness[state_name])
    elif opts.state_stickiness_standalone and opts.state_stickiness is not None:
        if state_name in opts.state_stickiness:
            stickiness = float(opts.state_stickiness[state_name])

    # Total load per node across all states, rebuilt per call (plan.go:118-124).
    node_partition_counts: dict[str, int] = {}
    for node_counts in ctx.state_node_counts.values():
        for node, cnt in node_counts.items():
            node_partition_counts[node] = node_partition_counts.get(node, 0) + cnt

    top_state = _top_priority_state_name(ctx.model)
    top_nodes = partition.nodes_by_state.get(top_state, [])
    top_priority_node = top_nodes[0] if top_nodes else ""

    state_priority = ctx.model[state_name].priority

    def exclude_higher_priority(nodes: list[str]) -> list[str]:
        # Leave holders of superior states untouched (plan.go:146-156).
        for s, s_nodes in partition.nodes_by_state.items():
            ms = ctx.model.get(s)
            if ms is not None and ms.priority < state_priority:
                nodes = strings_remove(nodes, s_nodes)
        return nodes

    candidates = exclude_higher_priority(list(ctx.nodes_next))

    score_ctx = NodeScoreContext(
        state_name=state_name,
        partition=partition,
        num_partitions=len(ctx.prev_map),
        top_priority_node=top_priority_node,
        state_node_counts=ctx.state_node_counts,
        node_to_node_counts=node_to_node_counts,
        node_partition_counts=node_partition_counts,
        node_positions=ctx.node_positions,
        node_weights=opts.node_weights,
        stickiness=stickiness,
        node_score_booster=opts.node_score_booster,
    )
    if opts.node_sorter is not None:
        # Full-sorter replacement (reference CustomNodeSorter,
        # plan.go:566-580): the hook owns score AND tie-break policy.
        def sort_candidates(nodes):
            out = list(opts.node_sorter(score_ctx, nodes))
            if sorted(out) != sorted(nodes):
                # A hook that drops/duplicates/invents nodes would silently
                # corrupt placement (missing candidates look like unmet
                # constraints, invented ones place onto ghost nodes) —
                # reject it loudly at the boundary instead.
                from collections import Counter

                want, got = Counter(nodes), Counter(out)
                missing = sorted((want - got).elements())[:3]
                extra = sorted((got - want).elements())[:3]
                raise ValueError(
                    "node_sorter must return a permutation of its input "
                    f"nodes: got {len(out)} nodes from {len(nodes)}"
                    f"{', missing ' + repr(missing) if missing else ''}"
                    f"{', unexpected/duplicated ' + repr(extra) if extra else ''}"
                    f" (partition {partition.name!r}, state {state_name!r})")
            return out
    else:
        scorer = opts.node_scorer or default_node_score

        def sort_candidates(nodes):
            return _sort_nodes(score_ctx, nodes, scorer)
    candidates = sort_candidates(candidates)
    # Scoring-cost attribution: how many candidates each (partition, state)
    # pick had to score — the distribution that explains greedy wall-clock.
    get_recorder().observe("plan.greedy.candidates", len(candidates))

    if opts.hierarchy_rules is not None:
        # Hierarchy pass (plan.go:174-226): each rule contributes up to
        # ``constraints`` picks anchored on the primary plus picks so far.
        hierarchy_nodes: list[str] = []
        for rule in opts.hierarchy_rules.get(state_name, []):
            anchor = top_priority_node
            if anchor == "" and hierarchy_nodes:
                anchor = hierarchy_nodes[0]
            for _ in range(constraints):
                h_candidates = include_exclude_nodes_intersect(
                    [anchor] + hierarchy_nodes,
                    rule.include_level,
                    rule.exclude_level,
                    opts.node_hierarchy,
                    ctx.hierarchy_children,
                )
                h_candidates = strings_intersect(h_candidates, ctx.nodes_next)
                h_candidates = exclude_higher_priority(h_candidates)
                h_candidates = sort_candidates(h_candidates)
                if h_candidates:
                    hierarchy_nodes.append(h_candidates[0])
                elif candidates:
                    hierarchy_nodes.append(candidates[0])
        candidates = strings_dedup(hierarchy_nodes + candidates)

    if len(candidates) >= constraints:
        candidates = candidates[:constraints]
    else:
        ctx.warnings.setdefault(partition.name, []).append(
            "could not meet constraints: %d, stateName: %s, partitionName: %s"
            % (constraints, state_name, partition.name)
        )

    # Replica-spread accounting (plan.go:238-245).
    m = node_to_node_counts.setdefault(top_priority_node, {})
    for node in candidates:
        m[node] = m.get(node, 0) + 1

    return candidates


def _assign_state_to_partitions(
    ctx: _PlanContext, next_partitions: list[Partition], state_name: str, constraints: int
) -> None:
    """Assign one state across all partitions in sorted order (plan.go:253-303)."""
    ordered = _sort_partitions(
        next_partitions,
        state_name,
        ctx.prev_map,
        ctx.nodes_to_remove,
        ctx.nodes_to_add,
        ctx.opts.partition_weights,
    )

    # higher-priority node -> {lower-priority node: count}; fresh per state.
    node_to_node_counts: dict[str, dict[str, int]] = {}

    for partition in ordered:
        weight = 1
        if ctx.opts.partition_weights is not None:
            weight = ctx.opts.partition_weights.get(partition.name, 1)

        def dec(state: str, nodes: list[str]) -> None:
            if nodes:
                _adjust_state_node_counts(ctx.state_node_counts, state, nodes, -weight)

        nodes_to_assign = _find_best_nodes(
            ctx, partition, state_name, constraints, node_to_node_counts
        )

        # Uninstall the state's old holders and the newly chosen nodes from
        # every state, keeping counts consistent (plan.go:290-297).
        partition.nodes_by_state = _remove_nodes_from_nodes_by_state(
            partition.nodes_by_state, partition.nodes_by_state.get(state_name, []), dec
        )
        partition.nodes_by_state = _remove_nodes_from_nodes_by_state(
            partition.nodes_by_state, nodes_to_assign, dec
        )
        partition.nodes_by_state[state_name] = nodes_to_assign
        _adjust_state_node_counts(ctx.state_node_counts, state_name, nodes_to_assign, weight)


def _plan_next_map_inner(
    prev_map: PartitionMap,
    partitions_to_assign: PartitionMap,
    nodes_all: list[str],
    nodes_to_remove: list[str],
    nodes_to_add: Optional[list[str]],
    model: PartitionModel,
    opts: PlanOptions,
) -> tuple[PartitionMap, dict[str, list[str]]]:
    """One planning pass (plan.go:60-331)."""
    node_positions = {node: i for i, node in enumerate(nodes_all)}
    nodes_next = strings_remove(nodes_all, nodes_to_remove)
    hierarchy_children = parents_to_children(opts.node_hierarchy)

    # Deep-clone the partitions to assign, strip removed nodes, and fix a
    # deterministic base order (plan.go:83-89 sorts by name key only).
    next_partitions = [p.copy() for p in partitions_to_assign.values()]
    for p in next_partitions:
        p.nodes_by_state = _remove_nodes_from_nodes_by_state(
            p.nodes_by_state, nodes_to_remove
        )
    next_partitions.sort(key=lambda p: (_partition_name_key(p.name), p.name))

    ctx = _PlanContext(
        prev_map=prev_map,
        nodes_all=nodes_all,
        nodes_next=nodes_next,
        nodes_to_remove=nodes_to_remove,
        nodes_to_add=nodes_to_add,
        model=model,
        opts=opts,
        node_positions=node_positions,
        hierarchy_children=hierarchy_children,
        state_node_counts=count_state_nodes(prev_map, opts.partition_weights),
    )

    for state_name in sort_state_names(model):
        constraints = model[state_name].constraints
        if opts.model_state_constraints is not None:
            constraints = opts.model_state_constraints.get(state_name, constraints)
        if constraints > 0:
            _assign_state_to_partitions(ctx, next_partitions, state_name, constraints)

    return {p.name: p for p in next_partitions}, ctx.warnings


def plan_next_map_greedy(
    prev_map: PartitionMap,
    partitions_to_assign: PartitionMap,
    nodes_all: list[str],
    nodes_to_remove: Optional[list[str]],
    nodes_to_add: Optional[list[str]],
    model: PartitionModel,
    opts: Optional[PlanOptions] = None,
) -> tuple[PartitionMap, dict[str, list[str]]]:
    """Plan the next balanced map; convergence loop (plan.go:23-58).

    Runs the inner pass up to opts.max_iterations times; between iterations
    the output is fed back as both prev and to-assign and the node deltas are
    cleared, so iteration 2+ re-balances on a stable node set.  Unlike the
    reference, the caller's maps are never mutated.
    """
    opts = opts or PlanOptions()

    with get_recorder().span(
            "plan.greedy", partitions=len(partitions_to_assign),
            nodes=len(nodes_all)):
        return _plan_next_map_greedy(
            prev_map, partitions_to_assign, nodes_all, nodes_to_remove,
            nodes_to_add, model, opts)


def _plan_next_map_greedy(
    prev_map: PartitionMap,
    partitions_to_assign: PartitionMap,
    nodes_all: list[str],
    nodes_to_remove: Optional[list[str]],
    nodes_to_add: Optional[list[str]],
    model: PartitionModel,
    opts: PlanOptions,
) -> tuple[PartitionMap, dict[str, list[str]]]:
    prev_map = copy_partition_map(prev_map)
    partitions_to_assign = copy_partition_map(partitions_to_assign)
    nodes_all = list(nodes_all)
    nodes_to_remove = list(nodes_to_remove) if nodes_to_remove is not None else []
    # nil-vs-empty matters for the category-1 partition sort branch
    # (plan.go:554); preserve None distinctly.
    nta: Optional[list[str]] = list(nodes_to_add) if nodes_to_add is not None else None

    next_map: PartitionMap = {}
    warnings: dict[str, list[str]] = {}

    for _ in range(max(1, opts.max_iterations)):
        next_map, warnings = _plan_next_map_inner(
            prev_map, partitions_to_assign, nodes_all,
            nodes_to_remove, nta, model, opts,
        )
        # Fixpoint check over the assigned partitions only (plan.go:35-45).
        if all(
            prev_map.get(p.name) is not None
            and p.nodes_by_state == prev_map[p.name].nodes_by_state
            for p in next_map.values()
        ):
            break
        # Feed forward and clear deltas (plan.go:49-55).
        for p in next_map.values():
            prev_map[p.name] = p
            partitions_to_assign[p.name] = p
        nodes_all = strings_remove(nodes_all, nodes_to_remove)
        nodes_to_remove = []
        nta = []

    return next_map, warnings
