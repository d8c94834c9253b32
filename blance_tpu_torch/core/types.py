# Copied from blance_tpu/core/types.py, verbatim but for the reference-path prefix in citations.
"""Core data model: partitions, maps, models, hierarchy rules, plan options.

This mirrors the reference's data model (reference: api.go:24-190)
but as Python dataclasses that are trivially JSON round-trippable — the
PartitionMap *is* the checkpoint format of the framework, so keeping it plain
is a design requirement (reference api.go:30,35 json tags).

Unlike the reference, hooks (node scorer / score booster) live on
``PlanOptions`` instead of mutable package globals, so concurrent plans with
different policies can't interfere.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Mapping, Optional

__all__ = [
    "Partition",
    "PartitionMap",
    "PartitionModelState",
    "PartitionModel",
    "HierarchyRule",
    "HierarchyRules",
    "PlanOptions",
    "partition_map_to_json",
    "partition_map_from_json",
    "copy_partition",
    "copy_partition_map",
    "model",
]


@dataclass
class Partition:
    """A distinct shard of a logical resource (reference api.go:28-36).

    ``nodes_by_state`` maps state name -> ordered node list.  Order is
    meaningful: index 0 of the top-priority state is "the primary" used for
    hierarchy anchoring and replica-spread accounting.
    """

    name: str
    nodes_by_state: dict[str, list[str]] = field(default_factory=dict)

    def copy(self) -> "Partition":
        return Partition(
            name=self.name,
            nodes_by_state={s: list(nodes) for s, nodes in self.nodes_by_state.items()},
        )

    def to_json(self) -> dict:
        return {"name": self.name, "nodesByState": self.nodes_by_state}

    @staticmethod
    def from_json(d: Mapping) -> "Partition":
        return Partition(
            name=d["name"],
            nodes_by_state={s: list(nodes) for s, nodes in d.get("nodesByState", {}).items()},
        )


# PartitionMap is keyed by Partition.name (reference api.go:24).
PartitionMap = dict[str, Partition]


@dataclass(frozen=True)
class PartitionModelState:
    """Metadata for one partition state (reference api.go:46-62).

    priority: 0 is highest ("primary" < "replica").
    constraints: how many nodes should hold this state per partition.
    """

    priority: int = 0
    constraints: int = 0


# PartitionModel is keyed by state name (reference api.go:41).
PartitionModel = dict[str, PartitionModelState]


@dataclass(frozen=True)
class HierarchyRule:
    """Rack/zone awareness rule (reference api.go:96-105).

    include_level: ancestors to climb to find the candidate subtree.
    exclude_level: ancestors to climb to find the excluded subtree.
    e.g. include 1 / exclude 0 = "same rack, different node";
    include 2 / exclude 1 = "different rack, same datacenter".
    """

    include_level: int = 0
    exclude_level: int = 0


# HierarchyRules is keyed by state name; value is an ordered rule list, one
# entry consulted per replica ordinal (reference api.go:64-74).
HierarchyRules = dict[str, list[HierarchyRule]]


# Signature of the score-booster hook: (node_weight, stickiness) -> score boost.
# Applied when a node's weight is negative (reference plan.go:675-684,693-697).
NodeScoreBoosterFunc = Callable[[int, float], float]


@dataclass
class PlanOptions:
    """Optional planner knobs (reference api.go:183-190 + package globals).

    The reference exposes ``MaxIterationsPerPlan``, ``CustomNodeSorter`` and
    ``NodeScoreBooster`` as mutable package globals (plan.go:21,580,693); here
    they are per-call options.
    """

    # Override the constraints defined in the model, keyed by state name.
    model_state_constraints: Optional[dict[str, int]] = None
    # Keyed by partition name; default weight 1.
    partition_weights: Optional[dict[str, int]] = None
    # Keyed by state name; default stickiness 1.5.  NOTE (reference quirk,
    # plan.go:104-115): the reference consults state_stickiness only when
    # partition_weights is non-nil; we reproduce that for parity unless
    # ``state_stickiness_standalone`` is set.
    state_stickiness: Optional[dict[str, int]] = None
    # Keyed by node name; default weight 1.  Negative weights trigger the
    # node_score_booster hook.
    node_weights: Optional[dict[str, int]] = None
    # Keyed by node; value is the node's parent in the containment hierarchy.
    node_hierarchy: Optional[dict[str, str]] = None
    # Keyed by state name; replica placement policy.
    hierarchy_rules: Optional[HierarchyRules] = None

    # --- hooks (package globals in the reference) ---
    max_iterations: int = 10  # reference plan.go:21
    node_score_booster: Optional[NodeScoreBoosterFunc] = None  # plan.go:693
    # Custom node scorer: replaces the default score formula entirely.
    # Called as fn(ctx: NodeScoreContext, node: str) -> float; ties still break
    # by node position (reference plan.go:580 CustomNodeSorter).
    node_scorer: Optional[Callable] = None
    # Custom node SORTER: replaces the whole candidate ordering — score
    # AND tie-break policy — like assigning the reference's
    # CustomNodeSorter package var a non-default sort.Interface factory
    # (plan.go:566-580).  Called as fn(ctx: NodeScoreContext,
    # nodes: list[str]) -> list[str]; must return a permutation of
    # ``nodes``.  Takes precedence over node_scorer when both are set.
    node_sorter: Optional[Callable] = None

    # --- compat switches ---
    # When True, state_stickiness applies even without partition_weights
    # (fixes the reference quirk at plan.go:104-115).
    state_stickiness_standalone: bool = False

    # --- backend selection / compilation ---
    # backend="auto" routes to the batched TPU solver when
    # P * N >= this threshold, else the exact native/greedy path.  None =
    # the library default (plan/api.py _AUTO_TPU_THRESHOLD, 256 * 1024 —
    # the crossover point where a device round-trip beats the sequential
    # planner on the calibration hosts).  Deployments with faster
    # interconnects or slower host CPUs should tune this down; tiny
    # embedded runs with no accelerator, up.
    auto_tpu_threshold: Optional[int] = None
    # Opt-in static-shape bucketing for the pure plan_next_map path: pad
    # P and N up to the next size bucket (core/encode.py bucket_size)
    # before the device solve, so repeated calls against a drifting
    # cluster reuse the compiled program instead of recompiling per
    # (P, N).  Pad partitions are weight-0 and pad nodes invalid, so the
    # padded solve's real rows match the unpadded solve's; the padding is
    # stripped before decode.  Off by default: one-shot callers pay the
    # up-to-12.5% padded-FLOPs cost for no reuse benefit.
    shape_bucketing: bool = False
    # Sparse shortlist solver (plan/tensor.solve_sparse): score only a
    # per-partition top-K candidate node list (derived from current
    # placement, hierarchy groups and weights — core/shortlist.py)
    # instead of the dense [P, N] sweep, with fill/price tables kept at
    # full [S, N] width and a per-row dense fallback for exhausted
    # shortlists.  True forces it (requires nesting hierarchy rules:
    # exclude_level < include_level), False forbids it, None = auto —
    # sparse exactly when the dense matrix engine's projected score
    # footprint exceeds the device memory budget.  With a saturating
    # K >= N the sparse result is bit-identical to the dense one.
    sparse: Optional[bool] = None
    # Candidate columns per partition for the sparse solver; None =
    # auto-sized from the constraint structure (core/shortlist.py
    # auto_shortlist_k).  Raise it when plan.sparse.shortlist_exhausted
    # stays nonzero in steady state (docs/DESIGN.md "Sparse solve").
    sparse_k: Optional[int] = None
    # Opt-in fused plan pipeline for the tpu backend: chain
    # encode→solve→move-diff→decode-pack through ONE jitted,
    # buffer-donated device dispatch (plan/tensor.plan_pipeline) instead
    # of the staged encode/solve/decode phases.  The map is bit-identical
    # to the staged path's; the move diff rides along on device (reach it
    # via plan_pipeline or PlannerSession.replan_with_moves to actually
    # consume it).  Off by default: it changes dispatch structure, and
    # one-shot callers with custom hooks fall back anyway.
    fused_pipeline: bool = False

    # --- validation ---
    # Post-solve constraint audit on the batched (tpu) backend: duplicates,
    # placements on removed nodes, unfilled-but-feasible slots surface as
    # UserWarnings (the reference degrades to warnings too, plan.go:231-235).
    # None = auto: on below ~4M P*N cells, off above (the audit is host-side
    # numpy); True/False force it.
    validate_assignment: Optional[bool] = None


def model(**states: tuple[int, int]) -> PartitionModel:
    """Convenience builder: model(primary=(0, 1), replica=(1, 2))."""
    return {
        name: PartitionModelState(priority=pc[0], constraints=pc[1])
        for name, pc in states.items()
    }


def copy_partition(p: Partition) -> Partition:
    return p.copy()


def copy_partition_map(m: PartitionMap) -> PartitionMap:
    """Deep copy (reference plan.go:334-351 toArrayCopy/copyNodesByState)."""
    return {name: p.copy() for name, p in m.items()}


def partition_map_to_json(m: PartitionMap) -> dict:
    return {name: p.to_json() for name, p in m.items()}


def partition_map_from_json(d: Mapping) -> PartitionMap:
    return {name: Partition.from_json(p) for name, p in d.items()}
