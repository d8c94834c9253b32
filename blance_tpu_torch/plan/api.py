"""Public planning entry point of the port.

``plan_next_map`` mirrors blance_tpu.plan.api.plan_next_map (the
reference's PlanNextMapEx, api.go:147-157) for the batched planner:

- "cuda": the cost-tensor planner (plan/tensor.py) on ``device``: a
  dense engine, or the sparse shortlist engine when ``PlanOptions.sparse``
  asks for it or (``sparse=None``) when the dense footprint would exceed
  the memory budget;
- "auto": "cuda" at every size, because the exact greedy and native
  backends, which the reference's auto picks for small problems, are not
  ported yet (ROADMAP queue A).

``PlanOptions.fused_pipeline`` routes the plan through the fused pipeline
(plan/tensor.py ``plan_pipeline``), whose map is bitwise the staged
path's.  Every call records the reference's ``plan.plan_next_map`` span.

Options the port cannot honor yet raise NotImplementedError naming the
ROADMAP item that ports them.  There is no silent fallback.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from ..core.types import PartitionMap, PartitionModel, PlanOptions
from ..obs import get_recorder

if TYPE_CHECKING:  # annotation-only
    from ..utils.trace import PhaseTimer

__all__ = ["plan_next_map", "cbgt_node_score_booster"]


def cbgt_node_score_booster(weight: int, stickiness: float) -> float:
    """The booster couchbase/cbgt installs (control_test.go:19-29): the
    shape max(-weight, stickiness) the batched score implements."""
    return max(float(-weight), stickiness)


cbgt_node_score_booster.__blance_native__ = "cbgt"  # type: ignore[attr-defined]


def _unsupported(opts: PlanOptions) -> Optional[str]:
    """Why the port cannot plan with these options yet, or None."""
    if opts.node_scorer is not None or opts.node_sorter is not None:
        return ("custom node_scorer/node_sorter hooks need the exact "
                "greedy/native backends (ROADMAP A.11)")
    booster = opts.node_score_booster
    if booster is not None and \
            getattr(booster, "__blance_native__", None) != "cbgt":
        return ("a non-cbgt node_score_booster needs the exact "
                "greedy/native backends (ROADMAP A.11)")
    if booster is None and opts.node_weights and \
            any(w < 0 for w in opts.node_weights.values()):
        return ("negative node weights without the cbgt booster need the "
                "exact greedy/native backends (ROADMAP A.11)")
    if opts.shape_bucketing:
        return "PlanOptions.shape_bucketing is not ported (ROADMAP A.13)"
    return None


def plan_next_map(
    prev_map: PartitionMap,
    partitions_to_assign: PartitionMap,
    nodes_all: list[str],
    nodes_to_remove: Optional[list[str]] = None,
    nodes_to_add: Optional[list[str]] = None,
    model: Optional[PartitionModel] = None,
    opts: Optional[PlanOptions] = None,
    backend: str = "cuda",
    device="cuda",
    timings: Optional[dict] = None,
    timer: Optional["PhaseTimer"] = None,
) -> tuple[PartitionMap, dict[str, list[str]]]:
    """Compute the next balanced partition map on ``device``.

    Returns (next_map, warnings), warnings keyed by partition name
    (constraint shortfalls degrade to warnings, reference
    plan.go:231-235).  ``sparse=None`` picks the sparse engine once the
    dense matrix engine's projected footprint passes the budget and the
    rules nest.  ``timings`` receives the phase wall times, the engine
    and its counts of the staged path (see plan_next_map_cuda); ``timer``
    (utils.trace.PhaseTimer) attributes wall-clock to encode / solve /
    decode, or with ``fused_pipeline`` to encode / dispatch / decode."""
    if model is None:
        raise ValueError("model is required")
    if backend not in ("cuda", "auto"):
        raise ValueError(f"unknown backend: {backend!r}")
    opts = opts or PlanOptions()
    why = _unsupported(opts)
    if why is not None:
        raise NotImplementedError(why)
    from .tensor import plan_next_map_cuda, plan_pipeline

    with get_recorder().span(
            "plan.plan_next_map", backend="cuda", requested=backend,
            partitions=len(partitions_to_assign), nodes=len(nodes_all)):
        if opts.fused_pipeline:
            next_map, warnings, _ = plan_pipeline(
                prev_map, partitions_to_assign, nodes_all, nodes_to_remove,
                nodes_to_add, model, opts, timer, want_moves=False,
                device=device)
            return next_map, warnings
        return plan_next_map_cuda(
            prev_map, partitions_to_assign, nodes_all, nodes_to_remove,
            nodes_to_add, model, opts, timer, device=device,
            timings=timings)
