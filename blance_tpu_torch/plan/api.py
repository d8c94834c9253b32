"""Public planning entry point of the port, with backend selection.

``plan_next_map`` mirrors blance_tpu.plan.api.plan_next_map (the
reference's PlanNextMapEx, api.go:147-157).  Backends:

- "greedy": the exact sequential planner (plan/greedy.py), the semantics
  oracle, on the host;
- "native": the same algorithm with its hot loop in C++ (plan/native.py
  and native/planner.cpp, built with the host's g++ at first use),
  bit-identical to "greedy"; it runs "greedy" itself for hooks the C++
  core does not model or when the library cannot be built;
- "cuda": the cost-tensor planner (plan/tensor.py) on ``device``: a
  dense engine, or the sparse shortlist engine when ``PlanOptions.sparse``
  asks for it or (``sparse=None``) when the dense footprint would exceed
  the memory budget.  Custom placement hooks the device score cannot
  express run on the exact path instead (``engine="exact-fallback"``);
- "auto": "native" below ``_AUTO_TPU_THRESHOLD`` cells (partitions x
  nodes), or below ``PlanOptions.auto_tpu_threshold`` when set, and
  "cuda" at and above it, as the reference routes.  It resolves
  ``device`` first at every size, so "auto" with the default
  ``device="cuda"`` raises on a machine without a card.

``PlanOptions.fused_pipeline`` routes a "cuda" plan through the fused
pipeline (plan/tensor.py ``plan_pipeline``), whose map is bitwise the
staged path's.  Every call records the reference's ``plan.plan_next_map``
span with the resolved ``backend`` and the ``requested`` one.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from ..convert import resolve_device
from ..core.types import (
    HierarchyRules,
    PartitionMap,
    PartitionModel,
    PlanOptions,
)
from ..obs import get_recorder
from .greedy import plan_next_map_greedy
from .native import cbgt_node_score_booster

if TYPE_CHECKING:  # annotation-only
    from ..utils.trace import PhaseTimer

__all__ = ["plan_next_map", "plan_next_map_legacy",
           "cbgt_node_score_booster"]

# Below this many (partitions x nodes) cells backend="auto" plans on the
# exact native planner, at and above it on the card; the reference's
# constant, overridden per deployment by PlanOptions.auto_tpu_threshold.
_AUTO_TPU_THRESHOLD = 256 * 1024


def _resolve_backend(backend: str, partitions: int, nodes: int,
                     opts: PlanOptions) -> str:
    """The backend a plan_next_map call runs on: ``backend`` itself, or
    for "auto" "native" below the cell threshold and "cuda" at and above
    it."""
    if backend not in ("greedy", "native", "cuda", "auto"):
        raise ValueError(f"unknown backend: {backend!r}")
    if backend != "auto":
        return backend
    threshold = (_AUTO_TPU_THRESHOLD if opts.auto_tpu_threshold is None
                 else int(opts.auto_tpu_threshold))
    return "cuda" if partitions * nodes >= threshold else "native"


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
    """Compute the next balanced partition map.

    Returns (next_map, warnings), warnings keyed by partition name
    (constraint shortfalls degrade to warnings, reference
    plan.go:231-235).  ``device`` is where the "cuda" backend solves;
    the exact backends plan on the host.  ``sparse=None`` picks the
    sparse engine once the dense matrix engine's projected footprint
    passes the budget and the rules nest.  ``timings`` receives the
    "cuda" backend's phase wall times, the engine and its counts of the
    staged path (see plan_next_map_cuda); ``timer`` (utils.trace.
    PhaseTimer) attributes wall-clock to encode / solve / decode, or with
    ``fused_pipeline`` to encode / dispatch / decode."""
    if model is None:
        raise ValueError("model is required")
    opts = opts or PlanOptions()
    requested = backend
    backend = _resolve_backend(backend, len(partitions_to_assign),
                               len(nodes_all), opts)
    if requested == "auto":
        # A small problem plans on the host, but the caller asked for
        # ``device``: without the card that raises here, not later.
        resolve_device(device, "plan_next_map")

    with get_recorder().span(
            "plan.plan_next_map", backend=backend, requested=requested,
            partitions=len(partitions_to_assign), nodes=len(nodes_all)):
        if backend == "greedy":
            return plan_next_map_greedy(
                prev_map, partitions_to_assign, nodes_all,
                nodes_to_remove, nodes_to_add, model, opts)
        if backend == "native":
            from .native import plan_next_map_native  # may compile

            return plan_next_map_native(
                prev_map, partitions_to_assign, nodes_all,
                nodes_to_remove, nodes_to_add, model, opts)
        from .tensor import plan_next_map_cuda, plan_pipeline

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


def plan_next_map_legacy(
    prev_map: PartitionMap,
    partitions_to_assign: PartitionMap,
    nodes_all: list[str],
    nodes_to_remove: Optional[list[str]],
    nodes_to_add: Optional[list[str]],
    model: PartitionModel,
    model_state_constraints: Optional[dict[str, int]] = None,
    partition_weights: Optional[dict[str, int]] = None,
    state_stickiness: Optional[dict[str, int]] = None,
    node_weights: Optional[dict[str, int]] = None,
    node_hierarchy: Optional[dict[str, str]] = None,
    hierarchy_rules: Optional["HierarchyRules"] = None,
    backend: str = "greedy",
) -> tuple[PartitionMap, dict[str, list[str]]]:
    """Positional-options compatibility shim mirroring the reference's
    deprecated PlanNextMap signature (api.go:109-132), with its
    "greedy" default; prefer plan_next_map with PlanOptions."""
    return plan_next_map(
        prev_map, partitions_to_assign, nodes_all,
        nodes_to_remove, nodes_to_add, model,
        PlanOptions(
            model_state_constraints=model_state_constraints,
            partition_weights=partition_weights,
            state_stickiness=state_stickiness,
            node_weights=node_weights,
            node_hierarchy=node_hierarchy,
            hierarchy_rules=hierarchy_rules,
        ),
        backend=backend,
    )
