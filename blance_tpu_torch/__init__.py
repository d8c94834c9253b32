"""blance_tpu_torch — the PyTorch/CUDA port of blance_tpu.

Plan, diff and orchestrate on PyTorch:

- the planner's cold-solve paths (``plan_next_map(..., backend="cuda")``):
  the dense engines and the sparse shortlist engine, with the three TPU
  kernels on those paths rewritten as CUDA C++ kernels for Hopper
  (``ops/csrc``), and shape bucketing (``PlanOptions.shape_bucketing``:
  inert padding to a static bucket, the real partition count threaded to
  the fill term as ``p_real``);
- the exact planners: ``backend="greedy"`` (``plan_next_map_greedy``) and
  ``backend="native"`` (the same algorithm in C++, ``native/planner.cpp``,
  built with the host's g++ at first use); ``backend="auto"`` picks
  native for small problems and the card for large ones, and custom
  placement hooks on the "cuda" backend run on the exact path;
- warm delta replans: ``PlannerSession`` keeps the solver's auction state
  (``SolveCarry``, held in a ``CarryCache``) between replans, so a delta
  replan runs one carry-seeded repair sweep (``solve_dense_warm``,
  ``solve_sparse_warm``) and falls back to the cold solve when the repair
  leaks outside the delta;
- the move diff: ``calc_all_moves`` diffs whole maps on the device
  (``moves/batch.py``), ``calc_partition_moves`` is its host oracle;
- the fused plan pipeline: ``plan_pipeline`` (and
  ``PlannerSession.replan_with_moves``) runs the solve, the move diff and
  the decode pack on the device and brings them back in one copy, bitwise
  the staged plan + ``calc_all_moves``;
- the native marshal path: host encode and decode run their dict/list
  traversals in a C extension (``native/marshal.c``, built with the
  host's gcc at first use; ``core.marshal.available()``), with the
  pure-Python path as the fallback;
- the orchestrator (``orchestrate_moves``) that executes a transition
  against the app's data-plane callback, and the rebalance facade
  (``rebalance``, ``rebalance_async``, ``RebalanceController``) that runs
  plan -> diff -> orchestrate.

The package imports ``torch`` and never ``jax`` or ``blance_tpu``: the
jax-free data model, encode/decode, audit, orchestrator and host side of
obs are its own copies.  Entry points run on ``device="cuda"`` unless the
caller asks for the CPU, where every kernel runs its plain PyTorch
version.
"""

from .core.types import (
    HierarchyRule,
    HierarchyRules,
    Partition,
    PartitionMap,
    PartitionModel,
    PartitionModelState,
    PlanOptions,
    copy_partition_map,
    model,
    partition_map_from_json,
    partition_map_to_json,
)
from .core.encode import DenseProblem, decode_assignment, encode_problem
from .core.order import flatten_nodes_by_state, sort_state_names
from .plan.greedy import (
    NodeScoreContext,
    count_state_nodes,
    default_node_score,
    plan_next_map_greedy,
)
from .core.setops import (
    strings_dedup,
    strings_intersect,
    strings_remove,
    strings_to_set,
)
from .convert import (
    assign_to_numpy,
    carry_to_numpy,
    carry_to_torch,
    problem_to_torch,
    score_inputs_to_torch,
)
from .plan.api import (
    cbgt_node_score_booster,
    plan_next_map,
    plan_next_map_legacy,
)
from .plan.audit import check_assignment, maybe_validate
from .moves.batch import calc_all_moves
from .moves.calc import NodeStateOp, calc_partition_moves
from .orchestrate import OrchestratorOptions, orchestrate_moves
from .rebalance import (
    ClusterDelta,
    RebalanceController,
    RebalanceResult,
    RecoveryRound,
    load_partition_map,
    rebalance,
    rebalance_async,
    save_partition_map,
)
from .plan.carry import CarryCache
from .plan.session import PlannerSession
from .plan.tensor import (
    SolveCarry,
    carry_from_assignment,
    plan_next_map_cuda,
    plan_pipeline,
    resolve_fused_score,
    set_dense_score_budget,
    set_fused_score_default,
    solve_converged_resilient,
    solve_dense,
    solve_dense_converged,
    solve_dense_warm,
    solve_sparse,
    solve_sparse_warm,
)

__all__ = [
    "CarryCache", "ClusterDelta", "DenseProblem", "HierarchyRule",
    "HierarchyRules", "NodeScoreContext", "NodeStateOp",
    "OrchestratorOptions", "Partition",
    "PartitionMap", "PartitionModel", "PartitionModelState", "PlanOptions",
    "PlannerSession", "RebalanceController", "RebalanceResult",
    "RecoveryRound", "SolveCarry", "assign_to_numpy", "calc_all_moves",
    "calc_partition_moves", "carry_from_assignment", "carry_to_numpy",
    "carry_to_torch", "cbgt_node_score_booster", "check_assignment",
    "copy_partition_map", "count_state_nodes", "decode_assignment",
    "default_node_score", "encode_problem", "flatten_nodes_by_state",
    "load_partition_map", "maybe_validate", "model", "orchestrate_moves",
    "partition_map_from_json", "partition_map_to_json", "plan_next_map",
    "plan_next_map_cuda", "plan_next_map_greedy", "plan_next_map_legacy",
    "plan_pipeline", "problem_to_torch", "rebalance", "rebalance_async",
    "resolve_fused_score", "save_partition_map", "score_inputs_to_torch",
    "set_dense_score_budget", "set_fused_score_default",
    "solve_converged_resilient", "solve_dense", "solve_dense_converged",
    "solve_dense_warm", "solve_sparse", "solve_sparse_warm",
    "sort_state_names", "strings_dedup", "strings_intersect",
    "strings_remove", "strings_to_set",
]
