"""blance_tpu_torch — the PyTorch/CUDA port of blance_tpu's planner.

The cold-solve paths of blance_tpu (``plan_next_map(...,
backend="tpu")``) on PyTorch: the dense engines and the sparse shortlist
engine, with the three TPU kernels on those paths rewritten as CUDA C++
kernels for Hopper (``ops/csrc``).  The package
imports ``torch`` and never ``jax`` or ``blance_tpu``: the jax-free data
model, encode/decode and audit are its own copies.  Entry points run on
``device="cuda"`` unless the caller asks for the CPU, where every kernel
runs its plain PyTorch version.
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
from .convert import assign_to_numpy, problem_to_torch, score_inputs_to_torch
from .plan.api import cbgt_node_score_booster, plan_next_map
from .plan.audit import check_assignment, maybe_validate
from .plan.tensor import (
    plan_next_map_cuda,
    resolve_fused_score,
    set_dense_score_budget,
    set_fused_score_default,
    solve_converged_resilient,
    solve_dense,
    solve_dense_converged,
    solve_sparse,
)

__all__ = [
    "DenseProblem", "HierarchyRule", "HierarchyRules", "Partition",
    "PartitionMap", "PartitionModel", "PartitionModelState", "PlanOptions",
    "assign_to_numpy", "cbgt_node_score_booster", "check_assignment",
    "copy_partition_map", "decode_assignment", "encode_problem",
    "maybe_validate", "model", "partition_map_from_json",
    "partition_map_to_json", "plan_next_map", "plan_next_map_cuda",
    "problem_to_torch", "resolve_fused_score", "score_inputs_to_torch",
    "set_dense_score_budget", "set_fused_score_default",
    "solve_converged_resilient", "solve_dense", "solve_dense_converged",
    "solve_sparse",
]
