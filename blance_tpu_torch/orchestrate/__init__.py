# Copied from blance_tpu/orchestrate/__init__.py.
"""blance_tpu_torch.orchestrate — asyncio rebalance control plane."""

from .csp import GET, PUT, Chan, ChanClosed, select
from .faults import FaultInjected, FaultPlan, NodeFaults
from .health import HALF_OPEN, HEALTHY, QUARANTINED, HealthTracker, NodeHealth
from .sched import (
    CriticalPathScheduler,
    LegacyWeightOrder,
    SchedulePlan,
    SchedulerPolicy,
)
from .orchestrator import (
    MOVE_OP_WEIGHT,
    ErrorInterrupt,
    ErrorStopped,
    MissingMoverError,
    MoveFailure,
    MoveTimeoutError,
    NextMoves,
    NodeQuarantinedError,
    Orchestrator,
    OrchestratorOptions,
    OrchestratorProgress,
    PartitionMove,
    lowest_weight_partition_move_for_node,
    orchestrate_moves,
)

__all__ = [
    "GET",
    "PUT",
    "Chan",
    "ChanClosed",
    "select",
    "FaultInjected",
    "FaultPlan",
    "NodeFaults",
    "HEALTHY",
    "QUARANTINED",
    "HALF_OPEN",
    "HealthTracker",
    "NodeHealth",
    "MOVE_OP_WEIGHT",
    "ErrorInterrupt",
    "ErrorStopped",
    "MissingMoverError",
    "MoveFailure",
    "MoveTimeoutError",
    "NextMoves",
    "NodeQuarantinedError",
    "Orchestrator",
    "OrchestratorOptions",
    "OrchestratorProgress",
    "PartitionMove",
    "lowest_weight_partition_move_for_node",
    "orchestrate_moves",
    "CriticalPathScheduler",
    "LegacyWeightOrder",
    "SchedulePlan",
    "SchedulerPolicy",
]
