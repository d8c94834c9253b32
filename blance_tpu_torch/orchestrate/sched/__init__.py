# Copied from blance_tpu/orchestrate/sched/__init__.py.
"""blance_tpu_torch.orchestrate.sched — critical-path move scheduling.

The orchestrator executes a flat per-partition move list; this package
decides the ORDER, turning the list into a scheduled execution plan
that minimizes rebalance makespan instead of leaving it to fall out of
per-node concurrency by accident (docs/SCHEDULER.md; arxiv 1711.01912
"it's the critical path!").

- :mod:`.dag` — the move-DAG builder: per-partition state-transition
  chains (never run the ``del`` before its ``add`` completed,
  promote-after-replica-build) plus per-node concurrency lanes
  (``max_concurrent_partition_moves_per_node`` as machine capacity).
- :mod:`.ranks` — upward-rank (critical-path) priorities over the
  leveled DAG: a level sweep on the device for large move sets, a
  host fallback below the size threshold.
- :mod:`.policy` — the scheduler interface the orchestrator binds:
  :class:`LegacyWeightOrder` (the reference's app-weight order,
  extracted verbatim — the pinned default) and
  :class:`CriticalPathScheduler` (HEFT-style earliest-finish list
  scheduling on calibrated ``CostModel.predict_move`` costs, with
  online rescheduling when the health breaker quarantines a node).
"""

from .dag import DagMove, MoveDag, MoveDagError, build_move_dag
from .policy import (
    MOVE_OP_WEIGHT,
    BoundScheduler,
    CriticalPathScheduler,
    LegacyWeightOrder,
    ScheduledMove,
    SchedulePlan,
    SchedulerPolicy,
    list_schedule,
    lowest_weight_partition_move_for_node,
)
from .ranks import upward_ranks

__all__ = [
    "DagMove",
    "MoveDag",
    "MoveDagError",
    "build_move_dag",
    "MOVE_OP_WEIGHT",
    "BoundScheduler",
    "CriticalPathScheduler",
    "LegacyWeightOrder",
    "ScheduledMove",
    "SchedulePlan",
    "SchedulerPolicy",
    "list_schedule",
    "lowest_weight_partition_move_for_node",
    "upward_ranks",
]
