"""blance_tpu_torch.obs: the port's own process recorder and the host side
of blance_tpu/obs.

One process-local :class:`Recorder` (``get_recorder()``), separate from
the reference package's, receives the port's spans, counters and
histograms: ``moves.calc_all_moves`` / ``moves.encode`` /
``moves.device_diff`` / ``moves.materialize`` spans with the
``moves.total_ops`` and ``moves.irregular_partitions`` counters from the
batched diff, and from the orchestrator the ``orchestrate.move`` lifecycle
spans, ``orchestrate.move_latency_s`` and every progress counter as
``orchestrate.tot_*``.  ``slo.SloTracker`` keeps the online SLO gauges of a
rebalance and ``costmodel.CostModel`` the per-(node, op) move costs the
critical-path scheduler prices moves with.

Copies of the jax-free modules of blance_tpu/obs (recorder, sinks,
costmodel, slo, and ``tracectx``, the request tracing the plan service
stamps each request with).  The reference's XLA compile observatory
(``device``), Chrome-trace export (``chrome``) and exposition server
(``expo``) are ROADMAP A.10.
"""

from .costmodel import CostModel
from .recorder import Recorder, get_recorder, set_recorder, use_recorder
from .slo import MoveObserver, SloSummary, SloTracker
from .tracectx import (
    SEGMENTS,
    RequestTimeline,
    TraceContext,
    TraceIdSource,
    current_trace,
    use_trace,
)

__all__ = [
    "CostModel",
    "MoveObserver",
    "Recorder",
    "RequestTimeline",
    "SEGMENTS",
    "SloSummary",
    "SloTracker",
    "TraceContext",
    "TraceIdSource",
    "current_trace",
    "get_recorder",
    "set_recorder",
    "use_recorder",
    "use_trace",
]
