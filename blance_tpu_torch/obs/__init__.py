"""blance_tpu_torch.obs: the port's own process recorder and the telemetry
of blance_tpu/obs.

One process-local :class:`Recorder` (``get_recorder()``), separate from
the reference package's, receives the port's spans, counters and
histograms: ``plan.*`` spans and the ``plan.solve.*`` convergence
counters from the planner, ``moves.calc_all_moves`` / ``moves.encode`` /
``moves.device_diff`` / ``moves.materialize`` spans with the
``moves.total_ops`` and ``moves.irregular_partitions`` counters from the
batched diff, and from the orchestrator the ``orchestrate.move``
lifecycle spans, ``orchestrate.move_latency_s`` and every progress
counter as ``orchestrate.tot_*``.  ``slo.SloTracker`` keeps the online
SLO gauges of a rebalance and ``costmodel.CostModel`` the per-(node, op)
move costs the critical-path scheduler prices moves with.

Sinks decide retention (``sinks.InMemorySink``, ``sinks.JsonlSink``,
``chrome.ChromeTraceSink``); ``chrome.trace(path)`` captures a region
into a chrome://tracing / Perfetto-loadable file, with
``utils.trace.device_profile`` (torch.profiler) over the same interval
when given a log dir.  ``expo.MetricsServer`` serves Prometheus text
format from Recorder snapshots (``expo.default_registry()`` is the one
declarative table of every metric; ``PORT_ONLY_TELEMETRY`` names the
spans and counters the port records beyond the reference's).
``tracectx`` stamps plan-service requests.

The DEVICE side has its own observatory (``device``, opt-in via
``device.enable()``): kernel-library and extension builds counted per
owning entry point, the first dispatch per (entry, shape class)
measured for its kernel work and the card's peak allocation, and the
converged solve's per-sweep changed-row fractions as a counter track.
"""

from . import device
from .chrome import ChromeTraceSink, trace, write_chrome_trace
from .costmodel import CostModel
from .expo import (
    PORT_ONLY_COUNTERS,
    PORT_ONLY_SPANS,
    PORT_ONLY_TELEMETRY,
    Metric,
    MetricsRegistry,
    MetricsServer,
    default_registry,
    parse_prometheus,
    render_prometheus,
    scrape,
)
from .recorder import (
    DEFAULT_BUCKETS,
    Recorder,
    Span,
    counting_to,
    counts_recorder,
    get_recorder,
    percentile,
    phase_span,
    set_recorder,
    use_recorder,
)
from .sinks import InMemorySink, JsonlSink, span_to_dict
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
    "device",
    "TraceContext",
    "TraceIdSource",
    "RequestTimeline",
    "SEGMENTS",
    "current_trace",
    "use_trace",
    "Recorder",
    "Span",
    "DEFAULT_BUCKETS",
    "get_recorder",
    "set_recorder",
    "use_recorder",
    "phase_span",
    "counts_recorder",
    "counting_to",
    "percentile",
    "InMemorySink",
    "JsonlSink",
    "span_to_dict",
    "ChromeTraceSink",
    "write_chrome_trace",
    "trace",
    "PORT_ONLY_SPANS",
    "PORT_ONLY_COUNTERS",
    "PORT_ONLY_TELEMETRY",
    "Metric",
    "MetricsRegistry",
    "MetricsServer",
    "default_registry",
    "render_prometheus",
    "parse_prometheus",
    "scrape",
    "MoveObserver",
    "SloSummary",
    "SloTracker",
    "CostModel",
]
