# Copied from blance_tpu/obs/recorder.py.
"""Process-local tracing & metrics core: spans, counters, histograms.

The Recorder is the single funnel every layer reports into (plan encode/
solve/decode, the greedy scorer, the batched move diff, the orchestrator's
per-move lifecycle).  Three primitives:

- **Spans**: nestable timed regions with attributes.  Parent tracking uses
  a ``contextvars.ContextVar``, so nesting is correct both synchronously
  and across asyncio tasks (a task inherits the span that was current when
  it was created, and sibling tasks cannot become each other's parents).
  Spans can also be *manufactured* after the fact (``record_span``) for
  lifecycles whose start predates the code that observes them — e.g. a
  move request's queue-wait time, measured by the mover that dequeues it.
- **Counters**: monotonic named floats (``count``).
- **Gauges**: last-value-wins named floats (``set_gauge``) — the online
  SLO accounting (``obs.slo``) publishes availability/churn/lag here and
  the exposition endpoint (``obs.expo``) serves them.
- **Histograms**: named value series (``observe``) summarized by
  nearest-rank percentiles (p50/p95) — per-move latency, solver sweep
  counts, greedy candidate-list sizes — plus EXACT cumulative bucket
  counts over fixed log-spaced bounds, which is what the Prometheus
  exposition's ``_bucket``/``_sum``/``_count`` series are built from.

The Recorder itself keeps only O(#names) aggregate state: span totals,
counters, gauges, exact histogram stats (count/sum/min/max) and bucket
counts, and a BOUNDED percentile sample — once a series reaches
``_HIST_CAP`` values it is decimated 2:1 and subsequent observations are
systematically subsampled (deterministic, no RNG), so percentiles stay
representative while memory stays flat.  Finished spans are retained
only by attached sinks (``blance_tpu_torch.obs.sinks``); an un-sinked recorder
in a long-running service never grows with traffic.

Timestamps come from the recorder's injectable ``clock`` (default
``time.perf_counter``) in seconds, offset against the recorder's
construction time (``t0``) at export — one consistent monotonic clock
for every span in a process, which is what lets the Chrome-trace
exporter lay host spans on a single timeline next to ``device_profile``
TPU traces captured over the same interval.  Injecting the clock is
what makes telemetry DETERMINISTIC under the controlled virtual-time
loop (``testing.sched.DeterministicLoop``): ``Recorder(clock=loop.time)``
makes every span duration, SLO gauge, and exposition snapshot a pure
function of the (seeded) schedule.
"""

from __future__ import annotations

import bisect
import contextlib
import contextvars
import itertools
import math
import threading
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Iterator, Optional

if TYPE_CHECKING:  # annotation-only
    from ..utils.trace import PhaseTimer
    from .sinks import Sink

__all__ = [
    "Span",
    "Recorder",
    "DEFAULT_BUCKETS",
    "get_recorder",
    "set_recorder",
    "use_recorder",
    "phase_span",
    "counts_recorder",
    "counting_to",
    "percentile",
    "escape_label_value",
]


def escape_label_value(value: str) -> str:
    """Prometheus label-value escaping (backslash, double quote,
    newline) — THE one spelling every labeled-metric emitter uses
    (obs/slo.py node labels, obs/device.py entry/klass labels), so the
    escaping rules cannot drift between emitters.  Arbitrary caller
    strings must not invalidate the whole scrape."""
    return value.replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


@dataclass
class Span:
    """One finished (or in-flight) timed region."""

    name: str
    t_start: float  # perf_counter seconds
    t_end: Optional[float]  # None while in flight
    attrs: dict
    span_id: int
    parent_id: Optional[int]
    task: str  # logical lane (thread/asyncio task/node) for trace viewers
    # Backdated / manufactured spans (explicit t_start, record_span) can
    # partially overlap live spans on their lane — e.g. a move's queue
    # wait starts while the mover is still executing the previous batch.
    # Exporters whose slice format requires strict nesting per lane
    # (Chrome "X" events) must emit these as async events instead.
    overlappable: bool = False

    @property
    def duration_s(self) -> float:
        return (self.t_end or self.t_start) - self.t_start


def percentile(values: list, q: float) -> float:
    """Nearest-rank percentile of an UNSORTED value list.

    rank = ceil(q/100 * n) clamped to [1, n]; q=0 returns the minimum,
    q=100 the maximum.  Deterministic (no interpolation), so summaries
    are stable across platforms and reproducible in tests."""
    if not values:
        raise ValueError("percentile of empty series")
    s = sorted(values)
    rank = max(1, min(len(s), math.ceil(q / 100.0 * len(s))))
    return s[rank - 1]


# Per-series percentile-sample bound: at the cap the sample is decimated
# 2:1 and the subsample stride doubles, so memory stays O(_HIST_CAP) while
# the sample stays spread evenly over the series' whole history.
_HIST_CAP = 4096

# Default histogram bucket upper bounds (``le`` semantics), log-spaced
# 1-2.5-5 per decade from 100 µs to 10k.  Wide on purpose: one fixed set
# covers sub-ms move latencies, solver sweep counts, and candidate-list
# sizes, so EVERY series has exact Prometheus-style bucket counts from
# its first observation without per-name registration (a +Inf bucket is
# implicit).  Override per series with ``Recorder.set_hist_bounds``
# BEFORE the first observation.
DEFAULT_BUCKETS: tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
    500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)


def _current_task_label() -> str:
    """Lane label: the asyncio task name when inside one, else the thread."""
    try:
        import asyncio

        task = asyncio.current_task()
        if task is not None:
            return task.get_name()
    except RuntimeError:
        pass
    return threading.current_thread().name


class Recorder:
    """Span/counter/gauge/histogram recorder with pluggable sinks.

    Thread-safe for aggregate updates (one lock); span parenthood is
    context-local, never locked.  ``sinks`` receive every finished span
    via their ``span(span)`` method; a sink that also defines
    ``counter(name, value, t)`` additionally sees every counter update
    live (the Chrome exporter uses this for time-series counter tracks).

    ``clock`` is the recorder's one time source (monotonic seconds);
    inject ``DeterministicLoop.time`` to run all telemetry — span
    durations, SLO gauges, exposition snapshots — under virtual time."""

    def __init__(self, sinks: tuple = (),
                 clock: Callable[[], float] = time.perf_counter) -> None:
        self._clock = clock
        self.t0 = clock()
        self.sinks: list = list(sinks)
        self.span_totals: dict[str, float] = {}
        self.span_counts: dict[str, int] = {}
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, list[float]] = {}  # bounded sample
        self._hist_stats: dict[str, list] = {}  # [count, sum, min, max]
        self._hist_stride: dict[str, int] = {}
        self._hist_bounds: dict[str, tuple[float, ...]] = {}
        self._hist_buckets: dict[str, list[int]] = {}  # per-bound counts
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        # Sinks that opted into live counter samples, cached at
        # add/remove time so count() — the orchestrator's hottest obs
        # call — never probes hasattr under the lock.
        self._counter_sinks: list = [
            s for s in self.sinks if hasattr(s, "counter")]
        # Per-instance ContextVar: two recorders never share nesting state
        # (tests swap recorders mid-process via use_recorder).
        self._current: contextvars.ContextVar[Optional[Span]] = \
            contextvars.ContextVar(f"obs_span_{id(self)}", default=None)

    def now(self) -> float:
        """The recorder's clock — the one time source every instrumented
        layer should read instead of ``time.perf_counter`` directly, so
        a virtual-time clock injection covers the whole pipeline."""
        return self._clock()

    # -- spans ---------------------------------------------------------------

    def add_sink(self, sink: "Sink") -> None:
        with self._lock:
            self.sinks.append(sink)
            if hasattr(sink, "counter"):
                self._counter_sinks = self._counter_sinks + [sink]

    def remove_sink(self, sink: "Sink") -> None:
        with self._lock:
            if sink in self.sinks:
                self.sinks.remove(sink)
            if sink in self._counter_sinks:
                self._counter_sinks = [
                    s for s in self._counter_sinks if s is not sink]

    def current_span(self) -> Optional[Span]:
        return self._current.get()

    @contextlib.contextmanager
    def span(self, name: str, *, t_start: Optional[float] = None,
             task: Optional[str] = None, **attrs) -> Iterator[Span]:
        """Open a nested span.  ``t_start`` backdates the span (e.g. to a
        request's enqueue time); ``task`` overrides the lane label."""
        parent = self._current.get()
        sp = Span(
            name=name,
            t_start=self._clock() if t_start is None else t_start,
            t_end=None,
            attrs=dict(attrs),
            span_id=next(self._ids),
            parent_id=parent.span_id if parent is not None else None,
            task=task if task is not None else _current_task_label(),
            overlappable=t_start is not None,
        )
        token = self._current.set(sp)
        try:
            yield sp
        finally:
            self._current.reset(token)
            sp.t_end = self._clock()
            self._finish(sp)

    def record_span(self, name: str, t_start: float, t_end: float, *,
                    task: Optional[str] = None, **attrs) -> Span:
        """Record an already-elapsed span (both endpoints known).  Parents
        onto the caller's current span, like a live span would."""
        parent = self._current.get()
        sp = Span(
            name=name, t_start=t_start, t_end=t_end, attrs=dict(attrs),
            span_id=next(self._ids),
            parent_id=parent.span_id if parent is not None else None,
            task=task if task is not None else _current_task_label(),
            overlappable=True,
        )
        self._finish(sp)
        return sp

    def set_attr(self, key: str, value: object) -> None:
        """Attach an attribute to the current span; no-op outside any."""
        sp = self._current.get()
        if sp is not None:
            sp.attrs[key] = value

    def _finish(self, sp: Span) -> None:
        with self._lock:
            self.span_totals[sp.name] = \
                self.span_totals.get(sp.name, 0.0) + sp.duration_s
            self.span_counts[sp.name] = self.span_counts.get(sp.name, 0) + 1
            sinks = list(self.sinks)
        for sink in sinks:
            sink.span(sp)

    # -- counters / gauges / histograms --------------------------------------

    def count(self, name: str, value: float = 1) -> None:
        with self._lock:
            total = self.counters[name] = self.counters.get(name, 0) + value
            # Cached at add/remove-sink time; rebound wholesale there, so
            # grabbing the reference is safe and the common no-hook path
            # stays one dict update under the lock.
            notify = self._counter_sinks
        if notify:
            t = self._clock()
            for sink in notify:
                sink.counter(name, total, t)

    def set_gauge(self, name: str, value: float) -> None:
        """Set a last-value-wins gauge (SLO accounting publishes here;
        the exposition endpoint serves them)."""
        with self._lock:
            self.gauges[name] = float(value)

    def sample(self, name: str, value: float,
               t: Optional[float] = None) -> None:
        """One time-stamped series point: recorded as a histogram
        observation (aggregates) AND forwarded to counter-capable sinks
        as a Chrome counter-track sample at time ``t`` (default: now).
        This is how a value-over-time series that is neither monotone
        (counter) nor last-value (gauge) — e.g. the per-sweep
        accepted-bid fraction — gets a track on the span timeline."""
        self.observe(name, value)
        notify = self._counter_sinks
        if notify:
            tt = self._clock() if t is None else t
            for sink in notify:
                sink.counter(name, float(value), tt)

    def set_hist_bounds(self, name: str, bounds: tuple[float, ...]) -> None:
        """Override the bucket upper bounds for one series.  Must happen
        before the series' first observation — bucket counts are exact
        by construction and cannot be re-binned after the fact."""
        with self._lock:
            if name in self._hist_stats:
                raise ValueError(
                    f"histogram {name!r} already has observations; bucket "
                    f"bounds must be set before the first observe()")
            self._hist_bounds[name] = tuple(sorted(float(b) for b in bounds))

    def observe(self, name: str, value: float) -> None:
        v = float(value)
        with self._lock:
            st = self._hist_stats.get(name)
            if st is None:
                st = self._hist_stats[name] = [0, 0.0, v, v]
            st[0] += 1
            st[1] += v
            if v < st[2]:
                st[2] = v
            if v > st[3]:
                st[3] = v
            # Exact per-bound bucket counts (le semantics; the final slot
            # is the +Inf bucket).  Incremental here, cumulated at export.
            bounds = self._hist_bounds.get(name, DEFAULT_BUCKETS)
            buckets = self._hist_buckets.get(name)
            if buckets is None:
                buckets = self._hist_buckets[name] = [0] * (len(bounds) + 1)
            buckets[bisect.bisect_left(bounds, v)] += 1
            # Bounded percentile sample: systematic 1-in-stride subsample,
            # stride doubling on each 2:1 decimation at the cap.
            stride = self._hist_stride.get(name, 1)
            if (st[0] - 1) % stride == 0:
                series = self.histograms.setdefault(name, [])
                series.append(v)
                if len(series) >= _HIST_CAP:
                    del series[::2]
                    self._hist_stride[name] = stride * 2

    # -- summaries -----------------------------------------------------------

    def histogram_buckets(
            self, name: str) -> Optional[tuple[tuple[float, ...],
                                               list[int], int, float]]:
        """(bounds, cumulative counts incl. +Inf, count, sum) for one
        series, or None if never observed.  Counts are EXACT (every
        observation lands in exactly one bucket), so the exposition's
        ``_bucket``/``_count``/``_sum`` agree by construction."""
        with self._lock:
            buckets = self._hist_buckets.get(name)
            if buckets is None:
                return None
            st = self._hist_stats[name]
            bounds = self._hist_bounds.get(name, DEFAULT_BUCKETS)
            cum: list[int] = []
            running = 0
            for c in buckets:
                running += c
                cum.append(running)
            return bounds, cum, st[0], st[1]

    def histogram_summary(self, name: str) -> Optional[dict]:
        with self._lock:
            st = self._hist_stats.get(name)
            values = list(self.histograms.get(name, ()))
        if st is None or not values:
            return None
        return {
            "count": st[0],
            "sum": st[1],
            "min": st[2],
            "max": st[3],
            "p50": percentile(values, 50),
            "p95": percentile(values, 95),
        }

    def summary(self) -> dict:
        """Everything aggregate, JSON-serializable: per-span-name totals,
        counters, gauges, and histogram percentile summaries — the block
        bench.py embeds into its artifact."""
        with self._lock:
            spans = {
                name: {"total_s": self.span_totals[name],
                       "count": self.span_counts[name]}
                for name in sorted(self.span_totals)
            }
            counters = {k: self.counters[k] for k in sorted(self.counters)}
            gauges = {k: self.gauges[k] for k in sorted(self.gauges)}
            hist_names = sorted(self.histograms)
        return {
            "spans": spans,
            "counters": counters,
            "gauges": gauges,
            "histograms": {
                name: self.histogram_summary(name) for name in hist_names
            },
        }


# -- process-global recorder --------------------------------------------------

_global_recorder = Recorder()


def get_recorder() -> Recorder:
    """The process-local recorder every instrumented layer reports to."""
    return _global_recorder


def set_recorder(recorder: Recorder) -> Recorder:
    """Swap the process recorder; returns the previous one."""
    global _global_recorder
    prev = _global_recorder
    _global_recorder = recorder
    return prev


@contextlib.contextmanager
def use_recorder(recorder: Recorder) -> Iterator[Recorder]:
    """Temporarily install ``recorder`` as the process recorder (tests)."""
    prev = set_recorder(recorder)
    try:
        yield recorder
    finally:
        set_recorder(prev)


class _Dropped:
    """Takes counts and keeps none."""

    def count(self, name: str, value: float = 1) -> None:
        pass


# Context-local: a solve running in a worker thread of the plan service
# counts where its caller asked, whatever the process recorder is.
_counts_to: contextvars.ContextVar = contextvars.ContextVar(
    "obs_counts_to", default=None)


def counts_recorder():
    """Where the solver counts its own work (its auction rounds and host
    syncs): the recorder ``counting_to`` names in this context, else the
    process recorder."""
    return _counts_to.get() or _global_recorder


@contextlib.contextmanager
def counting_to(recorder: Optional[Recorder]) -> Iterator[None]:
    """Send the solver's counts inside the body to ``recorder``, or drop
    them when it is None (a solve asked to record nothing)."""
    token = _counts_to.set(_Dropped() if recorder is None else recorder)
    try:
        yield
    finally:
        _counts_to.reset(token)


@contextlib.contextmanager
def phase_span(name: str, timer: Optional["PhaseTimer"] = None,
               phase: Optional[str] = None,
               **attrs: object) -> Iterator[Span]:
    """Recorder span that ALSO accumulates into a PhaseTimer.

    The instrumented pipeline names spans hierarchically ("plan.encode")
    while PhaseTimer callers keep their short phase keys ("encode", the
    default: the last dot segment) — one timed region, two views, no
    double-recorded span."""
    rec = get_recorder()
    start = rec.now()
    try:
        with rec.span(name, **attrs) as sp:
            yield sp
    finally:
        if timer is not None:
            timer._accumulate(phase or name.rsplit(".", 1)[-1],
                              rec.now() - start)
