# Copied from blance_tpu/obs/tracectx.py.
"""End-to-end request tracing: trace contexts + latency decomposition.

A :class:`TraceContext` is minted where a request enters the system
(``PlanService.submit``) and rides the request through coalescing,
executor hand-off and the fleet batch dispatch, so one tenant's latency
decomposes into named segments — in Perfetto (each request gets a
``req:<trace_id>`` lane with one span per segment) and as
``fleet.request_segment_s{segment=...}`` histograms on the exposition
endpoint.

Design constraints, in order:

- **Determinism.**  Trace ids come from a per-:class:`TraceIdSource`
  counter — never ``uuid``/``random`` — so a seeded run under the PR-5
  ``DeterministicLoop`` mints the same ids in the same order, and the
  whole telemetry plane (ids included) is a pure function of the
  schedule.
- **Exact decomposition.**  A :class:`RequestTimeline` is an ordered
  list of named timestamps on ONE clock (the owning Recorder's); each
  segment is the difference of two adjacent marks, so the segments
  tile the request's lifetime exactly — no gaps, no overlaps — and
  their sum telescopes to the end-to-end latency.
- **Zero cost off the request path.**  The context is a frozen
  dataclass, the timeline a list of (name, float) pairs; nothing here
  touches jax, sockets, or wall clocks.

The contextvar pair (:func:`current_trace` / :func:`use_trace`) lets
deeper layers (the fleet dispatch span) read the ambient context
without threading it through every signature.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
from dataclasses import dataclass
from typing import TYPE_CHECKING, Iterator, Optional

if TYPE_CHECKING:  # annotation-only
    from .recorder import Recorder

__all__ = [
    "TraceContext",
    "TraceIdSource",
    "RequestTimeline",
    "SEGMENTS",
    "current_trace",
    "use_trace",
]


# The canonical decomposition of one plan-service request, in lifecycle
# order.  Each name labels the segment that ENDS at the mark of the same
# name (docs/OBSERVABILITY.md "Request decomposition"):
#   admission       — queue wait: submit() until the dispatcher dequeues
#   coalesce        — the admission window: dequeue until the batch closes
#   executor_queue  — batch closed until the solver actually starts
#   device          — the fleet batch solve itself
#   resolve         — solve done until the request's future resolves
SEGMENTS = ("admission", "coalesce", "executor_queue", "device", "resolve")


@dataclass(frozen=True)
class TraceContext:
    """One request's identity: ``trace_id`` names the end-to-end trace,
    ``parent_id`` the minting hop (None at the root).  Frozen — a child
    hop gets a NEW context via :meth:`child`, never a mutation."""

    trace_id: str
    parent_id: Optional[str] = None

    def child(self, hop: str) -> "TraceContext":
        """A derived context for a sub-operation (``hop`` suffixes the
        id so children stay unique AND deterministic)."""
        return TraceContext(trace_id=f"{self.trace_id}/{hop}",
                            parent_id=self.trace_id)


class TraceIdSource:
    """Deterministic trace-id mint: ``prefix-000001``, ``prefix-000002``,
    ... per source instance.  Each PlanService owns one, so two seeded
    runs of the same scenario mint identical ids in identical order."""

    def __init__(self, prefix: str = "req") -> None:
        self._prefix = prefix
        self._n = itertools.count(1)

    def mint(self) -> TraceContext:
        return TraceContext(trace_id=f"{self._prefix}-{next(self._n):06d}")


_current: contextvars.ContextVar[Optional[TraceContext]] = \
    contextvars.ContextVar("blance_trace_ctx", default=None)


def current_trace() -> Optional[TraceContext]:
    """The ambient trace context, if any hop set one."""
    return _current.get()


@contextlib.contextmanager
def use_trace(ctx: TraceContext) -> Iterator[TraceContext]:
    """Install ``ctx`` as the ambient trace context for the body."""
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


class RequestTimeline:
    """Ordered named timestamps decomposing one request's latency.

    ``mark(name, t)`` closes the segment called ``name`` at time ``t``
    (times come from the owning Recorder's clock — virtual under
    ``DeterministicLoop``).  ``record`` emits the whole decomposition:
    one ``fleet.request`` span covering the request end-to-end, one
    ``fleet.request.<segment>`` span per segment (all on the request's
    own ``req:<trace_id>`` lane, so Perfetto shows the tiling), and one
    ``fleet.request_segment_s{segment=...}`` histogram observation per
    segment.  Every span carries ``trace_id`` (and ``parent_id`` when
    set), which is what lands in JSONL sink lines.
    """

    __slots__ = ("ctx", "marks")

    def __init__(self, ctx: TraceContext, t_submit: float) -> None:
        self.ctx = ctx
        self.marks: list[tuple[str, float]] = [("submit", t_submit)]

    def mark(self, name: str, t: float) -> None:
        self.marks.append((name, t))

    @property
    def t_submit(self) -> float:
        return self.marks[0][1]

    def segments(self) -> list[tuple[str, float]]:
        """(segment name, duration) pairs — adjacent-mark differences,
        so they tile [t_submit, t_last] exactly."""
        out: list[tuple[str, float]] = []
        for (_, t_prev), (name, t) in zip(self.marks, self.marks[1:]):
            out.append((name, t - t_prev))
        return out

    def record(self, rec: "Recorder", **attrs: object) -> None:
        """Emit the decomposition (spans + histograms) to ``rec``."""
        if len(self.marks) < 2:
            return
        lane = f"req:{self.ctx.trace_id}"
        ids: dict[str, object] = {"trace_id": self.ctx.trace_id}
        if self.ctx.parent_id is not None:
            ids["trace_parent_id"] = self.ctx.parent_id
        t_prev = self.marks[0][1]
        seg_attrs: dict[str, object] = {}
        for name, t in self.marks[1:]:
            rec.record_span(f"fleet.request.{name}", t_prev, t,
                            task=lane, **ids)
            rec.observe(f'fleet.request_segment_s{{segment="{name}"}}',
                        t - t_prev)
            seg_attrs[f"{name}_s"] = t - t_prev
            t_prev = t
        rec.record_span("fleet.request", self.marks[0][1], t_prev,
                        task=lane, **ids, **seg_attrs, **attrs)
