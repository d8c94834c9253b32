# Copied from blance_tpu/utils/trace.py; device_profile wraps
# torch.profiler where the reference wraps jax.profiler.
"""Lightweight tracing/profiling for planner and orchestrator phases.

The reference has no tracing (SURVEY.md §5); its observability surface is
the orchestrator progress stream.  Here, in addition to that stream, the
framework exposes:

- ``PhaseTimer``: wall-clock phase timing with a queryable report — kept
  as a thin compatibility shim over ``blance_tpu_torch.obs``: every phase is
  also recorded as a Recorder span (and annotations land on the current
  span), so legacy PhaseTimer callers feed the unified trace for free
  while ``report()`` output stays byte-identical to the pre-obs shape.
- ``device_profile``: context manager around torch.profiler (the card's
  kernels and copies beside the host's operations), exported as a
  Chrome trace viewable in Perfetto.  It marks the profile at its start
  and end with two clock anchors (``ANCHOR_START``, ``ANCHOR_END``), so
  a host clock's times can be moved onto the profiler's (``obs.chrome``
  merges the recorder's spans so).
"""

from __future__ import annotations

import contextlib
import itertools
import os
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional

from ..obs import get_recorder
from .hostclock import perf_now

__all__ = ["PhaseTimer", "DeviceProfile", "device_profile", "ANCHOR_START",
           "ANCHOR_END"]


@dataclass
class PhaseTimer:
    """Accumulates wall-clock per named phase; phases may repeat.

    ``annotations`` carries non-timing facts a caller wants surfaced with
    the timing report — e.g. which score engine the solve actually ran
    after auto-selection/fallback (tensor.solve_converged_resilient)."""

    totals: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        start = perf_now()
        try:
            with get_recorder().span(name):
                yield
        finally:
            self._accumulate(name, perf_now() - start)

    def _accumulate(self, name: str, elapsed: float) -> None:
        """Fold one elapsed interval into the report totals — the piece of
        the old phase() that is NOT the span; obs.phase_span uses it to
        time a region once while publishing both views."""
        self.totals[name] = self.totals.get(name, 0.0) + elapsed
        self.counts[name] = self.counts.get(name, 0) + 1

    def annotate(self, key: str, value: str) -> None:
        self.annotations[key] = value
        get_recorder().set_attr(key, value)

    def report(self) -> dict[str, dict]:
        out: dict = {
            name: {"total_s": self.totals[name], "count": self.counts[name]}
            for name in self.totals
        }
        if self.annotations:
            out["annotations"] = dict(self.annotations)
        return out

    def __str__(self) -> str:
        parts = [
            f"{name}: {self.totals[name]*1000:.1f}ms x{self.counts[name]}"
            for name in sorted(self.totals, key=self.totals.get, reverse=True)
        ]
        parts += [f"{k}={v}" for k, v in sorted(self.annotations.items())]
        return "; ".join(parts)


_PROFILES = itertools.count()

# The profile's clock anchors: ``record_function`` ranges opened right
# after a read of the host clock, as the profiler starts and as it stops.
ANCHOR_START = "obs.anchor.start"
ANCHOR_END = "obs.anchor.end"


@dataclass
class DeviceProfile:
    """What ``device_profile`` yields.  Once the body has run: ``path``,
    the exported trace (None when nothing was profiled), and
    ``anchors``, the host clock's reading at each anchor by name."""

    path: Optional[str] = None
    anchors: dict[str, float] = field(default_factory=dict)


def _anchor(into: DeviceProfile, name: str,
            clock: Callable[[], float]) -> None:
    import torch

    t = clock()
    with torch.profiler.record_function(name):
        pass
    into.anchors[name] = t


@contextlib.contextmanager
def device_profile(log_dir: Optional[str],
                   clock: Callable[[], float] = perf_now
                   ) -> Iterator[DeviceProfile]:
    """torch.profiler over the body: CPU and CUDA activities when a card
    is present (CPU only without one), exported on exit — also when the
    body raises — as a Chrome trace ``trace.<pid>.<n>.json`` in
    ``log_dir``.  Yields a ``DeviceProfile``: the trace's path and the
    ``clock``'s reading at the two anchors the profile holds (its first
    and last ranges), which place that clock's times on the profile's.

    Inert when ``log_dir`` is None or a profiler is already active (the
    documented no-op cases).  Any other failure to start raises on a
    machine with a card, so a run that was asked for a device trace
    never passes without one; without a card it warns and the body runs
    unprofiled."""
    out = DeviceProfile()
    if not log_dir:
        yield out
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    if torch.autograd.profiler._is_profiler_enabled:
        yield out
        return
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = None
    try:
        os.makedirs(log_dir, exist_ok=True)
        prof = profile(activities=acts)
        prof.__enter__()
    except Exception as e:
        if cuda:
            raise
        prof = None
        import warnings

        warnings.warn(
            f"device_profile: profiler failed to start "
            f"({type(e).__name__}: {e}); continuing without a trace",
            RuntimeWarning, stacklevel=3)
    if prof is not None:
        # The first range pays the profiler's set-up; the anchor is the
        # range after it.
        with torch.profiler.record_function("obs.anchor.warmup"):
            pass
        _anchor(out, ANCHOR_START, clock)
    # Guard only profiler startup: the body's own exceptions propagate
    # unchanged.
    try:
        yield out
    finally:
        if prof is not None:
            if cuda:
                torch.cuda.synchronize()
            _anchor(out, ANCHOR_END, clock)
            prof.__exit__(None, None, None)
            out.path = os.path.join(
                log_dir, f"trace.{os.getpid()}.{next(_PROFILES)}.json")
            prof.export_chrome_trace(out.path)
