# Copied from blance_tpu/utils/trace.py (PhaseTimer only: device_profile
# wraps jax.profiler and waits for ROADMAP A.10 as torch.profiler).
"""Lightweight tracing/profiling for planner and orchestrator phases.

The reference has no tracing (SURVEY.md §5); its observability surface is
the orchestrator progress stream.  Here, in addition to that stream, the
framework exposes:

- ``PhaseTimer``: wall-clock phase timing with a queryable report — kept
  as a thin compatibility shim over ``blance_tpu_torch.obs``: every phase is
  also recorded as a Recorder span (and annotations land on the current
  span), so legacy PhaseTimer callers feed the unified trace for free
  while ``report()`` output stays byte-identical to the pre-obs shape.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Iterator

from ..obs import get_recorder
from .hostclock import perf_now

__all__ = ["PhaseTimer"]


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
