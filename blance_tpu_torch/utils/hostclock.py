# Copied from blance_tpu/utils/hostclock.py.
"""The injectable host perf-clock seam.

Host-phase timing — solver host milliseconds (``plan.service``), the
fleet planner's encode/decode phases (``fleetloop``), simulator
``wall_s`` (``testing.simulate`` / ``testing.fleetsim``) and
``PhaseTimer`` totals — is *observability about this run of the
program*, not replayed state: none of it may feed a canonical log or
journal, and all of it needs a real wall clock in production.  Instead
of sprinkling ``time.perf_counter()`` through replay-rooted modules
(every call a separate allowlist entry for the determinism lint), those
sites read :func:`perf_now` — ONE declared boundary where wall-clock
enters replay-rooted code (``analysis/determinism.py`` ``CLOCK_SEAMS``).

The default clock is ``time.perf_counter``; tests inject a fake via
:func:`perf_clock` to make host-phase accounting itself deterministic.
The injection point is process-global on purpose: host-phase timing is
diagnostic, a test that wants a frozen clock wants it frozen everywhere,
and the sites it feeds are single-threaded control-plane code.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterator, Optional

__all__ = ["perf_now", "set_perf_clock", "perf_clock"]

_clock: Callable[[], float] = time.perf_counter


def perf_now() -> float:
    """Current host perf-clock reading (seconds; monotonic under the
    default clock).  Differences are host-phase durations."""
    return _clock()


def set_perf_clock(
        clock: Optional[Callable[[], float]]) -> Callable[[], float]:
    """Install ``clock`` as the process perf clock (``None`` restores
    ``time.perf_counter``); returns the previously installed clock."""
    global _clock
    prev = _clock
    _clock = time.perf_counter if clock is None else clock
    return prev


@contextlib.contextmanager
def perf_clock(clock: Callable[[], float]) -> Iterator[None]:
    """Scoped clock injection: install ``clock``, restore on exit."""
    prev = set_perf_clock(clock)
    try:
        yield
    finally:
        set_perf_clock(prev)
