# Port of blance_tpu/analysis/__init__.py: only Finding, the two
# device-side passes (retrace, membudget) and the schedule explorer.  The
# lints, the shape audit, the baseline and run_all are not ported
# (ROADMAP A.16).
"""Repo-specific contract checks of the port.

- :mod:`.retrace` — the build contract: per-entry-point ceilings on the
  kernel-library and extension builds a canonical workload triggers,
  counted with ``obs/device.py``'s attributed CompileMonitor (DEV001
  over budget, DEV002 unbudgeted entry, DEV003 a repeated call that
  built again).
- :mod:`.membudget` — the declarative per-entry device-memory ceiling
  table (``HBM_BUDGETS``), checked against the card allocator's peak
  during a real dispatch of each entry (MEM001), plus the table's
  host-only consistency rules (MEM002 drift, MEM003 rows the dense
  guard would reject).
- :mod:`.schedule` — deterministic schedule exploration of the
  orchestrator (the race tier's dynamic half): every scenario of its
  registry runs under seeded random walks and bounded-exhaustive
  enumeration in ``testing.sched``'s controlled loop, checking the
  control plane's dynamic invariants; a violating schedule is written as
  a replayable trace (``python -m blance_tpu_torch.analysis.schedule``).
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["Finding"]


@dataclass(frozen=True)
class Finding:
    """One analysis finding.

    ``symbol`` names what the rule tripped on (an entry label, or
    ``entry@class``); ``line`` is 1 for table-level findings."""

    rule: str  # e.g. "DEV001"
    path: str  # repo-relative, forward slashes
    line: int
    symbol: str
    message: str

    def render(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.path}:{self.line}: {self.rule}{sym}: {self.message}"
