# Port of blance_tpu/analysis/__init__.py: the same passes, run_lints,
# run_all and AnalysisResult over the port's package; run_all takes the
# device the shape audit, retrace and membudget checks run on.
"""Repo-specific contract checks of the port: the static layer and its
device-side companions.

The solver's correctness rests on invariants no generic tool checks:
host purity and stable tie-break bits on the device paths of
``plan/tensor.py`` (the warm-replan identity contract), cancellation- and
waiter-safety in ``orchestrate/`` (the cancelled-waiter bug class), the
warm carry's single-use contract, and the ``[P, S, N, R]`` shape
conventions that otherwise live only in comments.  The reference guards
its package with these passes; this is the same gate over the port:

- :mod:`.jit_purity` — AST lint over functions reachable from the
  declared ``DEVICE_ROOTS``: host nondeterminism (torch's global
  generator included), forced device syncs, captured-state mutation.
- :mod:`.asyncio_lint` — AST lint over the asyncio control plane:
  fire-and-forget tasks, blocking calls in ``async def``, silent broad
  exception swallows, un-deadlined app-callback awaits.
- :mod:`.race_lint` — await-atomicity race lint over the control
  plane's declared shared state (RACE0xx).
- :mod:`.determinism` — taint-style replay-contract lint over code
  reachable from the declared ``REPLAY_ROOTS`` (DET00x).
- :mod:`.donation` — use-after-consume lint over the declared
  ``CONSUMING`` table: the warm carry is single-use (DON00x).
- :mod:`.shape_audit` — the declarative shape-contract table for the
  solver's entry points, each run on a small concrete problem on the
  audit's device (the card by default), plus four host checks.
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
- :mod:`.baseline` — the accepted-findings allowlist
  (``analysis/baseline.toml``): pre-existing findings are pinned with a
  reason; any NEW finding fails the build.

CLI: ``python -m blance_tpu_torch.analysis [--ci] [--device DEV]`` (see
__main__.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Iterable, Optional

__all__ = [
    "Finding",
    "run_lints",
    "run_all",
    "PACKAGE_ROOT",
    "REPO_ROOT",
]

# The package directory the lints walk by default, and the repo root the
# paths in findings/baseline entries are relative to.
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PACKAGE_ROOT)


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


@dataclass
class AnalysisResult:
    """Findings split by baseline status, plus bookkeeping for the CLI."""

    new: list[Finding]  # non-baselined findings (these fail the build)
    baselined: list[tuple[Finding, str]]  # (finding, reason) pairs
    # BaselineEntry objects that matched nothing (typed loosely: the
    # baseline module is imported lazily to keep the editor loop light)
    unused_baseline: list[Any]
    checked_files: int = 0
    shape_entries: int = 0
    retrace_entries: int = 0
    membudget_entries: int = 0
    # shape contract label -> seconds (build + run on the audit device)
    shape_timings: dict[str, float] = field(default_factory=dict)
    # analyzer crashes (fatal)
    errors: list[str] = field(default_factory=list)


def _iter_py_files(paths: Iterable[str]) -> list[str]:
    out: list[str] = []
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            out.append(p)
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                # The analysis package lints the product code, not itself
                # (its own fixtures would trip the rules by design), and
                # never descends into build trash.
                dirs[:] = [d for d in dirs if d not in
                           ("__pycache__", "_native_build", "analysis")]
                for f in sorted(files):
                    if f.endswith(".py"):
                        out.append(os.path.join(root, f))
    return out


def run_lints(
        paths: Optional[list[str]] = None,
        determinism_only: bool = False,
        donation_only: bool = False) -> tuple[list[Finding], int]:
    """Run the AST passes over ``paths`` (default: the package).

    Returns (findings, checked_file_count).  Pure host work — safe to
    call from anywhere (no device touched, no torch import).  ``determinism_only`` /
    ``donation_only`` are the ``--determinism`` / ``--donation`` CLI
    modes: just that one pass.
    """
    from .asyncio_lint import lint_file as asyncio_lint_file
    from .determinism import DeterminismPass
    from .donation import DonationPass
    from .jit_purity import JitPurityPass
    from .race_lint import lint_file as race_lint_file

    files = _iter_py_files(paths or [PACKAGE_ROOT])
    findings: list[Finding] = []
    run_every = not determinism_only and not donation_only
    # jit purity, determinism and donation need the whole module set up
    # front (cross-module call resolution); the asyncio and race lints
    # are per-file (the race lint's shared-state model keys on class
    # names, so it is inert outside the control plane by construction).
    if run_every:
        jit_pass = JitPurityPass(files, repo_root=REPO_ROOT)
        findings.extend(jit_pass.run())
    if not donation_only:
        findings.extend(DeterminismPass(files, repo_root=REPO_ROOT).run())
    if not determinism_only:
        findings.extend(DonationPass(files, repo_root=REPO_ROOT).run())
    if run_every:
        for f in files:
            findings.extend(asyncio_lint_file(f, repo_root=REPO_ROOT))
            findings.extend(race_lint_file(f, repo_root=REPO_ROOT))
    findings.sort(key=lambda x: (x.path, x.line, x.rule))
    return findings, len(files)


def run_all(
    paths: Optional[list[str]] = None,
    baseline_path: Optional[str] = None,
    shape_audit: bool = True,
    retrace: bool = False,
    membudget: bool = False,
    determinism_only: bool = False,
    donation_only: bool = False,
    device: Any = "cuda",
) -> AnalysisResult:
    """Lints + (optionally) the shape audit, the build-budget check and
    the HBM-budget check, the last three on ``device`` (the card unless
    the caller asks for the CPU), folded through the baseline.  The CLI
    and the CI gate both call this."""
    from .baseline import Baseline

    findings, nfiles = run_lints(paths, determinism_only=determinism_only,
                                 donation_only=donation_only)
    shape_entries = 0
    retrace_entries = 0
    membudget_entries = 0
    shape_timings: dict[str, float] = {}
    errors: list[str] = []
    if shape_audit:
        from .shape_audit import run_shape_audit

        try:
            shape_findings, shape_entries = run_shape_audit(
                device=device, timings=shape_timings)
            findings.extend(shape_findings)
        except Exception as e:  # an analyzer crash is itself a failure
            errors.append(f"shape audit crashed: {type(e).__name__}: {e}")
    if retrace:
        from .retrace import run_retrace_check

        try:
            retrace_findings, retrace_entries = run_retrace_check(
                device=device)
            findings.extend(retrace_findings)
        except Exception as e:
            errors.append(
                f"retrace check crashed: {type(e).__name__}: {e}")
    if membudget:
        from .membudget import run_membudget_check

        try:
            mb_findings, membudget_entries = run_membudget_check(
                device=device)
            findings.extend(mb_findings)
        except Exception as e:
            errors.append(
                f"membudget check crashed: {type(e).__name__}: {e}")

    if baseline_path is None:
        baseline_path = os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "baseline.toml")
    baseline = Baseline.load(baseline_path)
    new, accepted = baseline.split(findings)
    return AnalysisResult(
        new=new,
        baselined=accepted,
        unused_baseline=baseline.unused(),
        checked_files=nfiles,
        shape_entries=shape_entries,
        retrace_entries=retrace_entries,
        membudget_entries=membudget_entries,
        shape_timings=shape_timings,
        errors=errors,
    )
