# Port of blance_tpu/obs/device.py: the same public names and entry
# attribution; the instruments count what the port does on the card
# (kernel-library builds and loads, measured dispatches) in place of
# XLA's compile log and AOT cost analysis.
"""Device-side performance observatory: build accounting, dispatch costs,
sweep traces.

Three instruments, all fed through the port's Recorder:

- **Build accounting** (:class:`CompileMonitor`).  The port compiles
  nothing per shape: its "compiles" are the builds and first loads of
  its native code, the kernel libraries (``ops/_build.py``, one ``nvcc``
  per ``ops/csrc/*.cu``) and the host extensions
  (``utils/nativebuild.py``: gcc for the marshal, g++ for the exact
  planner).  Each build, and each first load in the process of a
  library no build of this process made, is one event, attributed to
  the OWNING ENTRY POINT via the :func:`entry` contextvar the dispatch
  sites set (``solve_dense`` cold/warm/bucketed, the fleet batches, the
  pipelines, the rank sweep, the sharded dispatches ``sharded.cold`` /
  ``sharded.warm`` / ``sharded.pipeline`` / ``sparse.sharded.cold`` /
  ``sparse.sharded.warm``, whose worker ranks build in their own
  processes): ``device.compiles{entry=...}`` counters
  and ``device.compile_s{entry=...}`` histograms.  A warm process — one
  that has loaded every library it calls — counts 0, whatever shapes
  it solves.  The per-entry budgets live in ``analysis/retrace.py``.
- **Dispatch cost and memory gauges** (:func:`measure`).  The
  first dispatch per (entry, klass) — memoized, so steady state pays
  nothing — is measured live: ``device.peak_alloc_bytes``, the peak the
  caching allocator reached during the dispatch above what it held
  before, plus the dispatch's own tensor operands on the card
  (``torch.cuda.reset_peak_memory_stats`` before, a synchronize and
  ``torch.cuda.max_memory_allocated`` after; not published on the CPU,
  which has no allocator statistics), and ``device.flops`` /
  ``device.hbm_bytes``, the kernel work per dispatch: the operations
  and bytes of every kernel call the dispatch made, counted by the
  per-kernel formulas of ``ops/cost.py`` (the same ones
  ``chip_smoke.py``'s ``bound_ms`` uses).  They count the hand-written
  kernels only, not the PyTorch operations around them; no
  whole-program count exists here.  ``device.cost_analyses`` counts the
  publications.  Resetting the peak statistics is process-global, so
  a measured dispatch resets the peak any other reader was tracking.
- **Sweep-level convergence traces** (:func:`record_sweep_trace`).  With
  the trace armed, the converged solve counts each sweep's changed rows
  on the device, reads the counts back once after its loop, and this
  module emits the fractions as a ``device.sweep_accept_frac`` Chrome
  counter track, interpolated across the solve's host span.

Everything is OFF by default: the attribution contextvars always run (a
token swap), but no monitor counts, no dispatch is synchronized or
measured, no peak is reset and the solver keeps no sweep counts until
:func:`enable`.

CLI (the device-obs gate)::

    python -m blance_tpu_torch.obs.device_check --check [--device cpu]
        [--trace-out PATH]

runs the retrace-budget workload and a cost smoke (on the card unless
``--device cpu``) and exits nonzero when a budget is blown or a gauge
was not published; ``--trace-out`` captures the run as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import Any, Callable, Iterator, Optional

from .recorder import Recorder, escape_label_value as _lbl, get_recorder

__all__ = [
    "entry",
    "current_entry",
    "CompileMonitor",
    "enable",
    "disable",
    "enabled",
    "cost_enabled",
    "sweep_trace_enabled",
    "maybe_publish_cost",
    "measure",
    "cost_summaries",
    "reset_cost_cache",
    "record_sweep_trace",
    "main",
]


# -- entry-point attribution --------------------------------------------------

_entry_var: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("blance_torch_device_entry", default=None)

# Fallback classification for builds outside any entry scope (a kernel
# check, the encode's marshal extension).
_DEFAULT_ENTRY = "other"


@contextlib.contextmanager
def entry(label: str) -> Iterator[None]:
    """Attribute every build inside the body to ``label``.

    FIRST WINS: a nested entry (solve_dense_converged inside the
    bucketed plan path) does not re-label the outer scope — the
    outermost dispatch site owns the build.  Always active (a contextvar
    swap), whether or not a monitor is installed."""
    if _entry_var.get() is not None:
        yield
        return
    token = _entry_var.set(label)
    try:
        yield
    finally:
        _entry_var.reset(token)


def current_entry() -> str:
    """The owning entry label for a build happening right now."""
    return _entry_var.get() or _DEFAULT_ENTRY


def ambient_entry() -> Optional[str]:
    """The enclosing entry scope, or None outside any — for inner
    layers whose OWN label must yield to an outer dispatch site's (the
    bucketed plan path labels solve_dense_converged's cost gauges)."""
    return _entry_var.get()


# -- the build monitor --------------------------------------------------------

# Installed monitors; the build sites call note_compile(), which fans the
# event out to each.
_MONITORS: list["CompileMonitor"] = []
_MONITORS_LOCK = threading.Lock()


def note_compile(fn_name: str, secs: float) -> None:
    """One build (or first load) of ``fn_name`` that took ``secs``, on
    the calling thread: counted by every installed monitor under the
    entry scope open here.  Opens no scope of its own."""
    if not _MONITORS:
        return
    with _MONITORS_LOCK:
        monitors = list(_MONITORS)
    for mon in monitors:
        mon._on_compile(fn_name)
        mon._on_compile_done(fn_name, secs)


class CompileMonitor:
    """Process-wide build counter with entry attribution.

    Use as a context manager around a stage or install the
    process-global one via :func:`enable`.  ``emit=True`` additionally
    publishes every event to the CURRENT recorder
    (``device.compiles{entry=}`` counter, ``device.compile_s{entry=}``
    histogram) — stage-local monitors keep ``emit=False`` so a stage
    nested inside the global observatory never double-counts.

    Counts are exact per attribution scope; thread-safe (a build can
    happen on an executor thread — the fleet service's solve path)."""

    def __init__(self, emit: bool = False) -> None:
        self.emit = emit
        self.by_entry: dict[str, int] = {}
        self.by_fn: dict[str, int] = {}
        self.compile_s_by_entry: dict[str, float] = {}
        self._lock = threading.Lock()

    # -- event fan-in (called from note_compile) -----------------------------

    def _on_compile(self, fn_name: str) -> None:
        ent = current_entry()
        with self._lock:
            self.by_entry[ent] = self.by_entry.get(ent, 0) + 1
            self.by_fn[fn_name] = self.by_fn.get(fn_name, 0) + 1
        if self.emit:
            get_recorder().count(
                f'device.compiles{{entry="{_lbl(ent)}"}}')

    def _on_compile_done(self, fn_name: str, secs: float) -> None:
        ent = current_entry()
        with self._lock:
            self.compile_s_by_entry[ent] = \
                self.compile_s_by_entry.get(ent, 0.0) + secs
        if self.emit:
            get_recorder().observe(
                f'device.compile_s{{entry="{_lbl(ent)}"}}', secs)

    # -- lifecycle ------------------------------------------------------------

    def install(self) -> "CompileMonitor":
        with _MONITORS_LOCK:
            if self not in _MONITORS:
                _MONITORS.append(self)
        return self

    def uninstall(self) -> None:
        with _MONITORS_LOCK:
            if self in _MONITORS:
                _MONITORS.remove(self)

    def __enter__(self) -> "CompileMonitor":
        return self.install()

    def __exit__(self, *exc: object) -> None:
        self.uninstall()

    # -- summaries ------------------------------------------------------------

    @property
    def total(self) -> int:
        with self._lock:
            return sum(self.by_entry.values())

    def summary(self) -> dict:
        """JSON-ready stage summary."""
        with self._lock:
            return {
                "total": sum(self.by_entry.values()),
                "by_entry": dict(sorted(self.by_entry.items())),
                "compile_s_by_entry": {
                    k: round(v, 4)
                    for k, v in sorted(self.compile_s_by_entry.items())},
            }


# -- the process-global observatory ------------------------------------------

_state: dict[str, Any] = {
    "monitor": None,  # the emit=True process monitor, when enabled
    "cost": False,
    "sweep_trace": False,
}
_state_lock = threading.Lock()


def enable(cost_analysis: bool = True, sweep_trace: bool = True) -> None:
    """Switch the observatory ON process-wide: install the emitting
    build monitor and (optionally) arm the dispatch cost measurement
    and the sweep trace.  Idempotent."""
    with _state_lock:
        if _state["monitor"] is None:
            _state["monitor"] = CompileMonitor(emit=True).install()
        _state["cost"] = bool(cost_analysis)
        _state["sweep_trace"] = bool(sweep_trace)


def disable() -> None:
    """Switch the observatory OFF."""
    with _state_lock:
        mon = _state["monitor"]
        if mon is not None:
            mon.uninstall()
        _state["monitor"] = None
        _state["cost"] = False
        _state["sweep_trace"] = False


def enabled() -> bool:
    return _state["monitor"] is not None


def cost_enabled() -> bool:
    return bool(_state["cost"])


def sweep_trace_enabled() -> bool:
    return bool(_state["sweep_trace"])


def monitor() -> Optional[CompileMonitor]:
    """The process-global monitor (None while disabled)."""
    mon: Optional[CompileMonitor] = _state["monitor"]
    return mon


# -- dispatch cost & memory gauges --------------------------------------------

# (entry, klass) -> summary dict: the first-dispatch memo.  Bounded by
# the entry x shape-class product, which bucketing keeps small.
_COST_CACHE: dict[tuple[str, str], dict] = {}
_COST_LOCK = threading.Lock()


def reset_cost_cache() -> None:
    with _COST_LOCK:
        _COST_CACHE.clear()


def forget_cost(ent: str, klass: str) -> None:
    """Drop one (entry, klass) from the memo, so its next dispatch is
    measured again (the membudget check measures each row afresh)."""
    with _COST_LOCK:
        _COST_CACHE.pop((ent, klass), None)


def cost_summaries() -> dict:
    """{entry: {klass: summary}} for everything published so far."""
    out: dict[str, dict[str, dict]] = {}
    with _COST_LOCK:
        items = list(_COST_CACHE.items())
    for (ent, klass), summary in sorted(items):
        out.setdefault(ent, {})[klass] = summary
    return out


def _operand_bytes(values, device) -> int:
    """Bytes of the tensors among ``values`` (one level of tuples and
    lists, NamedTuples included) that live on ``device``."""
    import torch

    total = 0
    for v in values:
        items = v if isinstance(v, (tuple, list)) else (v,)
        for t in items:
            if isinstance(t, torch.Tensor) and t.device == device:
                total += t.numel() * t.element_size()
    return total


@contextlib.contextmanager
def measure(ent: str, klass: str, device: Any,
            operands: tuple = ()) -> Iterator[None]:
    """Measure the dispatch in the body the first time per (entry,
    klass) with cost measurement armed.

    Unarmed, or for a memoized key, this does nothing: no synchronize,
    no peak reset.  Armed, the first dispatch on a CUDA ``device``
    synchronizes and resets the card's peak statistics (process-global)
    on entry, and on exit synchronizes and publishes
    ``device.peak_alloc_bytes`` (the allocator's peak above what it held
    on entry, plus the tensors among ``operands`` already on the card);
    on any device it publishes ``device.flops`` / ``device.hbm_bytes``
    (the kernel work the body made, ops/cost.py) — gauges labeled
    ``{entry=,klass=}`` on the current recorder — and counts
    ``device.cost_analyses``.  A body that raises publishes nothing and
    stays unmemoized."""
    key = (ent, klass)
    if not cost_enabled():
        yield
        return
    with _COST_LOCK:
        memoized = key in _COST_CACHE
    if memoized:
        yield
        return
    import torch

    from ..ops import cost as _cost

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with _cost.tally() as work:
        yield
    summary: dict[str, Any] = {"flops": float(work[1]),
                               "hbm_bytes": float(work[0])}
    if on_card:
        torch.cuda.synchronize(dev)
        summary["peak_alloc_bytes"] = float(
            torch.cuda.max_memory_allocated(dev) - before
            + _operand_bytes(operands, dev))
    with _COST_LOCK:
        if key in _COST_CACHE:  # a concurrent first dispatch won
            return
        _COST_CACHE[key] = summary
    rec = get_recorder()
    labels = f'{{entry="{_lbl(ent)}",klass="{_lbl(klass)}"}}'
    rec.set_gauge(f"device.flops{labels}", summary["flops"])
    rec.set_gauge(f"device.hbm_bytes{labels}", summary["hbm_bytes"])
    if "peak_alloc_bytes" in summary:
        rec.set_gauge(f"device.peak_alloc_bytes{labels}",
                      summary["peak_alloc_bytes"])
    rec.count("device.cost_analyses")


def maybe_publish_cost(ent: str, klass: str, device: Any,
                       fn: Callable[..., Any], *args: Any,
                       **kwargs: Any) -> Any:
    """The reference's call shape: ``fn(*args, **kwargs)`` under
    :func:`measure`, its arguments the measured operands."""
    with measure(ent, klass, device, (*args, *kwargs.values())):
        return fn(*args, **kwargs)


# -- sweep-level convergence traces -------------------------------------------


def record_sweep_trace(rec: Recorder, t0: float, t1: float,
                       sweeps: int, fracs: Any) -> None:
    """Emit one solve's per-sweep accepted-bid fractions as a Chrome
    counter track (``device.sweep_accept_frac``).

    The counts are read back once after the fixpoint loop, so per-sweep
    host timestamps do not exist; samples are INTERPOLATED evenly across
    the solve's host interval [t0, t1] — the track then sits under the
    solve's span (and its device_profile slices) with the right number
    of steps, which is the alignment that matters for reading
    convergence shape in Perfetto."""
    n = int(sweeps)
    if n <= 0:
        return
    span = max(t1 - t0, 0.0)
    for i in range(n):
        t = t0 + span * (i + 1) / n
        rec.sample("device.sweep_accept_frac", float(fracs[i]), t=t)


# -- CLI: the device-obs gate -------------------------------------------------


def main(argv: Optional[list[str]] = None) -> int:
    """``python -m blance_tpu_torch.obs.device_check --check``: the
    retrace-budget workload + a cost smoke, with an optional Chrome
    trace of the run."""
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m blance_tpu_torch.obs.device_check",
        description="device-side observatory checks")
    ap.add_argument("--check", action="store_true",
                    help="run the retrace-budget workload + a cost smoke; "
                         "exit nonzero on failure")
    ap.add_argument("--device", default="cuda",
                    help="where the workload runs (default: the card; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the run's spans + counter tracks as a "
                         "Chrome trace")
    args = ap.parse_args(argv)
    if not args.check:
        ap.print_help()
        return 2

    from ..analysis.retrace import run_retrace_check
    from ..convert import resolve_device
    from .chrome import trace
    from .recorder import use_recorder

    dev = resolve_device(args.device, "device_check")
    rec = Recorder()
    failures: list[str] = []
    with use_recorder(rec):
        enable(cost_analysis=True, sweep_trace=True)
        reset_cost_cache()
        ctx = trace(args.trace_out, recorder=rec) if args.trace_out \
            else contextlib.nullcontext()
        try:
            with ctx:
                counts: dict = {}
                findings, entries = run_retrace_check(device=dev,
                                                      counts=counts)
                print(f"device-obs: builds by entry {counts['by_entry']}, "
                      f"added by calls 2-4 {counts['repeated']}",
                      file=sys.stderr)
                for f in findings:
                    failures.append(f.render())
                    print(f.render(), file=sys.stderr)
                # Cost smoke: the workload dispatched every entry with
                # cost measurement armed, so each entry's gauges must be
                # live — kernel work everywhere, the allocator's peak on
                # the card.
                for name in ("device.flops", "device.hbm_bytes") + (
                        ("device.peak_alloc_bytes",)
                        if dev.type == "cuda" else ()):
                    vals = [v for k, v in rec.gauges.items()
                            if k.startswith(name + "{")]
                    if not vals or not any(v > 0 for v in vals):
                        failures.append(f"cost smoke: no nonzero {name} "
                                        f"gauge published")
                if not rec.histogram_summary("device.sweep_accept_frac"):
                    failures.append("sweep trace: no "
                                    "device.sweep_accept_frac sample")
        finally:
            disable()
    print(f"device-obs: {entries} budget entries on {dev.type}, "
          f"{len(failures)} failure(s)"
          + (" — FAIL" if failures else " — OK"), file=sys.stderr)
    return 1 if failures else 0
