# Copied from blance_tpu/obs/expo.py; the smoke takes --device.
"""Streaming metrics exposition: a Prometheus text-format endpoint.

The Recorder alone is post-hoc — spans and histograms readable only
after the run.  This module makes telemetry a live subsystem: an
asyncio HTTP endpoint serves the Recorder's aggregates in the
Prometheus text format (version 0.0.4, the stable subset every scraper
parses), so a long-running rebalance serving real traffic is
observable WHILE it executes.  Three pieces:

- :class:`MetricsRegistry` — the single declarative table of every
  metric the pipeline emits: internal dotted name, type (counter /
  gauge / histogram), and help string.  ``default_registry()`` builds
  the port's table (plan, moves, orchestrate, rebalance, slo,
  costmodel groups; the ``orchestrate.tot_*`` progress mirror is
  generated from ``OrchestratorProgress``'s own fields so the mirror
  can never drift from the dataclass).  The drift-guard test pins this
  table against both the names actually emitted during a pipeline run
  and the metric table in docs/OBSERVABILITY.md.
- :func:`render_prometheus` — one Recorder snapshot rendered as
  exposition text.  Counters get a ``_total`` suffix; histograms render
  cumulative ``_bucket{le=...}`` / ``_sum`` / ``_count`` series straight
  off the Recorder's EXACT bucket counts; gauges render last-value
  samples, including labeled families (a gauge key of the form
  ``name{label="x"}`` carries its label set through verbatim).  Every
  DECLARED metric is rendered (zero-valued when never emitted), so a
  scrape is a complete, stable schema from the first request.
- :class:`MetricsServer` — a minimal asyncio HTTP/1.1 server for
  ``GET /metrics``.  Renders are throttled to one Recorder snapshot per
  ``min_interval_s`` (scrapes between snapshots serve the cached text),
  and ``collectors`` callables run before each snapshot — the SLO
  tracker's ``publish`` hook plugs in there so time-derived gauges
  (convergence lag) are fresh per snapshot.

Pure asyncio + stdlib; no sockets are touched until ``start()``, and
``render_prometheus`` needs no event loop at all — the virtual-time
tests drive it directly under ``DeterministicLoop``.

CLI (the obs smoke)::

    python -m blance_tpu_torch.obs --smoke [--device cpu]

runs a seeded chaos rebalance (30% flaky + a dead node) with the
endpoint live, scrapes it mid-run and again later, and asserts the
output parses, counters are monotone between scrapes, every registry
metric is present, and availability stays in [0, 1].
"""

from __future__ import annotations

import argparse
import asyncio
import sys
from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Sequence

from .recorder import Recorder, get_recorder

__all__ = [
    "Metric",
    "MetricsRegistry",
    "default_registry",
    "render_prometheus",
    "parse_prometheus",
    "MetricsServer",
    "scrape",
    "main",
]

_KINDS = ("counter", "gauge", "histogram")


@dataclass(frozen=True)
class Metric:
    """One declared metric: internal dotted name, type, help string."""

    name: str  # e.g. "orchestrate.move_latency_s"
    kind: str  # "counter" | "gauge" | "histogram"
    help: str

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"metric {self.name!r}: unknown kind "
                             f"{self.kind!r} (want one of {_KINDS})")


def _prom_base(name: str) -> str:
    """Dotted internal name -> Prometheus-legal base name."""
    return "blance_" + name.replace(".", "_").replace("-", "_")


class MetricsRegistry:
    """The declarative metric table the exposition renders from.

    One entry per (name, kind) — ``plan.solve.sweeps`` is legitimately
    both a counter (total passes) and a histogram (passes per solve),
    and the two render under distinct Prometheus names (``_total`` vs
    ``_bucket``/``_sum``/``_count``)."""

    def __init__(self, metrics: Iterable[Metric]) -> None:
        self._by_key: dict[tuple[str, str], Metric] = {}
        seen_prom: dict[str, tuple[str, str]] = {}
        for m in metrics:
            key = (m.name, m.kind)
            if key in self._by_key:
                raise ValueError(f"duplicate metric declaration {key}")
            pname = self.prom_name(m)
            if pname in seen_prom:
                raise ValueError(
                    f"metric {key} renders to Prometheus name {pname!r} "
                    f"already taken by {seen_prom[pname]}")
            seen_prom[pname] = key
            self._by_key[key] = m

    def metrics(self) -> list[Metric]:
        return sorted(self._by_key.values(), key=lambda m: (m.name, m.kind))

    def declared(self, name: str, kind: str) -> bool:
        return (name, kind) in self._by_key

    @staticmethod
    def prom_name(metric: Metric) -> str:
        base = _prom_base(metric.name)
        return base + "_total" if metric.kind == "counter" else base

    def names(self, kind: Optional[str] = None) -> set[str]:
        return {n for (n, k) in self._by_key if kind is None or k == kind}

    def undeclared(self, recorder: Recorder) -> list[str]:
        """Every (kind, name) the recorder holds that this registry does
        not declare — the drift-guard's 'no undeclared emissions' check.
        Labeled gauge keys are matched on their base name."""
        out: list[str] = []
        with recorder._lock:  # consistent snapshot vs concurrent emits
            counters = list(recorder.counters)
            gauges = list(recorder.gauges)
            hists = list(recorder._hist_stats)
        for kind, keys in (("counter", counters), ("gauge", gauges),
                           ("histogram", hists)):
            for key in keys:
                base = key.split("{", 1)[0]
                if not self.declared(base, kind):
                    out.append(f"{kind}:{base}")
        return sorted(set(out))


_REGISTRY: Optional[MetricsRegistry] = None


def default_registry() -> MetricsRegistry:
    """The blance_tpu_torch metric table, built lazily (the
    ``orchestrate.tot_*`` mirror enumerates ``OrchestratorProgress``'s
    fields, and importing orchestrate at module-import time would be
    circular: orchestrate itself imports obs)."""
    global _REGISTRY
    if _REGISTRY is not None:
        return _REGISTRY
    from ..orchestrate.orchestrator import OrchestratorProgress

    metrics: list[Metric] = [
        # -- plan ------------------------------------------------------------
        Metric("plan.solve.calls", "counter",
               "solver invocations (cold solves + warm repair attempts)"),
        Metric("plan.solve.sweeps", "counter",
               "converged-loop passes executed, summed over all solves"),
        Metric("plan.solve.sweeps", "histogram",
               "converged-loop passes per solve"),
        Metric("plan.solve.carry_hit", "counter",
               "warm replans whose carry-seeded repair was accepted"),
        Metric("plan.solve.carry_miss", "counter",
               "replans with no usable solver carry"),
        Metric("plan.solve.warm_fallback", "counter",
               "warm repairs declined or failed, falling back to cold"),
        Metric("plan.solve.dirty_fraction", "histogram",
               "fraction of partitions each delta replan marked dirty"),
        Metric("plan.engine_fallback", "counter",
               "score-engine fallbacks (fused -> matrix)"),
        # -- fused plan pipeline (plan/tensor.plan_pipeline +
        # PlannerSession.replan_with_moves) ---------------------------------
        Metric("plan.pipeline.calls", "counter",
               "fused plan-pipeline invocations (solve->diff->pack in "
               "one device dispatch)"),
        Metric("plan.pipeline.warm", "counter",
               "pipeline dispatches resolved by the one-sweep warm "
               "repair (accepted through every gate)"),
        Metric("plan.pipeline.fallback", "counter",
               "pipeline dispatch failures degraded to the staged "
               "encode/solve/decode path"),
        Metric("plan.pipeline.dispatch_s", "histogram",
               "wall-clock seconds per fused pipeline device dispatch "
               "(solve + diff + pack, one program)"),
        # -- sparse shortlist solver (plan/tensor.solve_sparse +
        # core/shortlist.py + parallel/sharded.solve_sparse_sharded) ----------
        Metric("plan.sparse.shortlist_build_s", "histogram",
               "seconds to derive the per-partition top-K candidate "
               "shortlist (host entries; the fused sparse pipeline "
               "builds it in-dispatch instead)"),
        Metric("plan.sparse.k_effective", "gauge",
               "candidate columns per partition (K) of the most recent "
               "sparse solve"),
        Metric("plan.sparse.shortlist_exhausted", "counter",
               "partitions flagged by the sparse solve with no "
               "acceptable shortlist candidate for some slot"),
        Metric("plan.sparse.dense_fallback_rows", "counter",
               "exhausted partitions re-placed by the per-row dense "
               "fallback"),
        Metric("plan.greedy.candidates", "histogram",
               "candidates scored per greedy (partition, state) pick"),
        # -- moves -----------------------------------------------------------
        Metric("moves.diff_partitions", "counter",
               "partitions diffed by the batched device move calculus"),
        Metric("moves.irregular_partitions", "counter",
               "partitions routed to the host loop by the batched diff"),
        Metric("moves.total_ops", "counter",
               "move operations produced by the batched diff"),
        # -- orchestrate (beyond the tot_* mirror) ---------------------------
        Metric("orchestrate.retries", "counter",
               "backoff-scheduled retry attempts"),
        Metric("orchestrate.retry_backoff_s", "histogram",
               "seconds each scheduled retry backed off"),
        Metric("orchestrate.timeouts", "counter",
               "async assign callbacks cancelled at move_timeout_s"),
        Metric("orchestrate.quarantine_trips", "counter",
               "circuit-breaker entries into quarantine"),
        Metric("orchestrate.move_failures", "counter",
               "structured MoveFailures recorded (abandoned moves)"),
        Metric("orchestrate.missing_mover", "counter",
               "moves targeting a node with no mover (outside nodes_all)"),
        Metric("orchestrate.errors", "counter",
               "errors folded into the progress stream (legacy aborts, "
               "mover exits)"),
        Metric("orchestrate.task_exceptions", "counter",
               "orchestration tasks that died with an escaped exception"),
        Metric("orchestrate.move_latency_s", "histogram",
               "per-partition-move callback latency (batch exec amortized "
               "across its moves)"),
        # -- rebalance -------------------------------------------------------
        Metric("rebalance.recovery_rounds", "counter",
               "failure-aware recovery replan rounds entered"),
        Metric("rebalance.unconverged", "counter",
               "rebalances/controller cycles that exhausted their "
               "recovery budget with failures still outstanding"),
        Metric("rebalance.degraded", "counter",
               "recovery replans degraded structurally (e.g. empty "
               "candidate node set) instead of raising"),
        # -- slo (obs/slo.py; formulas in docs/OBSERVABILITY.md) -------------
        Metric("slo.partition_availability", "gauge",
               "fraction of partitions with at least one serving primary"),
        Metric("slo.churn_ratio", "gauge",
               "moves executed / minimum necessary (the primary plan)"),
        Metric("slo.convergence_lag_s", "gauge",
               "seconds since the last successfully executed move"),
        Metric("slo.moves_executed", "gauge",
               "partition moves successfully executed so far (monotone)"),
        Metric("slo.moves_failed", "gauge",
               "partition moves that failed or were rejected (monotone)"),
        Metric("slo.min_moves", "gauge",
               "the primary plan's move count (the churn denominator)"),
        Metric("slo.quarantined_nodes", "gauge",
               "nodes currently quarantined or half-open"),
        Metric("slo.quarantine_exposure_s", "gauge",
               "cumulative seconds each node has spent quarantined "
               "(labeled per node)"),
        Metric("slo.time_weighted_availability", "gauge",
               "integral of availability over the run / duration "
               "(horizon accounting; emitted when timeline tracking "
               "is on)"),
        Metric("slo.violation_seconds", "gauge",
               "cumulative seconds availability sat below the "
               "configured SLO floor"),
        Metric("slo.first_converged_lag_s", "gauge",
               "per-incident seconds from incident open to the last "
               "required move executed (the rebalance makespan the "
               "scheduler minimizes; last closed incident)"),
        # -- sched (orchestrate/sched; docs/SCHEDULER.md) ---------------------
        Metric("sched.makespan_predicted_s", "gauge",
               "list-scheduled makespan of the current move DAG on the "
               "node lanes, priced by the calibrated cost model"),
        Metric("sched.makespan_actual_s", "gauge",
               "achieved makespan of the finished orchestration (bind "
               "to last executed move)"),
        Metric("sched.critical_path_s", "gauge",
               "longest scheduled dependency chain by predicted cost "
               "(the makespan lower bound; stalled tails excluded)"),
        Metric("sched.lane_utilization", "gauge",
               "predicted busy fraction of the active nodes' lanes "
               "across the scheduled makespan"),
        Metric("sched.makespan_rel_err", "histogram",
               "relative error of the predicted vs achieved makespan, "
               "scored as each orchestration winds down"),
        Metric("sched.reschedules", "counter",
               "online schedule rebuilds (health-breaker quarantine "
               "or heal mid-schedule)"),
        Metric("sched.host_ranks", "counter",
               "upward-rank sweeps computed on host (move set below "
               "the device threshold)"),
        Metric("sched.device_ranks", "counter",
               "upward-rank sweeps dispatched on device (jitted "
               "leveled-DAG scan)"),
        # -- sim (rebalance.RebalanceController + testing/simulate.py) -------
        Metric("sim.events", "counter",
               "scenario trace events applied by the simulator driver"),
        Metric("sim.deltas", "counter",
               "cluster deltas submitted to the rebalance controller"),
        Metric("sim.rebalances", "counter",
               "orchestration passes the control loop started"),
        Metric("sim.superseded", "counter",
               "in-flight rebalances cancelled because a newer delta "
               "invalidated them (resumed from the achieved map)"),
        Metric("sim.degraded_plans", "counter",
               "planning steps that applied a graceful-degradation "
               "policy (replica shed / empty candidate set)"),
        Metric("sim.convergence_lag_s", "histogram",
               "per-incident seconds from cluster-delta submission to "
               "the control loop's next quiesce"),
        # -- costmodel (obs/costmodel.py) ------------------------------------
        Metric("costmodel.updates", "counter",
               "EWMA cost-model updates from move-lifecycle spans"),
        Metric("costmodel.rel_err", "histogram",
               "relative error of the cost prediction vs the observed "
               "per-move cost, at update time"),
        Metric("costmodel.cold_predictions", "counter",
               "predictions served without an exact (node, op) "
               "estimate (op-prior / global / default fallback)"),
        # -- fleet (plan/fleet.py + plan/service.py) -------------------------
        Metric("fleet.requests", "counter",
               "tenant plan requests submitted to the plan service"),
        Metric("fleet.batches", "counter",
               "fleet batch device dispatches (one per bucket class x "
               "warm/cold)"),
        Metric("fleet.dispatcher_crashes", "counter",
               "plan-service dispatcher tasks that died with an escaped "
               "exception"),
        Metric("fleet.queue_depth", "gauge",
               "plan requests waiting in the service's bounded queue"),
        Metric("fleet.batch_tenants", "histogram",
               "real tenants per fleet batch dispatch"),
        Metric("fleet.batch_occupancy", "histogram",
               "real tenants / padded batch size per dispatch (mesh "
               "divisibility padding included)"),
        Metric("fleet.admission_latency_s", "histogram",
               "seconds from plan-service submit to resolved result"),
        Metric("fleet.dispatch_s", "histogram",
               "wall-clock seconds per fleet batch device dispatch"),
        Metric("fleet.request_segment_s", "histogram",
               "per-request latency decomposition (labeled by segment: "
               "admission/coalesce/executor_queue/device/resolve; the "
               "segments tile submit-to-resolve exactly)"),
        # -- fleet of control loops (blance_tpu/fleetloop.py +
        # plan/service.py fairness + plan/carry.py evictions) ----------------
        Metric("fleet.starved_admissions", "counter",
               "plan requests rolled out of a coalescing window by the "
               "per-tenant fair-share quota (one count per deferral "
               "event; the cross-tenant starvation observable)"),
        Metric("fleet.carry_evictions", "counter",
               "warm-carry cache evictions, labeled by reason (bytes = "
               "byte-budget LRU, entries = key-count LRU drop, shape = "
               "re-shaped problem reset) — every one costs the key one "
               "cold solve"),
        # -- encode residency (plan/resident.py + fleetloop.py
        # ServicePlanner; docs/DESIGN.md "Encode residency") ------------------
        Metric("fleet.encode_cold", "counter",
               "full encode_problem runs that (re)established resident "
               "state: a tenant's first cycle, or one after a counted "
               "demotion/eviction (tenants <= cold <= tenants + "
               "demotions + evictions; out-of-protocol tenants' "
               "every-cycle full encodes show as fleet.decode_full "
               "instead)"),
        Metric("fleet.encode_warm", "counter",
               "converge cycles served by delta-patching the resident "
               "encode state (O(delta) host work, no re-encode)"),
        Metric("fleet.encode_demotions", "counter",
               "resident encode states dropped by the conservative "
               "protocol, labeled by reason (divergence = pass/strip "
               "did not land the held map, statics = model/options "
               "swap, nodes = node-list drift, shape = slot-depth "
               "drift) — each costs the key one cold re-encode"),
        Metric("fleet.encode_evictions", "counter",
               "resident encode states dropped by the EncodeCache "
               "budgets, labeled by reason (bytes / entries) — each "
               "costs the key one cold re-encode"),
        Metric("fleet.encode_patch_rows", "histogram",
               "prev/weight rows written per resident delta patch "
               "(strip scatters, weight-drift rows, adopted-pass "
               "scatters, dark-set flips)"),
        Metric("fleet.encode_patch_bytes", "counter",
               "array bytes written by resident encode delta patches — "
               "the warm cycle's whole fresh-data footprint (bounded "
               "by dirty rows + scalars; the perf-smoke gate pins it)"),
        Metric("fleet.decode_full", "counter",
               "full decode_assignment runs on the planner path (cold "
               "cycles, first decode after a cold encode, pass-through "
               "tenants)"),
        Metric("fleet.decode_patch", "counter",
               "incremental decodes: held map patched at the changed "
               "rows, bit-identical to the full decode"),
        Metric("fleet.decode_dirty_rows", "histogram",
               "rows rebuilt per incremental decode (the rows the "
               "solve actually changed)"),
        Metric("fleet.h2d_bytes", "counter",
               "host->device bytes shipped as stacked fleet batch "
               "tensors, summed per dispatch"),
        Metric("fleet.tenants", "gauge",
               "tenant control loops registered with the fleet rollup"),
        Metric("fleet.converge_cycles", "gauge",
               "converge cycles completed across every tenant loop "
               "(fleet-controller rollup)"),
        Metric("slo.fleet_availability_min", "gauge",
               "minimum partition availability across all tenant loops "
               "(the fleet's worst tenant)"),
        Metric("slo.fleet_availability_mean", "gauge",
               "mean partition availability across all tenant loops"),
        Metric("slo.fleet_tenants_below_floor", "gauge",
               "tenant loops currently below their availability floor"),
        Metric("slo.fleet_violation_seconds", "gauge",
               "cumulative SLO-violation seconds summed across all "
               "tenant loops"),
        # -- durability (blance_tpu/durability; docs/DURABILITY.md) ----------
        Metric("durability.journal_records", "counter",
               "records appended to the write-ahead journal (all kinds, "
               "all tenants)"),
        Metric("durability.journal_bytes", "counter",
               "bytes appended to the write-ahead journal (framing "
               "included)"),
        Metric("durability.segments_rotated", "counter",
               "journal segment rotations (a fresh crash-atomically "
               "birthed segment file every rotate_records appends)"),
        Metric("durability.snapshots", "counter",
               "state snapshots written (controller map + membership + "
               "breaker/SLO/cost state; the pointer record is the "
               "commit point)"),
        Metric("durability.torn_tail", "counter",
               "journal segments whose final record was torn (partial "
               "write / CRC or framing failure), truncated to the last "
               "valid prefix at replay"),
        Metric("durability.recoveries", "counter",
               "recover() invocations: journal replays that rebuilt "
               "controller state and fenced a new epoch"),
        Metric("durability.replayed_records", "counter",
               "journal records folded into recovered state across all "
               "recoveries"),
        Metric("durability.stale_epoch_rejections", "counter",
               "writes or move completions rejected because their "
               "captured epoch lost the fence (zombie pre-crash writer "
               "or stale process) — counted, never applied"),
        Metric("durability.recovery_cold_solves", "counter",
               "resumed controllers whose first plan is a cold solve "
               "(carry/encode caches are deliberately not persisted; "
               "bounded by the fleet demotion attribution identity)"),
        # -- device (obs/device.py; all emitted only while the device
        # observatory is enabled) ---------------------------------------------
        # The help strings are the reference's, so a scrape (and the
        # simulators' replayed expositions) reads byte for byte as the
        # reference's.  What the port records under each name:
        # device.compiles / compile_s, the builds and first loads of the
        # kernel libraries and native extensions; cost_analyses, the first
        # dispatches measured; flops / hbm_bytes, the operations and bytes
        # of the hand-written kernels' calls (ops/cost.py); peak_alloc_bytes,
        # the card allocator's peak during the dispatch above what it held
        # before, plus the dispatch's operands on the card.
        Metric("device.compiles", "counter",
               "XLA compilations, labeled by owning entry point "
               "(solve_dense cold/carry/warm/bucketed, fleet batch "
               "classes, sharded dispatch, other)"),
        Metric("device.compile_s", "histogram",
               "seconds per XLA backend compilation (labeled by entry)"),
        Metric("device.cost_analyses", "counter",
               "AOT cost/memory analyses published (one per entry x "
               "bucket-shape, memoized)"),
        Metric("device.flops", "gauge",
               "XLA cost-analysis FLOPs per dispatch of the compiled "
               "program (labeled entry + bucket-shape klass)"),
        Metric("device.hbm_bytes", "gauge",
               "XLA cost-analysis bytes accessed per dispatch (labeled "
               "entry + klass)"),
        Metric("device.peak_alloc_bytes", "gauge",
               "XLA memory-analysis argument+output+temp bytes for the "
               "compiled program (labeled entry + klass)"),
        Metric("device.sweep_accept_frac", "histogram",
               "per-sweep accepted-bid fraction of the converged solve "
               "(also a Chrome counter track under the solve span)"),
    ]
    metrics.extend(
        Metric("orchestrate." + name, "counter",
               f"progress counter mirror of OrchestratorProgress.{name}")
        for name in OrchestratorProgress().__dict__
        if name != "errors")
    _REGISTRY = MetricsRegistry(metrics)
    return _REGISTRY


# -- rendering ---------------------------------------------------------------


def _fmt(v: float) -> str:
    """Deterministic sample formatting: integral floats render as ints
    (the common counter case), everything else as repr (full precision,
    stable across platforms)."""
    f = float(v)
    if f.is_integer() and abs(f) < 2 ** 53:
        return str(int(f))
    return repr(f)


def render_prometheus(recorder: Optional[Recorder] = None,
                      registry: Optional[MetricsRegistry] = None) -> str:
    """One Recorder snapshot as Prometheus text format (0.0.4).

    Registry-driven: every declared metric appears (HELP + TYPE + at
    least one sample, zero-valued when never emitted), so the scrape
    schema is complete and stable from the first request.  Recorder
    names NOT in the registry are deliberately omitted — the drift
    guard makes that set empty for the shipped pipeline."""
    rec = recorder if recorder is not None else get_recorder()
    reg = registry if registry is not None else default_registry()
    with rec._lock:  # the Recorder is counted from threads too; copying
        counters = dict(rec.counters)  # an unlocked dict mid-insert can
        gauges = dict(rec.gauges)  # raise 'changed size during iteration'
        hist_keys = list(rec._hist_stats)
    lines: list[str] = []

    def _render_hist(key: str, pname: str, labels: str) -> None:
        """One histogram series (base or labeled).  ``labels`` is the
        inner label list ('' for the base series); the le label composes
        with it inside one brace set, per the exposition format."""
        hb = rec.histogram_buckets(key)
        sep = "," if labels else ""
        suffix = f"{{{labels}}}" if labels else ""
        if hb is None:
            lines.append(f'{pname}_bucket{{{labels}{sep}le="+Inf"}} 0')
            lines.append(f"{pname}_sum{suffix} 0")
            lines.append(f"{pname}_count{suffix} 0")
            return
        bounds, cum, count, total = hb
        for b, c in zip(bounds, cum):
            lines.append(
                f'{pname}_bucket{{{labels}{sep}le="{_fmt(b)}"}} {c}')
        lines.append(f'{pname}_bucket{{{labels}{sep}le="+Inf"}} {cum[-1]}')
        lines.append(f"{pname}_sum{suffix} {_fmt(total)}")
        lines.append(f"{pname}_count{suffix} {count}")

    for m in reg.metrics():
        pname = reg.prom_name(m)
        lines.append(f"# HELP {pname} {m.help}")
        lines.append(f"# TYPE {pname} {m.kind}")
        if m.kind == "counter":
            labeled = sorted(k for k in counters
                             if k.startswith(m.name + "{"))
            if m.name in counters or not labeled:
                lines.append(f"{pname} {_fmt(counters.get(m.name, 0))}")
            for key in labeled:
                lines.append(f"{pname}{key[len(m.name):]} "
                             f"{_fmt(counters[key])}")
        elif m.kind == "gauge":
            labeled = sorted(k for k in gauges
                             if k.startswith(m.name + "{"))
            if m.name in gauges:
                lines.append(f"{pname} {_fmt(gauges[m.name])}")
            for key in labeled:
                lines.append(f"{pname}{key[len(m.name):]} "
                             f"{_fmt(gauges[key])}")
            if m.name not in gauges and not labeled:
                lines.append(f"{pname} 0")
        else:  # histogram
            labeled = sorted(k for k in hist_keys
                             if k.startswith(m.name + "{"))
            if m.name in hist_keys or not labeled:
                _render_hist(m.name, pname, "")
            for key in labeled:
                _render_hist(key, pname, key[len(m.name) + 1:-1])
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> tuple[dict[str, float], dict[str, str]]:
    """Parse exposition text back into (samples, types).

    ``samples`` is keyed by the full sample name INCLUDING any label
    set (``blance_x_bucket{le="1"}``); ``types`` maps base metric name
    to its declared type.  Raises ValueError on any line that is
    neither a comment nor a well-formed sample — the CI smoke's
    'parseable' assertion."""
    samples: dict[str, float] = {}
    types: dict[str, str] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or parts[3] not in _KINDS:
                raise ValueError(f"line {lineno}: malformed TYPE: {line!r}")
            types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        name, sep, value = line.rpartition(" ")
        if not sep or not name:
            raise ValueError(f"line {lineno}: malformed sample: {line!r}")
        try:
            samples[name] = float(value)
        except ValueError as e:
            raise ValueError(
                f"line {lineno}: bad sample value {value!r}") from e
    return samples, types


# -- the asyncio endpoint ----------------------------------------------------


class MetricsServer:
    """Minimal asyncio HTTP/1.1 server for ``GET /metrics``.

    ``collectors`` run before each snapshot (e.g. ``SloTracker.publish``
    refreshing time-derived gauges); renders are throttled to one per
    ``min_interval_s`` with scrapes in between served from the cached
    text, so a tight scrape loop cannot turn the recorder lock into a
    hot path."""

    def __init__(self, recorder: Optional[Recorder] = None,
                 registry: Optional[MetricsRegistry] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 min_interval_s: float = 0.25,
                 collectors: Sequence[Callable[[], None]] = ()) -> None:
        self._recorder = recorder
        self._registry = registry
        self._host = host
        self._requested_port = port
        self._min_interval_s = min_interval_s
        self._collectors = tuple(collectors)
        self._server: Optional[asyncio.Server] = None
        self._cached: Optional[str] = None
        self._cached_at: Optional[float] = None
        self._started_at: Optional[float] = None
        self._snapshots = 0

    # -- snapshotting --------------------------------------------------------

    def render(self) -> str:
        """A FRESH snapshot (collectors + render), bypassing the cache.
        Loop-free: usable directly under DeterministicLoop tests."""
        for collect in self._collectors:
            collect()
        rec = self._recorder if self._recorder is not None \
            else get_recorder()
        return render_prometheus(rec, self._registry)

    def _snapshot(self) -> str:
        rec = self._recorder if self._recorder is not None \
            else get_recorder()
        now = rec.now()
        if self._cached is None or self._cached_at is None or \
                now - self._cached_at >= self._min_interval_s:
            self._cached = self.render()
            self._cached_at = now
            self._snapshots += 1
        return self._cached

    def _healthz(self) -> tuple[str, bytes]:
        """Liveness + freshness: 200 with uptime/snapshot-age JSON once
        a snapshot exists, 503 before the first one — so a scraper (and
        the CI obs-smoke) can tell 'up and serving fresh aggregates'
        from 'up but you would get a stale or empty cache'."""
        import json

        rec = self._recorder if self._recorder is not None \
            else get_recorder()
        now = rec.now()
        if self._cached_at is None:
            payload = {"status": "no-snapshot",
                       "uptime_s": (now - self._started_at
                                    if self._started_at is not None
                                    else None)}
            return "503 Service Unavailable", \
                (json.dumps(payload, sort_keys=True) + "\n").encode()
        payload = {
            "status": "ok",
            "uptime_s": (now - self._started_at
                         if self._started_at is not None else None),
            "snapshot_age_s": now - self._cached_at,
            "snapshots": self._snapshots,
        }
        return "200 OK", \
            (json.dumps(payload, sort_keys=True) + "\n").encode()

    # -- server lifecycle ----------------------------------------------------

    async def start(self) -> None:
        if self._server is not None:
            raise RuntimeError("MetricsServer already started")
        rec = self._recorder if self._recorder is not None \
            else get_recorder()
        self._started_at = rec.now()
        self._server = await asyncio.start_server(
            self._handle, self._host, self._requested_port)

    @property
    def port(self) -> int:
        if self._server is None:
            raise RuntimeError("MetricsServer not started")
        sock = self._server.sockets[0]
        return int(sock.getsockname()[1])

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            request = await asyncio.wait_for(reader.readline(), 10.0)
            while True:  # drain headers to the blank line
                header = await asyncio.wait_for(reader.readline(), 10.0)
                if header in (b"\r\n", b"\n", b""):
                    break
            parts = request.split()
            path = parts[1].decode("latin-1") if len(parts) >= 2 else ""
            ctype = "text/plain; version=0.0.4; charset=utf-8"
            if parts and parts[0] != b"GET":
                status, body = "405 Method Not Allowed", b"method not allowed\n"
            elif path in ("/metrics", "/"):
                status, body = "200 OK", self._snapshot().encode()
            elif path == "/healthz":
                status, body = self._healthz()
                ctype = "application/json; charset=utf-8"
            else:
                status, body = "404 Not Found", b"not found\n"
            writer.write(
                f"HTTP/1.1 {status}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"Connection: close\r\n\r\n".encode() + body)
            await writer.drain()
        except (ConnectionError, asyncio.TimeoutError, OSError):
            pass  # a dropped/slow scraper is the scraper's problem
        finally:
            writer.close()


async def scrape(host: str, port: int, path: str = "/metrics",
                 timeout_s: float = 10.0) -> str:
    """Minimal asyncio scrape client (the CI smoke and tests use it;
    production scrapes come from a real Prometheus)."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(f"GET {path} HTTP/1.1\r\nHost: {host}\r\n"
                     f"Connection: close\r\n\r\n".encode())
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(-1), timeout_s)
    finally:
        writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    status = head.split(b"\r\n", 1)[0]
    if b" 200 " not in status + b" ":
        raise RuntimeError(f"scrape failed: {status.decode('latin-1')}")
    return body.decode()


# -- CI smoke ----------------------------------------------------------------


async def _smoke_async(fail_rate: float = 0.3, seed: int = 7,
                       device: str = "cuda") -> int:
    """Chaos rebalance with the endpoint live: scrape twice mid-flight,
    once after, and assert the acceptance contract (parseable output,
    every registry metric present, monotone counters, availability in
    [0, 1]).  Returns a process exit code."""
    from ..core.types import Partition, PartitionModelState
    from ..orchestrate.faults import FaultPlan, NodeFaults
    from ..orchestrate.orchestrator import OrchestratorOptions
    from ..rebalance import rebalance_async
    from .recorder import use_recorder
    from .slo import SloTracker

    P, N = 64, 8
    nodes = [f"n{i:03d}" for i in range(N)]
    live, dead = nodes[:-1], nodes[-1]
    model = {"primary": PartitionModelState(priority=0, constraints=1),
             "replica": PartitionModelState(priority=1, constraints=1)}
    beg = {
        f"{i:04d}": Partition(f"{i:04d}", {
            "primary": [live[i % len(live)]],
            "replica": [live[(i + 1) % len(live)]]})
        for i in range(P)
    }
    plan = FaultPlan(seed=seed, nodes={
        dead: NodeFaults(dead=True),
        nodes[0]: NodeFaults(fail_rate=fail_rate),
        nodes[1]: NodeFaults(fail_rate=fail_rate),
    })

    async def assign(stop_ch: object, node: str, partitions: list[str],
                     states: list[str], ops: list[str]) -> None:
        await asyncio.sleep(0.001)  # keep the run in flight across scrapes

    failures: list[str] = []

    def check(cond: bool, what: str) -> None:
        if not cond:
            failures.append(what)
        print(f"  {'ok' if cond else 'FAIL'}: {what}", file=sys.stderr)

    rec = Recorder()
    with use_recorder(rec):
        slo = SloTracker(beg, primary_states=("primary",), clock=rec.now,
                         recorder=rec)
        server = MetricsServer(recorder=rec, collectors=(slo.publish,),
                               min_interval_s=0.01)
        await server.start()
        try:
            # /healthz before ANY metrics scrape: no snapshot exists yet,
            # so a healthy-but-stale server must answer 503, not 200 —
            # that is the distinction real scrapers key alerts on.
            try:
                await scrape("127.0.0.1", server.port, path="/healthz")
                health_pre = "200"
            except RuntimeError as e:
                health_pre = "503" if " 503 " in f" {e} " else str(e)
            loop = asyncio.get_running_loop()
            # Decommission one live node AND add the dead one: the
            # decommission forces real (retried-through-the-flakes)
            # migrations between live nodes, while every move onto the
            # dead node fails into quarantine + recovery — so the scrape
            # sees both executed moves and failures.
            run = loop.create_task(rebalance_async(
                model, beg, nodes, [live[2]], [dead], plan.wrap(assign),
                # Generous deadline/retry budget: on a loaded CI host
                # only the SCRIPTED faults may fail moves — an innocent
                # callback stalled by scheduling jitter must not trip
                # quarantine and sink the final-availability assertion.
                orchestrator_options=OrchestratorOptions(
                    move_timeout_s=5.0, max_retries=6,
                    backoff_base_s=0.002, quarantine_after=3,
                    probe_after_s=60.0),
                max_recovery_rounds=3, backend="greedy", device=device,
                slo=slo))
            await asyncio.sleep(0.05)
            text1 = await scrape("127.0.0.1", server.port)
            await asyncio.sleep(0.05)
            text2 = await scrape("127.0.0.1", server.port)
            result = await run
            text3 = await scrape("127.0.0.1", server.port)
            health = await scrape("127.0.0.1", server.port,
                                  path="/healthz")
        finally:
            await server.stop()

    s1, t1 = parse_prometheus(text1)
    s2, _t2 = parse_prometheus(text2)
    s3, _t3 = parse_prometheus(text3)
    print(f"obs-smoke: scraped {len(s1)} -> {len(s2)} -> {len(s3)} "
          f"samples; rebalance failures={len(result.failures)} "
          f"quarantined={result.quarantined_nodes}", file=sys.stderr)

    reg = default_registry()
    missing = [reg.prom_name(m) for m in reg.metrics()
               if reg.prom_name(m) not in t1]
    check(not missing, f"every registry metric exposed (missing: "
                       f"{missing[:5]})")
    counter_names = {reg.prom_name(m) for m in reg.metrics()
                     if m.kind == "counter"}
    regressed = [n for n in counter_names
                 if not (s1.get(n, 0) <= s2.get(n, 0) <= s3.get(n, 0))]
    check(not regressed, f"counters monotone across scrapes (regressed: "
                         f"{regressed[:5]})")
    avail = "blance_slo_partition_availability"
    check(all(0.0 <= s[avail] <= 1.0 for s in (s1, s2, s3)),
          "availability within [0, 1] on every scrape")
    check(s3[avail] == 1.0, "final availability is 1.0 (chaos run "
                            "completed on the survivors)")
    # Churn can land under 1.0 here: abandoned moves are never executed
    # and the recovery replan (dead placements presumed lost) owes fewer
    # moves than the primary plan did.  Positive just means the gauge is
    # wired.
    check(s3["blance_slo_churn_ratio"] > 0.0,
          "churn ratio positive and published")
    check(s3["blance_slo_moves_executed"] > 0,
          "executed-move gauge advanced")
    check(s3["blance_orchestrate_move_failures_total"] > 0,
          "chaos actually injected failures")
    check(health_pre == "503",
          f"/healthz is 503 before the first snapshot (got {health_pre})")
    import json as _json

    try:
        hz = _json.loads(health)
    except ValueError:
        hz = {}
    check(hz.get("status") == "ok" and hz.get("snapshot_age_s", -1) >= 0
          and hz.get("uptime_s", -1) >= 0,
          f"/healthz serves ok + uptime/snapshot-age JSON (got {health!r})")
    if failures:
        print(f"obs-smoke: FAIL ({len(failures)} checks)", file=sys.stderr)
        return 1
    print("obs-smoke: OK", file=sys.stderr)
    return 0


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m blance_tpu_torch.obs",
        description="Prometheus exposition endpoint for blance_tpu_torch "
                    "telemetry")
    ap.add_argument("--smoke", action="store_true",
                    help="CI gate: chaos rebalance with the endpoint "
                         "live; scrape + assert, exit nonzero on failure")
    ap.add_argument("--device", default="cuda",
                    help="where the smoke's rebalance runs (default: the "
                         "card; 'cpu' without one)")
    ap.add_argument("--render", action="store_true",
                    help="render one snapshot of the process recorder "
                         "to stdout and exit")
    args = ap.parse_args(argv)
    if args.smoke:
        return asyncio.run(_smoke_async(device=args.device))
    if args.render:
        print(render_prometheus(), end="")
        return 0
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
