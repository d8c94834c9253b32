# Port of blance_tpu/testing/simulate.py: run_scenario takes ``device``
# ("cuda" by default) for the controller, its session and the offline
# plan; the scenario and its log are the reference's.
"""Event-driven closed-loop cluster-life simulator (ROADMAP item 4).

The paper's scenario is ONE rebalance; production is a control loop
under churn.  This module closes the loop: a seeded
:class:`~blance_tpu_torch.testing.scenarios.SimScenario` trace (node
arrivals/departures, bulk spot preemptions, rolling zone outages,
hot-tenant weight drift, flaky/slow movers) drives a
:class:`~blance_tpu_torch.rebalance.RebalanceController` — plan -> diff ->
orchestrate, repeatedly, with debounce, mid-flight supersede and
graceful degradation — entirely under the
:class:`~blance_tpu_torch.testing.sched.DeterministicLoop` virtual clock, so
a week of cluster life replays bit-identically in seconds.

Per-run scoring extends the ``SloTracker`` horizon account:

- **time-weighted availability** over the whole horizon, plus the
  SLO-violation intervals against the scenario's floor;
- **cumulative churn vs the offline optimum** — executed moves divided
  by what ONE plan from the initial map to the final membership would
  have moved (the single-plan lower bound no online loop can beat);
- **per-incident convergence lag** — delta submission to the control
  loop's next quiesce, one sample per scripted incident
  (``sim.convergence_lag_s``);
- **scripted-outage discipline** — every availability DROP must fall
  inside a scripted outage window (an ``outage=True`` event until the
  loop's next quiesce); a drop outside one is a lost primary nobody
  scripted, reported in ``SimReport.unscripted_drops``.

Everything the run did lands in a VERSIONED JSON event log (schema in
docs/SIMULATOR.md): the initial placements, every delta/strip/batch
with virtual timestamps, quiesce points with closed incidents, and the
final summary.  The log is the ground truth the SLO property tests
brute-force-recompute from, and the replay artifact: the same scenario
seed produces byte-identical log text, pinned by committed traces under
``tests/traces/``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

from ..convert import resolve_device
from ..core.types import PartitionMap, PartitionModel
from ..obs import Recorder, use_recorder
from ..obs.expo import render_prometheus
from ..obs.slo import SloSummary, SloTracker
from ..orchestrate.faults import FaultPlan
from ..orchestrate.orchestrator import OrchestratorOptions
from ..plan.api import plan_next_map
from ..rebalance import RebalanceController, count_moves
from ..utils.hostclock import perf_now
from .scenarios import SimScenario, initial_map, scenario_model
from .sched import DeterministicLoop, FifoPolicy

__all__ = [
    "SIM_LOG_VERSION",
    "SimLog",
    "SimReport",
    "run_scenario",
    "canonical_log_text",
    "recompute_slo_from_log",
]

SIM_LOG_VERSION = 1


class SimLog:
    """The run's versioned event log; also a move observer (``on_batch``)
    so every executed/failed batch lands with its virtual timestamp.
    Events append in virtual-clock order by construction (the clock is
    monotone and every emit happens inside the run)."""

    def __init__(self) -> None:
        self.events: list[dict[str, Any]] = []

    def emit(self, kind: str, t: float, **fields: Any) -> None:
        self.events.append({"kind": kind, "t": t, **fields})

    # MoveObserver hook (duck-typed; see obs/slo.py).
    def on_batch(self, node: str, moves: Sequence[Any], ok: bool,
                 now: float) -> None:
        self.emit("batch", now, node=node, ok=bool(ok),
                  moves=[[m.partition, m.node, m.state, m.op]
                         for m in moves])


def canonical_log_text(events: list[dict[str, Any]]) -> str:
    """THE byte-comparable serialization: sorted keys, fixed
    separators, trailing newline.  Committed replay traces are written
    and compared in exactly this form."""
    return json.dumps({"version": SIM_LOG_VERSION, "events": events},
                      sort_keys=True, indent=1) + "\n"


@dataclass
class SimReport:
    """Everything one scenario run produced (see module doc)."""

    scenario: str
    seed: int
    horizon_s: float
    final_map: PartitionMap
    complete: bool
    summary: SloSummary
    exposition: str  # rendered Prometheus text at end of run
    events: list[dict[str, Any]]
    deltas: int
    rebalances: int
    superseded: int
    degraded: int
    unconverged: int
    quarantined: list[str]
    convergence_lags: list[float]
    offline_min_moves: int
    # None when the offline optimum is zero moves (the trace returned
    # the membership to its start): transient work has no single-plan
    # baseline to divide by.
    churn_vs_offline: Optional[float]
    # Availability drops whose timestamp fell OUTSIDE every scripted
    # outage window: (t, availability) pairs; must be empty.
    unscripted_drops: list[tuple[float, float]] = field(
        default_factory=list)
    steps: int = 0
    wall_s: float = 0.0  # host time; NOT part of the replayable account

    def log_text(self) -> str:
        return canonical_log_text(self.events)


def _map_complete(pmap: PartitionMap, model: PartitionModel,
                  live: set[str]) -> bool:
    """Every partition holds its full constraint count per state, all
    placements on live nodes, no duplicates."""
    for p in pmap.values():
        seen: set[str] = set()
        for state, st in model.items():
            ns = p.nodes_by_state.get(state, [])
            if len(ns) != st.constraints:
                return False
            for n in ns:
                if n in seen or n not in live:
                    return False
                seen.add(n)
    return True


async def _sim_main(scn: SimScenario, loop: DeterministicLoop,
                    rec: Recorder, device: Any) -> SimReport:
    model = scenario_model(scn)
    beg = initial_map(scn)
    slo = SloTracker(
        beg, primary_states=("primary",), clock=rec.now, recorder=rec,
        track_timeline=True, availability_floor=scn.availability_floor)
    log = SimLog()
    log.emit(
        "init", 0.0, scenario=scn.name, seed=scn.seed,
        horizon_s=scn.horizon_s, nodes=list(scn.nodes),
        replicas=scn.replicas, floor=scn.availability_floor,
        placements={name: {s: list(ns)
                           for s, ns in p.nodes_by_state.items()}
                    for name, p in beg.items()})

    fault_plan = FaultPlan(seed=scn.seed, nodes=dict(scn.fault_nodes))

    async def data_plane(stop_ch: Any, node: str, partitions: list[str],
                         states: list[str], ops: list[str]) -> None:
        import asyncio

        await asyncio.sleep(
            scn.node_latency_s.get(node, scn.base_latency_s))

    session = None
    if scn.use_session:
        from ..plan.session import PlannerSession

        session = PlannerSession(model, list(scn.nodes),
                                 sorted(beg.keys()), device=device)
        session.load_map(beg)

    orch_opts = OrchestratorOptions(
        move_timeout_s=scn.move_timeout_s,
        max_retries=scn.max_retries,
        backoff_base_s=scn.backoff_base_s,
        retry_seed=scn.seed,
        quarantine_after=scn.quarantine_after,
        probe_after_s=scn.probe_after_s,
        max_concurrent_partition_moves_per_node=scn.max_concurrent_moves)
    if scn.scheduler == "critical_path":
        # Critical-path move order (docs/SCHEDULER.md): the cost model
        # seeds from the committed bench priors and recalibrates ONLINE
        # from this very run's move spans (virtual-time durations, so
        # the whole account replays bit-identically); each controller
        # pass re-binds the policy against its fresh move plans.
        from ..obs.costmodel import CostModel, default_op_priors
        from ..orchestrate.sched import CriticalPathScheduler

        cost_model = CostModel(recorder=rec)
        cost_model.seed_priors(default_op_priors())
        rec.add_sink(cost_model)
        orch_opts.scheduler = CriticalPathScheduler(cost_model=cost_model)
    elif scn.scheduler != "legacy":
        raise ValueError(f"unknown scheduler {scn.scheduler!r} "
                         f"(want 'legacy' or 'critical_path')")

    ctl = RebalanceController(
        model, list(scn.nodes), beg, fault_plan.wrap(data_plane),
        orchestrator_options=orch_opts,
        backend=scn.backend, device=device, session=session,
        debounce_s=scn.debounce_s,
        max_passes_per_cycle=scn.max_passes_per_cycle,
        slo=slo, move_observers=(log,))

    # Incident accounting: each scripted event opens an incident; the
    # controller's next quiesce closes every open one, with the lag as
    # the per-incident convergence sample.  Outage incidents also
    # define the windows availability is ALLOWED to drop in.
    open_incidents: list[dict[str, Any]] = []
    lags: list[float] = []
    outage_windows: list[list[float]] = []  # [start, end]

    def on_quiesce(t: float) -> None:
        if not open_incidents:
            return
        closed = []
        for inc in open_incidents:
            lag = t - inc["t"]
            lags.append(lag)
            rec.observe("sim.convergence_lag_s", lag)
            closed.append({"label": inc["label"], "lag_s": lag})
            if inc["outage"]:
                outage_windows.append([inc["t"], t])
        open_incidents.clear()
        log.emit("quiesce", t, closed=closed,
                 availability=slo.availability())

    def on_strip(nodes: set[str], t: float) -> None:
        log.emit("strip", t, nodes=sorted(nodes))

    ctl.on_quiesce.append(on_quiesce)
    ctl.on_strip.append(on_strip)
    ctl.start()

    import asyncio

    for ev in sorted(scn.events, key=lambda e: (e.t, e.label)):
        delay = ev.t - loop.time()
        if delay > 0:
            await asyncio.sleep(delay)
        t = rec.now()
        rec.count("sim.events")
        log.emit("delta", t, label=ev.label, outage=ev.outage,
                 add=list(ev.delta.add), remove=list(ev.delta.remove),
                 fail=list(ev.delta.fail),
                 partition_weights=dict(ev.delta.partition_weights or {}),
                 node_weights=dict(ev.delta.node_weights or {}))
        open_incidents.append({"t": t, "label": ev.label,
                               "outage": ev.outage})
        ctl.submit(ev.delta)

    remaining = scn.horizon_s - loop.time()
    if remaining > 0:
        await asyncio.sleep(remaining)
    final = await ctl.quiesce()
    await ctl.stop()

    # Offline-optimal churn baseline: ONE plan from the initial map to
    # the final membership — what a clairvoyant single rebalance would
    # have moved.  (Computed after the run so the planner sees exactly
    # the final candidate set.)
    live = ctl.live_nodes()
    removed = sorted(set(ctl._nodes) - set(live))
    offline_map, _w = plan_next_map(
        beg, beg, list(ctl._nodes), removed, [], model,
        ctl.opts, backend=scn.backend, device=device)
    offline_moves = count_moves(model, beg, offline_map)
    slo.set_min_moves(offline_moves)

    t_end = rec.now()
    summary = slo.summary(t_end)

    # Scripted-outage discipline: every availability DROP in the
    # timeline must fall inside some outage window.
    drops = []
    timeline = slo.timeline()
    for (t0, a0), (t1, a1) in zip(timeline, timeline[1:]):
        if a1 < a0 and not any(s <= t1 <= e for s, e in outage_windows):
            drops.append((t1, a1))

    complete = _map_complete(final, model, set(live))
    log.emit(
        "end", t_end,
        availability=summary.availability,
        time_weighted_availability=summary.time_weighted_availability,
        violation_s=summary.violation_s,
        moves_executed=summary.moves_executed,
        moves_failed=summary.moves_failed,
        offline_min_moves=offline_moves,
        complete=complete)

    return SimReport(
        scenario=scn.name, seed=scn.seed, horizon_s=scn.horizon_s,
        final_map=final, complete=complete, summary=summary,
        exposition=render_prometheus(rec), events=log.events,
        deltas=len(scn.events), rebalances=ctl.passes,
        superseded=ctl.superseded,
        degraded=len(ctl.degraded_reports),
        unconverged=ctl.unconverged_cycles,
        quarantined=ctl.quarantined_nodes(),
        convergence_lags=lags,
        offline_min_moves=offline_moves,
        churn_vs_offline=(summary.moves_executed / offline_moves
                          if offline_moves else None),
        unscripted_drops=drops)


def run_scenario(scn: SimScenario, device: Any = "cuda") -> SimReport:
    """Run one scenario to completion under the virtual clock and score
    it.  Pure function of the scenario (same input -> byte-identical
    event log, SLO summary and exposition text); wall_s/steps are the
    only host-dependent fields.  ``device`` is where the controller's
    planner, its session and the offline plan solve; it is not part of
    the scenario, and the log does not name it."""
    resolve_device(device, "run_scenario")
    loop = DeterministicLoop(FifoPolicy(), max_steps=scn.max_steps)
    rec = Recorder(clock=loop.time)
    t0 = perf_now()
    with use_recorder(rec):
        report = loop.run_until_complete(
            _sim_main(scn, loop, rec, device))
    report.wall_s = perf_now() - t0
    report.steps = loop.steps
    return report


# -- brute-force SLO recompute (the property-test oracle) ---------------------


def recompute_slo_from_log(events: list[dict[str, Any]],
                           floor: Optional[float] = None) -> dict[str, Any]:
    """Recompute availability/churn/lag/violations from the RAW event
    log alone — independent of ``SloTracker``'s incremental view.  The
    property tests assert the tracker's summary equals this, across
    seeded scenarios: any drift between the O(batch) incremental update
    and ground truth is a bug (docs/SIMULATOR.md).

    Mirrors the tracker's arithmetic exactly (change-compressed step
    timeline, in-order integral) so equality is EXACT, not approximate.
    """
    init = next(e for e in events if e["kind"] == "init")
    end = next(e for e in events if e["kind"] == "end")
    if floor is None:
        floor = init["floor"]
    placements: dict[str, dict[str, str]] = {}
    for pname, by_state in init["placements"].items():
        d: dict[str, str] = {}
        for state, ns in by_state.items():
            for n in ns:
                d[n] = state
        placements[pname] = d

    def availability() -> float:
        total = len(placements)
        if not total:
            return 1.0
        avail = sum(1 for d in placements.values()
                    if any(s == "primary" for s in d.values()))
        return avail / total

    timeline: list[tuple[float, float]] = [(0.0, availability())]
    executed = failed = 0
    t_last_progress = 0.0

    def note(t: float) -> None:
        a = availability()
        if a != timeline[-1][1]:
            timeline.append((t, a))

    for e in events:
        if e["kind"] == "batch":
            if e["ok"]:
                for part, node, state, _op in e["moves"]:
                    d = placements.get(part)
                    if d is None:
                        continue
                    d.pop(node, None)
                    if state:
                        d[node] = state
                executed += len(e["moves"])
                t_last_progress = e["t"]
                note(e["t"])
            else:
                failed += len(e["moves"])
        elif e["kind"] == "strip":
            for d in placements.values():
                for n in list(d):
                    if n in set(e["nodes"]):
                        d.pop(n)
            note(e["t"])

    t_end = end["t"]
    total = 0.0
    for (t_i, a_i), (t_j, _a_j) in zip(timeline, timeline[1:]):
        total += (t_j - t_i) * a_i
    t_last, a_last = timeline[-1]
    total += (t_end - t_last) * a_last
    tw = total / t_end if t_end > 0 else availability()

    intervals: list[tuple[float, float]] = []
    open_at: Optional[float] = None
    for t_i, a_i in timeline:
        if a_i < floor and open_at is None:
            open_at = t_i
        elif a_i >= floor and open_at is not None:
            intervals.append((open_at, t_i))
            open_at = None
    if open_at is not None:
        intervals.append((open_at, max(t_end, open_at)))

    return {
        "availability": availability(),
        "time_weighted_availability": tw,
        "violation_intervals": intervals,
        "violation_s": sum(e - s for s, e in intervals),
        "moves_executed": executed,
        "moves_failed": failed,
        "convergence_lag_s": max(t_end - t_last_progress, 0.0),
    }
