# Port of blance_tpu/analysis/schedule.py: the same scenarios over the
# port's orchestrator and testing.sched; the two that plan name their
# backend and device (greedy and the CPU, host-only as in the reference).
"""Deterministic schedule exploration of the orchestrator (RACE dynamic tier).

The static race lint (:mod:`.race_lint`) sees torn windows; this module
*drives* them: every scenario below builds a real orchestration inside
the controlled loop of :mod:`blance_tpu_torch.testing.sched` and is run under
many interleavings — bounded-exhaustive enumeration for the small
scenarios, pinned-seed random walks for the chaos ones — while checking
the control plane's declared dynamic invariants:

- progress counters are monotonic, pause/resume stay balanced, and the
  stream closes exactly once;
- ``progress.errors`` is append-only (every earlier snapshot a prefix of
  every later one) and, under fault-tolerant options, holds only
  structured ``MoveFailure``s;
- per-partition move cursors never reverse, and ``failed_at`` is
  write-once;
- ``achieved_map()`` equals ``beg_map`` with exactly the successfully
  executed callback batches applied (recomputed independently from the
  assign log);
- no schedule deadlocks, and a completed run reaches ``end_map``.

A violating schedule is emitted as a JSON trace (``testing.sched.Trace``)
that replays the exact interleaving — the race becomes a deterministic
regression test (see ``tests/test_race_regressions.py`` for the
committed pause-guard trace that fails on the pre-fix supplier).

CLI (the CI ``race-smoke`` step)::

    python -m blance_tpu_torch.analysis.schedule --ci [--trace-dir DIR]
    python -m blance_tpu_torch.analysis.schedule --scenario NAME --budget 2
    python -m blance_tpu_torch.analysis.schedule --scenario NAME --seeds 1,2,3

``--ci`` runs the bounded-exhaustive pass over the small scenarios plus
the pinned-seed walk batch over the chaos scenarios, writes any
violating schedule into ``--trace-dir``, and exits nonzero.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys
from dataclasses import dataclass
from typing import Any, Callable, Coroutine, Optional

from ..core.types import Partition, PartitionMap, PartitionModelState
from ..orchestrate.faults import FaultPlan, NodeFaults
from ..orchestrate.health import HALF_OPEN, HealthTracker
from ..orchestrate.orchestrator import (
    MoveFailure,
    Orchestrator,
    OrchestratorOptions,
    OrchestratorProgress,
    orchestrate_moves,
)
from ..testing.sched import (
    ExploreReport,
    InvariantViolation,
    RandomWalkPolicy,
    ScheduleOutcome,
    Trace,
    explore,
    run_controlled,
    save_trace,
)

__all__ = [
    "SCENARIOS",
    "Scenario",
    "ProgressInvariants",
    "run_scenario_walks",
    "run_scenario_exhaustive",
    "main",
]

# Pinned walk seeds for the CI chaos batch: three fixed, documented
# seeds — reproducible forever, diverse enough to hit distinct
# interleaving families (each seed drives a full random walk).
CI_WALK_SEEDS = (11, 23, 37)

_MODEL = {"primary": PartitionModelState(priority=0, constraints=0)}


def _pm(d: dict[str, dict[str, list[str]]]) -> PartitionMap:
    return {name: Partition(name, {s: list(ns) for s, ns in nbs.items()})
            for name, nbs in d.items()}


# -- invariants --------------------------------------------------------------


class ProgressInvariants:
    """Fold progress snapshots, raising InvariantViolation on any break.

    Checks the invariants that must hold under EVERY schedule: counter
    monotonicity, append-only errors, cursor monotonicity (sampled per
    snapshot via ``visit_next_moves``), failed_at write-once, and — at
    ``finish()`` — close-once plus achieved-map consistency against the
    independently recorded assign log.
    """

    def __init__(self, o: Orchestrator,
                 ft_errors_structured: bool = False) -> None:
        self._o = o
        self._ft = ft_errors_structured
        self._last: Optional[OrchestratorProgress] = None
        self._monotone = [
            name for name in OrchestratorProgress().__dict__
            if name != "errors"]
        self._cursors: dict[str, int] = {}
        self._failed_at: dict[str, Optional[int]] = {}
        self.snapshots = 0

    def observe(self, progress: OrchestratorProgress) -> None:
        self.snapshots += 1
        last = self._last
        if last is not None:
            for name in self._monotone:
                cur, prev = getattr(progress, name), getattr(last, name)
                if cur < prev:
                    raise InvariantViolation(
                        f"counter {name} regressed: {prev} -> {cur}")
            if progress.errors[:len(last.errors)] != last.errors:
                raise InvariantViolation(
                    "progress.errors is not append-only: "
                    f"{last.errors!r} is not a prefix of "
                    f"{progress.errors!r}")
        if progress.tot_pause_new_assignments < \
                progress.tot_resume_new_assignments:
            raise InvariantViolation(
                f"resume counter overtook pause: "
                f"{progress.tot_pause_new_assignments} < "
                f"{progress.tot_resume_new_assignments}")
        if self._ft:
            for e in progress.errors:
                if not isinstance(e, MoveFailure):
                    raise InvariantViolation(
                        f"unstructured error under fault-tolerant "
                        f"options: {type(e).__name__}: {e}")
        self._last = progress
        self._check_cursors()

    def _check_cursors(self) -> None:
        def check(m: dict[str, Any]) -> None:
            for name, nm in m.items():
                prev = self._cursors.get(name, 0)
                if nm.next < prev:
                    raise InvariantViolation(
                        f"cursor reversed for partition {name}: "
                        f"{prev} -> {nm.next}")
                self._cursors[name] = nm.next
                prev_failed = self._failed_at.get(name)
                if prev_failed is not None and \
                        nm.failed_at != prev_failed:
                    raise InvariantViolation(
                        f"failed_at rewritten for partition {name}: "
                        f"{prev_failed} -> {nm.failed_at}")
                self._failed_at[name] = nm.failed_at

        self._o.visit_next_moves(check)

    def finish(
        self,
        executed: Optional[list[tuple[str, tuple[str, ...],
                                      tuple[str, ...],
                                      tuple[str, ...]]]] = None,
        expect_complete: bool = False,
    ) -> None:
        last = self._last
        if last is None:
            raise InvariantViolation("progress stream closed with no "
                                     "snapshots")
        if last.tot_progress_close != 1:
            raise InvariantViolation(
                f"tot_progress_close == {last.tot_progress_close} "
                f"after stream close (must be exactly 1)")
        if executed is not None:
            self._check_achieved(executed)
        if expect_complete:
            achieved = self._o.achieved_map()
            if achieved != self._o.end_map:
                raise InvariantViolation(
                    "clean run did not reach end_map: "
                    f"achieved={achieved!r}")
            if last.errors:
                raise InvariantViolation(
                    f"clean run recorded errors: {last.errors!r}")

    def _check_achieved(
        self,
        executed: list[tuple[str, tuple[str, ...], tuple[str, ...],
                             tuple[str, ...]]],
    ) -> None:
        """achieved_map() must equal beg_map + successfully executed
        moves, recomputed here from the assign log alone."""
        expect: dict[str, dict[str, list[str]]] = {
            name: {s: list(ns) for s, ns in p.nodes_by_state.items()}
            for name, p in self._o.beg_map.items()}
        for node, partitions, states, ops in executed:
            for pname, state in zip(partitions, states):
                nbs = expect[pname]
                for ns in nbs.values():
                    if node in ns:
                        ns.remove(node)
                if state:
                    nbs.setdefault(state, []).append(node)
        achieved = self._o.achieved_map()
        got = {name: {s: list(ns) for s, ns in p.nodes_by_state.items()}
               for name, p in achieved.items()}
        # Normalize empty state lists both ways (a state emptied by a
        # removal vs never present).
        def norm(m: dict[str, dict[str, list[str]]]) \
                -> dict[str, dict[str, list[str]]]:
            return {name: {s: sorted(ns) for s, ns in nbs.items() if ns}
                    for name, nbs in m.items()}
        if norm(got) != norm(expect):
            raise InvariantViolation(
                f"achieved_map inconsistent with executed moves:\n"
                f"  achieved: {norm(got)!r}\n"
                f"  from log: {norm(expect)!r}")


def _logging_assign(
    executed: list[tuple[str, tuple[str, ...], tuple[str, ...],
                         tuple[str, ...]]],
) -> Callable[..., Coroutine[Any, Any, None]]:
    """An async assign callback that records each SUCCESSFUL batch
    (append happens after the yield, so a cancelled/timed-out callback
    never logs — matching the orchestrator's not-applied assumption)."""

    async def assign(stop_ch: Any, node: str, partitions: list[str],
                     states: list[str], ops: list[str]) -> None:
        await asyncio.sleep(0)
        executed.append((node, tuple(partitions), tuple(states),
                         tuple(ops)))

    return assign


# -- scenarios ---------------------------------------------------------------


@dataclass(frozen=True)
class Scenario:
    """One explorable orchestration scenario.

    ``factory()`` returns a FRESH coroutine: the whole orchestration is
    built inside it, and it raises InvariantViolation (or deadlocks)
    when a schedule breaks an invariant.  ``exhaustive`` scenarios are
    small enough for the bounded-exhaustive CI pass with the given
    ``branch_budget``; every scenario also supports seeded walks.
    """

    name: str
    doc: str
    factory: Callable[[], Coroutine[Any, Any, Any]]
    exhaustive: bool = False
    branch_budget: Optional[int] = 2
    max_schedules: int = 4000


async def _two_movers_three_partitions() -> dict[str, int]:
    """The acceptance scenario: 2 movers, 3 partitions, 6 moves, legacy
    options — every interleaving must preserve every invariant and end
    at end_map with the exact per-partition op sequences."""
    beg = _pm({"p0": {"primary": ["n1"]},
               "p1": {"primary": ["n2"]},
               "p2": {"primary": ["n1"]}})
    end = _pm({"p0": {"primary": ["n2"]},
               "p1": {"primary": ["n1"]},
               "p2": {"primary": ["n2"]}})
    executed: list[tuple[str, tuple[str, ...], tuple[str, ...],
                         tuple[str, ...]]] = []
    o = orchestrate_moves(_MODEL, OrchestratorOptions(), ["n1", "n2"],
                          beg, end, _logging_assign(executed))
    inv = ProgressInvariants(o)
    plans: dict[str, list[tuple[str, str, str]]] = {}
    o.visit_next_moves(lambda m: plans.update(
        {k: [(mv.node, mv.state, mv.op) for mv in v.moves]
         for k, v in m.items()}))
    async for progress in o.progress_ch():
        inv.observe(progress)
    o.stop()
    inv.finish(executed=executed, expect_complete=True)
    # Exact per-partition execution order == the up-front move plans.
    seen: dict[str, list[tuple[str, str, str]]] = {}
    for node, partitions, states, ops in executed:
        for p, s, op in zip(partitions, states, ops):
            seen.setdefault(p, []).append((node, s, op))
    if seen != plans:
        raise InvariantViolation(
            f"executed ops diverge from move plans:\n  plans: "
            f"{plans!r}\n  seen: {seen!r}")
    return {"snapshots": inv.snapshots, "batches": len(executed)}


async def _pause_cycle_guard() -> dict[str, int]:
    """The pause-guard regression: a pause→resume→pause cycle landing
    inside the supplier's pause-counter put must NOT let a new round
    feed while paused.  The assign callback asserts the invariant
    directly; the scenario scripts the racy cycle and then resumes via
    an out-of-band timer so the fixed supplier (which correctly honors
    the second pause) completes."""
    beg = _pm({"p0": {"primary": []}, "p1": {"primary": []}})
    end = _pm({"p0": {"primary": ["n1"]}, "p1": {"primary": ["n1"]}})

    o: Optional[Orchestrator] = None

    async def assign(stop_ch: Any, node: str, partitions: list[str],
                     states: list[str], ops: list[str]) -> None:
        assert o is not None
        if o._pause_ch is not None:
            raise InvariantViolation(
                f"assign started for {partitions!r} on {node!r} while "
                f"new assignments are paused (torn pause guard)")
        await asyncio.sleep(0)

    o = orchestrate_moves(_MODEL, OrchestratorOptions(), ["n1"],
                          beg, end, assign)
    inv = ProgressInvariants(o)
    # Pause before the supplier's first round can feed anything.
    o.pause_new_assignments()
    cycled = False

    async def resume_later() -> None:
        await asyncio.sleep(0.001)  # virtual time: fires when loop idles
        o.resume_new_assignments()

    resumer: Optional[asyncio.Task[None]] = None
    async for progress in o.progress_ch():
        inv.observe(progress)
        for e in progress.errors:
            # The torn-guard assign assertion is caught by the
            # orchestrator as an app error; surface it as the scenario
            # failure it is.
            if isinstance(e, InvariantViolation):
                raise e
        if not cycled and progress.tot_run_supply_moves_pause >= 1:
            # The supplier is inside its pause window (the bump put just
            # rendezvoused with us): cycle resume->pause to strand it on
            # a stale channel if the guard is torn.
            cycled = True
            o.resume_new_assignments()
            o.pause_new_assignments()
            resumer = asyncio.ensure_future(resume_later())
    o.stop()
    if resumer is not None:
        await resumer
    if not cycled:
        raise InvariantViolation("scenario never cycled pause/resume — "
                                 "driver drifted from the code under test")
    inv.finish(expect_complete=True)
    return {"snapshots": inv.snapshots}


async def _pause_resume_during_retry_backoff() -> dict[str, int]:
    """Pause/resume while a mover sits in a retry backoff: the backoff
    finishes, the retried move lands after the heal, and every
    counter/error invariant holds along the way."""
    beg = _pm({f"p{i}": {"primary": ["a"]} for i in range(3)})
    end = _pm({f"p{i}": {"primary": ["b"]} for i in range(3)})
    plan = FaultPlan(seed=1, nodes={"b": NodeFaults(dead=True,
                                                    heal_after=2)})
    executed: list[tuple[str, tuple[str, ...], tuple[str, ...],
                         tuple[str, ...]]] = []
    o = orchestrate_moves(
        _MODEL,
        OrchestratorOptions(move_timeout_s=0.25, max_retries=4,
                            backoff_base_s=0.002, backoff_jitter=0.25),
        ["a", "b"], beg, end, plan.wrap(_logging_assign(executed)))
    inv = ProgressInvariants(o, ft_errors_structured=True)
    paused = False

    async def resume_later() -> None:
        await asyncio.sleep(0.001)
        o.resume_new_assignments()

    resumer: Optional[asyncio.Task[None]] = None
    async for progress in o.progress_ch():
        inv.observe(progress)
        if not paused and progress.tot_mover_assign_partition_retry >= 1:
            paused = True
            o.pause_new_assignments()
            resumer = asyncio.ensure_future(resume_later())
    o.stop()
    if resumer is not None:
        await resumer
    if not paused:
        raise InvariantViolation("no retry observed — the fault plan "
                                 "no longer forces retries")
    inv.finish(executed=executed, expect_complete=True)
    return {"snapshots": inv.snapshots,
            "retries": o._progress.tot_mover_assign_partition_retry}


async def _stop_during_quarantine_probe() -> dict[str, int]:
    """stop() landing in the breaker's half-open probe window: the
    wind-down must complete under every interleaving, with counters and
    the error stream intact.

    Probe admission is structural, not lucky: partition ``p0`` trips
    ``dead``'s breaker at virtual time 0 (every schedule must drain the
    runnable frontier before the loop can idle, so the trip always
    precedes the first timer).  Partitions ``q*`` sequence a ``slow``
    primary move BEFORE their dead-targeted replica move; ``slow``'s
    0.005 s of virtual work advances the clock past the 0.001 s probe
    dwell, so when the replica move reaches the dead mover the breaker
    is ripe for a half-open probe — which ``heal_after=2`` lets
    succeed.  The consumer stops the instant it observes the half-open
    state, so the wind-down races the in-flight probe."""
    loop = asyncio.get_running_loop()
    model = {"primary": PartitionModelState(priority=0, constraints=0),
             "replica": PartitionModelState(priority=1, constraints=1)}
    beg = _pm({"p0": {"primary": ["dead"], "replica": []},
               "q0": {"primary": ["a"], "replica": []},
               "q1": {"primary": ["a"], "replica": []}})
    end = _pm({"p0": {"primary": ["a"], "replica": []},
               "q0": {"primary": ["slow"], "replica": ["dead"]},
               "q1": {"primary": ["slow"], "replica": ["dead"]}})
    plan = FaultPlan(seed=4, nodes={"dead": NodeFaults(dead=True,
                                                       heal_after=2)})
    health = HealthTracker(threshold=1, probe_after_s=0.001,
                           clock=loop.time)

    async def assign(stop_ch: Any, node: str, partitions: list[str],
                     states: list[str], ops: list[str]) -> None:
        # Virtual-time work on the slow node idles the loop, advancing
        # the clock past the breaker's probe dwell.
        await asyncio.sleep(0.005 if node == "slow" else 0.0)

    o = orchestrate_moves(
        model,
        OrchestratorOptions(move_timeout_s=0.25, max_retries=0,
                            health=health),
        ["a", "dead", "slow"], beg, end, plan.wrap(assign))
    inv = ProgressInvariants(o, ft_errors_structured=True)
    stopped = False
    async for progress in o.progress_ch():
        inv.observe(progress)
        if not stopped and health.state("dead") == HALF_OPEN:
            stopped = True
            o.stop()
    if not stopped:
        o.stop()
    inv.finish()
    if o._progress.tot_quarantine_trips < 1:
        raise InvariantViolation("breaker never tripped — scenario "
                                 "drifted from the code under test")
    return {"snapshots": inv.snapshots,
            "stopped_during_probe": int(stopped),
            "trips": o._progress.tot_quarantine_trips}


async def _movers_race_breaker_trip() -> dict[str, int]:
    """Two movers pounding two failing nodes race their breaker trips
    and quarantine releases against the supplier's rounds; the failure
    bookkeeping must stay exact under every interleaving."""
    beg = _pm({f"p{i}": {"primary": ["ok"]} for i in range(4)})
    end = _pm({f"p{i}": {"primary": ["bad1" if i % 2 else "bad2"]}
               for i in range(4)})
    plan = FaultPlan(seed=9, nodes={"bad1": NodeFaults(dead=True),
                                    "bad2": NodeFaults(dead=True)})
    executed: list[tuple[str, tuple[str, ...], tuple[str, ...],
                         tuple[str, ...]]] = []
    o = orchestrate_moves(
        _MODEL,
        OrchestratorOptions(move_timeout_s=0.25, max_retries=1,
                            backoff_base_s=0.002, quarantine_after=1,
                            probe_after_s=60.0),
        ["ok", "bad1", "bad2"], beg, end,
        plan.wrap(_logging_assign(executed)))
    inv = ProgressInvariants(o, ft_errors_structured=True)
    async for progress in o.progress_ch():
        inv.observe(progress)
    o.stop()
    inv.finish(executed=executed)
    last = o._progress
    if last.tot_move_failures != len(o.move_failures()):
        raise InvariantViolation(
            f"failure counter ({last.tot_move_failures}) diverges from "
            f"move_failures() ({len(o.move_failures())})")
    if len(last.errors) != last.tot_move_failures:
        raise InvariantViolation(
            f"errors stream ({len(last.errors)}) diverges from the "
            f"failure counter ({last.tot_move_failures})")
    if last.tot_quarantine_trips < 2:
        raise InvariantViolation(
            f"expected both breakers to trip, got "
            f"{last.tot_quarantine_trips} trips")
    return {"snapshots": inv.snapshots,
            "failures": last.tot_move_failures,
            "trips": last.tot_quarantine_trips}


async def _slo_gauges_under_chaos() -> dict[str, int]:
    """The live-telemetry plane under chaos: every interleaving must
    keep the SLO gauges well-formed — availability within [0, 1] at
    every progress snapshot, the executed-move count monotone,
    convergence lag non-negative — and at the end the tracker's
    incrementally maintained view must agree EXACTLY with both the
    independently logged assign batches and a from-scratch availability
    recompute off ``achieved_map()``.  The whole run (orchestrator
    clocks included) rides a virtual-time Recorder, so gauge values are
    pure functions of the schedule."""
    from ..obs import Recorder, use_recorder
    from ..obs.slo import SloTracker

    loop = asyncio.get_running_loop()
    beg = _pm({f"p{i}": {"primary": ["a"]} for i in range(4)})
    end = _pm({"p0": {"primary": ["b"]}, "p1": {"primary": ["b"]},
               "p2": {"primary": ["bad"]}, "p3": {"primary": ["flaky"]}})
    plan = FaultPlan(seed=13, nodes={
        "bad": NodeFaults(dead=True),
        "flaky": NodeFaults(fail_rate=0.5),
    })
    executed: list[tuple[str, tuple[str, ...], tuple[str, ...],
                         tuple[str, ...]]] = []
    with use_recorder(Recorder(clock=loop.time)) as rec:
        slo = SloTracker(beg, primary_states=("primary",),
                         clock=loop.time, recorder=rec)
        o = orchestrate_moves(
            _MODEL,
            OrchestratorOptions(move_timeout_s=0.25, max_retries=2,
                                backoff_base_s=0.002, quarantine_after=2,
                                probe_after_s=60.0),
            ["a", "b", "bad", "flaky"], beg, end,
            plan.wrap(_logging_assign(executed)), move_observers=(slo,))
        o.visit_next_moves(lambda m: slo.set_min_moves(
            sum(len(nm.moves) for nm in m.values())))
        slo.attach_health(o.health)
        inv = ProgressInvariants(o, ft_errors_structured=True)
        prev_executed = 0
        async for progress in o.progress_ch():
            inv.observe(progress)
            a = slo.availability()
            if not 0.0 <= a <= 1.0:
                raise InvariantViolation(f"availability out of [0,1]: {a}")
            if slo.moves_executed < prev_executed:
                raise InvariantViolation(
                    f"executed-move count regressed: {prev_executed} -> "
                    f"{slo.moves_executed}")
            prev_executed = slo.moves_executed
            if slo.convergence_lag_s() < 0.0:
                raise InvariantViolation("negative convergence lag")
            if slo.churn_ratio() < 0.0:
                raise InvariantViolation("negative churn")
        o.stop()
        inv.finish(executed=executed)
        logged = sum(len(parts) for _node, parts, _s, _o in executed)
        if slo.moves_executed != logged:
            raise InvariantViolation(
                f"tracker executed {slo.moves_executed} != {logged} "
                f"batches logged by the assign callback")
        achieved = o.achieved_map()
        recomputed = sum(
            1 for p in achieved.values()
            if p.nodes_by_state.get("primary")) / len(achieved)
        if abs(recomputed - slo.availability()) > 1e-12:
            raise InvariantViolation(
                f"incremental availability {slo.availability()} diverges "
                f"from achieved-map recompute {recomputed}")
    return {"snapshots": inv.snapshots, "executed": logged,
            "failed": slo.moves_failed}


async def _reschedule_on_quarantine() -> dict[str, int]:
    """The critical-path scheduler's online-reschedule path:
    a breaker trip mid-schedule must rebuild the plan in one atomic
    window — under EVERY interleaving the rebuilt (plan, remaining)
    snapshot pair stays consistent:

    - every unfinished move reappears in the rebuilt schedule exactly
      once (scheduled on a lane XOR stalled, never both, none lost);
    - no orphan lanes: nothing is scheduled onto a quarantined node,
      and every lane index is within the machine's capacity;
    - cursors never reverse and failed_at is write-once (the standard
      ProgressInvariants), with achieved_map consistent against the
      independently logged assign batches."""
    from ..obs import Recorder, use_recorder
    from ..orchestrate.sched import CriticalPathScheduler
    from ..orchestrate.sched.policy import _CriticalPathBound

    loop = asyncio.get_running_loop()
    beg = _pm({f"p{i}": {"primary": ["a"]} for i in range(4)})
    end = _pm({"p0": {"primary": ["dead"]}, "p1": {"primary": ["dead"]},
               "p2": {"primary": ["b"]}, "p3": {"primary": ["b"]}})
    plan = FaultPlan(seed=17, nodes={"dead": NodeFaults(dead=True)})
    executed: list[tuple[str, tuple[str, ...], tuple[str, ...],
                         tuple[str, ...]]] = []
    max_lanes = 2
    with use_recorder(Recorder(clock=loop.time)):
        o = orchestrate_moves(
            _MODEL,
            OrchestratorOptions(
                move_timeout_s=0.25, max_retries=0, quarantine_after=1,
                probe_after_s=60.0,
                max_concurrent_partition_moves_per_node=max_lanes,
                scheduler=CriticalPathScheduler()),
            ["a", "b", "dead"], beg, end,
            plan.wrap(_logging_assign(executed)))
        bound = o.sched
        assert isinstance(bound, _CriticalPathBound)
        inv = ProgressInvariants(o, ft_errors_structured=True)
        async for progress in o.progress_ch():
            inv.observe(progress)
            # The (plan, last_remaining) pair must be consistent at
            # EVERY observation point, not just at the end — _build
            # writes both in one no-await window.
            keys = [(m.partition, m.index) for m in bound.plan.moves]
            if len(set(keys)) != len(keys):
                raise InvariantViolation(
                    f"duplicate moves in the schedule: {keys!r}")
            all_keys = set(keys) | set(bound.plan.stalled)
            if len(keys) + len(bound.plan.stalled) != len(all_keys):
                raise InvariantViolation(
                    "a move is both scheduled and stalled: "
                    f"{keys!r} / {bound.plan.stalled!r}")
            if all_keys != set(bound.last_remaining):
                raise InvariantViolation(
                    "rebuilt schedule diverges from the remaining set: "
                    f"plan+stalled={sorted(all_keys)!r} vs "
                    f"remaining={sorted(bound.last_remaining)!r}")
            for mv in bound.plan.moves:
                if mv.node in bound.quarantined():
                    raise InvariantViolation(
                        f"orphan lane: {mv!r} scheduled onto "
                        f"quarantined node {mv.node!r}")
                if not 0 <= mv.lane < max_lanes:
                    raise InvariantViolation(
                        f"lane {mv.lane} outside machine capacity "
                        f"{max_lanes} for {mv!r}")
        o.stop()
        inv.finish(executed=executed)
        if o._progress.tot_quarantine_trips < 1:
            raise InvariantViolation("breaker never tripped — scenario "
                                     "drifted from the code under test")
        if bound.reschedules < 1:
            raise InvariantViolation(
                "quarantine trip did not trigger a reschedule")
    return {"snapshots": inv.snapshots, "reschedules": bound.reschedules,
            "trips": o._progress.tot_quarantine_trips}


async def _supersede_mid_rebalance() -> dict[str, int]:
    """The continuous-rebalance controller's supersede path: a second
    cluster delta fired from INSIDE the first transition's assign
    callback (structurally mid-flight) must cancel cleanly — no orphan
    tasks after wind-down, no spurious failures — and the loop must
    land on the SAME final map as a quiesced sequential run.  The
    survivors here reduce to one node, so the sequential reference is
    unique regardless of which prefix of the first transition executed
    before the cancel.  Under most schedules the delta supersedes the
    in-flight pass (``superseded == 1``); a schedule that lets the pass
    finish first handles it as a second cycle — both must converge
    identically."""
    from ..obs import Recorder, use_recorder
    from ..plan.api import plan_next_map
    from ..rebalance import ClusterDelta, RebalanceController, count_moves

    loop = asyncio.get_running_loop()
    nodes = ["a", "b", "c"]
    # Unlike the scripted-move scenarios above, this one PLANS — the
    # model needs a real constraint (1 primary per partition), not the
    # constraints=0 placeholder of _MODEL.
    plan_model = {"primary": PartitionModelState(priority=0,
                                                 constraints=1)}
    beg = _pm({f"p{i}": {"primary": [nodes[i % 3]]} for i in range(4)})
    with use_recorder(Recorder(clock=loop.time)):
        fired = False
        ctl: Optional[RebalanceController] = None

        async def assign(stop_ch: Any, node: str, partitions: list[str],
                         states: list[str], ops: list[str]) -> None:
            nonlocal fired
            assert ctl is not None
            if not fired:
                fired = True
                ctl.submit(ClusterDelta(fail=("b",)))
            await asyncio.sleep(0.01)

        ctl = RebalanceController(plan_model, nodes, beg, assign,
                                  backend="greedy", device="cpu",
                                  debounce_s=0.001)
        ctl.start()
        ctl.submit(ClusterDelta(remove=("a",)))
        final = await ctl.quiesce()
        await ctl.stop()
        for _ in range(3):  # let just-resolved movers finalize
            await asyncio.sleep(0)
        if ctl.pending_tasks():
            raise InvariantViolation(
                f"orphan tasks after cancel + wind-down: "
                f"{[t.get_name() for t in ctl.pending_tasks()]}")
        if ctl.failures:
            raise InvariantViolation(
                f"spurious failures on a fault-free supersede: "
                f"{ctl.failures!r}")
        if not fired:
            raise InvariantViolation(
                "the mid-flight delta never fired — scenario drifted "
                "from the code under test")
        # Sequential reference: quiesce delta 1 fully, then delta 2 —
        # pure planning, schedule-independent (c is the only survivor,
        # so the final map is unique).
        m1, _w1 = plan_next_map(beg, beg, nodes, ["a"], [], plan_model,
                                backend="greedy")
        m2, _w2 = plan_next_map(m1, m1, nodes, ["a", "b"], [], plan_model,
                                backend="greedy")
        if count_moves(plan_model, m2, final) != 0:
            raise InvariantViolation(
                f"superseded run diverged from the quiesced sequential "
                f"reference:\n  sequential: "
                f"{ {k: v.nodes_by_state for k, v in m2.items()} !r}\n"
                f"  superseded: "
                f"{ {k: v.nodes_by_state for k, v in final.items()} !r}")
        if any(p.nodes_by_state.get("primary") != ["c"]
               for p in final.values()):
            raise InvariantViolation(
                f"final map incomplete on the sole survivor: "
                f"{ {k: v.nodes_by_state for k, v in final.items()} !r}")
    return {"superseded": ctl.superseded, "cycles": ctl.cycles,
            "cancels": ctl.superseded}


async def _fleet_coalesce_window() -> dict[str, int]:
    """The plan service's coalescing window under admission fairness
    (docs/FLEET.md): a chatty tenant fires three CONCURRENT requests against
    ``fair_share=1`` while two calm neighbors submit one each, under
    arbitrary interleavings of the submitters, the dispatcher and the
    window timer.  Invariants: every future resolves exactly once with
    its own tenant's bit-exact single-problem solve (cross-wiring would
    surface as a foreign assign), no batch ever holds more than
    fair_share requests of one key, the starved counter equals the
    observed deferral events, and stop() strands nothing."""
    import numpy as np

    from ..obs import Recorder, use_recorder
    from ..plan.fleet import TenantProblem, solve_fleet
    from ..plan.service import PlanService

    loop = asyncio.get_running_loop()

    def tenant(key: str, seed: int) -> Any:
        P, N, S, R = 2, 3, 1, 1
        prev = np.full((P, S, R), -1, np.int32)
        prev[0, 0, 0] = seed % N
        prev[1, 0, 0] = (seed + 1) % N
        return TenantProblem(
            key=key, prev=prev,
            partition_weights=np.ones(P, np.float32),
            node_weights=np.ones(N, np.float32),
            valid_node=np.ones(N, bool),
            stickiness=np.full((P, S), 1.5, np.float32),
            gids=np.arange(N, dtype=np.int32).reshape(1, N),
            gid_valid=np.ones((1, N), bool),
            constraints=(1,), rules=((),))

    seeds = {"chatty": 0, "calm-b": 1, "calm-c": 2}
    # The oracle: each tenant's single-problem fleet solve (the service
    # result must be bit-identical to it, whatever the batching).
    expected = {key: solve_fleet([tenant(key, s)], record=False,
                                 device="cpu")[0].assign
                for key, s in seeds.items()}

    batches: list[list[str]] = []
    deferrals = 0

    class _Capturing(PlanService):
        def _solve_batch(self, problems: list[Any],
                         trace_ids: dict[str, Any]) -> Any:
            batches.append([t.key for t in problems])
            return super()._solve_batch(problems, trace_ids)

        def _defer(self, req: Any) -> None:
            nonlocal deferrals
            deferrals += 1
            super()._defer(req)

    rec = Recorder(clock=loop.time)
    with use_recorder(rec):
        svc = _Capturing(admission_window_s=0.01, fair_share=1,
                         inline_solve=True, max_pending=8, recorder=rec,
                         device="cpu")
        await svc.start()
        results: dict[str, Any] = {}

        async def one(key: str, tag: str) -> None:
            results[tag] = await svc.submit(tenant(key, seeds[key]))

        tasks = [asyncio.ensure_future(one("chatty", f"chatty{i}"))
                 for i in range(3)]
        tasks += [asyncio.ensure_future(one("calm-b", "b")),
                  asyncio.ensure_future(one("calm-c", "c"))]
        await asyncio.gather(*tasks)
        await svc.stop()

    if len(results) != 5:
        raise InvariantViolation(
            f"{5 - len(results)} submit futures never resolved")
    for tag, res in results.items():
        key = "chatty" if tag.startswith("chatty") else \
            ("calm-b" if tag == "b" else "calm-c")
        if res.key != key:
            raise InvariantViolation(
                f"request {tag} resolved with tenant {res.key!r}: "
                f"cross-wired batch")
        if not np.array_equal(res.assign, expected[key]):
            raise InvariantViolation(
                f"request {tag} diverged from the single-problem "
                f"oracle: batching must be bit-neutral")
    for keys in batches:
        counts: dict[str, int] = {}
        for k in keys:
            counts[k] = counts.get(k, 0) + 1
        if any(c > 1 for c in counts.values()):
            raise InvariantViolation(
                f"a batch exceeded fair_share=1 for one tenant: {keys}")
    starved = int(rec.counters.get("fleet.starved_admissions", 0))
    if starved != deferrals:
        raise InvariantViolation(
            f"starved counter {starved} != observed deferral events "
            f"{deferrals}")
    return {"batches": len(batches), "starved": starved,
            "resolved": len(results)}


SCENARIOS: dict[str, Scenario] = {
    s.name: s for s in (
        Scenario(
            name="two_movers_three_partitions",
            doc="2 movers / 3 partitions / 6 moves, legacy options: "
                "full invariant suite + exact op sequences",
            factory=_two_movers_three_partitions,
            exhaustive=True, branch_budget=2, max_schedules=12000),
        Scenario(
            name="pause_cycle_guard",
            doc="pause->resume->pause cycle inside the supplier's "
                "pause window must never feed while paused",
            factory=_pause_cycle_guard,
            exhaustive=True, branch_budget=2, max_schedules=4000),
        Scenario(
            name="pause_resume_during_retry_backoff",
            doc="pause/resume while a mover is in retry backoff "
                "(seeded chaos walks)",
            factory=_pause_resume_during_retry_backoff),
        Scenario(
            name="stop_during_quarantine_probe",
            doc="stop() inside the breaker's half-open probe window "
                "(seeded chaos walks)",
            factory=_stop_during_quarantine_probe),
        Scenario(
            name="movers_race_breaker_trip",
            doc="two movers race breaker trips on two dead nodes "
                "(seeded chaos walks)",
            factory=_movers_race_breaker_trip),
        Scenario(
            name="slo_gauges_under_chaos",
            doc="SLO gauges stay well-formed and agree with the "
                "achieved map under chaos (seeded chaos walks)",
            factory=_slo_gauges_under_chaos),
        Scenario(
            name="reschedule_on_quarantine",
            doc="a breaker trip mid-schedule rebuilds the critical-"
                "path plan: every unfinished move exactly once, no "
                "orphan lanes, cursors never reverse (seeded chaos "
                "walks)",
            factory=_reschedule_on_quarantine),
        Scenario(
            name="supersede_mid_rebalance",
            doc="a delta mid-rebalance cancels cleanly (no orphan "
                "tasks) and lands on the sequential run's final map "
                "(seeded chaos walks)",
            factory=_supersede_mid_rebalance),
        Scenario(
            name="fleet_coalesce_window",
            doc="plan-service coalescing window under admission "
                "fairness: a chatty tenant vs fair_share=1 — every "
                "request resolves bit-exactly, no batch over quota, "
                "starved counter consistent (seeded chaos walks)",
            factory=_fleet_coalesce_window),
    )
}


# -- runners -----------------------------------------------------------------


# "use the scenario's own budget" sentinel for run_scenario_exhaustive —
# distinct from None, which (as in explore()) means a true unbounded
# exhaustive enumeration.
_SCENARIO_DEFAULT = object()


def run_scenario_exhaustive(
    scenario: Scenario,
    branch_budget: object = _SCENARIO_DEFAULT,
    max_schedules: Optional[int] = None,
) -> ExploreReport:
    budget: Optional[int]
    if branch_budget is _SCENARIO_DEFAULT:
        budget = scenario.branch_budget
    else:
        assert branch_budget is None or isinstance(branch_budget, int)
        budget = branch_budget
    return explore(
        scenario.factory,
        branch_budget=budget,
        max_schedules=(scenario.max_schedules if max_schedules is None
                       else max_schedules))


def run_scenario_walks(
    scenario: Scenario, seeds: tuple[int, ...] = CI_WALK_SEEDS,
) -> list[tuple[int, ScheduleOutcome]]:
    return [(seed,
             run_controlled(scenario.factory, RandomWalkPolicy(seed)))
            for seed in seeds]


def _emit_traces(scenario: str, violations: list[Any],
                 trace_dir: str, limit: int = 5) -> list[str]:
    os.makedirs(trace_dir, exist_ok=True)
    paths = []
    for i, v in enumerate(violations[:limit]):
        path = os.path.join(trace_dir, f"{scenario}-{i}.json")
        save_trace(v.to_trace(scenario), path)
        paths.append(path)
    return paths


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m blance_tpu_torch.analysis.schedule",
        description="deterministic schedule exploration of the "
                    "orchestrator (docs/STATIC_ANALYSIS.md)")
    ap.add_argument("--ci", action="store_true",
                    help="the race-smoke gate: bounded-exhaustive pass "
                         "over the small scenarios + pinned-seed walks "
                         "over the chaos scenarios")
    ap.add_argument("--scenario", default=None,
                    help="run one scenario by name")
    ap.add_argument("--list", action="store_true",
                    help="list scenarios and exit")
    ap.add_argument("--budget", type=int, default=None,
                    help="branch budget for exhaustive mode (-1 = "
                         "unbounded)")
    ap.add_argument("--max-schedules", type=int, default=None,
                    help="schedule cap for exhaustive mode")
    ap.add_argument("--seeds", default=None,
                    help="comma-separated walk seeds (walk mode)")
    ap.add_argument("--trace-dir", default="sched-traces",
                    help="where violating schedules are written as "
                         "replayable JSON traces")
    args = ap.parse_args(argv)

    if args.list:
        for s in SCENARIOS.values():
            kind = ("exhaustive" if s.exhaustive else "walk")
            print(f"{s.name:40s} [{kind}] {s.doc}")
        return 0

    budget: object = _SCENARIO_DEFAULT
    if args.budget is not None:
        # Negative = explicit None = truly unbounded enumeration; any
        # other value overrides the scenario's own bounded budget.
        budget = None if args.budget < 0 else args.budget

    failed = False

    def run_one(s: Scenario, exhaustive: bool,
                seeds: tuple[int, ...]) -> None:
        nonlocal failed
        if exhaustive:
            rep = run_scenario_exhaustive(
                s, branch_budget=budget, max_schedules=args.max_schedules)
            status = rep.summary()
            if rep.violations:
                failed = True
                paths = _emit_traces(s.name, rep.violations,
                                     args.trace_dir)
                status += " -> " + ", ".join(paths)
            if not rep.complete:
                # A capped enumeration silently stops checking the
                # coverage the gate promises — fail loudly so the
                # budget gets raised (or the scenario shrunk) instead.
                failed = True
                status += " — INCOMPLETE (raise --max-schedules or " \
                          "shrink the scenario)"
            print(f"explore {s.name}: {status}")
        else:
            for seed, out in run_scenario_walks(s, seeds):
                line = f"walk {s.name} seed={seed}: {out.describe()}"
                if not out.ok:
                    failed = True
                    os.makedirs(args.trace_dir, exist_ok=True)
                    path = os.path.join(args.trace_dir,
                                        f"{s.name}-seed{seed}.json")
                    save_trace(
                        Trace(scenario=s.name, choices=out.choices,
                              candidate_counts=out.candidate_counts,
                              seed=seed,
                              note=f"{type(out.error).__name__}: "
                                   f"{out.error}"),
                        path)
                    line += f" -> {path}"
                print(line)

    seeds = CI_WALK_SEEDS
    if args.seeds:
        seeds = tuple(int(x) for x in args.seeds.split(","))

    if args.scenario:
        s = SCENARIOS.get(args.scenario)
        if s is None:
            print(f"unknown scenario {args.scenario!r}; --list shows "
                  f"the registry", file=sys.stderr)
            return 2
        run_one(s, exhaustive=(s.exhaustive and args.seeds is None),
                seeds=seeds)
    elif args.ci:
        for s in SCENARIOS.values():
            if s.exhaustive:
                run_one(s, exhaustive=True, seeds=seeds)
        for s in SCENARIOS.values():
            # The exhaustive scenarios' walk interleavings are a strict
            # subset of the enumeration that just ran — chaos walks only.
            if not s.exhaustive:
                run_one(s, exhaustive=False, seeds=seeds)
    else:
        ap.print_help()
        return 2

    print("blance_tpu_torch.analysis.schedule: " +
          ("FAIL (traces in %s)" % args.trace_dir if failed else "OK"))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
