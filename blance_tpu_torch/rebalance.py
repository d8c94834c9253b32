# Copied from blance_tpu/rebalance.py.  Planning goes through the port's
# plan_next_map or, with session=, the port's PlannerSession (which solves
# on its own device); rebalance_async and RebalanceController take
# ``device`` ("cuda" by default) for the planner and the orchestrator's
# batched diff.  The controller's backend defaults to "auto" where the
# reference's defaults to "greedy": auto routes as the reference's does,
# to the exact native planner below the cell threshold and to the card
# above it, where "greedy" would keep every plan on the host.  Its
# journal= takes the port's durability.Journal (or any object with its
# feed methods), as the reference's does.
"""App-level rebalance facade: plan -> diff -> orchestrate in one call.

The reference leaves this composition to the application (SURVEY.md §3.4:
plan or hand-build the end map, call OrchestrateMoves, drain ProgressCh,
Stop).  This module packages the canonical wiring, with the checkpoint
story built in: the PartitionMap IS the checkpoint (JSON-serializable by
design, reference api.go:30-35), so a crashed rebalance resumes by
re-planning from the current map and orchestrating the remaining diff —
the planner is pure and idempotent at fixpoint (plan_test.go:1888-1908).

Failure-aware recovery (docs/DESIGN.md "Failure semantics & recovery"):
when the orchestrator options enable fault tolerance (deadlines /
retries / quarantine) and ``max_recovery_rounds > 0``, an orchestration
pass that left failed moves or quarantined nodes re-enters the planner —
quarantined nodes become ``nodes_to_remove``, the reconstructed achieved
map (with dead-node placements presumed lost) becomes the current map —
and runs another bounded pass.  Each round's outcome lands in
``RebalanceResult.rounds``; the node health tracker carries across
rounds so a dead node stays dead.  With a ``PlannerSession`` supplied,
recovery replans warm-start off the session's solver carry whenever the
failures were confined to the dead nodes (the only rows that differ from
the adopted proposal are exactly the rows the removal marks dirty).
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Callable, Iterable, Mapping, \
    Optional

from .control import CycleEngine, CyclePlanner
from .core.types import (
    Partition,
    PartitionMap,
    PartitionModel,
    PlanOptions,
    copy_partition_map,
    partition_map_from_json,
    partition_map_to_json,
)
from .moves.calc import calc_partition_moves
from .obs import get_recorder
from .obs.slo import SloSummary, SloTracker
from .orchestrate.health import HealthTracker
from .orchestrate.orchestrator import (
    FindMoveFunc,
    MoveFailure,
    Orchestrator,
    OrchestratorOptions,
    OrchestratorProgress,
    lowest_weight_partition_move_for_node,
    orchestrate_moves,
)
from .plan.api import plan_next_map
from .core.order import sort_state_names
from .utils.atomicio import atomic_write_json
from .utils.trace import PhaseTimer

if TYPE_CHECKING:  # annotation-only
    from .plan.session import PlannerSession

__all__ = [
    "ClusterDelta",
    "DegradedPlacement",
    "RebalanceController",
    "RebalanceResult",
    "RecoveryRound",
    "count_moves",
    "rebalance",
    "rebalance_async",
    "save_partition_map",
    "load_partition_map",
]


@dataclass(frozen=True)
class ClusterDelta:
    """One cluster-membership / workload change fed to the control loop.

    ``add``: nodes joining (or returning — a previously failed node
    re-added starts with a clean breaker slate).  ``remove``: graceful
    decommissions — the data is still there, the next plans drain it
    off.  ``fail``: abrupt losses (spot preemption, zone outage) — the
    placements are presumed gone NOW, availability drops immediately
    and the controller re-places from the survivors.  Weight mappings
    are merged over the controller's running view (hot-tenant drift)."""

    add: tuple[str, ...] = ()
    remove: tuple[str, ...] = ()
    fail: tuple[str, ...] = ()
    partition_weights: Optional[Mapping[str, int]] = None
    node_weights: Optional[Mapping[str, int]] = None


@dataclass
class DegradedPlacement:
    """A structured graceful-degradation report — returned as DATA when
    capacity cannot hold the constraint set, instead of an exception or
    a silently partial map.

    ``reason`` is ``"no-candidate-nodes"`` (every node removed, failed
    or quarantined: current placements are kept as-is — or, on a
    recovery round whose achieved map was already stripped, the empty
    placement — rather than draining data to nowhere),
    ``"capacity-shed"`` (fewer candidates than constraint slots per
    partition: lower-priority replicas were shed first, primaries kept
    to the last node; ``shed`` maps state -> replicas dropped from its
    constraint), or ``"no-fixpoint"`` (the planner kept producing moves
    for the whole pass budget without failures — greedy balance under
    skewed weights can oscillate — so the cycle was cut off serving but
    not at the planner's preferred balance)."""

    reason: str
    nodes_available: int
    shed: dict[str, int] = field(default_factory=dict)
    partitions: int = 0


def count_moves(model: PartitionModel, beg_map: PartitionMap,
                end_map: PartitionMap,
                favor_min_nodes: bool = False) -> int:
    """Total orchestration moves the beg -> end transition needs (the
    per-partition move calculus the orchestrator itself runs).  Zero
    means beg IS end up to move semantics — the control loop's
    convergence check, and the simulator's offline-optimal churn
    denominator."""
    states = sort_state_names(model)
    return sum(
        len(calc_partition_moves(
            states, beg_map[name].nodes_by_state,
            end_map[name].nodes_by_state, favor_min_nodes))
        for name in beg_map)


@dataclass
class RecoveryRound:
    """Outcome of one orchestration pass (round 0 = the primary pass)."""

    round: int
    dead_nodes: list[str]  # quarantined when the pass ENDED
    failures: int  # MoveFailures recorded during this pass
    progress_events: int
    progress: OrchestratorProgress


@dataclass
class RebalanceResult:
    """Everything a caller needs after a full rebalance."""

    next_map: PartitionMap
    warnings: dict[str, list[str]]
    progress: OrchestratorProgress
    progress_events: int
    timer: PhaseTimer = field(default_factory=PhaseTimer)
    # -- fault-tolerant mode extras (empty/None in legacy mode) --
    failures: list[MoveFailure] = field(default_factory=list)
    rounds: list[RecoveryRound] = field(default_factory=list)
    # The reconstructed map the cluster actually reached (== next_map on
    # a clean run); populated only when fault tolerance is on.
    achieved_map: Optional[PartitionMap] = None
    quarantined_nodes: list[str] = field(default_factory=list)
    # End-of-run SLO snapshot (obs/slo.py): availability, churn,
    # convergence lag, per-node quarantine exposure.  The live gauges
    # stream on the exposition endpoint during the run; this is the
    # final reading.
    slo: Optional[SloSummary] = None
    # False when fault-tolerant recovery exhausted max_recovery_rounds
    # with failures still outstanding (or degraded below) — the
    # returned map is PARTIAL and must not read as success.
    # ``residual_failures`` summarizes what is still broken (node ->
    # outstanding MoveFailure count from the final round).  Legacy mode
    # has no recovery semantics and always reports True.
    converged: bool = True
    residual_failures: dict[str, int] = field(default_factory=dict)
    # Structured graceful degradation (e.g. a recovery replan with an
    # EMPTY candidate node set — every node quarantined); None on a
    # healthy run.
    degraded: Optional[DegradedPlacement] = None


def save_partition_map(pmap: PartitionMap, path: str) -> None:
    """Checkpoint a map as JSON, atomically and durably.

    One of the three users of the shared crash-atomic write recipe in
    :mod:`blance_tpu_torch.utils.atomicio` (same-dir temp + file fsync +
    rename + DIRECTORY fsync); a crash mid-write leaves the previous
    checkpoint untouched, and a power failure after return cannot lose
    the rename.  The checkpoint's mode is preserved (umask default for
    a fresh file) so unprivileged readers keep working.
    """
    atomic_write_json(path, partition_map_to_json(pmap))


def load_partition_map(path: str) -> PartitionMap:
    with open(path) as f:
        return partition_map_from_json(json.load(f))


def _session_matches(session: "PlannerSession", cur: PartitionMap) -> bool:
    """True when the session's adopted current state already IS ``cur``
    — then load_map (which invalidates the warm carry) can be skipped
    and a repeat rebalance through the same session warm-starts its
    primary plan off the carry the previous call promoted."""
    try:
        current, _warns = session.to_map("current")
    except ValueError:
        # to_map's documented failure (nothing adopted yet / unknown
        # which): no adopted state means no match.
        return False
    return current == cur


def _strip_nodes(pmap: PartitionMap, nodes: set[str]) -> PartitionMap:
    """Drop every placement on ``nodes`` — the recovery presumption that
    a quarantined node's data is lost, so no 'del' move is owed to it."""
    if not nodes:
        return pmap
    return {
        name: Partition(name, {
            s: [n for n in ns if n not in nodes]
            for s, ns in p.nodes_by_state.items()})
        for name, p in pmap.items()
    }


async def rebalance_async(
    model: PartitionModel,
    current_map: PartitionMap,
    nodes_all: list[str],
    nodes_to_remove: Optional[list[str]],
    nodes_to_add: Optional[list[str]],
    assign_partitions: Callable[..., object],
    *,
    plan_options: Optional[PlanOptions] = None,
    orchestrator_options: Optional[OrchestratorOptions] = None,
    find_move: Optional[FindMoveFunc] = None,
    backend: str = "auto",
    device: Any = "cuda",
    on_progress: Optional[Callable[[OrchestratorProgress], None]] = None,
    checkpoint_path: Optional[str] = None,
    max_recovery_rounds: int = 0,
    session: "Optional[PlannerSession]" = None,
    slo: Optional[SloTracker] = None,
) -> RebalanceResult:
    """Plan the next map and execute the transition against the callback.

    assign_partitions(stop_ch, node, partitions, states, ops) is the app's
    data plane (sync or async).  on_progress sees every progress snapshot.
    checkpoint_path, if set, saves each round's planned target map
    (atomically) before its orchestration begins; on a mid-orchestration
    crash, resume by re-running rebalance from the app's current map (the
    planner is idempotent at fixpoint, so the redo converges) or diff
    current vs the checkpointed target directly.

    max_recovery_rounds (requires fault-tolerant orchestrator options):
    after a pass that left MoveFailures or quarantined nodes, up to this
    many recovery passes replan with the quarantined nodes removed and
    the achieved map (dead placements stripped) as current.

    device: where the planner solves and, with ``device_diff``, where the
    orchestrator diffs the maps (it overrides the orchestrator options'
    own ``device``).  session, a plan.session.PlannerSession covering the
    same partitions/nodes, makes the planning incremental (it solves on
    its own device): recovery replans warm-start off the solver carry
    when the failures were confined to the dead nodes.

    slo: an ``obs.slo.SloTracker`` to account availability/churn/lag
    against (pass your own when you also feed it to a ``MetricsServer``
    so the gauges stream live); one is created internally otherwise.
    Either way the tracker rides the orchestrator as a move observer,
    publishes ``slo.*`` gauges to the process recorder as the run
    progresses, and its final reading lands in ``RebalanceResult.slo``.
    """
    timer = PhaseTimer()
    rec = get_recorder()
    if slo is None:
        # "Serving" = the model's highest-priority (priority-0) states.
        top = min((st.priority for st in model.values()), default=0)
        slo = SloTracker(
            current_map,
            primary_states=[s for s, st in model.items()
                            if st.priority == top],
            clock=rec.now, recorder=rec)
    # One rebalance call is one SLO incident: its time-to-converged
    # (slo.first_converged_lag_s — entry to the last required move) is
    # the makespan the critical-path scheduler minimizes; the rolling
    # convergence-lag gauge alone would under-report a long scheduled
    # tail (it resets on every executed move).
    slo.open_incident()
    try:
        opts = dataclasses.replace(
            orchestrator_options or OrchestratorOptions(), device=device)
        ft = opts.fault_tolerant
        if max_recovery_rounds > 0 and not ft:
            raise ValueError(
                "max_recovery_rounds needs fault-tolerant orchestrator options "
                "(move_timeout_s / max_retries / quarantine_after): the legacy "
                "path aborts on the first error and records no failures to "
                "recover from")

        all_warnings: dict[str, list[str]] = {}

        def plan(cur: PartitionMap, removes: list[str], adds: list[str],
                 warm_ok: bool, recovery: bool) -> PartitionMap:
            """One planner entry; merges warnings.  With a session: adopt
            ``cur`` unless the session's adopted state already matches
            (warm_ok — the recovery fast path), apply the delta, replan.
            Recovery rounds go through the session's dedicated entry
            (``recovery_replan``)."""
            if session is None:
                next_map, warns = plan_next_map(
                    cur, cur, nodes_all, removes, adds, model,
                    plan_options, backend=backend, device=device)
            else:
                if not warm_ok and not _session_matches(session, cur):
                    session.load_map(cur)  # cold: invalidates any carry
                if recovery:
                    session.recovery_replan(removes)  # adds is [] here
                else:
                    if adds:
                        session.add_nodes(adds)
                    if removes:
                        session.remove_nodes(removes)
                    session.replan()
                next_map, warns = session.to_map("proposed")
            for k, v in warns.items():
                all_warnings.setdefault(k, []).extend(v)
            return next_map

        beg = current_map
        removes = list(nodes_to_remove or [])
        adds = list(nodes_to_add or [])
        rounds: list[RecoveryRound] = []
        all_failures: list[MoveFailure] = []
        events_total = 0
        health = opts.health
        warm_ok = False
        final: OrchestratorProgress = OrchestratorProgress()
        next_map: PartitionMap = beg
        achieved: Optional[PartitionMap] = None
        quarantined: list[str] = []
        round_failures: list[MoveFailure] = []
        degraded: Optional[DegradedPlacement] = None

        for round_i in range(1 + max(max_recovery_rounds, 0)):
            if round_i > 0 and not [n for n in nodes_all if n not in removes]:
                # Every node is removed/quarantined: a recovery replan has
                # an EMPTY candidate set.  The achieved map was already
                # stripped of every dead placement, so the honest target is
                # the empty placement — surfaced as a structured
                # degradation, not a planner round that can place nothing
                # (and not a raise: the simulator's zone-outage scenarios
                # hit this in normal operation).
                degraded = DegradedPlacement(
                    reason="no-candidate-nodes", nodes_available=0,
                    partitions=len(beg))
                rec.count("rebalance.degraded")
                next_map = {name: Partition(name, {s: [] for s in model})
                            for name in beg}
                break
            phase = "plan" if round_i == 0 else f"recovery_plan_{round_i}"
            with timer.phase(phase):
                next_map = plan(beg, removes, adds, warm_ok,
                                recovery=round_i > 0)

            if checkpoint_path:
                with timer.phase("checkpoint"):
                    save_partition_map(next_map, checkpoint_path)

            events = 0
            orch_phase = "orchestrate" if round_i == 0 \
                else f"recovery_orchestrate_{round_i}"
            with timer.phase(orch_phase):
                round_opts = opts
                if ft and health is not None:
                    # Quarantine state carries across rounds: a node that
                    # tripped in round k stays dark in round k+1 unless its
                    # half-open probe heals it.
                    round_opts = dataclasses.replace(opts, health=health)
                orch_nodes = [n for n in nodes_all if n not in quarantined]
                o = orchestrate_moves(
                    model,
                    round_opts,
                    orch_nodes,
                    beg,
                    next_map,
                    assign_partitions,
                    find_move or lowest_weight_partition_move_for_node,
                    move_observers=(slo,),
                )
                if round_i == 0:
                    # The churn denominator: the PRIMARY plan's move count
                    # is the minimum a perfect run would execute; recovery
                    # rounds only ever add to the numerator.
                    o.visit_next_moves(lambda m: slo.set_min_moves(
                        sum(len(nm.moves) for nm in m.values())))
                slo.attach_health(o.health)
                async for progress in o.progress_ch():
                    events += 1
                    final = progress
                    if on_progress is not None:
                        on_progress(progress)
                o.stop()

            events_total += events
            round_failures = o.move_failures()
            all_failures.extend(round_failures)
            health = o.health
            quarantined = health.quarantined_nodes() if health is not None \
                else []
            rounds.append(RecoveryRound(
                round=round_i, dead_nodes=list(quarantined),
                failures=len(round_failures), progress_events=events,
                progress=final))
            if ft:
                achieved = _strip_nodes(o.achieved_map(), set(quarantined))
                # Mirror the presumption on the live SLO view: a quarantined
                # node's placements are lost, so availability drops NOW, not
                # after the recovery round re-places them.
                slo.strip_nodes(set(quarantined))

            if not ft or not round_failures:
                # Converged (or legacy mode, which never recovers): a
                # quarantined node with zero failures this round means the
                # plan already routed around it.  With a session, a clean
                # pass adopts the proposal so the next plan — this
                # rebalance's or a later one — warm-starts off the carry.
                if session is not None and not round_failures and \
                        not final.errors:
                    session.apply()
                break
            if round_i >= max_recovery_rounds:
                break

            # -- set up the recovery round ------------------------------------
            rec.count("rebalance.recovery_rounds")
            if session is not None:
                # Warm fast path: failures confined to the dead nodes mean
                # the achieved state differs from the adopted proposal only
                # on rows that held a dead-node copy — exactly the rows
                # remove_nodes(dead) marks dirty, so the carry stays sound.
                confined = bool(quarantined) and all(
                    f.node in set(quarantined) for f in round_failures)
                if confined:
                    session.apply()
                    warm_ok = True
                else:
                    warm_ok = False
            beg = achieved
            # The original removal intent persists until drained: a node the
            # caller was decommissioning must not be re-adopted just because
            # a failed round left copies on it.  Quarantined nodes join it.
            removes = sorted(set(removes) | set(quarantined))
            adds = []

        # Recovery exhaustion is DATA, not silence: a run that still has
        # failures outstanding after its last round (or that degraded to an
        # empty placement) is not converged, and the residual summary says
        # what is still broken — a partial map must never be
        # indistinguishable from success.
        residual: dict[str, int] = {}
        converged = True
        if ft and (round_failures or degraded is not None):
            converged = False
            for f in round_failures:
                residual[f.node] = residual.get(f.node, 0) + 1
            rec.count("rebalance.unconverged")

        slo.close_incident()
        slo.publish()
        return RebalanceResult(
            next_map=next_map,
            warnings=all_warnings,
            progress=final,
            progress_events=events_total,
            timer=timer,
            failures=all_failures,
            rounds=rounds,
            achieved_map=achieved,
            quarantined_nodes=list(quarantined),
            slo=slo.summary(),
            converged=converged,
            residual_failures=residual,
            degraded=degraded,
        )
    except BaseException:
        # A raise out of the episode is not an incident with a
        # makespan: a reused tracker must not carry a stale open
        # incident into its next rebalance call.
        slo.discard_incident()
        raise


def rebalance(*args, **kwargs) -> RebalanceResult:
    """Synchronous wrapper around rebalance_async (runs its own loop)."""
    return asyncio.run(rebalance_async(*args, **kwargs))


def _maps_equal(a: PartitionMap, b: PartitionMap) -> bool:
    """Placement equality up to empty state lists (an emptied state vs
    a never-present one).  In-list ORDER is kept — index 0 is "the
    primary" by contract."""
    def norm(m: PartitionMap) -> dict:
        return {name: {s: list(ns) for s, ns in p.nodes_by_state.items()
                       if ns}
                for name, p in m.items()}
    return norm(a) == norm(b)


class RebalanceController(CycleEngine):
    """The continuous-rebalance control loop (ROADMAP item 4).

    ``rebalance_async`` is one bounded episode; production is a loop:
    cluster deltas (:class:`ClusterDelta`) arrive at any time, and the
    controller keeps the cluster converging while it serves —

    - **debounce**: deltas arriving within ``debounce_s`` of each other
      coalesce into one planning cycle (a zone outage is dozens of node
      events, not dozens of rebalances);
    - **supersede**: a delta landing mid-rebalance CANCELS the in-flight
      transition (``Orchestrator.cancel``), waits for the wind-down, and
      resumes from ``achieved_map()`` — never from a stale plan;
    - **graceful degradation**: when the candidate set cannot hold the
      constraint set, lower-priority replicas are shed before primaries
      and a structured :class:`DegradedPlacement` lands in
      ``degraded_reports`` instead of an exception; an EMPTY candidate
      set keeps the current placements (never drains data to nowhere);
    - **convergence accounting**: each cycle replans until the move
      calculus reports zero moves; a cycle that exhausts
      ``max_passes_per_cycle`` with failures outstanding counts
      ``rebalance.unconverged`` and leaves the residue for the next
      delta.

    The generic debounce/coalesce/converge machinery is the extracted
    :class:`~blance_tpu_torch.control.CycleEngine` (the fleet tier runs one
    engine per tenant on a single event loop, docs/FLEET.md); this
    class supplies the cluster-specific half: planning, orchestration,
    supersede, health and SLO accounting.  A
    :class:`~blance_tpu_torch.control.CyclePlanner` (``planner=``) replaces
    the inline planning step with an AWAITED one — the seam that lets N
    controllers coalesce their converge cycles through one shared
    ``plan.service.PlanService`` fleet dispatch.  The planner path is
    itself bypassed by graceful degradation (capacity shed / empty
    candidate set), which stays on the local planner.

    ``device`` is where the local planner solves and where the
    orchestrator's batched diff runs (it overrides the orchestrator
    options' own ``device``).  With a ``session`` (a PlannerSession,
    which solves on its own device), clean cycles ride the solver carry
    across plans (load/adopt gated exactly like ``rebalance_async``);
    the session and ``planner=`` are mutually exclusive.

    Single-task discipline (analysis/race_lint.py ``SHARED_STATE``):
    every mutation of the shared control state happens in a sync
    window, either on the app-facing surface (``submit``/``stop_soon``)
    or inside the controller task — the bounded rendezvous between them
    is the wake event plus the pending-delta list, taken atomically.

    Time comes exclusively from the recorder's clock, so the whole loop
    — debounce windows included — runs deterministically under
    ``testing.sched.DeterministicLoop`` (the ``testing/simulate`` tier
    replays a week of cluster life in seconds, bit-identically).
    """

    TASK_NAME = "rebalance-controller"

    def __init__(
        self,
        model: PartitionModel,
        nodes_all: list[str],
        current_map: PartitionMap,
        assign_partitions: Callable[..., object],
        *,
        plan_options: Optional[PlanOptions] = None,
        orchestrator_options: Optional[OrchestratorOptions] = None,
        backend: str = "auto",
        device: Any = "cuda",
        session: "Optional[PlannerSession]" = None,
        planner: Optional[CyclePlanner] = None,
        find_move: Optional[FindMoveFunc] = None,
        debounce_s: float = 0.05,
        max_passes_per_cycle: int = 8,
        slo: Optional[SloTracker] = None,
        move_observers: tuple = (),
        journal: Any = None,
    ) -> None:
        if session is not None and planner is not None:
            raise ValueError(
                "session and planner are mutually exclusive: the async "
                "planner path owns its own warm-carry lifecycle, so a "
                "session's carry would never be consulted")
        self.model = model
        self._assign = assign_partitions
        self._find_move = find_move
        self._planner = planner
        # Private copy: the controller folds weight deltas into its
        # options view, and mutating a caller-shared PlanOptions would
        # leak this loop's weights into unrelated plans.
        self.opts = dataclasses.replace(plan_options) \
            if plan_options is not None else PlanOptions()
        self.orch_opts = dataclasses.replace(
            orchestrator_options or OrchestratorOptions(), device=device)
        self.backend = backend
        self.device = device
        self.session = session
        self.max_passes_per_cycle = max(int(max_passes_per_cycle), 1)
        self._rec = get_recorder()
        super().__init__(debounce_s=debounce_s, clock=self._rec.now)
        self.current: PartitionMap = copy_partition_map(current_map)
        self._nodes: list[str] = list(nodes_all)
        self._removing: set[str] = set()  # graceful decommissions
        self._failed: set[str] = set()  # abrupt losses (stripped)
        self._pweights: dict[str, int] = dict(
            self.opts.partition_weights or {})
        self._nweights: dict[str, int] = dict(self.opts.node_weights or {})
        self._slo = slo
        self._observers = ((slo,) if slo is not None else ()) + \
            tuple(move_observers)
        # One breaker for the WHOLE loop: quarantine survives cycles
        # (a dead node stays dark) until an explicit re-add forgets it.
        if self.orch_opts.health is not None:
            self.health: Optional[HealthTracker] = self.orch_opts.health
        elif self.orch_opts.quarantine_after > 0:
            self.health = HealthTracker(
                threshold=self.orch_opts.quarantine_after,
                probe_after_s=self.orch_opts.probe_after_s,
                clock=self._rec.now)
        else:
            self.health = None
        if self._slo is not None and self.health is not None:
            self._slo.attach_health(self.health)

        self._inflight: Optional[Orchestrator] = None
        # Introspection / scoring surface:
        self.warnings: dict[str, list[str]] = {}
        self.failures: list[MoveFailure] = []
        self.degraded_reports: list[DegradedPlacement] = []
        self.passes = 0
        self.superseded = 0
        self.unconverged_cycles = 0
        # Called with (nodes, t) whenever placements are stripped (an
        # abrupt fail delta, or quarantined placements presumed lost) —
        # the simulator's event log needs every strip to make the SLO
        # account recomputable from the log alone.
        self.on_strip: list[Callable[[set[str], float], None]] = []
        # Durability feed (durability/journal.py, docs/DURABILITY.md):
        # every sync window writes a WAL record — delta intake
        # (_on_submit), cycle begin (_on_cycle), plan landed
        # (_converge), executed-batch achieved-map delta (the journal
        # rides _observers as a MoveObserver), strips, and quiesce
        # (plus a periodic snapshot at that idle edge).  The genesis
        # record below makes recovery self-contained before the first
        # snapshot.
        self._journal = journal
        if journal is not None:
            journal.record_genesis(
                self.current, self._nodes, self._removing, self._failed,
                self._pweights, self._nweights, t=self._rec.now())
            self._observers = self._observers + (journal,)
            self.on_strip.append(
                lambda nodes, t: journal.record_strip(sorted(nodes), t=t))

    # -- CycleEngine hooks (sync: single atomic windows) -------------------

    def _on_submit(self, delta: ClusterDelta) -> None:
        self._rec.count("sim.deltas")
        if self._slo is not None:
            # One busy episode = one SLO incident (first submit wins;
            # the next quiesce closes it with the time-to-last-required
            # -move sample, slo.first_converged_lag_s).
            self._slo.open_incident(self._rec.now())
        if self._journal is not None:
            self._journal.record_delta(delta, t=self._rec.now())

    def _on_cycle(self, n: int, deltas: int) -> None:
        if self._journal is not None:
            self._journal.record_cycle(n, deltas, t=self._rec.now())

    def _on_stop_soon(self) -> None:
        # Wind-down cancels any in-flight transition.
        o = self._inflight
        if o is not None:
            o.cancel()

    def _on_idle(self, t: float) -> None:
        if self._slo is not None:
            self._slo.close_incident(t)
        if self._journal is not None:
            # Quiesce record (map digest: the cheap divergence probe),
            # then maybe a snapshot — written at the idle edge so a
            # snapshot never captures a mid-cycle map.
            self._journal.record_quiesce_map(self.current, t=t)
            if self._journal.should_snapshot():
                self._journal.write_snapshot(self.snapshot_payload(t), t=t)

    def _on_exit(self) -> None:
        if self._slo is not None and not self._idle.is_set():
            # A crash / mid-episode stop is not a quiesce: the open
            # incident dies unrecorded (same discard-on-raise rule as
            # rebalance_async) instead of closing as an "instantly
            # converged" 0.0 lag sample.
            self._slo.discard_incident()

    async def quiesce(self) -> PartitionMap:
        """Wait until the controller is idle (every submitted delta
        planned, orchestrated and converged — or structurally degraded)
        and return the current map."""
        await self._idle.wait()
        return self.current

    def quarantined_nodes(self) -> list[str]:
        return self.health.quarantined_nodes() \
            if self.health is not None else []

    def snapshot_payload(self, t: float) -> dict:
        """The controller's durable state for one snapshot
        (durability/recover.py SNAPSHOT_FORMAT_VERSION): map +
        membership view + weights, HealthTracker state (open exposure
        intervals included), SloTracker horizon state, and the
        scheduler's CostModel aggregates when one is wired.  Carry /
        encode caches are deliberately absent — recovery demotes them
        to counted cold solves (docs/DURABILITY.md)."""
        cost = getattr(self.orch_opts.scheduler, "cost_model", None)
        return {
            "version": 1,
            "map": {name: p.to_json()
                    for name, p in sorted(self.current.items())},
            "nodes": list(self._nodes),
            "removing": sorted(self._removing),
            "failed": sorted(self._failed),
            "pweights": dict(sorted(self._pweights.items())),
            "nweights": dict(sorted(self._nweights.items())),
            "health": (self.health.to_dict(t)
                       if self.health is not None else None),
            "slo": (self._slo.to_dict(t)
                    if self._slo is not None else None),
            "cost": cost.to_json() if cost is not None else None,
        }

    def live_nodes(self) -> list[str]:
        """Nodes currently eligible as placement candidates (known,
        not decommissioning, not failed, not quarantined), in tie-break
        order — the simulator's offline-optimal baseline node set."""
        return self._candidates()

    def pending_tasks(self) -> "list[asyncio.Task[object]]":
        """Unfinished orchestration/controller tasks — the no-orphan
        probe for the supersede explorer scenario."""
        out: "list[asyncio.Task[object]]" = []
        if self._task is not None and not self._task.done():
            out.append(self._task)
        o = self._inflight
        if o is not None:
            out.extend(o.pending_tasks())
        return out

    def _apply_deltas(self, deltas: Iterable[ClusterDelta]) -> None:
        """Fold deltas into the membership/weight view, IN ORDER (a
        fail followed by a re-add in one burst comes back clean).  One
        sync window: placements strip atomically with the view."""
        weights_changed = False
        for delta in deltas:
            for n in delta.add:
                if n not in self._nodes:
                    self._nodes.append(n)
                self._removing.discard(n)
                if n in self._failed:
                    self._failed.discard(n)
                if self.health is not None:
                    self.health.forget(n)
            self._removing.update(
                n for n in delta.remove if n in self._nodes)
            fresh = [n for n in delta.fail
                     if n in self._nodes and n not in self._failed]
            if fresh:
                self._failed.update(fresh)
                before = self.current
                self.current = _strip_nodes(self.current, set(fresh))
                t = self._rec.now()
                if self._slo is not None:
                    self._slo.strip_nodes(set(fresh), t)
                for hook in self.on_strip:
                    hook(set(fresh), t)
                # Encode residency (docs/DESIGN.md): an async planner
                # holding resident encode state patches its prev at
                # the holder rows instead of re-encoding the stripped
                # map next cycle.
                notify = getattr(self._planner, "notify_strip", None)
                if notify is not None:
                    notify(set(fresh), before, self.current)
            if delta.partition_weights:
                self._pweights.update(delta.partition_weights)
                weights_changed = True
            if delta.node_weights:
                self._nweights.update(delta.node_weights)
                weights_changed = True
        self.opts.partition_weights = dict(self._pweights) or None
        self.opts.node_weights = dict(self._nweights) or None
        if self.session is not None:
            self._mirror_session(weights_changed)

    def _mirror_session(self, weights_changed: bool) -> None:
        """Push the folded membership/weight view into the session.
        Weight updates invalidate the carry (they re-price everything)
        so they are mirrored only when this burst actually changed
        them; membership changes keep the carry warm via the session's
        own dirty masks.

        The dark set mirrored as removed includes QUARANTINED nodes —
        the session must never plan onto a node whose mover is
        excluded, or the pass wedges on a moverless target — and a
        node the session still counts removed but the controller
        considers eligible again (a failed node re-added, a healed
        breaker) is re-added, clearing the session's removal flag:
        returned capacity must not stay dark."""
        session = self.session
        assert session is not None
        dark = self._removing | self._failed | set(self.quarantined_nodes())
        known = set(session.nodes)
        back = [n for n in self._nodes
                if n not in known
                or (n in set(session.removed_nodes) and n not in dark)]
        if back:
            session.add_nodes(back)
        gone = sorted(dark - set(session.removed_nodes))
        if gone:
            session.remove_nodes(gone)
        if weights_changed:
            if self._pweights:
                session.set_partition_weights(dict(self._pweights))
            if self._nweights:
                session.set_node_weights(dict(self._nweights))

    def _candidates(self) -> list[str]:
        dark = self._removing | self._failed | set(self.quarantined_nodes())
        return [n for n in self._nodes if n not in dark]

    def _mover_nodes(self) -> list[str]:
        """Nodes that get movers this pass: failed and quarantined
        nodes are gone (their queued work must drain as failures, and
        feeding them would burn the retry budget); GRACEFUL removals
        keep movers — their 'del' moves are real work."""
        dark = self._failed | set(self.quarantined_nodes())
        return [n for n in self._nodes if n not in dark]

    # -- planning with graceful degradation --------------------------------

    def _effective_constraints(self) -> dict[str, int]:
        out = {s: st.constraints for s, st in self.model.items()}
        for s, c in (self.opts.model_state_constraints or {}).items():
            if s in out:
                out[s] = c
        return out

    def _shed_plan(self, n_candidates: int) \
            -> tuple[Optional[dict[str, int]], dict[str, int]]:
        """(degraded constraints, shed per state) when the candidate
        set cannot hold the full constraint set; (None, {}) when no
        shedding is needed.  Lowest-priority states shed first; the
        top-priority state keeps at least one copy."""
        eff = self._effective_constraints()
        total = sum(eff.values())
        if total <= n_candidates:
            return None, {}
        top = min((st.priority for st in self.model.values()), default=0)
        shed: dict[str, int] = {}
        # Highest priority VALUE (least important) first; name-sorted
        # within a tier for determinism.
        for s in sorted(eff, key=lambda s: (-self.model[s].priority, s)):
            floor = 1 if self.model[s].priority == top else 0
            while total > n_candidates and eff[s] > floor:
                eff[s] -= 1
                shed[s] = shed.get(s, 0) + 1
                total -= 1
        return eff, shed

    def _plan(self, candidates: list[str]) \
            -> tuple[Optional[PartitionMap], Optional[DegradedPlacement]]:
        """One planning step.  (None, report) when there is nothing a
        plan could place (empty candidate set: keep current placements
        rather than draining data to nowhere)."""
        if not candidates:
            return None, DegradedPlacement(
                reason="no-candidate-nodes", nodes_available=0,
                partitions=len(self.current))
        removes = sorted(self._removing | self._failed |
                         set(self.quarantined_nodes()))
        degraded_constraints, shed = self._shed_plan(len(candidates))
        report = None
        if degraded_constraints is not None:
            report = DegradedPlacement(
                reason="capacity-shed", nodes_available=len(candidates),
                shed=shed, partitions=len(self.current))
        if self.session is not None and report is None:
            next_map, warns = self._plan_session()
        else:
            opts = self.opts
            if degraded_constraints is not None:
                # Shedding bypasses the session: the session's encoded
                # statics pin the full constraint set.
                opts = dataclasses.replace(
                    self.opts,
                    model_state_constraints=degraded_constraints)
            next_map, warns = plan_next_map(
                self.current, self.current, list(self._nodes), removes,
                [], self.model, opts, backend=self.backend,
                device=self.device)
        for k, v in warns.items():
            self.warnings.setdefault(k, []).extend(v)
        return next_map, report

    def _plan_session(self) -> tuple[PartitionMap, dict[str, list[str]]]:
        session = self.session
        assert session is not None
        if not _session_matches(session, self.current):
            session.load_map(self.current)  # cold: invalidates the carry
        # Re-push membership before EVERY session plan (weights stay:
        # the session's own opts already carry them, and re-encodes
        # read them back in): the breaker can quarantine a node
        # between passes, and a plan that still targets it would wedge
        # on a moverless mover.
        self._mirror_session(weights_changed=False)
        session.replan()
        return session.to_map("proposed")

    async def _plan_cycle(self, candidates: list[str]) \
            -> tuple[Optional[PartitionMap], Optional[DegradedPlacement]]:
        """One planning step, through the async ``planner`` seam when
        one is wired and the cycle is healthy.  Graceful degradation
        (empty candidate set, capacity shed) bypasses the planner onto
        the local path — the planner's encoded statics pin the full
        constraint set."""
        if self._planner is not None and candidates and \
                self._shed_plan(len(candidates))[0] is None:
            removes = sorted(self._removing | self._failed |
                             set(self.quarantined_nodes()))
            next_map, warns = await self._planner.plan_cycle(
                self.current, list(self._nodes), removes, self.model,
                self.opts)
            for k, v in warns.items():
                self.warnings.setdefault(k, []).extend(v)
            return next_map, None
        return self._plan(candidates)

    # -- one converge cycle -------------------------------------------------

    async def _converge(self) -> None:
        """Plan/orchestrate until the move calculus reports zero moves,
        a new delta supersedes the cycle, or the pass budget runs out."""
        passes = 0
        while not self._stopping:
            next_map, report = await self._plan_cycle(self._candidates())
            if report is not None:
                self.degraded_reports.append(report)
                self._rec.count("sim.degraded_plans")
            if next_map is None:
                break
            n_moves = count_moves(self.model, self.current, next_map,
                                  self.orch_opts.favor_min_nodes)
            if n_moves == 0:
                if self.session is not None and \
                        _maps_equal(self.current, next_map):
                    # Fixpoint reached with the proposal == current:
                    # adopt it so the NEXT cycle warm-starts.
                    self.session.apply()
                break
            passes += 1
            self.passes += 1
            self._rec.count("sim.rebalances")
            if self._journal is not None:
                self._journal.record_plan(passes, n_moves,
                                          t=self._rec.now())
            superseded, failures = await self._one_pass(next_map)
            if superseded:
                return
            if passes >= self.max_passes_per_cycle:
                # The pass budget is a HARD bound, failures or not: a
                # planner that keeps reshuffling (greedy balance under
                # skewed weights has states with no fixpoint — plans
                # oscillate) must not spin the control loop forever.
                # The cycle ends unconverged, structurally: the map is
                # serving (every executed pass was complete
                # make-before-break work), the residue waits for the
                # next delta.
                self.unconverged_cycles += 1
                self._rec.count("rebalance.unconverged")
                if not failures:
                    self.degraded_reports.append(DegradedPlacement(
                        reason="no-fixpoint",
                        nodes_available=len(self._candidates()),
                        partitions=len(self.current)))
                    self._rec.count("sim.degraded_plans")
                break

    async def _one_pass(self, next_map: PartitionMap) \
            -> tuple[bool, list[MoveFailure]]:
        """One orchestration pass toward ``next_map``; True when a new
        delta superseded it mid-flight (resume happens in the outer
        loop, from the achieved map adopted here either way)."""
        opts = self.orch_opts
        if self.health is not None:
            opts = dataclasses.replace(opts, health=self.health)
        if self._journal is not None and opts.epoch_fence is None:
            # Every dispatched move is stamped with the journal dir's
            # fenced epoch: a completion arriving after a recovery
            # bumped the fence is rejected and counted, never applied
            # (durability.stale_epoch_rejections).
            opts = dataclasses.replace(opts,
                                       epoch_fence=self._journal.fence)
        o = orchestrate_moves(
            self.model, opts, self._mover_nodes(), self.current, next_map,
            self._assign, self._find_move, move_observers=self._observers)
        self._inflight = o
        drain = asyncio.ensure_future(self._drain_progress(o))
        superseded = False
        while not drain.done():
            waiter = asyncio.ensure_future(self._wake_wait())
            await asyncio.wait({drain, waiter},
                               return_when=asyncio.FIRST_COMPLETED)
            if not waiter.done():
                waiter.cancel()
                try:
                    await waiter
                except asyncio.CancelledError:
                    pass
            if drain.done():
                break
            if self._pending and not self._stopping:
                # Supersede: the plan in flight no longer matches the
                # cluster.  Cancel, wait the full wind-down (no orphan
                # tasks), resume from the achieved map.
                superseded = True
                self.superseded += 1
                self._rec.count("sim.superseded")
            o.cancel()
            await o.wait_drained()
            break
        await drain
        self._adopt(o, superseded=superseded)
        return superseded, o.move_failures()

    async def _drain_progress(self, o: Orchestrator) -> None:
        async for _progress in o.progress_ch():
            pass
        o.stop()

    def _adopt(self, o: Orchestrator, superseded: bool = False) -> None:
        """Fold one finished pass into the controller view (sync: one
        atomic window).  Quarantined placements are presumed lost, like
        rebalance_async's recovery presumption."""
        quarantined = set(o.health.quarantined_nodes()) \
            if o.health is not None else set()
        achieved = o.achieved_map()
        if quarantined:
            achieved = _strip_nodes(achieved, quarantined)
            t = self._rec.now()
            if self._slo is not None:
                self._slo.strip_nodes(quarantined, t)
            for hook in self.on_strip:
                hook(set(quarantined), t)
        failures = o.move_failures()
        self.failures.extend(failures)
        self.current = achieved
        self._inflight = None
        notify = getattr(self._planner, "notify_pass", None)
        if notify is not None:
            # Encode residency: a clean-hinted pass (fully drained, no
            # cancel/supersede/failures/quarantine/errors) lets the
            # planner adopt its proposal's packed assignment as the
            # next resident prev; the planner itself still verifies the
            # changed rows landed verbatim, and anything off-hint
            # demotes to a cold re-encode.
            clean = (not superseded and not self._stopping
                     and not failures and not quarantined
                     and o._progress.tot_cancel == 0
                     and not o._progress.errors)
            notify(achieved, o.end_map, clean)
        if self.session is not None and not failures and \
                not quarantined and \
                _maps_equal(self.current, o.end_map):
            # Clean pass: the proposal landed verbatim — adopt it so
            # the next plan rides the warm carry.
            self.session.apply()
