# Copied from blance_tpu/orchestrate/sched/policy.py; the critical-path
# scheduler passes the rank sweep's ``device`` through ("cuda" by default).
"""Scheduler policies: the move-ordering interface the orchestrator binds.

The orchestrator's supplier asks, per destination node and per round,
"which available move next?"; a :class:`SchedulerPolicy` answers.  Two
implementations:

- :class:`LegacyWeightOrder` — the reference's app-weight order
  (``MOVE_OP_WEIGHT``: promote < demote < add < del, first-lowest wins
  ties), EXTRACTED verbatim from ``orchestrate/orchestrator.py`` behind
  this interface.  It is the pinned default: an orchestration with no
  ``OrchestratorOptions.scheduler`` set behaves byte-identically to the
  pre-extraction code (the untouched ``test_orchestrate*`` suites pin
  it).
- :class:`CriticalPathScheduler` — critical-path list scheduling
  (arxiv 1711.01912): upward-rank priorities from calibrated
  :meth:`~blance_tpu_torch.obs.costmodel.CostModel.predict_move` costs over
  the move DAG (:mod:`.dag`), HEFT-style earliest-finish assignment
  onto per-node lanes (:func:`list_schedule`) for the makespan
  prediction, and the highest-rank-first selection rule at feed time.
  The final map and the move SET are bit-identical to the legacy order
  by construction — the policy only chooses ORDER, the cursors still
  release each partition's moves strictly in sequence — so only the
  clock changes.  When the health breaker quarantines a node the bound
  scheduler REBUILDS priorities from the remaining DAG and the live
  cursor state (``sched.reschedules``); a controller supersede rebuilds
  for free, because each new pass binds the policy against the fresh
  move plans computed from the achieved map.

Metrics (``sched.*`` in the registry; docs/OBSERVABILITY.md):
makespan prediction, critical-path length, lane utilization at every
(re)build; achieved makespan and predicted-vs-actual relative error at
finish; reschedule and rank-engine counters.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Sequence

from ...obs.costmodel import CostModel, default_op_priors
from ...obs.recorder import Recorder
from .dag import MoveDag, build_move_dag
from .ranks import upward_ranks

__all__ = [
    "MOVE_OP_WEIGHT",
    "BoundScheduler",
    "CriticalPathScheduler",
    "LegacyWeightOrder",
    "ScheduledMove",
    "SchedulePlan",
    "SchedulerPolicy",
    "list_schedule",
    "lowest_weight_partition_move_for_node",
]


MOVE_OP_WEIGHT = {"promote": 1, "demote": 2, "add": 3, "del": 4}


def lowest_weight_partition_move_for_node(
    node: str, moves: Sequence[Any]
) -> int:
    """Default FindMoveFunc: index of the lightest op (orchestrate.go:177-186).

    First-lowest wins ties, so single-node promotions/demotions go first and
    clients regain coverage quickly.
    """
    r = 0
    for i, move in enumerate(moves):
        if MOVE_OP_WEIGHT.get(moves[r].op, 0) > MOVE_OP_WEIGHT.get(move.op, 0):
            r = i
    return r


class BoundScheduler(abc.ABC):
    """One orchestration run's scheduler state (``Orchestrator.sched``).

    ``select`` is the feed-time hook (same contract as the app's
    ``find_move``, but over the live cursors so no move views need
    materializing); the rest are lifecycle notifications the
    orchestrator drives.  All methods are plain sync code — mutations
    are atomic on the event loop (race lint ``SHARED_STATE``)."""

    # True when the orchestrator should register this bound as a move
    # observer (``on_batch`` sees every batch outcome).  The legacy
    # bound opts out so the default path's observer loop stays empty.
    observes_batches: bool = False

    @abc.abstractmethod
    def select(self, node: str, candidates: Sequence[Any]) -> int:
        """Index of the move to feed next for ``node``; ``candidates``
        are live cursors (``NextMoves``-shaped) whose current move all
        target ``node``."""

    def on_batch(self, node: str, moves: Sequence[Any], ok: bool,
                 now: float) -> None:
        """Move-observer hook (only called when ``observes_batches``)."""

    def on_quarantine(self, node: str) -> None:
        """The health breaker quarantined ``node`` — rebuild if the
        policy maintains an online schedule."""

    def on_heal(self, node: str) -> None:
        """A half-open probe healed ``node`` — its lanes rejoin the
        machine model; rebuild if the policy maintains one."""

    def finish(self, now: float) -> None:
        """The orchestration wound down (progress stream closing)."""


class SchedulerPolicy(abc.ABC):
    """A reusable move-ordering policy; ``bind`` yields per-run state.

    One policy object can serve many orchestrations (the controller's
    passes, recovery rounds): every run binds fresh, so priorities are
    always rebuilt from that run's move plans — a superseded pass never
    replays a stale order."""

    name: str = "scheduler"

    @abc.abstractmethod
    def bind(self, nodes: Sequence[str], cursors: Mapping[str, Any],
             max_concurrent: int, recorder: Recorder) -> BoundScheduler:
        """Bind to one orchestration: its mover nodes, its live move
        cursors (``map_partition_to_next_moves``), the per-node lane
        count, and the run's Recorder (time source + metric sink)."""


# -- the pinned default: the reference's app-weight order ---------------------


class _LegacyBound(BoundScheduler):
    """Stateless; selection is EXACTLY the pre-extraction fast path
    (hand the op-bearing cursor entries straight to the weight rule)."""

    def select(self, node: str, candidates: Sequence[Any]) -> int:
        return lowest_weight_partition_move_for_node(
            node, [nm.moves[nm.next] for nm in candidates])


_LEGACY_BOUND = _LegacyBound()


class LegacyWeightOrder(SchedulerPolicy):
    """The reference ordering (orchestrate.go:177-186) behind the
    scheduler interface — the default when ``OrchestratorOptions.
    scheduler`` is None, byte-identical to the pre-sched code."""

    name = "legacy-weight"

    def bind(self, nodes: Sequence[str], cursors: Mapping[str, Any],
             max_concurrent: int, recorder: Recorder) -> BoundScheduler:
        return _LEGACY_BOUND


# -- critical-path list scheduling -------------------------------------------


@dataclass(frozen=True)
class ScheduledMove:
    """One move placed on a node lane by the list scheduler."""

    partition: str
    index: int  # absolute index into the partition's move list
    node: str
    lane: int
    start_s: float
    finish_s: float


@dataclass(frozen=True)
class SchedulePlan:
    """A predicted execution plan: every remaining move exactly once —
    on a lane, or in ``stalled`` when its chain reaches a machine-less
    (moverless / quarantined) node.  ``critical_path_s`` is the longest
    remaining chain by predicted cost (a makespan lower bound);
    ``lane_utilization`` is predicted busy time over the active nodes'
    lane capacity across the makespan."""

    makespan_s: float
    critical_path_s: float
    lane_utilization: float
    moves: tuple[ScheduledMove, ...]
    stalled: tuple[tuple[str, int], ...]
    lanes_total: int

    def scheduled_keys(self) -> set[tuple[str, int]]:
        return {(m.partition, m.index) for m in self.moves}


def list_schedule(
    dag: MoveDag,
    costs: Mapping[tuple[str, int], float],
    ranks: Mapping[tuple[str, int], float],
) -> SchedulePlan:
    """HEFT-style earliest-finish list scheduling of the move DAG.

    Moves are taken in non-increasing upward-rank order (which respects
    the chain edges by construction: a predecessor's rank is its
    successor's plus its own positive cost) and placed on their
    destination node's earliest-free lane, starting no earlier than
    their predecessor's finish.  Deterministic: ties break on
    (partition, index), lanes on lowest index."""
    order = sorted(
        dag.moves(),
        key=lambda m: (-ranks.get((m.partition, m.index), 0.0),
                       m.partition, m.index))
    lane_free: dict[str, list[float]] = {
        node: [0.0] * lanes for node, lanes in dag.machines.items()}
    chain_ready: dict[str, float] = {}
    chain_cost: dict[str, float] = {}
    chain_stalled: dict[str, int] = {}
    scheduled: list[ScheduledMove] = []
    stalled: list[tuple[str, int]] = []
    busy = 0.0
    active_nodes: set[str] = set()
    for mv in order:
        stall_at = chain_stalled.get(mv.partition)
        if stall_at is not None and mv.level >= stall_at:
            stalled.append((mv.partition, mv.index))
            continue
        lanes = lane_free.get(mv.node)
        if lanes is None:
            # No machine (moverless or quarantined destination): this
            # move — and everything after it in the chain — stalls.
            chain_stalled[mv.partition] = mv.level
            stalled.append((mv.partition, mv.index))
            continue
        lane = min(range(len(lanes)), key=lambda i: lanes[i])
        cost = max(costs.get((mv.partition, mv.index), 0.0), 0.0)
        start = max(lanes[lane], chain_ready.get(mv.partition, 0.0))
        finish = start + cost
        lanes[lane] = finish
        chain_ready[mv.partition] = finish
        chain_cost[mv.partition] = chain_cost.get(mv.partition, 0.0) + cost
        busy += cost
        active_nodes.add(mv.node)
        scheduled.append(ScheduledMove(
            partition=mv.partition, index=mv.index, node=mv.node,
            lane=lane, start_s=start, finish_s=finish))
    makespan = max((m.finish_s for m in scheduled), default=0.0)
    # Longest SCHEDULED chain by predicted cost: for a fully scheduled
    # chain this is its head's upward rank; a chain stalled at level k
    # contributes only its scheduled prefix, so the gauge stays a true
    # lower bound on the predicted makespan (a stalled tail isn't in
    # the schedule and must not inflate the "bound" past it).
    critical = max(chain_cost.values(), default=0.0)
    active_lanes = sum(dag.machines.get(n, 0) for n in active_nodes)
    util = busy / (active_lanes * makespan) \
        if makespan > 0.0 and active_lanes > 0 else 0.0
    return SchedulePlan(
        makespan_s=makespan, critical_path_s=critical,
        lane_utilization=util, moves=tuple(scheduled),
        stalled=tuple(stalled),
        lanes_total=sum(dag.machines.values()))


class _CriticalPathBound(BoundScheduler):
    """Per-run critical-path scheduler state.

    Mutable shared state (``_rank``, ``plan``, ``last_remaining``,
    ``_quarantined``, ``_t_last_exec``, ``reschedules``) is declared in
    the race lint's ``SHARED_STATE`` table: every mutator is a plain
    sync method (one atomic window on the event loop) — ``select`` runs
    on the supplier task, ``on_batch``/``on_quarantine`` on mover
    tasks, never concurrently within a window."""

    observes_batches = True

    def __init__(self, cost_model: CostModel, nodes: Sequence[str],
                 cursors: Mapping[str, Any], max_concurrent: int,
                 recorder: Recorder,
                 device_threshold: Optional[int],
                 device: Any = "cuda") -> None:
        self._cost = cost_model
        self._nodes = tuple(nodes)
        self._cursors = cursors  # the orchestrator's LIVE cursor map
        self._lanes = max_concurrent if max_concurrent > 0 else 1
        self._rec = recorder
        self._device_threshold = device_threshold
        self._device = device
        self._quarantined: set[str] = set()
        self._t0 = recorder.now()
        self._t_last_exec: Optional[float] = None
        self._first_predicted: Optional[float] = None
        self._finished = False
        self.reschedules = 0
        self._rank: dict[tuple[str, int], float] = {}
        self.plan: SchedulePlan = SchedulePlan(
            0.0, 0.0, 0.0, (), (), 0)
        # The (partition, absolute-index) set the current plan was
        # built from, captured in the SAME sync window as the plan —
        # the explorer's every-unfinished-move-exactly-once probe
        # compares plan vs this snapshot, race-free by construction.
        self.last_remaining: frozenset[tuple[str, int]] = frozenset()
        self._build(validate=True)

    # -- schedule construction ------------------------------------------------

    def _build(self, validate: bool = False) -> None:
        dag = build_move_dag(
            self._cursors,
            nodes_all=[n for n in self._nodes
                       if n not in self._quarantined],
            max_concurrent=self._lanes, validate=validate)
        chains = list(dag.chains.values())
        chain_costs = [
            [self._cost.predict_move(mv) for mv in chain]
            for chain in chains]
        chain_ranks = upward_ranks(
            chain_costs, device_threshold=self._device_threshold,
            recorder=self._rec, device=self._device)
        costs: dict[tuple[str, int], float] = {}
        rank: dict[tuple[str, int], float] = {}
        for chain, ccosts, cranks in zip(chains, chain_costs,
                                         chain_ranks):
            for mv, c, r in zip(chain, ccosts, cranks):
                costs[(mv.partition, mv.index)] = c
                rank[(mv.partition, mv.index)] = r
        self._rank = rank
        self.plan = list_schedule(dag, costs, rank)
        self.last_remaining = frozenset(rank)
        if self._first_predicted is None:
            self._first_predicted = self.plan.makespan_s
        self._rec.set_gauge("sched.makespan_predicted_s",
                            self.plan.makespan_s)
        self._rec.set_gauge("sched.critical_path_s",
                            self.plan.critical_path_s)
        self._rec.set_gauge("sched.lane_utilization",
                            self.plan.lane_utilization)

    # -- orchestrator hooks ---------------------------------------------------

    def select(self, node: str, candidates: Sequence[Any]) -> int:
        best = 0
        best_key: Optional[tuple[float, str]] = None
        for i, nm in enumerate(candidates):
            r = self._rank.get((nm.partition, nm.next), 0.0)
            key = (-r, nm.partition)
            if best_key is None or key < best_key:
                best_key = key
                best = i
        return best

    def on_batch(self, node: str, moves: Sequence[Any], ok: bool,
                 now: float) -> None:
        if ok:
            self._t_last_exec = now

    def on_quarantine(self, node: str) -> None:
        """Online reschedule: the breaker quarantined ``node``, so its
        lanes leave the machine model and every surviving move's
        priority is rebuilt from the live cursors (the orchestrator's
        achieved frontier) and the cost model's CURRENT estimates —
        never a replay of the stale order."""
        self._quarantined.add(node)
        self.reschedules += 1
        self._rec.count("sched.reschedules")
        self._build()

    def on_heal(self, node: str) -> None:
        """The half-open probe healed ``node``: its lanes rejoin the
        machine model and the schedule rebuilds, so the makespan/
        critical-path/utilization gauges (and the wind-down rel-err
        score) track the machines actually serving — a heal-blind plan
        would keep the node's chains 'stalled' forever."""
        if node not in self._quarantined:
            return
        self._quarantined.discard(node)
        self.reschedules += 1
        self._rec.count("sched.reschedules")
        self._build()

    def quarantined(self) -> frozenset[str]:
        return frozenset(self._quarantined)

    def finish(self, now: float) -> None:
        if self._finished:
            return
        self._finished = True
        # A cancelled/superseded orchestration winds down with live
        # moves still pending — that truncated clock is not an achieved
        # makespan, and scoring |predicted - actual| against it would
        # drown the rel-err histogram in supersede noise (abandoned
        # chains are DONE: their failure is the run's real outcome).
        if any(getattr(nm, "failed_at", None) is None
               and nm.next < len(nm.moves)
               for nm in self._cursors.values()):
            return
        t_end = self._t_last_exec if self._t_last_exec is not None \
            else now
        actual = max(t_end - self._t0, 0.0)
        self._rec.set_gauge("sched.makespan_actual_s", actual)
        predicted = self._first_predicted or 0.0
        if actual > 0.0 and predicted > 0.0:
            self._rec.observe("sched.makespan_rel_err",
                              abs(predicted - actual) / actual)


class CriticalPathScheduler(SchedulerPolicy):
    """Critical-path move scheduling on calibrated costs (module doc).

    ``cost_model``: the :class:`~blance_tpu_torch.obs.costmodel.CostModel`
    whose ``predict_move`` prices every move — pass the one you attach
    to the live Recorder (``rec.add_sink(model)``) so estimates
    recalibrate online across passes; by default a fresh model seeded
    with the committed per-op bench priors
    (``obs/costmodel_priors.json``), so even a never-observed cluster
    schedules on non-uniform costs.  ``device_threshold`` overrides
    when the rank sweep moves on-device (:mod:`.ranks`), and ``device``
    is where it runs then."""

    name = "critical-path"

    def __init__(self, cost_model: Optional[CostModel] = None,
                 device_threshold: Optional[int] = None,
                 use_priors: bool = True, device: Any = "cuda") -> None:
        if cost_model is None:
            cost_model = CostModel()
            if use_priors:
                cost_model.seed_priors(default_op_priors())
        self.cost_model = cost_model
        self.device_threshold = device_threshold
        self.device = device

    def bind(self, nodes: Sequence[str], cursors: Mapping[str, Any],
             max_concurrent: int, recorder: Recorder) -> BoundScheduler:
        return _CriticalPathBound(
            self.cost_model, nodes, cursors, max_concurrent, recorder,
            self.device_threshold, self.device)
