# Copied from blance_tpu/durability/recover.py; resume_controller takes
# ``device`` for the resumed controller (the port's controllers solve on
# a torch device).
"""Recovery: rebuild control-plane state from the journal and resume.

``recover(journal_dir)`` is the restart entry point:

1. replay the journal (:func:`~blance_tpu_torch.durability.journal.
   read_journal` — torn tails truncated, fenced zombie appends
   dropped), folding each tenant's record stream into a
   :class:`RecoveredTenant`: current map, membership view, weights,
   breaker state, SLO horizon state.  A ``snapshot`` pointer record
   fast-forwards the fold to its payload; a ``genesis`` record resets
   it (a resumed controller writes a fresh genesis, so every epoch's
   journal is self-contained).
2. bump the directory's epoch fence (persisted crash-atomically) and
   open a new journal segment under the new epoch, writing a ``fence``
   record that freezes every prior segment's valid record count — the
   cross-process zombie defense.

``resume_controller`` then rebuilds one ``RebalanceController`` from a
recovered tenant: restored map + membership (via a journaled kick
delta through the existing fault-tolerant recovery machinery), restored
``HealthTracker`` (clock re-based) and ``SloTracker`` (snapshot state
plus post-snapshot batch/strip records re-applied with re-based
times).  Carry/encode caches are deliberately NOT persisted: a resumed
tenant costs one counted cold solve
(``durability.recovery_cold_solves``), bounded by the fleet tier's
demotion/eviction attribution identity (docs/FLEET.md).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Optional

from ..core.types import Partition, PartitionMap
from ..obs import get_recorder
from .epoch import fence_for
from .journal import Journal, Record, read_journal

__all__ = ["RecoveredState", "RecoveredTenant", "recover",
           "resume_controller"]

SNAPSHOT_FORMAT_VERSION = 1


@dataclasses.dataclass
class RecoveredTenant:
    """One tenant's folded state at the crash point."""

    tenant: Optional[str]
    pmap: PartitionMap = dataclasses.field(default_factory=dict)
    nodes: list[str] = dataclasses.field(default_factory=list)
    removing: set[str] = dataclasses.field(default_factory=set)
    failed: set[str] = dataclasses.field(default_factory=set)
    pweights: dict[str, int] = dataclasses.field(default_factory=dict)
    nweights: dict[str, int] = dataclasses.field(default_factory=dict)
    # Serialized HealthTracker / SloTracker / CostModel state from the
    # last snapshot (None before the first snapshot).
    health: Optional[dict[str, Any]] = None
    slo: Optional[dict[str, Any]] = None
    cost: Optional[dict[str, Any]] = None
    # batch/strip records since the last snapshot/genesis — re-applied
    # to a restored SloTracker so its view matches the folded map.
    post_events: list[Record] = dataclasses.field(default_factory=list)
    records: int = 0
    last_t: float = 0.0
    snapshot_t: Optional[float] = None
    quiesced: bool = True


@dataclasses.dataclass
class RecoveredState:
    """Everything ``recover()`` rebuilt, plus the successor journal
    (already fenced at the new epoch)."""

    epoch: int
    next_seq: int
    records_replayed: int
    torn_segments: int
    stale_dropped: int
    tenants: dict[Optional[str], RecoveredTenant]
    journal: Journal


def _apply_batch(pmap: PartitionMap, moves: list[Any]) -> None:
    """Fold one executed batch into the map — the same per-move
    semantics as ``Orchestrator.achieved_map`` / ``SloTracker._apply``:
    remove the node from wherever it was, then (unless the move is a
    removal, state "") place it in the move's state."""
    for mv in moves:
        partition, node, state = str(mv[0]), str(mv[1]), str(mv[2])
        p = pmap.get(partition)
        if p is None:
            continue
        for ns in p.nodes_by_state.values():
            if node in ns:
                ns.remove(node)
        if state:
            p.nodes_by_state.setdefault(state, []).append(node)


def _strip(pmap: PartitionMap, nodes: set[str]) -> None:
    for p in pmap.values():
        for state, ns in p.nodes_by_state.items():
            p.nodes_by_state[state] = [n for n in ns if n not in nodes]


def _map_from_json(data: dict[str, Any]) -> PartitionMap:
    return {str(name): Partition.from_json(p) for name, p in data.items()}


def _reset_from(t_state: RecoveredTenant, data: dict[str, Any]) -> None:
    """Seed the fold from a genesis record or snapshot payload (both
    share the membership schema)."""
    t_state.pmap = _map_from_json(data["map"])
    t_state.nodes = [str(n) for n in data["nodes"]]
    t_state.removing = {str(n) for n in data["removing"]}
    t_state.failed = {str(n) for n in data["failed"]}
    t_state.pweights = {str(k): int(v)
                        for k, v in (data.get("pweights") or {}).items()}
    t_state.nweights = {str(k): int(v)
                        for k, v in (data.get("nweights") or {}).items()}
    t_state.post_events = []
    # A reset supersedes any earlier snapshot's auxiliary state; the
    # snapshot fold re-sets these right after when that's the source.
    t_state.health = None
    t_state.slo = None
    t_state.cost = None
    t_state.snapshot_t = None


def _fold(t_state: RecoveredTenant, record: Record,
          journal_dir: str) -> None:
    """One record into one tenant's fold, in journal order."""
    t_state.records += 1
    t_state.last_t = record.t
    data = record.data
    if record.kind == "genesis":
        _reset_from(t_state, data)
        t_state.quiesced = True
        return
    if record.kind == "snapshot":
        try:
            with open(os.path.join(journal_dir, str(data["file"]))) as f:
                payload = json.load(f)
        except (OSError, ValueError, KeyError):
            # A missing/torn snapshot file never blocks recovery: the
            # fold simply continues from what it already has (the
            # pointer is only written after the file is durable, so
            # this is defense in depth, not an expected path).
            return
        if payload.get("version") != SNAPSHOT_FORMAT_VERSION:
            return
        _reset_from(t_state, payload)
        t_state.health = payload.get("health")
        t_state.slo = payload.get("slo")
        t_state.cost = payload.get("cost")
        t_state.snapshot_t = record.t
        return
    if record.kind == "delta":
        t_state.quiesced = False
        for n in data.get("add", ()):
            n = str(n)
            if n not in t_state.nodes:
                t_state.nodes.append(n)
            t_state.removing.discard(n)
            t_state.failed.discard(n)
        t_state.removing.update(
            str(n) for n in data.get("remove", ()) if n in t_state.nodes)
        t_state.failed.update(
            str(n) for n in data.get("fail", ()) if n in t_state.nodes)
        if data.get("pweights"):
            t_state.pweights.update(
                {str(k): int(v) for k, v in data["pweights"].items()})
        if data.get("nweights"):
            t_state.nweights.update(
                {str(k): int(v) for k, v in data["nweights"].items()})
        return
    if record.kind == "strip":
        t_state.quiesced = False
        _strip(t_state.pmap, {str(n) for n in data.get("nodes", ())})
        t_state.post_events.append(record)
        return
    if record.kind == "batch":
        t_state.quiesced = False
        if data.get("ok"):
            _apply_batch(t_state.pmap, list(data.get("moves", ())))
        t_state.post_events.append(record)
        return
    if record.kind == "quiesce":
        t_state.quiesced = True
        return
    if record.kind in ("cycle", "plan"):
        t_state.quiesced = False
        return
    # Unknown kinds (a newer writer's vocabulary): ignore, by design.


def recover(journal_dir: str, *,
            clock: Optional[Callable[[], float]] = None,
            rotate_records: int = 1024,
            snapshot_every: int = 0,
            journal_factory: Optional[Callable[..., Journal]] = None,
            ) -> RecoveredState:
    """Rebuild every tenant's state from ``journal_dir`` and fence the
    epoch.  Returns the folded states plus the successor journal
    (new epoch, fresh segment, ``fence`` record already written).

    ``journal_factory`` substitutes the successor journal's class —
    the crash-injection harness passes a journal that dies again at a
    scripted record boundary (testing/crashsim.py)."""
    rec_sink = get_recorder()
    records, stats = read_journal(journal_dir)
    fence = fence_for(journal_dir)
    new_epoch = fence.bump()
    make = journal_factory if journal_factory is not None else Journal
    journal = make(
        journal_dir, fence=fence, clock=clock,
        rotate_records=rotate_records, snapshot_every=snapshot_every,
        start_seq=(records[-1].seq + 1) if records else 1)
    journal.append("fence",
                   {"epoch": new_epoch, "segments": stats.per_segment})
    tenants: dict[Optional[str], RecoveredTenant] = {}
    for record in records:
        if record.kind == "fence":
            continue
        t_state = tenants.get(record.tenant)
        if t_state is None:
            t_state = tenants[record.tenant] = RecoveredTenant(record.tenant)
        _fold(t_state, record, journal_dir)
    rec_sink.count("durability.recoveries")
    rec_sink.count("durability.replayed_records", len(records))
    return RecoveredState(
        epoch=new_epoch,
        next_seq=journal.next_seq,
        records_replayed=len(records),
        torn_segments=stats.torn_segments,
        stale_dropped=stats.stale_dropped,
        tenants=tenants,
        journal=journal,
    )


class _ReplayMove:
    """Duck-typed move (partition/node/state/op) for re-applying
    journaled batches through a restored SloTracker."""

    __slots__ = ("partition", "node", "state", "op")

    def __init__(self, partition: str, node: str, state: str,
                 op: str) -> None:
        self.partition = partition
        self.node = node
        self.state = state
        self.op = op


def _restore_slo(t_state: RecoveredTenant, clock: Callable[[], float],
                 publish_gauges: bool,
                 availability_floor: Optional[float],
                 track_timeline: bool) -> Any:
    """A SloTracker for the resumed controller.

    With a snapshot: restore it (ages re-based), then re-apply the
    post-snapshot batch/strip records with their times SHIFTED onto the
    new clock (shift = now - last journaled t), so every inter-event
    duration — lag, timeline steps, integrals — survives the crash.
    Without one: a fresh account seeded from the recovered map (the
    horizon restarts; availability is instantaneous state and correct
    either way).
    """
    from ..obs.slo import SloTracker

    now = clock()
    if t_state.slo is None:
        return SloTracker(
            t_state.pmap, clock=clock,
            track_timeline=track_timeline,
            availability_floor=availability_floor,
            publish_gauges=publish_gauges)
    shift = now - t_state.last_t
    snap_now = (t_state.snapshot_t + shift
                if t_state.snapshot_t is not None else now)
    slo = SloTracker.from_dict(
        t_state.slo, clock=clock, now=snap_now,
        publish_gauges=publish_gauges)
    for record in t_state.post_events:
        t = record.t + shift
        if record.kind == "strip":
            slo.strip_nodes(
                {str(n) for n in record.data.get("nodes", ())}, t)
        elif record.kind == "batch":
            moves = [_ReplayMove(str(m[0]), str(m[1]), str(m[2]), str(m[3]))
                     for m in record.data.get("moves", ())]
            slo.on_batch(str(record.data.get("node", "")), moves,
                         bool(record.data.get("ok")), t)
    return slo


def resume_controller(state: RecoveredState, model: Any,
                      assign_partitions: Callable[..., object], *,
                      tenant: Optional[str] = None,
                      plan_options: Any = None,
                      orchestrator_options: Any = None,
                      backend: str = "greedy",
                      planner: Any = None,
                      find_move: Any = None,
                      debounce_s: float = 0.05,
                      max_passes_per_cycle: int = 8,
                      move_observers: "tuple[Any, ...]" = (),
                      publish_slo_gauges: bool = True,
                      track_timeline: bool = True,
                      availability_floor: Optional[float] = None,
                      start: bool = True,
                      kick: bool = True,
                      device: Any = "cuda") -> Any:
    """One recovered tenant back to a live ``RebalanceController``.

    The controller starts from the journaled achieved map; membership
    residue (graceful removals, failed nodes) is re-submitted as a
    journaled kick delta, so convergence resumes through the existing
    fault-tolerant machinery — idempotent (a zero-move plan) when the
    crash happened quiesced.  Encode/carry caches were never persisted:
    the first plan is a counted cold solve
    (``durability.recovery_cold_solves``).  ``device`` is the
    controller's (``RebalanceController(device=)``).
    """
    # Imported here, not at module top: rebalance.py imports the
    # orchestrate layer, which imports this package — a module-level
    # import would cycle.
    from ..rebalance import ClusterDelta, RebalanceController

    rec_sink = get_recorder()
    t_state = state.tenants[tenant]
    opts = orchestrator_options
    if t_state.health is not None:
        from ..orchestrate.health import HealthTracker
        from ..orchestrate.orchestrator import OrchestratorOptions
        health = HealthTracker.from_dict(t_state.health, clock=rec_sink.now)
        opts = dataclasses.replace(opts or OrchestratorOptions(),
                                   health=health)
    slo = _restore_slo(t_state, rec_sink.now, publish_slo_gauges,
                       availability_floor, track_timeline)
    journal = (state.journal if tenant is None
               else state.journal.for_tenant(tenant))
    controller = RebalanceController(
        model, list(t_state.nodes), t_state.pmap, assign_partitions,
        plan_options=plan_options, orchestrator_options=opts,
        backend=backend, device=device, planner=planner,
        find_move=find_move,
        debounce_s=debounce_s,
        max_passes_per_cycle=max_passes_per_cycle, slo=slo,
        move_observers=move_observers, journal=journal)
    rec_sink.count("durability.recovery_cold_solves")
    if start:
        controller.start()
        if kick:
            controller.submit(ClusterDelta(
                remove=tuple(sorted(t_state.removing)),
                fail=tuple(sorted(t_state.failed))))
    return controller
