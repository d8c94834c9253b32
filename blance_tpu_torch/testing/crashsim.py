# Port of blance_tpu/testing/crashsim.py: run_crash_scenario and
# crash_matrix take ``device`` ("cuda" by default) for every life's
# controller; the journal and the log are the reference's.
"""Deterministic crash-injection harness for the durability tier
(docs/DURABILITY.md "Crash injection").

A real controller crash is: the process stops, nothing past the last
durable journal record exists, and a restart runs
:func:`~blance_tpu_torch.durability.recover.recover` +
:func:`~blance_tpu_torch.durability.recover.resume_controller`.  This module
reproduces exactly that inside the
:class:`~blance_tpu_torch.testing.sched.DeterministicLoop`:

- :class:`CrashingJournal` — a :class:`~blance_tpu_torch.durability.journal.
  Journal` that "dies" after a scripted number of appends: every later
  record is silently dropped (it never reached disk) and a crash flag
  raises.  No exception is thrown into controller code — a crash is the
  absence of durability, not a control-flow event.
- :func:`run_crash_scenario` — one full cluster life over a
  :class:`~blance_tpu_torch.testing.scenarios.SimScenario`: run, die at each
  scripted record boundary, recover into a FRESH virtual loop (the
  restart clock starts at zero, exercising the re-basing paths),
  redeliver every event the journal never durably received (the
  upstream event source is at-least-once), converge, repeat until a
  life completes.  Emits a versioned, canonically-serialized event log
  (committed replay traces under ``tests/traces/``).
- :func:`crash_matrix` — the bounded-exhaustive acceptance check: a
  crash-free reference run, then one crashed run per journal-record
  boundary, each asserted to converge to the reference's final map
  bit-identically.

Determinism contract: everything is a pure function of (scenario,
crash boundaries) — virtual clocks, seeded scenarios, synchronous
journal appends — so the same inputs replay byte-identical logs.
"""

from __future__ import annotations

import asyncio
import json
import os
from dataclasses import dataclass, field
from typing import Any, Optional

from ..convert import resolve_device
from ..core.types import PartitionMap, PartitionModel
from ..durability.journal import Journal, map_digest
from ..durability.recover import RecoveredState, recover, resume_controller
from ..obs import Recorder, use_recorder
from ..orchestrate.orchestrator import OrchestratorOptions
from ..rebalance import RebalanceController
from .scenarios import SimEvent, SimScenario, initial_map, scenario_model
from .sched import DeterministicLoop, FifoPolicy

__all__ = [
    "CRASH_LOG_VERSION",
    "CrashingJournal",
    "CrashRunReport",
    "run_crash_scenario",
    "crash_matrix",
    "crash_log_text",
    "maps_identical",
]

CRASH_LOG_VERSION = 1

# Virtual-time poll interval for the event driver's crash checks: the
# crash flag flips synchronously inside controller appends, so the
# driver notices at the next poll tick — a fixed, deterministic lag.
_POLL_S = 0.25

# Runaway guard: a crash chain longer than this means the scripted
# boundaries never let a life complete (a harness bug, not a scenario).
_MAX_LIVES = 64


class CrashingJournal(Journal):
    """A journal that stops persisting after ``crash_after`` appends.

    The freeze is silent by design: record N+1 is simply never written
    (the process died before the write), the ``crashed`` flag flips,
    and the controller keeps running in memory — everything it does
    past the boundary is the doomed pre-crash work the harness then
    discards by cancelling its tasks.  ``crash_after=None`` never
    crashes (the reference configuration, kept on this class so record
    accounting is uniform)."""

    def __init__(self, *args: Any, crash_after: Optional[int] = None,
                 **kwargs: Any) -> None:
        self.crash_after = crash_after
        self.appended = 0
        self.crashed = False
        super().__init__(*args, **kwargs)

    def _frozen(self) -> bool:
        if (self.crash_after is not None
                and self.appended >= self.crash_after):
            self.crashed = True
            return True
        return False

    def append(self, kind: str, data: "dict[str, Any]", *,
               t: Optional[float] = None,
               tenant: Optional[str] = None) -> bool:
        if self._frozen():
            return False
        ok = super().append(kind, data, t=t, tenant=tenant)
        if ok:
            self.appended += 1
        return ok

    def write_snapshot(self, payload: "dict[str, Any]", *,
                       t: Optional[float] = None,
                       tenant: Optional[str] = None) -> str:
        # If the boundary lands ON the pointer append, the snapshot
        # file may exist without its pointer — exactly the torn case
        # recovery ignores (the pointer is the commit point).
        if self._frozen():
            return ""
        return super().write_snapshot(payload, t=t, tenant=tenant)


def crash_log_text(events: "list[dict[str, Any]]") -> str:
    """Canonical byte-comparable serialization of a crash-run log
    (same shape discipline as ``testing.simulate.canonical_log_text``;
    committed traces are written and compared in this form)."""
    return json.dumps({"version": CRASH_LOG_VERSION, "events": events},
                      sort_keys=True, indent=1) + "\n"


def _nbs(pmap: PartitionMap) -> "dict[str, dict[str, list[str]]]":
    return {name: {s: list(ns) for s, ns in p.nodes_by_state.items()}
            for name, p in pmap.items()}


def maps_identical(a: PartitionMap, b: PartitionMap) -> bool:
    """Bit-identical partition maps (names, states, node order)."""
    return _nbs(a) == _nbs(b)


@dataclass
class _LifeResult:
    crashed: bool
    next_event: int  # global index of the first event to (re)deliver
    records: int     # records durably appended this life
    final_map: Optional[PartitionMap] = None


@dataclass
class CrashRunReport:
    """One complete (possibly multi-crash) cluster life."""

    scenario: str
    seed: int
    crashes: "tuple[int, ...]"
    lives: int
    final_map: PartitionMap
    events: "list[dict[str, Any]]"
    counters: "dict[str, float]" = field(default_factory=dict)
    # Durable records written by the FIRST life — the reference run's
    # value is the exhaustive matrix's boundary count.
    records_first_life: int = 0

    def log_text(self) -> str:
        return crash_log_text(self.events)


def _orch_opts(scn: SimScenario) -> OrchestratorOptions:
    return OrchestratorOptions(
        move_timeout_s=scn.move_timeout_s,
        max_retries=scn.max_retries,
        backoff_base_s=scn.backoff_base_s,
        retry_seed=scn.seed,
        quarantine_after=scn.quarantine_after,
        probe_after_s=scn.probe_after_s,
        max_concurrent_partition_moves_per_node=scn.max_concurrent_moves)


async def _run_life(scn: SimScenario, model: PartitionModel,
                    loop: DeterministicLoop, rec: Recorder,
                    journal: CrashingJournal,
                    state: Optional[RecoveredState],
                    from_event: int, life: int,
                    log: "list[dict[str, Any]]", device: Any) -> _LifeResult:
    """One process lifetime: build or resume the controller, deliver
    the not-yet-durable tail of the event trace, converge or die."""

    async def data_plane(stop_ch: Any, node: str, partitions: "list[str]",
                         states: "list[str]", ops: "list[str]") -> None:
        await asyncio.sleep(
            scn.node_latency_s.get(node, scn.base_latency_s))

    if state is not None and None in state.tenants:
        ctl = resume_controller(
            state, model, data_plane,
            orchestrator_options=_orch_opts(scn),
            backend=scn.backend, debounce_s=scn.debounce_s,
            max_passes_per_cycle=scn.max_passes_per_cycle, device=device)
    else:
        # First life — or a crash so early the genesis record itself
        # was lost: nothing durable exists, bootstrap from scratch.
        ctl = RebalanceController(
            model, list(scn.nodes), initial_map(scn), data_plane,
            orchestrator_options=_orch_opts(scn),
            backend=scn.backend, device=device, debounce_s=scn.debounce_s,
            max_passes_per_cycle=scn.max_passes_per_cycle,
            journal=journal)
        ctl.start()

    events = sorted(scn.events, key=lambda e: (e.t, e.label))[from_event:]
    crashed = journal.crashed
    next_local = 0
    for i, ev in enumerate(events):
        while loop.time() < ev.t and not journal.crashed:
            await asyncio.sleep(min(_POLL_S, ev.t - loop.time()))
        if journal.crashed:
            crashed, next_local = True, i
            break
        before = journal.appended
        log.append({
            "kind": "delta", "life": life, "t": rec.now(),
            "label": ev.label, "outage": ev.outage,
            "add": list(ev.delta.add), "remove": list(ev.delta.remove),
            "fail": list(ev.delta.fail),
            "partition_weights": dict(ev.delta.partition_weights or {}),
            "node_weights": dict(ev.delta.node_weights or {})})
        ctl.submit(ev.delta)
        if journal.appended == before:
            # The delta's own record was the first casualty: this event
            # never became durable — it is the redelivery point.
            crashed, next_local = True, i
            break
        next_local = i + 1

    final: Optional[PartitionMap] = None
    if not crashed:
        final = await ctl.quiesce()
        # The journal may have died during convergence or on the
        # quiesce/snapshot records themselves — the in-memory idle map
        # is then doomed pre-crash state, not a result.
        crashed = journal.crashed

    if crashed:
        log.append({"kind": "crash", "life": life, "t": rec.now(),
                    "epoch": journal.epoch, "records": journal.appended,
                    "next_event": from_event + next_local})
        for task in ctl.pending_tasks():
            task.cancel()
        for _ in range(8):  # drain the cancellations
            await asyncio.sleep(0)
        return _LifeResult(True, from_event + next_local,
                           journal.appended)

    assert final is not None
    log.append({"kind": "life-end", "life": life, "t": rec.now(),
                "epoch": journal.epoch, "records": journal.appended,
                "map_digest": map_digest(final)})
    await ctl.stop()
    journal.close()
    return _LifeResult(False, from_event + len(events),
                       journal.appended, final_map=final)


def run_crash_scenario(scn: SimScenario, journal_dir: str, *,
                       crashes: "tuple[int, ...]" = (),
                       snapshot_every: int = 0,
                       rotate_records: int = 64,
                       device: Any = "cuda") -> CrashRunReport:
    """One cluster life under a scripted crash chain: life ``i`` dies
    after ``crashes[i]`` durable records (lives past the end of
    ``crashes`` run crash-free).  Each restart recovers from the
    journal into a fresh virtual loop and redelivers the events the
    journal never durably received.  Pure function of its arguments —
    same scenario + boundaries => byte-identical ``log_text()``.
    ``device`` is where each life's controller plans; the log does not
    name it."""
    resolve_device(device, "run_crash_scenario")
    model = scenario_model(scn)
    log: "list[dict[str, Any]]" = [{
        "kind": "init", "life": 0, "t": 0.0, "scenario": scn.name,
        "seed": scn.seed, "crashes": list(crashes),
        "nodes": list(scn.nodes), "partitions": scn.partitions,
        "replicas": scn.replicas, "snapshot_every": snapshot_every}]
    counters: "dict[str, float]" = {}
    from_event = 0
    records_first = 0
    life = 0
    while True:
        if life > _MAX_LIVES:
            raise RuntimeError(
                f"crash chain never completed a life ({scn.name})")
        loop = DeterministicLoop(FifoPolicy(), max_steps=scn.max_steps)
        rec = Recorder(clock=loop.time)
        crash_after = crashes[life] if life < len(crashes) else None
        with use_recorder(rec):
            if life == 0:
                journal = CrashingJournal(
                    journal_dir, clock=loop.time,
                    crash_after=crash_after,
                    rotate_records=rotate_records,
                    snapshot_every=snapshot_every)
                state: Optional[RecoveredState] = None
            else:
                def _factory(*a: Any, **kw: Any) -> Journal:
                    return CrashingJournal(
                        *a, crash_after=crash_after, **kw)

                state = recover(
                    journal_dir, clock=loop.time,
                    rotate_records=rotate_records,
                    snapshot_every=snapshot_every,
                    journal_factory=_factory)
                journal = state.journal  # type: ignore[assignment]
                t0 = state.tenants.get(None)
                log.append({
                    "kind": "recover", "life": life, "t": 0.0,
                    "epoch": state.epoch,
                    "replayed": state.records_replayed,
                    "torn": state.torn_segments,
                    "stale_dropped": state.stale_dropped,
                    "next_event": from_event,
                    "map_digest": (map_digest(t0.pmap)
                                   if t0 is not None else None)})
            result = loop.run_until_complete(_run_life(
                scn, model, loop, rec, journal, state,  # type: ignore[arg-type]
                from_event, life, log, device))
        for name, value in rec.counters.items():
            if name.startswith("durability."):
                counters[name] = counters.get(name, 0) + value
        if life == 0:
            records_first = result.records
        if not result.crashed:
            assert result.final_map is not None
            log.append({"kind": "end", "life": life, "t": 0.0,
                        "lives": life + 1,
                        "map_digest": map_digest(result.final_map),
                        "placements": _nbs(result.final_map)})
            return CrashRunReport(
                scenario=scn.name, seed=scn.seed, crashes=tuple(crashes),
                lives=life + 1, final_map=result.final_map, events=log,
                counters=counters, records_first_life=records_first)
        from_event = result.next_event
        life += 1


def crash_matrix(scn: SimScenario, base_dir: str, *,
                 boundaries: "Optional[list[int]]" = None,
                 snapshot_every: int = 0, rotate_records: int = 64,
                 device: Any = "cuda",
                 ) -> "tuple[CrashRunReport, list[tuple[int, CrashRunReport]]]":
    """The bounded-exhaustive acceptance check: a crash-free reference
    run, then one single-crash run per journal-record boundary of the
    reference (or per entry of ``boundaries``).  Returns the reference
    report plus ``(boundary, report)`` pairs — callers assert each
    report's final map is bit-identical to the reference's."""
    ref = run_crash_scenario(
        scn, os.path.join(base_dir, "ref"), crashes=(),
        snapshot_every=snapshot_every, rotate_records=rotate_records,
        device=device)
    ks = (boundaries if boundaries is not None
          else list(range(ref.records_first_life)))
    out: "list[tuple[int, CrashRunReport]]" = []
    for k in ks:
        report = run_crash_scenario(
            scn, os.path.join(base_dir, f"k{k:04d}"), crashes=(k,),
            snapshot_every=snapshot_every, rotate_records=rotate_records,
            device=device)
        out.append((k, report))
    return ref, out
