# Port of blance_tpu/testing/fleetsim.py: run_fleet_scenario takes
# ``device`` ("cuda" by default) for the FleetController, its plan
# service and its tenants' controllers; the log is the reference's.
"""Multi-tenant closed-loop fleet simulator (docs/SIMULATOR.md
"Multi-tenant scenario families").

``testing/simulate.py`` replays ONE tenant's cluster life; this module
replays a FLEET: a seeded :class:`~blance_tpu_torch.testing.scenarios.
FleetScenario` drives a :class:`~blance_tpu_torch.fleetloop.FleetController`
— N per-tenant ``RebalanceController`` loops multiplexed over one
shared ``PlanService`` + ``CarryCache`` — entirely under the
``DeterministicLoop`` virtual clock, so a multi-hundred-tenant virtual
week replays bit-identically: the event log, every tenant's SLO
summary, the fleet rollup AND the rendered exposition text are pure
functions of the scenario.

The runner executes the SAME scenario in two modes:

- ``coalesce=True`` (the fleet plane): overlapping debounce windows
  land tenants' converge cycles in shared bucketed ``[B, ...]`` fleet
  dispatches;
- ``coalesce=False`` (the sequential loop-per-tenant baseline): the
  same code path with a zero admission window and ``max_batch=1`` —
  one device dispatch per tenant per plan, the per-problem dispatch
  tax the fleet tier exists to eliminate.

Per-element fleet solves are bit-identical to single-problem solves
(plan/fleet.py's contract) and, with an unbounded carry cache, both
modes make identical warm/cold decisions — so the two runs converge to
IDENTICAL final maps with EQUAL executed moves, and the only deltas are
the dispatch count and the wall-clock (the ``fleet_loop`` bench stage's
gate).

Event-log schema (``FLEET_LOG_VERSION``): ``init`` (nodes + tenant
specs + t0 placements), ``onboard`` (a staggered tenant's empty-start),
``delta`` (label, targets, fields), ``strip``/``batch``/``quiesce``
(tenant-tagged), ``end`` (per-tenant availability + fleet rollup +
dispatch/request/starved counters).  ``canonical_fleet_log_text`` is
the byte-comparable serialization committed under ``tests/traces/``.
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

from ..convert import resolve_device
from ..core.types import Partition, PartitionMap, PartitionModel, model
from ..fleetloop import FleetController
from ..obs import Recorder, use_recorder
from ..obs.expo import render_prometheus
from ..obs.recorder import percentile
from ..obs.slo import FleetSloSummary, SloSummary
from ..rebalance import ClusterDelta
from ..utils.hostclock import perf_now
from .scenarios import FleetScenario, FleetTenant
from .sched import DeterministicLoop, FifoPolicy

__all__ = [
    "FLEET_LOG_VERSION",
    "FleetSimReport",
    "canonical_fleet_log_text",
    "run_fleet_scenario",
    "tenant_model",
    "tenant_initial_map",
]

FLEET_LOG_VERSION = 1


def tenant_model(spec: FleetTenant) -> PartitionModel:
    """primary(+replicas) model for one tenant."""
    if spec.replicas > 0:
        return model(primary=(0, 1), replica=(1, spec.replicas))
    return model(primary=(0, 1))


def tenant_initial_map(spec: FleetTenant, nodes: Sequence[str],
                       offset: int) -> PartitionMap:
    """Deterministic seed placements.  A t0 tenant gets round-robin
    placements offset by its fleet index (tenants don't all pile their
    primaries on node 0); an onboarding tenant starts EMPTY — its first
    converge cycle places everything."""
    out: PartitionMap = {}
    n = len(nodes)
    for i in range(spec.partitions):
        name = f"p{i:04d}"
        if spec.onboard_t > 0:
            nbs: dict[str, list[str]] = {}
        else:
            nbs = {"primary": [nodes[(i + offset) % n]]}
            if spec.replicas > 0:
                nbs["replica"] = [nodes[(i + offset + 1 + r) % n]
                                  for r in range(spec.replicas)]
        out[name] = Partition(name, nbs)
    return out


def canonical_fleet_log_text(events: list[dict[str, Any]]) -> str:
    """THE byte-comparable serialization (sorted keys, fixed
    separators, trailing newline) — committed replay traces are written
    and compared in exactly this form."""
    return json.dumps({"version": FLEET_LOG_VERSION, "events": events},
                      sort_keys=True, indent=1) + "\n"


@dataclass
class FleetSimReport:
    """Everything one fleet scenario run produced (module doc)."""

    scenario: str
    seed: int
    coalesced: bool
    horizon_s: float
    tenants: int
    final_maps: dict[str, PartitionMap]
    complete: bool
    summaries: dict[str, SloSummary]
    fleet: FleetSloSummary
    events: list[dict[str, Any]]
    # Device-dispatch economics: the coalescing win is
    # dispatches << plan_requests (sequential mode: dispatches ==
    # plan_requests).
    dispatches: int
    plan_requests: int
    starved_admissions: int
    carry_evictions: dict[str, int]
    carry_hits: int
    cycles: int
    passes: int
    superseded: int
    unconverged: int
    admission_p50_s: float
    admission_p99_s: float
    exposition: str
    # Encode-residency economics: all deterministic
    # counters, safe to compare across runs.
    encode_cold: int = 0
    encode_warm: int = 0
    encode_demotions: dict[str, int] = field(default_factory=dict)
    encode_evictions: dict[str, int] = field(default_factory=dict)
    encode_patch_bytes: int = 0
    encode_patch_rows: int = 0
    decode_full: int = 0
    decode_patch: int = 0
    steps: int = 0
    wall_s: float = 0.0  # host time; NOT part of the replayable account
    # Host wall-clock split of the cycle cost (encode / decode /
    # device / other); like wall_s, NOT part of the replayable account.
    phase_wall: dict[str, float] = field(default_factory=dict)

    def log_text(self) -> str:
        return canonical_fleet_log_text(self.events)


class _TenantLog:
    """Tenant-tagged move observer feeding the shared event log."""

    def __init__(self, log: "_FleetLog", key: str) -> None:
        self._log = log
        self._key = key

    def on_batch(self, node: str, moves: Sequence[Any], ok: bool,
                 now: float) -> None:
        self._log.emit("batch", now, tenant=self._key, node=node,
                       ok=bool(ok),
                       moves=[[m.partition, m.node, m.state, m.op]
                              for m in moves])


class _FleetLog:
    def __init__(self) -> None:
        self.events: list[dict[str, Any]] = []

    def emit(self, kind: str, t: float, **fields: Any) -> None:
        self.events.append({"kind": kind, "t": t, **fields})


def _placements_of(pmap: PartitionMap) -> dict[str, dict[str, list[str]]]:
    return {name: {s: list(ns) for s, ns in p.nodes_by_state.items()}
            for name, p in pmap.items()}


def _map_complete(pmap: PartitionMap, mdl: PartitionModel,
                  live: set[str]) -> bool:
    """Every partition holds its full constraint count per state, all
    placements on live nodes, no duplicates (simulate.py's check)."""
    for p in pmap.values():
        seen: set[str] = set()
        for state, st in mdl.items():
            ns = p.nodes_by_state.get(state, [])
            if len(ns) != st.constraints:
                return False
            for n in ns:
                if n in seen or n not in live:
                    return False
                seen.add(n)
    return True


async def _fleet_main(scn: FleetScenario, loop: DeterministicLoop,
                      rec: Recorder, coalesce: bool,
                      encode_residency: bool = True,
                      device: Any = "cuda") -> FleetSimReport:
    log = _FleetLog()
    specs = {t.key: t for t in scn.tenants}
    models = {t.key: tenant_model(t) for t in scn.tenants}
    offsets = {t.key: i for i, t in enumerate(scn.tenants)}

    async def data_plane(stop_ch: Any, node: str, partitions: list[str],
                         states: list[str], ops: list[str]) -> None:
        await asyncio.sleep(
            scn.node_latency_s.get(node, scn.base_latency_s))

    fc = FleetController(
        list(scn.nodes), coalesce=coalesce,
        admission_window_s=scn.admission_window_s,
        fair_share=scn.fair_share,
        carry_bytes=scn.carry_bytes,
        carry_entries=scn.carry_entries,
        inline_solve=True,  # loop-only: the determinism requirement
        debounce_s=scn.debounce_s,
        max_passes_per_cycle=scn.max_passes_per_cycle,
        availability_floor=scn.availability_floor,
        recorder=rec,
        encode_residency=encode_residency,
        device=device)
    await fc.start()

    def onboard(spec: FleetTenant, t0: bool) -> None:
        key = spec.key
        initial = tenant_initial_map(spec, scn.nodes, offsets[key])
        ctl = fc.add_tenant(
            key, models[key], initial, data_plane,
            move_observers=(_TenantLog(log, key),),
            kick=not t0)
        slo = fc.tenant(key).slo

        def on_quiesce(t: float, key: str = key) -> None:
            log.emit("quiesce", t, tenant=key,
                     availability=slo.availability())

        def on_strip(nodes: set[str], t: float, key: str = key) -> None:
            log.emit("strip", t, tenant=key, nodes=sorted(nodes))

        ctl.on_quiesce.append(on_quiesce)
        ctl.on_strip.append(on_strip)
        if not t0:
            log.emit("onboard", loop.time(), tenant=key,
                     partitions=spec.partitions, replicas=spec.replicas)

    log.emit(
        "init", 0.0, scenario=scn.name, seed=scn.seed,
        coalesced=coalesce, horizon_s=scn.horizon_s,
        nodes=list(scn.nodes), floor=scn.availability_floor,
        tenants=[{"key": t.key, "partitions": t.partitions,
                  "replicas": t.replicas, "onboard_t": t.onboard_t}
                 for t in scn.tenants],
        placements={t.key: _placements_of(
            tenant_initial_map(t, scn.nodes, offsets[t.key]))
            for t in scn.tenants if t.onboard_t <= 0})
    for spec in scn.tenants:
        if spec.onboard_t <= 0:
            onboard(spec, t0=True)

    # The merged timeline: staggered onboardings + scripted deltas, in
    # virtual-time order (stable tie-break on kind + label/key).
    timeline: list[tuple[float, int, str, Any]] = []
    for spec in scn.tenants:
        if spec.onboard_t > 0:
            timeline.append((spec.onboard_t, 0, spec.key, spec))
    for ev in scn.events:
        timeline.append((ev.t, 1, ev.label, ev))
    timeline.sort(key=lambda e: (e[0], e[1], e[2]))

    # Driver-side fleet membership (correlated events only), for the
    # end-of-run completeness check.
    dark: set[str] = set()

    for t_ev, kind, _tag, payload in timeline:
        delay = t_ev - loop.time()
        if delay > 0:
            await asyncio.sleep(delay)
        t = rec.now()
        if kind == 0:
            onboard(payload, t0=False)
            continue
        ev = payload
        targets = list(ev.tenants) if ev.tenants else sorted(fc.keys())
        log.emit("delta", t, label=ev.label, outage=ev.outage,
                 tenants=(sorted(ev.tenants) if ev.tenants else ["*"]),
                 add=list(ev.delta.add), remove=list(ev.delta.remove),
                 fail=list(ev.delta.fail),
                 partition_weights=dict(ev.delta.partition_weights or {}),
                 node_weights=dict(ev.delta.node_weights or {}))
        if not ev.tenants:
            dark |= set(ev.delta.remove) | set(ev.delta.fail)
            dark -= set(ev.delta.add)
        for key in targets:
            fc.submit(key, ev.delta)

    remaining = scn.horizon_s - loop.time()
    if remaining > 0:
        await asyncio.sleep(remaining)
    final_maps = await fc.quiesce_all()

    t_end = rec.now()
    live = set(scn.nodes) - dark
    complete = all(
        _map_complete(final_maps[key], models[key], live)
        for key in final_maps)
    summaries = {key: fc.tenant(key).slo.summary(t_end)
                 for key in final_maps}
    fleet_summary = fc.summary()
    cache_stats = fc.service.carry_cache.stats()
    dispatches = int(rec.counters.get("fleet.batches", 0))
    requests = int(rec.counters.get("fleet.requests", 0))
    starved = int(rec.counters.get("fleet.starved_admissions", 0))

    log.emit(
        "end", t_end,
        complete=complete,
        availability={k: summaries[k].availability
                      for k in sorted(summaries)},
        fleet={"tenants": fleet_summary.tenants,
               "availability_min": fleet_summary.availability_min,
               "availability_mean": fleet_summary.availability_mean,
               "tenants_below_floor": fleet_summary.tenants_below_floor,
               "moves_executed": fleet_summary.moves_executed,
               "moves_failed": fleet_summary.moves_failed},
        dispatches=dispatches, plan_requests=requests,
        starved_admissions=starved,
        carry_evictions=dict(cache_stats["evictions"]),  # type: ignore[arg-type]
        cycles=fc.cycles, passes=fc.passes,
        superseded=fc.superseded, unconverged=fc.unconverged_cycles)

    phase_wall = fc.host_phases()
    enc_cache = fc.encode_cache
    await fc.stop()

    lat = sorted(rec.histograms.get("fleet.admission_latency_s", []))
    return FleetSimReport(
        scenario=scn.name, seed=scn.seed, coalesced=coalesce,
        horizon_s=scn.horizon_s, tenants=len(scn.tenants),
        final_maps=final_maps, complete=complete,
        summaries=summaries, fleet=fleet_summary, events=log.events,
        dispatches=dispatches, plan_requests=requests,
        starved_admissions=starved,
        carry_evictions=dict(cache_stats["evictions"]),  # type: ignore[arg-type]
        carry_hits=int(rec.counters.get("plan.solve.carry_hit", 0)),
        cycles=fc.cycles, passes=fc.passes, superseded=fc.superseded,
        unconverged=fc.unconverged_cycles,
        admission_p50_s=(percentile(lat, 50) if lat else 0.0),
        admission_p99_s=(percentile(lat, 99) if lat else 0.0),
        exposition=render_prometheus(rec),
        encode_cold=int(rec.counters.get("fleet.encode_cold", 0)),
        encode_warm=int(rec.counters.get("fleet.encode_warm", 0)),
        encode_demotions=(dict(enc_cache.demotions)
                          if enc_cache is not None else {}),
        encode_evictions=(dict(enc_cache.evictions)
                          if enc_cache is not None else {}),
        encode_patch_bytes=int(
            rec.counters.get("fleet.encode_patch_bytes", 0)),
        encode_patch_rows=int(rec._hist_stats.get(
            "fleet.encode_patch_rows", (0, 0.0))[1]),  # exact sum
        decode_full=int(rec.counters.get("fleet.decode_full", 0)),
        decode_patch=int(rec.counters.get("fleet.decode_patch", 0)),
        phase_wall=phase_wall)


def run_fleet_scenario(scn: FleetScenario,
                       coalesce: bool = True,
                       encode_residency: bool = True,
                       device: Any = "cuda") -> FleetSimReport:
    """Run one fleet scenario to completion under the virtual clock.
    Pure function of (scenario, coalesce): same inputs -> byte-identical
    event log, SLO summaries and exposition text; ``wall_s``/``steps``/
    ``phase_wall`` are the only host-dependent fields.
    ``encode_residency=False`` runs the full-re-encode-per-cycle
    baseline — a pure perf toggle: the event log and every replayable
    quantity are byte-identical either way (tests pin this), only the
    host wall-clock and the ``fleet.encode_*`` accounting differ.
    ``device`` is where the fleet's batched solves run; the log does not
    name it."""
    resolve_device(device, "run_fleet_scenario")
    loop = DeterministicLoop(FifoPolicy(), max_steps=scn.max_steps)
    rec = Recorder(clock=loop.time)
    t0 = perf_now()
    with use_recorder(rec):
        report = loop.run_until_complete(
            _fleet_main(scn, loop, rec, coalesce, encode_residency,
                        device))
    report.wall_s = perf_now() - t0
    report.steps = loop.steps
    return report
