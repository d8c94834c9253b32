# Port of blance_tpu/fleetloop.py: the same fleet of control loops over
# the port's PlanService; FleetController takes ``device`` ("cuda" by
# default) for its own service and its tenants' controllers.
"""Fleet of control loops: N tenants' continuous rebalance through one
coalesced plan dispatch (ROADMAP item 3 — the production shape).

The paper's deployment (cbgt/FTS at millions of users) is not one
cluster rebalancing once: it is hundreds of tenant *indexes*, each
running its own continuous rebalance loop over a shared node fleet.
PR 7 made many tenants' *solves* one vmapped dispatch
(``plan/fleet.py`` + ``plan/service.py``); PR 10 closed *one* tenant's
loop (``rebalance.RebalanceController``).  This module composes them:

- each tenant runs a full :class:`~blance_tpu_torch.rebalance.
  RebalanceController` — the extracted
  :class:`~blance_tpu_torch.control.CycleEngine` cycle machine — as ONE task
  on a single shared event loop (no thread per tenant);
- every controller plans through a :class:`ServicePlanner`, the
  :class:`~blance_tpu_torch.control.CyclePlanner` that encodes the tenant's
  map problem to dense arrays, submits it to the ONE shared
  :class:`~blance_tpu_torch.plan.service.PlanService`, and decodes the
  result — so tenants whose debounce windows overlap land their
  converge cycles in the SAME bucketed ``[B, ...]`` fleet dispatch
  (GSPMD-style shape bucketing keeps compiled programs shared as
  tenant shapes drift, arXiv:2105.04663).  The steady-state cost of N
  loops is a handful of bucketed programs, not N dispatches;
- per-tenant warm carries ride the service's shared
  :class:`~blance_tpu_torch.plan.carry.CarryCache` under a conservative
  protocol (below) in which a cache eviction or invalidation only ever
  costs a cold solve — never a stale or wrong map;
- the service's ``fair_share`` quota gives cross-tenant admission
  fairness: a chatty tenant churning weight deltas cannot fill a
  coalescing window and starve its neighbors
  (``fleet.starved_admissions``);
- per-tenant SLO accounts aggregate into the fleet-wide
  ``slo.fleet_*`` / ``fleet.*`` scorecard
  (:class:`~blance_tpu_torch.obs.slo.FleetSloRollup`), rendered by the
  existing exposition plane.

Warm-carry protocol (the ServicePlanner side of the CarryCache's
"eviction is always safe" contract): a request states its delta
(``dirty``) — and thereby opts into the one-sweep warm repair — ONLY
when, versus the planner's previous request, (a) the partition set and
every array shape are unchanged, (b) partition AND node weights are
byte-identical (a re-priced problem invalidates the carry, exactly like
``PlannerSession.set_partition_weights``), and (c) the dark-node set
did not shrink (returned capacity must re-balance, which only a cold
solve does).  The dirty mask is then the holders of currently-dark
nodes; the service's value-match of ``prev`` against the cached
assignment catches everything else (superseded passes, failures,
mid-flight divergence) and demotes to cold.  Cold is always correct —
it is the single-problem solve on the current inputs.

Determinism: everything here is loop-only when the service runs
``inline_solve=True`` — under ``testing.sched.DeterministicLoop`` a
multi-hundred-tenant virtual week replays bit-identically
(``testing/fleetsim.py``, docs/SIMULATOR.md).
"""

from __future__ import annotations

import asyncio
import dataclasses
from typing import TYPE_CHECKING, Any, Callable, Optional

if TYPE_CHECKING:  # pragma: no cover - type-only (import cycle)
    from .durability.journal import Journal
    from .durability.recover import RecoveredState

import numpy as np

from .control import CyclePlanner
from .core.encode import DenseProblem, decode_assignment, encode_problem
from .core.types import PartitionMap, PartitionModel, PlanOptions
from .obs import get_recorder
from .obs.slo import FleetSloRollup, FleetSloSummary, SloTracker
from .orchestrate.orchestrator import OrchestratorOptions
from .plan.carry import EncodeCache
from .plan.fleet import TenantProblem
from .plan.resident import EncodedState, build_encoded_state
from .plan.service import PlanService
from .rebalance import ClusterDelta, RebalanceController
from .utils.hostclock import perf_now

__all__ = ["FleetController", "ServicePlanner", "TenantLoop"]


class ServicePlanner(CyclePlanner):
    """One tenant's :class:`~blance_tpu_torch.control.CyclePlanner` over the
    shared :class:`~blance_tpu_torch.plan.service.PlanService` (module doc:
    encode → submit → decode, with the conservative warm protocol).

    With ``encode_residency`` (the default) the encode/decode halves
    are DELTA-RESIDENT (:mod:`blance_tpu_torch.plan.resident`): the interned
    problem arrays live in an :class:`~blance_tpu_torch.plan.carry.
    EncodeCache` keyed by tenant, each cycle patches them in O(delta)
    (dark-set flips, weight-row writes, strip scatters), adoption
    replaces ``prev`` with the landed solve's packed assignment, and
    decode patches the held map at the changed rows — a warm converge
    cycle writes only dirty rows + scalars instead of re-running
    ``encode_problem``/``decode_assignment`` over the whole cluster.
    The warm-SOLVE protocol (the ``dirty`` mask, ``_dirty_for``) is
    byte-for-byte the pre-residency decision tree on the resident
    arrays, so solve decisions — and therefore dispatch counts, event
    logs and committed traces — are bit-identical either way; any
    off-protocol event (divergent pass, supersede, statics swap, shape
    drift, cache eviction) demotes to a full re-encode, never a stale
    map.  ``host_phase`` accumulates host wall-clock seconds per phase
    (encode/decode) for the bench stage's phase split."""

    def __init__(self, key: str, service: PlanService, *,
                 recorder: Optional[Any] = None,
                 encode_cache: Optional[EncodeCache] = None,
                 encode_residency: bool = True) -> None:
        self.key = key
        self._service = service
        self._rec = recorder if recorder is not None else get_recorder()
        self._resident = bool(encode_residency)
        self._encodes = encode_cache if encode_cache is not None else (
            EncodeCache(recorder=self._rec) if self._resident else None)
        # Fingerprint of the previous request: (dark set, partition
        # list, prev shape, N, pweights bytes, nweights bytes).  None
        # until the first cycle — the first request is always cold.
        self._last: Optional[tuple[frozenset[str], tuple[str, ...],
                                   tuple[int, ...], int, bytes,
                                   bytes]] = None
        # Host wall-clock per planner phase (perf_counter seconds; NOT
        # recorder/virtual time — the bench phase-split source).
        self.host_phase: dict[str, float] = {"encode": 0.0,
                                             "decode": 0.0}

    async def plan_cycle(
        self,
        current: PartitionMap,
        nodes: list[str],
        removes: list[str],
        model: PartitionModel,
        opts: PlanOptions,
    ) -> tuple[PartitionMap, dict[str, list[str]]]:
        if opts.node_score_booster is not None or \
                opts.node_scorer is not None or \
                opts.node_sorter is not None:
            raise ValueError(
                f"tenant {self.key!r}: the fleet plan service runs the "
                f"dense batch solver, which does not support "
                f"node_score_booster/node_scorer/node_sorter hooks — "
                f"run this tenant on a local planner instead")
        t0 = perf_now()
        problem, st = self._encode(current, nodes, removes, model, opts)
        fp = (frozenset(removes), tuple(problem.partitions),
              tuple(problem.prev.shape), problem.N,
              problem.partition_weights.tobytes(),
              problem.node_weights.tobytes())
        dirty = self._dirty_for(problem, fp)
        tenant = TenantProblem.from_dense(self.key, problem, dirty=dirty)
        self.host_phase["encode"] += perf_now() - t0
        result = await self._service.submit(tenant)
        t1 = perf_now()
        if st is None:
            next_map, warnings = decode_assignment(
                problem, result.assign, current, removes)
            if self._resident:
                self._rec.count("fleet.decode_full")
        else:
            next_map, warnings, full, nrows = st.decode(
                np.asarray(result.assign), current, removes)
            self._rec.count("fleet.decode_full" if full
                            else "fleet.decode_patch")
            if not full:
                self._rec.observe("fleet.decode_dirty_rows",
                                  float(nrows))
        self._last = fp
        self.host_phase["decode"] += perf_now() - t1
        return next_map, warnings

    # -- the encode-residency layer (plan/resident.py) ---------------------

    def _encode(self, current: PartitionMap, nodes: list[str],
                removes: list[str], model: PartitionModel,
                opts: PlanOptions) -> tuple[DenseProblem,
                                            Optional[EncodedState]]:
        """The cycle's encoded problem: the resident arrays patched in
        O(delta) when the warm-encode protocol holds, else a full
        ``encode_problem`` (counted ``fleet.encode_cold``; every such
        cold beyond a tenant's first is preceded by exactly one counted
        demotion or eviction)."""
        if not self._resident:
            return encode_problem(current, current, nodes, removes,
                                  model, opts), None
        assert self._encodes is not None
        rec = self._rec
        st = self._encodes.get(self.key)
        if st is not None:
            reason = self._warm_gate(st, current, nodes, model, opts)
            if reason is None:
                rows = 0
                nbytes = 0
                added = st.apply_nodes(nodes, opts)
                if added is None:
                    self._encodes.invalidate(self.key, "nodes")
                    st = None
                else:
                    nbytes += added[1]
                    rows += st.apply_removes(frozenset(removes))
                    wrows, wbytes = st.apply_weights(opts)
                    rows += wrows
                    nbytes += wbytes
                    rec.count("fleet.encode_warm")
                    if rows:
                        rec.observe("fleet.encode_patch_rows",
                                    float(rows))
                    if nbytes:
                        rec.count("fleet.encode_patch_bytes", nbytes)
                    return st.problem, st
            else:
                self._encodes.invalidate(self.key, reason)
                st = None
        problem = encode_problem(current, current, nodes, removes,
                                 model, opts)
        st = build_encoded_state(problem, current, removes, model, opts)
        if st is not None:
            # Counted only when resident state is actually
            # (re)established: an out-of-protocol tenant (pass-through
            # states, degenerate shapes) full-encodes every cycle by
            # design, and counting those would break the attribution
            # bound (tenants <= encode_cold <= tenants + demotions +
            # evictions) the perf-smoke gate pins.  Its full decodes
            # still show as fleet.decode_full.
            rec.count("fleet.encode_cold")
            self._encodes.put(self.key, st)
        return problem, st

    def _warm_gate(self, st: EncodedState, current: PartitionMap,
                   nodes: list[str], model: PartitionModel,
                   opts: PlanOptions) -> Optional[str]:
        """The conservative protocol: None when the resident state may
        be delta-patched for this cycle, else the demotion reason.  The
        one warm entry besides an adopted pass: ``current`` IS the map
        object this planner returned last cycle (a direct caller
        adopting the proposal wholesale) — then the pending proposal's
        packed assignment is adopted as ``prev`` on the spot."""
        if not st.statics_match(model, opts):
            return "statics"
        if current is not st.expected:
            if st.pending is not None and current is st.pending.map:
                rows, nbytes = st.adopt(st.pending, current)
                self._note_patch(rows, nbytes)
            else:
                return "divergence"
        else:
            p = st.pending
            if p is not None and not p.changed and st.map is None:
                # A zero-move proposal: the solve changed nothing, so
                # its decoded map IS the canonical decode of the
                # unchanged resident prev — holding it unlocks
                # incremental decode without waiting for a pass to
                # land (weight-drift cycles often converge move-free).
                st.map = p.map
            # Any other un-adopted proposal is stale: the cluster
            # stayed on ``expected``, so the next solve re-proposes
            # from the same prev.
            st.pending = None
        if st.shape_drifted():
            return "shape"
        return None

    def _note_patch(self, rows: int, nbytes: int) -> None:
        if rows:
            self._rec.observe("fleet.encode_patch_rows", float(rows))
        if nbytes:
            self._rec.count("fleet.encode_patch_bytes", nbytes)

    # -- controller notifications (rebalance.RebalanceController) ----------

    def notify_strip(self, nodes: set[str], before: PartitionMap,
                     after: PartitionMap) -> None:
        """An abrupt-fail strip replaced the controller's current map:
        patch the resident prev/map at the holder rows and re-key the
        identity token, or demote when the strip did not start from the
        map we encode."""
        if not self._resident:
            return
        assert self._encodes is not None
        st = self._encodes.get(self.key)
        if st is None:
            return
        if st.expected is not before:
            self._encodes.invalidate(self.key, "divergence")
            return
        rows, nbytes = st.apply_strip(nodes, after)
        self._note_patch(rows, nbytes)

    def notify_pass(self, achieved: PartitionMap,
                    end_map: PartitionMap, clean: bool) -> None:
        """An orchestration pass adopted ``achieved`` as current.  When
        the pass landed OUR pending proposal verbatim (``clean`` hint
        from the controller, the target is identical to the proposal
        object, and every row the proposal changed reads back equal),
        adopt: the packed assignment becomes ``prev`` and ``achieved``
        the identity token.  Anything else — supersede, failures,
        quarantine strips, a locally-planned degraded pass — demotes to
        a cold re-encode.  Never a stale map: rows the proposal did not
        change are the held map's own objects, so only changed rows
        need the read-back check."""
        if not self._resident:
            return
        assert self._encodes is not None
        st = self._encodes.get(self.key)
        if st is None:
            return
        p = st.pending
        if not clean or p is None or end_map is not p.map:
            self._encodes.invalidate(self.key, "divergence")
            return
        for pname in p.changed:
            got = achieved.get(pname)
            if got is None or \
                    got.nodes_by_state != p.map[pname].nodes_by_state:
                self._encodes.invalidate(self.key, "divergence")
                return
        rows, nbytes = st.adopt(p, achieved)
        self._note_patch(rows, nbytes)

    def _dirty_for(self, problem: Any,
                   fp: tuple) -> Optional[np.ndarray]:
        """The request's delta mask when the warm path MAY run, else
        None (cold — see the module doc's warm-carry protocol)."""
        last = self._last
        if last is None:
            return None
        dark, parts, shape, n, pw, nw = fp
        ldark, lparts, lshape, ln, lpw, lnw = last
        if parts != lparts or shape != lshape or n != ln:
            return None  # re-shaped problem: any carry is stale
        if pw != lpw or nw != lnw:
            return None  # re-priced problem: the carry's fills lie
        if not (ldark <= dark):
            return None  # capacity returned: only a cold solve rebalances
        dark_ids = np.array(
            [i for i, name in enumerate(problem.nodes) if name in dark],
            np.int32)
        dirty: np.ndarray = np.isin(problem.prev, dark_ids).any(
            axis=(1, 2))
        return dirty


@dataclasses.dataclass
class TenantLoop:
    """One tenant's registered control loop."""

    key: str
    controller: RebalanceController
    planner: ServicePlanner
    slo: SloTracker


class FleetController:
    """N per-tenant rebalance loops multiplexed over one shared plan
    service + carry cache on a single event loop (module doc).

    ``coalesce=False`` is the sequential loop-per-tenant BASELINE: the
    same code path with a zero admission window and ``max_batch=1``,
    so every tenant plan costs its own device dispatch — the
    configuration the ``fleet_loop`` bench stage beats (identical
    final maps, measurably fewer dispatches; docs/FLEET.md).

    Shared state (analysis/race_lint.py SHARED_STATE): the tenant
    registry is mutated only from the driving task (``add_tenant`` /
    ``forget_tenant``), in sync windows; each controller's own state
    follows the CycleEngine discipline; the rollup and the service are
    single-window by their own contracts.
    """

    def __init__(
        self,
        nodes_all: list[str],
        *,
        service: Optional[PlanService] = None,
        coalesce: bool = True,
        admission_window_s: float = 0.002,
        fair_share: Optional[int] = None,
        max_batch: int = 1024,
        max_pending: int = 4096,
        carry_bytes: Optional[int] = 64 << 20,
        carry_entries: Optional[int] = 16384,
        mesh: Optional[Any] = None,
        inline_solve: bool = False,
        batch_floor: int = 16,
        orchestrator_options: Optional[OrchestratorOptions] = None,
        plan_options: Optional[PlanOptions] = None,
        debounce_s: float = 0.05,
        max_passes_per_cycle: int = 8,
        availability_floor: Optional[float] = None,
        recorder: Optional[Any] = None,
        encode_residency: bool = True,
        encode_bytes: Optional[int] = 256 << 20,
        encode_entries: Optional[int] = 16384,
        journal: "Optional[Journal]" = None,
        device: Any = "cuda",
    ) -> None:
        self.nodes_all = list(nodes_all)
        self._rec = recorder if recorder is not None else get_recorder()
        self._own_service = service is None
        if service is None:
            service = PlanService(
                admission_window_s=admission_window_s if coalesce
                else 0.0,
                max_batch=max_batch if coalesce else 1,
                max_pending=max_pending,
                fair_share=fair_share if coalesce else None,
                carry_bytes=carry_bytes,
                carry_entries=carry_entries,
                mesh=mesh,
                inline_solve=inline_solve,
                # Both modes share the floored batch programs: a fleet
                # of loops dispatches many SMALL batches (sequential
                # mode: all B=1), and without the floor every distinct
                # coalesced size compiles its own program.
                batch_floor=batch_floor,
                recorder=self._rec,
                device=device,
            )
        self.service = service
        self.device = device
        self.coalesce = coalesce
        self.orch_opts = orchestrator_options or OrchestratorOptions()
        self.plan_options = plan_options
        self.debounce_s = debounce_s
        self.max_passes_per_cycle = max_passes_per_cycle
        self.availability_floor = availability_floor
        self._tenants: dict[str, TenantLoop] = {}
        # Encode residency (docs/DESIGN.md): one shared keyed store of
        # per-tenant resident encode state, the encode-layer sibling of
        # the service's CarryCache — bounded, with eviction only ever
        # costing a cold re-encode.
        self.encode_residency = bool(encode_residency)
        self.encode_cache: Optional[EncodeCache] = EncodeCache(
            max_bytes=encode_bytes, max_entries=encode_entries,
            recorder=self._rec) if self.encode_residency else None
        self.rollup = FleetSloRollup(
            availability_floor, recorder=self._rec,
            clock=self._rec.now)
        # One shared WAL for the whole fleet (docs/DURABILITY.md):
        # every tenant journals through a tenant-tagged view of it,
        # and fleet-tier membership events land untagged — recovery
        # groups records back per tenant.
        self._journal = journal

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        """Start the shared plan service (own-service mode only; a
        caller-supplied service is the caller's lifecycle)."""
        if self._own_service:
            await self.service.start()

    async def stop(self) -> None:
        """Stop every tenant loop, then the shared service (in that
        order: a stopping controller may still await one last plan).

        A tenant engine that died with an exception must not abort the
        wind-down partway (stranding its neighbors' tasks and leaking
        the service's dispatcher/executor): every loop is stopped and
        the service closed first, then the FIRST tenant failure is
        re-raised so the crash still surfaces to the caller."""
        for loop in self._tenants.values():
            loop.controller.stop_soon()
        first_error: Optional[BaseException] = None
        first_key: Optional[str] = None
        for loop in self._tenants.values():
            try:
                await loop.controller.stop()
            except (Exception, asyncio.CancelledError) as exc:
                # CancelledError included: a supervisor that cancelled
                # one engine task must not abort THIS wind-down partway
                # (CancelledError is a BaseException on 3.8+).
                if first_error is None:
                    first_error, first_key = exc, loop.key
        if self._own_service:
            await self.service.stop()
        self.publish_rollup()
        if first_error is not None:
            raise RuntimeError(
                f"tenant {first_key!r} controller died during the "
                f"run") from first_error

    # -- tenants -----------------------------------------------------------

    def add_tenant(
        self,
        key: str,
        model: PartitionModel,
        initial_map: PartitionMap,
        assign_partitions: Callable[..., object],
        *,
        plan_options: Optional[PlanOptions] = None,
        orchestrator_options: Optional[OrchestratorOptions] = None,
        move_observers: tuple = (),
        kick: bool = False,
    ) -> RebalanceController:
        """Onboard one tenant: spawn its controller task on the running
        loop, wire its ServicePlanner + SLO tracker, register it with
        the rollup.  ``kick=True`` submits an empty delta so an
        onboarding tenant (empty placements) converges to a full map
        immediately — the staggered-onboarding entry point."""
        if key in self._tenants:
            raise ValueError(f"tenant {key!r} already registered")
        effective_opts = (plan_options if plan_options is not None
                          else self.plan_options)
        if effective_opts is not None and (
                effective_opts.node_score_booster is not None
                or effective_opts.node_scorer is not None
                or effective_opts.node_sorter is not None):
            # Surface the misconfiguration HERE, where the caller can
            # handle it — inside the engine task it would kill the
            # tenant's loop silently (quiesce still returns, with a
            # stale map) and only resurface at stop().
            raise ValueError(
                f"tenant {key!r}: the fleet plan service runs the dense "
                f"batch solver, which does not support node_score_"
                f"booster/node_scorer/node_sorter hooks — run this "
                f"tenant on a standalone RebalanceController instead")
        top = min((st.priority for st in model.values()), default=0)
        slo = SloTracker(
            initial_map,
            primary_states=[s for s, st in model.items()
                            if st.priority == top],
            clock=self._rec.now, recorder=self._rec,
            track_timeline=True,
            availability_floor=self.availability_floor,
            publish_gauges=False)
        planner = ServicePlanner(
            key, self.service, recorder=self._rec,
            encode_cache=self.encode_cache,
            encode_residency=self.encode_residency)
        if self._journal is not None:
            self._journal.append(
                "fleet", {"event": "add_tenant", "tenant": key},
                t=self._rec.now())
        controller = RebalanceController(
            model, list(self.nodes_all), initial_map, assign_partitions,
            plan_options=(plan_options if plan_options is not None
                          else self.plan_options),
            orchestrator_options=(orchestrator_options
                                  if orchestrator_options is not None
                                  else self.orch_opts),
            backend="greedy",  # degradation-path fallback only
            device=self.device, planner=planner,
            debounce_s=self.debounce_s,
            max_passes_per_cycle=self.max_passes_per_cycle,
            slo=slo, move_observers=move_observers,
            journal=(self._journal.for_tenant(key)
                     if self._journal is not None else None))
        self._tenants[key] = TenantLoop(key, controller, planner, slo)
        self.rollup.register(key, slo)
        controller.start()
        if kick:
            controller.submit(ClusterDelta())
        self.publish_rollup()
        return controller

    def resume_tenant(
        self,
        state: "RecoveredState",
        key: str,
        model: PartitionModel,
        assign_partitions: Callable[..., object],
        *,
        plan_options: Optional[PlanOptions] = None,
        orchestrator_options: Optional[OrchestratorOptions] = None,
        move_observers: tuple = (),
        kick: bool = True,
    ) -> RebalanceController:
        """Re-onboard one tenant from a crashed fleet's recovered
        journal state (docs/DURABILITY.md): same service/planner wiring
        as :meth:`add_tenant`, but the map, membership residue, breaker
        state and SLO horizon come from the journal fold.  The tenant's
        carry/encode residency was never persisted, so its first plan
        is a counted cold solve (``durability.recovery_cold_solves``)
        — inside the fleet tier's demotion attribution bound."""
        from .durability.recover import resume_controller

        if key in self._tenants:
            raise ValueError(f"tenant {key!r} already registered")
        planner = ServicePlanner(
            key, self.service, recorder=self._rec,
            encode_cache=self.encode_cache,
            encode_residency=self.encode_residency)
        controller = resume_controller(
            state, model, assign_partitions, tenant=key,
            plan_options=(plan_options if plan_options is not None
                          else self.plan_options),
            orchestrator_options=(orchestrator_options
                                  if orchestrator_options is not None
                                  else self.orch_opts),
            backend="greedy", planner=planner,
            debounce_s=self.debounce_s,
            max_passes_per_cycle=self.max_passes_per_cycle,
            move_observers=move_observers,
            publish_slo_gauges=False,
            availability_floor=self.availability_floor,
            start=True, kick=kick, device=self.device)
        slo = controller._slo
        assert slo is not None  # resume_controller always restores one
        self._tenants[key] = TenantLoop(key, controller, planner, slo)
        self.rollup.register(key, slo)
        self.publish_rollup()
        return controller

    def forget_tenant(self, key: str) -> None:
        """Drop a tenant's registration (the caller stops its
        controller); its carry-cache entry ages out via the LRU and
        its resident encode state is dropped outright."""
        if key in self._tenants and self._journal is not None:
            self._journal.append(
                "fleet", {"event": "forget_tenant", "tenant": key},
                t=self._rec.now())
        self._tenants.pop(key, None)
        if self.encode_cache is not None:
            self.encode_cache.drop(key)
        self.rollup.forget(key)
        self.publish_rollup()

    def tenant(self, key: str) -> TenantLoop:
        return self._tenants[key]

    def tenants(self) -> list[TenantLoop]:
        return list(self._tenants.values())

    def keys(self) -> list[str]:
        return list(self._tenants)

    # -- delta fan-out -----------------------------------------------------

    def submit(self, key: str, delta: ClusterDelta) -> None:
        """One tenant's delta (weight drift, tenant-local churn)."""
        self._tenants[key].controller.submit(delta)

    def submit_all(self, delta: ClusterDelta) -> None:
        """Fan one cluster-wide membership delta to EVERY tenant loop —
        a correlated zone outage is one event, N coalesced converge
        cycles, a handful of fleet dispatches."""
        for loop in self._tenants.values():
            loop.controller.submit(delta)

    # -- rendezvous & scorecard --------------------------------------------

    async def quiesce_all(self) -> dict[str, PartitionMap]:
        """Wait until every tenant loop is idle; returns each tenant's
        current map (registration order — deterministic under the
        DeterministicLoop)."""
        out: dict[str, PartitionMap] = {}
        for key, loop in self._tenants.items():
            out[key] = await loop.controller.quiesce()
        self.publish_rollup()
        return out

    def publish_rollup(self) -> None:
        """Refresh the fleet-wide gauges (collector-compatible: hand
        this to a ``MetricsServer(collectors=...)``)."""
        self._rec.set_gauge(
            "fleet.converge_cycles",
            float(sum(loop.controller.cycles
                      for loop in self._tenants.values())))
        self.rollup.publish()

    def summary(self) -> FleetSloSummary:
        """The fleet scorecard (per-tenant summaries included)."""
        return self.rollup.summary()

    def host_phases(self) -> dict[str, float]:
        """Cumulative HOST wall-clock seconds per converge-cycle phase
        across every tenant loop: ``encode``/``decode`` from the
        planners, ``device`` from the service's solve worker.  This is
        perf_counter time (not the virtual clock), so it is NOT part of
        the replayable account — it is the bench phase-split source
        that makes the host-encode share visible (docs/FLEET.md)."""
        out = {"encode": 0.0, "decode": 0.0,
               "device": float(self.service.host_solve_s)}
        for loop in self._tenants.values():
            out["encode"] += loop.planner.host_phase["encode"]
            out["decode"] += loop.planner.host_phase["decode"]
        return out

    @property
    def cycles(self) -> int:
        return sum(t.controller.cycles for t in self._tenants.values())

    @property
    def passes(self) -> int:
        return sum(t.controller.passes for t in self._tenants.values())

    @property
    def superseded(self) -> int:
        return sum(t.controller.superseded
                   for t in self._tenants.values())

    @property
    def unconverged_cycles(self) -> int:
        return sum(t.controller.unconverged_cycles
                   for t in self._tenants.values())
