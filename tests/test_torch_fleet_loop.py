"""The port's fleet of control loops against the reference's, on the CPU.

``FleetController`` runs one ``RebalanceController`` per tenant, all
planning through ``ServicePlanner`` -> one shared ``PlanService`` ->
``solve_fleet``, with each tenant's encode kept resident
(``EncodeCache`` / ``build_encoded_state``).  Three kinds of check:

- the reference's own cases of ``tests/test_fleet_loop.py`` and
  ``tests/test_encode_resident.py`` run again with their module names
  bound to the port's (the exposition registry, the ``DeterministicLoop``
  and the fleet simulator ``testing/fleetsim.py`` included), on the CPU;
  the seven-day fleet week stays with ``tests/test_torch_harness.py``;
- the same fleet, the same deltas, through both packages, each on its
  own package's ``DeterministicLoop``: equal final maps, op logs and
  ``fleet.*`` / ``plan.solve.*`` counters;
- ``build_encoded_state`` gives the reference's resident arrays.
"""

import asyncio
import importlib

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference package imports it

import blance_tpu  # noqa: E402
import blance_tpu.core.types as j_types  # noqa: E402
import blance_tpu.fleetloop as jfleetloop  # noqa: E402
import blance_tpu.obs as jobs  # noqa: E402
import blance_tpu.plan.service as j_service  # noqa: E402
from blance_tpu.core.encode import encode_problem as j_encode  # noqa: E402
from blance_tpu.plan.resident import build_encoded_state as j_build  # noqa: E402
from blance_tpu.rebalance import ClusterDelta as JDelta  # noqa: E402
import blance_tpu.testing.sched as jsched  # noqa: E402

import blance_tpu_torch as bt  # noqa: E402
import blance_tpu_torch.fleetloop as tfleetloop  # noqa: E402
import blance_tpu_torch.obs as tobs  # noqa: E402
from blance_tpu_torch.core import encode as t_encode  # noqa: E402
from blance_tpu_torch.obs import slo as t_slo  # noqa: E402
from blance_tpu_torch.plan import carry as t_carry  # noqa: E402
from blance_tpu_torch.plan import fleet as t_fleet  # noqa: E402
from blance_tpu_torch.plan import service as t_service  # noqa: E402
from blance_tpu_torch.plan import tensor as t_tensor  # noqa: E402
from blance_tpu_torch.plan.resident import build_encoded_state  # noqa: E402
from blance_tpu_torch.testing import fleetsim as t_fleetsim  # noqa: E402
from blance_tpu_torch.testing import scenarios as t_scenarios  # noqa: E402
from blance_tpu_torch.testing import sched as tsched  # noqa: E402

import test_encode_resident as ref_resident  # noqa: E402
import test_fleet_loop as ref_loop  # noqa: E402
from test_torch_durability import call_with_fixtures, rebind  # noqa: E402
from _port_telemetry import SOLVER, port_names, ref_view  # noqa: E402

# The module, not the package's ``rebalance`` function of the same name.
t_rebalance = importlib.import_module("blance_tpu_torch.rebalance")


class CpuPlanService(t_service.PlanService):
    def __init__(self, *args, device="cpu", **kw):
        super().__init__(*args, device=device, **kw)


class CpuFleetController(tfleetloop.FleetController):
    def __init__(self, *args, device="cpu", **kw):
        super().__init__(*args, device=device, **kw)


class CpuRebalanceController(t_rebalance.RebalanceController):
    def __init__(self, *args, device="cpu", **kw):
        super().__init__(*args, device=device, **kw)


def cpu_solve_fleet(problems, **kw):
    return t_fleet.solve_fleet(problems, device="cpu", **kw)


def cpu_run_fleet_scenario(scn, *args, **kw):
    return t_fleetsim.run_fleet_scenario(scn, *args, device="cpu", **kw)


M = bt.model(primary=(0, 1), replica=(1, 1))

COMMON = {
    "M": M, "model": bt.model, "Partition": bt.Partition,
    "PlanOptions": bt.PlanOptions,
    "FleetController": CpuFleetController,
    "ServicePlanner": tfleetloop.ServicePlanner,
    "PlanService": CpuPlanService,
    "RebalanceController": CpuRebalanceController,
    "ClusterDelta": t_rebalance.ClusterDelta,
    "Recorder": tobs.Recorder, "use_recorder": tobs.use_recorder,
    "CarryCache": t_carry.CarryCache, "EncodeCache": t_carry.EncodeCache,
    "TenantProblem": t_fleet.TenantProblem, "solve_fleet": cpu_solve_fleet,
    "FleetSloRollup": t_slo.FleetSloRollup, "SloTracker": t_slo.SloTracker,
    "default_registry": tobs.default_registry,
    "DeterministicLoop": tsched.DeterministicLoop,
    "FifoPolicy": tsched.FifoPolicy,
    "run_fleet_scenario": cpu_run_fleet_scenario,
    "fleet_noisy_neighbor": t_scenarios.fleet_noisy_neighbor,
    "fleet_onboarding": t_scenarios.fleet_onboarding,
    "fleet_week": t_scenarios.fleet_week,
    "fleet_zone_outage": t_scenarios.fleet_zone_outage,
}
LOOP = rebind(ref_loop, COMMON)
RESIDENT = rebind(ref_resident, dict(
    COMMON, HierarchyRule=bt.HierarchyRule,
    encode_problem=t_encode.encode_problem,
    pack_slot_rows=t_encode.pack_slot_rows,
    strip_prev_rows=t_encode.strip_prev_rows,
    _strip_nodes=t_rebalance._strip_nodes))


def _port_carry_for(cache, key, n=64):
    """The reference helper's carry, as the port's tensors (a port
    carry lives on its solve's device)."""
    used = torch.zeros((2, n))
    carry = t_tensor.SolveCarry(prices=used.sum(0),
                                assign=torch.zeros((4, 2, 1),
                                                   dtype=torch.int32),
                                used=used)
    cache.store(key, carry, np.zeros((4, 2, 1), np.int32))
    return carry


LOOP["_carry_for"] = _port_carry_for

# Every case but the slow-marked fleet week.
LOOP_CASES = [
    "test_fleet_scenario_bit_identical_across_runs",
    "test_committed_fleet_trace_replays_exactly",
    "test_tenant_scale_matrix",
    "test_coalesced_equals_sequential_at_fewer_dispatches",
    "test_onboarding_family_converges_from_empty",
    "test_noisy_neighbor_family_keeps_neighbors_serving",
    "test_shared_cache_eviction_under_fleet_only_costs_cold",
    "test_service_fair_share_defers_chatty_tenant",
    "test_service_fair_share_validation",
    "test_service_planner_warm_protocol_and_invalidation",
    "test_planner_rejects_scoring_hooks",
    "test_add_tenant_rejects_scoring_hooks_at_registration",
    "test_stop_survives_a_dead_tenant_loop",
    "test_session_and_planner_are_mutually_exclusive",
    "test_fleet_rollup_math_and_gauges",
    "test_fleet_loop_emits_only_declared_metrics",
    "test_carry_cache_eviction_stats_and_labeled_counter",
]
RESIDENT_CASES = [
    "test_strip_prev_rows_matches_strip_then_reencode",
    "test_pack_slot_rows_matches_decode_pack",
    "test_fuzz_delta_families_patch_equals_reencode",
    "test_fuzz_with_hierarchy_and_node_adds",
    "test_incremental_decode_warnings_bit_identical",
    "test_divergence_statics_shape_and_eviction_each_demote_cold",
    "test_shape_drift_demotes",
    "test_passthrough_states_stay_on_full_path",
    "test_encode_cache_lru_budgets_and_counters",
    "test_supersede_divergence_demotes_and_recovers",
]


def _expand(module, names):
    """One pytest param per case, parametrized cases expanded."""
    out = []
    for name in names:
        fn = getattr(module, name)
        marks = [m for m in getattr(fn, "pytestmark", [])
                 if m.name == "parametrize"]
        if not marks:
            out.append(pytest.param(name, {}, id=name))
            continue
        argnames, values = marks[0].args[:2]
        argnames = [a.strip() for a in argnames.split(",")]
        for vals in values:
            vals = tuple(vals) if len(argnames) > 1 else (vals,)
            out.append(pytest.param(
                name, dict(zip(argnames, vals)),
                id=f"{name}[{'-'.join(map(str, vals))}]"))
    return out


@pytest.fixture
def port_locals(monkeypatch):
    """Names some reference cases import inside their bodies resolve to
    the port's for the test's duration."""
    monkeypatch.setattr(j_types, "PlanOptions", bt.PlanOptions)
    monkeypatch.setattr(j_service, "PlanServiceClosed",
                        t_service.PlanServiceClosed)



def _call(fn, request, params):
    if params:
        fn(**params)
    else:
        call_with_fixtures(fn, request)


@pytest.mark.parametrize("case,params", _expand(ref_loop, LOOP_CASES))
def test_reference_fleet_loop_case_on_port(case, params, request,
                                           port_locals):
    _call(LOOP[case], request, params)


@pytest.mark.parametrize("case,params",
                         _expand(ref_resident, RESIDENT_CASES))
def test_reference_resident_case_on_port(case, params, request,
                                         port_locals):
    _call(RESIDENT[case], request, params)


# -- one fleet through both packages ------------------------------------------

NODES = [f"n{i:02d}" for i in range(16)]
ZONE_A = tuple(NODES[:4])  # the outage: every node of rack r0


def _tenant_map(lib, k):
    """Tenant k: 12-20 partitions over the 16 nodes, a replica that may
    share the primary's rack (the outage's planning pressure)."""
    pmap = {}
    for i in range(12 + (k * 3) % 9):
        p = f"t{k}p{i:02d}"
        pmap[p] = lib.Partition(p, {
            "primary": [NODES[(i + k) % 16]],
            "replica": [NODES[(i + k + 1 + i % 5) % 16]]})
    return pmap


def _nbs(pmap):
    return {k: {s: list(ns) for s, ns in p.nodes_by_state.items()}
            for k, p in pmap.items()}


def _fleet_run(lib, obs, fleet, delta, sched, kw, tenants=8):
    """8 tenants, one zone-outage delta for all of them, then a weight
    delta for one tenant, on ``sched``'s loop: final maps, op log, fleet
    counters."""
    m = lib.model(primary=(0, 1), replica=(1, 1))
    log = []
    loop = sched.DeterministicLoop(sched.FifoPolicy(), max_steps=2_000_000)
    rec = obs.Recorder(clock=loop.time)

    async def drive():
        async def assign(stop_ch, node, partitions, states, ops):
            log.append((node, tuple(partitions), tuple(states),
                        tuple(ops)))
            await asyncio.sleep(0.01)

        fc = fleet.FleetController(NODES, inline_solve=True,
                                   admission_window_s=0.05, debounce_s=0.1,
                                   recorder=rec, **kw)
        await fc.start()
        for k in range(tenants):
            fc.add_tenant(f"tenant{k}", m, _tenant_map(lib, k), assign)
        fc.submit_all(delta(fail=ZONE_A))
        await fc.quiesce_all()
        fc.submit("tenant3", delta(partition_weights={"t3p01": 3}))
        maps = await fc.quiesce_all()
        summary = fc.summary()
        await fc.stop()
        return {k: _nbs(v) for k, v in maps.items()}, summary

    with obs.use_recorder(rec):
        maps, summary = loop.run_until_complete(drive())
    counters = {k: v for k, v in rec.counters.items()
                if k.startswith(("fleet.", "plan.solve."))}
    return maps, log, counters, summary


@pytest.fixture(scope="module")
def both_fleets():
    ref = _fleet_run(blance_tpu, jobs, jfleetloop, JDelta, jsched, {})
    port = _fleet_run(bt, tobs, tfleetloop, t_rebalance.ClusterDelta,
                      tsched, {"device": "cpu"})
    return ref, port


def test_fleet_controller_maps_and_ops_equal_reference(both_fleets):
    (rmaps, rlog, _rc, rsum), (pmaps, plog, _pc, psum) = both_fleets
    assert pmaps == rmaps
    assert plog == rlog and rlog
    assert psum.availability_min == rsum.availability_min == 1.0
    for m in pmaps.values():
        for nbs in m.values():
            assert not set(ZONE_A) & {n for ns in nbs.values() for n in ns}
            assert len(nbs["primary"]) == 1 and len(nbs["replica"]) == 1


def test_fleet_controller_counters_equal_reference(both_fleets):
    (_rm, _rl, rcount, _rs), (_pm, _pl, pcount, _ps) = both_fleets
    assert ref_view(pcount) == rcount
    assert port_names(pcount) == SOLVER
    # Coalescing engaged: fewer batches than plan requests, and the
    # resident encode and the warm carry both ran.
    assert pcount["fleet.batches"] < pcount["fleet.requests"]
    assert pcount.get("fleet.encode_warm", 0) > 0


def test_build_encoded_state_matches_reference():
    for k in (0, 5):
        ref_map, port_map = _tenant_map(blance_tpu, k), _tenant_map(bt, k)
        removes = [NODES[1]]
        jm = blance_tpu.model(primary=(0, 1), replica=(1, 1))
        jp = j_encode(ref_map, ref_map, NODES, removes, jm,
                      j_types.PlanOptions())
        tp = t_encode.encode_problem(port_map, port_map, NODES, removes, M,
                                     bt.PlanOptions())
        js = j_build(jp, ref_map, removes, jm, j_types.PlanOptions())
        ts = build_encoded_state(tp, port_map, removes, M, bt.PlanOptions())
        for f in ("prev", "partition_weights", "node_weights", "valid_node",
                  "stickiness", "gids", "gid_valid", "constraints"):
            a, b = getattr(ts.problem, f), getattr(js.problem, f)
            assert np.asarray(a).dtype == np.asarray(b).dtype, f
            assert np.array_equal(a, b), f
        assert ts.nbytes() == js.nbytes()
        assert ts.problem.nodes == js.problem.nodes
        assert ts.problem.partitions == js.problem.partitions


def test_fleet_controller_asks_for_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    async def build():
        return tfleetloop.FleetController(NODES)

    with pytest.raises(RuntimeError, match="is_available"):
        asyncio.run(build())


def test_service_planner_dirty_protocol_equals_reference():
    """The planner's warm-or-cold decision (``_dirty_for``) on the same
    cycle sequence in both packages: equal masks, equal maps."""
    out = {}
    for name, lib, obs, fleet, sched, kw in (
            ("ref", blance_tpu, jobs, jfleetloop, jsched, {}),
            ("port", bt, tobs, tfleetloop, tsched, {"device": "cpu"})):
        m = lib.model(primary=(0, 1), replica=(1, 1))
        loop = sched.DeterministicLoop(sched.FifoPolicy(),
                                       max_steps=500_000)
        rec = obs.Recorder(clock=loop.time)
        svc_cls = j_service.PlanService if name == "ref" \
            else t_service.PlanService

        async def drive():
            svc = svc_cls(admission_window_s=0.0, inline_solve=True,
                          recorder=rec, batch_floor=16, **kw)
            await svc.start()
            planner = fleet.ServicePlanner("t0", svc, recorder=rec)
            opts = lib.PlanOptions()
            cur = _tenant_map(lib, 2)
            maps = []
            for removes in ([], ["n03"], ["n03", "n07"], ["n07"]):
                cur, _w = await planner.plan_cycle(cur, NODES, removes, m,
                                                   opts)
                maps.append(_nbs(cur))
            await svc.stop()
            return maps

        with obs.use_recorder(rec):
            maps = loop.run_until_complete(drive())
        out[name] = (maps, {k: v for k, v in rec.counters.items()
                            if k.startswith(("fleet.", "plan.solve."))})
    assert out["port"][0] == out["ref"][0]
    assert ref_view(out["port"][1]) == out["ref"][1]
    assert port_names(out["port"][1]) == SOLVER
    assert out["port"][1].get("plan.solve.carry_hit", 0) > 0
