"""The port's mesh paths against the JAX package, on the CPU: the sharded
plan pipeline, PlannerSession(mesh=), solve_fleet(mesh=) and
PlanService(mesh=), and the 12 sharded shape contracts.

The reference runs each path on meshes of the 8 virtual CPU devices
(tests/conftest.py); the port runs it on ``make_mesh(..., device="cpu")``
worker processes over gloo.  Assignments, move arrays, carry tables,
warm decisions and the ``plan.solve.*`` counters must be equal exactly
(whole-number weights throughout, node weights 1).  The fixtures are the
reference's own (tests/test_pipeline.py, tests/test_warm_replan.py,
tests/test_fleet.py), at the mesh sizes of one 4-rank mesh, which
serves the module; the smaller meshes run on its first ranks (the shape contracts take the audit's own
2-rank mesh).  FleetController(mesh=) is held against the unmeshed
controller.
"""

import asyncio

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import blance_tpu  # noqa: E402
import blance_tpu.obs as jobs  # noqa: E402
import blance_tpu_torch as bt  # noqa: E402
import blance_tpu_torch.obs as tobs  # noqa: E402
from blance_tpu.parallel import sharded as jsh  # noqa: E402
from blance_tpu.plan import fleet as jfleet  # noqa: E402
from blance_tpu.plan import tensor as jtensor  # noqa: E402
from blance_tpu.plan.service import PlanService as JService  # noqa: E402
from blance_tpu_torch.analysis import shape_audit  # noqa: E402
from blance_tpu_torch.parallel import sharded as tsh  # noqa: E402
from blance_tpu_torch.plan import fleet as tfleet  # noqa: E402
from blance_tpu_torch.plan import tensor as ttensor  # noqa: E402
from blance_tpu_torch.plan.service import PlanService  # noqa: E402
from test_fleet import delta_tenant, make_tenant  # noqa: E402
from test_pipeline import _dense  # noqa: E402
from test_torch_fleet import _port  # noqa: E402

NODES = [f"n{i}" for i in range(8)]
PARTS = [str(i) for i in range(64)]


@pytest.fixture(scope="module")
def pool():
    mesh = tsh.make_mesh(4, device="cpu", timeout=60)
    yield mesh
    mesh.close()


def _jmesh(shape):
    return jsh.make_mesh(shape[0]) if len(shape) == 1 else \
        jsh.make_mesh_2d(*shape)


def _tmesh(shape, pool):
    return tsh.make_mesh(shape[0], devices=pool) if len(shape) == 1 else \
        tsh.make_mesh_2d(*shape, devices=pool)


# --- the sharded pipeline -----------------------------------------------------


@pytest.mark.parametrize("shape", [(4,), (2, 2)], ids=["4", "2x2"])
def test_pipeline_sharded_cold_bitwise(pool, shape):
    args = _dense(64, 8, seed=25, invalid=1)
    w_assign, w_carry, w_diff = jsh.solve_pipeline_sharded(
        _jmesh(shape), *args[:7], args[7], args[8])
    with _tmesh(shape, pool) as mesh:
        g_assign, g_carry, g_diff = tsh.solve_pipeline_sharded(
            mesh, *args[:7], args[7], args[8])
        staged = tsh.solve_dense_sharded(mesh, *args[:7], args[7], args[8])
    assert np.array_equal(g_assign, w_assign)
    assert np.array_equal(g_assign, staged)
    assert all(np.array_equal(a, np.asarray(b))
               for a, b in zip(g_diff, w_diff))
    assert np.array_equal(g_carry.used.numpy(), np.asarray(w_carry.used))
    assert np.array_equal(g_carry.prices.numpy(),
                          np.asarray(w_carry.prices))


@pytest.mark.parametrize("delta", ["fixpoint", "remove"])
def test_pipeline_sharded_warm_bitwise(pool, delta):
    """The warm pipeline from a converged carry: a fixpoint repair (the
    reference's test) and a real removal, accept or decline equal.  The
    base map is the port's cold solve (bitwise the reference's above)."""
    args = _dense(64, 8, seed=27)
    with tsh.make_mesh(4, devices=pool) as mesh:
        b_assign = tsh.solve_dense_sharded(mesh, *args[:7], args[7],
                                           args[8])
    b_carry = jtensor.carry_from_assignment(
        b_assign, jnp.asarray(args[1]), jnp.asarray(args[2]))
    valid = args[3].copy()
    dirty = np.zeros(64, bool)
    if delta == "fixpoint":
        dirty[:4] = True
    else:
        victim = int(b_assign[0, 0, 0])
        valid[victim] = False
        dirty = (b_assign == victim).any(axis=(1, 2))
    want = jsh.solve_pipeline_sharded(
        jsh.make_mesh(4), b_assign, args[1], args[2], valid, *args[4:7],
        args[7], args[8], dirty=dirty, carry=b_carry, warm_only=True)
    carry = ttensor.carry_from_assignment(
        b_assign, torch.from_numpy(args[1]), torch.from_numpy(args[2]))
    with tsh.make_mesh(4, devices=pool) as mesh:
        got = tsh.solve_pipeline_sharded(
            mesh, b_assign, args[1], args[2], valid, *args[4:7], args[7],
            args[8], dirty=dirty, carry=carry, warm_only=True)
    assert (got is None) == (want is None)
    if want is not None:
        assert np.array_equal(got[0], want[0])
        assert all(np.array_equal(a, np.asarray(b))
                   for a, b in zip(got[2], want[2]))
        assert np.array_equal(got[1].used.numpy(), np.asarray(want[1].used))
    if delta == "fixpoint":
        assert got is not None and np.array_equal(got[0], b_assign)
        assert (got[2][2] < 0).all()


# --- PlannerSession(mesh=) ----------------------------------------------------


def _counters(rec, prefix="plan.solve."):
    return {k: v for k, v in rec.counters.items() if k.startswith(prefix)}


def test_session_on_mesh_full_loop_matches_reference(pool):
    """The steady loop (plan -> apply -> remove -> replan) through the
    sharded solver: each proposal and the plan.solve.* counters equal the
    reference's session on the same mesh size."""
    jm = blance_tpu.model(primary=(0, 1), replica=(1, 1))
    tm = bt.model(primary=(0, 1), replica=(1, 1))
    jrec, trec = jobs.Recorder(), tobs.Recorder()
    # The second replan is the warm carry path in both packages.
    with jobs.use_recorder(jrec):
        js = blance_tpu.PlannerSession(jm, NODES, PARTS,
                                       mesh=jsh.make_mesh(4))
        ja1 = js.replan().copy()
        js.apply()
        js.remove_nodes(["n0"])
        ja2 = js.replan().copy()
    with tobs.use_recorder(trec), tsh.make_mesh(4, devices=pool) as mesh:
        ts = bt.PlannerSession(tm, NODES, PARTS, mesh=mesh)
        ta1 = ts.replan().copy()
        ts.apply()
        ts.remove_nodes(["n0"])
        ta2 = ts.replan().copy()
        nmap, warn = ts.to_map("proposed")
    assert np.array_equal(ta1, ja1) and np.array_equal(ta2, ja2)
    assert not (ta2 == 0).any()
    assert not warn
    assert _counters(trec) == _counters(jrec)
    assert trec.counters.get("plan.solve.carry_hit") == 1


def test_warm_replan_on_mesh_matches_cold(pool):
    """The sharded warm carry: the warm mesh replan is a carry hit and
    equals a cold twin session on the same mesh (the full loop above
    holds the warm replan against the reference's)."""
    tm = bt.model(primary=(0, 1), replica=(1, 1))
    rec = tobs.Recorder()
    with tobs.use_recorder(rec), tsh.make_mesh(4, devices=pool) as mesh:
        s = bt.PlannerSession(tm, NODES, PARTS, mesh=mesh)
        s.replan()
        s.apply()
        twin = bt.PlannerSession(tm, NODES, PARTS, mesh=mesh)
        twin.load_map(s.to_map()[0])
        s.remove_nodes(["n3"])
        twin.remove_nodes(["n3"])
        warm = s.replan().copy()
        assert rec.counters.get("plan.solve.carry_hit", 0) == 1
        cold = twin.replan()
    assert np.array_equal(warm, cold)
    assert rec.counters.get("plan.solve.warm_fallback", 0) == 0


@pytest.mark.parametrize("shape", [(2, 2)], ids=["2x2"])
def test_session_fast_path_sharded(pool, shape):
    """replan_with_moves() on a mesh equals replan() + moves(), cold and
    after a removal (the warm pipeline), and the reference's proposals."""
    from test_pipeline import _fresh_sessions, _mk_map, _rack_opts

    prev_map, nodes = _mk_map(64, 8, seed=19)
    parts = [str(i) for i in range(64)]
    tm = bt.model(primary=(0, 1), replica=(1, 1))
    with _tmesh(shape, pool) as mesh:
        s1, s2 = (bt.PlannerSession(
            tm, nodes, parts, mesh=mesh,
            opts=bt.PlanOptions(
                node_hierarchy=_rack_opts(nodes).node_hierarchy,
                hierarchy_rules={"replica": [bt.HierarchyRule(2, 1)]}))
            for _ in range(2))
        tmap = {k: bt.Partition(k, dict(v.nodes_by_state))
                for k, v in prev_map.items()}
        s1.load_map(tmap)
        s2.load_map(tmap)
        outs = []
        for step in range(2):
            a1 = s1.replan()
            mv1 = s1.moves()
            a2, mv2 = s2.replan_with_moves()
            assert np.array_equal(a1, a2)
            assert all(np.array_equal(x, y) for x, y in zip(mv1, mv2))
            outs.append(a2.copy())
            s1.apply()
            s2.apply()
            s1.remove_nodes([nodes[1]])
            s2.remove_nodes([nodes[1]])
    j1, j2, _ = _fresh_sessions(64, 8, seed=19, mesh=_jmesh(shape))
    ja, _ = j2.replan_with_moves()
    assert np.array_equal(outs[0], ja)
    j2.apply()
    j2.remove_nodes([nodes[1]])
    jb, _ = j2.replan_with_moves()
    assert np.array_equal(outs[1], jb)


# --- solve_fleet(mesh=) and PlanService(mesh=) --------------------------------


@pytest.fixture(scope="module")
def fleet_rounds(pool):
    tenants = [make_tenant(17 + (i % 4), 8, seed=i, weights=i % 3 == 0)
               for i in range(12)]
    jmesh = jsh.make_mesh()
    ref1 = jfleet.solve_fleet(tenants, mesh=jmesh)
    ref2_in = [delta_tenant(t, r, victim_rank=i)[0]
               for i, (t, r) in enumerate(zip(tenants, ref1))]
    ref2 = jfleet.solve_fleet(ref2_in, mesh=jmesh)
    with tsh.make_mesh(4, devices=pool) as mesh:
        got1 = tfleet.solve_fleet([_port(t) for t in tenants], mesh=mesh)
        got2_in = [_port(t2, carry=g.carry) for t2, g in zip(ref2_in, got1)]
        got2 = tfleet.solve_fleet(got2_in, mesh=mesh)
    flat1 = tfleet.solve_fleet([_port(t) for t in tenants], device="cpu")
    flat2 = tfleet.solve_fleet(
        [_port(t2, carry=g.carry) for t2, g in zip(ref2_in, flat1)],
        device="cpu")
    return dict(tenants=tenants, ref=(ref1, ref2), got=(got1, got2),
                flat=(flat1, flat2))


@pytest.mark.parametrize("rnd", [0, 1], ids=["cold", "warm"])
def test_fleet_on_mesh_bitwise(fleet_rounds, rnd):
    ref, got, flat = (fleet_rounds[k][rnd] for k in ("ref", "got", "flat"))
    for r, g, f in zip(ref, got, flat):
        assert np.array_equal(g.assign, r.assign), g.key
        assert np.array_equal(g.assign, f.assign), g.key
        assert g.warm == r.warm == f.warm and g.sweeps == r.sweeps
        assert np.array_equal(g.carry.used.numpy(),
                              np.asarray(r.carry.used))
    if rnd:
        assert any(g.warm for g in got)


def test_fleet_mesh_pads_batch_to_mesh_divisibility(pool):
    """Three tenants on a 4-rank mesh: the batch pads to 4 (the last
    tenant replicated), and each result is its unmeshed solve's."""
    tenants = [_port(make_tenant(17, 8, seed=i)) for i in range(3)]
    rec = tobs.Recorder()
    with tsh.make_mesh(4, devices=pool) as mesh:
        got = tfleet.solve_fleet(tenants, mesh=mesh, recorder=rec)
        assert mesh.last_call["body"] == "fleet.cold"
        assert sorted(mesh.last_call["stats"]) == [0, 1, 2, 3]
    want = tfleet.solve_fleet(tenants, device="cpu")
    for g, w in zip(got, want):
        assert np.array_equal(g.assign, w.assign)
    occ = rec.histogram_summary("fleet.batch_occupancy")
    assert occ["max"] == 0.75


def test_plan_service_on_mesh_matches_reference(pool):
    tenants = [make_tenant(17 + (i % 4), 8, seed=i) for i in range(8)]

    async def drive(svc, items):
        await svc.start()
        try:
            return await asyncio.gather(*(svc.submit(t) for t in items))
        finally:
            await svc.stop()

    want = asyncio.run(drive(JService(mesh=jsh.make_mesh(4)), tenants))
    with tsh.make_mesh(4, devices=pool) as mesh:
        svc = PlanService(mesh=mesh)
        assert svc.device == mesh.device
        got = asyncio.run(drive(svc, [_port(t) for t in tenants]))
    for g, w in zip(got, want):
        assert g.key == w.key
        assert np.array_equal(g.assign, w.assign)


def test_fleet_controller_on_mesh_matches_unmeshed(pool):
    """FleetController(mesh=) passes the mesh to its PlanService: the
    zone-outage fleet of tests/test_torch_fleet_loop.py on a 2-rank mesh
    gives the unmeshed controller's maps, op log and counters."""
    from blance_tpu_torch import fleetloop as tfleetloop
    from blance_tpu_torch.rebalance import ClusterDelta
    from blance_tpu_torch.testing import sched as tsched
    from test_torch_fleet_loop import _fleet_run

    with tsh.make_mesh(2, devices=pool) as mesh:
        meshed = _fleet_run(bt, tobs, tfleetloop, ClusterDelta, tsched,
                            {"mesh": mesh}, tenants=4)
    flat = _fleet_run(bt, tobs, tfleetloop, ClusterDelta, tsched,
                      {"device": "cpu"}, tenants=4)
    assert meshed[0] == flat[0] and meshed[1] == flat[1] and flat[1]
    assert meshed[2] == flat[2]
    assert meshed[3].availability_min == 1.0


# --- the 12 sharded shape contracts -------------------------------------------

_SHARDED_CONTRACTS = [c for c in shape_audit.CONTRACTS
                      if "sharded" in c.entry]


@pytest.fixture(scope="module")
def audit_meshes():
    yield
    shape_audit.close_audit_meshes()


@pytest.mark.parametrize("contract", _SHARDED_CONTRACTS,
                         ids=lambda c: f"{c.entry}[{c.variant}]")
def test_sharded_shape_contract_on_cpu(audit_meshes, contract):
    """Each sharded contract's dispatch, through the runtime's layout
    tables on the audit's 2-rank CPU mesh, returns the reference's
    output tree (shapes and dtypes)."""
    from blance_tpu.analysis import shape_audit as ref

    twin, = [c for c in ref.CONTRACTS
             if (c.entry, c.variant) == (contract.entry, contract.variant)]
    assert contract.expect() == twin.expect()
    assert shape_audit._check_one(contract, torch.device("cpu")) == []


def test_twelve_sharded_contracts():
    assert len(_SHARDED_CONTRACTS) == 12
    assert {c.entry for c in _SHARDED_CONTRACTS} == {
        "solve_dense_sharded", "solve_sparse_sharded",
        "plan_pipeline_sharded"}
