"""The port's fleet tier against the reference's, on the CPU.

``solve_fleet`` batches tenants by bucket class and solves each class
over an explicit batch axis (the reference runs ``jax.vmap``).  Every
tenant's ``assign`` and ``sweeps`` must equal the reference's
``solve_fleet`` and the port's own single bucketed solve on the same
padded arrays, cold, warm and warm-declined; the ``fleet.*`` and
``plan.solve.*`` counters must equal the reference's.  The fixtures are
the reference's own (``tests/test_fleet.py`` ``make_tenant``: 12
tenants in two classes).  ``PlanService`` runs the port's solve behind
the reference's coalescing front door.
"""

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from blance_tpu.obs import Recorder as JRecorder  # noqa: E402
from blance_tpu.obs import use_recorder as j_use_recorder  # noqa: E402
from blance_tpu.plan import fleet as jfleet  # noqa: E402

from blance_tpu_torch.core.encode import (  # noqa: E402
    pad_problem_arrays,
    pad_to,
    stack_problem_arrays,
    strip_prev_rows,
)
from blance_tpu_torch.obs import Recorder, get_recorder, use_recorder  # noqa: E402
from blance_tpu_torch.plan import fleet as tfleet  # noqa: E402
from blance_tpu_torch.plan import tensor as T  # noqa: E402
from blance_tpu_torch.plan.carry import effective_dirty  # noqa: E402
from blance_tpu_torch.plan.service import (  # noqa: E402
    PlanService,
    PlanServiceClosed,
)

from test_fleet import delta_tenant, make_tenant  # noqa: E402

CPU = torch.device("cpu")


def _port(t, **kw):
    """The reference's TenantProblem as the port's (same host arrays)."""
    fields = {f.name: getattr(t, f.name)
              for f in dataclasses.fields(jfleet.TenantProblem)}
    fields.update(kw)
    return tfleet.TenantProblem(**fields)


def _tensors(arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _p_real(t):
    return torch.tensor(np.float32(t.prev.shape[0]))


def single_cold(t, fused_score="off"):
    """The port's single-problem bucketed solve on the tenant's
    class-padded arrays: (real-row assign, sweeps, padded used)."""
    k = tfleet.batch_class_of(t)
    arrs = pad_problem_arrays(
        t.prev, t.partition_weights, t.node_weights, t.valid_node,
        t.stickiness, t.gids, t.gid_valid, k.p, k.n)
    stats = {}
    out, carry = T.solve_dense_converged(
        *_tensors(arrs), t.constraints, t.rules, max_iterations=10,
        fused_score=fused_score, record=False, return_carry=True,
        stats=stats, p_real=_p_real(t))
    return out.numpy()[:t.prev.shape[0]], stats["sweeps"], carry.used


def single_warm(t):
    """The port's single solve_dense_warm on the class-padded arrays."""
    k = tfleet.batch_class_of(t)
    arrs = pad_problem_arrays(
        t.prev, t.partition_weights, t.node_weights, t.valid_node,
        t.stickiness, t.gids, t.gid_valid, k.p, k.n)
    cu = pad_to(np.asarray(t.carry.used, np.float32), 1, k.n, 0.0)
    dirty_p = pad_to(effective_dirty(t.dirty, t.prev, t.constraints), 0,
                     k.p, True)
    cu_t = torch.from_numpy(cu)
    out, carry = T.solve_dense_warm(
        *_tensors(arrs), t.constraints, t.rules, dirty=dirty_p,
        carry=T.SolveCarry(prices=cu_t.sum(0),
                           assign=torch.from_numpy(arrs[0]), used=cu_t),
        record=False, p_real=_p_real(t))
    return None if out is None else out[:t.prev.shape[0]]


@pytest.fixture(scope="module")
def rounds():
    """Round 1 (cold) and round 2 (one held node removed per tenant,
    warm) through both packages, each under its own recorder."""
    tenants = [make_tenant(17 + (i % 4), 8, seed=i, weights=i % 3 == 0)
               for i in range(12)]
    jrec, trec = JRecorder(), Recorder()
    with j_use_recorder(jrec):
        ref1 = jfleet.solve_fleet(tenants)
        ref2_in = [delta_tenant(t, r, victim_rank=i)[0]
                   for i, (t, r) in enumerate(zip(tenants, ref1))]
        ref2 = jfleet.solve_fleet(ref2_in)
    with use_recorder(trec):
        got1 = tfleet.solve_fleet([_port(t) for t in tenants], device=CPU)
        got2_in = [_port(t2, carry=g.carry)
                   for t2, g in zip(ref2_in, got1)]
        got2 = tfleet.solve_fleet(got2_in, device=CPU)
    return dict(tenants=tenants, ref1=ref1, got1=got1, ref2_in=ref2_in,
                ref2=ref2, got2_in=got2_in, got2=got2, jrec=jrec,
                trec=trec)


# -- cold ---------------------------------------------------------------------


def test_cold_batch_equals_reference_and_single_solve(rounds):
    classes = {tfleet.batch_class_of(_port(t)) for t in rounds["tenants"]}
    assert len(classes) == 2
    for t, r, g in zip(rounds["tenants"], rounds["ref1"], rounds["got1"]):
        assert np.array_equal(g.assign, r.assign), t.key
        assert g.sweeps == r.sweeps and not g.warm, t.key
        assign, sweeps, used = single_cold(t)
        assert np.array_equal(g.assign, assign), t.key
        assert g.sweeps == sweeps, t.key
        n = t.node_weights.shape[0]
        assert np.array_equal(g.carry.used.numpy(), used.numpy()[:, :n])
        assert np.array_equal(g.carry.used.numpy(),
                              np.asarray(r.carry.used)), t.key


def test_fleet_results_keep_input_order_and_keys(rounds):
    assert [g.key for g in rounds["got1"]] == \
        [t.key for t in rounds["tenants"]]
    assert [g.klass for g in rounds["got1"]] == \
        [tfleet.BatchClass(*r.klass) for r in rounds["ref1"]]


def test_fleet_results_are_not_batch_tensor_views(rounds):
    """Each result copies its slice off the [B, ...] batch tensors: a
    view would pin the whole batch while the carry cache accounts only
    the slice."""
    for g in rounds["got1"] + rounds["got2"]:
        assert g.assign.base is None
        for t in (g.carry.used, g.carry.assign, g.carry.prices):
            assert t._base is None
            assert t.untyped_storage().nbytes() == t.nbytes


# -- warm ---------------------------------------------------------------------


def test_warm_batch_accepted_and_bitwise(rounds):
    assert all(g.warm for g in rounds["got2"])
    for t2, r, g in zip(rounds["got2_in"], rounds["ref2"], rounds["got2"]):
        assert r.warm and g.sweeps == r.sweeps == 1, t2.key
        assert np.array_equal(g.assign, r.assign), t2.key
        want = single_warm(t2)
        assert want is not None, t2.key
        assert np.array_equal(g.assign, want), t2.key
        assert np.array_equal(g.carry.used.numpy(),
                              np.asarray(r.carry.used)), t2.key


def _under_marked(pkg_problem, t2):
    """The round-2 tenant with a lying (all-False) dirty mask: the
    removed node's holders must move, so a repair ripples."""
    return pkg_problem(t2, dirty=np.zeros(t2.prev.shape[0], bool))


def test_capacity_precheck_demotes(rounds):
    t2 = rounds["got2_in"][0]
    lying = _under_marked(_port, t2)
    rec = Recorder()
    with use_recorder(rec):
        g = tfleet.solve_fleet([lying], device=CPU)[0]
    assert not g.warm
    assert rec.counters.get("plan.solve.carry_miss", 0) == 1
    assert rec.counters.get("plan.solve.warm_fallback", 0) == 0
    assert np.array_equal(g.assign, single_cold(lying)[0])


def test_warm_decline_falls_back_to_cold_identically(rounds, monkeypatch):
    """With the host precheck bypassed, the batched repair's own flags
    decline the rippling tenant, which then solves cold: equal to the
    reference's decline and to the single cold solve, counters too."""
    j2, t2 = rounds["ref2_in"][0], rounds["got2_in"][0]
    monkeypatch.setattr(jfleet, "capacity_shrank", lambda *a, **k: False)
    monkeypatch.setattr(tfleet, "capacity_shrank", lambda *a, **k: False)
    jrec, trec = JRecorder(), Recorder()
    with j_use_recorder(jrec):
        r = jfleet.solve_fleet([dataclasses.replace(
            j2, dirty=np.zeros(j2.prev.shape[0], bool))])[0]
    with use_recorder(trec):
        g = tfleet.solve_fleet([_under_marked(_port, t2)], device=CPU)[0]
    assert not g.warm and not r.warm
    assert trec.counters.get("plan.solve.warm_fallback", 0) == 1
    assert np.array_equal(g.assign, r.assign)
    assert g.sweeps == r.sweeps
    assert np.array_equal(g.assign, single_cold(t2)[0])
    assert _solve_counters(trec) == _solve_counters(jrec)


# -- counters -----------------------------------------------------------------


def _solve_counters(rec):
    return {k: v for k, v in rec.counters.items()
            if k.startswith(("fleet.", "plan.solve."))}


def _hist(rec, name):
    return rec._hist_stats.get(name, (0,))[0]


def test_fleet_counters_equal_reference(rounds):
    jrec, trec = rounds["jrec"], rounds["trec"]
    assert _solve_counters(trec) == _solve_counters(jrec)
    assert _solve_counters(trec)["fleet.batches"] == 4
    for name in ("fleet.batch_tenants", "fleet.batch_occupancy",
                 "plan.solve.sweeps", "plan.solve.dirty_fraction"):
        assert trec._hist_stats[name] == jrec._hist_stats[name], name
    assert _hist(trec, "fleet.dispatch_s") == _hist(jrec, "fleet.dispatch_s")


def test_solve_fleet_record_false_emits_nothing(rounds):
    t = _port(make_tenant(18, 8, seed=97))
    toy = T.SolveCarry(prices=torch.zeros(5), assign=torch.zeros(
        (18, 2, 1), dtype=torch.int32), used=torch.zeros((2, 5)))
    rec = Recorder()
    with use_recorder(rec):
        r1 = tfleet.solve_fleet([t], record=False, device=CPU)[0]
        t2, _ = delta_tenant(t, r1)
        tfleet.solve_fleet([_port(t2)], record=False, device=CPU)
        tfleet.solve_fleet([dataclasses.replace(
            t, key="m", carry=toy, dirty=np.zeros(18, bool))],
            record=False, device=CPU)
    assert rec.counters == {}
    assert rec._hist_stats == {}


# -- shapes and degenerate tenants ---------------------------------------------


def test_degenerate_tenant_passes_through():
    t = _port(make_tenant(6, 4, 0))
    empty = dataclasses.replace(
        t, key="empty", prev=np.zeros((0, 2, 1), np.int32),
        partition_weights=np.zeros(0, np.float32),
        stickiness=np.zeros((0, 2), np.float32))
    res = tfleet.solve_fleet([empty, t], device=CPU)
    assert res[0].klass is None and res[0].assign.shape == (0, 2, 1)
    assert res[0].carry is None and res[0].sweeps == 0
    assert np.array_equal(res[1].assign, single_cold(t)[0])


def test_fleet_rejects_underdeep_slots():
    t = _port(make_tenant(8, 4, 0))
    with pytest.raises(ValueError, match="slot depth"):
        tfleet.solve_fleet([dataclasses.replace(
            t, key="bad", constraints=(2, 1))], device=CPU)


def test_boundary_straddling_tenants_solve_identically():
    """P 16 | 17 fall in buckets 16 | 18: different classes, each
    tenant still its single solve's and the reference's."""
    below, above = make_tenant(16, 8, 5), make_tenant(17, 8, 6)
    kb = tfleet.batch_class_of(_port(below))
    ka = tfleet.batch_class_of(_port(above))
    assert (kb.p, ka.p) == (16, 18)
    got = tfleet.solve_fleet([_port(below), _port(above)], device=CPU)
    ref = jfleet.solve_fleet([below, above])
    for t, g, r in zip((below, above), got, ref):
        assert np.array_equal(g.assign, single_cold(t)[0])
        assert np.array_equal(g.assign, r.assign)


@pytest.mark.parametrize("P,N,seed", [(17, 9, 0), (19, 9, 1), (15, 10, 2)])
def test_bucket_padding_is_bit_neutral(P, N, seed):
    """Unpadded with p_real and bucket-padded with p_real agree on the
    real rows, on the single path and through the batch axis."""
    t = make_tenant(P, N, seed, weights=True)
    args = (t.prev, t.partition_weights, t.node_weights, t.valid_node,
            t.stickiness, t.gids, t.gid_valid)
    out_u, _ = T._solve_dense_converged_impl(
        *_tensors(args), t.constraints, t.rules, 10, "off",
        p_real=_p_real(t))
    k = tfleet.batch_class_of(_port(t))
    arrs = pad_problem_arrays(*args, k.p, k.n)
    out_p, _ = T._solve_dense_converged_impl(
        *_tensors(arrs), t.constraints, t.rules, 10, "off",
        p_real=_p_real(t))
    assert np.array_equal(out_u.numpy(), out_p.numpy()[:P])
    batch = stack_problem_arrays([arrs + (np.float32(P),)] * 2)
    out_b, sweeps_b, _used = tfleet._fleet_cold_batch(
        *_tensors(batch), t.constraints, t.rules)
    assert np.array_equal(out_b.numpy()[1, :P], out_u.numpy())
    assert sweeps_b.tolist() == [sweeps_b[0].item()] * 2


def test_batch_padding_replicates_the_last_element():
    a = np.arange(6).reshape(3, 2)
    out, b = tfleet._pad_batch([a], 5)
    assert b == 5 and out[0].tolist() == a.tolist() + [[4, 5], [4, 5]]
    assert tfleet._pad_batch([a], 2)[1] == 3


def test_strip_prev_rows_matches_reference():
    from blance_tpu.core.encode import strip_prev_rows as j_strip

    prev = make_tenant(20, 8, 3).prev
    got, dirty = strip_prev_rows(prev, np.array([1, 5], np.int32))
    want, want_dirty = j_strip(prev, np.array([1, 5], np.int32))
    assert np.array_equal(got, want) and np.array_equal(dirty, want_dirty)


# -- the in-kernel score engine ------------------------------------------------


def test_fused_on_matches_reference_interpret():
    """fused_score="on" (its plain version on the CPU) against the
    reference's Pallas interpreter, and against the port's single
    fused solve."""
    tenants = [make_tenant(17 + (i % 2), 8, seed=30 + i) for i in range(3)]
    ref = jfleet.solve_fleet(tenants, fused_score="interpret")
    got = tfleet.solve_fleet([_port(t) for t in tenants],
                             fused_score="on", device=CPU)
    for t, r, g in zip(tenants, ref, got):
        assert np.array_equal(g.assign, r.assign), t.key
        assert g.sweeps == r.sweeps
        assert np.array_equal(g.assign, single_cold(t, "on")[0])


def test_mesh_raises_naming_a9():
    """``mesh=`` takes a port Mesh: anything else is rejected with a
    clear error (as is a 2-D mesh, the batch axis being the only one),
    and a real 2-rank CPU mesh solves the tenant as the unmeshed batch
    does."""
    from blance_tpu_torch.parallel.sharded import make_mesh, make_mesh_2d

    t = _port(make_tenant(17, 8, 0))
    with pytest.raises(TypeError, match="must be a blance_tpu_torch"):
        tfleet.solve_fleet([t], mesh=object(), device=CPU)
    with pytest.raises(TypeError, match="must be a blance_tpu_torch"):
        PlanService(mesh=object(), device=CPU)
    with make_mesh(2, device="cpu") as mesh:
        with make_mesh_2d(1, 2, devices=mesh) as grid, \
                pytest.raises(ValueError, match="1-D mesh"):
            tfleet.solve_fleet([t], mesh=grid)
        got = tfleet.solve_fleet([t], mesh=mesh)
    want = tfleet.solve_fleet([t], device=CPU)
    assert np.array_equal(got[0].assign, want[0].assign)
    assert got[0].sweeps == want[0].sweeps


def test_fleet_asks_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tfleet.solve_fleet([_port(make_tenant(17, 8, 0))])
    with pytest.raises(RuntimeError, match="is_available"):
        PlanService()


# -- the plan service ---------------------------------------------------------


def _run(coro):
    return asyncio.run(coro)


def test_service_coalesces_and_matches_reference():
    tenants = [make_tenant(17 + (i % 2), 8, seed=40 + i, key=f"svc{i}")
               for i in range(8)]
    rec = Recorder()

    async def drive():
        svc = PlanService(admission_window_s=0.05, recorder=rec,
                          device=CPU)
        await svc.start()
        results = await asyncio.gather(
            *[svc.submit(_port(t)) for t in tenants])
        await svc.stop()
        return results

    results = _run(drive())
    for t, got, want in zip(tenants, results, jfleet.solve_fleet(tenants)):
        assert np.array_equal(got.assign, want.assign)
        assert np.array_equal(got.assign, single_cold(t)[0])
    assert rec.counters["fleet.requests"] == 8
    assert rec.counters["fleet.batches"] <= 2
    assert rec._hist_stats["fleet.batch_tenants"][3] >= 4  # max
    assert rec._hist_stats["fleet.admission_latency_s"][0] == 8


def test_service_warm_carry_across_rounds():
    """Round 2 requests carry no carry: the service's cache supplies it
    (prev equals the cached assignment by value) and the tenants ride
    the warm repair, equal to the reference's warm fleet."""
    tenants = [make_tenant(18, 8, seed=60 + i, key=f"warm{i}")
               for i in range(4)]
    rec = Recorder()

    async def drive():
        svc = PlanService(admission_window_s=0.02, recorder=rec,
                          device=CPU)
        await svc.start()
        r1 = await asyncio.gather(*[svc.submit(_port(t)) for t in tenants])
        round2 = [_port(delta_tenant(t, r)[0], carry=None)
                  for t, r in zip(tenants, r1)]
        r2 = await asyncio.gather(*[svc.submit(t) for t in round2])
        await svc.stop()
        return r1, r2

    r1, r2 = _run(drive())
    ref1 = jfleet.solve_fleet(tenants)
    ref2 = jfleet.solve_fleet([delta_tenant(t, r)[0]
                               for t, r in zip(tenants, ref1)])
    assert all(r.warm for r in r2)
    assert rec.counters.get("plan.solve.carry_hit", 0) == 4
    for got, want in zip(r1 + r2, ref1 + ref2):
        assert np.array_equal(got.assign, want.assign)


def test_service_without_dirty_mask_solves_cold():
    t = _port(make_tenant(18, 8, seed=70, key="colder"))
    rec = Recorder()

    async def drive():
        svc = PlanService(admission_window_s=0.0, recorder=rec, device=CPU)
        await svc.start()
        r1 = await svc.submit(t)
        r2 = await svc.submit(dataclasses.replace(t, prev=r1.assign))
        await svc.stop()
        return r2

    assert not _run(drive()).warm
    assert rec.counters.get("plan.solve.carry_hit", 0) == 0


def test_service_stop_and_closed_semantics():
    t = _port(make_tenant(17, 8, seed=80, key="stopme"))

    async def drive():
        svc = PlanService(admission_window_s=0.0, device=CPU)
        with pytest.raises(PlanServiceClosed):
            await svc.submit(t)  # before start
        await svc.start()
        await svc.start()  # idempotent
        r = await svc.submit(t)
        await svc.stop()
        await svc.stop()  # idempotent
        with pytest.raises(PlanServiceClosed):
            await svc.submit(t)
        with pytest.raises(PlanServiceClosed):
            await svc.start()
        return r

    assert np.array_equal(_run(drive()).assign, single_cold(t)[0])


def test_service_backpressure_bounds_queue():
    tenants = [_port(make_tenant(17, 8, seed=90 + i, key=f"bp{i}"))
               for i in range(6)]

    async def drive():
        svc = PlanService(admission_window_s=0.0, max_pending=2, device=CPU)
        await svc.start()
        subs = [asyncio.create_task(svc.submit(t)) for t in tenants]
        await asyncio.sleep(0)
        assert svc._queue.qsize() <= 2
        results = await asyncio.gather(*subs)
        await svc.stop()
        return results

    results = _run(drive())
    for t, r in zip(tenants, results):
        assert np.array_equal(r.assign, single_cold(t)[0])


def test_service_malformed_and_invalid_requests_fail_alone():
    """A request that dies in batch preparation (a plain-list prev; a
    slot depth below its constraints) fails its own future; the
    co-batched neighbor still solves and the service stays up."""
    good = _port(make_tenant(17, 8, seed=95, key="good"))
    malformed = dataclasses.replace(good, key="bad", prev=[[0]])
    small = _port(make_tenant(8, 4, 0))
    underdeep = dataclasses.replace(small, key="bad2", constraints=(2, 1))

    async def drive():
        svc = PlanService(admission_window_s=0.05, device=CPU)
        await svc.start()
        done = await asyncio.gather(
            svc.submit(good), svc.submit(malformed), svc.submit(underdeep),
            return_exceptions=True)
        again = await svc.submit(dataclasses.replace(good, key="ok2"))
        await svc.stop()
        return done, again

    (good_res, bad_res, deep_res), again = _run(drive())
    assert isinstance(bad_res, Exception)
    assert isinstance(deep_res, ValueError) and "slot depth" in str(deep_res)
    assert np.array_equal(good_res.assign, single_cold(good)[0])
    assert np.array_equal(again.assign, good_res.assign)


def test_service_worker_error_fails_its_batch(monkeypatch):
    """An error in the solve worker fails every request of its batch —
    never swallowed — and the next batch still solves."""
    import blance_tpu_torch.plan.service as service_mod

    t = _port(make_tenant(17, 8, seed=81, key="w"))
    real = service_mod.solve_fleet
    calls = []

    def flaky(problems, **kw):
        calls.append(len(problems))
        if len(calls) == 1:
            raise RuntimeError("worker failed")
        return real(problems, **kw)

    monkeypatch.setattr(service_mod, "solve_fleet", flaky)

    async def drive():
        svc = PlanService(admission_window_s=0.05, device=CPU)
        await svc.start()
        first = await asyncio.gather(
            svc.submit(t), svc.submit(dataclasses.replace(t, key="w2")),
            return_exceptions=True)
        again = await svc.submit(t)
        await svc.stop()
        return first, again

    first, again = _run(drive())
    assert calls[0] == 2
    assert all(isinstance(e, RuntimeError) and "worker failed" in str(e)
               for e in first)
    assert np.array_equal(again.assign, single_cold(t)[0])


def test_service_routes_solve_metrics_to_its_recorder():
    """The executor thread's fleet and solve metrics go to the service's
    own recorder, none to the process recorder."""
    t = _port(make_tenant(18, 8, seed=99, key="routed"))
    rec = Recorder()

    async def drive():
        svc = PlanService(admission_window_s=0.0, recorder=rec, device=CPU)
        await svc.start()
        r = await svc.submit(t)
        await svc.stop()
        return r

    before = dict(get_recorder().counters)
    _run(drive())
    assert rec.counters.get("fleet.batches", 0) >= 1
    assert rec.counters.get("plan.solve.calls", 0) >= 1
    assert "fleet.batch_tenants" in rec._hist_stats
    after = get_recorder().counters
    for name in ("fleet.batches", "fleet.requests", "plan.solve.calls"):
        assert after.get(name, 0) == before.get(name, 0)


# -- batched helpers ----------------------------------------------------------


def test_segment_accept_reduces_per_batch_element():
    """Over a batch each element's prefix starts at zero: an earlier
    element's weight never enters a later element's prefix."""
    rng = np.random.default_rng(4)
    node = np.sort(rng.integers(0, 5, (3, 40)), axis=1).astype(np.int32)
    ok = rng.random((3, 40)) < 0.8
    w = np.where(ok, rng.integers(1, 4, (3, 40)), 0).astype(np.float32)
    cap = rng.integers(0, 9, (3, 40)).astype(np.float32)
    got = T._segment_accept(*_tensors((node, ok, w, cap)))
    for b in range(3):
        want = T._segment_accept(*_tensors((node[b], ok[b], w[b], cap[b])))
        assert torch.equal(got[b], want)
