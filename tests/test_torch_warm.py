"""The port's warm carry and warm repairs against the JAX package, on the CPU.

Same inputs, made from a seed with numpy, through both packages and
compared exactly (whole-number weights throughout, so every float32 sum
is exact in any order): ``carry_from_assignment``'s tables, the dense
warm repair (``solve_dense_warm``) on both score engines, the sparse warm
repair (``solve_sparse_warm``) at K < N and K = N, the carry-seeded and
carry-returning cold solves, and the carry cache copied from the
reference.  The reference runs its matrix engine under XLA and its Pallas
kernels in interpret mode; the port runs with ``device="cpu"``, where
every kernel takes its plain version.  A reference carry seeds the port
through ``carry_to_torch`` throughout, so both packages repair from the
very same state.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import blance_tpu  # noqa: E402
import blance_tpu.obs as jobs  # noqa: E402
import blance_tpu_torch as bt  # noqa: E402
import blance_tpu_torch.obs as tobs  # noqa: E402
from blance_tpu.plan import carry as jcarry  # noqa: E402
from blance_tpu.plan import tensor as jtensor  # noqa: E402
from blance_tpu.plan.session import PlannerSession as JSession  # noqa: E402
from blance_tpu_torch.plan import carry as tcarry  # noqa: E402
from blance_tpu_torch.plan import tensor as ttensor  # noqa: E402
from test_torch_sparse import _dense_args  # noqa: E402
from _port_telemetry import (  # noqa: E402
    SOLVER, SPARSE_MIN2, port_names, ref_view)

MODEL_STATES = dict(primary=(0, 1), replica=(1, 1))
NODES = [f"n{i}" for i in range(8)]
PARTS = [str(i) for i in range(64)]
# The four deltas of tests/test_warm_replan.py.
DELTAS = [
    pytest.param({"remove": ["n3"]}, id="remove-1"),
    pytest.param({"remove": ["n1", "n6"]}, id="remove-2"),
    pytest.param({"add": ["x0"]}, id="add-1"),
    pytest.param({"remove": ["n2"], "add": ["x0", "x1"]}, id="mixed"),
]
ENGINES = [pytest.param("off", "off", id="matrix"),
           pytest.param("on", "interpret", id="fused")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(arrays):
    return bt.problem_to_torch(*arrays, device="cpu")


def _first_diff(got, want):
    return f"first differing [p, s, r]: {np.argwhere(got != want)[:3].tolist()}"


def _plan_counters(rec):
    return {k: v for k, v in rec.counters.items() if k.startswith("plan.")}


def rack_opts(lib, nodes, racks_of=4):
    hier = {n: f"r{i // racks_of}" for i, n in enumerate(nodes)}
    hier.update({f"r{i}": "z0"
                 for i in range((len(nodes) + racks_of - 1) // racks_of)})
    return lib.PlanOptions(
        node_hierarchy=hier,
        hierarchy_rules={"replica": [lib.HierarchyRule(2, 1)]})


# --- carry tables ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 2])
def test_carry_from_assignment_matches_jax(seed):
    """used, prices and assign bitwise (seed 2: weighted partitions and
    nodes)."""
    arrays, cons, rules = _dense_args(512, 32, seed)
    cold = jtensor.solve_dense_converged(
        *[jnp.asarray(a) for a in arrays], cons, rules, record=False)
    want = jtensor.carry_from_assignment(cold, jnp.asarray(arrays[1]),
                                         jnp.asarray(arrays[2]))
    a = _t(arrays)
    got = ttensor.carry_from_assignment(np.asarray(cold), a[1], a[2])
    for name in ("prices", "assign", "used"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes(), name
    # The port's own cold solve returns the same carry.
    out, carry = bt.solve_dense_converged(*a, cons, rules, return_carry=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(cold))
    assert carry.used.numpy().tobytes() == np.asarray(want.used).tobytes()


def test_carry_conversions_round_trip():
    arrays, cons, rules = _dense_args(128, 16, 1)
    cold = jtensor.solve_dense_converged(
        *[jnp.asarray(a) for a in arrays], cons, rules, record=False)
    jc = jtensor.carry_from_assignment(cold, jnp.asarray(arrays[1]),
                                       jnp.asarray(arrays[2]))
    tc = bt.carry_to_torch(jc, "cpu")
    assert isinstance(tc, bt.SolveCarry)
    assert (tc.prices.dtype, tc.assign.dtype, tc.used.dtype) == \
        (torch.float32, torch.int32, torch.float32)
    back = bt.carry_to_numpy(tc)
    for name in ("prices", "assign", "used"):
        np.testing.assert_array_equal(getattr(back, name),
                                      np.asarray(getattr(jc, name)))


# --- carry-seeded and carry-returning cold solves ----------------------------------


@pytest.mark.parametrize("seed", [0, 2])
def test_carry_seeded_cold_solve_matches_jax(seed):
    """A converged solve seeded from a carry (the first sweep reads it)
    after a one-node removal, and the carry the resilient solve returns."""
    arrays, cons, rules = _dense_args(512, 32, seed)
    prev, pw, nw, valid, stick, gids, gv = arrays
    cold = np.asarray(jtensor.solve_dense_converged(
        *[jnp.asarray(a) for a in arrays], cons, rules, record=False))
    valid2 = valid.copy()
    valid2[int(cold[0, 0, 0])] = False
    args2 = (cold, pw, nw, valid2, stick, gids, gv)
    jc = jtensor.carry_from_assignment(jnp.asarray(cold), jnp.asarray(pw),
                                       jnp.asarray(nw))
    want, _mode, want_carry = jtensor.solve_converged_resilient(
        *[jnp.asarray(a) for a in args2], cons, rules, max_iterations=10,
        mode="off", allow_fallback=False, context="test",
        carry_used=jc.used, return_carry=True)
    got, mode, got_carry = ttensor.solve_converged_resilient(
        *_t(args2), cons, rules, max_iterations=10, mode="off",
        allow_fallback=False, context="test",
        carry_used=bt.carry_to_torch(jc, "cpu").used, return_carry=True)
    assert mode == "off"
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got_carry.used.numpy(),
                                  np.asarray(want_carry.used))
    np.testing.assert_array_equal(got_carry.assign.numpy(), got)


def test_sweeps_and_engine_recorded_like_jax():
    """plan.solve.calls / sweeps on each package's recorder, and the
    engine attribute on the enclosing span."""
    arrays, cons, rules = _dense_args(256, 32, 1)
    jrec, trec = jobs.Recorder(), tobs.Recorder()
    with jobs.use_recorder(jrec), jrec.span("outer") as jsp:
        jtensor.solve_converged_resilient(
            *[jnp.asarray(a) for a in arrays], cons, rules,
            max_iterations=10, mode="off", allow_fallback=False,
            context="test")
    with tobs.use_recorder(trec), trec.span("outer") as tsp:
        ttensor.solve_converged_resilient(
            *_t(arrays), cons, rules, max_iterations=10, mode="off",
            allow_fallback=False, context="test")
    assert ref_view(_plan_counters(trec)) == _plan_counters(jrec)
    assert port_names(trec.counters) == SOLVER
    assert trec.counters["plan.solve.sweeps"] >= 2
    assert tsp.attrs["engine"] == jsp.attrs["engine"] == "matrix"
    assert trec.span_counts["plan.solve.attempt"] == 1


# --- the dense warm repair -----------------------------------------------------------


def _reference_warm_state(opts, delta):
    """The reference session's state for a warm replan after ``delta``:
    solver arrays, statics, the live carry and the effective dirty mask,
    taken just before the session would call solve_dense_warm."""
    s = JSession(blance_tpu.model(**MODEL_STATES), list(NODES), list(PARTS),
                 opts=opts)
    s.replan()
    s.apply()
    if "remove" in delta:
        s.remove_nodes(delta["remove"])
    if "add" in delta:
        s.add_nodes(delta["add"])
    e = s._carries.peek(s._ckey)
    prob = s.problem
    dirty = jcarry.effective_dirty(e.dirty | e.dirty_post, s.current,
                                   prob.constraints)
    arrays = tuple(np.array(a) for a in (
        s.current, prob.partition_weights, prob.node_weights,
        prob.valid_node, prob.stickiness, prob.gids, prob.gid_valid))
    rules = tuple(tuple(prob.rules.get(si, ())) for si in range(prob.S))
    cons = tuple(int(c) for c in prob.constraints)
    return arrays, cons, rules, e.carry, dirty


@pytest.mark.parametrize("engine,ref_engine", ENGINES)
@pytest.mark.parametrize("rack", [False, True], ids=["flat", "rack-rules"])
@pytest.mark.parametrize("delta", DELTAS)
def test_solve_dense_warm_matches_jax(delta, rack, engine, ref_engine):
    """Same accept/decline decision, assignment, next carry and counters
    as the reference, from the reference's own carry; an accepted repair
    equals the cold solve of the same problem."""
    opts = rack_opts(blance_tpu, NODES + ["x0", "x1"]) if rack else None
    arrays, cons, rules, carry, dirty = _reference_warm_state(opts, delta)
    jrec, trec = jobs.Recorder(), tobs.Recorder()
    with jobs.use_recorder(jrec):
        want, want_carry = jtensor.solve_dense_warm(
            *arrays, cons, rules, dirty=dirty, carry=carry,
            fused_score=ref_engine)
    with tobs.use_recorder(trec):
        got, got_carry = ttensor.solve_dense_warm(
            *_t(arrays), cons, rules, dirty=dirty,
            carry=bt.carry_to_torch(carry, "cpu"), fused_score=engine)
    assert (got is None) == (want is None)
    assert ref_view(_plan_counters(trec)) == _plan_counters(jrec)
    # When nodes only join, every copy stays pinned: no auction round.
    assert port_names(trec.counters) == (
        SOLVER if "remove" in delta else {"plan.solve.host_syncs"})
    assert trec.histogram_summary("plan.solve.dirty_fraction") == \
        jrec.histogram_summary("plan.solve.dirty_fraction")
    if want is None:
        assert got_carry is None
        return
    np.testing.assert_array_equal(got, want, _first_diff(got, want))
    np.testing.assert_array_equal(got_carry.used.numpy(),
                                  np.asarray(want_carry.used))
    np.testing.assert_array_equal(got_carry.prices.numpy(),
                                  np.asarray(want_carry.prices))
    cold = bt.solve_dense_converged(*_t(arrays), cons, rules,
                                    fused_score=engine, record=False)
    np.testing.assert_array_equal(got, cold.numpy())


def test_dense_warm_accepts_a_contained_removal():
    """The fixture the tests above must not make vacuous: removing one
    node from a flat 64 x 8 plan is accepted (one sweep) by both."""
    arrays, cons, rules, carry, dirty = _reference_warm_state(
        None, {"remove": ["n3"]})
    trec = tobs.Recorder()
    with tobs.use_recorder(trec):
        got, _ = ttensor.solve_dense_warm(
            *_t(arrays), cons, rules, dirty=dirty,
            carry=bt.carry_to_torch(carry, "cpu"))
    assert got is not None
    assert trec.counters["plan.solve.sweeps"] == 1
    assert "plan.solve.warm_fallback" not in trec.counters


def test_dense_warm_refuses_unported_and_unresolved_options():
    """p_real (once refused until A.13) repairs as the reference's
    does; an unresolved engine raises; donate= changes nothing."""
    arrays, cons, rules, carry, dirty = _reference_warm_state(
        None, {"remove": ["n3"]})
    tc = bt.carry_to_torch(carry, "cpu")
    want, _ = jtensor.solve_dense_warm(*arrays, cons, rules, dirty=dirty,
                                       carry=carry, p_real=64, record=False)
    got, _ = ttensor.solve_dense_warm(*_t(arrays), cons, rules, dirty=dirty,
                                      carry=tc, p_real=64, record=False)
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got, want, _first_diff(got, want))
    with pytest.raises(ValueError, match="unresolved"):
        ttensor.solve_dense_warm(*_t(arrays), cons, rules, dirty=dirty,
                                 carry=tc, fused_score="auto")
    # donate= is accepted and changes nothing; the carry stays usable.
    a, _ = ttensor.solve_dense_warm(*_t(arrays), cons, rules, dirty=dirty,
                                    carry=tc, donate=True, record=False)
    b, _ = ttensor.solve_dense_warm(*_t(arrays), cons, rules, dirty=dirty,
                                    carry=tc, record=False)
    np.testing.assert_array_equal(a, b)


# --- the sparse warm repair ----------------------------------------------------------


def _sparse_warm_case(seed, P=256, N=64):
    """A converged cold solve, one node (row 0's primary) removed, the
    rows that held it dirty (tests/test_sparse.py's warm fixture)."""
    arrays, cons, rules = _dense_args(P, N, seed)
    prev, pw, nw, valid, stick, gids, gv = arrays
    cold = np.asarray(jtensor.solve_dense_converged(
        *[jnp.asarray(a) for a in arrays], cons, rules, record=False))
    victim = int(cold[0, 0, 0])
    valid2 = valid.copy()
    valid2[victim] = False
    dirty = (cold == victim).any(axis=(1, 2))
    return (cold, pw, nw, valid2, stick, gids, gv), cons, rules, dirty


@pytest.mark.parametrize("k", [8, None], ids=["k8", "k=N"])
@pytest.mark.parametrize("seed", [0, 2, 3, 7])
def test_solve_sparse_warm_matches_jax(seed, k):
    """Held against the reference's kernel route (interpret): the same
    decision, assignment, next carry and counters (seeds 0 and 2 accept
    at both K, 3 and 7 decline at K = 8)."""
    arrays, cons, rules, dirty = _sparse_warm_case(seed)
    kk = arrays[2].shape[0] if k is None else k
    jc = jtensor.carry_from_assignment(jnp.asarray(arrays[0]),
                                       jnp.asarray(arrays[1]),
                                       jnp.asarray(arrays[2]))
    jrec, trec = jobs.Recorder(), tobs.Recorder()
    with jobs.use_recorder(jrec):
        want, want_carry = jtensor.solve_sparse_warm(
            *arrays, cons, rules, dirty=dirty, carry=jc, k=kk,
            sparse_impl="interpret")
    stats = {}
    with tobs.use_recorder(trec):
        got, got_carry = ttensor.solve_sparse_warm(
            *_t(arrays), cons, rules, dirty=dirty,
            carry=bt.carry_to_torch(jc, "cpu"), k=kk, stats=stats)
    assert (got is None) == (want is None) == (not stats["accepted"])
    keep = ("plan.solve.", "plan.sparse.shortlist_exhausted",
            "plan.sparse.dense_fallback_rows")
    assert ref_view({k_: v for k_, v in trec.counters.items()
                     if k_.startswith(keep)}) \
        == {k_: v for k_, v in jrec.counters.items() if k_.startswith(keep)}
    assert port_names(trec.counters) == SOLVER | SPARSE_MIN2
    assert trec.gauges["plan.sparse.k_effective"] == \
        jrec.gauges["plan.sparse.k_effective"] == kk
    if want is None:
        return
    np.testing.assert_array_equal(got, want, _first_diff(got, want))
    np.testing.assert_array_equal(got_carry.used.numpy(),
                                  np.asarray(want_carry.used))


@pytest.mark.parametrize("seed", [2, 3])
def test_saturating_sparse_warm_equals_dense_warm(seed):
    """K = N: the sparse repair accepts exactly when the dense one does,
    with the identical assignment and carry (the port against itself)."""
    arrays, cons, rules, dirty = _sparse_warm_case(seed)
    a = _t(arrays)
    carry = ttensor.carry_from_assignment(a[0], a[1], a[2])
    wd, cd = ttensor.solve_dense_warm(*a, cons, rules, dirty=dirty,
                                      carry=carry, record=False)
    ws, cs = ttensor.solve_sparse_warm(*a, cons, rules, dirty=dirty,
                                       carry=carry, k=arrays[2].shape[0],
                                       record=False)
    assert wd is not None and ws is not None
    np.testing.assert_array_equal(wd, ws)
    np.testing.assert_array_equal(cd.used.numpy(), cs.used.numpy())


def test_warm_repair_sparse_sweep_matches_jax():
    """The repair sweep itself: assignment, new_used, ok and exhausted
    flags, array for array (K = 1 cannot serve two exclusive slots, so
    rows exhaust)."""
    arrays, cons, rules, dirty = _sparse_warm_case(2, P=512, N=32)
    jarr = [jnp.asarray(x) for x in arrays]
    jc = jtensor.carry_from_assignment(jarr[0], jarr[1], jarr[2])
    sl = np.array(jtensor._build_or_adopt_shortlist(
        *jarr[:4], jarr[5], jarr[6], cons, rules, None, 1, False))
    want = jtensor._warm_repair_sparse_jit(
        *jarr, jnp.asarray(sl), jnp.asarray(dirty), jc.used,
        constraints=cons, rules=rules, sparse_impl="interpret")
    a = _t(arrays)
    got = ttensor._warm_repair_sparse(
        *a, torch.from_numpy(sl), torch.from_numpy(dirty),
        bt.carry_to_torch(jc, "cpu").used, cons, rules)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(np.asarray(want[3]).any())  # the fallback has rows to place


@pytest.mark.parametrize("seed", [0, 2])
def test_sparse_cold_carry_matches_jax(seed):
    """solve_sparse seeded from a carry and returning one, with K small
    enough that the host fallback patches rows before the carry is
    built."""
    arrays, cons, rules, _dirty = _sparse_warm_case(seed, P=512, N=32)
    jarr = [jnp.asarray(x) for x in arrays]
    jc = jtensor.carry_from_assignment(jarr[0], jarr[1], jarr[2])
    want, want_carry = jtensor.solve_sparse(
        *arrays, cons, rules, k=3, record=False, carry_used=jc.used,
        return_carry=True, sparse_impl="interpret")
    stats = {}
    got, got_carry = ttensor.solve_sparse(
        *_t(arrays), cons, rules, k=3, record=False,
        carry_used=bt.carry_to_torch(jc, "cpu").used, return_carry=True,
        stats=stats)
    np.testing.assert_array_equal(got, want, _first_diff(got, want))
    np.testing.assert_array_equal(got_carry.used.numpy(),
                                  np.asarray(want_carry.used))
    np.testing.assert_array_equal(got_carry.assign.numpy(), got)
    assert stats["fallback_rows"] > 0


def test_sparse_warm_refuses_p_real():
    """p_real, refused until A.13: the sparse warm repair with it is the
    reference's (kernel route), decision and assignment."""
    arrays, cons, rules, dirty = _sparse_warm_case(0, P=64, N=16)
    a = _t(arrays)
    carry = ttensor.carry_from_assignment(a[0], a[1], a[2])
    jc = jtensor.carry_from_assignment(*[jnp.asarray(x) for x in arrays[:3]])
    want, _ = jtensor.solve_sparse_warm(*arrays, cons, rules, dirty=dirty,
                                        carry=jc, k=4, p_real=64,
                                        record=False, sparse_impl="interpret")
    got, _ = ttensor.solve_sparse_warm(*a, cons, rules, dirty=dirty,
                                       carry=carry, k=4, p_real=64,
                                       record=False)
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got, want, _first_diff(got, want))


# --- the carry cache (a copy of the reference's, on torch carries) --------------------


def _toy_carry(p=4, s=2, n=3, fill=1.0):
    used = torch.full((s, n), fill, dtype=torch.float32)
    return bt.SolveCarry(prices=used.sum(0),
                         assign=torch.zeros((p, s, 1), dtype=torch.int32),
                         used=used)


def test_carry_cache_consume_matching_modes():
    cache = tcarry.CarryCache()
    cur = np.zeros((4, 2, 1), np.int32)
    cache.store("a", _toy_carry(), cur)
    clone = cur.copy()
    carry, _ = cache.consume("a", clone, match="identity")
    assert carry is None
    cache.store("a", _toy_carry(), cur)
    carry, _ = cache.consume("a", clone, match="equal")
    assert carry is not None
    carry2, _ = cache.consume("a", clone, match="equal")
    assert carry2 is None
    with pytest.raises(ValueError, match="match mode"):
        cache.consume("a", cur, match="bogus")


def test_carry_cache_pending_promotion_and_dirty_routing():
    cache = tcarry.CarryCache()
    cur = np.zeros((4, 2, 1), np.int32)
    e = cache.entry("a", 4)
    cache.mark_dirty("a", np.array([1, 0, 0, 0], bool), pending=False)
    cache.store_pending("a", _toy_carry())
    cache.mark_dirty("a", np.array([0, 0, 1, 0], bool), pending=True)
    cache.promote("a", cur)
    assert e.carry is not None and e.pending is None
    carry, dirty = cache.consume("a", cur)
    assert carry is not None
    assert dirty.tolist() == [False, False, True, False]


def test_carry_cache_pad_nodes_grows_both_carries():
    cache = tcarry.CarryCache()
    cur = np.zeros((4, 2, 1), np.int32)
    cache.store("a", _toy_carry(n=3), cur)
    cache.store_pending("a", _toy_carry(n=3, fill=2.0))
    cache.pad_nodes("a", 5)
    e = cache.peek("a")
    assert tuple(e.carry.used.shape) == tuple(e.pending.used.shape) == (2, 5)
    assert isinstance(e.carry.used, torch.Tensor)
    assert (e.carry.used[:, 3:] == 0).all()
    np.testing.assert_array_equal(e.carry.prices.numpy(),
                                  e.carry.used.sum(0).numpy())
    assert tcarry.pad_carry_nodes(None, 9) is None
    assert tcarry.pad_carry_nodes(e.carry, 2) is e.carry


def test_carry_cache_lru_byte_budget_evicts_oldest():
    one = _toy_carry()
    per_entry = sum(t.element_size() * t.nelement()
                    for t in (one.prices, one.assign, one.used))
    cache = tcarry.CarryCache(max_bytes=2 * per_entry)
    cur = np.zeros((4, 2, 1), np.int32)
    for key in ("a", "b", "c"):
        cache.store(key, _toy_carry(), cur)
    assert cache.nbytes() <= 2 * per_entry
    assert cache.peek("a").carry is None
    assert cache.peek("b").carry is not None
    assert cache.peek("c").carry is not None
    cache.consume("b", cur)
    cache.store("b", _toy_carry(), cur)
    cache.store("d", _toy_carry(), cur)
    assert cache.peek("c").carry is None
    assert cache.peek("b").carry is not None
    assert cache.evictions.get("bytes", 0) == 2


def test_carry_cache_bytes_track_ground_truth():
    cache = tcarry.CarryCache(max_bytes=None, max_entries=4)
    cur = np.zeros((4, 2, 1), np.int32)

    def check(step):
        assert cache.nbytes() == cache._recount(), step

    for i in range(6):
        cache.store(f"k{i}", _toy_carry(), cur)
        check(f"store k{i}")
    assert set(cache.keys()) == {"k2", "k3", "k4", "k5"}
    cache.consume("k5", cur)
    check("consume")
    cache.store_pending("k5", _toy_carry(n=4))
    check("store_pending")
    cache.pad_nodes("k5", 7)
    check("pad_nodes")
    cache.promote("k5", cur)
    check("promote")
    cache.invalidate("k4")
    check("invalidate")
    cache.drop("k3")
    check("drop")
    e = cache.entry("k5", 9)  # shape reset replaces the entry
    check("entry reset")
    assert e.carry is None and e.dirty.shape == (9,)


@pytest.mark.parametrize("all_dirty", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_capacity_shrank_matches_jax(seed, all_dirty):
    """The host precheck on a torch ``used`` equals the reference's on
    the same numbers (a quarter of the rows dirty, or all of them)."""
    rng = np.random.default_rng(seed)
    P, N = 200, 10
    current = rng.integers(-1, N, (P, 2, 1)).astype(np.int32)
    pw = rng.integers(1, 3, P).astype(np.float32)
    nw = rng.integers(1, 3, N).astype(np.float32)
    valid = rng.random(N) < 0.9
    used = np.stack([np.bincount(current[:, si, 0][current[:, si, 0] >= 0],
                                 weights=pw[current[:, si, 0] >= 0],
                                 minlength=N) for si in range(2)]
                    ).astype(np.float32)
    dirty = np.ones(P, bool) if all_dirty else rng.random(P) < 0.25
    want = jcarry.capacity_shrank(used, current, pw, nw, valid, (1, 1),
                                  dirty)
    got = tcarry.capacity_shrank(torch.from_numpy(used), current, pw, nw,
                                 valid, (1, 1), dirty)
    assert got == want
    assert not all_dirty or not got


def test_effective_dirty_matches_jax():
    rng = np.random.default_rng(4)
    current = rng.integers(-1, 5, (50, 2, 2)).astype(np.int32)
    dirty = rng.random(50) < 0.1
    for cons in ((1, 1), (1, 2), (0, 2)):
        np.testing.assert_array_equal(
            tcarry.effective_dirty(dirty, current, cons),
            jcarry.effective_dirty(dirty, current, cons))
