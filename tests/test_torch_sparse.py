"""The port's sparse shortlist engine against the JAX package, on the CPU.

Same inputs, made from a seed with numpy, through both packages and
compared bitwise (whole-number weights throughout): the sparse min2
(port's plain version against the reference's XLA spelling and its
Pallas kernel in interpret mode), the shortlist builder, the score at
gathered columns, the converged sparse solve with its host fallback, and
plan_next_map with ``sparse=True`` and with the auto routing.  The port
runs on ``device="cpu"``, where the kernel takes its plain version; the
CUDA kernel itself is held against that plain version in
tests/test_torch_cuda.py and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import blance_tpu  # noqa: E402
import blance_tpu_torch as bt  # noqa: E402
from blance_tpu.core import shortlist as jshortlist  # noqa: E402
from blance_tpu.ops import sparse2 as jsparse2  # noqa: E402
from blance_tpu.plan import tensor as jtensor  # noqa: E402
from blance_tpu_torch.core import encode as tencode  # noqa: E402
from blance_tpu_torch.core import shortlist as tshortlist  # noqa: E402
from blance_tpu_torch.ops import score_fused as tfused  # noqa: E402
from blance_tpu_torch.ops import sparse2 as tsparse2  # noqa: E402
from blance_tpu_torch.plan import tensor as ttensor  # noqa: E402
from blance_tpu_torch.plan.audit import check_assignment  # noqa: E402

CLEAN = {"duplicates": 0, "on_removed_nodes": 0,
         "unfilled_feasible_slots": 0, "hierarchy_misses": 0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread is faster and steadier than
    a pool that competes with the other test workers for the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


# --- sparse min2 ----------------------------------------------------------------


def _min2_case(name):
    rng = np.random.default_rng(3)
    if name == "quantized":  # many duplicate minima
        shape = (2048, 64)
        score = rng.integers(0, 6, shape).astype(np.float32) * 0.125
        price = rng.integers(0, 3, shape).astype(np.float32) * 0.25
    elif name == "ragged":
        shape = (33, 37)
        score = rng.standard_normal(shape).astype(np.float32)
        price = rng.standard_normal(shape).astype(np.float32)
    elif name == "k1":
        shape = (7, 1)
        score = rng.standard_normal(shape).astype(np.float32)
        price = rng.standard_normal(shape).astype(np.float32)
    else:  # "inf_rows": all-+inf rows and +inf pad columns
        shape = (40, 19)
        score = rng.integers(0, 4, shape).astype(np.float32)
        score[:, 15:] = np.inf
        score[::7] = np.inf
        price = np.zeros(shape, np.float32)
    return score, price


@pytest.mark.parametrize("name", ["quantized", "ragged", "k1", "inf_rows"])
def test_sparse_min2_matches_jax(name):
    score, price = _min2_case(name)
    want = jsparse2.sparse_min2_reference(jnp.asarray(score),
                                          jnp.asarray(price))
    want_kernel = jsparse2.sparse_priced_min2(
        jnp.asarray(score), jnp.asarray(price), interpret=True)
    # The Pallas kernel leaves raw at 0 on an all-+inf row, where its XLA
    # oracle (and the port) give score[row, 0] = +inf; such a row never
    # bids (best >= _INF / 2), so the solver reads neither.
    finite = np.isfinite(np.asarray(want[0]))
    _same(want_kernel[:3], want[:3])
    _same(np.asarray(want_kernel[3])[finite], np.asarray(want[3])[finite])
    assert name != "inf_rows" or not finite.all()
    before = tsparse2.sparse_priced_min2.launches
    got = tsparse2.sparse_priced_min2(_t(score), _t(price))
    assert tsparse2.sparse_priced_min2.launches == before  # plain on CPU
    _same(got, want)
    _same(tsparse2.sparse_min2_reference(_t(score), _t(price)), want)


def test_sparse_min2_refuses_bad_inputs():
    with pytest.raises(ValueError, match="K >= 1"):
        tsparse2.sparse_priced_min2(torch.zeros(4, 0), torch.zeros(4, 0))
    with pytest.raises(ValueError, match="price shape"):
        tsparse2.sparse_priced_min2(torch.zeros(4, 3), torch.zeros(4, 2))
    meta = torch.empty(4, 3, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tsparse2.sparse_priced_min2(meta, meta)


# --- shortlist builder ---------------------------------------------------------------


def _dense_args(P, N, seed, rack=25, remove_frac=20, weights=None):
    """The rack-rule delta shape of bench.py's build_dense (one zone,
    5% of nodes removed, replica on another rack); seed 2 adds
    whole-number partition and node weights."""
    rng = np.random.default_rng(seed)
    prev = np.full((P, 2, 1), -1, np.int32)
    prev[:, 0, 0] = rng.integers(0, N, P)
    prev[:, 1, 0] = (prev[:, 0, 0] + 1 + rng.integers(0, N - 1, P)) % N
    pw = np.ones(P, np.float32)
    nw = np.ones(N, np.float32)
    weighted = seed == 2 if weights is None else weights
    if weighted:
        pw[::7] = rng.integers(2, 5, len(pw[::7]))
        nw[::5] = rng.integers(2, 4, len(nw[::5]))
    valid = np.ones(N, bool)
    if remove_frac:
        valid[rng.choice(N, max(N // remove_frac, 1), replace=False)] = False
    stick = np.full((P, 2), 1.5, np.float32)
    gids = np.stack([np.arange(N, dtype=np.int32),
                     np.arange(N, dtype=np.int32) // rack,
                     np.zeros(N, np.int32)])
    gv = np.ones((3, N), bool)
    return (prev, pw, nw, valid, stick, gids, gv), (1, 1), ((), ((2, 1),))


def _shortlist_case(name):
    if name == "rules":
        return _dense_args(512, 64, 0, rack=8) + (16,)
    if name == "rules_weighted_k10":
        return _dense_args(512, 64, 2, rack=8) + (10,)
    if name == "no_rules":
        arrays, cons, _ = _dense_args(300, 40, 1, remove_frac=0)
        return arrays, cons, ((), ()), 16
    if name == "two_rules":
        arrays, cons, _ = _dense_args(400, 48, 4, rack=4)
        gids = arrays[5].copy()
        gids[2] = np.arange(48, dtype=np.int32) // 16  # three zones
        arrays = arrays[:5] + (gids,) + arrays[6:]
        return arrays, (1, 2), ((), ((2, 1), (1, 0))), 24
    # "wrap": a fresh cluster (no holders) at P = 60 000, so every row
    # leans on the rotated window, whose int32 product wraps from row
    # 53 021 on.
    P, N = 60_000, 64
    prev = np.full((P, 2, 1), -1, np.int32)
    valid = np.ones(N, bool)
    valid[[3, 17, 40]] = False
    gids = np.stack([np.arange(N, dtype=np.int32),
                     np.arange(N, dtype=np.int32) // 8,
                     np.zeros(N, np.int32)])
    arrays = (prev, np.ones(P, np.float32), np.ones(N, np.float32), valid,
              np.full((P, 2), 1.5, np.float32), gids, np.ones((3, N), bool))
    return arrays, (1, 1), ((), ((2, 1),)), 16


@pytest.mark.parametrize("name", ["rules", "rules_weighted_k10", "no_rules",
                                  "two_rules", "wrap"])
def test_build_shortlist_matches_jax(name):
    (prev, pw, nw, valid, _stick, gids, gv), cons, rules, k = \
        _shortlist_case(name)
    if name == "two_rules":
        prev = np.concatenate([prev, (prev + 7) % 48], axis=2)  # R = 2
    want = np.asarray(jshortlist.build_shortlist(
        prev, pw, nw, valid, gids, gv, cons, rules, k))
    got = tshortlist.build_shortlist_core(
        _t(prev), _t(pw), _t(nw), _t(valid), _t(gids), _t(gv), cons, rules,
        k)
    assert got.dtype == torch.int32
    diff = np.argwhere(got.numpy() != want)
    assert diff.size == 0, f"first differing [p, k]: {diff[:3].tolist()}"
    assert want.shape == (prev.shape[0], min(k, nw.shape[0]))


def test_shortlist_k_rules_and_saturation():
    assert tshortlist.auto_shortlist_k(10_000, (1, 1), ((), ((2, 1),))) == 16
    for args in [(10, (1, 1), ((), ())), (10_000, (1, 3), ((), ((2, 1),))),
                 (5, (2,), (((1, 0),),))]:
        assert tshortlist.auto_shortlist_k(*args) == \
            jshortlist.auto_shortlist_k(*args)
    for rules in [((), ((2, 1),)), ((), ((1, 2),)), (((1, 1),),)]:
        assert tshortlist.shortlist_rules_nest(rules) == \
            jshortlist.shortlist_rules_nest(rules)
    (prev, pw, nw, valid, _s, gids, gv), cons, rules = _dense_args(20, 8, 0)
    sat = tshortlist.build_shortlist_core(
        _t(prev), _t(pw), _t(nw), _t(valid), _t(gids), _t(gv), cons, rules,
        12)
    np.testing.assert_array_equal(sat.numpy(),
                                  np.broadcast_to(np.arange(8), (20, 8)))


# --- score at gathered columns ----------------------------------------------------


@pytest.mark.parametrize("with_rules", [False, True])
def test_sparse_score_cols_matches_jitted_jax(with_rules):
    rng = np.random.default_rng(int(with_rules))
    P, N, K, R = 500, 97, 13, 2
    rack = rng.integers(0, 9, N).astype(np.int32)
    gids = np.stack([np.arange(N, dtype=np.int32), rack, rack // 3])
    gv = rng.random((3, N)) < 0.95
    cols = np.sort(rng.integers(0, N, (P, K)), axis=1).astype(np.int32)
    cols[:, -3:] = -1  # pads
    rows = rng.permutation(P).astype(np.int32)
    kw = dict(
        total=rng.integers(0, 60, N).astype(np.float32),
        w_div=rng.integers(1, 4, N).astype(np.float32),
        neg_boost=np.where(rng.random(N) < 0.2, 2.0, 0.0).astype(np.float32),
        valid=rng.random(N) < 0.9,
        stick_si=np.full(P, 1.5, np.float32),
        prev_slot=rng.integers(-1, N, P).astype(np.int32),
        prev_state=rng.integers(-1, N, (P, R)).astype(np.int32))
    taken = [rng.integers(-1, N, P).astype(np.int32) for _ in range(2)]
    anchors = rng.integers(-1, N, (P, 2)).astype(np.int32)
    rules = ((2, 1), (1, 0)) if with_rules else ()

    @jax.jit
    def ref(cols, rows, anchors, taken, kw):
        # total_p a trace-time constant, as inside the reference's solve.
        return jtensor._sparse_score_cols(
            cols, rows, 0, total_p=jnp.array(P, jnp.float32),
            gids=jnp.asarray(gids), gid_valid=jnp.asarray(gv),
            taken_ids=tuple(taken), anchors=anchors, rules=rules,
            jitter_scale=float(jtensor._JITTER), **kw)

    want = np.asarray(ref(jnp.asarray(cols), jnp.asarray(rows),
                          jnp.asarray(anchors),
                          [jnp.asarray(x) for x in taken],
                          {k: jnp.asarray(v) for k, v in kw.items()}))
    # The port's sparse engine: the one score on the slot's packed
    # inputs, at the gathered columns in the matrix build's term order.
    si = tfused.pack_score_inputs(
        total_l=_t(kw["total"]), total_p=P, w_div_l=_t(kw["w_div"]),
        neg_boost_l=_t(kw["neg_boost"]), valid_l=_t(kw["valid"]),
        stickiness_si=_t(kw["stick_si"]), prev_slot=_t(kw["prev_slot"]),
        prev_state=_t(kw["prev_state"]), taken_ids=[_t(x) for x in taken],
        anchors=_t(anchors), gids_l=_t(gids), gid_valid=_t(gv),
        gids=_t(gids), rules=rules)
    got = tfused.score_cells(si, _t(rows).long(), _t(cols), 0, 0,
                             nrules=len(rules), jitter_scale=ttensor._JITTER,
                             order="matrix").numpy()
    assert got.dtype == want.dtype
    diff = np.argwhere(got != want)
    assert diff.size == 0, f"first differing [row, k]: {diff[:3].tolist()}"


# --- converged sparse solve -----------------------------------------------------------


def _problem(arrays, constraints, rules):
    prev, pw, nw, valid, stick, gids, gv = arrays
    P, S, _ = prev.shape
    return tencode.DenseProblem(
        nodes=[str(i) for i in range(nw.shape[0])],
        partitions=[str(i) for i in range(P)],
        states=[f"s{i}" for i in range(S)],
        constraints=np.asarray(constraints, np.int32), prev=prev,
        partition_weights=pw, node_weights=nw, valid_node=valid,
        stickiness=stick, gids=gids, gid_valid=gv,
        rules={si: list(r) for si, r in enumerate(rules) if r})


def _first_diff(got, want):
    diff = np.argwhere(got != want)
    return f"first differing [p, s, r]: {diff[:3].tolist()}"


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("P,N", [(1024, 64), (4096, 256)])
def test_solve_sparse_matches_jax(P, N, seed):
    """Held against the reference's kernel route (the Pallas kernel in
    interpret mode, as on the TPU).  Its XLA route agrees wherever node
    weights are 1: with weighted nodes XLA on the CPU contracts the force
    step's ``score + used * price_scale`` into one FMA (the price never
    materializes), and seed 2 at 4096 x 256 then differs (ROADMAP C)."""
    arrays, constraints, rules = _dense_args(P, N, seed)
    want = jtensor.solve_sparse(*arrays, constraints, rules, k=16,
                                record=False, sparse_impl="interpret")
    if seed != 2:
        assert np.array_equal(want, jtensor.solve_sparse(
            *arrays, constraints, rules, k=16, record=False))
    stats = {}
    got = ttensor.solve_sparse(*bt.problem_to_torch(*arrays, device="cpu"),
                               constraints, rules, k=16, stats=stats)
    assert np.array_equal(got, want), _first_diff(got, want)
    assert stats["k"] == 16 and stats["sweeps"] >= 2
    assert (got != arrays[0]).any()  # the delta really moved copies
    assert check_assignment(_problem(arrays, constraints, rules),
                            got) == CLEAN


@pytest.mark.parametrize("k_over", [0, 7])
@pytest.mark.parametrize("seed", range(3))
def test_saturating_k_equals_dense(seed, k_over):
    """K >= N is bitwise the port's dense matrix engine."""
    P, N = 1024, 64
    arrays, constraints, rules = _dense_args(P, N, seed)
    args = bt.problem_to_torch(*arrays, device="cpu")
    dense = bt.solve_dense_converged(*args, constraints, rules).numpy()
    stats = {}
    sparse = ttensor.solve_sparse(*args, constraints, rules, k=N + k_over,
                                  stats=stats)
    assert stats["k"] == N and stats["exhausted_rows"] == 0
    assert np.array_equal(sparse, dense), _first_diff(sparse, dense)


def test_rule_less_and_two_rule_solves_match_jax():
    arrays, constraints, _ = _dense_args(1024, 64, 1)
    for rules, k in ((((), ()), 8), (((), ((2, 1),)), 4)):
        want = jtensor.solve_sparse(*arrays, constraints, rules, k=k,
                                    record=False)
        got = ttensor.solve_sparse(
            *bt.problem_to_torch(*arrays, device="cpu"), constraints, rules,
            k=k)
        assert np.array_equal(got, want), _first_diff(got, want)


def test_all_candidates_excluded_row_falls_back_dense():
    """The reference's fixture: row 0's shortlist holds only removed
    nodes, so it is flagged, re-placed densely on live nodes, and every
    other row keeps its sparse result; the port matches bit for bit."""
    P, N = 64, 16
    arrays, cons, rules = _dense_args(P, N, 8, rack=5, remove_frac=0,
                                      weights=False)
    prev, pw, nw, valid, stick, gids, gv = arrays
    valid = valid.copy()
    valid[0] = valid[1] = False
    arrays = (prev, pw, nw, valid, stick, gids, gv)
    shortlist = np.asarray(jshortlist.build_shortlist(
        prev, pw, nw, valid, gids, gv, cons, rules, 6)).copy()
    shortlist[0] = -1
    shortlist[0, :2] = [0, 1]
    want = jtensor.solve_sparse(*arrays, cons, rules,
                                shortlist=jnp.asarray(shortlist),
                                record=False)
    stats = {}
    got = ttensor.solve_sparse(*bt.problem_to_torch(*arrays, device="cpu"),
                               cons, rules, shortlist=shortlist, stats=stats)
    assert np.array_equal(got, want), _first_diff(got, want)
    assert stats["exhausted_rows"] >= 1 and stats["fallback_rows"] >= 1
    assert (got[0] >= 0).all() and valid[got[0].ravel()].all()
    assert check_assignment(_problem(arrays, cons, rules), got) == CLEAN


@pytest.mark.parametrize("cells", [None, 40])
def test_fallback_in_chunks_matches_jax(monkeypatch, cells):
    """K = 1 cannot serve two exclusive slots, so the fallback places
    many rows; scoring a slot's rows in chunks (here 2 rows of 20 nodes
    per chunk) changes nothing."""
    if cells is not None:
        monkeypatch.setattr(ttensor, "_FALLBACK_CELLS", cells)
    arrays, cons, rules = _dense_args(96, 20, 6, rack=5)
    want = jtensor.solve_sparse(*arrays, cons, rules, k=1, record=False)
    stats = {}
    got = ttensor.solve_sparse(*bt.problem_to_torch(*arrays, device="cpu"),
                               cons, rules, k=1, stats=stats)
    assert np.array_equal(got, want), _first_diff(got, want)
    assert stats["fallback_rows"] > 10
    assert check_assignment(_problem(arrays, cons, rules), got) == CLEAN


def test_sparse_requires_nesting_rules():
    arrays, cons, _ = _dense_args(32, 8, 0)
    bad = ((), ((1, 2),))  # exclude coarser than include
    args = bt.problem_to_torch(*arrays, device="cpu")
    with pytest.raises(ValueError, match="nesting"):
        ttensor.solve_sparse(*args, cons, bad, k=4)
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="nesting"):
        ttensor._sparse_selected(bt.PlanOptions(sparse=True), 32, 8, bad,
                                 cpu)
    # Auto (sparse=None) declines exotic rules instead of raising.
    assert not ttensor._sparse_selected(bt.PlanOptions(), 10**6, 10**5, bad,
                                        cpu)
    assert ttensor._sparse_selected(bt.PlanOptions(), 10**6, 10**5,
                                    ((), ((2, 1),)), cpu)


def test_unported_sparse_options_raise():
    """p_real (shape bucketing), the last option refused until A.13,
    solves as the reference's kernel route does; the warm ones
    (carry_used, return_carry) run (tests/test_torch_warm.py holds them
    against the reference)."""
    arrays, cons, rules = _dense_args(32, 8, 0)
    args = bt.problem_to_torch(*arrays, device="cpu")
    want = jtensor.solve_sparse(*[jnp.asarray(a) for a in arrays], cons,
                                rules, k=4, p_real=32, record=False,
                                sparse_impl="interpret")
    got = ttensor.solve_sparse(*args, cons, rules, k=4, p_real=32,
                               record=False)
    np.testing.assert_array_equal(got, want)
    out, carry = ttensor.solve_sparse(*args, cons, rules, k=4,
                                      return_carry=True)
    seeded = ttensor.solve_sparse(*args, cons, rules, k=4,
                                  carry_used=ttensor.carry_from_assignment(
                                      args[0], args[1], args[2]).used)
    assert np.array_equal(seeded, out)
    assert np.array_equal(carry.assign.numpy(), out)


# --- plan_next_map, map for map --------------------------------------------------------


def _rack_delta(lib):
    rng = np.random.default_rng(0)
    nodes = [f"n{i:03d}" for i in range(100)]
    hier = {nd: f"r{i // 5:02d}" for i, nd in enumerate(nodes)}
    hier.update({f"r{i:02d}": "z0" for i in range(20)})
    prev = {}
    for p in range(600):
        a = int(rng.integers(0, 100))
        b = (a + 1 + int(rng.integers(0, 99))) % 100
        prev[str(p)] = lib.Partition(
            str(p), {"primary": [nodes[a]], "replica": [nodes[b]]})
    removed = [nodes[i] for i in rng.choice(100, 5, replace=False)]
    opts = dict(node_hierarchy=hier, hierarchy_rules={
        "replica": [lib.HierarchyRule(2, 1)]})
    return prev, nodes, removed, dict(primary=(0, 1), replica=(1, 1)), opts


def _multi_state(lib):
    nodes = [f"m{i:02d}" for i in range(16)]
    prev = {str(p): lib.Partition(str(p), {}) for p in range(300)}
    return prev, nodes, [], dict(primary=(0, 1), replica=(1, 2),
                                 readonly=(2, 1)), {}


def _plan_both(fixture, **opt_kw):
    prev, nodes, removed, states, spec = fixture(blance_tpu)
    want = blance_tpu.plan_next_map(
        prev, prev, nodes, removed, [], blance_tpu.model(**states),
        blance_tpu.PlanOptions(**spec, **opt_kw), backend="tpu")
    tprev, nodes, removed, states, tspec = fixture(bt)
    timings = {}
    got = bt.plan_next_map(
        tprev, tprev, nodes, removed, [], bt.model(**states),
        bt.PlanOptions(**tspec, **opt_kw), backend="cuda", device="cpu",
        timings=timings)
    assert bt.partition_map_to_json(got[0]) == \
        blance_tpu.partition_map_to_json(want[0])
    assert got[1] == want[1]
    return timings


@pytest.mark.parametrize("fixture,k", [(_rack_delta, None), (_rack_delta, 6),
                                       (_multi_state, 5)])
def test_plan_next_map_sparse_matches_jax(fixture, k):
    timings = _plan_both(fixture, sparse=True, sparse_k=k)
    assert timings["engine"] == "sparse"
    assert timings["k"] == (k or 16)
    for key in ("shortlist_s", "exhausted_rows", "fallback_rows", "sweeps",
                "launches"):
        assert key in timings, key


def test_auto_routes_to_sparse_past_budget():
    """sparse=None picks the sparse engine exactly when the matrix
    engine's projection exceeds the budget (rules nest), on both sides."""
    projected = ttensor.projected_score_bytes(600, 100)
    try:
        jtensor.set_dense_score_budget(projected - 1)
        bt.set_dense_score_budget(projected - 1)
        timings = _plan_both(_rack_delta)
        assert timings["engine"] == "sparse"
    finally:
        jtensor.set_dense_score_budget(None)
        bt.set_dense_score_budget(None)
    assert ttensor.dense_score_budget_bytes(torch.device("cpu")) == \
        int(0.6 * 16 * 2 ** 30)
    assert _plan_both(_rack_delta)["engine"] == "matrix"
