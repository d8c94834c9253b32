"""Shape bucketing and the traced ``p_real`` in the port, against the JAX
package on the CPU.

``PlanOptions.shape_bucketing`` pads a plan to (bucket_size(P),
bucket_size(N)) with inert rows and columns and passes the real P to the
solver as ``p_real``, the fill term's denominator.  Under jit the
reference divides ``(0.001 * total / max(p_real, 1)) / w_div`` as ONE
division by the product, ``(fl32(0.001) * total) / (max(p_real, 1) *
w_div)``; the port spells that form (``ops/score_fused.fill_term``).
Each site that builds the term is pinned here against the values the
reference's real solve computes, captured inside it: the matrix build,
``score_at_columns``, the fused kernel's ``base`` and the sparse
columns.  Bucketed plans and pipelines on the three engines, and every
entry that takes ``p_real``, must equal the reference's.  Fixtures stay
at P <= 4096; node weights other than 1 are held against the
reference's kernel route (ROADMAP C).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import blance_tpu as jb  # noqa: E402
import blance_tpu.obs as jobs  # noqa: E402
import blance_tpu_torch as bt  # noqa: E402
import blance_tpu_torch.obs as tobs  # noqa: E402
from blance_tpu.core import encode as jencode  # noqa: E402
from blance_tpu.obs.sinks import InMemorySink as JSink  # noqa: E402
from blance_tpu.ops import reduce2 as jreduce2  # noqa: E402
from blance_tpu.ops import score_fused as jscore  # noqa: E402
from blance_tpu.ops import sparse2 as jsparse2  # noqa: E402
from blance_tpu.plan import tensor as jtensor  # noqa: E402
from blance_tpu_torch.core import encode as tencode  # noqa: E402
from blance_tpu_torch.obs.sinks import InMemorySink as TSink  # noqa: E402
from blance_tpu_torch.plan import tensor as ttensor  # noqa: E402
from test_fleet import make_tenant  # noqa: E402
from test_torch_sparse import _dense_args  # noqa: E402
from _port_telemetry import SOLVER, port_names, ref_view  # noqa: E402

STATES = dict(primary=(0, 1), replica=(1, 1))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(arrays):
    return bt.problem_to_torch(*arrays, device="cpu")


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _pr(p):
    """p_real for each package: the reference's device scalar, the
    port's 0-d float32 tensor."""
    return jax.device_put(np.float32(p)), torch.tensor(np.float32(p))


def _first_diff(got, want):
    return f"first differing [p, s, r]: {np.argwhere(got != want)[:3].tolist()}"


def _padded(arrays, p=None, n=None):
    p = p or jencode.bucket_size(arrays[0].shape[0])
    n = n or jencode.bucket_size(arrays[2].shape[0])
    return tencode.pad_problem_arrays(*arrays, p, n)


# --- the helpers -----------------------------------------------------------------


def test_bucket_size_ladder():
    """The port's ladder is the reference's, and keeps its promises
    (tests/test_warm_replan.py::test_bucket_size_ladder)."""
    for x in list(range(0, 600)) + [998, 1000, 1007, 4093, 12_345, 100_000,
                                    1_000_000, 10_000]:
        assert tencode.bucket_size(x) == jencode.bucket_size(x), x
        assert tencode.bucket_size(x, 4) == jencode.bucket_size(x, 4), x
    assert tencode.bucket_size(1000) == tencode.bucket_size(1007) == \
        tencode.bucket_size(998)
    for x in (9, 100, 513, 12_345, 100_000):
        assert x <= tencode.bucket_size(x) <= x * 1.125 + 1
    assert [tencode.bucket_size(x) for x in range(9)] == list(range(9))
    assert tencode.bucket_size(100_000) == 106_496
    assert tencode.bucket_size(10_000) == 10_240
    assert tencode.bucket_size(1_000_000) == 1_048_576


def test_pad_problem_arrays_match_reference():
    arrays, _, _ = _dense_args(37, 11, 2)
    for p, n in ((40, 12), (37, 11), (64, 16)):
        got = tencode.pad_problem_arrays(*arrays, p, n)
        want = jencode.pad_problem_arrays(*arrays, p, n)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert tencode.pad_to(arrays[0], 0, 10, -1) is arrays[0]


# --- the fill term at each site of a real solve --------------------------------


def _capture_ref(monkeypatch, engine, run):
    """Values the reference's real solve on ``engine`` computes where the
    fill term enters, captured inside the jitted program with debug
    callbacks: {site: [array per call]}."""
    got: dict = {}

    def cb(site):
        return lambda x: got.setdefault(site, []).append(np.array(x))

    if engine == "matrix":
        def min2(score, price, **kw):
            jax.debug.callback(cb("matrix"), score)
            return jreduce2.priced_min2_argmin(score, price, interpret=True)
        monkeypatch.setattr(jtensor, "pallas_available", lambda: True)
        monkeypatch.setattr(jtensor, "priced_min2_argmin", min2)
    elif engine == "fused":
        def fused(price, si, *a, **kw):
            jax.debug.callback(cb("fused_base"), si.base)
            return jscore.fused_score_min2(price, si, *a, **kw)

        def at_cols(rows, cols, **kw):
            out = jscore.score_at_columns(rows, cols, **kw)
            jax.debug.callback(cb("score_at_columns"), out)
            return out
        monkeypatch.setattr(jtensor, "fused_score_min2", fused)
        monkeypatch.setattr(jtensor, "score_at_columns", at_cols)
    else:
        def sparse(score, price, **kw):
            jax.debug.callback(cb("sparse"), score)
            return jsparse2.sparse_priced_min2(score, price, **kw)
        monkeypatch.setattr(jtensor, "sparse_priced_min2", sparse)
    jax.clear_caches()
    try:
        run()
        jax.effects_barrier()
    finally:
        jax.clear_caches()
    return got


def _capture_port(monkeypatch, engine, run):
    got: dict = {}

    def spy(name, site, pick):
        orig = getattr(ttensor, name)

        def wrapper(*args, **kw):
            out = orig(*args, **kw)
            got.setdefault(site, []).append(
                pick(args, out).numpy().copy())
            return out
        monkeypatch.setattr(ttensor, name, wrapper)

    if engine == "matrix":
        spy("priced_min2_argmin", "matrix", lambda a, out: a[0])
    elif engine == "fused":
        spy("fused_score_min2", "fused_base", lambda a, out: a[1].base)
        spy("score_cells", "score_at_columns", lambda a, out: out)
    else:
        spy("sparse_priced_min2_cand", "sparse", lambda a, out: a[0])
    run()
    return got


@pytest.mark.parametrize("variant", ["constant", "p_real", "p_real_padded"])
@pytest.mark.parametrize("engine", ["matrix", "fused", "sparse"])
def test_fill_term_matches_reference_solve(monkeypatch, engine, variant):
    """Every value the fill term feeds, in every call of a two-sweep
    solve with weighted partitions AND nodes, equals the value the
    reference's own solve computed there, bit for bit, at each site: the
    matrix build (matrix engine), the fused kernel's ``base`` and
    ``score_at_columns`` (fused engine), the sparse columns (sparse
    engine); with P a constant (``fill_scale``), with a traced ``p_real``
    and with ``p_real`` on bucket-padded arrays (``fill_term``'s one
    division)."""
    arrays, cons, rules = _dense_args(300, 37, 2)
    P = arrays[0].shape[0]
    if variant == "p_real_padded":
        arrays = _padded(arrays)
    jp, tp = _pr(P) if variant != "constant" else (None, None)

    def ref():
        if engine == "sparse":
            jtensor.solve_sparse(*_j(arrays), cons, rules, k=8, p_real=jp,
                                 max_iterations=2, record=False,
                                 sparse_impl="interpret")
        else:
            jtensor.solve_dense_converged(
                *_j(arrays), cons, rules, max_iterations=2, record=False,
                fused_score="off" if engine == "matrix" else "interpret",
                p_real=jp)

    def port():
        if engine == "sparse":
            ttensor.solve_sparse(*_t(arrays), cons, rules, k=8, p_real=tp,
                                 max_iterations=2, record=False)
        else:
            ttensor.solve_dense_converged(
                *_t(arrays), cons, rules, max_iterations=2, record=False,
                fused_score="off" if engine == "matrix" else "on", p_real=tp)

    want = _capture_ref(monkeypatch, engine, ref)
    got = _capture_port(monkeypatch, engine, port)
    assert sorted(got) == sorted(want) and want
    for site in want:
        assert len(got[site]) == len(want[site]) > 0, site
        for i, (g, w) in enumerate(zip(got[site], want[site])):
            assert g.shape == w.shape, (site, i, g.shape, w.shape)
            bad = np.argwhere(g != w)
            assert bad.size == 0, (site, variant, i, len(bad),
                                   bad[:3].tolist())


def test_fill_term_forms():
    """fill_term's two forms: a Python count multiplies by fill_scale, a
    0-d tensor divides once by the product (not twice)."""
    from blance_tpu_torch.ops.score_fused import fill_scale, fill_term

    rng = np.random.default_rng(0)
    total = torch.from_numpy(rng.integers(0, 5000, 4096).astype(np.float32))
    w = torch.from_numpy(rng.integers(1, 4, 4096).astype(np.float32))
    p = 4093
    assert torch.equal(fill_term(total, p, w), (total * fill_scale(p)) / w)
    one = (total * float(np.float32(0.001))) / (float(p) * w)
    got = fill_term(total, torch.tensor(np.float32(p)), w)
    assert torch.equal(got, one)
    two = ((total * float(np.float32(0.001))) / float(p)) / w
    assert not torch.equal(got, two)
    # max(p_real, 1): a zero count divides by the node weight alone.
    assert torch.equal(fill_term(total, torch.tensor(0.0), w),
                       (total * float(np.float32(0.001))) / w)


# --- the entries that take p_real ------------------------------------------------


@pytest.mark.parametrize("engine,ref_engine", [("off", "off"),
                                               ("on", "interpret")],
                         ids=["matrix", "fused"])
def test_padding_is_bit_neutral_on_real_rows(engine, ref_engine):
    """tests/test_fleet.py::test_bucket_padding_is_bit_neutral_on_real_rows
    on the port, its three fixtures: the unpadded solve with the real-P
    p_real and the padded one agree on the real rows; on the first
    fixture both equal the reference's."""
    for i, (P, N, seed) in enumerate([(17, 9, 0), (19, 9, 1), (15, 10, 2)]):
        t = make_tenant(P, N, seed, weights=True)
        args = (t.prev, t.partition_weights, t.node_weights, t.valid_node,
                t.stickiness, t.gids, t.gid_valid)
        padded = _padded(args, jencode.bucket_size(P) + 3,
                         jencode.bucket_size(N) + 2)
        jp, tp = _pr(P)
        outs = []
        for arrs in (args, padded):
            got, _ = ttensor._solve_dense_converged_impl(
                *_t(arrs), t.constraints, t.rules, max_iterations=10,
                fused_score=engine, p_real=tp)
            got = got.numpy()[:P]
            if i == 0:
                want, _ = jtensor._solve_dense_converged_impl(
                    *_j(arrs), t.constraints, t.rules, max_iterations=10,
                    fused_score=ref_engine, p_real=jp)
                want = np.asarray(want)[:P]
                np.testing.assert_array_equal(got, want,
                                              _first_diff(got, want))
            outs.append(got)
        np.testing.assert_array_equal(outs[0], outs[1], (P, N))


@pytest.mark.parametrize("p_real", [None, 300], ids=["constant", "p_real"])
def test_converged_sweeps_match_reference(p_real):
    """The fixpoint's map and its sweep count, unpadded with the folded
    fill constant and padded with p_real, equal the reference's."""
    arrays, cons, rules = _dense_args(300, 37, 1)
    if p_real is not None:
        arrays = _padded(arrays)
    jp, tp = _pr(p_real) if p_real else (None, None)
    want = jtensor._solve_dense_converged_impl(
        *_j(arrays), cons, rules, max_iterations=4, p_real=jp)
    got = ttensor._solve_dense_converged_impl(
        *_t(arrays), cons, rules, max_iterations=4, p_real=tp)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1] == int(want[1]) > 1


def _warm_case(seed, P=300, N=37):
    """A converged padded cold solve with p_real, one node removed, the
    rows that held it dirty."""
    arrays, cons, rules = _dense_args(P, N, seed)
    padded = _padded(arrays)
    jp, _ = _pr(P)
    cold = np.asarray(jtensor.solve_dense_converged(
        *_j(padded), cons, rules, record=False, p_real=jp))
    victim = int(cold[0, 0, 0])
    valid = padded[3].copy()
    valid[victim] = False
    dirty = (cold == victim).any(axis=(1, 2))
    return (cold,) + padded[1:3] + (valid,) + padded[4:], cons, rules, \
        dirty, P


@pytest.mark.parametrize("engine,ref_engine", [("off", "off"),
                                               ("on", "interpret")],
                         ids=["matrix", "fused"])
@pytest.mark.parametrize("seed", [0, 3])
def test_solve_dense_warm_with_p_real_matches_reference(seed, engine,
                                                         ref_engine):
    arrays, cons, rules, dirty, P = _warm_case(seed)
    jp, tp = _pr(P)
    jc = jtensor.carry_from_assignment(*_j(arrays[:3]))
    jrec, trec = jobs.Recorder(), tobs.Recorder()
    with jobs.use_recorder(jrec):
        want, want_carry = jtensor.solve_dense_warm(
            *arrays, cons, rules, dirty=dirty, carry=jc, p_real=jp,
            fused_score=ref_engine)
    with tobs.use_recorder(trec):
        got, got_carry = ttensor.solve_dense_warm(
            *_t(arrays), cons, rules, dirty=dirty,
            carry=bt.carry_to_torch(jc, "cpu"), p_real=tp,
            fused_score=engine)
    assert (got is None) == (want is None)
    assert ref_view(trec.counters) == jrec.counters
    assert port_names(trec.counters) == SOLVER
    if want is not None:
        np.testing.assert_array_equal(got, want, _first_diff(got, want))
        np.testing.assert_array_equal(got_carry.used.numpy(),
                                      np.asarray(want_carry.used))


@pytest.mark.parametrize("impl,seed", [("interpret", 2), ("interpret", 0),
                                       ("xla", 0)])
def test_solve_sparse_with_p_real_matches_reference(impl, seed):
    """The padded sparse solve with p_real: against the reference's kernel
    route, and its XLA route where node weights are 1 (seed 0)."""
    arrays, cons, rules = _dense_args(300, 37, seed)
    P = arrays[0].shape[0]
    padded = _padded(arrays)
    jp, tp = _pr(P)
    want = jtensor.solve_sparse(*_j(padded), cons, rules, k=8, p_real=jp,
                                record=False, sparse_impl=impl)
    got = ttensor.solve_sparse(*_t(padded), cons, rules, k=8, p_real=tp,
                               record=False)
    np.testing.assert_array_equal(got, want, _first_diff(got, want))


@pytest.mark.parametrize("seed", [0, 2])
def test_solve_sparse_warm_with_p_real_matches_reference(seed):
    arrays, cons, rules, dirty, P = _warm_case(seed)
    jp, tp = _pr(P)
    jc = jtensor.carry_from_assignment(*_j(arrays[:3]))
    want, _ = jtensor.solve_sparse_warm(
        *arrays, cons, rules, dirty=dirty, carry=jc, k=8, p_real=jp,
        record=False, sparse_impl="interpret")
    got, _ = ttensor.solve_sparse_warm(
        *_t(arrays), cons, rules, dirty=dirty,
        carry=bt.carry_to_torch(jc, "cpu"), k=8, p_real=tp, record=False)
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got, want, _first_diff(got, want))


# --- bucketed plans and pipelines --------------------------------------------------


def _mk_map(lib, P, N, seed):
    rng = np.random.default_rng(seed)
    nodes = [f"n{i:03d}" for i in range(N)]
    p_ids = rng.integers(0, N, P)
    r_ids = (p_ids + 1 + rng.integers(0, N - 1, P)) % N
    prev = {str(i): lib.Partition(str(i), {"primary": [nodes[p_ids[i]]],
                                           "replica": [nodes[r_ids[i]]]})
            for i in range(P)}
    return prev, nodes


def _opts(lib, nodes, engine, **kw):
    hier = {n: f"r{i // 4}" for i, n in enumerate(nodes)}
    hier.update({f"r{i}": "z0" for i in range((len(nodes) + 3) // 4)})
    if engine == "sparse":
        kw.update(sparse=True, sparse_k=8)
    return lib.PlanOptions(
        node_hierarchy=hier, shape_bucketing=True,
        hierarchy_rules={"replica": [lib.HierarchyRule(2, 1)]}, **kw)


@pytest.fixture
def engine_default(request):
    """Select the dense engine on both sides (fused: the port's plain
    version, the reference's kernel in interpret mode)."""
    engine = request.param
    if engine == "fused":
        ttensor.set_fused_score_default("on")
        jtensor.set_fused_score_default("interpret")
    yield engine
    ttensor.set_fused_score_default("auto")
    jtensor.set_fused_score_default("auto")


def _nbs(pmap):
    return {k: p.nodes_by_state for k, p in pmap.items()}


def _ops(moves):
    return {k: [(m.node, m.state, m.op) for m in ms]
            for k, ms in moves.items()}


ENGINES = ["matrix", "fused", "sparse"]
SIZE = (300, 37, 5)  # off-bucket: solved at (320, 40)


@pytest.mark.parametrize("engine_default", ENGINES, indirect=True)
def test_bucketed_plan_matches_reference(engine_default):
    """plan_next_map(shape_bucketing=True) on each engine: map and
    warnings equal to the reference's bucketed backend="tpu", the
    padded shape recorded on plan.solve, no pad node in the map."""
    engine = engine_default
    P, N, seed = SIZE
    out = {}
    for name, lib, obs, sink_cls, kw in (
            ("ref", jb, jobs, JSink, dict(backend="tpu")),
            ("port", bt, tobs, TSink, dict(device="cpu"))):
        prev, nodes = _mk_map(lib, P, N, seed)
        rec, sink = obs.Recorder(), sink_cls()
        rec.add_sink(sink)
        with obs.use_recorder(rec):
            res = lib.plan_next_map(prev, prev, nodes, [nodes[3]], [],
                                    lib.model(**STATES),
                                    _opts(lib, nodes, engine), **kw)
        (solve,) = sink.by_name("plan.solve")
        out[name] = (res, tuple(solve.attrs["bucketed_shape"]),
                     solve.attrs.get("engine"))
    (rmap, rwarn), rshape, reng = out["ref"]
    (pmap, pwarn), pshape, peng = out["port"]
    assert _nbs(pmap) == _nbs(rmap) and pwarn == rwarn
    assert pshape == rshape == (320, 40)
    assert peng == {"matrix": "matrix", "fused": "fused",
                    "sparse": "sparse"}[engine]
    placed = {n for p in pmap.values() for ns in p.nodes_by_state.values()
              for n in ns}
    assert placed <= set(_mk_map(bt, P, N, seed)[1])


@pytest.mark.parametrize("engine_default", ENGINES, indirect=True)
def test_bucketed_pipeline_matches_reference(engine_default):
    """plan_pipeline(shape_bucketing=True): map, warnings and moves equal
    to the reference's bucketed pipeline and to the port's staged
    bucketed plan + calc_all_moves."""
    engine = engine_default
    P, N, seed = SIZE
    out = []
    for lib, pipe, kw in ((jb, jtensor.plan_pipeline, {}),
                          (bt, ttensor.plan_pipeline, dict(device="cpu"))):
        prev, nodes = _mk_map(lib, P, N, seed)
        out.append(pipe(prev, prev, nodes, [nodes[3]], [],
                        lib.model(**STATES), _opts(lib, nodes, engine),
                        **kw))
    assert _nbs(out[1][0]) == _nbs(out[0][0]) and out[1][1] == out[0][1]
    assert _ops(out[1][2]) == _ops(out[0][2])
    prev, nodes = _mk_map(bt, P, N, seed)
    staged, swarn = bt.plan_next_map(prev, prev, nodes, [nodes[3]], [],
                                     bt.model(**STATES),
                                     _opts(bt, nodes, engine), device="cpu")
    moves = bt.calc_all_moves(prev, staged, bt.model(**STATES), device="cpu")
    assert _nbs(staged) == _nbs(out[1][0]) and swarn == out[1][1]
    assert _ops(moves) == _ops(out[1][2])


def test_shape_bucketing_contract_equivalent():
    """tests/test_warm_replan.py::test_shape_bucketing_contract_equivalent
    on the port: deterministic, audit-clean, no pad node, balance as
    tight as the unbucketed solve; and equal to the reference's map."""
    from blance_tpu_torch.plan.audit import check_assignment

    model = bt.model(**STATES)
    nodes = [f"n{i}" for i in range(13)]  # deliberately off-bucket
    parts = {str(i): bt.Partition(str(i), {}) for i in range(100)}
    opts_b = bt.PlanOptions(shape_bucketing=True)
    bucketed, warn = bt.plan_next_map(parts, parts, nodes, [], [], model,
                                      opts_b, device="cpu")
    assert not warn
    again, _ = bt.plan_next_map(parts, parts, nodes, [], [], model, opts_b,
                                device="cpu")
    assert _nbs(bucketed) == _nbs(again)
    placed = {n for p in bucketed.values()
              for ns in p.nodes_by_state.values() for n in ns}
    assert placed <= set(nodes)
    prob = bt.encode_problem(parts, parts, nodes, [], model, bt.PlanOptions())
    nidx = {n: i for i, n in enumerate(nodes)}
    assign = np.full((100, prob.S, prob.R), -1, np.int32)
    order = {p: i for i, p in enumerate(prob.partitions)}
    for pname, part in bucketed.items():
        for s, ns in part.nodes_by_state.items():
            for ri, node in enumerate(ns):
                assign[order[pname], prob.states.index(s), ri] = nidx[node]
    report = check_assignment(prob, assign)
    assert not any(report.values()), report
    counts = np.bincount(assign[assign >= 0], minlength=13)
    plain, _ = bt.plan_next_map(parts, parts, nodes, [], [], model,
                                bt.PlanOptions(), device="cpu")
    pc = np.zeros(13, int)
    for p in plain.values():
        for ns in p.nodes_by_state.values():
            for n in ns:
                pc[nidx[n]] += 1
    assert counts.max() - counts.min() <= (pc.max() - pc.min()) + 2
    jparts = {str(i): jb.Partition(str(i), {}) for i in range(100)}
    ref, _ = jb.plan_next_map(jparts, jparts, nodes, [], [],
                              jb.model(**STATES),
                              jb.PlanOptions(shape_bucketing=True),
                              backend="tpu")
    assert _nbs(bucketed) == _nbs(ref)


def test_bucketed_plan_routes_sparse_at_the_padded_shape():
    """The engine is chosen at the padded shape: a budget between the
    real and the padded matrix footprint routes sparse=None to the
    sparse engine only when bucketing is on (the reference's rule)."""
    P, N, seed = SIZE
    prev, nodes = _mk_map(bt, P, N, seed)
    real = ttensor.projected_score_bytes(P, N)
    ttensor.set_dense_score_budget(real + 1)
    try:
        for bucketing, want in ((False, "matrix"), (True, "sparse")):
            timings = {}
            opts = bt.PlanOptions(shape_bucketing=bucketing, sparse_k=8)
            bt.plan_next_map(prev, prev, nodes, [], [], bt.model(**STATES),
                             opts, device="cpu", timings=timings)
            assert timings["engine"] == want, bucketing
    finally:
        ttensor.set_dense_score_budget(None)
