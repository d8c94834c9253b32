"""The port's fused plan pipeline against the JAX package, on the CPU.

``plan_pipeline`` and ``PlannerSession.replan_with_moves`` run the solve,
the move diff and the decode pack on the device and bring their outputs
back in one copy.  Each test runs the same inputs through the reference's
pipeline (under XLA on the CPU; its fused engine in interpret mode) and
through the port's (``device="cpu"``, every kernel on its plain version),
and through the port's staged path (``plan_next_map`` and
``calc_all_moves``, or ``replan()`` and ``moves()``): maps, warnings,
move lists, proposed assignments, move arrays and the ``plan.*``
counters must be equal, exactly (the fixtures use whole-number weights).

The reference's donation test (``test_donated_buffers_invalidated_after_
dispatch``) is not ported: torch has no buffer donation, and the port
uses the uploaded ``prev`` tensor as the diff's beginning state without
copying it.  Its sharded-pipeline and mesh tests are held against the
port's in tests/test_torch_sharded_paths.py and
tests/test_torch_sharded.py, and its bucketed and exact-fallback tests
are held against the port's in
tests/test_torch_bucketing.py and tests/test_torch_exact.py (and here,
once each).
"""

import asyncio
import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import blance_tpu  # noqa: E402
import blance_tpu.obs as jobs  # noqa: E402
import blance_tpu_torch as bt  # noqa: E402
import blance_tpu_torch.obs as tobs  # noqa: E402
from blance_tpu.plan import tensor as jtensor  # noqa: E402
from blance_tpu.plan.session import PlannerSession as JSession  # noqa: E402
from blance_tpu_torch.core import encode as tencode  # noqa: E402
from blance_tpu_torch.plan import tensor as ttensor  # noqa: E402

REF = dict(lib=blance_tpu, obs=jobs, session=JSession, kw={},
           pipeline=jtensor.plan_pipeline)
PORT = dict(lib=bt, obs=tobs, session=bt.PlannerSession,
            kw=dict(device="cpu"), pipeline=ttensor.plan_pipeline)
STATES = dict(primary=(0, 1), replica=(1, 1))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mk_map(lib, P, N, seed=0):
    """The reference test's map: a primary and a replica on another node,
    for P partitions over N nodes."""
    rng = np.random.default_rng(seed)
    nodes = [f"n{i:03d}" for i in range(N)]
    p_ids = rng.integers(0, N, P)
    r_ids = (p_ids + 1 + rng.integers(0, N - 1, P)) % N
    prev = {str(i): lib.Partition(str(i), {"primary": [nodes[p_ids[i]]],
                                           "replica": [nodes[r_ids[i]]]})
            for i in range(P)}
    return prev, nodes


def _rack_opts(lib, nodes, **kw):
    hier = {n: f"r{i // 4}" for i, n in enumerate(nodes)}
    hier.update({f"r{i}": "z0" for i in range((len(nodes) + 3) // 4)})
    return lib.PlanOptions(
        node_hierarchy=hier,
        hierarchy_rules={"replica": [lib.HierarchyRule(2, 1)]}, **kw)


def _flat_opts(lib, nodes, **kw):
    return lib.PlanOptions(**kw)


def _nbs(pmap):
    return {k: p.nodes_by_state for k, p in pmap.items()}


def _ops(moves):
    return {k: [(m.node, m.state, m.op) for m in ms]
            for k, ms in moves.items()}


def _plan_counters(rec):
    return {k: v for k, v in rec.counters.items() if k.startswith("plan.")}


def _pipeline(pkg, P, N, seed, removed_ids, opts_fn, **kw):
    """plan_pipeline of ``pkg`` on the _mk_map fixture under a fresh
    recorder; returns (map, warnings, moves, recorder)."""
    lib = pkg["lib"]
    prev, nodes = _mk_map(lib, P, N, seed)
    rec = pkg["obs"].Recorder()
    with pkg["obs"].use_recorder(rec):
        out = pkg["pipeline"](
            prev, prev, nodes, [nodes[i] for i in removed_ids], [],
            lib.model(**STATES), opts_fn(lib, nodes), **kw,
            **pkg["kw"])
    return (*out, rec)


def _staged(P, N, seed, removed_ids, opts_fn, favor_min_nodes=False):
    """The port's staged path on the same fixture: plan_next_map, then
    calc_all_moves from the seeded beginning map."""
    prev, nodes = _mk_map(bt, P, N, seed)
    model = bt.model(**STATES)
    smap, swarn = bt.plan_next_map(prev, prev, nodes,
                                   [nodes[i] for i in removed_ids], [],
                                   model, opts_fn(bt, nodes), device="cpu")
    moves = bt.calc_all_moves(prev, smap, model, favor_min_nodes,
                              device="cpu")
    return smap, swarn, moves


def _assert_same(ref, port, staged=None):
    assert _nbs(port[0]) == _nbs(ref[0])
    assert port[1] == ref[1]
    assert _ops(port[2]) == _ops(ref[2])
    if staged is not None:
        assert _nbs(staged[0]) == _nbs(port[0])
        assert staged[1] == port[1]
        assert _ops(staged[2]) == _ops(port[2])


# --- plan_pipeline == staged path == reference -----------------------------------


@pytest.mark.parametrize("opts_fn", [_rack_opts, _flat_opts],
                         ids=["rack-rules", "flat"])
def test_plan_pipeline_identical_to_staged(opts_fn):
    ref = _pipeline(REF, 96, 12, 1, [3], opts_fn)
    port = _pipeline(PORT, 96, 12, 1, [3], opts_fn)
    _assert_same(ref, port, _staged(96, 12, 1, [3], opts_fn))
    assert _plan_counters(port[3]) == _plan_counters(ref[3])
    assert sorted(port[3].span_counts) == sorted(ref[3].span_counts)
    assert port[3].counters["plan.pipeline.calls"] == 1


def test_plan_pipeline_favor_min_nodes_order():
    ref = _pipeline(REF, 48, 8, 7, [0], _flat_opts, favor_min_nodes=True)
    port = _pipeline(PORT, 48, 8, 7, [0], _flat_opts, favor_min_nodes=True)
    _assert_same(ref, port,
                 _staged(48, 8, 7, [0], _flat_opts, favor_min_nodes=True))
    # The two emission orders really differ on this fixture.
    plain = _pipeline(PORT, 48, 8, 7, [0], _flat_opts)
    assert _ops(plain[2]) != _ops(port[2])


def test_plan_next_map_fused_pipeline_option():
    """plan_next_map with PlanOptions.fused_pipeline rides the pipeline and
    stays bitwise the staged plan_next_map (and the reference's)."""
    prev, nodes = _mk_map(bt, 64, 8, seed=4)
    jprev, _ = _mk_map(blance_tpu, 64, 8, seed=4)
    model = bt.model(**STATES)
    smap, swarn = bt.plan_next_map(prev, prev, nodes, [nodes[2]], [], model,
                                   _rack_opts(bt, nodes), device="cpu")
    rec = tobs.Recorder()
    with tobs.use_recorder(rec):
        fmap, fwarn = bt.plan_next_map(
            prev, prev, nodes, [nodes[2]], [], model,
            _rack_opts(bt, nodes, fused_pipeline=True), device="cpu")
    jmap, jwarn = blance_tpu.plan_next_map(
        jprev, jprev, nodes, [nodes[2]], [], blance_tpu.model(**STATES),
        _rack_opts(blance_tpu, nodes, fused_pipeline=True), backend="tpu")
    assert _nbs(fmap) == _nbs(smap) == _nbs(jmap)
    assert fwarn == swarn == jwarn
    assert rec.counters["plan.pipeline.calls"] == 1
    assert "plan.plan_next_map" in rec.span_counts


def test_plan_pipeline_empty_problem():
    for pkg in (REF, PORT):
        lib = pkg["lib"]
        out = pkg["pipeline"]({}, {}, ["a", "b"], [], [],
                              lib.model(**STATES), None, **pkg["kw"])
        assert out == ({}, {}, {})


@pytest.mark.parametrize("spec,item", [
    (dict(node_sorter=lambda ctx, ns: list(ns)), "A.11"),
    (dict(shape_bucketing=True), "A.13"),
])
def test_plan_pipeline_unported_options_raise(spec, item):
    """The options that raised until their ROADMAP item (A.11: a hook,
    the exact path; A.13: shape_bucketing) now run the pipeline: map,
    warnings and moves equal to the reference's."""
    out = []
    for pkg in (REF, PORT):
        lib = pkg["lib"]
        prev, nodes = _mk_map(lib, 24, 6, seed=9)
        out.append(pkg["pipeline"](prev, prev, nodes, [nodes[4]], [],
                                   lib.model(**STATES),
                                   lib.PlanOptions(**spec), **pkg["kw"]))
    assert _nbs(out[1][0]) == _nbs(out[0][0]), item
    assert out[1][1] == out[0][1], item
    assert _ops(out[1][2]) == _ops(out[0][2]), item


def test_plan_pipeline_asks_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prev, nodes = _mk_map(bt, 24, 6)
    with pytest.raises(RuntimeError, match="is_available"):
        bt.plan_pipeline(prev, prev, nodes, [], [], bt.model(**STATES))


# --- sparse pipeline ----------------------------------------------------------------


@pytest.mark.parametrize("k", [3, 6])
@pytest.mark.parametrize("opts_fn", [_rack_opts, _flat_opts],
                         ids=["rack-rules", "flat"])
def test_sparse_pipeline_matches_reference_and_staged(opts_fn, k):
    """sparse=True with K < N and node weights 1 (where the reference's
    CPU route agrees with its kernel route, ROADMAP C)."""
    def opts(lib, nodes):
        return opts_fn(lib, nodes, sparse=True, sparse_k=k)

    ref = _pipeline(REF, 128, 16, 3, [2, 9], opts)
    port = _pipeline(PORT, 128, 16, 3, [2, 9], opts)
    _assert_same(ref, port, _staged(128, 16, 3, [2, 9], opts))
    assert _plan_counters(port[3]) == _plan_counters(ref[3])
    assert port[3].gauges["plan.sparse.k_effective"] == k


def test_sparse_pipeline_exhaustion_rederives_diff():
    """K = 1 cannot serve two exclusive slots: the host fallback re-places
    many rows after the solve, and the diff and pack are re-derived from
    the patched assignment, so the moves still equal the staged path's
    and the reference's."""
    def opts(lib, nodes):
        return _rack_opts(lib, nodes, sparse=True, sparse_k=1)

    ref = _pipeline(REF, 96, 20, 5, [4], opts)
    port = _pipeline(PORT, 96, 20, 5, [4], opts)
    _assert_same(ref, port, _staged(96, 20, 5, [4], opts))
    assert _plan_counters(port[3]) == _plan_counters(ref[3])
    assert port[3].counters["plan.sparse.dense_fallback_rows"] > 10


# --- edges -------------------------------------------------------------------------


def test_plan_pipeline_node_in_two_states_matches_reference():
    """A beginning map holding one node in two states of a partition: the
    pipeline diffs the dense one-state-per-node encoding, which is the
    reference's contract for its pipeline (not calc_all_moves, whose
    irregular-partition host fallback does not apply), so the moves are
    held against the reference's plan_pipeline."""
    out = []
    for pkg in (REF, PORT):
        lib = pkg["lib"]
        prev, nodes = _mk_map(lib, 40, 8, seed=12)
        for name in ("3", "17"):
            node = prev[name].nodes_by_state["primary"][0]
            prev[name] = lib.Partition(name, {"primary": [node],
                                              "replica": [node]})
        rec = pkg["obs"].Recorder()
        with pkg["obs"].use_recorder(rec):
            res = pkg["pipeline"](prev, prev, nodes, [nodes[1]], [],
                                  lib.model(**STATES), None, **pkg["kw"])
        out.append((*res, rec))
    _assert_same(*out)
    assert _plan_counters(out[1][3]) == _plan_counters(out[0][3])
    assert _ops(out[1][2])["3"]  # the doubled partition does move


def test_plan_pipeline_engine_failure_degrades_to_staged(monkeypatch):
    """A failing engine gives a UserWarning, counts plan.pipeline.fallback
    once and returns the staged path's map, warnings and moves."""
    def boom(*args, **kwargs):
        raise RuntimeError("engine lost")

    monkeypatch.setattr(ttensor, "_pipeline_cold_impl", boom)
    with pytest.warns(UserWarning, match="degrading to the staged path"):
        port = _pipeline(PORT, 96, 12, 1, [3], _rack_opts)
    _assert_same(port, port, _staged(96, 12, 1, [3], _rack_opts))
    assert port[3].counters["plan.pipeline.fallback"] == 1
    assert "plan.engine_fallback" not in port[3].counters
    # The staged fallback records the staged path's spans.
    assert "plan.solve" in port[3].span_counts


# --- decode with a device pack --------------------------------------------------------


def test_decode_with_device_pack_equals_host_pack():
    prev, nodes = _mk_map(bt, 61, 9, seed=6)
    model = bt.model(primary=(0, 1), replica=(1, 2))
    problem = tencode.encode_problem(prev, prev, nodes, [nodes[0]], model,
                                     bt.PlanOptions())
    rng = np.random.default_rng(6)
    assign = rng.integers(-1, 9, (61, 2, 2)).astype(np.int32)
    packed, counts = (t.numpy() for t in
                      tencode.pack_assignment(assign, device="cpu"))
    want = tencode.decode_assignment(problem, assign, prev, [nodes[0]])
    got = tencode.decode_assignment(problem, assign, prev, [nodes[0]],
                                    packed=packed, counts=counts)
    assert _nbs(got[0]) == _nbs(want[0])
    assert got[1] == want[1] and want[1]  # shortfalls warn the same


@pytest.mark.parametrize("which", ["packed", "counts"])
def test_decode_pack_needs_both(which):
    prev, nodes = _mk_map(bt, 8, 4)
    problem = tencode.encode_problem(prev, prev, nodes, [],
                                     bt.model(**STATES), bt.PlanOptions())
    kw = {which: np.zeros((8, 2, 1), np.int32)}
    with pytest.raises(ValueError, match="together"):
        tencode.decode_assignment(problem, problem.prev, prev, [], **kw)


# --- session fast path == replan() + moves() == reference ---------------------------


def _session_script(pkg, P, N, seed, steps, fused, opts_fn=_rack_opts):
    """Drive one session of ``pkg`` through ``steps`` (("remove", ids),
    ("add", names) or ("apply",)); every replan goes through
    replan_with_moves (``fused``) or replan() + moves().  Returns every
    proposal with its move arrays, and the plan counters."""
    lib = pkg["lib"]
    rec = pkg["obs"].Recorder()
    outs = []
    with pkg["obs"].use_recorder(rec):
        prev, nodes = _mk_map(lib, P, N, seed)
        s = pkg["session"](lib.model(**STATES), nodes,
                           [str(i) for i in range(P)],
                           opts=opts_fn(lib, nodes), **pkg["kw"])
        s.load_map(prev)
        for step in steps:
            if step[0] == "remove":
                s.remove_nodes([nodes[i] for i in step[1]])
            elif step[0] == "add":
                s.add_nodes(list(step[1]))
            elif step[0] == "apply":
                s.apply()
            elif fused:
                a, mv = s.replan_with_moves()
                outs.append((a.copy(), mv))
            else:
                a = s.replan().copy()
                outs.append((a, s.moves()))
    return outs, _plan_counters(rec)


def _same_outs(a, b):
    assert len(a) == len(b)
    for (x, xm), (y, ym) in zip(a, b):
        np.testing.assert_array_equal(x, y)
        for u, v in zip(xm, ym):
            np.testing.assert_array_equal(u, v)


COLD_WARM = [("replan",), ("apply",), ("remove", [5]), ("replan",),
             ("apply",), ("remove", [7, 8]), ("replan",), ("apply",)]


@pytest.mark.parametrize("opts_fn", [_rack_opts, _flat_opts],
                         ids=["rack-rules", "flat"])
def test_session_fast_path_cold_warm_identity(opts_fn):
    ref, ref_c = _session_script(REF, 96, 12, 11, COLD_WARM, True, opts_fn)
    port, port_c = _session_script(PORT, 96, 12, 11, COLD_WARM, True,
                                   opts_fn)
    staged, _ = _session_script(PORT, 96, 12, 11, COLD_WARM, False, opts_fn)
    _same_outs(port, ref)
    _same_outs(port, staged)
    assert port_c == ref_c
    assert port_c["plan.pipeline.calls"] == 3


def test_session_fast_path_warm_counters():
    """96 x 12: removing one node stays inside the capacity precheck's
    allowance, so the warm pipeline really runs."""
    steps = [("replan",), ("apply",), ("remove", [2]), ("replan",)]
    ref, ref_c = _session_script(REF, 96, 12, 13, steps, True)
    port, port_c = _session_script(PORT, 96, 12, 13, steps, True)
    _same_outs(port, ref)
    assert port_c == ref_c
    assert port_c["plan.solve.carry_hit"] == 1
    assert port_c["plan.pipeline.warm"] == 1
    assert port_c["plan.solve.sweeps"] == ref_c["plan.solve.sweeps"]


def test_session_fast_path_add_nodes_delta():
    steps = [("replan",), ("apply",), ("add", ["zz0", "zz1"]), ("replan",)]
    ref, ref_c = _session_script(REF, 48, 8, 17, steps, True)
    port, port_c = _session_script(PORT, 48, 8, 17, steps, True)
    staged, _ = _session_script(PORT, 48, 8, 17, steps, False)
    _same_outs(port, ref)
    _same_outs(port, staged)
    assert port_c == ref_c


def test_session_fast_path_fused_engine():
    """The session's pipeline on the in-kernel score engine (its plain
    version here), cold and warm, equals the matrix engine's and the
    reference's interpret-mode kernel."""
    steps = [("replan",), ("apply",), ("remove", [2]), ("replan",)]
    ttensor.set_fused_score_default("on")
    jtensor.set_fused_score_default("interpret")
    try:
        ref, ref_c = _session_script(REF, 96, 12, 13, steps, True)
        port, port_c = _session_script(PORT, 96, 12, 13, steps, True)
    finally:
        ttensor.set_fused_score_default("auto")
        jtensor.set_fused_score_default("auto")
    matrix, _ = _session_script(PORT, 96, 12, 13, steps, True)
    _same_outs(port, ref)
    _same_outs(port, matrix)
    assert port_c == ref_c and port_c["plan.pipeline.warm"] == 1


def _dense(P, N, seed=0):
    """The reference test's dense arrays: a rack rule on the replica."""
    rng = np.random.default_rng(seed)
    prev = np.full((P, 2, 1), -1, np.int32)
    prev[:, 0, 0] = rng.integers(0, N, P)
    prev[:, 1, 0] = (prev[:, 0, 0] + 1 + rng.integers(0, N - 1, P)) % N
    gids = np.stack([np.arange(N, dtype=np.int32),
                     np.arange(N, dtype=np.int32) // 4,
                     np.zeros(N, np.int32)])
    return ((prev, np.ones(P, np.float32), np.ones(N, np.float32),
             np.ones(N, bool), np.full((P, 2), 1.5, np.float32), gids,
             np.ones((3, N), bool)), (1, 1), ((), ((2, 1),)))


def test_warm_pipeline_fused_matches_matrix():
    """The warm pipeline body, every output, on both engines and against
    the reference's with its kernel in interpret mode."""
    arrays, cons, rules = _dense(48, 8, seed=21)
    dev = [jnp.asarray(a) for a in arrays]
    out_np = np.asarray(jtensor.solve_dense_converged(*dev, cons, rules,
                                                      record=False))
    dirty = np.zeros(48, bool)
    dirty[0] = True
    jcarry = jtensor.carry_from_assignment(jnp.asarray(out_np), dev[1],
                                           dev[2])
    want = jtensor._pipeline_warm_jit(
        jnp.asarray(out_np), *dev[1:7], jnp.asarray(dirty),
        jnp.asarray(jcarry.used), cons, rules, fused_score="interpret")
    args = bt.problem_to_torch(out_np, *arrays[1:], device="cpu")
    carry = bt.carry_from_assignment(args[0], args[1], args[2])
    for mode in ("off", "on"):
        got = ttensor._pipeline_warm_impl(
            *args, torch.from_numpy(dirty), carry.used, cons, rules,
            fused_score=mode)
        assert bool(got[3])  # accepted
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_fetch_is_one_copy_of_every_output():
    """_fetch splits one int32 buffer back into the tensors' shapes and
    dtypes (a 0-d bool flag included)."""
    rng = np.random.default_rng(2)
    ts = [torch.from_numpy(rng.integers(-1, 9, s).astype(np.int32))
          for s in ((5, 2, 3), (5, 12), (5, 2))]
    ts.append(torch.tensor(True))
    got = ttensor._fetch(*ts)
    for g, t in zip(got, ts):
        assert g.shape == tuple(t.shape)
        np.testing.assert_array_equal(g, t.numpy())
    assert got[-1].dtype == bool


# --- emissions ----------------------------------------------------------------------


def test_pipeline_emissions_match_reference():
    """The reference's emission script (a session cold and warm, then a
    plan_pipeline) on each package's recorder: the same counters, span
    names and histograms, every one declared in the reference's metric
    table."""
    from blance_tpu.obs.expo import default_registry

    recs = []
    for pkg in (REF, PORT):
        lib = pkg["lib"]
        rec = pkg["obs"].Recorder()
        with pkg["obs"].use_recorder(rec):
            prev, nodes = _mk_map(lib, 96, 12, seed=31)
            s = pkg["session"](lib.model(**STATES), nodes,
                               [str(i) for i in range(96)],
                               opts=_rack_opts(lib, nodes), **pkg["kw"])
            s.load_map(prev)
            s.replan_with_moves()
            s.apply()
            s.remove_nodes([nodes[1]])
            s.replan_with_moves()
            pkg["pipeline"](prev, prev, nodes, [nodes[2]], [],
                            lib.model(**STATES), _rack_opts(lib, nodes),
                            **pkg["kw"])
        recs.append(rec)
    ref, port = recs
    assert default_registry().undeclared(port) == []
    assert port.counters == ref.counters
    assert sorted(port.span_counts) == sorted(ref.span_counts)
    assert sorted(port.histograms) == sorted(ref.histograms)
    assert port.counters["plan.pipeline.calls"] == 3
    assert port.counters["plan.pipeline.warm"] == 1


# --- the plan's phase spans (ROADMAP C.1) ---------------------------------------------


def _span_drive(pkg, through):
    """The 64 x 8 delta planned once through plan_next_map or rebalance()
    under a fresh recorder of ``pkg``; returns the recorder."""
    lib = pkg["lib"]
    prev, nodes = _mk_map(lib, 64, 8, seed=1)
    model = lib.model(**STATES)
    backend = dict(backend="tpu") if pkg is REF else \
        dict(backend="cuda", device="cpu")
    rec = pkg["obs"].Recorder()
    with pkg["obs"].use_recorder(rec):
        if through == "plan_next_map":
            lib.plan_next_map(prev, prev, nodes, [nodes[3]], [], model,
                              None, **backend)
        else:
            async def assign(stop_ch, node, partitions, states, ops):
                await asyncio.sleep(0)

            reb = importlib.import_module(lib.__name__ + ".rebalance")
            res = asyncio.run(reb.rebalance_async(
                model, prev, nodes, [nodes[3]], [], assign, **backend))
            assert not res.progress.errors
    return rec


@pytest.mark.parametrize("through", ["plan_next_map", "rebalance"])
def test_plan_spans_match_reference(through):
    """The port records the reference's plan spans: plan.plan_next_map,
    plan.encode, plan.solve (with plan.solve.attempt inside) and
    plan.decode, through plan_next_map and through rebalance()."""
    ref, port = (_span_drive(pkg, through) for pkg in (REF, PORT))
    assert sorted(port.span_counts) == sorted(ref.span_counts)
    for name in ("plan.plan_next_map", "plan.encode", "plan.solve",
                 "plan.solve.attempt", "plan.decode"):
        assert port.span_counts[name] == ref.span_counts[name] == 1
    assert _plan_counters(port) == _plan_counters(ref)


def test_plan_next_map_timer_phases():
    """plan_next_map's timer= attributes wall-clock to the reference's
    phase keys and carries the engine annotation."""
    from blance_tpu_torch.utils.trace import PhaseTimer

    prev, nodes = _mk_map(bt, 64, 8, seed=1)
    for opts, phases in ((bt.PlanOptions(), {"encode", "solve", "decode"}),
                         (bt.PlanOptions(fused_pipeline=True),
                          {"encode", "dispatch", "decode"}),
                         (bt.PlanOptions(sparse=True, sparse_k=4),
                          {"encode", "solve", "decode"})):
        timer = PhaseTimer()
        bt.plan_next_map(prev, prev, nodes, [nodes[3]], [],
                         bt.model(**STATES), opts, device="cpu", timer=timer)
        assert set(timer.totals) == phases
        want = "sparse" if opts.sparse else "matrix"
        assert timer.annotations["engine"] == want
