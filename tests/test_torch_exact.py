"""The port's exact backends against the JAX package, on the CPU.

``backend="greedy"`` (plan/greedy.py) and ``backend="native"`` (the C++
core, the port's own copy of native/planner.cpp) must give maps and
warnings bit-identical to the reference's on the golden cases of
tests/test_plan.py, the native suite's fixtures and its random
differential; ``backend="auto"`` must route as the reference does; and
custom placement hooks on the "cuda" backend and in ``plan_pipeline``
must take the exact path, with the reference's spans.  Both packages'
native libraries load in one process.
"""

import dataclasses
import os
import random

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import blance_tpu as jb  # noqa: E402
import blance_tpu.obs as jobs  # noqa: E402
import blance_tpu_torch as bt  # noqa: E402
import blance_tpu_torch.obs as tobs  # noqa: E402
from blance_tpu.plan import api as japi  # noqa: E402
from blance_tpu.plan import greedy as jgreedy  # noqa: E402
from blance_tpu.plan import native as jnative  # noqa: E402
from blance_tpu.plan import tensor as jtensor  # noqa: E402
from blance_tpu_torch.plan import api as tapi  # noqa: E402
from blance_tpu_torch.plan import greedy as tgreedy  # noqa: E402
from blance_tpu_torch.plan import native as tnative  # noqa: E402
from blance_tpu_torch.plan import tensor as ttensor  # noqa: E402
from blance_tpu.obs.sinks import InMemorySink as JSink  # noqa: E402
from blance_tpu_torch.obs.sinks import InMemorySink as TSink  # noqa: E402
import test_plan_hierarchy  # noqa: E402
import test_plan_vis  # noqa: E402
from blance_tpu.testing import vis as jvis  # noqa: E402
from test_native import _random_scenario  # noqa: E402
from test_plan import CASES  # noqa: E402

STATES = dict(primary=(0, 1), replica=(1, 1))


def to_port(x):
    """A reference object (maps, models, options, rules) as the port's."""
    if isinstance(x, jb.Partition):
        return bt.Partition(x.name, {s: list(ns)
                                     for s, ns in x.nodes_by_state.items()})
    if isinstance(x, jb.PartitionModelState):
        return bt.PartitionModelState(priority=x.priority,
                                      constraints=x.constraints)
    if isinstance(x, jb.HierarchyRule):
        return bt.HierarchyRule(x.include_level, x.exclude_level)
    if isinstance(x, jb.PlanOptions):
        return bt.PlanOptions(**{f.name: to_port(getattr(x, f.name))
                                 for f in dataclasses.fields(x)})
    if x is jnative.cbgt_node_score_booster:
        return bt.cbgt_node_score_booster
    if isinstance(x, dict):
        return {k: to_port(v) for k, v in x.items()}
    if isinstance(x, list):
        return [to_port(v) for v in x]
    return x


def _nbs(pmap):
    return {k: p.nodes_by_state for k, p in pmap.items()}


def _ops(moves):
    return {k: [(m.node, m.state, m.op) for m in ms]
            for k, ms in moves.items()}


def _both(args, opts, backend, **port_kw):
    """plan_next_map of both packages on the same (reference-typed)
    arguments; returns ((ref_map, ref_warn), (port_map, port_warn))."""
    ref = jb.plan_next_map(*args, opts, backend=backend)
    port = bt.plan_next_map(*to_port(list(args)), to_port(opts),
                            backend=backend, **port_kw)
    return ref, port


def _case_args(case):
    def pm(d):
        return {n: jb.Partition(n, {s: list(ns) for s, ns in nbs.items()})
                for n, nbs in d.items()}
    opts = jb.PlanOptions(
        model_state_constraints=case.get("constraints"),
        partition_weights=case.get("pweights"),
        state_stickiness=case.get("sstick"),
        node_weights=case.get("nweights"),
        node_hierarchy=case.get("hierarchy"),
        hierarchy_rules=case.get("rules"),
    )
    return (pm(case["prev"]), pm(case["assign"]), case["nodes"],
            case["remove"], case["add"], case["model"]), opts


@pytest.fixture(scope="module", autouse=True)
def _native_libraries():
    """Both packages' native planners, loaded in this one process."""
    assert tnative.native_available(), "the port's planner.cpp did not build"
    assert jnative.native_available()
    assert tnative._LIB is not jnative._LIB


# --- golden cases and the native suite ---------------------------------------


@pytest.mark.parametrize("backend", ["greedy", "native"])
@pytest.mark.parametrize("case", CASES, ids=[c["about"] for c in CASES])
def test_golden_cases_match_reference(case, backend):
    args, opts = _case_args(case)
    (rmap, rwarn), (pmap, pwarn) = _both(args, opts, backend)
    assert _nbs(pmap) == _nbs(rmap)
    assert pwarn == rwarn
    assert _nbs(pmap) == {n: dict(nbs) for n, nbs in case["exp"].items()}
    assert sum(len(w) for w in pwarn.values()) == case["warnings"]


@pytest.mark.parametrize("backend", ["greedy", "native"])
def test_ghost_nodes_match_reference(backend):
    """Partitions referencing nodes outside nodes_all keep them in rows
    and accounting, never as candidates (tests/test_native.py)."""
    prev = {
        "0": jb.Partition("0", {"primary": ["ghost"], "replica": ["a"]}),
        "1": jb.Partition("1", {"primary": ["b"], "replica": ["ghost"]}),
        "2": jb.Partition("2", {"primary": ["a"], "replica": ["b"]}),
    }
    for constraints in (None, {"primary": 1, "replica": 0}):
        opts = jb.PlanOptions(model_state_constraints=constraints)
        args = (prev, prev, ["a", "b"], [], None, jb.model(**STATES))
        (rmap, rwarn), (pmap, pwarn) = _both(args, opts, backend)
        assert _nbs(pmap) == _nbs(rmap) and pwarn == rwarn


@pytest.mark.parametrize("backend", ["greedy", "native"])
def test_interior_hierarchy_node_matches_reference(backend):
    """A listed node that is also a hierarchy parent is never a hierarchy
    pick (tests/test_native.py)."""
    parts = {str(i): jb.Partition(str(i), {}) for i in range(4)}
    opts = jb.PlanOptions(
        node_hierarchy={"a": "r0", "b": "r0", "r0": "z0"},
        hierarchy_rules={"replica": [jb.HierarchyRule(1, 0)]})
    nodes = ["a", "b", "r0"]
    args = ({}, parts, nodes, [], nodes, jb.model(**STATES))
    (rmap, rwarn), (pmap, pwarn) = _both(args, opts, backend)
    assert _nbs(pmap) == _nbs(rmap) and pwarn == rwarn


VIS_SUITES = [
    (test_plan_vis, "test_plan_next_map_vis"),
    (test_plan_hierarchy, "test_plan_next_map_hierarchy"),
    (test_plan_hierarchy, "test_multi_primary"),
    (test_plan_hierarchy, "test_2_replicas"),
    (test_plan_hierarchy, "test_hierarchy_multi_rack_failure_cases"),
]


@pytest.mark.parametrize("backend", ["greedy", "native"])
@pytest.mark.parametrize("suite", VIS_SUITES, ids=[f for _, f in VIS_SUITES])
def test_vis_suites_match_reference(monkeypatch, suite, backend):
    """The reference's visual golden suites (tests/test_plan_vis.py,
    tests/test_plan_hierarchy.py): their VisCase inputs, captured from the
    suites themselves, planned through both packages; maps and warnings
    equal, and equal to each case's golden map."""
    module, name = suite
    captured: list = []
    monkeypatch.setattr(module, "run_vis_cases",
                        lambda cases, backend=None: captured.extend(cases))
    getattr(module, name)(backend=backend)
    assert captured
    for case in captured:
        if case.ignore:
            continue
        prev, exp = jvis.vis_maps(case)
        opts = jb.PlanOptions(
            model_state_constraints=case.model_state_constraints,
            partition_weights=case.partition_weights,
            state_stickiness=case.state_stickiness,
            node_weights=case.node_weights,
            node_hierarchy=case.node_hierarchy,
            hierarchy_rules=case.hierarchy_rules)
        args = (prev, prev, case.nodes, case.nodes_to_remove,
                case.nodes_to_add, case.model)
        (rmap, rwarn), (pmap, pwarn) = _both(args, opts, backend)
        assert _nbs(pmap) == _nbs(rmap) == _nbs(exp), case.about
        assert pwarn == rwarn, case.about


def test_native_differential_matches_reference():
    """The reference's random differential (tests/test_native.py, seed
    1234, 60 trials): the port's native and greedy equal each other and
    the reference's native, map and warnings."""
    rng = random.Random(1234)
    for trial in range(60):
        prev, assign, nodes, removes, adds, m, opts = _random_scenario(rng)
        args = (prev, assign, nodes, removes, adds, m)
        ref = jb.plan_next_map(*args, opts, backend="native")
        pargs, popts = to_port(list(args)), to_port(opts)
        for backend in ("native", "greedy"):
            got = bt.plan_next_map(*pargs, popts, backend=backend)
            assert _nbs(got[0]) == _nbs(ref[0]), (trial, backend)
            assert got[1] == ref[1], (trial, backend)


def test_plan_next_map_legacy_matches_reference():
    """The deprecated positional shim, every option given, on each exact
    backend (the reference's "greedy" default included)."""
    nodes = [f"n{i}" for i in range(6)]
    prev = {str(i): jb.Partition(str(i), {"primary": [nodes[i % 6]],
                                          "replica": [nodes[(i + 1) % 6]]})
            for i in range(20)}
    hier = {n: f"r{i // 2}" for i, n in enumerate(nodes)}
    hier.update({"r0": "z", "r1": "z", "r2": "z"})
    extra = ({"primary": 1, "replica": 1}, {"3": 2}, {"primary": 4},
             {"n1": 2}, hier, {"replica": [jb.HierarchyRule(2, 1)]})
    args = (prev, prev, nodes, ["n5"], [], jb.model(**STATES))
    for backend in (None, "greedy", "native"):
        kw = {} if backend is None else dict(backend=backend)
        ref = japi.plan_next_map_legacy(*args, *extra, **kw)
        port = tapi.plan_next_map_legacy(*to_port(list(args)),
                                         *to_port(list(extra)), **kw)
        assert _nbs(port[0]) == _nbs(ref[0]) and port[1] == ref[1]


def test_plan_helpers_match_reference():
    """count_state_nodes and _remove_nodes_from_nodes_by_state (the
    tables of tests/test_plan_helpers.py) against the reference's."""
    pm = {
        "0": jb.Partition("0", {"primary": ["a"], "replica": ["b", "c"]}),
        "1": jb.Partition("1", {"primary": ["b"], "replica": ["c"]}),
        "2": jb.Partition("2", {"replica": ["b", "c"]}),
    }
    for weights in (None, {"0": 3}, {"2": 5, "9": 7}):
        assert bt.count_state_nodes(to_port(pm), weights) == \
            jb.count_state_nodes(pm, weights)
    cases = [
        ({"primary": ["a", "b"]}, ["b", "c"]),
        ({"primary": ["a", "b"], "replica": ["c"]}, ["a", "c"]),
        ({"primary": ["a", "b"], "replica": ["c"]}, []),
        ({}, ["a"]),
    ]
    for nbs, remove in cases:
        seen_r, seen_p = [], []
        want = jgreedy._remove_nodes_from_nodes_by_state(
            nbs, remove, lambda s, ns: seen_r.append((s, ns)))
        got = tgreedy._remove_nodes_from_nodes_by_state(
            nbs, remove, lambda s, ns: seen_p.append((s, ns)))
        assert got == want and seen_p == seen_r


# --- auto routing --------------------------------------------------------------


def _routed(monkeypatch, pkg, partitions, nodes, opts, **kw):
    """The backend plan_next_map(backend="auto") resolves to, read off its
    plan.plan_next_map span, with the planners stubbed out (no solve)."""
    lib, obs, native, tensor, dense = pkg
    for mod, name in ((native, "plan_next_map_native"), (tensor, dense)):
        monkeypatch.setattr(mod, name, lambda *a, **k: ({}, {}))
    rec = obs.Recorder()
    sink = (TSink if obs is tobs else JSink)()
    rec.add_sink(sink)
    parts = {str(i): lib.Partition(str(i), {}) for i in range(partitions)}
    with obs.use_recorder(rec):
        lib.plan_next_map(parts, parts, [f"n{i}" for i in range(nodes)], [],
                          [], lib.model(**STATES), opts, backend="auto", **kw)
    (span,) = sink.by_name("plan.plan_next_map")
    return span.attrs["backend"], span.attrs["requested"]


@pytest.mark.parametrize("partitions,nodes,threshold", [
    (1024, 255, None), (1024, 256, None), (512, 511, None), (512, 512, None),
    (30, 9, 271), (30, 9, 270), (30, 9, 1), (30, 9, 10 ** 9),
])
def test_auto_routes_as_reference(monkeypatch, partitions, nodes, threshold):
    """Both sides of _AUTO_TPU_THRESHOLD (256 * 1024 cells) and of
    PlanOptions.auto_tpu_threshold: "native" below, the card ("cuda",
    the reference's "tpu") at and above."""
    assert tapi._AUTO_TPU_THRESHOLD == japi._AUTO_TPU_THRESHOLD == 256 * 1024
    ref = _routed(monkeypatch, (jb, jobs, jnative, jtensor,
                                "plan_next_map_tpu"), partitions, nodes,
                  jb.PlanOptions(auto_tpu_threshold=threshold))
    port = _routed(monkeypatch, (bt, tobs, tnative, ttensor,
                                 "plan_next_map_cuda"), partitions, nodes,
                   bt.PlanOptions(auto_tpu_threshold=threshold),
                   device="cpu")
    assert ref[1] == port[1] == "auto"
    assert port[0] == {"native": "native", "tpu": "cuda"}[ref[0]]
    cells = partitions * nodes
    want = "cuda" if cells >= (threshold or 256 * 1024) else "native"
    assert port[0] == want


def test_auto_plans_on_native_below_threshold():
    """A real auto plan below the threshold runs the native planner (no
    kernel, no device) and equals the reference's."""
    args = (*_mk_args(jb, 48, 8, 3), jb.model(**STATES))
    (rmap, rwarn), (pmap, pwarn) = _both(args, jb.PlanOptions(), "auto",
                                         device="cpu")
    assert _nbs(pmap) == _nbs(rmap) and pwarn == rwarn
    assert _nbs(pmap) == _nbs(bt.plan_next_map(
        *to_port(list(args)), backend="native")[0])


def test_unknown_backend_raises():
    parts = {"0": bt.Partition("0", {})}
    for backend in ("tpu", "cpu", ""):
        with pytest.raises(ValueError, match="unknown backend"):
            bt.plan_next_map(parts, parts, ["a"], [], [],
                             bt.model(primary=(0, 1)), backend=backend)


# --- the exact-path fallback of the "cuda" backend ------------------------------


def _mk_args(lib, P, N, seed):
    """prev == to-assign map (primary + replica) over N nodes, one node
    removed."""
    rng = np.random.default_rng(seed)
    nodes = [f"n{i:02d}" for i in range(N)]
    p_ids = rng.integers(0, N, P)
    r_ids = (p_ids + 1 + rng.integers(0, N - 1, P)) % N
    prev = {str(i): lib.Partition(str(i), {"primary": [nodes[p_ids[i]]],
                                           "replica": [nodes[r_ids[i]]]})
            for i in range(P)}
    return prev, prev, nodes, [nodes[1]], []


HOOKS = {
    "node_scorer": lambda: dict(
        node_scorer=lambda ctx, node: -float(ctx.node_positions[node])),
    "node_sorter": lambda: dict(
        node_sorter=lambda ctx, nodes: sorted(nodes, reverse=True)),
    "non_cbgt_booster": lambda: dict(
        node_weights={"n03": -1, "n05": 2},
        node_score_booster=lambda w, stick: float(-2 * w)),
    "negative_weight_no_booster": lambda: dict(
        node_weights={"n03": -1, "n04": -2}),
}


def _hook_opts(lib, name):
    spec = HOOKS[name]()
    nodes = [f"n{i:02d}" for i in range(10)]
    hier = {n: f"r{i // 2}" for i, n in enumerate(nodes)}
    hier.update({f"r{i}": "z0" for i in range(5)})
    return lib.PlanOptions(
        node_hierarchy=hier,
        hierarchy_rules={"replica": [lib.HierarchyRule(2, 1)]}, **spec)


def _spans(pkg_obs, fn):
    rec = pkg_obs.Recorder()
    sink = (TSink if pkg_obs is tobs else JSink)()
    rec.add_sink(sink)
    with pkg_obs.use_recorder(rec):
        out = fn()
    return out, rec, sink


@pytest.mark.parametrize("hook", sorted(HOOKS))
def test_cuda_backend_falls_back_to_exact_path(hook):
    """A hook the device score cannot express: plan_next_map(backend=
    "cuda") returns the exact planner's map (the reference's
    backend="tpu" does the same), inside a plan.solve span with
    engine="exact-fallback", with the reference's span counts."""
    jargs = (*_mk_args(jb, 40, 10, 5), jb.model(**STATES))
    targs = (*_mk_args(bt, 40, 10, 5), bt.model(**STATES))
    ref, rrec, _ = _spans(jobs, lambda: jb.plan_next_map(
        *jargs, _hook_opts(jb, hook), backend="tpu"))
    port, prec, psink = _spans(tobs, lambda: bt.plan_next_map(
        *targs, _hook_opts(bt, hook), backend="cuda", device="cpu"))
    exact = bt.plan_next_map(*targs, _hook_opts(bt, hook), backend="greedy")
    assert _nbs(port[0]) == _nbs(ref[0]) == _nbs(exact[0])
    assert port[1] == ref[1] == exact[1]
    assert prec.span_counts == rrec.span_counts
    (solve,) = psink.by_name("plan.solve")
    assert solve.attrs["engine"] == "exact-fallback"
    assert ttensor._cuda_supported(_hook_opts(bt, hook)) is False


@pytest.mark.parametrize("hook", ["node_sorter", "negative_weight_no_booster"])
def test_plan_pipeline_falls_back_to_exact_path(hook):
    """plan_pipeline with a hook: the exact map and its device-diffed
    moves, equal to the reference's pipeline and to calc_partition_moves
    on the host, with the reference's span counts."""
    jargs = (*_mk_args(jb, 40, 10, 6), jb.model(**STATES))
    targs = (*_mk_args(bt, 40, 10, 6), bt.model(**STATES))
    ref, rrec, _ = _spans(jobs, lambda: jtensor.plan_pipeline(
        *jargs, _hook_opts(jb, hook)))
    port, prec, _ = _spans(tobs, lambda: ttensor.plan_pipeline(
        *targs, _hook_opts(bt, hook), device="cpu"))
    assert _nbs(port[0]) == _nbs(ref[0]) and port[1] == ref[1]
    assert _ops(port[2]) == _ops(ref[2])
    assert prec.span_counts == rrec.span_counts
    beg = targs[0]
    for name, part in port[0].items():
        want = bt.calc_partition_moves(
            bt.sort_state_names(targs[5]), beg[name].nodes_by_state,
            part.nodes_by_state)
        assert _ops({name: port[2][name]}) == _ops({name: want})


def test_supported_options_stay_on_the_card():
    """The cbgt booster with negative weights, and no hooks at all, stay
    on the batched solver (no exact-fallback span)."""
    for opts in (bt.PlanOptions(),
                 bt.PlanOptions(node_weights={"n03": -1},
                                node_score_booster=bt.cbgt_node_score_booster)):
        assert ttensor._cuda_supported(opts)
        targs = (*_mk_args(bt, 40, 10, 5), bt.model(**STATES))
        _, _, sink = _spans(tobs, lambda: bt.plan_next_map(
            *targs, opts, backend="cuda", device="cpu"))
        assert [s.attrs.get("engine") for s in sink.by_name("plan.solve")] \
            != ["exact-fallback"]


def test_cbgt_booster_is_the_native_marker():
    """cbgt_node_score_booster lives in plan/native.py, as in the
    reference, and plan/api.py re-exports the same object."""
    assert tapi.cbgt_node_score_booster is tnative.cbgt_node_score_booster
    assert bt.cbgt_node_score_booster.__blance_native__ == "cbgt"
    assert bt.cbgt_node_score_booster(-3, 1.5) == \
        jnative.cbgt_node_score_booster(-3, 1.5) == 3.0


# --- the native planner builds from the port's own source ----------------------


def test_port_native_planner_builds(tmp_path):
    """planner.cpp in the port's tree compiles with the reference's g++
    line into a fresh directory and exports the planner's entry point
    (after tests/test_native_builds.py::test_native_planner_builds)."""
    import ctypes
    import shutil

    from blance_tpu_torch.utils.nativebuild import compile_cached

    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    src = tnative._source_path()
    assert src.startswith(os.path.dirname(os.path.abspath(
        bt.__file__))), src
    so = str(tmp_path / "planner.so")
    assert compile_cached(src, so, ["g++", "-O3", "-shared", "-fPIC",
                                    "-std=c++17", "-o", so, src])
    assert hasattr(ctypes.CDLL(so), "blance_plan_inner")
