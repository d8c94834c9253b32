"""The sparse engine's own telemetry, on the CPU.

``plan_next_map(backend="auto")`` reaches the sparse shortlist engine
once the matrix engine's projected footprint passes the memory budget;
the tests lower the budget to just under their fixture's projection, as
a deployment of a million partitions meets it on an 80 GB card.  Then:

- the shortlist build runs in the span ``plan.sparse.shortlist`` (inside
  ``plan.solve``, before ``plan.solve.attempt``), and the host dense
  fallback in ``plan.sparse.fallback`` only when the solve flags rows;
  ``plan_pipeline`` and ``solve_sparse_warm`` open the same spans;
- the counters ``ops.sparse_min2.cells`` / ``price_cells`` /
  ``out_cells`` equal P·K, N and 5·P summed over the sparse min2 calls
  the solve made (P·K, 0 and 4·P for the [P, K]-price entry);
- the matrix route records none of these names;
- the names are the port's own (``obs.PORT_ONLY_TELEMETRY``): declared,
  and kept out of the exposition.
"""

import contextlib

import numpy as np
import pytest
import torch

import blance_tpu_torch as bt
from blance_tpu_torch.obs import (PORT_ONLY_COUNTERS, PORT_ONLY_SPANS,
                                  PORT_ONLY_TELEMETRY, InMemorySink,
                                  Recorder, default_registry,
                                  render_prometheus, use_recorder)
from blance_tpu_torch.ops import sparse2
from blance_tpu_torch.plan import tensor as ttensor
from _port_telemetry import SPARSE_MIN2, SPARSE_SPANS

P, N = 2048, 128  # P * N is auto's threshold for the card's solver
MODEL = dict(primary=(0, 1), replica=(1, 1))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def _past_budget():
    """The matrix engine's projection just over the budget."""
    ttensor.set_dense_score_budget(ttensor.projected_score_bytes(P, N) - 1)
    try:
        yield
    finally:
        ttensor.set_dense_score_budget(None)


def _fixture(seed=5):
    """A balanced primary + replica map on racks of 25 under one zone,
    the replica on another rack, as the benchmark's deployments are."""
    rng = np.random.default_rng(seed)
    nodes = [f"n{i:04d}" for i in range(N)]
    first = rng.permutation(P) % N
    beg = {}
    for i in range(P):
        a = int(first[i])
        b = (a + N // 2) % N  # half the nodes apart: another rack
        beg[f"{i:05d}"] = bt.Partition(
            f"{i:05d}", {"primary": [nodes[a]], "replica": [nodes[b]]})
    hier = {n: f"r{i // 25}" for i, n in enumerate(nodes)}
    hier.update({r: "z0" for r in set(hier.values())})
    opts = dict(node_hierarchy=hier,
                hierarchy_rules={"replica": [bt.HierarchyRule(2, 1)]})
    out = [nodes[j] for j in rng.choice(N, 6, replace=False)]
    return beg, nodes, out, opts


def _record(fn):
    sink = InMemorySink()
    rec = Recorder(sinks=(sink,))
    with use_recorder(rec):
        fn()
    return rec, sink.spans


def _plan(opts_kw=None, timings=None, **extra):
    beg, nodes, out, opts = _fixture()
    opts.update(opts_kw or {})
    return bt.plan_next_map(beg, beg, nodes, out, [], bt.model(**MODEL),
                            bt.PlanOptions(**opts), backend="auto",
                            device="cpu", timings=timings, **extra)


def _spy_calls(monkeypatch):
    """(score shape, price_n length) of each gathered sparse min2 call
    the solver makes."""
    calls = []
    real = ttensor.sparse_priced_min2_cand

    def spy(score, cand, price_n):
        calls.append((tuple(score.shape), int(price_n.shape[0])))
        return real(score, cand, price_n)

    monkeypatch.setattr(ttensor, "sparse_priced_min2_cand", spy)
    return calls


def test_auto_route_opens_the_shortlist_span():
    timings = {}
    with _past_budget():
        rec, spans = _record(lambda: _plan(timings=timings))
    assert timings["engine"] == "sparse"
    assert rec.span_counts["plan.sparse.shortlist"] == 1
    by_name = {sp.name: sp for sp in spans}
    by_id = {sp.span_id: sp for sp in spans}
    sl = by_name["plan.sparse.shortlist"]
    solve = by_id[sl.parent_id]
    assert solve.name == "plan.solve"
    assert solve.t_start <= sl.t_start <= sl.t_end <= solve.t_end
    assert sl.t_end <= by_name["plan.solve.attempt"].t_start
    assert sl.duration_s > 0
    # The fallback span opens exactly when the solve flagged rows.
    flagged = timings["exhausted_rows"] > 0
    assert ("plan.sparse.fallback" in rec.span_counts) == flagged
    assert rec.counters.get("plan.sparse.shortlist_exhausted", 0) == \
        timings["exhausted_rows"]


@pytest.mark.parametrize("sparse_k", [1, 3])
def test_fallback_span_when_rows_are_flagged(sparse_k):
    """A shortlist too narrow for two rack-exclusive slots flags rows:
    the fallback runs in its span, after the solve's attempt."""
    timings = {}
    with _past_budget():
        rec, spans = _record(lambda: _plan(dict(sparse_k=sparse_k),
                                           timings=timings))
    assert timings["engine"] == "sparse" and timings["exhausted_rows"] > 0
    assert rec.span_counts["plan.sparse.fallback"] == 1
    assert rec.counters["plan.sparse.shortlist_exhausted"] == \
        timings["exhausted_rows"]
    by_name = {sp.name: sp for sp in spans}
    fb = by_name["plan.sparse.fallback"]
    assert by_name["plan.solve.attempt"].t_end <= fb.t_start
    assert by_name["plan.solve"].t_start <= fb.t_start <= fb.t_end <= \
        by_name["plan.solve"].t_end


@pytest.mark.parametrize("sparse_k", [None, 3])
def test_min2_counters_equal_the_calls(sparse_k, monkeypatch):
    calls = _spy_calls(monkeypatch)
    timings = {}
    with _past_budget():
        rec, _ = _record(lambda: _plan(dict(sparse_k=sparse_k),
                                       timings=timings))
    assert timings["engine"] == "sparse" and calls
    k = timings["k"]
    assert all(shape == (P, k) and n == N for shape, n in calls)
    c = rec.counters
    assert c["ops.sparse_min2.cells"] == sum(s[0] * s[1] for s, _ in calls)
    assert c["ops.sparse_min2.price_cells"] == sum(n for _, n in calls)
    assert c["ops.sparse_min2.out_cells"] == sum(5 * s[0] for s, _ in calls)


def test_min2_counters_of_the_plain_entry():
    score = torch.rand(37, 8)
    price = torch.rand(37, 8)
    rec = Recorder()
    with use_recorder(rec):
        sparse2.sparse_priced_min2(score, price)
        sparse2.sparse_priced_min2(score[:5], price[:5])
    assert {n: rec.counters[n] for n in SPARSE_MIN2} == {
        "ops.sparse_min2.cells": 42 * 8, "ops.sparse_min2.price_cells": 0,
        "ops.sparse_min2.out_cells": 4 * 42}


def test_matrix_route_records_none():
    timings = {}
    rec, _ = _record(lambda: _plan(timings=timings))
    assert timings["engine"] == "matrix"
    assert not SPARSE_SPANS & set(rec.span_counts)
    assert not SPARSE_MIN2 & set(rec.counters)


def test_pipeline_and_warm_open_the_spans():
    beg, nodes, out, opts = _fixture()
    model = bt.model(**MODEL)
    with _past_budget():
        rec, spans = _record(lambda: bt.plan_pipeline(
            beg, beg, nodes, out, [], model,
            bt.PlanOptions(sparse_k=3, **opts), device="cpu"))
    assert rec.span_counts["plan.sparse.shortlist"] == 1
    assert rec.span_counts["plan.sparse.fallback"] == 1
    by_id = {sp.span_id: sp for sp in spans}
    parents = {sp.name: by_id[sp.parent_id].name for sp in spans
               if sp.name in SPARSE_SPANS}
    assert parents == {"plan.sparse.shortlist": "plan.pipeline.dispatch",
                       "plan.sparse.fallback": "plan.pipeline"}
    assert SPARSE_MIN2 <= set(rec.counters)

    # The warm repair builds its own shortlist in the same span.
    from blance_tpu_torch.core.encode import encode_problem
    problem = encode_problem(beg, beg, nodes, out, model, bt.PlanOptions(
        **opts))
    arrays = [torch.from_numpy(np.asarray(a)) for a in (
        problem.prev, problem.partition_weights, problem.node_weights,
        problem.valid_node, problem.stickiness, problem.gids,
        problem.gid_valid)]
    rules = tuple(tuple(problem.rules.get(si, ()))
                  for si in range(problem.S))
    cons = tuple(int(c) for c in problem.constraints)
    cold = ttensor.solve_sparse(*arrays, cons, rules, k=16, record=False)
    carry = ttensor.carry_from_assignment(torch.from_numpy(cold),
                                          arrays[1], arrays[2])
    dirty = np.zeros(P, bool)
    rec, _ = _record(lambda: ttensor.solve_sparse_warm(
        torch.from_numpy(cold), *arrays[1:], cons, rules, dirty=dirty,
        carry=carry, k=16))
    assert rec.span_counts["plan.sparse.shortlist"] == 1
    assert SPARSE_MIN2 <= set(rec.counters)


def test_names_are_the_ports_own_and_unrendered():
    assert SPARSE_SPANS <= set(PORT_ONLY_SPANS)
    assert SPARSE_MIN2 <= set(PORT_ONLY_COUNTERS)
    assert (SPARSE_SPANS | SPARSE_MIN2) <= set(PORT_ONLY_TELEMETRY)
    with _past_budget():
        rec, _ = _record(lambda: _plan(dict(sparse_k=3)))
    assert SPARSE_MIN2 <= set(rec.counters)
    assert SPARSE_SPANS <= set(rec.span_counts)
    assert default_registry().undeclared(rec) == []
    text = render_prometheus(rec)
    rendered = {line.split("{")[0].split(" ")[0]
                for line in text.splitlines() if not line.startswith("#")}
    assert "blance_plan_sparse_shortlist_exhausted_total" in rendered
    for name in SPARSE_SPANS | SPARSE_MIN2:
        base = "blance_" + name.replace(".", "_")
        assert not {base, base + "_total"} & rendered, name
