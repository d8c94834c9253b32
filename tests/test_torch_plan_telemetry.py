"""The port's own plan telemetry (``obs.PORT_ONLY_TELEMETRY``), on the CPU.

- The audit's ``plan.audit`` span and the encode and decode stage spans
  nest under the span that encloses them on each path: ``plan_next_map``
  (backend "cuda"), ``plan_pipeline`` and the ``PlannerSession`` loop.
- ``plan.solve.auction_rounds`` and ``plan.solve.host_syncs`` equal the
  counts a spy takes on its own: the rounds of ``_assign_slot`` (its
  calls of ``_segment_accept``), and every read of a tensor back to the
  host made by the solver's code (``plan/tensor.py`` and the shortlist
  build), on a rack fixture and a multi-state fixture.
- The counters stay out of the exposition, but the drift guard counts
  them declared.
- ``obs.chrome.trace`` with a device log dir writes a merged file in
  which a ``torch.profiler.record_function`` range opened inside a
  recorder span lies inside that span.
- ``plan_next_map``'s ``timings`` are its spans' durations.
"""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

import blance_tpu_torch as bt
from blance_tpu_torch.core import encode as tencode
from blance_tpu_torch.obs import (PORT_ONLY_COUNTERS, PORT_ONLY_SPANS,
                                  PORT_ONLY_TELEMETRY, InMemorySink,
                                  Recorder, chrome, default_registry,
                                  render_prometheus, use_recorder)
from blance_tpu_torch.plan import tensor as ttensor
from _port_telemetry import (SCORE_WRITE, SPARSE_MIN2, SPARSE_SPANS,
                             port_names)

RACK = dict(primary=(0, 1), replica=(1, 1))
MULTI = dict(primary=(0, 2), replica=(1, 1), readonly=(2, 1))
ENCODE = ("plan.encode.order", "plan.encode.prev", "plan.encode.hierarchy")
DECODE = ("plan.decode.rows", "plan.decode.build")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _fixture(kind, P=160, N=16, seed=3):
    """(beginning map, nodes, model, options): ``rack`` is a primary and a
    replica on another rack (racks of 4, one zone); ``multi`` two
    primaries, a replica and a read-only copy, flat."""
    rng = np.random.default_rng(seed)
    nodes = [f"n{i:03d}" for i in range(N)]
    states = RACK if kind == "rack" else MULTI
    beg = {}
    for i in range(P):
        held = [nodes[j] for j in rng.permutation(N)[:4]]
        nbs = {"primary": held[:1], "replica": held[1:2]} if kind == "rack" \
            else {"primary": held[:2], "replica": held[2:3],
                  "readonly": held[3:4]}
        beg[str(i)] = bt.Partition(str(i), nbs)
    if kind == "rack":
        hier = {n: f"r{i // 4}" for i, n in enumerate(nodes)}
        hier.update({f"r{i}": "z0" for i in range(N // 4)})
        opts = dict(node_hierarchy=hier,
                    hierarchy_rules={"replica": [bt.HierarchyRule(2, 1)]})
    else:
        opts = {}
    return beg, nodes, bt.model(**states), opts


def _spans(fn):
    """Run ``fn`` under a fresh recorder with a sink: (recorder, the
    finished spans, their names by span id)."""
    sink = InMemorySink()
    rec = Recorder(sinks=(sink,))
    with use_recorder(rec):
        fn()
    by_id = {sp.span_id: sp for sp in sink.spans}
    return rec, sink.spans, by_id


def _parent(sp, by_id):
    return by_id[sp.parent_id].name if sp.parent_id is not None else None


def _assert_nested(spans, by_id, want):
    """Each span of ``want`` (name -> parent name or None) has that
    parent and lies inside it in time."""
    for sp in spans:
        if sp.name not in want:
            continue
        assert _parent(sp, by_id) == want[sp.name], sp.name
        if sp.parent_id is not None:
            par = by_id[sp.parent_id]
            assert par.t_start <= sp.t_start <= sp.t_end <= par.t_end


def test_the_declared_tuple():
    assert PORT_ONLY_TELEMETRY == PORT_ONLY_SPANS + PORT_ONLY_COUNTERS
    assert set(PORT_ONLY_SPANS) == {"plan.audit", "plan.release", *ENCODE,
                                    *DECODE, *SPARSE_SPANS}
    assert set(PORT_ONLY_COUNTERS) == {"plan.solve.auction_rounds",
                                       "plan.solve.host_syncs",
                                       "plan.decode.rows_trimmed",
                                       "plan.encode.rows_keyed",
                                       "plan.decode.passthrough_rows",
                                       *SPARSE_MIN2, *SCORE_WRITE}


@pytest.mark.parametrize("kind", ["rack", "multi"])
def test_plan_next_map_spans_nest(kind):
    beg, nodes, model, opts = _fixture(kind)
    rec, spans, by_id = _spans(lambda: bt.plan_next_map(
        beg, beg, nodes, [nodes[5]], [], model, bt.PlanOptions(**opts),
        backend="cuda", device="cpu"))
    want = {name: "plan.encode" for name in ENCODE}
    want.update({name: "plan.decode" for name in DECODE})
    want["plan.audit"] = want["plan.release"] = "plan.plan_next_map"
    _assert_nested(spans, by_id, want)
    for name in PORT_ONLY_SPANS:
        # The matrix route opens none of the sparse engine's spans.
        assert rec.span_counts.get(name, 0) == \
            (name not in SPARSE_SPANS), name
    # The release is the plan's last stage, after the decode.
    by_name = {sp.name: sp for sp in spans}
    assert by_name["plan.decode"].t_end <= by_name["plan.release"].t_start
    # The reference's spans keep their parents.
    _assert_nested(spans, by_id, {
        "plan.encode": "plan.plan_next_map", "plan.solve":
        "plan.plan_next_map", "plan.decode": "plan.plan_next_map",
        "plan.solve.attempt": "plan.solve"})


def test_pipeline_spans_nest():
    beg, nodes, model, opts = _fixture("rack")
    rec, spans, by_id = _spans(lambda: bt.plan_pipeline(
        beg, beg, nodes, [nodes[2]], [], model, bt.PlanOptions(**opts),
        device="cpu"))
    want = {name: "plan.encode" for name in ENCODE}
    want.update({name: "plan.decode" for name in DECODE})
    want["plan.audit"] = "plan.pipeline"
    _assert_nested(spans, by_id, want)
    for name in PORT_ONLY_SPANS:
        assert rec.span_counts.get(name, 0) == \
            (name != "plan.release" and name not in SPARSE_SPANS), name


def test_session_spans():
    """The session opens no span of its own: its encode (load_map), its
    audits (the replan's and the warm gate's) and its decode (to_map)
    are top-level spans."""
    beg, nodes, model, opts = _fixture("rack")

    def drive():
        sess = bt.PlannerSession(model, nodes, list(beg), device="cpu",
                                 opts=bt.PlanOptions(**opts))
        sess.load_map(beg)
        sess.replan()
        sess.apply()
        sess.remove_nodes([nodes[3]])
        sess.replan()
        sess.to_map("proposed")

    rec, spans, by_id = _spans(drive)
    _assert_nested(spans, by_id, {name: None for name in PORT_ONLY_SPANS})
    # The constructor's encode and load_map's; the cold replan's audit,
    # the warm replan's gate and its audit; one decode; no release.
    assert {n: rec.span_counts[n] for n in port_names(rec.span_counts)} \
        == {**{n: 2 for n in ENCODE}, "plan.audit": 3,
            **{n: 1 for n in DECODE}}
    assert rec.counters["plan.solve.carry_hit"] == 1


class _Spy:
    """Counts the solver's rounds and host reads without the recorder."""

    FILES = (os.path.join("plan", "tensor.py"),
             os.path.join("core", "shortlist.py"))
    READS = ("item", "cpu", "tolist", "__bool__", "__int__", "__float__")

    def __init__(self, monkeypatch):
        self.rounds = 0
        self.reads = 0
        accept = ttensor._segment_accept

        def segment_accept(*a, **kw):
            if sys._getframe(1).f_code.co_name == "_assign_slot":
                self.rounds += 1
            return accept(*a, **kw)

        monkeypatch.setattr(ttensor, "_segment_accept", segment_accept)
        for name in self.READS:
            monkeypatch.setattr(torch.Tensor, name,
                                self._wrap(getattr(torch.Tensor, name)))

    def _wrap(self, method):
        spy = self

        def read(t, *a, **kw):
            if sys._getframe(1).f_code.co_filename.endswith(spy.FILES):
                spy.reads += 1
            return method(t, *a, **kw)

        return read


def _drive(path, beg, nodes, model, opts):
    if path == "plan_next_map":
        bt.plan_next_map(beg, beg, nodes, [nodes[5]], [], model,
                         bt.PlanOptions(**opts), backend="cuda",
                         device="cpu")
    elif path == "sparse":
        bt.plan_next_map(beg, beg, nodes, [nodes[5]], [], model,
                         bt.PlanOptions(sparse=True, sparse_k=3, **opts),
                         backend="cuda", device="cpu")
    elif path == "pipeline":
        bt.plan_pipeline(beg, beg, nodes, [nodes[5]], [], model,
                         bt.PlanOptions(**opts), device="cpu")
    else:  # the session: a cold replan, then the warm repair
        sess = bt.PlannerSession(model, nodes, list(beg), device="cpu",
                                 opts=bt.PlanOptions(**opts))
        sess.load_map(beg)
        sess.replan()
        sess.apply()
        sess.remove_nodes([nodes[5]])
        sess.replan()


@pytest.mark.parametrize("path", ["plan_next_map", "sparse", "pipeline",
                                  "session"])
@pytest.mark.parametrize("kind", ["rack", "multi"])
def test_counters_equal_the_spy(kind, path, monkeypatch):
    beg, nodes, model, opts = _fixture(kind)
    spy = _Spy(monkeypatch)
    rec = Recorder()
    with use_recorder(rec):
        _drive(path, beg, nodes, model, opts)
    monkeypatch.undo()
    assert spy.rounds > 0 and spy.reads > 0
    assert rec.counters["plan.solve.auction_rounds"] == spy.rounds
    assert rec.counters["plan.solve.host_syncs"] == spy.reads


def test_counters_declared_but_not_rendered():
    beg, nodes, model, opts = _fixture("rack")
    rec = Recorder()
    problem = tencode.encode_problem(beg, beg, nodes, [], model,
                                     bt.PlanOptions())
    short = problem.prev.copy()
    short[0, 0, :] = -1  # one row short of its state's copies
    with use_recorder(rec):
        _drive("plan_next_map", beg, nodes, model, opts)
        _drive("sparse", beg, nodes, model, opts)
        tencode.decode_assignment(problem, short, beg, [])
        # A map out of the planner's order, with a state the decode passes
        # through: its entries are looked up by hash, and the build reads
        # the marked row's source again.
        backwards = dict(reversed(beg.items()))
        first = next(iter(backwards))
        backwards[first] = bt.Partition(first, {
            **beg[first].nodes_by_state, "unmodeled": [nodes[0]]})
        other = tencode.encode_problem(backwards, backwards, nodes, [],
                                       model, bt.PlanOptions())
        tencode.decode_assignment(other, other.prev, backwards, [])
    # The score write counts on the card only: counted here by hand, to
    # hold it declared and unrendered with the others.
    assert not SCORE_WRITE & set(rec.counters)
    for name in SCORE_WRITE:
        rec.count(name, 7)
    assert set(PORT_ONLY_COUNTERS) <= set(rec.counters)
    assert default_registry().undeclared(rec) == []
    text = render_prometheus(rec)
    for name in PORT_ONLY_COUNTERS:
        assert name.replace(".", "_") not in text
    assert "blance_plan_solve_sweeps_total" in text


def test_merged_trace_puts_spans_on_the_profiler_clock(tmp_path):
    path = tmp_path / "t.json"
    rec = Recorder()
    with use_recorder(rec):
        with chrome.trace(str(path), recorder=rec,
                          device_log_dir=str(tmp_path / "dev")) as sink:
            with rec.span("outer"):
                time.sleep(0.005)
                with torch.profiler.record_function("probe"):
                    time.sleep(0.002)
                time.sleep(0.005)
            rec.count("plan.solve.host_syncs")
    assert sink.merged_path == str(tmp_path / "t.merged.json")
    assert abs(sink.clock_drift_s) < 0.005
    doc = json.loads((tmp_path / "t.merged.json").read_text())
    assert doc["hostClockDrift_s"] == sink.clock_drift_s
    events = doc["traceEvents"]
    (outer,) = [e for e in events if e.get("name") == "outer"]
    (probe,) = [e for e in events if e.get("name") == "probe"]
    assert "span_id" in outer["args"]
    assert outer["ts"] <= probe["ts"]
    assert probe["ts"] + probe["dur"] <= outer["ts"] + outer["dur"]
    # The span is no profiler range: the profiler's file has the probe
    # and not the span; the sink's own file keeps its format.
    (dev,) = os.listdir(tmp_path / "dev")
    prof = json.loads((tmp_path / "dev" / dev).read_text())
    names = {e.get("name") for e in prof["traceEvents"]}
    assert "probe" in names and "outer" not in names
    own = json.loads(path.read_text())["traceEvents"]
    (x,) = [e for e in own if e["name"] == "outer"]
    assert x["ph"] == "X" and x["args"] == outer["args"]
    assert x["dur"] == outer["dur"]
    assert any(e["ph"] == "C" and e["name"] == "plan.solve.host_syncs"
               for e in events)


def test_timings_are_the_span_durations():
    beg, nodes, model, opts = _fixture("rack")
    timings = {}
    rec, spans, _ = _spans(lambda: bt.plan_next_map(
        beg, beg, nodes, [nodes[5]], [], model, bt.PlanOptions(**opts),
        backend="cuda", device="cpu", timings=timings))
    by_name = {sp.name: sp for sp in spans}
    assert timings["encode_s"] == by_name["plan.encode"].duration_s
    assert timings["solve_s"] == by_name["plan.solve"].duration_s
    assert timings["decode_s"] == by_name["plan.decode"].duration_s
    audit = by_name["plan.audit"]
    assert audit.duration_s <= timings["audit_s"] == \
        by_name["plan.decode"].t_start - by_name["plan.solve"].t_end
