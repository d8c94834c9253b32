"""The port's PlannerSession and the session paths of its rebalance facade
against the JAX package, on the CPU.

Both packages run the same session script (load, deltas, replan, moves,
apply) on the same inputs; every proposed assignment, every move array,
the final state and the ``plan.solve.*`` counters each package's recorder
kept must be equal, exactly (the fixtures use whole-number weights).  The
port's sessions run with ``device="cpu"``, where every kernel takes its
plain version.  ``rebalance(session=)`` and ``RebalanceController(
session=)`` run each on its own package's DeterministicLoop, each
package's recorder on its virtual clock, so op logs compare exactly too.
"""

import asyncio
import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import blance_tpu  # noqa: E402
import blance_tpu.obs as jobs  # noqa: E402
import blance_tpu.orchestrate as jorch  # noqa: E402
import blance_tpu_torch as bt  # noqa: E402
import blance_tpu_torch.obs as tobs  # noqa: E402
import blance_tpu_torch.orchestrate as torch_orch  # noqa: E402
from blance_tpu.plan.session import PlannerSession as JSession  # noqa: E402
from blance_tpu.testing.sched import DeterministicLoop as JLoop  # noqa: E402
from blance_tpu_torch.plan import session as tsession  # noqa: E402
from blance_tpu_torch.plan import tensor as ttensor  # noqa: E402
from blance_tpu_torch.plan.audit import check_assignment  # noqa: E402
from blance_tpu_torch.testing.sched import DeterministicLoop as TLoop  # noqa: E402

jreb = importlib.import_module("blance_tpu.rebalance")
treb = importlib.import_module("blance_tpu_torch.rebalance")

REF = dict(lib=blance_tpu, obs=jobs, orch=jorch, reb=jreb, loop=JLoop,
           session=JSession, kw={})
PORT = dict(lib=bt, obs=tobs, orch=torch_orch, reb=treb, loop=TLoop,
            session=bt.PlannerSession, kw=dict(device="cpu"))
STATES = dict(primary=(0, 1), replica=(1, 1))
NODES = [f"n{i}" for i in range(8)]
PARTS = [str(i) for i in range(64)]
CLEAN = {"duplicates": 0, "on_removed_nodes": 0,
         "unfilled_feasible_slots": 0, "hierarchy_misses": 0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def rack_opts(lib, nodes=NODES + ["x0", "x1"], racks_of=4):
    hier = {n: f"r{i // racks_of}" for i, n in enumerate(nodes)}
    hier.update({f"r{i}": "z0"
                 for i in range((len(nodes) + racks_of - 1) // racks_of)})
    return lib.PlanOptions(
        node_hierarchy=hier,
        hierarchy_rules={"replica": [lib.HierarchyRule(2, 1)]})


OPTS = [pytest.param(lambda lib: None, id="flat"),
        pytest.param(rack_opts, id="rack-rules")]


def _plan_counters(rec):
    return {k: v for k, v in rec.counters.items() if k.startswith("plan.")}


def _run_script(pkg, script, opts_fn, nodes=NODES, parts=PARTS):
    """Run ``script`` (a list of (method, *args)) on a fresh session of
    ``pkg``; returns every array a step returned, the final current, the
    plan counters, the dirty-fraction histogram and the session."""
    rec = pkg["obs"].Recorder()
    outs = []
    with pkg["obs"].use_recorder(rec):
        s = pkg["session"](pkg["lib"].model(**STATES), list(nodes),
                           list(parts), opts=opts_fn(pkg["lib"]),
                           **pkg["kw"])
        for op, *args in script:
            if op == "reload":  # checkpoint round trip: to_map -> load_map
                s.load_map(s.to_map()[0])
                continue
            got = getattr(s, op)(*args)
            if isinstance(got, np.ndarray):
                outs.append(got.copy())
            elif isinstance(got, tuple) and op == "moves":
                outs.extend(a.copy() for a in got)
    return outs, s.current.copy(), _plan_counters(rec), \
        rec.histogram_summary("plan.solve.dirty_fraction"), s


WARM = [("replan",), ("apply",)]
SCRIPTS = {
    # Successive deltas each warm-start from the previous apply.
    "steady-loop": WARM + [("remove_nodes", ["n1"]), ("replan",), ("apply",),
                           ("remove_nodes", ["n4"]), ("replan",), ("apply",),
                           ("remove_nodes", ["n6"]), ("replan",), ("apply",)],
    # The carry activates only on apply; a second replan without one
    # finds it consumed and solves cold.
    "promote-on-apply": WARM + [("remove_nodes", ["n2"]), ("replan",),
                                ("replan",)],
    # A node added while a proposal is pending pads the pending carry.
    "add-between": WARM + [("replan",), ("add_nodes", ["x0"]), ("apply",),
                           ("replan",)],
    # A removal after replan() survives apply() in the post mask.
    "remove-between": WARM + [("replan",), ("remove_nodes", ["n4"]),
                              ("apply",), ("replan",)],
    "reload": WARM + [("reload",), ("remove_nodes", ["n3"]), ("replan",)],
    "node-weights": WARM + [("set_node_weights", {"n0": 3}),
                            ("remove_nodes", ["n5"]), ("replan",),
                            ("apply",), ("remove_nodes", ["n6"]),
                            ("replan",)],
    "partition-weights": WARM + [("set_partition_weights", {"3": 2, "7": 3}),
                                 ("remove_nodes", ["n5"]), ("replan",),
                                 ("apply",), ("remove_nodes", ["n6"]),
                                 ("replan",)],
    "readd": WARM + [("remove_nodes", ["n2"]), ("replan",), ("apply",),
                     ("add_nodes", ["n2"]), ("replan",), ("apply",)],
    "grow": WARM + [("add_nodes", ["x0", "x1", "x0"]), ("replan",),
                    ("apply",), ("remove_nodes", ["n0"]), ("replan",)],
    "moves": WARM + [("remove_nodes", ["n3"]), ("replan",), ("moves",),
                     ("moves", True), ("apply",)],
    "recovery": WARM + [("recovery_replan", ["n5"]), ("apply",),
                        ("recovery_replan", ["n7"])],
}


@pytest.mark.parametrize("opts_fn", OPTS)
@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_session_script_matches_jax(name, opts_fn):
    want = _run_script(REF, SCRIPTS[name], opts_fn)
    got = _run_script(PORT, SCRIPTS[name], opts_fn)
    assert len(got[0]) == len(want[0])
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        np.testing.assert_array_equal(g, w, f"step output {i}")
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    assert got[3] == want[3]
    s = got[4]
    last = s.proposed if s.proposed is not None else s.current
    assert check_assignment(s.problem, last) == CLEAN
    assert s.nodes == want[4].nodes
    assert s.removed_nodes == want[4].removed_nodes


def test_steady_loop_rides_the_carry():
    """Every replan after the first is a carry hit of one sweep, and
    the victims are drained."""
    outs, current, counters, hist, s = _run_script(
        PORT, SCRIPTS["steady-loop"], lambda lib: None)
    assert counters["plan.solve.carry_hit"] == 3
    assert counters["plan.solve.carry_miss"] == 1  # the first, cold replan
    assert counters["plan.solve.calls"] == 4
    assert hist["count"] == 3 and 0.0 < hist["max"] < 1.0
    for victim in ("n1", "n4", "n6"):
        assert not (current == s.nodes.index(victim)).any()


def test_carry_promoted_only_on_apply():
    outs, _cur, counters, _h, _s = _run_script(
        PORT, SCRIPTS["promote-on-apply"], lambda lib: None)
    assert counters.get("plan.solve.carry_hit", 0) == 1
    np.testing.assert_array_equal(outs[1], outs[2])


@pytest.mark.parametrize("script", ["reload", "node-weights",
                                    "partition-weights"])
def test_invalidation_forces_cold(script):
    """load_map and weight changes drop the carry: the next replan is a
    miss, and a replan after a later apply is warm again."""
    _outs, _cur, counters, _h, s = _run_script(PORT, SCRIPTS[script],
                                               lambda lib: None)
    assert counters["plan.solve.carry_miss"] >= 2
    assert counters.get("plan.solve.carry_hit", 0) == \
        (0 if script == "reload" else 1)


def _apply_delta(s, delta):
    if "remove" in delta:
        s.remove_nodes(delta["remove"])
    if "add" in delta:
        s.add_nodes(delta["add"])


@pytest.mark.parametrize("opts_fn", OPTS)
@pytest.mark.parametrize("delta", [
    pytest.param({"remove": ["n3"]}, id="remove-1"),
    pytest.param({"remove": ["n1", "n6"]}, id="remove-2"),
    pytest.param({"add": ["x0"]}, id="add-1"),
    pytest.param({"remove": ["n2"], "add": ["x0", "x1"]}, id="mixed"),
])
def test_warm_replan_identical_to_cold(delta, opts_fn):
    """tests/test_warm_replan.py's property on the port: a warm replan
    equals a cold session's replan of the same map and removed set (the
    same opts object, so added nodes sit where they sit in both)."""
    rec = tobs.Recorder()
    with tobs.use_recorder(rec):
        opts = opts_fn(bt)
        s = bt.PlannerSession(bt.model(**STATES), list(NODES), list(PARTS),
                              opts=opts, device="cpu")
        s.replan()
        s.apply()
        _apply_delta(s, delta)
        warm = s.replan().copy()
        c = bt.PlannerSession(bt.model(**STATES), s.nodes, list(PARTS),
                              opts=opts, device="cpu")
        c.load_map(s.to_map()[0])
        if s.removed_nodes:
            c.remove_nodes(s.removed_nodes)
        cold = c.replan()
    np.testing.assert_array_equal(warm, cold)
    assert check_assignment(s.problem, warm) == CLEAN


def test_warm_remove_halves_sweeps():
    """A one-node removal replanned warm records at least 2x fewer
    plan.solve.sweeps than its cold twin, and equals it."""
    rec = tobs.Recorder()
    with tobs.use_recorder(rec):
        s = bt.PlannerSession(bt.model(**STATES), list(NODES), list(PARTS),
                              device="cpu")
        s.replan()
        s.apply()
        twin = bt.PlannerSession(bt.model(**STATES), list(NODES),
                                 list(PARTS), device="cpu")
        twin.load_map(s.to_map()[0])
        s.remove_nodes(["n3"])
        twin.remove_nodes(["n3"])
        c0 = rec.counters["plan.solve.sweeps"]
        warm = s.replan().copy()
        warm_sweeps = rec.counters["plan.solve.sweeps"] - c0
        c1 = rec.counters["plan.solve.sweeps"]
        cold = twin.replan()
        cold_sweeps = rec.counters["plan.solve.sweeps"] - c1
    np.testing.assert_array_equal(warm, cold)
    assert rec.counters["plan.solve.carry_hit"] == 1
    assert warm_sweeps == 1 and warm_sweeps * 2 <= cold_sweeps


def test_failed_warm_repair_warns_and_falls_back(monkeypatch):
    """An engine failure inside the repair degrades to the cold solve
    with the reference's UserWarning and warm_fallback count; the result
    equals the cold twin."""
    def boom(*a, **k):
        raise RuntimeError("device lost")

    s = bt.PlannerSession(bt.model(**STATES), list(NODES), list(PARTS),
                          device="cpu")
    s.replan()
    s.apply()
    twin = bt.PlannerSession(bt.model(**STATES), list(NODES), list(PARTS),
                             device="cpu")
    twin.load_map(s.to_map()[0])
    s.remove_nodes(["n3"])
    twin.remove_nodes(["n3"])
    monkeypatch.setattr(ttensor, "solve_dense_warm", boom)
    rec = tobs.Recorder()
    with tobs.use_recorder(rec), pytest.warns(UserWarning, match="warm "
                                              "repair failed"):
        out = s.replan().copy()
    assert rec.counters["plan.solve.warm_fallback"] == 1
    assert "plan.solve.carry_hit" not in rec.counters
    np.testing.assert_array_equal(out, twin.replan())


def test_audit_gate_rejects_a_violating_repair(monkeypatch):
    """A repaired map the audit flags is not adopted: warm_fallback,
    then the cold solve."""
    s = bt.PlannerSession(bt.model(**STATES), list(NODES), list(PARTS),
                          device="cpu")
    s.replan()
    s.apply()
    s.remove_nodes(["n3"])
    real = ttensor.solve_dense_warm

    def bad_repair(*a, **k):
        out, carry = real(*a, **k)
        out = out.copy()
        out[0, 1, 0] = out[0, 0, 0]  # a duplicate placement
        return out, carry

    monkeypatch.setattr(ttensor, "solve_dense_warm", bad_repair)
    rec = tobs.Recorder()
    with tobs.use_recorder(rec):
        out = s.replan()
    assert rec.counters["plan.solve.warm_fallback"] == 1
    assert check_assignment(s.problem, out) == CLEAN


def test_sessions_share_a_keyed_cache():
    cache = bt.CarryCache()
    sessions = [bt.PlannerSession(bt.model(**STATES), list(NODES),
                                  list(PARTS), carry_cache=cache,
                                  cache_key=f"tenant-{i}", device="cpu")
                for i in range(2)]
    for s in sessions:
        s.replan()
        s.apply()
    assert set(cache.keys()) == {"tenant-0", "tenant-1"}
    assert cache.nbytes() == cache._recount() > 0
    rec = tobs.Recorder()
    with tobs.use_recorder(rec):
        for s, victim in zip(sessions, ("n0", "n1")):
            s.remove_nodes([victim])
            s.replan()
    assert rec.counters["plan.solve.carry_hit"] == 2


def test_session_edges():
    """The reference's edge cases: moves/to_map before a replan, unknown
    nodes or partitions in load_map, duplicate adds, an empty problem,
    and the card by default."""
    s = bt.PlannerSession(bt.model(**STATES), list(NODES), list(PARTS),
                          device="cpu")
    with pytest.raises(ValueError):
        s.moves()
    with pytest.raises(ValueError):
        s.to_map("proposed")
    with pytest.raises(ValueError):
        s.to_map("bogus")
    with pytest.raises(ValueError, match="not-a-node"):
        s.load_map({p: bt.Partition(p, {"primary": ["not-a-node"]})
                    for p in PARTS})
    with pytest.raises(ValueError, match="ghost"):
        s.load_map({"ghost": bt.Partition("ghost", {})})
    s.add_nodes(["x0", "x0", "x0"])
    assert s.nodes.count("x0") == 1 and s.problem.N == len(NODES) + 1
    empty = bt.PlannerSession(bt.model(**STATES), list(NODES), [],
                              device="cpu")
    assert empty.replan().shape[0] == 0


def test_session_asks_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        bt.PlannerSession(bt.model(**STATES), list(NODES), list(PARTS))


def test_matches_one_shot_plan():
    """A session replan equals the port's one-shot plan_next_map."""
    s = bt.PlannerSession(bt.model(**STATES), list(NODES), list(PARTS),
                          device="cpu")
    s.replan()
    s.apply()
    prev_map, _ = s.to_map()
    s.remove_nodes(["n0"])
    s.replan()
    dense_map, _ = s.to_map("proposed")
    one_shot, _ = bt.plan_next_map(prev_map, prev_map, NODES, ["n0"], [],
                                   bt.model(**STATES), device="cpu")
    assert bt.partition_map_to_json(dense_map) == \
        bt.partition_map_to_json(one_shot)


# --- rebalance(session=) and RebalanceController(session=) ---------------------


def _on_loop(pkg, make_coro):
    loop = pkg["loop"]()
    rec = pkg["obs"].Recorder(clock=loop.time)
    with pkg["obs"].use_recorder(rec):
        out = loop.run_until_complete(make_coro())
    return out, rec


def _tracker(current):
    cluster = {k: {s: list(ns) for s, ns in p.nodes_by_state.items()}
               for k, p in current.items()}
    log = []

    async def assign(stop_ch, node, partitions, states, ops):
        for p, s, op in zip(partitions, states, ops):
            log.append((p, node, s, op))
            for ns in cluster[p].values():
                if node in ns:
                    ns.remove(node)
            if s:
                cluster[p].setdefault(s, []).append(node)
        await asyncio.sleep(0)

    return cluster, log, assign


def _round_robin(lib, n_parts, nodes):
    return {f"{i:02d}": lib.Partition(f"{i:02d}", {
        "primary": [nodes[i % len(nodes)]],
        "replica": [nodes[(i + 1) % len(nodes)]]}) for i in range(n_parts)}


def _ft_opts(pkg):
    return pkg["orch"].OrchestratorOptions(
        move_timeout_s=0.25, max_retries=4, backoff_base_s=0.002,
        backoff_jitter=0.25, quarantine_after=3, probe_after_s=60.0)


def _result_view(lib, r):
    return dict(
        next_map=lib.partition_map_to_json(r.next_map),
        achieved=None if r.achieved_map is None else
        lib.partition_map_to_json(r.achieved_map),
        failures=[str(f) for f in r.failures],
        rounds=[(x.round, x.dead_nodes, x.failures, x.progress_events)
                for x in r.rounds],
        quarantined=r.quarantined_nodes, converged=r.converged,
        events=r.progress_events)


def _recovery(pkg):
    """tests/test_faults.py's session recovery: d decommissions while e
    joins dead on arrival, two recovery rounds through the session."""
    lib = pkg["lib"]
    live = ["a", "b", "c", "d"]
    nodes = live + ["e"]
    beg = _round_robin(lib, 16, live)
    session = pkg["session"](lib.model(**STATES), nodes, sorted(beg),
                             **pkg["kw"])
    _cluster, log, assign = _tracker(beg)
    plan = pkg["orch"].FaultPlan(seed=7, nodes={
        "e": pkg["orch"].NodeFaults(dead=True)})

    def make():
        return pkg["reb"].rebalance_async(
            lib.model(**STATES), beg, nodes, ["d"], ["e"],
            plan.wrap(assign), orchestrator_options=_ft_opts(pkg),
            max_recovery_rounds=2, session=session)

    result, rec = _on_loop(pkg, make)
    return result, log, _plan_counters(rec), session


def test_rebalance_session_recovery_matches_jax():
    want, want_log, want_c, jsess = _recovery(REF)
    got, log, counters, session = _recovery(PORT)
    assert _result_view(bt, got) == _result_view(blance_tpu, want)
    assert log == want_log
    assert counters == want_c
    np.testing.assert_array_equal(session.current, jsess.current)
    assert got.quarantined_nodes == ["e"] and got.rounds[-1].failures == 0
    # The session adopted the recovery proposal as its current state.
    assert session.to_map("current")[0] == got.next_map
    assert any(k.startswith("plan.solve.carry") for k in counters)


def _repeat(pkg):
    """tests/test_faults.py's repeat rebalance: the second call through
    the adopted session skips load_map and rides the carry."""
    lib = pkg["lib"]
    nodes = ["a", "b", "c", "d"]
    beg = _round_robin(lib, 12, nodes)
    session = pkg["session"](lib.model(**STATES), nodes, sorted(beg),
                             **pkg["kw"])
    _cluster, log, assign = _tracker(beg)

    def first():
        return pkg["reb"].rebalance_async(
            lib.model(**STATES), beg, nodes, [], [], assign,
            orchestrator_options=_ft_opts(pkg), session=session)

    r1, _rec1 = _on_loop(pkg, first)
    promoted = session._carry is not None

    def second():
        return pkg["reb"].rebalance_async(
            lib.model(**STATES), r1.next_map, nodes, ["d"], [], assign,
            orchestrator_options=_ft_opts(pkg), session=session)

    r2, rec2 = _on_loop(pkg, second)
    return r1, r2, log, _plan_counters(rec2), promoted, session


def test_repeat_rebalance_through_session_matches_jax():
    w1, w2, want_log, want_c, _wp, jsess = _repeat(REF)
    g1, g2, log, counters, promoted, session = _repeat(PORT)
    assert _result_view(bt, g1) == _result_view(blance_tpu, w1)
    assert _result_view(bt, g2) == _result_view(blance_tpu, w2)
    assert log == want_log and counters == want_c
    np.testing.assert_array_equal(session.current, jsess.current)
    assert promoted, "clean pass did not promote the carry"
    assert counters["plan.solve.carry_hit"] == 1
    assert "plan.solve.carry_miss" not in counters


def _controller(pkg):
    """A controller with a session: one graceful removal and one
    failure, then a weight delta, each quiesced."""
    lib = pkg["lib"]
    nodes = [f"n{i}" for i in range(6)]
    beg = _round_robin(lib, 24, nodes[:5])
    session = pkg["session"](lib.model(**STATES), list(nodes), sorted(beg),
                             **pkg["kw"])
    _cluster, log, assign = _tracker(beg)

    async def drive():
        ctl = pkg["reb"].RebalanceController(
            lib.model(**STATES), nodes, beg, assign, debounce_s=0.01,
            session=session)
        ctl.start()
        ctl.submit(pkg["reb"].ClusterDelta(remove=("n1",), fail=("n3",)))
        first = await ctl.quiesce()
        ctl.submit(pkg["reb"].ClusterDelta(remove=("n4",)))
        second = await ctl.quiesce()
        ctl.submit(pkg["reb"].ClusterDelta(partition_weights={"03": 2}))
        third = await ctl.quiesce()
        await ctl.stop()
        return ctl, [first, second, third]

    (ctl, maps), rec = _on_loop(pkg, drive)
    return ctl, [lib.partition_map_to_json(m) for m in maps], log, \
        _plan_counters(rec), session


def test_controller_with_session_matches_jax():
    want_ctl, want_maps, want_log, want_c, jsess = _controller(REF)
    ctl, maps, log, counters, session = _controller(PORT)
    assert maps == want_maps and log == want_log
    assert counters == want_c
    assert (ctl.cycles, ctl.passes, ctl.failures) == \
        (want_ctl.cycles, want_ctl.passes, [])
    np.testing.assert_array_equal(session.current, jsess.current)
    assert counters.get("plan.solve.carry_hit", 0) >= 1
    gone = {"n1", "n3", "n4"}
    final = bt.partition_map_from_json(maps[-1])
    assert not any(n in gone for p in final.values()
                   for ns in p.nodes_by_state.values() for n in ns)


def test_controller_session_and_planner_are_exclusive():
    s = bt.PlannerSession(bt.model(**STATES), ["a"], ["p0"], device="cpu")
    cur = {"p0": bt.Partition("p0", {"primary": ["a"]})}
    with pytest.raises(ValueError, match="mutually exclusive"):
        bt.RebalanceController(bt.model(**STATES), ["a"], cur,
                               lambda *a: None, device="cpu", session=s,
                               planner=object())


def test_session_module_surface():
    assert tsession.__all__ == ["PlannerSession"]
    assert bt.PlannerSession is tsession.PlannerSession
