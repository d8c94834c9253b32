"""The port's rebalance facade against the JAX package, on the CPU.

``rebalance`` runs plan -> diff -> orchestrate.  The port plans with
``backend="cuda", device="cpu"`` and the reference with ``backend="tpu"``;
both orchestrate the same host code.  Each run goes on a fresh
DeterministicLoop of the reference's testing tier, with each package's own
recorder on the loop's virtual clock, so the op logs, progress, result
counts and SLO summaries are compared exactly.
"""

import asyncio
import dataclasses
import importlib

import pytest
import torch

jax = pytest.importorskip("jax")

import blance_tpu  # noqa: E402
import blance_tpu.obs as jobs  # noqa: E402
import blance_tpu.orchestrate as jorch  # noqa: E402
import blance_tpu_torch as bt  # noqa: E402
import blance_tpu_torch.obs as tobs  # noqa: E402
import blance_tpu_torch.orchestrate as torch_orch  # noqa: E402
from blance_tpu.testing.sched import DeterministicLoop  # noqa: E402
from test_torch_plan import _opts, _rack_delta, _weighted  # noqa: E402

# Both packages export a function ``rebalance`` that shadows the module.
jreb = importlib.import_module("blance_tpu.rebalance")
treb = importlib.import_module("blance_tpu_torch.rebalance")

REF = dict(lib=blance_tpu, obs=jobs, orch=jorch, reb=jreb,
           plan=dict(backend="tpu"))
PORT = dict(lib=bt, obs=tobs, orch=torch_orch, reb=treb,
            plan=dict(backend="cuda", device="cpu"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data_plane(lib, current):
    """An in-memory cluster the op log is replayed onto, and the log."""
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


def _on_loop(pkg, make_coro):
    loop = DeterministicLoop()
    rec = pkg["obs"].Recorder(clock=loop.time)
    with pkg["obs"].use_recorder(rec):
        out = loop.run_until_complete(make_coro())
    return out, rec


def _placed(nbs_by_name):
    return {k: {s: sorted(ns) for s, ns in nbs.items() if ns}
            for k, nbs in nbs_by_name.items()}


def _summary(result):
    """Everything comparable across the packages in a RebalanceResult."""
    prog = {f.name: getattr(result.progress, f.name)
            for f in dataclasses.fields(result.progress) if f.name != "errors"}
    return dict(
        next_map=blance_tpu.partition_map_to_json(result.next_map),
        warnings=result.warnings, progress=prog,
        errors=[str(e) for e in result.progress.errors],
        progress_events=result.progress_events,
        failures=[str(f) for f in result.failures],
        rounds=[(r.round, r.dead_nodes, r.failures, r.progress_events)
                for r in result.rounds],
        achieved=None if result.achieved_map is None else
        blance_tpu.partition_map_to_json(result.achieved_map),
        quarantined=result.quarantined_nodes, converged=result.converged,
        residual=result.residual_failures,
        slo=dataclasses.asdict(result.slo),
        phases=sorted(result.timer.report()))


def _rebalance(pkg, fixture, orch_kw, **kw):
    prev, nodes, removed, states, spec = fixture()
    lib = pkg["lib"]
    current = lib.partition_map_from_json(
        blance_tpu.partition_map_to_json(prev))
    cluster, log, assign = _data_plane(lib, current)

    def make():
        return pkg["reb"].rebalance_async(
            lib.model(**states), current, nodes, removed, [], assign,
            plan_options=_opts(lib, spec),
            orchestrator_options=pkg["orch"].OrchestratorOptions(**orch_kw),
            **pkg["plan"], **kw)

    result, rec = _on_loop(pkg, make)
    return result, log, cluster, rec


@pytest.mark.parametrize("orch_kw", [
    dict(),
    dict(device_diff=True, interrupt_on_first_feed=False,
         max_concurrent_partition_moves_per_node=4),
], ids=["exact-host-diff", "throughput-device-diff"])
@pytest.mark.parametrize("fixture", [_rack_delta, _weighted])
def test_rebalance_matches_reference(fixture, orch_kw):
    want, want_log, _, jrec = _rebalance(REF, fixture, orch_kw)
    got, log, cluster, trec = _rebalance(PORT, fixture, orch_kw)
    assert _summary(got) == _summary(want)
    assert log == want_log
    assert log and not got.progress.errors
    # The replayed op log reaches the planned map.
    assert _placed(cluster) == _placed(
        {k: p.nodes_by_state for k, p in got.next_map.items()})
    keys = ("orchestrate.tot_mover_assign_partition_ok", "moves.total_ops")
    assert {k: trec.counters.get(k) for k in keys} == \
        {k: jrec.counters.get(k) for k in keys}


def _chaos_fixture():
    """Round-robin primaries and replicas over four nodes; "a" is
    removed and a fifth node joins and is dead on arrival, so the plan
    moves copies onto it (tests/test_faults.py's shape)."""
    live = ["a", "b", "c", "d"]
    prev = {f"p{i}": blance_tpu.Partition(
        f"p{i}", {"primary": [live[i % 4]], "replica": [live[(i + 1) % 4]]})
        for i in range(16)}
    return prev, live + ["e"], ["a"], dict(primary=(0, 1), replica=(1, 1)), \
        {}


def _chaos(pkg):
    prev, nodes, removed, states, _spec = _chaos_fixture()
    lib = pkg["lib"]
    current = lib.partition_map_from_json(
        blance_tpu.partition_map_to_json(prev))
    _cluster, log, assign = _data_plane(lib, current)
    plan = pkg["orch"].FaultPlan(seed=3, nodes={
        "b": pkg["orch"].NodeFaults(fail_rate=0.3),
        "e": pkg["orch"].NodeFaults(dead=True)})
    opts = pkg["orch"].OrchestratorOptions(
        move_timeout_s=0.25, max_retries=2, backoff_base_s=0.01,
        quarantine_after=2, probe_after_s=600.0)

    def make():
        return pkg["reb"].rebalance_async(
            lib.model(**states), current, nodes, removed, ["e"],
            plan.wrap(assign), orchestrator_options=opts,
            max_recovery_rounds=1, **pkg["plan"])

    result, rec = _on_loop(pkg, make)
    return result, log, dict(plan.injected), rec


def test_fault_tolerant_rebalance_matches_reference():
    want, want_log, want_inj, jrec = _chaos(REF)
    got, log, inj, trec = _chaos(PORT)
    assert _summary(got) == _summary(want)
    assert log == want_log and inj == want_inj
    assert got.failures and "e" in got.quarantined_nodes
    assert len(got.rounds) == 2
    assert trec.counters["rebalance.recovery_rounds"] == \
        jrec.counters["rebalance.recovery_rounds"] == 1


def test_checkpoint_round_trip(tmp_path):
    path = str(tmp_path / "target.json")
    result, _log, _cluster, _rec = _rebalance(PORT, _weighted, {},
                                              checkpoint_path=path)
    loaded = treb.load_partition_map(path)
    assert bt.partition_map_to_json(loaded) == \
        bt.partition_map_to_json(result.next_map)
    again = str(tmp_path / "again.json")
    treb.save_partition_map(loaded, again)
    assert bt.partition_map_to_json(treb.load_partition_map(again)) == \
        bt.partition_map_to_json(loaded)
    assert "checkpoint" in result.timer.report()


def test_session_is_not_ported():
    """The part of a PlannerSession the port does not have yet raises and
    names its ROADMAP item: the sharded session (mesh=, A.9).  The fused
    replan (replan_with_moves) runs: on a one-partition session it
    returns the proposal and its move arrays (the session itself in
    tests/test_torch_session.py, the pipeline in
    tests/test_torch_pipeline.py)."""
    m = bt.model(primary=(0, 1))
    with pytest.raises(NotImplementedError, match="A.9"):
        bt.PlannerSession(m, ["a", "b"], ["p0"], mesh=object(),
                          device="cpu")
    s = bt.PlannerSession(m, ["a", "b"], ["p0"], device="cpu")
    assign, (nodes, states, ops) = s.replan_with_moves()
    assert assign.shape == (1, 1, 1) and assign[0, 0, 0] in (0, 1)
    assert nodes.shape == states.shape == ops.shape == (1, 2)
    assert ops[0].tolist() == [0, -1]  # one add into the empty slot
    assert nodes[0, 0] == assign[0, 0, 0]


def test_rebalance_asks_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = bt.model(primary=(0, 1))
    cur = {"p0": bt.Partition("p0", {"primary": ["a"]})}
    with pytest.raises(RuntimeError, match="is_available"):
        bt.rebalance(m, cur, ["a", "b"], ["a"], [], lambda *a: None)


@pytest.mark.parametrize("backend", ["auto", "cuda"])
def test_rebalance_backends_ask_for_the_card(monkeypatch, backend):
    """"auto" sends a problem this small to the host's native planner, as
    the reference routes, yet a rebalance on the default device="cuda"
    raises without a card on both backends that may use it; with
    device="cpu" the same "auto" call plans on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = bt.model(primary=(0, 1))
    cur = {"p0": bt.Partition("p0", {"primary": ["a"]})}
    with pytest.raises(RuntimeError, match="is_available"):
        bt.rebalance(m, cur, ["a", "b"], ["a"], [], lambda *a: None,
                     backend=backend)
    if backend == "auto":
        res = bt.rebalance(m, cur, ["a", "b"], ["a"], [], lambda *a: None,
                           backend=backend, device="cpu")
        assert res.next_map["p0"].nodes_by_state["primary"] == ["b"]


def _controller(pkg, backend):
    """Start a controller on the rack-delta map, submit one delta (a
    graceful removal and a failure), quiesce, stop."""
    prev, nodes, removed, states, spec = _rack_delta()
    lib = pkg["lib"]
    current = lib.partition_map_from_json(
        blance_tpu.partition_map_to_json(prev))
    _cluster, log, assign = _data_plane(lib, current)
    plan_kw = dict(pkg["plan"], backend=backend)

    async def drive():
        ctl = pkg["reb"].RebalanceController(
            lib.model(**states), nodes, current, assign,
            plan_options=_opts(lib, spec), debounce_s=0.01, **plan_kw)
        ctl.start()
        ctl.submit(pkg["reb"].ClusterDelta(remove=tuple(removed[:3]),
                                           fail=tuple(removed[3:])))
        final = await ctl.quiesce()
        await ctl.stop()
        return ctl, final

    (ctl, final), _rec = _on_loop(pkg, drive)
    return ctl, final, log


def test_controller_matches_reference():
    want_ctl, want, want_log = _controller(REF, "tpu")
    got_ctl, got, log = _controller(PORT, "cuda")
    assert bt.partition_map_to_json(got) == \
        blance_tpu.partition_map_to_json(want)
    assert log == want_log
    assert (got_ctl.cycles, got_ctl.passes, got_ctl.failures) == \
        (want_ctl.cycles, want_ctl.passes, [])
    gone = set(_rack_delta()[2])
    assert not any(n in gone for p in got.values()
                   for ns in p.nodes_by_state.values() for n in ns)
