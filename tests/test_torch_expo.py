"""The port's exposition plane against the reference's, on the CPU.

- ``default_registry()`` declares the reference's (name, kind) pairs.
- Every metric name the port's plan, pipeline, session, fleet, rebalance
  and observatory paths emit is declared (the port's counterpart of the
  reference's pipeline drift guard).
- ``render_prometheus`` output parses with both packages' parsers, and
  one recorder's rendering is the same text through both.
- The reference's registry, render, server and healthz cases of
  ``tests/test_telemetry.py`` / ``tests/test_device_obs.py`` run again
  with their names bound to the port's.
- ``python -m blance_tpu_torch.obs --smoke`` on the CPU.
"""

import asyncio
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")  # the reference package imports it

import blance_tpu.obs as jobs  # noqa: E402
import blance_tpu.orchestrate.orchestrator as j_orch  # noqa: E402

import blance_tpu_torch as bt  # noqa: E402
import blance_tpu_torch.obs as tobs  # noqa: E402
from blance_tpu_torch.obs import (  # noqa: E402
    CostModel, Recorder, SloTracker, default_registry, expo,
    parse_prometheus, render_prometheus, use_recorder)
from blance_tpu_torch.obs import device  # noqa: E402
from blance_tpu_torch.orchestrate import orchestrator as t_orch  # noqa: E402
from blance_tpu_torch.orchestrate.faults import (  # noqa: E402
    FaultPlan, NodeFaults)
from blance_tpu_torch.plan import fleet as t_fleet  # noqa: E402

import test_device_obs as ref_dev  # noqa: E402
import test_telemetry as ref_tel  # noqa: E402
from test_torch_durability import call_with_fixtures, rebind  # noqa: E402

BINDINGS = {
    "Recorder": tobs.Recorder, "use_recorder": tobs.use_recorder,
    "MetricsServer": tobs.MetricsServer, "scrape": tobs.scrape,
    "default_registry": tobs.default_registry,
    "render_prometheus": tobs.render_prometheus,
    "parse_prometheus": tobs.parse_prometheus,
    "CostModel": tobs.CostModel, "SloTracker": tobs.SloTracker,
    "Partition": bt.Partition,
    "PartitionModelState": bt.PartitionModelState,
    "OrchestratorOptions": t_orch.OrchestratorOptions,
    "PartitionMove": t_orch.PartitionMove,
    "orchestrate_moves": t_orch.orchestrate_moves,
    "FaultPlan": FaultPlan, "NodeFaults": NodeFaults,
}
TELEMETRY = rebind(ref_tel, BINDINGS)
DEVICE_OBS = rebind(ref_dev, BINDINGS)

TELEMETRY_CASES = [
    "test_registry_declares_every_progress_counter",
    "test_registry_rejects_duplicates_and_collisions",
    "test_render_includes_every_declared_metric_and_parses",
    "test_render_histogram_buckets_cumulative_and_consistent",
    "test_render_counter_and_labeled_gauge_samples",
    "test_parse_prometheus_rejects_garbage",
    "test_metrics_server_scrape_and_cache",
    "test_metrics_server_snapshot_throttling",
    "test_metrics_server_collectors_run_per_snapshot",
]


@pytest.fixture
def port_locals(monkeypatch):
    """Names the reference cases import inside their bodies resolve to
    the port's for the test's duration."""
    monkeypatch.setattr(jobs, "Metric", tobs.Metric)
    monkeypatch.setattr(jobs, "MetricsRegistry", tobs.MetricsRegistry)
    monkeypatch.setattr(j_orch, "OrchestratorProgress",
                        t_orch.OrchestratorProgress)


@pytest.mark.parametrize("case", TELEMETRY_CASES)
def test_reference_telemetry_case_on_port(case, request, port_locals):
    call_with_fixtures(TELEMETRY[case], request)


def test_reference_healthz_case_on_port(request):
    call_with_fixtures(DEVICE_OBS[
        "test_healthz_503_before_first_snapshot_then_200"], request)


def _pairs(reg):
    return {(m.name, m.kind) for m in reg.metrics()}


def test_registry_declares_the_reference_pairs():
    assert _pairs(default_registry()) == _pairs(jobs.default_registry())
    ref_help = {(m.name, m.kind): m.help
                for m in jobs.default_registry().metrics()}
    for m in default_registry().metrics():
        if not m.name.startswith("device."):
            assert m.help == ref_help[(m.name, m.kind)], m.name


def _busy_recorder():
    """A recorder holding every kind of sample: a labeled counter, a
    labeled gauge, a labeled histogram and plain series."""
    rec = Recorder()
    rec.count("plan.solve.calls", 3)
    rec.count('device.compiles{entry="solve_dense.cold"}')
    rec.observe("plan.solve.sweeps", 2)
    rec.observe('device.compile_s{entry="sparse.cold"}', 0.75)
    rec.observe("device.sweep_accept_frac", 0.23395998775959015)
    rec.set_gauge('device.peak_alloc_bytes{entry="solve_dense.cold",'
                  'klass="100000x10000"}', 5184019392.0)
    rec.set_gauge("slo.partition_availability", 0.5)
    return rec


def test_render_parses_with_both_packages():
    text = render_prometheus(_busy_recorder())
    t_samples, t_types = parse_prometheus(text)
    j_samples, j_types = jobs.parse_prometheus(text)
    assert (t_samples, t_types) == (j_samples, j_types)
    assert t_samples['blance_device_peak_alloc_bytes{entry="solve_dense.'
                     'cold",klass="100000x10000"}'] == 5184019392.0
    assert t_samples[
        'blance_device_compiles_total{entry="solve_dense.cold"}'] == 1
    assert t_types["blance_device_sweep_accept_frac"] == "histogram"


def test_render_equals_the_reference_rendering_but_device_help():
    """One recorder's samples, rendered by both packages' tables, give
    the same sample lines; only the device.* HELP lines differ."""
    rec = _busy_recorder()
    jrec = jobs.Recorder()
    for k, v in rec.counters.items():
        jrec.count(k, v)
    for k, v in rec.gauges.items():
        jrec.set_gauge(k, v)
    for k in rec._hist_stats:
        for v in ([2] if k == "plan.solve.sweeps" else
                  [0.75] if k.startswith("device.compile_s") else
                  [0.23395998775959015]):
            jrec.observe(k, v)

    def lines(text):
        return [ln for ln in text.splitlines()
                if not ln.startswith("# HELP blance_device_")]

    assert lines(render_prometheus(rec)) == \
        lines(jobs.render_prometheus(jrec))


def _tenant(k, n=6, p=12):
    rng = np.random.default_rng(k)
    prev = np.full((p, 2, 1), -1, np.int32)
    prev[:, 0, 0] = rng.integers(0, n, p)
    prev[:, 1, 0] = (prev[:, 0, 0] + 1 + rng.integers(0, n - 1, p)) % n
    return t_fleet.TenantProblem(
        key=f"t{k}", prev=prev, partition_weights=np.ones(p, np.float32),
        node_weights=np.ones(n, np.float32), valid_node=np.ones(n, bool),
        stickiness=np.full((p, 2), 1.5, np.float32),
        gids=np.stack([np.arange(n), np.arange(n) // 3,
                       np.zeros(n)]).astype(np.int32),
        gid_valid=np.ones((3, n), bool), constraints=(1, 1),
        rules=((), ((2, 1),)))


def test_drift_guard_port_emissions_all_declared():
    """Plan (matrix, sparse, bucketed, greedy, native), pipeline, the
    session's cold and warm pipeline, the fleet (cold and warm), the
    chaos rebalance with its SLO tracker and cost model, and the device
    observatory: every name they emit is declared."""
    m = bt.model(primary=(0, 1), replica=(1, 1))
    nodes = [f"n{i}" for i in range(6)]
    beg = {str(i): bt.Partition(str(i), {
        "primary": [nodes[i % 5]], "replica": [nodes[(i + 1) % 5]]})
        for i in range(24)}
    rec = Recorder()
    cm = CostModel(recorder=rec)
    rec.add_sink(cm)
    with use_recorder(rec):
        device.enable()
        try:
            for opts, backend in ((None, "cuda"),
                                  (bt.PlanOptions(sparse=True, sparse_k=3),
                                   "cuda"),
                                  (bt.PlanOptions(shape_bucketing=True),
                                   "cuda"),
                                  (None, "greedy"), (None, "native")):
                bt.plan_next_map(beg, beg, nodes, [nodes[0]], [], m, opts,
                                 backend=backend, device="cpu")
            end, _w, _mv = bt.plan_pipeline(beg, beg, nodes, [nodes[0]], [],
                                            m, device="cpu")
            bt.calc_all_moves(beg, end, m, device="cpu")
            s = bt.PlannerSession(m, nodes, list(beg), device="cpu")
            s.load_map(beg)
            s.replan_with_moves()
            s.apply()
            s.remove_nodes([nodes[1]])
            s.replan_with_moves()
            res = t_fleet.solve_fleet([_tenant(k) for k in range(3)],
                                      device="cpu")
            t_fleet.solve_fleet([dataclasses.replace(
                _tenant(k), prev=r.assign, carry=r.carry,
                dirty=np.eye(12, dtype=bool)[0])
                for k, r in enumerate(res)], device="cpu")
        finally:
            device.disable()

        plan = FaultPlan(seed=3, nodes={
            nodes[5]: NodeFaults(dead=True),
            nodes[1]: NodeFaults(fail_rate=0.3)})

        async def assign(stop_ch, node, partitions, states, ops):
            await asyncio.sleep(0)

        slo = SloTracker(beg, primary_states=("primary",), clock=rec.now,
                         recorder=rec)
        bt.rebalance(m, beg, nodes, [nodes[2]], [nodes[5]],
                     plan.wrap(assign),
                     orchestrator_options=t_orch.OrchestratorOptions(
                         move_timeout_s=0.25, max_retries=3,
                         backoff_base_s=0.001, quarantine_after=2,
                         probe_after_s=60.0),
                     max_recovery_rounds=2, backend="greedy", device="cpu",
                     slo=slo)

    assert default_registry().undeclared(rec) == []
    # The run exercised every group the check is about.
    for name in ("plan.pipeline.calls", "plan.solve.carry_hit",
                 "fleet.batches", "orchestrate.move_failures",
                 "costmodel.updates", "device.cost_analyses"):
        assert rec.counters.get(name, 0) > 0, name
    assert "slo.partition_availability" in rec.gauges
    assert rec.histogram_summary("device.sweep_accept_frac")["count"] > 0
    assert any(k.startswith("device.flops{") for k in rec.gauges)
    samples, _ = parse_prometheus(render_prometheus(rec))
    jobs.parse_prometheus(render_prometheus(rec))
    assert samples["blance_fleet_batches_total"] > 0


def test_expo_smoke_on_cpu():
    """``python -m blance_tpu_torch.obs --smoke --device cpu``: the chaos
    rebalance with the endpoint live, scraped three times."""
    assert expo.main(["--smoke", "--device", "cpu"]) == 0


def test_expo_cli_render_and_help(capsys):
    assert expo.main(["--render"]) == 0
    samples, _ = parse_prometheus(capsys.readouterr().out)
    assert "blance_plan_solve_calls_total" in samples
    assert expo.main([]) == 2
