"""The port's device observatory against the reference's, on the CPU.

- Build accounting: first-wins entry scopes, the monitor's fan-in from
  the port's build sites (the kernel-library loader and the host
  extensions' compile helper), the labeled ``device.compiles`` /
  ``device.compile_s`` emissions, and the retrace-budget mechanics
  (DEV001 / DEV002 / DEV003) and workload (calls 2-4 build nothing).
- Dispatch cost gauges: published once per (entry, klass) from the
  kernel work of the dispatch, nothing while disabled, no synchronize or
  peak reset unless a first dispatch is measured on a card, and the
  work formulas pinned to the bounds ``chip_smoke.py`` prints.
- Sweep traces: the same seeded fixtures through the reference with
  ``blance_tpu.obs.device.enable(sweep_trace=True)`` and through the port
  on ``device="cpu"`` give the same per-sweep fractions bitwise, the
  same sweep count and the same map, traced or not, unbucketed and
  bucketed (the ``p_real`` denominator).
- The entry labels at every dispatch site, ``device_profile`` on
  torch.profiler, the Chrome export (the reference's schema and counter
  cases rebound to the port), the ``device_check`` CLI, and the
  membudget table's host-only rules (MEM002, MEM003) and builders.
"""

import json
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference package imports it

import jax.numpy as jnp  # noqa: E402

import blance_tpu  # noqa: E402
import blance_tpu.obs as jobs  # noqa: E402
from blance_tpu.obs import device as jdevice  # noqa: E402
from blance_tpu.plan import api as japi  # noqa: E402
from blance_tpu.plan import tensor as jtensor  # noqa: E402

import blance_tpu_torch as bt  # noqa: E402
from blance_tpu_torch.analysis import membudget, retrace  # noqa: E402
from blance_tpu_torch.obs import (ChromeTraceSink, Recorder,  # noqa: E402
                                  default_registry, parse_prometheus,
                                  render_prometheus, use_recorder)
from blance_tpu_torch.obs import device  # noqa: E402
from blance_tpu_torch.ops import _build, cost  # noqa: E402
from blance_tpu_torch.ops import reduce2, score_fused, sparse2  # noqa: E402
from blance_tpu_torch.plan import tensor as T  # noqa: E402
from blance_tpu_torch.utils import nativebuild  # noqa: E402
from blance_tpu_torch.utils.trace import device_profile  # noqa: E402

import test_obs as ref_obs  # noqa: E402
from test_torch_durability import rebind  # noqa: E402

CONSTRAINTS = (1, 1)
RULES = ((), ((2, 1),))


@pytest.fixture(autouse=True)
def _observatories_off():
    """Every test leaves both packages' observatories OFF."""
    yield
    device.disable()
    device.reset_cost_cache()
    jdevice.disable()
    jdevice.reset_cost_cache()


def _arrays(P=24, N=6, seed=0, racks=3):
    rng = np.random.default_rng(seed)
    prev = np.full((P, 2, 1), -1, np.int32)
    prev[:, 0, 0] = rng.integers(0, N, P)
    prev[:, 1, 0] = (prev[:, 0, 0] + 1 + rng.integers(0, N - 1, P)) % N
    prev[rng.random(P) < 0.15, 1, 0] = -1
    return (prev, rng.integers(1, 4, P).astype(np.float32),
            np.ones(N, np.float32), np.ones(N, bool),
            np.full((P, 2), 1.5, np.float32),
            np.stack([np.arange(N, dtype=np.int32),
                      np.arange(N, dtype=np.int32) // racks,
                      np.zeros(N, np.int32)]),
            np.ones((3, N), bool))


def _port(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _ref(arrs):
    return [jnp.asarray(a) for a in arrs]


def _samples(sink, name="device.sweep_accept_frac"):
    return [v for _t, n, v in sorted(sink._counter_samples) if n == name]


def _traced(recorder_cls, sink_cls, use, obs_device, fn):
    """Run ``fn`` with ``obs_device``'s sweep trace on under a fresh
    recorder; returns (fn's result, the recorder, the sweep samples)."""
    rec = recorder_cls()
    sink = sink_cls(rec)
    rec.add_sink(sink)
    with use(rec):
        obs_device.enable(cost_analysis=False, sweep_trace=True)
        try:
            out = fn()
        finally:
            obs_device.disable()
    return out, rec, _samples(sink)


# ---------------------------------------------------------------------------
# Entry attribution + build accounting
# ---------------------------------------------------------------------------


def test_entry_scope_first_wins():
    assert device.current_entry() == "other"
    assert device.ambient_entry() is None
    with device.entry("outer"):
        assert device.current_entry() == "outer"
        with device.entry("inner"):  # nested scopes never re-label
            assert device.current_entry() == "outer"
        assert device.ambient_entry() == "outer"
    assert device.current_entry() == "other"


def test_compile_monitor_counts_and_attributes():
    with device.CompileMonitor() as mon:
        with device.entry("test.entry"):
            device.note_compile("libx", 0.25)
            with device.entry("inner"):  # first wins: still test.entry
                device.note_compile("liby", 0.5)
        device.note_compile("libz", 1.0)
    device.note_compile("libw", 1.0)  # uninstalled: not counted
    assert mon.by_entry == {"test.entry": 2, "other": 1}
    assert mon.by_fn == {"libx": 1, "liby": 1, "libz": 1}
    assert mon.total == 3
    summary = mon.summary()
    assert summary["by_entry"] == dict(sorted(mon.by_entry.items()))
    assert summary["compile_s_by_entry"] == {"other": 1.0,
                                             "test.entry": 0.75}


def _gcc_or_skip():
    if shutil.which("gcc") is None:
        pytest.skip("gcc is not installed")


def test_native_extension_build_and_first_load_are_counted(tmp_path):
    """utils/nativebuild.compile_cached (the marshal's and the exact
    planner's build helper) is one event per successful call, built or
    cached, attributed to the entry scope open at the call."""
    _gcc_or_skip()
    src = tmp_path / "x.c"
    src.write_text("int blance_x(void) { return 7; }\n")
    out = str(tmp_path / "build" / "libx.so")
    cmd = ["gcc", "-shared", "-fPIC", "-o", out, str(src)]
    with device.CompileMonitor() as mon:
        with device.entry("solve_dense.cold"):
            assert nativebuild.compile_cached(str(src), out, cmd)
        assert nativebuild.compile_cached(str(src), out, cmd)  # cached
        assert not nativebuild.compile_cached(str(tmp_path / "no.c"), out,
                                              cmd)
    assert mon.by_entry == {"solve_dense.cold": 1, "other": 1}
    assert mon.by_fn == {"libx.so": 2}
    assert mon.compile_s_by_entry["solve_dense.cold"] > 0


def test_kernel_library_first_load_counted_once(tmp_path, monkeypatch):
    """ops/_build.load: the first load in the process of a library this
    process did not build is one event under the open entry scope; the
    second call is served from the loaded table and counts nothing, and
    the event opens no scope of its own."""
    _gcc_or_skip()
    src = tmp_path / "k.c"
    src.write_text("int blance_k(void) { return 3; }\n")
    so = tmp_path / "libk.so"
    subprocess.run(["gcc", "-shared", "-fPIC", "-o", str(so), str(src)],
                   check=True)
    monkeypatch.setattr(_build, "_lib_path", lambda name: str(so))
    monkeypatch.setattr(_build, "_LIBS", {})
    with device.CompileMonitor() as mon:
        with device.entry("sparse.cold"):
            lib = _build.load("k")
            assert device.ambient_entry() == "sparse.cold"
        assert _build.load("k") is lib
    assert lib.blance_k() == 3
    assert mon.by_entry == {"sparse.cold": 1}
    assert mon.by_fn == {"libk": 1}


def test_compile_monitor_emits_labeled_metrics_and_is_declared():
    rec = Recorder()
    with use_recorder(rec):
        device.enable(cost_analysis=False, sweep_trace=False)
        with device.entry("solve_dense.cold"):
            device.note_compile("libmin2", 0.125)
        device.disable()
        device.note_compile("libmin2", 0.125)  # off: nothing emitted
    key = 'device.compiles{entry="solve_dense.cold"}'
    assert rec.counters == {key: 1}
    assert rec.histogram_buckets(
        'device.compile_s{entry="solve_dense.cold"}') is not None
    assert default_registry().undeclared(rec) == []
    samples, _ = parse_prometheus(render_prometheus(rec))
    assert samples[
        'blance_device_compiles_total{entry="solve_dense.cold"}'] == 1
    assert samples[
        'blance_device_compile_s_count{entry="solve_dense.cold"}'] == 1


def test_retrace_check_mechanics(monkeypatch):
    """Budget semantics without the full workload: an unbudgeted entry is
    DEV002, an over-budget one DEV001, and an entry whose calls 2-4
    build again DEV003."""
    calls = {"n": 0}

    def tiny_workload(dev, repeat):
        def budgeted():
            with device.entry("budgeted"):
                device.note_compile("liba", 0.1)  # every call builds

        def once():
            calls["n"] += 1
            if calls["n"] == 1:
                with device.entry("unbudgeted"):
                    device.note_compile("libb", 0.1)

        repeat("budgeted", budgeted)
        repeat("unbudgeted", once)

    monkeypatch.setattr(retrace, "_workload", tiny_workload)
    monkeypatch.setattr(retrace, "RETRACE_BUDGETS",
                        {"budgeted": 5, "other": 50})
    counts: dict = {}
    findings, entries = retrace.run_retrace_check(device="cpu",
                                                  counts=counts)
    assert entries == 2
    assert counts["by_entry"] == {"budgeted": 4, "unbudgeted": 1}
    assert counts["repeated"] == {"budgeted": 3, "unbudgeted": 0}
    assert sorted((f.rule, f.symbol) for f in findings) == [
        ("DEV002", "unbudgeted"), ("DEV003", "budgeted")]

    calls["n"] = 0
    monkeypatch.setattr(retrace, "RETRACE_BUDGETS",
                        {"budgeted": 3, "unbudgeted": 5, "other": 50})
    findings, _ = retrace.run_retrace_check(device="cpu")
    assert sorted((f.rule, f.symbol) for f in findings) == [
        ("DEV001", "budgeted"), ("DEV003", "budgeted")]


def test_retrace_check_defaults_to_the_card(monkeypatch):
    """Called without ``device=``, the retrace workload targets the card;
    with no card it raises before it dispatches anything."""
    def no_workload(dev, repeat):
        raise AssertionError("the workload ran without a card")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(retrace, "_workload", no_workload)
    with pytest.raises(RuntimeError, match="is_available"):
        retrace.run_retrace_check()


def test_retrace_workload_adds_no_builds_on_repeat():
    """The canonical workload on the CPU: every budgeted solver entry is
    dispatched, calls 2-4 of each build nothing, and no budget is
    blown."""
    counts: dict = {}
    findings, entries = retrace.run_retrace_check(device="cpu",
                                                  counts=counts)
    assert findings == []
    assert entries == len(retrace.RETRACE_BUDGETS)
    assert set(counts["repeated"]) == set(retrace.RETRACE_BUDGETS) - {
        "other"}
    assert all(v == 0 for v in counts["repeated"].values())


def test_retrace_budgets_have_the_reference_labels():
    """Every reference label, the sharded dispatches' included."""
    from blance_tpu.analysis.retrace import RETRACE_BUDGETS as ref

    assert set(retrace.RETRACE_BUDGETS) == set(ref)


# ---------------------------------------------------------------------------
# Dispatch cost gauges
# ---------------------------------------------------------------------------


def test_cost_gauges_published_once_per_entry_shape():
    args = _port(_arrays())
    rec = Recorder()
    with use_recorder(rec):
        device.enable(cost_analysis=True, sweep_trace=False)
        out = T.solve_dense_converged(*args, CONSTRAINTS, RULES)
        first = rec.counters.get("device.cost_analyses", 0)
        T.solve_dense_converged(*args, CONSTRAINTS, RULES)  # same shape
        T.solve_dense_converged(*_port(_arrays(P=30)), CONSTRAINTS, RULES)
        device.disable()
    assert first == 1
    assert rec.counters["device.cost_analyses"] == 2  # the new shape only
    labels = '{entry="solve_dense.cold",klass="24x6"}'
    # Kernel work: the matrix engine's priced min2 calls, counted by the
    # formulas of ops/cost.py from the plain versions on the CPU.
    assert rec.gauges[f"device.flops{labels}"] > 0
    assert rec.gauges[f"device.hbm_bytes{labels}"] > 0
    # No allocator statistics on the CPU: no peak gauge.
    assert not any(k.startswith("device.peak_alloc_bytes")
                   for k in rec.gauges)
    summaries = device.cost_summaries()
    assert set(summaries["solve_dense.cold"]) == {"24x6", "30x6"}
    assert default_registry().undeclared(rec) == []
    assert out.shape == (24, 2, 1)


def test_cost_gauges_count_each_kernel_call():
    """A dispatch's gauges are the sum of its kernel calls' work."""
    score = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    price = torch.zeros(4)

    def two_calls():
        reduce2.priced_min2_argmin(score, price)
        return reduce2.priced_min2_argmin(score, price)

    rec = Recorder()
    with use_recorder(rec):
        device.enable(cost_analysis=True, sweep_trace=False)
        device.maybe_publish_cost("e", "3x4", "cpu", two_calls)
    nbytes, ops = cost.min2_work(score, price)
    assert rec.gauges['device.flops{entry="e",klass="3x4"}'] == 2 * ops
    assert rec.gauges['device.hbm_bytes{entry="e",klass="3x4"}'] == \
        2 * nbytes


def test_cost_gauges_noop_when_disabled():
    rec = Recorder()
    with use_recorder(rec):
        assert device.maybe_publish_cost("x", "1x1", "cpu",
                                         lambda a: a + 1, 6) == 7
    assert not rec.gauges and not rec.counters
    assert device.cost_summaries() == {}


def test_off_path_never_synchronizes_or_resets_the_peak(monkeypatch):
    """Disabled, or for a memoized key, maybe_publish_cost is the bare
    call even for a CUDA device: no synchronize, no peak reset."""
    def boom(*a, **k):
        raise AssertionError("touched the card's statistics")

    for name in ("synchronize", "reset_peak_memory_stats",
                 "max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, boom)
    assert device.maybe_publish_cost("x", "1x1", "cuda", lambda: 3) == 3
    device.enable(cost_analysis=True, sweep_trace=False)
    device._COST_CACHE[("x", "1x1")] = {"flops": 0.0, "hbm_bytes": 0.0}
    assert device.maybe_publish_cost("x", "1x1", "cuda", lambda: 4) == 4
    # Cost measurement off, observatory on: bare too.
    device.enable(cost_analysis=False, sweep_trace=True)
    assert device.maybe_publish_cost("y", "1x1", "cuda", lambda: 5) == 5


def test_failed_dispatch_publishes_nothing_and_is_retried():
    rec = Recorder()

    def fail():
        raise RuntimeError("engine failed")

    with use_recorder(rec):
        device.enable(cost_analysis=True, sweep_trace=False)
        with pytest.raises(RuntimeError):
            device.maybe_publish_cost("e", "k", "cpu", fail)
        assert device.cost_summaries() == {}
        device.maybe_publish_cost("e", "k", "cpu", lambda: None)
    assert rec.counters["device.cost_analyses"] == 1


def test_kernel_wrappers_note_work_only_inside_a_tally():
    score = torch.zeros(5, 7)
    price = torch.zeros(7)
    reduce2.priced_min2_argmin(score, price)  # no tally: nothing kept
    with cost.tally() as acc:
        reduce2.priced_min2_argmin(score, price)
        with cost.tally() as inner:
            reduce2.priced_min2_argmin(score, price)
    assert acc == list(cost.min2_work(score, price))
    assert inner == acc


def test_work_formulas_pin_the_chip_bounds():
    """The formulas chip_smoke.py's bound_ms is computed from, at the
    main path's shapes (meta tensors: shapes only)."""
    meta = dict(device="meta")
    p, n, k, b = 100_000, 10_000, 16, 240
    score = torch.empty(p, n, **meta)
    price = torch.empty(n, **meta)
    assert cost.min2_work(score, price) == (
        p * n * 4 + n * 4 + p * 12, p * n * 3)
    bscore = torch.empty(b, 1024, 64, **meta)
    bprice = torch.empty(b, 64, **meta)
    assert cost.min2_work(bscore, bprice) == (
        b * 1024 * 64 * 4 + b * 64 * 4 + b * 1024 * 12, b * 1024 * 64 * 3)
    sp = torch.empty(1_000_000, k, **meta)
    cand = torch.empty(1_000_000, k, dtype=torch.int32, **meta)
    assert cost.sparse_cand_work(sp, cand, price) == (
        1_000_000 * k * 8 + n * 4 + 1_000_000 * 20, 1_000_000 * k * 3)
    assert cost.sparse_work(sp, sp) == (
        1_000_000 * k * 8 + 1_000_000 * 16, 1_000_000 * k * 3)
    assert cost.fused_ops_per_cell(1, 2, 2, 1) == 39
    assert cost.bound(3.35e12 / 1e3, 0) == {"bound_ms": 1.0,
                                            "bound_by": "bytes"}
    assert cost.bound(0, 67e12 / 1e3)["bound_by"] == "operations"


def test_fused_work_counts_every_input_once():
    rng = np.random.default_rng(4)
    p, n = 9, 5
    t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
    nodes = np.arange(n, dtype=np.int32)
    prim = rng.integers(0, n, p).astype(np.int32)
    gids = t(np.stack([nodes, nodes // 2, np.zeros(n, np.int32)]))
    si = score_fused.pack_score_inputs(
        total_l=t(np.zeros(n, np.float32)), total_p=p,
        w_div_l=t(np.ones(n, np.float32)),
        neg_boost_l=t(np.zeros(n, np.float32)), valid_l=t(np.ones(n, bool)),
        stickiness_si=t(np.full(p, 1.5, np.float32)), prev_slot=t(prim),
        prev_state=t(prim[:, None]), taken_ids=[t(prim)],
        anchors=t(prim[:, None]), gids_l=gids,
        gid_valid=t(np.ones((3, n), bool)), gids=gids, rules=((2, 1),))
    nbytes, ops = cost.fused_work(torch.zeros(n), si, 1)
    in_bytes = sum(x.numel() * x.element_size() for x in si) + n * 4
    assert nbytes == in_bytes + p * 16
    assert ops == p * n * cost.fused_ops_per_cell(
        si.prev_state.shape[1], si.taken.shape[1], si.present.shape[1], 1)


# ---------------------------------------------------------------------------
# Sweep traces against the reference
# ---------------------------------------------------------------------------

SWEEP_FIXTURES = [
    # (P, N, seed, racks, p_real): p_real None = unbucketed
    (7, 4, 0, 2, None),
    (32, 8, 3, 3, None),
    (300, 17, 1, 3, None),
    (777, 13, 6, 4, None),
    (4096, 64, 5, 8, None),
    (64, 16, 2, 4, 50.0),
    (1024, 32, 8, 4, 1000.0),
    (4096, 64, 9, 8, 3001.0),
]


@pytest.mark.parametrize("P,N,seed,racks,p_real", SWEEP_FIXTURES)
def test_sweep_fracs_match_reference_bitwise(P, N, seed, racks, p_real):
    arrs = _arrays(P, N, seed, racks)
    jkw = {} if p_real is None else {"p_real": jnp.float32(p_real)}
    tkw = {} if p_real is None else {"p_real": torch.tensor(p_real)}
    j_out, j_rec, j_fracs = _traced(
        jobs.Recorder, jobs.ChromeTraceSink, jobs.use_recorder, jdevice,
        lambda: np.asarray(jtensor.solve_dense_converged(
            *_ref(arrs), CONSTRAINTS, RULES, **jkw)))
    t_out, t_rec, t_fracs = _traced(
        Recorder, ChromeTraceSink, use_recorder, device,
        lambda: T.solve_dense_converged(
            *_port(arrs), CONSTRAINTS, RULES, **tkw).numpy())
    assert np.array_equal(j_out, t_out)
    sweeps = t_rec.counters["plan.solve.sweeps"]
    assert sweeps == j_rec.counters["plan.solve.sweeps"] == len(t_fracs)
    assert np.array_equal(np.float32(j_fracs).view(np.int32),
                          np.float32(t_fracs).view(np.int32))
    assert t_fracs[-1] == 0.0  # converged: the last sweep changed nothing
    # The trace does not perturb the fixpoint.
    plain = T.solve_dense_converged(*_port(arrs), CONSTRAINTS, RULES,
                                    record=False, **tkw).numpy()
    assert np.array_equal(plain, t_out)
    assert default_registry().undeclared(t_rec) == []


def test_sweep_trace_fracs_from_the_impl_match_reference():
    """The fixpoint's own traced output (fracs over max_iterations, zeros
    past the last sweep) against the reference's jitted impl."""
    import functools

    import jax

    arrs = _arrays(300, 17, 1)
    f = jax.jit(functools.partial(jtensor._solve_dense_converged_impl,
                                  constraints=CONSTRAINTS, rules=RULES,
                                  trace_sweeps=True))
    j_out, j_sweeps, j_fracs = f(*_ref(arrs))
    t_out, t_sweeps, t_fracs = T._solve_dense_converged_impl(
        *_port(arrs), CONSTRAINTS, RULES, trace_sweeps=True)
    assert int(j_sweeps) == t_sweeps
    assert np.array_equal(np.asarray(j_out), t_out.numpy())
    assert t_fracs.dtype == np.float32 and t_fracs.shape == (10,)
    assert np.array_equal(np.asarray(j_fracs).view(np.int32),
                          t_fracs.view(np.int32))


def _bucketed_plan(lib, p, n_real):
    nodes = [f"n{i:03d}" for i in range(n_real)]
    hier = {nd: f"r{i // 4}" for i, nd in enumerate(nodes)}
    hier.update({f"r{i}": "z0" for i in range((n_real + 3) // 4)})
    opts = lib.PlanOptions(
        shape_bucketing=True, node_hierarchy=hier,
        hierarchy_rules={"replica": [lib.HierarchyRule(2, 1)]})
    pmap = {str(i): lib.Partition(str(i), {
        "primary": [nodes[(i * 7) % n_real]],
        "replica": [nodes[(i * 7 + 1 + i % 3) % n_real]]})
        for i in range(p)}
    return pmap, nodes, [nodes[1]], lib.model(primary=(0, 1),
                                              replica=(1, 1)), opts


@pytest.mark.parametrize("p,n_real", [(24, 17), (300, 29), (1000, 37)])
def test_bucketed_plan_sweep_fracs_match_reference(p, n_real):
    """plan_next_map with shape bucketing: the fraction's denominator is
    the real partition count, not the padded P — both packages give the
    same samples and the same map."""
    jm, jn, jr, jmodel, jopts = _bucketed_plan(blance_tpu, p, n_real)
    tm, tn, tr, tmodel, topts = _bucketed_plan(bt, p, n_real)
    (j_map, _), _, j_fracs = _traced(
        jobs.Recorder, jobs.ChromeTraceSink, jobs.use_recorder, jdevice,
        lambda: japi.plan_next_map(jm, jm, jn, jr, [], jmodel, jopts,
                                   backend="tpu"))
    (t_map, _), t_rec, t_fracs = _traced(
        Recorder, ChromeTraceSink, use_recorder, device,
        lambda: bt.plan_next_map(tm, tm, tn, tr, [], tmodel, topts,
                                 backend="cuda", device="cpu"))
    assert blance_tpu.partition_map_to_json(j_map) == \
        bt.partition_map_to_json(t_map)
    assert len(t_fracs) == t_rec.counters["plan.solve.sweeps"]
    assert np.array_equal(np.float32(j_fracs).view(np.int32),
                          np.float32(t_fracs).view(np.int32))
    # Traced or not, the plan is the same.
    plain, _ = bt.plan_next_map(tm, tm, tn, tr, [], tmodel, topts,
                                backend="cuda", device="cpu")
    assert bt.partition_map_to_json(plain) == bt.partition_map_to_json(t_map)


def test_sweep_trace_off_leaves_no_samples():
    rec = Recorder()
    with use_recorder(rec):
        T.solve_dense_converged(*_port(_arrays()), CONSTRAINTS, RULES)
        device.enable(cost_analysis=False, sweep_trace=True)
        T.solve_dense_converged(*_port(_arrays()), CONSTRAINTS, RULES,
                                record=False)  # unrecorded: no trace
    assert rec.histogram_summary("device.sweep_accept_frac") is None


def test_fleet_batch_has_no_sweep_trace():
    """The batched fixpoint keeps no per-sweep counts (the reference's
    vmapped loop has none either)."""
    arrs = [np.stack([a, a]) for a in _arrays(16, 6)]
    tensors = _port(arrs)
    out, sweeps = T._solve_dense_converged_impl(
        *tensors, CONSTRAINTS, RULES, trace_sweeps=True)
    assert out.shape == (2, 16, 2, 1) and sweeps.shape == (2,)


def test_record_sweep_trace_interpolates_timestamps():
    rec = Recorder(clock=lambda: 0.0)
    sink = ChromeTraceSink(rec)
    rec.add_sink(sink)
    device.record_sweep_trace(rec, 10.0, 14.0, 4, [0.5, 0.25, 0.0, 0.0])
    samples = sorted(sink._counter_samples)
    assert [t for t, _, _ in samples] == [11.0, 12.0, 13.0, 14.0]
    assert [v for _, _, v in samples] == [0.5, 0.25, 0.0, 0.0]
    device.record_sweep_trace(rec, 0.0, 1.0, 0, [])  # no-op, no raise


# ---------------------------------------------------------------------------
# Entry labels at the dispatch sites
# ---------------------------------------------------------------------------


def test_every_dispatch_site_publishes_under_its_label():
    """The retrace workload with cost measurement armed: each dispatch
    site publishes under the reference's entry label, at its shape."""
    rec = Recorder()
    with use_recorder(rec):
        device.enable(cost_analysis=True, sweep_trace=True)
        findings, _ = retrace.run_retrace_check(device="cpu")
    assert findings == []
    summaries = device.cost_summaries()
    # The sharded dispatches publish no cost gauge (as in the reference:
    # their per-rank work scales with the mesh, membudget.MESH_EXEMPT).
    assert set(summaries) == set(retrace.RETRACE_BUDGETS) - {"other"} - \
        membudget.MESH_EXEMPT
    assert set(summaries["solve_dense.cold"]) == {"48x8"}
    assert set(summaries["fleet.cold"]) == {"48x8xB3"}
    assert set(summaries["sched.ranks"]) == {"32x3"}
    # Bucketed plans: 24 partitions x 17-18 nodes in one bucket class.
    assert len(summaries["solve_dense.bucketed"]) == 1
    # Kernel work is what this run's data needs: the cold solves bid
    # through min2; a repair whose every copy pins (or the plain-PyTorch
    # rank sweep) may launch nothing.
    for ent in ("solve_dense.cold", "solve_dense.bucketed", "sparse.cold",
                "fleet.cold", "pipeline.cold"):
        for klass, s in summaries[ent].items():
            assert s["flops"] > 0 and s["hbm_bytes"] > 0, (ent, klass)
    assert all(s["flops"] >= 0 for by in summaries.values()
               for s in by.values())
    assert rec.histogram_summary("device.sweep_accept_frac")["count"] > 0
    assert default_registry().undeclared(rec) == []


def test_sparse_pipeline_publishes_under_its_label():
    m = bt.model(primary=(0, 1), replica=(1, 1))
    nodes = [f"n{i}" for i in range(8)]
    parts = {str(i): bt.Partition(str(i), {}) for i in range(40)}
    cur, _ = bt.plan_next_map(parts, parts, nodes, [], [], m, device="cpu")
    device.enable(cost_analysis=True, sweep_trace=False)
    bt.plan_pipeline(cur, cur, nodes, ["n3"], [], m,
                     bt.PlanOptions(sparse=True, sparse_k=4), device="cpu")
    bt.plan_pipeline(cur, cur, nodes, ["n3"], [], m,
                     bt.PlanOptions(shape_bucketing=True), device="cpu")
    summaries = device.cost_summaries()
    assert set(summaries["sparse.pipeline"]) == {"40x8"}
    assert "solve_dense.bucketed" in summaries


# ---------------------------------------------------------------------------
# device_profile, the Chrome export, the CLI
# ---------------------------------------------------------------------------


def test_device_profile_noop_cases(tmp_path):
    with device_profile(None):
        pass
    log_dir = tmp_path / "prof"
    with device_profile(str(log_dir)):
        torch.ones(4).sum()
        with device_profile(str(tmp_path / "inner")):  # already active
            pass
    files = sorted(os.listdir(log_dir))
    assert len(files) == 1 and files[0].startswith("trace.")
    assert not (tmp_path / "inner").exists()
    doc = json.loads((log_dir / files[0]).read_text())
    assert isinstance(doc["traceEvents"], list)


def test_device_profile_writes_its_trace_when_the_body_raises(tmp_path):
    with pytest.raises(ValueError, match="body"):
        with device_profile(str(tmp_path)):
            raise ValueError("body")
    assert len(os.listdir(tmp_path)) == 1


def _check_chrome_schema(doc):
    """The trace-event subset chrome://tracing and Perfetto both load
    (the reference's test_chrome_trace_schema_valid rules)."""
    assert isinstance(doc, dict)
    events = doc["traceEvents"]
    assert isinstance(events, list) and events
    for ev in events:
        assert isinstance(ev["name"], str)
        assert ev["ph"] in ("X", "M", "C", "b", "e")
        assert isinstance(ev["pid"], int)
        if ev["ph"] == "X":
            assert ev["ts"] >= 0 and ev["dur"] >= 0
            assert isinstance(ev["tid"], int)
            assert "span_id" in ev["args"]
        if ev["ph"] in ("b", "e"):
            assert ev["cat"] and isinstance(ev["id"], str)
    return events


def test_chrome_trace_of_a_traced_plan_validates(tmp_path):
    from blance_tpu_torch.obs import chrome

    path = tmp_path / "plan.json"
    rec = Recorder()
    m = bt.model(primary=(0, 1), replica=(1, 1))
    nodes = [f"n{i}" for i in range(6)]
    parts = {str(i): bt.Partition(str(i), {}) for i in range(30)}
    with use_recorder(rec):
        device.enable()
        with chrome.trace(str(path), recorder=rec,
                          device_log_dir=str(tmp_path / "dev")):
            bt.plan_next_map(parts, parts, nodes, [], [], m, device="cpu")
    events = _check_chrome_schema(json.loads(path.read_text()))
    names = {ev["name"] for ev in events}
    assert {"plan.plan_next_map", "plan.solve",
            "device.sweep_accept_frac"} <= names
    fracs = [ev["args"]["value"] for ev in events
             if ev["ph"] == "C" and ev["name"] == "device.sweep_accept_frac"]
    assert len(fracs) == rec.counters["plan.solve.sweeps"]
    assert len(os.listdir(tmp_path / "dev")) == 1


CHROME = rebind(ref_obs, {
    "ChromeTraceSink": ChromeTraceSink, "Recorder": Recorder,
    "write_chrome_trace": __import__(
        "blance_tpu_torch.obs.chrome", fromlist=["x"]).write_chrome_trace,
    "use_recorder": use_recorder})


@pytest.mark.parametrize("case", ["test_chrome_trace_schema_valid",
                                  "test_chrome_counter_track_time_series"])
def test_reference_chrome_case_on_port(case, tmp_path, monkeypatch):
    # A name the case imports inside its body resolves to the port's.
    monkeypatch.setattr(jobs, "ChromeTraceSink", ChromeTraceSink)
    fn = CHROME[case]
    fn(tmp_path) if "tmp_path" in fn.__code__.co_varnames[
        :fn.__code__.co_argcount] else fn()


def test_device_check_cli_on_cpu(tmp_path, capsys):
    path = tmp_path / "dc.json"
    assert device.main(["--check", "--device", "cpu", "--trace-out",
                        str(path)]) == 0
    err = capsys.readouterr().err
    assert "0 failure(s)" in err and "builds by entry" in err
    _check_chrome_schema(json.loads(path.read_text()))
    assert not device.enabled()  # the CLI leaves the observatory off
    assert device.main([]) == 2  # no --check: help


def test_device_check_fails_on_a_blown_budget(monkeypatch, capsys):
    def workload(dev, repeat):
        with device.entry("sched.ranks"):
            device.note_compile("libx", 0.0)

    monkeypatch.setattr(retrace, "_workload", workload)
    assert device.main(["--check", "--device", "cpu"]) == 1
    assert "DEV001" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# membudget: the host-only rules and the builders
# ---------------------------------------------------------------------------


def test_membudget_tables_clean_and_mem001_not_run_without_a_card(capsys):
    rows: list = []
    findings, measured = membudget.run_membudget_check(device="cpu",
                                                       rows_out=rows)
    assert findings == []  # MEM002 and MEM003 clean
    assert measured == 0
    assert rows and all(r["ok"] is None and "not run" in r["status"]
                        for r in rows)
    assert "MEM001 not run" in capsys.readouterr().err


def test_membudget_mem002_drift(monkeypatch):
    table = dict(membudget.HBM_BUDGETS)
    table["sharded.cold"] = {"smoke": 1}
    table["gone.entry"] = {"smoke": 1}
    table["sched.ranks"] = {"smoke": 1, "huge": 1}
    del table["fleet.warm"]
    monkeypatch.setattr(membudget, "HBM_BUDGETS", table)
    findings, _ = membudget.run_membudget_check(device="cpu")
    got = sorted((f.rule, f.symbol) for f in findings)
    assert got == [("MEM002", "fleet.warm"), ("MEM002", "gone.entry"),
                   ("MEM002", "sched.ranks@huge"),
                   ("MEM002", "sharded.cold")]


def test_membudget_mem003_judges_against_the_calibration_card(monkeypatch):
    """A dense row past the guard's budget on the 80 GB card is MEM003 on
    every machine; the north star's dense row is not (20 GB < 48 GB)."""
    classes = dict(membudget.SHAPE_CLASSES)
    classes["wide"] = membudget.Dims(P=1_000_000, S=2, N=10_000, R=2, L=2)
    table = dict(membudget.HBM_BUDGETS)
    table["solve_dense.cold"] = {"smoke": 1, "north": 1, "wide": 1}
    table["sparse.cold"] = {"smoke": 1, "wide": 1}
    monkeypatch.setattr(membudget, "SHAPE_CLASSES", classes)
    monkeypatch.setattr(membudget, "HBM_BUDGETS", table)
    findings, _ = membudget.run_membudget_check(device="cpu")
    assert [(f.rule, f.symbol) for f in findings] == [
        ("MEM003", "solve_dense.cold@wide")]
    assert membudget._dense_guard_ref_bytes() == int(
        0.6 * membudget.CALIBRATION_CARD_BYTES)


def test_membudget_table_matches_the_reference_rows():
    from blance_tpu.analysis.membudget import HBM_BUDGETS as ref
    from blance_tpu.analysis.membudget import SHAPE_CLASSES as ref_classes

    assert set(membudget.HBM_BUDGETS) == set(ref)
    assert {k: tuple(v) for k, v in membudget.SHAPE_CLASSES.items()} == \
        {k: tuple(v) for k, v in ref_classes.items()}
    for ent, rows in membudget.HBM_BUDGETS.items():
        assert "smoke" in rows
        assert set(rows) <= {"smoke", "north"}
    assert set(membudget.HBM_BUDGETS["solve_dense.cold"]) == {"smoke",
                                                              "north"}
    assert set(membudget.HBM_BUDGETS["sparse.cold"]) == {"smoke", "north"}


@pytest.mark.parametrize("entry", sorted(membudget.HBM_BUDGETS))
def test_membudget_builder_dispatches_on_cpu(entry):
    """Each row's builder runs its entry's dispatch at the smoke class
    (on the CPU: the kernels' plain versions), under the label and
    klass a live dispatch site would publish."""
    d = membudget.SHAPE_CLASSES["smoke"]
    klass, fn, args, kw = membudget._builders()[entry](d, torch.device(
        "cpu"))
    out = fn(*args, **kw)
    assert out is not None
    want = {"fleet.cold": "512x64xB4", "fleet.warm": "512x64xB4",
            "sched.ranks": "512x4"}.get(entry, "512x64")
    assert klass == want
    rec = Recorder()
    with use_recorder(rec):
        device.enable(cost_analysis=True, sweep_trace=False)
        device.maybe_publish_cost(entry, klass, "cpu", fn, *args, **kw)
    assert f'device.flops{{entry="{entry}",klass="{klass}"}}' in rec.gauges


def test_membudget_builders_cover_every_dispatch_label():
    """Every budgeted dispatch label has a memory row, except the
    mesh-exempt sharded ones, whose rows would be table drift."""
    assert set(membudget._builders()) == set(membudget.HBM_BUDGETS)
    assert set(retrace.RETRACE_BUDGETS) - {"other"} - \
        membudget.MESH_EXEMPT <= set(membudget.HBM_BUDGETS)
    assert {"sharded.cold", "sharded.pipeline"} <= membudget.MESH_EXEMPT
