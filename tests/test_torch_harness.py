"""The port's testing harness (``blance_tpu_torch.testing``) against the
reference's, on the CPU.

- The five committed traces under ``tests/traces/`` replay byte for byte
  through the port alone (``device="cpu"``).
- Every simulator family at the pinned seeds gives the reference's event
  log, exposition and SLO summary: the closed-loop simulator (with a
  session, with the critical-path scheduler, and on the port's batched
  backend against the reference's ``backend="tpu"``), the crash matrix
  (with and without snapshots) and the fleet simulator (coalesced,
  sequential, and with the resident encode off).
- The visual golden corpus runs through the port's ``run_vis_cases``.
- The reference's ``DeterministicLoop`` unit cases (``tests/
  test_sched.py``) run again with their names bound to the port's
  ``testing.sched``.

The slow-marked cases are the seven-day soak, the 240-tenant fleet week
(the port's digests against the reference's) and the hash-seed replay.
"""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("jax")  # the reference package imports it

import blance_tpu.durability as jdur  # noqa: E402
import blance_tpu.testing.crashsim as jcrash  # noqa: E402
import blance_tpu.testing.fleetsim as jfleetsim  # noqa: E402
import blance_tpu.testing.scenarios as jscn  # noqa: E402
import blance_tpu.testing.simulate as jsim  # noqa: E402

import blance_tpu_torch.durability as tdur  # noqa: E402
from blance_tpu_torch.analysis.schedule import SCENARIOS as SCHED  # noqa: E402
from blance_tpu_torch.testing import crashsim as tcrash  # noqa: E402
from blance_tpu_torch.testing import fleetsim as tfleetsim  # noqa: E402
from blance_tpu_torch.testing import scenarios as tscn  # noqa: E402
from blance_tpu_torch.testing import sched as tsched  # noqa: E402
from blance_tpu_torch.testing import simulate as tsim  # noqa: E402
from blance_tpu_torch.testing import vis as tvis  # noqa: E402

import test_sched as ref_sched  # noqa: E402
from test_torch_durability import call_with_fixtures, rebind  # noqa: E402
from test_torch_exact import VIS_SUITES, to_port  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE_DIR = os.path.join(ROOT, "tests", "traces")

# tests/test_simulate.py's pinned sim-smoke seeds.
SIM_SEEDS = (11, 23, 37)


@pytest.fixture(autouse=True)
def _crash_env(monkeypatch):
    """fsync off (the crash tier's speed valve) and both packages'
    process-level fence registries cleared around every test."""
    monkeypatch.setenv("BLANCE_WAL_FSYNC", "0")
    jdur.reset_fences()
    tdur.reset_fences()
    yield
    jdur.reset_fences()
    tdur.reset_fences()


def _committed(name):
    with open(os.path.join(TRACE_DIR, name)) as f:
        return f.read()


def _port_trace(name, tmp_path):
    """The port's regeneration of one committed artifact on the CPU."""
    if name == "sim_spot_preemption_s11.json":
        return tsim.run_scenario(tscn.spot_preemption(11),
                                 device="cpu").log_text()
    if name == "sim_hetero_drain_s41.json":
        scn = dataclasses.replace(tscn.hetero_drain(41),
                                  scheduler="critical_path")
        return tsim.run_scenario(scn, device="cpu").log_text()
    if name == "crash_storm_s19.json":
        cs = tscn.crash_storm(19)
        return tcrash.run_crash_scenario(
            cs.base, str(tmp_path), crashes=cs.crashes,
            snapshot_every=cs.snapshot_every,
            rotate_records=cs.rotate_records, device="cpu").log_text()
    assert name == "fleet_zone_outage_s5_t8.json"
    return tfleetsim.run_fleet_scenario(
        tscn.fleet_zone_outage(seed=5, tenants=8), device="cpu").log_text()


@pytest.mark.parametrize("name", [
    "sim_spot_preemption_s11.json", "sim_hetero_drain_s41.json",
    "crash_storm_s19.json", "fleet_zone_outage_s5_t8.json"])
def test_committed_trace_replays_through_the_port(name, tmp_path):
    assert _port_trace(name, tmp_path) == _committed(name)


def _outcome(out):
    return dict(ok=out.ok, signature=out.signature, steps=out.steps,
                choices=out.choices,
                candidate_counts=out.candidate_counts)


def test_committed_schedule_trace_replays_through_the_port():
    """The pause-guard schedule replays on the port's explorer and
    orchestrator (non-strict, as the reference replays it on the fixed
    supplier) to the reference's outcome, step for step."""
    from blance_tpu.analysis.schedule import SCENARIOS as JSCHED
    from blance_tpu.testing.sched import load_trace as jload
    from blance_tpu.testing.sched import replay as jreplay

    path = os.path.join(TRACE_DIR, "pause_cycle_guard.json")
    port = tsched.replay(SCHED["pause_cycle_guard"].factory,
                         tsched.load_trace(path), strict=False)
    ref = jreplay(JSCHED["pause_cycle_guard"].factory, jload(path),
                  strict=False)
    assert port.ok, port.describe()
    assert _outcome(port) == _outcome(ref)


# -- the closed-loop simulator --------------------------------------------------


def _sim_pair(family, seed, **fields):
    """One scenario through both packages: the port on the CPU, the
    reference as its tests run it (``backend="cuda"`` is the reference's
    ``"tpu"``)."""
    jfields = dict(fields)
    if fields.get("backend") == "cuda":
        jfields["backend"] = "tpu"
    ref = jsim.run_scenario(dataclasses.replace(
        jscn.SCENARIOS[family](seed), **jfields))
    port = tsim.run_scenario(dataclasses.replace(
        tscn.SCENARIOS[family](seed), **fields), device="cpu")
    return ref, port


def _assert_same_run(ref, port):
    assert port.log_text() == ref.log_text()
    assert port.exposition == ref.exposition
    assert dataclasses.asdict(port.summary) == dataclasses.asdict(ref.summary)
    assert (port.complete, port.rebalances, port.superseded,
            port.unconverged, port.convergence_lags,
            port.offline_min_moves, port.unscripted_drops) == \
        (ref.complete, ref.rebalances, ref.superseded, ref.unconverged,
         ref.convergence_lags, ref.offline_min_moves, ref.unscripted_drops)


def test_sim_families_are_the_references():
    assert sorted(tscn.SCENARIOS) == sorted(jscn.SCENARIOS)
    for family in tscn.SCENARIOS:
        a, b = tscn.SCENARIOS[family](11), jscn.SCENARIOS[family](11)
        assert [f.name for f in dataclasses.fields(a)] == \
            [f.name for f in dataclasses.fields(b)]
        assert (a.name, a.backend, len(a.events)) == \
            (b.name, b.backend, len(b.events))


@pytest.mark.parametrize("seed", SIM_SEEDS)
@pytest.mark.parametrize("family", sorted(jscn.SCENARIOS))
def test_sim_log_matches_reference(family, seed):
    _assert_same_run(*_sim_pair(family, seed))


@pytest.mark.parametrize("seed", SIM_SEEDS)
@pytest.mark.parametrize("variant", [
    ("spot_preemption", dict(use_session=True)),
    ("hetero_drain", dict(scheduler="critical_path")),
    ("zone_flap", dict(backend="cuda")),
], ids=["session", "critical_path", "cuda"])
def test_sim_variant_matches_reference(variant, seed):
    family, fields = variant
    _assert_same_run(*_sim_pair(family, seed, **fields))


def test_sim_session_on_the_batched_backend_matches_reference():
    """The card's configuration of chip_smoke's closed loop (the batched
    backend under a PlannerSession), here on the CPU."""
    _assert_same_run(*_sim_pair("spot_preemption", 11, backend="cuda",
                                use_session=True))


@pytest.mark.parametrize("seed", SIM_SEEDS)
def test_slo_recompute_matches_summary(seed):
    """The port's incremental SLO account equals the brute-force
    recompute from its own raw log (tests/test_simulate.py)."""
    for family in ("spot_preemption", "zone_flap", "weight_drift"):
        r = tsim.run_scenario(tscn.SCENARIOS[family](seed), device="cpu")
        ref = tsim.recompute_slo_from_log(r.events)
        s = r.summary
        assert s.availability == ref["availability"], family
        assert s.moves_executed == ref["moves_executed"], family
        assert s.moves_failed == ref["moves_failed"], family
        assert s.time_weighted_availability == \
            ref["time_weighted_availability"], family
        assert s.violation_s == ref["violation_s"], family
        assert s.violation_intervals == ref["violation_intervals"], family
        assert s.convergence_lag_s == ref["convergence_lag_s"], family


def test_simulators_ask_for_the_card(monkeypatch, tmp_path):
    """Called without ``device=``, every simulator entry targets the card
    and raises without one, before it runs anything."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cs = tscn.crash_smoke(17)
    calls = [
        lambda: tsim.run_scenario(tscn.spot_preemption(11)),
        lambda: tcrash.run_crash_scenario(cs, str(tmp_path / "a")),
        lambda: tcrash.crash_matrix(cs, str(tmp_path / "b")),
        lambda: tfleetsim.run_fleet_scenario(
            tscn.fleet_zone_outage(seed=5, tenants=2)),
        lambda: tvis.run_vis_cases([]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="is_available"):
            call()
    assert not os.listdir(tmp_path)


# -- the crash simulator ----------------------------------------------------------


@pytest.mark.parametrize("snapshots", [
    dict(), dict(snapshot_every=4, rotate_records=8)],
    ids=["plain", "snapshots"])
def test_crash_matrix_matches_reference(snapshots, tmp_path):
    """A crash at every journal-record boundary of crash_smoke(17):
    each restart recovers bit-identically to the crash-free run, and
    every life's log is the reference's."""
    ref, ref_runs = jcrash.crash_matrix(
        jscn.crash_smoke(17), str(tmp_path / "ref"), **snapshots)
    port, runs = tcrash.crash_matrix(
        tscn.crash_smoke(17), str(tmp_path / "port"), device="cpu",
        **snapshots)
    assert port.log_text() == ref.log_text()
    assert port.counters == ref.counters
    assert len(runs) == len(ref_runs) == port.records_first_life >= 20
    for (k, got), (kr, want) in zip(runs, ref_runs):
        assert k == kr
        assert got.lives == 2, k
        assert tcrash.maps_identical(got.final_map, port.final_map), k
        assert got.log_text() == want.log_text(), k
        assert got.counters == want.counters, k


# -- the fleet simulator ----------------------------------------------------------

FLEET_FAMILIES = {
    "zone_outage": lambda m: m.fleet_zone_outage(seed=5, tenants=8),
    "onboarding": lambda m: m.fleet_onboarding(seed=13, tenants=12),
    "noisy_neighbor": lambda m: m.fleet_noisy_neighbor(seed=29, tenants=10),
}
FLEET_MODES = {
    "coalesced": dict(),
    "sequential": dict(coalesce=False),
    "full_encode": dict(encode_residency=False),
}

# What a fleet run accounts for besides its log (host wall times and the
# encode split are not replayed).
FLEET_FIELDS = ("complete", "tenants", "dispatches", "plan_requests",
                "starved_admissions", "carry_evictions", "carry_hits",
                "cycles", "passes", "superseded", "unconverged",
                "admission_p50_s", "admission_p99_s", "encode_cold",
                "encode_warm", "encode_demotions", "encode_evictions",
                "encode_patch_bytes", "encode_patch_rows", "decode_full",
                "decode_patch")


@pytest.mark.parametrize("mode", sorted(FLEET_MODES))
@pytest.mark.parametrize("family", sorted(FLEET_FAMILIES))
def test_fleet_family_matches_reference(family, mode):
    ref = jfleetsim.run_fleet_scenario(FLEET_FAMILIES[family](jscn),
                                       **FLEET_MODES[mode])
    port = tfleetsim.run_fleet_scenario(FLEET_FAMILIES[family](tscn),
                                        device="cpu", **FLEET_MODES[mode])
    assert port.log_text() == ref.log_text()
    assert port.exposition == ref.exposition
    assert dataclasses.asdict(port.fleet) == dataclasses.asdict(ref.fleet)
    assert {k: dataclasses.asdict(s) for k, s in port.summaries.items()} \
        == {k: dataclasses.asdict(s) for k, s in ref.summaries.items()}
    for f in FLEET_FIELDS:
        assert getattr(port, f) == getattr(ref, f), f
    assert port.complete and port.fleet.availability_min == 1.0


# -- the visual golden corpus -----------------------------------------------------


@pytest.mark.parametrize("backend", ["greedy", "cuda"])
@pytest.mark.parametrize("suite", VIS_SUITES, ids=[f for _, f in VIS_SUITES])
def test_vis_golden_cases_through_the_port(monkeypatch, suite, backend):
    """The reference's golden suites' cases through the port's
    ``run_vis_cases``: bit for bit on greedy, contract mode (audit clean,
    balance within the golden oracle's spread, equal warning counts) on
    the batched backend."""
    module, name = suite
    captured: list = []
    monkeypatch.setattr(module, "run_vis_cases",
                        lambda cases, backend=None: captured.extend(cases))
    getattr(module, name)(backend="greedy")
    assert captured
    cases = [tvis.VisCase(**{f.name: to_port(getattr(c, f.name))
                             for f in dataclasses.fields(c)})
             for c in captured]
    tvis.run_vis_cases(cases, backend=backend, device="cpu")


# -- the deterministic loop -------------------------------------------------------

LOOP_CASES = rebind(ref_sched, {
    name: getattr(tsched, name) for name in (
        "DeadlockError", "DeterministicLoop", "FifoPolicy",
        "InvariantViolation", "PrefixPolicy", "RandomWalkPolicy",
        "ReplayDivergence", "StepLimitExceeded", "Trace", "explore",
        "load_trace", "replay", "run_controlled", "save_trace")})


@pytest.mark.parametrize("case", sorted(
    n for n in vars(ref_sched) if n.startswith("test_")))
def test_deterministic_loop_case_on_port(case, request):
    call_with_fixtures(LOOP_CASES[case], request)


def test_port_sched_exports_the_reference_surface():
    import blance_tpu.testing.sched as jsched

    assert sorted(tsched.__all__) == sorted(jsched.__all__)


# -- slow: the soak, the fleet week, hash-seed independence ------------------------


@pytest.mark.slow
def test_seven_day_soak_matches_reference():
    """mixed_week(7) through both packages, on the exact planner (the
    reference's soak: its overlapping deltas really overlap) and on the
    batched one under a session (the card's closed loop)."""
    ref, port = _sim_pair("mixed_week", 7)
    _assert_same_run(ref, port)
    assert port.wall_s < 60.0
    assert port.complete and port.unscripted_drops == []
    assert port.superseded >= 1
    ref, port = _sim_pair("mixed_week", 7, backend="cuda", use_session=True)
    _assert_same_run(ref, port)
    assert port.complete and port.unscripted_drops == []


# The reference's fleet_week() digests, pinned in chip_smoke.py too.
FLEET_WEEK_LOG_SHA256 = (
    "166bacaf16c693a1c2da9282a25e99326f65dff2cc9f0382ef73fa07308ac4ab")
FLEET_WEEK_EXPO_SHA256 = (
    "fd014693eeb2c88616c2f3f80bf2f455d5d6dc6c0af1f4d432601a324f11361f")


def _sha(text):
    return hashlib.sha256(text.encode()).hexdigest()


def test_chip_smoke_pins_the_fleet_week_digests():
    """chip_smoke.py holds the card's fleet week to the same digests and
    horizon the slow case below checks on the CPU."""
    import chip_smoke

    assert chip_smoke.FLEET_WEEK_LOG_SHA256 == FLEET_WEEK_LOG_SHA256
    assert chip_smoke.FLEET_WEEK_EXPO_SHA256 == FLEET_WEEK_EXPO_SHA256
    scn = tscn.fleet_week(days=chip_smoke.FLEET_WEEK_DAYS)
    assert (scn.horizon_s, len(scn.tenants), len(scn.nodes)) == \
        (7 * 86_400.0, 240, 18)


@pytest.mark.slow
def test_fleet_week_digests_match_reference():
    port = tfleetsim.run_fleet_scenario(tscn.fleet_week(), device="cpu")
    ref = jfleetsim.run_fleet_scenario(jscn.fleet_week())
    assert _sha(ref.log_text()) == FLEET_WEEK_LOG_SHA256
    assert _sha(ref.exposition) == FLEET_WEEK_EXPO_SHA256
    assert _sha(port.log_text()) == FLEET_WEEK_LOG_SHA256
    assert _sha(port.exposition) == FLEET_WEEK_EXPO_SHA256
    assert port.complete and port.unconverged == 0
    assert port.fleet.availability_min == 1.0
    assert port.dispatches * 4 <= port.plan_requests


# Regenerates the port's five artifacts in one interpreter on the CPU and
# prints a JSON map of name -> text (sorted keys).
_DRIVER = r"""
import json, sys, tempfile
from blance_tpu_torch.analysis.schedule import SCENARIOS
from blance_tpu_torch.testing.crashsim import run_crash_scenario
from blance_tpu_torch.testing.fleetsim import run_fleet_scenario
from blance_tpu_torch.testing.scenarios import (
    crash_storm, fleet_zone_outage, spot_preemption)
from blance_tpu_torch.testing.sched import load_trace, replay
from blance_tpu_torch.testing.simulate import run_scenario

out = {}
out["sim_spot_preemption_s11"] = run_scenario(
    spot_preemption(11), device="cpu").log_text()
out["fleet_zone_outage_s5_t8"] = run_fleet_scenario(
    fleet_zone_outage(seed=5, tenants=8), device="cpu").log_text()
cs = crash_storm(19)
out["crash_storm_s19"] = run_crash_scenario(
    cs.base, tempfile.mkdtemp(), crashes=cs.crashes,
    snapshot_every=cs.snapshot_every, rotate_records=cs.rotate_records,
    device="cpu").log_text()
res = replay(SCENARIOS["pause_cycle_guard"].factory,
             load_trace(sys.argv[1]), strict=False)
out["pause_cycle_guard"] = json.dumps(
    {"ok": res.ok, "signature": res.signature, "steps": res.steps,
     "choices": res.choices, "candidate_counts": res.candidate_counts},
    sort_keys=True)
print(json.dumps(out, sort_keys=True))
"""


def _regenerate(hashseed):
    env = dict(os.environ, PYTHONHASHSEED=hashseed, BLANCE_WAL_FSYNC="0",
               PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _DRIVER,
         os.path.join(TRACE_DIR, "pause_cycle_guard.json")],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=900)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.slow
def test_port_replays_are_hashseed_independent():
    """tests/test_hashseed_replay.py on the port: two interpreters under
    different PYTHONHASHSEEDs regenerate the same artifacts, equal to
    the committed ones."""
    a, b = _regenerate("0"), _regenerate("1")
    assert a == b
    for name in ("sim_spot_preemption_s11", "fleet_zone_outage_s5_t8",
                 "crash_storm_s19"):
        assert a[name] == _committed(name + ".json"), name
    assert json.loads(a["pause_cycle_guard"])["ok"] is True
