"""The port's schedule explorer (``blance_tpu_torch.analysis.schedule``)
against the reference's, on the CPU.

Every scenario of the registry builds a real orchestration (or plan
service) of the port inside the port's controlled loop; the seeded walks
and the bounded-exhaustive enumerations must walk the reference's
schedules step for step (equal signatures, choices and candidate
counts), and the CLI must gate and emit replayable traces as the
reference's does.
"""

import os

import pytest

pytest.importorskip("jax")  # the reference package imports it

import blance_tpu.analysis.schedule as jschedule  # noqa: E402
import blance_tpu.testing.sched as jsched  # noqa: E402

import blance_tpu_torch.analysis.schedule as tschedule  # noqa: E402
from blance_tpu_torch.orchestrate.orchestrator import Orchestrator  # noqa: E402
from blance_tpu_torch.testing import sched as tsched  # noqa: E402

from test_race_regressions import _prefix_wait  # noqa: E402

TRACE = os.path.join(os.path.dirname(__file__), "traces",
                     "pause_cycle_guard.json")


@pytest.fixture
def prefix_supplier(monkeypatch):
    """The port's orchestrator with the pre-fix supplier pause wait
    (tests/test_race_regressions.py's shim)."""
    monkeypatch.setattr(Orchestrator, "_wait_while_paused", _prefix_wait)


def test_registry_is_the_references():
    assert list(tschedule.SCENARIOS) == list(jschedule.SCENARIOS)
    for name, s in tschedule.SCENARIOS.items():
        r = jschedule.SCENARIOS[name]
        assert (s.doc, s.exhaustive, s.branch_budget, s.max_schedules) == \
            (r.doc, r.exhaustive, r.branch_budget, r.max_schedules), name
    assert tschedule.CI_WALK_SEEDS == jschedule.CI_WALK_SEEDS
    assert sorted(tschedule.__all__) == sorted(jschedule.__all__)


def _walk(out):
    return (out.ok, out.signature, out.steps, out.choices,
            out.candidate_counts, out.result)


def test_chip_smoke_pins_the_cpu_walk_signatures():
    """chip_smoke.py holds the card's walks to these signatures: the
    port's on the CPU, which are the reference's (the case below)."""
    import chip_smoke

    assert sorted(chip_smoke.SCHEDULE_WALK_SIGNATURES) == \
        sorted(tschedule.SCENARIOS)
    for name, s in tschedule.SCENARIOS.items():
        walks = tschedule.run_scenario_walks(s, tschedule.CI_WALK_SEEDS)
        assert tuple(w.signature for _seed, w in walks) == \
            chip_smoke.SCHEDULE_WALK_SIGNATURES[name], name


@pytest.mark.parametrize("name", list(jschedule.SCENARIOS))
def test_walks_match_reference(name):
    port = tschedule.run_scenario_walks(tschedule.SCENARIOS[name])
    ref = jschedule.run_scenario_walks(jschedule.SCENARIOS[name])
    assert [seed for seed, _ in port] == list(tschedule.CI_WALK_SEEDS)
    for (seed, got), (_s, want) in zip(port, ref):
        assert got.ok, f"{name} seed={seed}: {got.describe()}"
        assert _walk(got) == _walk(want), (name, seed)


def _signatures(module, sched, scenario, budget):
    """Every schedule an enumeration ran, in order: (ok, signature)."""
    seen = []
    run = sched.run_controlled

    def spy(*args, **kw):
        out = run(*args, **kw)
        seen.append((out.ok, out.signature))
        return out

    sched.run_controlled = spy
    try:
        rep = module.run_scenario_exhaustive(scenario, branch_budget=budget)
    finally:
        sched.run_controlled = run
    return rep, seen


@pytest.mark.parametrize("name", list(jschedule.SCENARIOS))
def test_bounded_exhaustive_matches_reference(name):
    """The pause guard at its own budget (2), the rest at one preemption:
    the same schedules, in the same order, none violating."""
    budget = 2 if name == "pause_cycle_guard" else 1
    rep, port = _signatures(tschedule, tsched, tschedule.SCENARIOS[name],
                            budget)
    jrep, ref = _signatures(jschedule, jsched, jschedule.SCENARIOS[name],
                            budget)
    assert rep.complete and rep.violations == [], rep.summary()
    assert rep.summary() == jrep.summary()
    assert port == ref and len(port) == rep.schedules > 1


def test_committed_trace_fails_on_prefix_code(prefix_supplier):
    out = tsched.replay(tschedule.SCENARIOS["pause_cycle_guard"].factory,
                        tsched.load_trace(TRACE), strict=True)
    assert not out.ok
    assert isinstance(out.error, tsched.InvariantViolation)
    assert "paused" in str(out.error)


def test_schedule_cli_smoke(capsys):
    rc = tschedule.main(["--scenario", "pause_cycle_guard", "--budget", "0"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "pause_cycle_guard" in out and "OK" in out
    assert "blance_tpu_torch.analysis.schedule: OK" in out

    rc = tschedule.main(["--scenario", "supersede_mid_rebalance",
                         "--seeds", "11,23"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("walk supersede_mid_rebalance seed=") == 2

    rc = tschedule.main(["--list"])
    out = capsys.readouterr().out
    assert rc == 0
    assert all(name in out for name in tschedule.SCENARIOS)

    rc = tschedule.main(["--scenario", "no_such_scenario"])
    assert rc == 2
    assert "unknown scenario" in capsys.readouterr().err


def test_schedule_cli_emits_trace_on_violation(tmp_path, capsys,
                                               prefix_supplier):
    trace_dir = str(tmp_path / "traces")
    rc = tschedule.main(["--scenario", "pause_cycle_guard", "--budget", "0",
                         "--trace-dir", trace_dir])
    assert "FAIL" in capsys.readouterr().out
    assert rc == 1
    files = sorted(os.listdir(trace_dir))
    assert files, "violating schedule was not written as a trace"
    tr = tsched.load_trace(os.path.join(trace_dir, files[0]))
    assert tr.scenario == "pause_cycle_guard"
    out = tsched.replay(tschedule.SCENARIOS["pause_cycle_guard"].factory, tr,
                        strict=True)
    assert not out.ok
    assert isinstance(out.error, tsched.InvariantViolation)
