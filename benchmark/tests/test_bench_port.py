"""The port against the reference at small sizes on the CPU: every cell's
chain runs through the program's entry and comes out correct (no
violation, the move lists equal to the reference's), and the per-layer
readers find the program's spans and counters."""

import pytest

import _bench_path
import harness

CELLS = [w["name"] for w in harness.spec()["workloads"]]
MIXES = _bench_path.mixes()


@pytest.mark.parametrize("cell", sorted(MIXES))
def test_cell_correct_on_cpu(cell):
    result, lines = harness.run_cell(
        cell, _bench_path.SEED, 5.0, False, device="cpu",
        cfg=_bench_path.small_cfg(cell), limits=_bench_path.SMALL_LIMITS,
        w=MIXES[cell])
    checks = result["checks"]
    assert checks["violations"][0] == 0
    assert checks.get("moves_mismatch", [0])[0] == 0
    assert result["correct"], lines
    assert result["attempted"] >= 2 and result["failed"] == 0
    want = {m["name"] for m in harness.metrics_of(harness.spec(), cell,
                                                  "end_to_end")}
    assert set(result["metrics"]) == want
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_traced_readers_on_cpu(cell):
    result, _ = harness.run_cell(
        cell, _bench_path.SEED + 1, 1.5, True, device="cpu",
        cfg=_bench_path.small_cfg(cell), limits=_bench_path.SMALL_LIMITS)
    assert result["correct"]
    got = set(result["metrics"])
    # The card's readers find nothing on the CPU; the program's spans
    # and counters are there.
    assert {"solve_ms", "sweeps_per_plan"} <= got
    assert not {"min2_roofline", "device_idle_pct"} & got
    session = harness.workload(cell)["traffic"] == "swap"
    assert ({"carry_hit_pct"} if session else {"encode_ms", "decode_ms"}) \
        <= got
    assert result["device"]["window_s"] > 0
    assert result["breakdown"]["idle_gaps"]


def test_carry_hit_reader():
    read = harness.load_module("metrics", "carry_hit_pct").read
    run = harness.Run(requests=4, counters={"plan.solve.carry_hit": 3,
                                            "plan.solve.carry_miss": 1})
    assert read(run) == 75.0
    assert read(harness.Run(requests=4)) is None
