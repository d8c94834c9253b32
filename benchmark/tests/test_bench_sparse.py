"""The sparse deployment's cell on the CPU, and its readers.

``sparse1m.failover`` runs at the tests' small size with the program's
dense-score budget lowered to just under the matrix engine's projection,
so that ``plan_next_map(backend="auto")`` takes the sparse shortlist
engine as it does at a million partitions on the card: the chain comes
out correct and the sparse readers read, the card's roofline reads
nothing.  Each new reader is held on a synthetic run, and reads nothing
where the program has no such span or counter or the sparse engine did
not run."""

import pytest

import _bench_path
import harness
import tracing

CELL = "sparse1m.failover"
READERS = ("shortlist_ms", "sparse_fallback_ms", "exhausted_rows_per_plan",
           "sparse_min2_roofline")


def _read(metric, run):
    return harness.load_module("metrics", metric).read(run)


@pytest.fixture
def past_budget():
    from blance_tpu_torch.plan import tensor

    cfg = _bench_path.small_cfg(CELL)
    tensor.set_dense_score_budget(tensor.projected_score_bytes(
        cfg["partitions"], cfg["nodes"]) - 1)
    try:
        yield cfg
    finally:
        tensor.set_dense_score_budget(None)


def test_cell_on_the_sparse_engine_on_cpu(past_budget):
    result, lines = harness.run_cell(
        CELL, _bench_path.SEED + 2, 2.0, True, device="cpu",
        cfg=past_budget, limits=_bench_path.SMALL_LIMITS)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] >= 2
    got = result["metrics"]
    assert got["shortlist_ms"]["value"] > 0
    assert got["exhausted_rows_per_plan"]["value"] >= 0
    assert got["sparse_fallback_ms"]["value"] >= 0
    assert {"encode_ms", "decode_ms", "solve_ms", "sweeps_per_plan"} <= \
        set(got)
    # The card's readers find nothing on the CPU.
    assert not {"sparse_min2_roofline", "device_idle_pct"} & set(got)


def test_readers_listed_for_the_cell():
    by_name = {m["name"]: m for m in harness.spec()["per_layer"]}
    for metric in READERS:
        m = by_name[metric]
        assert m["moves"] == "plan_s" and m["workloads"] == [CELL]
    assert by_name["sparse_min2_roofline"]["unit"] == "%"
    assert by_name["sparse_min2_roofline"]["better"] == "higher"


def test_span_readers_per_request():
    run = harness.Run(requests=4, spans={"plan.sparse.shortlist": 0.2,
                                         "plan.sparse.fallback": 0.06})
    assert _read("shortlist_ms", run) == pytest.approx(50.0)
    assert _read("sparse_fallback_ms", run) == pytest.approx(15.0)


def test_exhausted_rows_per_request():
    run = harness.Run(requests=4,
                      spans={"plan.sparse.shortlist": 0.2},
                      counters={"plan.sparse.shortlist_exhausted": 10})
    assert _read("exhausted_rows_per_plan", run) == pytest.approx(2.5)


@pytest.mark.parametrize("metric", ["sparse_fallback_ms",
                                    "exhausted_rows_per_plan"])
def test_zero_where_the_sparse_engine_ran_clean(metric):
    run = harness.Run(requests=3, spans={"plan.sparse.shortlist": 0.1})
    assert _read(metric, run) == 0.0


@pytest.mark.parametrize("metric", READERS)
def test_nothing_without_the_sparse_engine(metric):
    # The matrix route (or a program before these spans and counters):
    # the solve's spans and counters alone.
    tl = tracing.Timeline(window_s=2.0, busy_s=1.0,
                          kernels={"priced_min2_kernel": 0.5},
                          idle_by_span={}, min2_s=[0.5],
                          min2_shapes=[((10, 4), (4,))])
    run = harness.Run(requests=3, spans={"plan.solve": 1.0},
                      counters={"plan.solve.sweeps": 6}, trace=tl)
    assert _read(metric, run) is None
    assert _read(metric, harness.Run(
        requests=0, spans={"plan.sparse.shortlist": 0.1,
                           "plan.sparse.fallback": 0.1},
        counters={"plan.sparse.shortlist_exhausted": 4,
                  "ops.sparse_min2.cells": 16})) is None


def _sparse_timeline(kernels):
    return tracing.Timeline(window_s=4.0, busy_s=1.0, kernels=kernels,
                            idle_by_span={}, min2_s=[], min2_shapes=[])


def test_roofline_is_the_frozen_bound_over_the_kernels_time():
    import yardstick

    cells, price, out = 16 * 10**6 * 20, 10**4 * 20, 5 * 10**6 * 20
    counters = {"ops.sparse_min2.cells": cells,
                "ops.sparse_min2.price_cells": price,
                "ops.sparse_min2.out_cells": out}
    kernels = {"sparse_min2_kernel<true, true>(float const*)": 0.8,
               "sparse_min2_kernel<true, false>(float const*)": 0.2,
               "priced_min2_kernel(float const*)": 5.0}
    run = harness.Run(requests=2, counters=counters,
                      trace=_sparse_timeline(kernels))
    nbytes = 8 * cells + 4 * price + 4 * out
    want = 100.0 * nbytes / yardstick.HBM_BYTES_PER_S / 1.0
    assert _read("sparse_min2_roofline", run) == pytest.approx(want)
    assert 0 < want <= 100


def test_roofline_nothing_without_either_side():
    counters = {"ops.sparse_min2.cells": 16,
                "ops.sparse_min2.price_cells": 4,
                "ops.sparse_min2.out_cells": 5}
    kernels = {"sparse_min2_kernel<true, true>(float const*)": 1e-6}
    # No trace (an untraced run, or the CPU's), no counters (a program
    # before them), or no such kernel in the window.
    assert _read("sparse_min2_roofline", harness.Run(
        requests=1, counters=counters)) is None
    assert _read("sparse_min2_roofline", harness.Run(
        requests=1, trace=_sparse_timeline(kernels))) is None
    assert _read("sparse_min2_roofline", harness.Run(
        requests=1, counters=counters,
        trace=_sparse_timeline({"priced_min2_kernel": 1.0}))) is None
