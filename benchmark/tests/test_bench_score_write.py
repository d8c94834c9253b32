"""The score write's roofline reader, on synthetic runs: the frozen
store bound of the window's ``ops.score_write.cells`` over the device
time of ``score_write_kernel*``, nothing where the program has no such
counter (the parent, or a CPU run) or the profiler saw no such kernel,
and the metric listed for the two matrix cells."""

import pytest

import _bench_path  # noqa: F401  the benchmark's folder on sys.path
import harness
import tracing

METRIC = "score_write_roofline"


def _read(run):
    return harness.load_module("metrics", METRIC).read(run)


def _timeline(kernels):
    return tracing.Timeline(window_s=20.0, busy_s=8.0, kernels=kernels,
                            idle_by_span={}, min2_s=[], min2_shapes=[])


def test_listed_for_the_matrix_cells():
    by_name = {m["name"]: m for m in harness.spec()["per_layer"]}
    m = by_name[METRIC]
    assert m["workloads"] == ["northstar.failover", "multiprimary.failover"]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == \
        ("%", "higher", "device_trace", "kernels", "plan_s")


def test_share_is_the_store_bound_over_the_kernels_time():
    import yardstick

    cells = 4 * 10**9 * 20  # four builds of 10^9 cells, 20 plans
    kernels = {"score_write_kernel<1, 1, 2, 2>(Args, float*, int)": 90.0,
               "score_write_kernel<0, 1, 1, 0>(Args, float*, int)": 30.0,
               "priced_min2_kernel(float const*)": 110.0,
               "fused_score_min2_kernel<1, 1, 2, 2>(Args)": 7.0}
    run = harness.Run(requests=20, counters={"ops.score_write.cells": cells},
                      trace=_timeline(kernels))
    want = 100.0 * 4 * cells / yardstick.HBM_BYTES_PER_S / 120.0
    assert _read(run) == pytest.approx(want)
    assert 0 < want <= 100


def test_nothing_without_either_side():
    counters = {"ops.score_write.cells": 10**6}
    kernels = {"score_write_kernel<1, 1, 2, 2>(Args, float*, int)": 1e-3}
    # An untraced run (or the CPU's), a program without the counter (the
    # parent's eager build), or no such kernel in the window.
    assert _read(harness.Run(requests=1, counters=counters)) is None
    assert _read(harness.Run(requests=1,
                             trace=_timeline(kernels))) is None
    assert _read(harness.Run(
        requests=1, counters=counters,
        trace=_timeline({"priced_min2_kernel(float const*)": 1.0}))) is None
