"""The readers of the audit's span and the solver's counters:
``audit_ms``, ``auction_rounds_per_plan`` and ``host_syncs_per_plan``
per request, and nothing where the program has no such span or counter
(a program before them) or no request completed."""

import pytest

import _bench_path  # noqa: F401 (puts the harness on sys.path)
import harness

READERS = {
    "audit_ms": ("spans", "plan.audit", 0.15, 50.0),
    "auction_rounds_per_plan": ("counters", "plan.solve.auction_rounds",
                                120, 40.0),
    "host_syncs_per_plan": ("counters", "plan.solve.host_syncs", 189,
                            63.0),
}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_per_request(metric):
    field, name, total, want = READERS[metric]
    read = harness.load_module("metrics", metric).read
    run = harness.Run(requests=3, **{field: {name: total,
                                             "plan.solve": 2.0}})
    assert read(run) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_reads_nothing_without_its_source(metric):
    field, name, total, _ = READERS[metric]
    read = harness.load_module("metrics", metric).read
    # A program without the span or counter: the encode span and the
    # sweep counter alone, as before they were added.
    assert read(harness.Run(requests=3, spans={"plan.encode": 0.4},
                            counters={"plan.solve.sweeps": 6})) is None
    assert read(harness.Run(requests=0, **{field: {name: total}})) is None


def test_readers_listed_in_benchmark():
    bench = harness.spec()
    by_name = {m["name"]: m for m in bench["per_layer"]}
    for metric, (field, _, _, _) in READERS.items():
        m = by_name[metric]
        assert m["moves"] == "plan_s"
        assert m["source"] == ("program_span" if field == "spans"
                               else "program_counter")
        assert m["workloads"] == ["northstar.failover",
                                  "multiprimary.failover"]
