"""BENCHMARK.json is well formed, and every cell resolves by name to its
configuration, traffic, entry, limits and metric readers."""

import json
import os
import re

import pytest

import _bench_path
import deploy
import harness

BENCH = harness.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # A full check of 24 cells at this length fits in the driver's 12 h.
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert os.path.getsize(os.path.join(_bench_path.ROOT,
                                        "BENCHMARK.json")) <= 64 * 1024


def test_configs_resolve():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = deploy.load_json("configs", c["name"])
        assert cfg["source"] == c["source"] and _line(c["source"])
        assert cfg["reduced"] == c["reduced"]
        deploy.Deployment.from_config(cfg)
    assert names == {w["config"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    w = harness.workload(cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1 and _line(w["why"])
    traffic = deploy.load_json("traffic", w["traffic"])
    harness.load_module("entries", traffic["entry"]).Entry
    with open(os.path.join(_bench_path.BENCH, "limits",
                           f"{cell}.json")) as f:
        limits = json.load(f)
    assert {"violations", "balance_cv", "churn"} <= set(limits)
    e2e = harness.metrics_of(BENCH, cell, "end_to_end")
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    layer = harness.metrics_of(BENCH, cell, "per_layer")
    assert layer and all(m["moves"] in names for m in layer)


def test_metrics_resolve():
    seen = set()
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for group in ("end_to_end", "per_layer"):
        for m in BENCH[group]:
            assert NAME.match(m["name"]) and m["name"] not in seen
            seen.add(m["name"])
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
            assert set(m.get("workloads", CELLS)) <= set(CELLS)
            assert callable(harness.load_module("metrics", m["name"]).read)
            if group == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert m["source"] in ("device_trace", "program_span",
                                       "program_counter", "host_clock")
                assert m["moves"] in e2e and _line(m["layer"])


def test_layers_named_in_perf_md():
    with open(os.path.join(_bench_path.ROOT, "PERF.md")) as f:
        perf = f.read()
    for m in BENCH["per_layer"]:
        assert m["layer"] in perf, m["layer"]
