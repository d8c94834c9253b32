"""One short run of each cell on the card, through run.py: the last line
of standard output is the result, correct, with the cell's end-to-end
metrics.  Needs an NVIDIA card; skips without one."""

import json
import os
import subprocess
import sys

import pytest

import _bench_path
import harness


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.spec()["workloads"]])
def test_cell_on_card(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2**31 + 11), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=_bench_path.ROOT,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    want = {m["name"] for m in harness.metrics_of(harness.spec(), cell,
                                                  "end_to_end")}
    assert set(result["metrics"]) == want
