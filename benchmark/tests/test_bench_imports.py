"""What the benchmark runs imports neither JAX nor the JAX package
(top-level module names compared whole: ``blance_tpu_torch`` is the
program, ``blance_tpu`` is not), and the reference imports nothing of
the program either; without a card, or without the program, a run ends
non-zero and prints no result."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

import _bench_path

BANNED = {"jax", "jaxlib", "flax", "blance_tpu"}
PLAIN = {"reference.py", "deploy.py", "yardstick.py"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    for d, _, files in os.walk(_bench_path.BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not set(_imports(path)) & BANNED, path


@pytest.mark.parametrize("name", sorted(PLAIN))
def test_reference_side_imports_no_program(name):
    got = set(_imports(os.path.join(_bench_path.BENCH, name)))
    assert got <= {"__future__", "numpy", "dataclasses", "json", "os",
                   "deploy"}, got


def test_run_loads_no_jax_module():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import _bench_path, harness\n"
        "r, _ = harness.run_cell('northstar.failover', 5, 0.5, True,"
        " device='cpu', cfg=_bench_path.small_cfg('northstar.failover'),"
        " limits=_bench_path.SMALL_LIMITS)\n"
        "assert 'blance_tpu_torch' in sys.modules\n"
        "print(harness.banned_modules())\n"
        % (os.path.dirname(__file__), _bench_path.BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=_bench_path.ROOT,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "northstar.failover", "--seed", str(2**31 + 1), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=cwd)


def test_no_result_without_a_card_or_the_program(tmp_path):
    out = _run(_bench_path.ROOT)  # this machine has no card
    assert out.returncode != 0 and out.stdout == ""
    shutil.copy(os.path.join(_bench_path.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(_bench_path.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
