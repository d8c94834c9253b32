"""The port's native marshalling layer (blance_tpu_torch/native/marshal.c):
encode and decode with the extension equal the pure-Python path and the
JAX package's output, on randomized problems and the awkward cases:
unmodeled passthrough states, unknown node names, removed nodes, empty
partitions, structural surprises, and the fast Partition constructor.

The port's extension is ``_blance_torch_marshal``; the reference's is
``_blance_marshal``.  Both load in one process (these tests use both).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import blance_tpu  # noqa: E402
import blance_tpu.core.encode as jenc  # noqa: E402
import blance_tpu.core.marshal as jmarshal  # noqa: E402
import blance_tpu.core.types as jtypes  # noqa: E402
import blance_tpu_torch.core.encode as enc  # noqa: E402
import blance_tpu_torch.core.marshal as marshal  # noqa: E402
import blance_tpu_torch.core.types as ttypes  # noqa: E402
from blance_tpu_torch.core.types import (  # noqa: E402
    Partition, PartitionModelState, PlanOptions)
from _multi_width import multi_width_assign, multiprimary_problem  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def native():
    """The port's extension, loaded (the test skips without a compiler);
    the loader is restored to it afterwards."""
    if not marshal.available():
        pytest.skip("native marshal unavailable (no gcc or Python headers)")
    yield marshal.get()
    _with_native(True)


def _random_problem(lib, seed, P=200, N=16):
    rng = np.random.default_rng(seed)
    nodes = [f"n{i}" for i in range(N)]
    model = {
        "primary": lib.PartitionModelState(0, 2),
        "replica": lib.PartitionModelState(1, 1),
    }
    prev = {}
    for i in range(P):
        name = str(i)
        nbs = {}
        if rng.random() < 0.9:
            k = int(rng.integers(1, 4))
            nbs["primary"] = [nodes[j] for j in rng.choice(N, k, replace=False)]
        if rng.random() < 0.7:
            nbs["replica"] = [nodes[int(rng.integers(0, N))]]
        if rng.random() < 0.1:
            nbs["unmodeled"] = [nodes[0], "ghost-node", nodes[1]]
        if rng.random() < 0.05:
            nbs["primary"] = ["ghost-node"]  # unknown name -> -1 / skipped
        prev[name] = lib.Partition(name, nbs)
    return prev, nodes, model


def _with_native(flag):
    """Flip the loader so the same call takes the native or Python path."""
    marshal._MOD = None
    marshal._FAILED = not flag
    if flag:
        assert marshal.available()


def _both_paths(fn):
    """``fn()`` with the extension, then on the pure-Python path."""
    try:
        _with_native(True)
        a = fn()
        _with_native(False)
        b = fn()
    finally:
        _with_native(True)
    return a, b


def _same_problem(a, b):
    assert a.partitions == b.partitions and a.nodes == b.nodes
    assert a.states == b.states
    for f in ("prev", "constraints", "partition_weights", "node_weights",
              "valid_node", "stickiness", "gids", "gid_valid"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert (x == y).all(), f
    assert a.rules == b.rules


def _nbs(pmap):
    return {k: (p.name, p.nodes_by_state) for k, p in pmap.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_parity(native, seed):
    prev, nodes, model = _random_problem(jtypes, seed)
    tprev, _, tmodel = _random_problem(ttypes, seed)
    removed = [nodes[1]]
    a, b = _both_paths(lambda: enc.encode_problem(
        tprev, tprev, nodes, removed, tmodel, PlanOptions()))
    _same_problem(a, b)
    ref = jenc.encode_problem(prev, prev, nodes, removed, model,
                              blance_tpu.PlanOptions())
    _same_problem(a, ref)


@pytest.mark.parametrize("seed", [0, 1, 2, "multi-full", "multi-short",
                                  "multi-over"])
def test_decode_parity(native, seed):
    if isinstance(seed, int):
        prev, nodes, model = _random_problem(jtypes, seed)
        tprev, _, tmodel = _random_problem(ttypes, seed)
    else:
        prev, nodes, model = multiprimary_problem(jtypes)
        tprev, _, tmodel = multiprimary_problem(ttypes)
    removed = [nodes[2]]
    problem = enc.encode_problem(tprev, tprev, nodes, removed, tmodel,
                                 PlanOptions())
    if isinstance(seed, int):
        # Decode the previous assignment itself (plus some -1 holes).
        assign = problem.prev.copy()
        assign[::7, 0, -1] = -1
    else:
        assert problem.prev.shape[1:] == (3, 2)
        assign = multi_width_assign(problem.prev, seed[len("multi-"):])
    (map_n, warn_n), (map_p, warn_p) = _both_paths(
        lambda: enc.decode_assignment(problem, assign, tprev, removed))
    assert warn_n == warn_p
    assert _nbs(map_n) == _nbs(map_p)
    assert all(type(p) is Partition for p in map_n.values())
    jproblem = jenc.encode_problem(prev, prev, nodes, removed, model,
                                   blance_tpu.PlanOptions())
    map_r, warn_r = jenc.decode_assignment(jproblem, assign, prev, removed)
    assert warn_n == warn_r
    assert _nbs(map_n) == _nbs(map_r)
    if seed == "multi-full":
        assert not warn_n
    elif seed == "multi-over":
        assert len(map_n["4"].nodes_by_state["replica"]) == 2


def test_empty_problem(native):
    model = {"primary": PartitionModelState(0, 1)}
    problem = enc.encode_problem({}, {}, [], None, model, PlanOptions())
    assert problem.P == 0
    m, w = enc.decode_assignment(
        problem, np.full((0, 1, 1), -1, np.int32), {}, None)
    assert m == {} and w == {}


def test_structural_surprise_falls_back(native):
    """Tuple node lists take the pure-Python path instead of crashing
    (marshal.c is stricter than the fallback by design)."""
    model = {"primary": PartitionModelState(0, 1)}
    prev = {"p": Partition("p", {"primary": ("n0", "n1")})}  # tuple
    problem = enc.encode_problem(prev, prev, ["n0", "n1"], None, model,
                                 PlanOptions())
    assert problem.prev[0, 0, 0] == 0 and problem.prev[0, 0, 1] == 1
    m, w = enc.decode_assignment(problem, problem.prev, prev, None)
    assert m["p"].nodes_by_state["primary"] == ["n0", "n1"]


def test_none_in_prev_map_falls_back(native):
    """A None value in prev_map raises AttributeError inside marshal.c;
    the Python path tolerates it (``prev_map.get(p) or ...`` falls
    through to partitions_to_assign), so the native try must catch it."""
    model = {"primary": PartitionModelState(0, 1)}
    parts = {"a": Partition("a", {}), "b": Partition("b", {})}
    prev = {"a": None, "b": Partition("b", {"primary": ["n0"]})}
    problem = enc.encode_problem(prev, parts, ["n0", "n1"], None, model,
                                 PlanOptions())
    assert problem.prev[0, 0, 0] == -1 and problem.prev[1, 0, 0] == 0


def test_fast_ctor_parity_and_post_init_fallback(native):
    """build_map's __init__-bypassing constructor gives objects equal to
    normal construction for the port's Partition, and a subclass with
    __post_init__, an extra field or a hand-written __init__ takes the
    ordinary call."""
    parts = ["a", "b"]
    rows = [[["n0"], ["n1"]]]
    pta = {"a": Partition("a", {}), "b": Partition("b", {})}
    out = native.build_map(Partition, parts, ["primary"], rows, pta,
                           {"primary"}, set())
    got = out["a"]
    assert type(got) is Partition
    assert got == Partition("a", {"primary": ["n0"]})
    assert got.copy().nodes_by_state == {"primary": ["n0"]}

    @dataclasses.dataclass
    class Hooked(Partition):
        def __post_init__(self):
            self.hooked = True

    out = native.build_map(Hooked, parts, ["primary"], rows, pta,
                           {"primary"}, set())
    assert out["b"].hooked

    @dataclasses.dataclass
    class Tagged(Partition):
        tags: list = dataclasses.field(default_factory=list)

    out = native.build_map(Tagged, parts, ["primary"], rows, pta,
                           {"primary"}, set())
    assert out["a"].tags == []

    class Custom(Partition):
        def __init__(self, name, nodes_by_state):
            super().__init__(name.upper(), nodes_by_state)

    out = native.build_map(Custom, parts, ["primary"], rows, pta,
                           {"primary"}, set())
    assert out["a"].name == "A"


def test_port_builds_its_own_source(native):
    """The port compiles its own copy of the source, under its own module
    name and build directory."""
    assert native.__name__ == "_blance_torch_marshal"
    assert "blance_tpu_torch" in native.__file__
    assert marshal._source_path().endswith(
        "blance_tpu_torch/native/marshal.c")


def test_both_extensions_load_in_one_process():
    """The reference's and the port's extensions, loaded in one fresh
    interpreter, are distinct modules and each marshals its own package's
    Partition class."""
    code = (
        "import blance_tpu.core.marshal as j, "
        "blance_tpu_torch.core.marshal as t\n"
        "from blance_tpu.core.types import Partition as JP\n"
        "from blance_tpu_torch.core.types import Partition as TP\n"
        "a, b = j.get(), t.get()\n"
        "assert a is not None and b is not None and a is not b\n"
        "assert (a.__name__, b.__name__) == "
        "('_blance_marshal', '_blance_torch_marshal')\n"
        "pta = {'p': JP('p', {})}\n"
        "ma = a.build_map(JP, ['p'], ['s'], [[['n']]], pta, {'s'}, set())\n"
        "mb = b.build_map(TP, ['p'], ['s'], [[['n']]], pta, {'s'}, set())\n"
        "assert type(ma['p']) is JP and type(mb['p']) is TP\n"
        "assert ma['p'].nodes_by_state == mb['p'].nodes_by_state\n"
        "print('OK')\n")
    if not (jmarshal.available() and marshal.available()):
        pytest.skip("native marshal unavailable (no gcc or Python headers)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "OK"
