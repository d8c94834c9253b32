"""The port's native marshalling layer (blance_tpu_torch/native/marshal.c):
encode and decode with the extension equal the pure-Python path and the
JAX package's output, on randomized problems and the awkward cases:
unmodeled passthrough states, unknown node names, removed nodes, empty
partitions, structural surprises, and the fast Partition constructor.
The encode's one walk of the input map is held to both on maps in and
out of the planner's order, prev maps that are not the partitions' map,
rows wider than their constraint and passthrough states; with the two
maps one object, encode + decode read each source once.

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
import blance_tpu_torch  # noqa: E402
import blance_tpu.core.encode as jenc  # noqa: E402
import blance_tpu.core.marshal as jmarshal  # noqa: E402
import blance_tpu.core.types as jtypes  # noqa: E402
import blance_tpu_torch.core.encode as enc  # noqa: E402
import blance_tpu_torch.core.marshal as marshal  # noqa: E402
import blance_tpu_torch.core.types as ttypes  # noqa: E402
from blance_tpu_torch.core.types import (  # noqa: E402
    Partition, PartitionModelState, PlanOptions)
from blance_tpu_torch.obs import Recorder, use_recorder  # noqa: E402
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


# --- the encode's one walk of the input map, and the decode's use of it ---

WALK_CASES = ["sorted", "shuffled", "extra", "missing", "other", "empty",
              "wide", "passthrough", "none"]


def _walk_case(lib, case, P=120, N=12, seed=5):
    """(prev_map, partitions_to_assign, nodes, model, removed) for one
    case of the walk: ``sorted`` the planner's own order; ``shuffled``
    the same map inserted in a random order; ``extra`` / ``missing`` a
    prev map with names the partitions lack (in the middle of its order)
    or without some of theirs; ``other`` a prev map that is another
    object with other placements, while some of the partitions' sources
    carry an unmodeled state; ``empty`` no prev map, the same partitions;
    ``wide`` rows wider than their
    constraint (a second walk at the wider R); ``passthrough`` unmodeled
    and zero-constraint states in some sources; ``none`` a None entry in
    the prev map."""
    rng = np.random.default_rng(seed)
    nodes = [f"n{i:02d}" for i in range(N)]
    model = {"primary": lib.PartitionModelState(0, 1),
             "replica": lib.PartitionModelState(1, 1)}
    if case == "passthrough":
        model["standby"] = lib.PartitionModelState(2, 0)

    def part(name, plain=False):
        a, b, c = (nodes[int(j)] for j in rng.choice(N, 3, replace=False))
        nbs = {"primary": [a], "replica": [b]}
        draw = rng.random()
        if plain:
            pass
        elif case == "wide" and draw < 0.1:
            nbs["replica"] = [b, c, nodes[0] if nodes[0] not in (a, b, c)
                              else "ghost-node"]
        elif case in ("passthrough", "other", "empty") and draw < 0.1:
            nbs["unmodeled"] = [a, "ghost-node", c]
        elif case == "passthrough" and draw < 0.2:
            nbs = {"standby": [c], **nbs}
        return lib.Partition(name, nbs)

    names = [f"{i:04d}" for i in range(P)]
    if case == "shuffled":
        names = [names[int(i)] for i in rng.permutation(P)]
    pta = {name: part(name) for name in names}
    prev = pta
    if case == "extra":
        prev = {}
        for name in names:
            prev[name] = pta[name]
            if name in ("0040", "0077"):
                prev[name + "x"] = part(name + "x")
    elif case == "missing":
        prev = {name: p for i, (name, p) in enumerate(pta.items())
                if i % 9 != 4}
    elif case == "other":
        prev = {name: part(name, plain=True) for name in names}
    elif case == "empty":
        prev = {}
    elif case == "none":
        prev = dict(pta)
        prev[names[3]] = None
    return prev, pta, nodes, model, [nodes[2]]


def _marked(pta, problem):
    solved = {s for si, s in enumerate(problem.states)
              if problem.constraints[si] > 0}
    return [pi for pi, name in enumerate(problem.partitions)
            if not pta[name].nodes_by_state.keys() <= solved]


def _objects(pmap):
    """The ids of every Partition, nodes_by_state dict and node list of
    ``pmap``."""
    ids = set()
    for p in pmap.values():
        if p is None:
            continue
        ids.update((id(p), id(p.nodes_by_state)))
        ids.update(id(ns) for ns in p.nodes_by_state.values())
    return ids


@pytest.mark.parametrize("case", WALK_CASES)
def test_walk_encode_parity(native, case):
    """One walk of the input map gives the pure-Python path's and the JAX
    package's problem, marks the rows with states to pass through (only
    when every source came from the partitions' map: the prev map is that
    map, or empty), and counts the prev map's entries it found by a
    hashed lookup, out of step."""
    jprev, jpta, nodes, jmodel, removed = _walk_case(jtypes, case)
    prev, pta, _, model, _ = _walk_case(ttypes, case)
    recs = []

    def encode():
        recs.append(Recorder())
        with use_recorder(recs[-1]):
            return enc.encode_problem(prev, pta, nodes, removed, model,
                                      PlanOptions())

    a, b = _both_paths(encode)
    _same_problem(a, b)
    _same_problem(a, jenc.encode_problem(jprev, jpta, nodes, removed,
                                         jmodel, blance_tpu.PlanOptions()))
    assert a.R == (3 if case == "wide" else 1)
    want = _marked(pta, a)
    assert bool(want) == (case in ("passthrough", "other", "empty"))
    if prev is pta or not prev:
        for problem in (a, b):
            marks = problem.passthrough
            assert marks.source is pta and marks.rows == want
            assert marks.partitions is problem.partitions
            assert marks.solved == {"primary", "replica"}
    else:
        assert a.passthrough is None and b.passthrough is None
    # The pure-Python path finds every prev_map entry by hash; the walk
    # only those past the first entry out of step.
    held = sum(prev.get(name) is not None for name in a.partitions)
    assert recs[-1].counters.get("plan.encode.rows_keyed", 0) == held
    keyed = recs[0].counters.get("plan.encode.rows_keyed", 0)
    if case in ("sorted", "other", "empty", "wide", "passthrough"):
        assert keyed == 0
    elif case == "none":
        assert keyed == held  # the walk raised: the Python path's count
    else:
        assert 0 < keyed <= held


@pytest.mark.parametrize("case", WALK_CASES)
def test_walk_decode_parity(native, case):
    """Encode + decode equal the pure-Python path and the JAX package,
    maps and warnings, whether or not the decode may trust the encode's
    marks; the result shares no Partition, dict or list with the input."""
    jprev, jpta, nodes, jmodel, removed = _walk_case(jtypes, case)
    prev, pta, _, model, _ = _walk_case(ttypes, case)
    problem = enc.encode_problem(prev, pta, nodes, removed, model,
                                 PlanOptions())
    assign = problem.prev.copy()
    assign[::7, 0, 0] = -1  # some shortfalls: warnings

    def plan():
        return enc.decode_assignment(
            enc.encode_problem(prev, pta, nodes, removed, model,
                               PlanOptions()), assign, pta, removed)

    (map_n, warn_n), (map_p, warn_p) = _both_paths(plan)
    jproblem = jenc.encode_problem(jprev, jpta, nodes, removed, jmodel,
                                   blance_tpu.PlanOptions())
    map_r, warn_r = jenc.decode_assignment(jproblem, assign, jpta, removed)
    assert warn_n == warn_p == warn_r and warn_n
    assert _nbs(map_n) == _nbs(map_p) == _nbs(map_r)
    assert list(map_n) == list(map_r)
    if case in ("passthrough", "other", "empty"):
        kept = [p for p in map_n.values()
                if {"unmodeled", "standby"} & p.nodes_by_state.keys()]
        assert kept and all("ghost-node" in p.nodes_by_state.get(
            "unmodeled", ["ghost-node"]) for p in kept)
    # The same problem decoded against another map object, one of whose
    # sources gained a state to pass through, reads every source again
    # and gives that map's answer.
    first = problem.partitions[0]
    copies = []
    for lib_pta in (pta, jpta):
        copy = {name: p.copy() for name, p in lib_pta.items()}
        copy[first].nodes_by_state["late"] = [nodes[3]]
        copies.append(copy)
    m2, w2 = enc.decode_assignment(problem, assign, copies[0], removed)
    m2_r, w2_r = jenc.decode_assignment(jproblem, assign, copies[1],
                                        removed)
    assert _nbs(m2) == _nbs(m2_r) and w2 == w2_r == warn_n
    assert m2[first].nodes_by_state["late"] == [nodes[3]]
    inputs = _objects(prev) | _objects(pta) | _objects(copies[0])
    for out in (map_n, map_p, m2):
        assert not _objects(out) & inputs


class _Counted(Partition):
    """A Partition that counts the reads of its ``nodes_by_state``."""

    reads: dict = {}

    @property
    def nodes_by_state(self):
        _Counted.reads[self.name] = _Counted.reads.get(self.name, 0) + 1
        return self._nbs

    @nodes_by_state.setter
    def nodes_by_state(self, value):
        self._nbs = value


@pytest.mark.parametrize("path", ["encode+decode", "plan_next_map"])
@pytest.mark.parametrize("case", ["solved", "passthrough"])
def test_walk_reads_each_source_once(native, case, path):
    """With ``prev_map is partitions_to_assign`` and every state solved,
    encode + decode read each source once, alone or inside the matrix
    engine's plan: the walk reads it, and the map build reads none.  A
    row whose source carries a state to pass through is read once more,
    by the build; the counters say so."""
    rng = np.random.default_rng(11)
    nodes = [f"n{i}" for i in range(10)]
    model = {"primary": PartitionModelState(0, 1),
             "replica": PartitionModelState(1, 1)}
    pmap, extra = {}, set()
    for i in range(200):
        a, b = (nodes[int(j)] for j in rng.choice(10, 2, replace=False))
        nbs = {"primary": [a], "replica": [b]}
        if case == "passthrough" and i % 13 == 5:
            nbs["unmodeled"] = [b]
            extra.add(f"{i:03d}")
        pmap[f"{i:03d}"] = _Counted(f"{i:03d}", nbs)
    _Counted.reads = {}
    rec = Recorder()
    with use_recorder(rec):
        if path == "plan_next_map":
            out, _ = blance_tpu_torch.plan_next_map(
                pmap, pmap, nodes, [nodes[1]], [], model, PlanOptions(),
                backend="cuda", device="cpu")
        else:
            problem = enc.encode_problem(pmap, pmap, nodes, [nodes[1]],
                                         model, PlanOptions())
            out, _ = enc.decode_assignment(problem, problem.prev, pmap,
                                           [nodes[1]])
    assert _Counted.reads == {name: 1 + (name in extra) for name in pmap}
    assert "plan.encode.rows_keyed" not in rec.counters
    if extra:
        assert rec.counters["plan.decode.passthrough_rows"] == len(extra)
        assert all(out[name].nodes_by_state["unmodeled"] ==
                   [n for n in pmap[name].nodes_by_state["unmodeled"]
                    if n != nodes[1]] for name in extra)
    else:
        assert "plan.decode.passthrough_rows" not in rec.counters


@pytest.mark.parametrize("rows", [[3, 1], [-1], ["0"]])
def test_build_map_refuses_bad_read_rows(native, rows):
    """build_map's rows to read must be ascending row indices."""
    pta = {n: Partition(n, {}) for n in "abcd"}
    with pytest.raises((ValueError, TypeError)):
        native.build_map(Partition, list(pta), ["s"], [[["n"]] * 4], pta,
                         {"s"}, set(), rows)


NAME_FAMILIES = {
    "padded": [f"{i:07d}" for i in range(5000)],  # the numpy sort's size
    "plain": [str(i) for i in range(300)],
    "zeros": ["7", "007", "07", "0", "00", "000", "70", "0070", "8"],
    "wide": ["9999999999", "10000000000", "99999999999", "100000000000",
             "999999999", "1000000000", "0000000000001",
             "123456789012345678", "012345678901234567"],
    "alpha": ["p000", "p001", "a", "B", "", "+", "-x", "p1", "1a", "a1"],
    "mixed": ["10", "9", "abc", "1a", "0", " 5", "zz", "Z", "05"],
    "signed": ["+5", "1", "2", "3"],
    "long": ["1", "2", "1234567890123456789"],
    "unicode": ["1", "2", "é"],
}


@pytest.mark.parametrize("family", sorted(NAME_FAMILIES))
def test_in_name_order_matches_the_sort(native, family):
    """in_name_order is true exactly when the list is already what
    sorted_by_partition_name returns, or false where it leaves the
    decision to the sort (a signed or 19-digit number, a non-ASCII
    name); the encode then sorts as before."""
    from blance_tpu_torch.core.order import sorted_by_partition_name

    names = NAME_FAMILIES[family]
    decides = family not in ("signed", "long", "unicode")
    ordered = sorted_by_partition_name(names)
    assert native.in_name_order(ordered) is decides
    rng = np.random.default_rng(3)
    for _ in range(20):
        trial = list(ordered)
        i = int(rng.integers(0, len(trial) - 1))
        trial[i], trial[i + 1] = trial[i + 1], trial[i]
        if rng.random() < 0.5:
            trial = [trial[int(j)] for j in rng.permutation(len(trial))]
        want = decides and trial == sorted_by_partition_name(trial)
        assert native.in_name_order(trial) is want
    assert native.in_name_order([]) is True
    assert native.in_name_order(["x"]) is True
