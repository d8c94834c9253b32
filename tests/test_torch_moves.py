"""The port's move calculus and pack helpers against the JAX package, on
the CPU.

Same inputs through both packages, compared exactly: the batched diff
bitwise on all three outputs, calc_all_moves op list for op list (and
against the port's own host oracle calc_partition_moves), and the integer
cores of encode and decode bitwise.  The port runs with ``device="cpu"``.
"""

import random

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import blance_tpu  # noqa: E402
import blance_tpu_torch as bt  # noqa: E402
from blance_tpu.core import encode as jencode  # noqa: E402
from blance_tpu.moves import batch as jbatch  # noqa: E402
from blance_tpu_torch.core import encode as tencode  # noqa: E402
from blance_tpu_torch.core.order import sort_state_names  # noqa: E402
from blance_tpu_torch.moves import batch as tbatch  # noqa: E402
from blance_tpu_torch.obs import Recorder, use_recorder  # noqa: E402

STATES = dict(primary=(0, 1), replica=(1, 2))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ops(moves):
    """Op lists of either package as comparable tuples."""
    return {name: [(m.node, m.state, m.op) for m in ms]
            for name, ms in moves.items()}


def _maps(lib, beg_nbs, end_nbs):
    return ({k: lib.Partition(k, {s: list(ns) for s, ns in v.items()})
             for k, v in beg_nbs.items()},
            {k: lib.Partition(k, {s: list(ns) for s, ns in v.items()})
             for k, v in end_nbs.items()})


# --- diff_assignments, bitwise -----------------------------------------------------


def _diff_arrays(seed, p, s, r, n=7):
    """Random [P, S, R] node ids with -1 holes; the first rows script one
    promote, demote, add and del each (where S allows)."""
    rng = np.random.default_rng(seed)
    beg = rng.integers(-1, n, (p, s, r)).astype(np.int32)
    end = rng.integers(-1, n, (p, s, r)).astype(np.int32)
    beg[:4] = -1
    end[:4] = -1
    end[0, 0, 0] = 5  # add
    beg[1, 0, 0] = 6  # del
    if s > 1:
        beg[2, 1, 0], end[2, 0, 0] = 3, 3  # promote
        beg[3, 0, 0], end[3, s - 1, 0] = 4, 4  # demote
    return beg, end


@pytest.mark.parametrize("favor_min_nodes", [False, True])
@pytest.mark.parametrize("r", [1, 2, 3])
@pytest.mark.parametrize("s", [1, 2, 3])
def test_diff_assignments_matches_jax(s, r, favor_min_nodes):
    beg, end = _diff_arrays(10 * s + r, 400, s, r)
    want = jbatch.diff_assignments(jnp.asarray(beg), jnp.asarray(end),
                                   favor_min_nodes=favor_min_nodes)
    got = tbatch.diff_assignments(torch.from_numpy(beg),
                                  torch.from_numpy(end),
                                  favor_min_nodes=favor_min_nodes)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.int32 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
    ops = got[2].numpy()
    assert {0, 1} <= set(np.unique(ops[:2]).tolist())
    if s > 1:
        assert {2, 3} <= set(np.unique(ops[2:4]).tolist())


# --- calc_all_moves -----------------------------------------------------------


def _random_nbs(seed, n_partitions, n_nodes):
    """The shape of tests/test_moves_batch.py's random maps: up to five
    distinct nodes per partition, at most one primary."""
    rng = random.Random(seed)
    nodes = [f"n{i}" for i in range(n_nodes)]

    def one():
        pool = rng.sample(nodes, rng.randint(0, 5))
        k = rng.randint(0, min(1, len(pool)))
        return {"primary": pool[:k], "replica": pool[k:]}

    return ({str(i): one() for i in range(n_partitions)},
            {str(i): one() for i in range(n_partitions)})


@pytest.mark.parametrize("favor_min_nodes", [False, True])
@pytest.mark.parametrize("seed,n_partitions,n_nodes",
                         [(0, 40, 8), (1, 40, 8), (2, 300, 12),
                          (3, 2000, 64)])
def test_calc_all_moves_matches_reference(seed, n_partitions, n_nodes,
                                          favor_min_nodes):
    beg_nbs, end_nbs = _random_nbs(seed, n_partitions, n_nodes)
    want = jbatch.calc_all_moves(*_maps(blance_tpu, beg_nbs, end_nbs),
                                 blance_tpu.model(**STATES), favor_min_nodes)
    tbeg, tend = _maps(bt, beg_nbs, end_nbs)
    got = bt.calc_all_moves(tbeg, tend, bt.model(**STATES), favor_min_nodes,
                            device="cpu")
    assert list(got) == list(want)  # planner order
    assert _ops(got) == _ops(want)
    states = sort_state_names(bt.model(**STATES))
    for name in tbeg:
        host = bt.calc_partition_moves(states, tbeg[name].nodes_by_state,
                                       tend[name].nodes_by_state,
                                       favor_min_nodes)
        assert got[name] == host, name


@pytest.mark.parametrize("favor_min_nodes", [False, True])
@pytest.mark.parametrize("beg_nbs,end_nbs", [
    ({}, {"primary": ["a"], "replica": ["a"]}),
    ({"primary": ["a"]}, {"primary": ["a"], "replica": ["a"]}),
    ({"primary": ["a"], "replica": ["a"]}, {"replica": ["a"]}),
])
def test_calc_all_moves_irregular_matches_reference(beg_nbs, end_nbs,
                                                    favor_min_nodes):
    """Multi-state nodes take the host diff in both packages."""
    want = jbatch.calc_all_moves(
        *_maps(blance_tpu, {"x": beg_nbs}, {"x": end_nbs}),
        blance_tpu.model(**STATES), favor_min_nodes)
    rec = Recorder()
    with use_recorder(rec):
        got = bt.calc_all_moves(*_maps(bt, {"x": beg_nbs}, {"x": end_nbs}),
                                bt.model(**STATES), favor_min_nodes,
                                device="cpu")
    assert _ops(got) == _ops(want)
    assert rec.counters["moves.irregular_partitions"] == 1


def test_calc_all_moves_edges():
    """Empty and no-op maps, mismatched keys, planner order, and the
    counters on the port's own recorder."""
    model = bt.model(**STATES)
    same = {"x": bt.Partition("x", {"primary": ["a"]})}
    assert bt.calc_all_moves(same, same, model, device="cpu") == {"x": []}
    assert bt.calc_all_moves({}, {}, model, device="cpu") == {}
    two = {"x": bt.Partition("x", {"primary": ["a"]}),
           "y": bt.Partition("y", {"primary": ["b"]})}
    with pytest.raises(KeyError):
        bt.calc_all_moves(two, same, model, device="cpu")
    beg = {n: bt.Partition(n, {"primary": ["a"]}) for n in ("10", "2")}
    end = {n: bt.Partition(n, {"primary": ["b"]}) for n in ("10", "2")}
    ref_rec = blance_tpu.obs.get_recorder()
    ref_ops = ref_rec.counters.get("moves.total_ops", 0)
    rec = Recorder()
    with use_recorder(rec):
        got = bt.calc_all_moves(beg, end, model, device="cpu")
    assert list(got) == ["2", "10"]
    assert rec.counters["moves.total_ops"] == 4
    assert rec.counters["moves.diff_partitions"] == 2
    assert {"moves.calc_all_moves", "moves.encode", "moves.device_diff",
            "moves.materialize"} <= set(rec.summary()["spans"])
    # The port counts on its own recorder, never on the reference's.
    assert ref_rec.counters.get("moves.total_ops", 0) == ref_ops


def test_calc_all_moves_asks_for_the_card(monkeypatch):
    """Without ``device=`` the diff targets the card; with no card it
    raises rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    same = {"x": bt.Partition("x", {"primary": ["a"]})}
    with pytest.raises(RuntimeError, match="is_available"):
        bt.calc_all_moves(same, same, bt.model(**STATES))


# --- pack helpers ---------------------------------------------------------------


@pytest.mark.parametrize("shape", [(50, 2, 3), (7, 1, 1), (200, 3, 4)])
def test_pack_assignment_core_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    assign = rng.integers(-1, 9, shape).astype(np.int32)
    assign[rng.random(shape) < 0.3] = -1
    want = jencode.pack_assignment_core(jnp.asarray(assign))
    got = tencode.pack_assignment_core(torch.from_numpy(assign))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    via_entry = tencode.pack_assignment(assign, device="cpu")
    for g, w in zip(via_entry, got):
        assert torch.equal(g, w)


def test_prev_from_entries_core_matches_jax():
    """Distinct in-range slots, plus entries that drop: negative
    coordinates and flat indices past P*S*R."""
    p, s, r = 40, 2, 3
    rng = np.random.default_rng(5)
    flat = rng.choice(p * s * r, 150, replace=False)
    pi, si, ri = (flat // (s * r), flat // r % s, flat % r)
    node = rng.integers(0, 30, flat.size)
    drop_pi = np.array([-1, 3, 5, p, p + 2, 0])
    drop_si = np.array([0, -1, 1, 0, 1, 0])
    drop_ri = np.array([1, 0, -1, 0, 2, 0])
    cols = [np.concatenate([a, b]).astype(np.int32) for a, b in
            ((pi, drop_pi), (si, drop_si), (ri, drop_ri),
             (node, np.full(6, 99)))]
    # The (0, 0, 0) row above is in range: keep it out of the random set.
    keep = ~((cols[0] == 0) & (cols[1] == 0) & (cols[2] == 0))
    keep[-1] = True
    cols = [c[keep] for c in cols]
    want = np.asarray(jencode.prev_from_entries_core(
        *[jnp.asarray(c) for c in cols], p, s, r))
    got = tencode.prev_from_entries_core(
        *[torch.from_numpy(c) for c in cols], p, s, r)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 99).sum() == 1  # only the in-range pad row landed
    np.testing.assert_array_equal(
        tencode.prev_from_entries(*cols, p, s, r, device="cpu").numpy(),
        want)


def test_pack_slot_rows_matches_reference():
    rng = np.random.default_rng(8)
    rows = rng.integers(-1, 6, (30, 3, 4)).astype(np.int32)
    for g, w in zip(tencode.pack_slot_rows(rows),
                    jencode.pack_slot_rows(rows)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    packed, counts = tencode.pack_assignment_core(torch.from_numpy(rows))
    np.testing.assert_array_equal(packed.numpy(),
                                  tencode.pack_slot_rows(rows)[0])
