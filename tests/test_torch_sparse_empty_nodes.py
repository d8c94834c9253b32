"""The sparse shortlist and the nodes that come back empty, on the CPU.

The reference's shortlist gives every row the same four least-loaded
nodes.  When a failover's nodes come back empty, the rows that must move
(those that held a copy on a node that left) then reach four of the
empty nodes, and the rest only through the rotated window, which lands
on one in twenty rows: the empty nodes are filled short, about 10 copies
of a mean of 210 at 100 000 x 1 000.  Where more than four are empty,
the port's block is twice as wide and spreads the rows that must move
evenly over the empty nodes (``core/shortlist.py`` ``_empty_node_block``);
with at most four it is the reference's, which these tests hold bitwise,
and every parity fixture of ``tests/test_torch_*.py`` stays the
reference's.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import blance_tpu_torch as bt  # noqa: E402
from blance_tpu.core import shortlist as jshortlist  # noqa: E402
from blance_tpu_torch.core import shortlist as tshortlist  # noqa: E402

G = 4  # the block's width at K = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _arrays(P, N, n_empty, seed=0, rack=8):
    """A primary + replica placement on racks of ``rack`` with 5% of the
    nodes out and ``n_empty`` valid nodes holding nothing."""
    rng = np.random.default_rng(seed)
    nodes = rng.permutation(N)
    out, empty = nodes[:N // 20], nodes[N // 20:N // 20 + n_empty]
    held = np.setdiff1d(np.arange(N), empty)
    prev = np.full((P, 2, 1), -1, np.int32)
    prev[:, 0, 0] = rng.choice(held, P)
    prev[:, 1, 0] = rng.choice(held, P)
    same = prev[:, 0, 0] // rack == prev[:, 1, 0] // rack
    while same.any():  # the replica on another rack
        prev[same, 1, 0] = rng.choice(held, int(same.sum()))
        same = prev[:, 0, 0] // rack == prev[:, 1, 0] // rack
    valid = np.ones(N, bool)
    valid[out] = False
    gids = np.stack([np.arange(N, dtype=np.int32),
                     np.arange(N, dtype=np.int32) // rack,
                     np.zeros(N, np.int32)])
    return (prev, np.ones(P, np.float32), np.ones(N, np.float32), valid,
            gids, np.ones((3, N), bool)), np.sort(empty)


def _shortlists(arrays, k=16):
    prev, pw, nw, valid, gids, gv = arrays
    cons, rules = (1, 1), ((), ((2, 1),))
    want = np.asarray(jshortlist.build_shortlist(
        prev, pw, nw, valid, gids, gv, cons, rules, k))
    got = tshortlist.build_shortlist_core(
        _t(prev), _t(pw), _t(nw), _t(valid), _t(gids), _t(gv), cons, rules,
        k).numpy()
    return got, want


@pytest.mark.parametrize("n_empty", range(G + 1))
def test_at_most_four_empty_nodes_is_the_reference(n_empty):
    arrays, _ = _arrays(512, 64, n_empty, seed=n_empty)
    got, want = _shortlists(arrays)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_empty", [G + 1, 12, 40])
def test_rows_that_must_move_spread_over_the_empty_nodes(n_empty):
    P = 1024
    arrays, empty = _arrays(P, 128, n_empty, seed=n_empty)
    got, want = _shortlists(arrays)
    prev, valid = arrays[0], arrays[3]
    must = (~valid[prev.reshape(P, -1)]).any(axis=1)
    width = min(2 * G, n_empty)
    meets = np.array([(got[must] == e).any(axis=1).sum() for e in empty])
    # The rows that must move, ranked among themselves, take `width`
    # consecutive empty nodes each: every empty node meets the same
    # number of them, give or take a row's block.  (An empty node that
    # is also a rack's representative for the rule meets them all.)
    share = width * int(must.sum()) / n_empty
    assert meets.min() >= share - width
    assert (meets[meets < must.sum()] <= share + width).all()
    # The reference's shared block gives every row the same four and
    # leaves the others to the window.
    ref = np.array([(want[must] == e).any(axis=1).sum() for e in empty])
    assert (ref == must.sum()).sum() == G
    assert np.sort(ref)[:n_empty - G].max() < must.sum() // 4
    assert got.shape == want.shape


def _chain_map(P, N, seed):
    """(map, nodes, options, nodes out at the start): a balanced primary +
    replica map on racks of 25 under one zone, the replica on another
    rack, 5% of the nodes out and empty."""
    rng = np.random.default_rng(seed)
    nodes = [f"n{i:04d}" for i in range(N)]
    out0 = rng.choice(N, N // 20, replace=False)
    live = np.setdiff1d(np.arange(N), out0)
    j = rng.permutation(P) % live.size
    prim, repl = live[j], live[(j + live.size // 2) % live.size]
    pmap = {f"{i:05d}": bt.Partition(f"{i:05d}", {
        "primary": [nodes[a]], "replica": [nodes[b]]})
        for i, (a, b) in enumerate(zip(prim, repl))}
    hier = {n: f"r{i // 25}" for i, n in enumerate(nodes)}
    hier.update({r: "z0" for r in set(hier.values())})
    opts = bt.PlanOptions(sparse=True, node_hierarchy=hier,
                          hierarchy_rules={"replica": [
                              bt.HierarchyRule(2, 1)]})
    return pmap, nodes, opts, [nodes[i] for i in out0], rng


def _loads(pmap, nodes):
    count = dict.fromkeys(nodes, 0)
    for p in pmap.values():
        for ns in p.nodes_by_state.values():
            for n in ns:
                count[n] += 1
    return count


@pytest.mark.parametrize("block", ["rotated", "shared"])
def test_failover_chain_fills_the_returning_nodes(block, monkeypatch):
    """Three chained failovers of 5% of 128 nodes on the sparse engine:
    the nodes that come back empty end within a fifth of the live mean;
    no copy on a node that is out, no replica on its primary's rack.
    With the reference's shared block in the port's place, the same chain
    leaves a returning node under half the mean: the check sees the fault
    the block mends."""
    if block == "shared":
        monkeypatch.setattr(
            tshortlist, "_empty_node_block",
            lambda order, prev, valid, cons, m, g:
            order[:G].expand(prev.shape[0], G))
    P, N = 2048, 128
    pmap, nodes, opts, back, rng = _chain_map(P, N, seed=7)
    model = bt.model(primary=(0, 1), replica=(1, 1))
    worst = 1.0
    for _ in range(3):
        live = [n for n in nodes if n not in back]
        out = sorted(rng.choice(live, N // 20, replace=False).tolist())
        nxt, warnings = bt.plan_next_map(pmap, pmap, nodes, out, back,
                                         model, opts, backend="cuda",
                                         device="cpu")
        assert not any(warnings.values())
        counts = _loads(nxt, nodes)
        assert all(counts[n] == 0 for n in out)
        mean = np.mean([counts[n] for n in nodes if n not in out])
        worst = min(worst, min(counts[n] for n in back) / mean)
        for p in nxt.values():
            (a,), (b,) = p.nodes_by_state["primary"], \
                p.nodes_by_state["replica"]
            assert nodes.index(a) // 25 != nodes.index(b) // 25
        if block == "rotated":
            assert worst >= 0.8, (worst, mean)
        pmap, back = nxt, out
    if block == "shared":
        assert worst < 0.5
