"""The reference on hand-made maps: the moves_per_plan counter, the
violations, the move lists and the plain planner."""

import numpy as np

import _bench_path  # noqa: F401
import reference

STATES = ("primary", "replica")
COLS = (0, 1)  # one copy of each state
APART = ((0, 1),)  # the replica on another rack than the primary


def test_placed_counts_new_copies_only():
    prev = np.array([[0, 1], [2, 3], [4, 5]], np.int32)
    nxt = np.array([[0, 1], [3, 6], [7, 5]], np.int32)
    # (1, primary, 3) is a promotion: a copy placed as primary anew.
    assert reference.placed(prev, nxt, COLS) == 3
    assert reference.placed(prev, prev, COLS) == 0
    assert reference.forced(prev, np.array([2, 4])) == 2


def test_violations_each_kind():
    racks = np.array([0, 0, 1, 1, 2, 2])
    live = np.array([1, 1, 1, 1, 1, 0], bool)
    good = np.array([[0, 2], [3, 1]], np.int32)
    assert reference.violations(good, live, racks, APART) == 0
    assert reference.violations(np.array([[0, -1]]), live, racks, APART) == 1
    assert reference.violations(np.array([[0, 5]]), live, racks, APART) == 1
    assert reference.violations(np.array([[2, 2]]), live, racks) == 1
    assert reference.violations(np.array([[0, 1]]), live, racks, APART) == 1
    assert reference.violations(np.array([[0, 1]]), live, racks) == 0


def test_partition_moves_orders():
    beg = {"primary": ["a"], "replica": ["b"]}
    assert reference.partition_moves(STATES, beg, beg) == []
    # The primary left: the replica rises, the old primary goes at the
    # primary's turn, a new replica arrives at the replica's.
    end = {"primary": ["b"], "replica": ["c"]}
    assert reference.partition_moves(STATES, beg, end) == [
        ("b", "primary", "promote"), ("a", "", "del"),
        ("c", "replica", "add")]
    # Swapped roles, then a relocation of both copies.
    assert reference.partition_moves(
        STATES, beg, {"primary": ["b"], "replica": ["a"]}) == [
        ("b", "primary", "promote"), ("a", "replica", "demote")]
    assert reference.partition_moves(
        STATES, beg, {"primary": ["c"], "replica": ["d"]}) == [
        ("c", "primary", "add"), ("a", "", "del"),
        ("d", "replica", "add"), ("b", "", "del")]


def test_moves_mismatch_finds_a_changed_step():
    # Nodes a, b, c are ids 0, 1, 2; ops (add, del, promote, demote).
    prev = np.array([[0, 1], [1, 2]], np.int32)
    nxt = np.array([[1, 2], [1, 2]], np.int32)
    right = np.full((2, 4, 3), -1, np.int32)
    right[0, :3] = [(1, 0, 2), (0, -1, 1), (2, 1, 0)]
    assert reference.moves_mismatch(STATES, COLS, prev, nxt, right) == 0
    short = right.copy()
    short[0, 2] = -1
    assert reference.moves_mismatch(STATES, COLS, prev, nxt, short) == 1
    extra = right.copy()
    extra[1, 0] = (0, 1, 0)  # a step for a partition that did not change
    assert reference.moves_mismatch(STATES, COLS, prev, nxt, extra) == 1


def test_plain_plan_keeps_the_guarantees():
    rng = np.random.default_rng(3)
    n, p = 60, 600
    racks = np.arange(n) // 5
    prim = rng.integers(0, n, p)
    repl = (prim + 5 + rng.integers(0, n - 10, p)) % n
    prev = np.stack([prim, repl], 1).astype(np.int32)
    out = np.arange(0, 60, 10)
    nxt = reference.plain_plan(prev, out, racks, COLS, APART)
    live = np.ones(n, bool)
    live[out] = False
    assert reference.violations(nxt, live, racks, APART) == 0
    kept = ~np.isin(prev, out).any(axis=1)
    assert np.array_equal(nxt[kept], prev[kept])  # sticky


def test_states_of_several_copies():
    # primary x2, replica, read_only: columns (0, 0, 1, 2).
    states = ("primary", "replica", "read_only")
    cols = (0, 0, 1, 2)
    prev = np.array([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
    # Row 0: the two primaries swap columns (no copy placed), the read
    # copy moves; row 1: a replica rises to primary.
    nxt = np.array([[1, 0, 2, 8], [4, 6, 9, 7]], np.int32)
    assert reference.placed(prev, nxt, cols) == 3
    live = np.ones(10, bool)
    assert reference.violations(nxt, live, np.arange(10)) == 0
    assert reference.violations(nxt[:, [0, 0, 2, 3]], live,
                                np.arange(10)) == 2
    assert reference.state_lists(states, cols, nxt[1]) == {
        "primary": [4, 6], "replica": [9], "read_only": [7]}
    racks = np.arange(12) // 4
    pr = np.array([[0, 4, 8, 1]] * 30, np.int32)
    got = reference.plain_plan(pr, np.array([0]), racks, cols)
    live = np.ones(12, bool)
    live[0] = False
    assert reference.violations(got, live, racks) == 0
    # Each row: the replica rises to primary, the read copy to replica,
    # and a new read copy is placed: three placed copies a row.
    assert reference.placed(pr, got, cols) == 90
    assert (got[:, :3] == [8, 4, 1]).all()


def test_balance_cv():
    live = np.ones(4, bool)
    even = np.array([[0, 1], [2, 3]], np.int32)
    assert reference.balance_cv(even, live) == 0.0
    piled = np.array([[0, 1], [0, 2], [0, 1], [2, 1]], np.int32)
    # Loads 3, 3, 2, 0 on a mean of 2: RMS of (0.5, 0.5, 0, -1).
    assert np.isclose(reference.balance_cv(piled, live), np.sqrt(1.5 / 4))
    live[3] = False  # a node out of the request counts for nothing
    # Loads 3, 3, 2 on a mean of 8 / 3: RMS of (1 / 8, 1 / 8, -2 / 8).
    assert np.isclose(reference.balance_cv(piled, live), np.sqrt(6 / 192))
