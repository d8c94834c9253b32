"""The plain reference: what a correct plan is, in NumPy, and a plain planner.

This file imports NumPy alone: nothing of the program, nothing of JAX.
A plan cannot be recomputed bit for bit by a second algorithm (many maps
are equally good), so the reference judges each plan by the guarantees
the configuration states and by the quality the planner exists for:

- ``violations`` (exact, limit 0): a partition missing or unknown, a
  state without exactly its copies, a copy on a node that is not live in
  that request, two copies of a partition on one node, a replica on its
  primary's rack where the rack rule holds, a warning for a partition;
- ``moves_mismatch`` (exact, limit 0): partitions whose returned move list
  differs from the moves this file derives from the request's own input
  and output maps (the availability-first order of blance's moves.go);
- ``balance_cv``: the RMS distance of each live node's copies from the
  live nodes' mean, as a share of that mean (balance over every live
  node: a plan that piles copies on some nodes and starves others, new
  or old, reads high);
- ``churn``: copies placed on a (partition, state, node) the input map did
  not hold, over the copies that had to leave the departing nodes
  (stickiness).

Maps are [P, C] int32 arrays of node ids, -1 for an empty slot: column c
holds a copy of state ``cols[c]`` (an index into the states, superior
first; a state of R copies has R adjacent columns, in no order among
themselves).  ``apart`` lists the column pairs a placement rule keeps on
different racks.  ``plain_plan`` is a straightforward planner over the
same arrays: the control that stands in the program's place.
"""

from __future__ import annotations

import numpy as np

OPS = ("add", "del", "promote", "demote")


def placed(prev: np.ndarray, nxt: np.ndarray, cols) -> int:
    """Copies on a (partition, state, node) that ``prev`` did not hold."""
    cols = np.asarray(cols)
    new = 0
    for c in range(nxt.shape[1]):
        same = prev[:, cols == cols[c]]
        held = (same == nxt[:, c:c + 1]).any(axis=1)
        new += int(((nxt[:, c] >= 0) & ~held).sum())
    return new


def forced(prev: np.ndarray, out: np.ndarray) -> int:
    """Copies of ``prev`` on the nodes ``out`` takes away."""
    return int(np.isin(prev, out).sum())


def load(assign: np.ndarray, n_nodes: int) -> np.ndarray:
    held = assign[assign >= 0]
    return np.bincount(held, minlength=n_nodes)


def violations(nxt: np.ndarray, live: np.ndarray, racks: np.ndarray,
               apart=()) -> int:
    """Guarantee breaks in one plan ([P, C] ids; ``live`` a node mask)."""
    n = live.size
    bad = int((nxt < 0).sum() + (nxt >= n).sum())
    ids = np.clip(nxt, 0, n - 1)
    ok = (nxt >= 0) & (nxt < n)
    bad += int((ok & ~live[ids]).sum())
    s = nxt.shape[1]
    for a in range(s):
        for b in range(a + 1, s):
            bad += int((ok[:, a] & ok[:, b] & (nxt[:, a] == nxt[:, b])).sum())
    r = racks[ids]
    for a, b in apart:
        bad += int((ok[:, a] & ok[:, b] & (r[:, a] == r[:, b])).sum())
    return bad


def balance_cv(nxt: np.ndarray, live: np.ndarray) -> float:
    """RMS over the live nodes of (copies - mean) / mean."""
    per_node = load(nxt, live.size)[live].astype(np.float64)
    mean = per_node.mean()
    return float(np.sqrt((((per_node - mean) / mean) ** 2).mean()))


def partition_moves(states, beg: dict, end: dict) -> list:
    """Ordered (node, state, op) steps from ``beg`` to ``end`` for one
    partition, each a dict state -> node list, ``states`` superior first.

    Availability first: for each state from the superior down, the nodes
    that rise into it (promote), fall into it (demote), arrive in it
    (add), then the nodes of that state that leave the partition (del,
    with the state ""); a node takes one step at most."""
    where_beg = {nd: i for i, s in enumerate(states) for nd in beg.get(s, ())}
    where_end = {nd: i for i, s in enumerate(states) for nd in end.get(s, ())}
    steps, seen = [], set()

    def emit(nodes, state, op):
        for nd in nodes:
            if nd not in seen:
                seen.add(nd)
                steps.append((nd, state, op))

    for i, s in enumerate(states):
        into = end.get(s, ())
        emit([nd for nd in into if where_beg.get(nd, -1) > i], s, "promote")
        emit([nd for nd in into if -1 < where_beg.get(nd, -1) < i], s,
             "demote")
        emit([nd for nd in into if nd not in where_beg], s, "add")
        emit([nd for nd in beg.get(s, ()) if nd not in where_end], "",
             "del")
    return steps


def step_codes(states, steps: list) -> list:
    """Steps as (node id, state index or -1 for "", op index in OPS)."""
    return [(nd, states.index(s) if s else -1, OPS.index(op))
            for nd, s, op in steps]


def state_lists(states, cols, row) -> dict:
    """One map row as state -> node ids, in column order."""
    out: dict = {}
    for c, node in enumerate(row.tolist()):
        if node >= 0:
            out.setdefault(states[cols[c]], []).append(int(node))
    return out


def moves_mismatch(states, cols, prev: np.ndarray, nxt: np.ndarray,
                   got: np.ndarray) -> int:
    """Partitions whose ``got`` steps ([P, L, 3] int32: node id, state
    index or -1 for a del, op index in OPS; rows padded with -1) differ
    from :func:`partition_moves` of the input and output rows."""
    changed = (prev != nxt).any(axis=1)
    bad = int((got[~changed] != -1).any(axis=(1, 2)).sum())
    for pi in np.flatnonzero(changed):
        beg = state_lists(states, cols, prev[pi])
        end = state_lists(states, cols, nxt[pi])
        want = step_codes(states, partition_moves(states, beg, end))
        row = got[pi]
        n = len(want)
        if n > row.shape[0] or \
                [tuple(x) for x in row[:n].tolist()] != want or \
                (row[n:] != -1).any():
            bad += 1
    return bad


def map_rows(pmap: dict, part_index: dict, node_index: dict, states,
             cols) -> tuple:
    """A returned PartitionMap (name -> object with ``nodes_by_state``)
    as [P, C] node ids, and the entries that cannot be read as each
    state's copies on known nodes of a known partition."""
    rows = np.full((len(part_index), len(cols)), -1, np.int32)
    first = {si: list(cols).index(si) for si in set(cols)}
    copies = {si: list(cols).count(si) for si in set(cols)}
    bad = 0
    for name, part in pmap.items():
        pi = part_index.get(name)
        if pi is None:
            bad += 1
            continue
        nbs = part.nodes_by_state
        bad += sum(1 for s, ns in nbs.items() if ns and s not in states)
        for si, s in enumerate(states):
            ns = nbs.get(s) or []
            bad += max(len(ns) - copies[si], 0)
            for r, name_ in enumerate(ns[:copies[si]]):
                node = node_index.get(name_)
                if node is None:
                    bad += 1
                else:
                    rows[pi, first[si] + r] = node
    return rows, bad


def judge(prev: np.ndarray, nxt: np.ndarray, out: np.ndarray,
          racks: np.ndarray, cols, apart=()) -> dict:
    """The numbers of one plan that took the nodes ``out`` away: its
    violations, balance, churn and the copies it placed."""
    live = np.ones(racks.size, bool)
    live[out] = False
    need = max(forced(prev, out), 1)
    new = placed(prev, nxt, cols)
    return {"violations": violations(nxt, live, racks, apart),
            "balance_cv": balance_cv(nxt, live),
            "churn": new / need,
            "placed": new}


def plain_plan(prev: np.ndarray, out: np.ndarray, racks: np.ndarray,
               cols, apart=(), skip: np.ndarray = None,
               fresh: bool = False) -> np.ndarray:
    """A straightforward planner: copies on live nodes stay, a copy of a
    lower state rises into a superior state that lost its copy, and each
    empty slot goes to the least loaded live node that keeps the
    partition's copies apart (and on another rack than the copies its
    column is kept ``apart`` from).

    The two ways it breaks a guarantee, for the control: ``skip`` (node
    ids) are never chosen, so the nodes coming back stay empty (balance);
    ``fresh`` ignores ``prev`` and lays every copy out anew (stickiness)."""
    n = racks.size
    live = np.ones(n, bool)
    live[out] = False
    p, c = prev.shape
    if fresh:
        ids = np.flatnonzero(live)
        j = np.arange(p) % ids.size
        step = ids.size // c
        return np.stack([ids[(j + k * step) % ids.size] for k in range(c)],
                        axis=1).astype(np.int32)
    nxt = prev.copy()
    nxt[np.isin(nxt, out)] = -1
    # Promote the highest surviving copy into an emptied superior state.
    for hi in range(c):
        for lo in range(hi + 1, c):
            if cols[lo] == cols[hi]:
                continue
            up = (nxt[:, hi] < 0) & (nxt[:, lo] >= 0)
            nxt[up, hi] = nxt[up, lo]
            nxt[up, lo] = -1
    partners = {k: [b if a == k else a for a, b in apart if k in (a, b)]
                for k in range(c)}
    cand = live.copy()
    if skip is not None:
        cand[skip] = False
    used = load(nxt, n).astype(np.int64)
    big = np.iinfo(np.int64).max
    for pi, ci in zip(*np.nonzero(nxt < 0)):
        row = nxt[pi]
        ok = cand.copy()
        ok[row[row >= 0]] = False
        near = row[partners[ci]]
        near = near[near >= 0]
        if near.size:
            ok &= ~np.isin(racks, racks[near])
        node = int(np.argmin(np.where(ok, used, big)))
        nxt[pi, ci] = node
        used[node] += 1
    return nxt
