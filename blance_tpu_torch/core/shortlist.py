"""Per-partition top-K candidate shortlists for the sparse solver.

Port of blance_tpu/core/shortlist.py, on tensors.  See the reference
module's docstring for the derivation; in short, each row's candidates
are, in priority order:

1. the nodes the partition holds now (prev[P, S, R]);
2. per nesting hierarchy rule, the least-loaded representative of each
   exclude group ("rack") inside the previous primary's include group
   ("zone");
3. a few globally least-loaded valid nodes shared by every row, plus a
   per-row rotated window over the valid-node ranking.  Where more of
   the valid nodes are empty than that block is wide, a wider block
   spreads the rows that must move over the empty nodes instead
   (``_empty_node_block``).  That is the one departure from the
   reference, whose shared block leaves the nodes a failover brings back
   at about a twentieth of their share; with no more empty nodes than
   the block's width the shortlist is the reference's bit for bit.

Rows are deduplicated (keep-first), truncated to K and returned sorted
ascending with -1 padding at the tail; a saturating K >= N is the
identity permutation on every row.

Bit-equality with the jitted reference rests on three spellings:
``.at[...].add/min/set(mode="drop")`` scatters into one extra bucket
that is sliced off; stable sorts where JAX's are stable; and the rotated
window's ``arange(P) * 40503`` product kept in int32, so that it wraps
in two's complement like the reference's (from row 53,021 on) before
the Python-style ``%``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..obs import counts_recorder

__all__ = ["auto_shortlist_k", "build_shortlist_core", "shortlist_rules_nest"]


def shortlist_rules_nest(rules: tuple) -> bool:
    """True when every rule's exclude level is strictly finer than its
    include level — the tree shape the sparse solver's group-counting
    tier floor requires."""
    return all(exc < inc for state_rules in rules
               for (inc, exc) in state_rules)


def auto_shortlist_k(n: int, constraints: tuple, rules: tuple) -> int:
    """Default K: two columns per slot, two more per ruled slot and a
    margin of 8 attractors, at least 16, rounded up to a multiple of 8
    and clamped to N."""
    slots = sum(max(int(c), 0) for c in constraints)
    ruled = sum(max(int(c), 0) for c, state_rules in zip(constraints, rules)
                if state_rules)
    k = 2 * slots + 2 * ruled + 8
    k = max(16, k)
    k = -(-k // 8) * 8
    return min(max(n, 1), k)


def _seed_load(prev: torch.Tensor, pweights: torch.Tensor,
               nweights: torch.Tensor, n: int) -> torch.Tensor:
    """[N] weight-normalized seed fill from the previous placement."""
    ids = prev.reshape(prev.shape[0], -1)
    flat = torch.where(ids >= 0, ids, n).reshape(-1).long()
    w = pweights[:, None].expand(ids.shape).reshape(-1)
    fill = torch.zeros(n + 1, dtype=torch.float32, device=prev.device)
    fill.index_add_(0, flat, w.to(torch.float32))
    w_div = torch.where(nweights > 0, nweights, 1.0)
    return fill[:n] / w_div


def _group_reps(load_rank: torch.Tensor, gids_lv: torch.Tensor,
                gid_valid_lv: torch.Tensor, valid: torch.Tensor,
                n: int) -> torch.Tensor:
    """[N] exclude-group -> representative node id (-1 = empty group):
    the valid node with the lowest load rank in each group."""
    dev = load_rank.device
    ok = valid & gid_valid_lv & (gids_lv >= 0)
    g = torch.where(ok, gids_lv, n).long()
    rank = torch.where(ok, load_rank, n).to(torch.int32)
    best = torch.full((n + 1,), n, dtype=torch.int32, device=dev)
    best.scatter_reduce_(0, g, rank, reduce="amin", include_self=True)
    best = best[:n]
    # Ranks of valid members are a permutation, so each is written once;
    # slot n (every non-member) is never read below.
    node_of_rank = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    node_of_rank[rank.clamp(0, n).long()] = torch.arange(
        n, dtype=torch.int32, device=dev)
    return torch.where(best < n, node_of_rank[best.clamp(0, n).long()], -1)


def _rep_table(rep: torch.Tensor, load_rank: torch.Tensor,
               gids_inc: torch.Tensor, gid_valid_inc: torch.Tensor,
               m: int, n: int) -> torch.Tensor:
    """[N, m] include-group -> its ``m`` least-loaded exclude-group
    representatives (-1 padded)."""
    dev = rep.device
    has = rep >= 0
    rep_c = rep.clamp(0, n - 1).long()
    parent = torch.where(has & gid_valid_inc[rep_c], gids_inc[rep_c], n)
    rank = torch.where(has, load_rank[rep_c], n).to(torch.int32)
    perm1 = torch.sort(rank, stable=True).indices
    perm = perm1[torch.sort(parent[perm1], stable=True).indices]
    parent_s = parent[perm]
    rep_s = rep[perm]
    seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           parent_s[1:] != parent_s[:-1]])
    pos_all = torch.arange(n, dtype=torch.int32, device=dev)
    seg_base = torch.cummax(torch.where(seg_start, pos_all, -1), dim=0).values
    segpos = pos_all - seg_base
    ok = (parent_s < n) & (rep_s >= 0) & (segpos < m)
    flat_idx = torch.where(ok, parent_s * m + segpos, n * m).long()
    table = torch.full((n * m + 1,), -1, dtype=torch.int32, device=dev)
    table[flat_idx] = rep_s.to(torch.int32)  # one writer per kept index
    return table[:n * m].reshape(n, m)


def _dedup_truncate_sort(cand: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """[P, C] priority-ordered candidate ids -> [P, k] deduplicated,
    ascending, -1-padded shortlist (keep-first dedup)."""
    c_width = cand.shape[1]
    ids = torch.where(cand >= 0, cand, n)
    ids_s, ord1 = torch.sort(ids, dim=1, stable=True)
    dup = torch.cat(
        [torch.zeros((ids.shape[0], 1), dtype=torch.bool, device=ids.device),
         (ids_s[:, 1:] == ids_s[:, :-1]) & (ids_s[:, 1:] < n)], dim=1)
    key = torch.where(dup | (ids_s >= n), c_width, ord1)
    key_s, ord2 = torch.sort(key, dim=1, stable=True)
    kept = ids_s.gather(1, ord2)[:, :k]
    kept = torch.where(key_s[:, :k] >= c_width, n, kept)
    out = torch.sort(kept, dim=1).values
    return torch.where(out >= n, -1, out).to(torch.int32)


def build_shortlist_core(prev, pweights, nweights, valid, gids, gid_valid,
                         constraints: tuple, rules: tuple, k: int,
                         reps: Optional[int] = None) -> torch.Tensor:
    """[P, S, R] placement -> [P, K'] int32 shortlist (K' = min(k, N)) on
    the device of ``prev``.  Saturating K >= N returns the identity
    permutation broadcast to every row."""
    p = prev.shape[0]
    n = nweights.shape[0]
    dev = prev.device
    if n == 0 or p == 0:
        return torch.zeros((p, 0), dtype=torch.int32, device=dev)
    if k >= n:
        return torch.arange(n, dtype=torch.int32, device=dev) \
            .expand(p, n).contiguous()
    k = max(int(k), 1)

    load = _seed_load(prev, pweights, nweights, n)
    # Global least-loaded ranking; ties break by node id (stable sort).
    order = torch.sort(torch.where(valid, load, float("inf")),
                       stable=True).indices.to(torch.int32)
    load_rank = torch.zeros(n, dtype=torch.int32, device=dev)
    load_rank[order.long()] = torch.arange(n, dtype=torch.int32, device=dev)

    cols = [prev.reshape(p, -1)]  # sticky candidates, highest priority

    if reps is None:
        reps = max([1] + [int(c) + 1 for c, state_rules
                          in zip(constraints, rules) if state_rules])
        reps = min(reps, max(1, k // 2))
    anchor = prev[:, 0, 0]
    anchor_c = anchor.clamp(0, n - 1).long()
    seen: set = set()
    for state_rules in rules:
        for (inc, exc) in state_rules:
            if (inc, exc) in seen or not (exc < inc):
                continue
            seen.add((inc, exc))
            rep = _group_reps(load_rank, gids[exc], gid_valid[exc], valid, n)
            table = _rep_table(rep, load_rank, gids[inc], gid_valid[inc],
                               reps, n)
            g = torch.where((anchor >= 0) & gid_valid[inc][anchor_c],
                            gids[inc][anchor_c], -1)
            row_reps = torch.where(g[:, None] >= 0,
                                   table[g.clamp(0, n - 1).long()], -1)
            cols.append(row_reps)

    n_fixed = sum(c.shape[1] for c in cols)
    k_glob = max(k - min(n_fixed, k - 1), 1)
    # A few true least-loaded nodes, then a per-row rotated window over
    # the valid-node ranking (coverage for rows with no sticky node or
    # anchor).  One host read (plan.solve.host_syncs, as plan/tensor.py
    # counts): the valid nodes, and those that hold nothing while the
    # cluster holds copies.
    counts_recorder().count("plan.solve.host_syncs")
    empty = valid & (load == 0) & (load.sum() > 0)
    n_valid, n_empty = torch.stack([valid.sum(), empty.sum()]).tolist()
    n_valid = max(n_valid, 1)
    g_top = min(4, k_glob)
    if n_empty > g_top:
        block = _empty_node_block(
            order, prev, valid, constraints, n_empty,
            max(g_top, min(2 * g_top, k_glob - 1, n_empty)))
    else:
        block = order[:g_top].expand(p, g_top)
    cols.append(block)
    k_cov = k_glob - block.shape[1]
    if k_cov > 0:
        # int32 on purpose: the product wraps from row 53,021 on, as the
        # reference's does; torch.remainder is Python's (floor) modulo.
        rowpos = torch.remainder(
            torch.arange(p, dtype=torch.int32, device=dev) * 40503, n_valid)
        offs = rowpos[:, None] + torch.arange(k_cov, dtype=torch.int32,
                                              device=dev)[None, :]
        cols.append(order[torch.remainder(offs, n_valid).long()])

    cand = torch.cat([c.to(torch.int32) for c in cols], dim=1)
    return _dedup_truncate_sort(cand, k, n)


def _empty_node_block(order: torch.Tensor, prev: torch.Tensor,
                      valid: torch.Tensor, constraints: tuple, m: int,
                      g: int) -> torch.Tensor:
    """[P, g] candidates from the ``m`` empty valid nodes, the first ``m``
    of the load ranking ``order``, where the reference gives every row the
    same four least-loaded nodes.

    After a failover the rows that must move (a copy on a node that is
    out, or a slot unfilled) are the ones that bid for the empty nodes,
    and together they fill about as many places as the empty nodes have.
    A shared block lets them reach four of those nodes, so the others
    are filled short (a twentieth of their share at 100 000 x 1 000).
    Here the rows that must move are ranked among themselves, the other
    rows after them, and the row of rank q takes ranks q·g .. q·g + g - 1
    of the empty nodes, modulo ``m``: each empty node meets the same
    number of bidders.  The block is twice the shared one, up to ``m``,
    and the rotated window keeps the columns left, so a row whose empty
    nodes fill still reaches nodes with room."""
    dev = order.device
    p, _, r = prev.shape
    n = valid.shape[0]
    slot = torch.arange(r, device=dev)[None, :] < torch.tensor(
        [int(c) for c in constraints], device=dev)[:, None]  # [S, R]
    gone = (prev < 0) | ~valid[prev.clamp(0, n - 1).long()]
    need = (gone & slot).reshape(p, -1).any(dim=1).to(torch.int64)
    rank = torch.where(need > 0, torch.cumsum(need, 0),
                       need.sum() + torch.cumsum(1 - need, 0)) - 1
    pos = torch.remainder(
        rank[:, None] * g + torch.arange(g, device=dev)[None, :], m)
    return order[pos]
