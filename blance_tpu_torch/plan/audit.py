# Copied from blance_tpu/plan/tensor.py:3205-3560 (the host numpy audit:
# check_assignment, maybe_validate and the _count_hier_misses* helpers).
"""Constraint audit of a dense assignment — pure numpy, device-free."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.encode import DenseProblem, NPArray
from ..obs import get_recorder

__all__ = ["check_assignment", "maybe_validate"]


def _anchor_sat_np(
    anchor: NPArray,  # [P] node ids, -1 = absent
    gids: NPArray,  # [L, N]
    gid_valid: NPArray,  # [L, N]
    rules: list[tuple[int, int]],
) -> NPArray:
    """Per-rule satisfaction [n_rules, P, N] for ONE anchor column: does
    node n share the anchor's include-level ancestor and NOT its
    exclude-level ancestor?  Absent anchors satisfy everything.  Validity
    gates on the anchor side only, exactly like the device _hier_penalty."""
    p = anchor.shape[0]
    n = gids.shape[1]
    aa = np.clip(anchor, 0, n - 1)
    present = (anchor >= 0)[:, None]
    out = np.ones((len(rules), p, n), bool)
    for idx, (inc, exc) in enumerate(rules):
        inc_same = (gids[inc][aa][:, None] == gids[inc][None, :]) & \
            gid_valid[inc][aa][:, None]
        exc_same = (gids[exc][aa][:, None] == gids[exc][None, :]) & \
            gid_valid[exc][aa][:, None]
        out[idx] = np.where(present, inc_same & ~exc_same, True)
    return out


# Partition-block size for the matrix-path hierarchy audit: bounds its
# peak numpy temporaries to [n_rules, _HIER_CHUNK, N] regardless of P.
_HIER_CHUNK = 4096


def _audit_rules_nest(problem: DenseProblem) -> bool:
    """True when every rule's exclude level is strictly finer than its
    include level — the tree shape under which an exclude group lies
    inside exactly one include group, so attainability reduces to group
    counting (the same precondition _hier_floor_counts relies on in the
    solver)."""
    return all(exc < inc
               for si in range(problem.S)
               for (inc, exc) in (problem.rules.get(si) or []))


def _count_hier_misses_fast(
    problem: DenseProblem, assign: NPArray
) -> int:
    """Group-counting hierarchy audit: O(P·S·R·rules + N·L) host math.

    Semantically identical to the matrix path (_count_hier_misses_block)
    when every rule nests (_audit_rules_nest) — pinned by
    tests/test_tensor.py's parity fuzz.  Instead of materializing
    per-anchor satisfaction over all N candidates, the attainable tier
    comes from counting: with the exclude level strictly finer than the
    include level, the number of rule-satisfying open candidates is

        count(valid nodes in the anchors' shared include group)
        - sum over DISTINCT anchor exclude groups of count(valid in e)
        - count(already-used nodes in the include group but in none of
          those exclude groups)

    — [N]-bincounts (one per hierarchy level, shared across rules) plus
    [P] gathers.  The achieved tier is a point evaluation at the judged
    node.  This is what makes the audit affordable at the north-star
    scale, so validation defaults ON at every size (maybe_validate);
    the reference's equivalent property surfaces as warnings
    (plan.go:231-235).
    """
    P, S, R = assign.shape
    N = problem.N
    gids, gid_valid = problem.gids, problem.gid_valid
    valid = problem.valid_node
    if not any(problem.rules.get(si) for si in range(S)):
        return 0

    # Valid-node histogram per hierarchy level.  Ancestor PRESENCE is
    # gid_valid, not the gid's sign: encode interns orphans into a shared
    # ""-group with a real dense id and gid_valid=False (encode.py:
    # level_group_ids + find_ancestor), while synthetic/test problems may
    # spell absence as gid -1 — gate on gid_valid and drop negatives so
    # both representations count identically.
    cnt = np.zeros((gids.shape[0], N), np.int64)
    for lv in range(gids.shape[0]):
        g = gids[lv][valid & gid_valid[lv]]
        g = g[g >= 0]
        cnt[lv] = np.bincount(g, minlength=N)

    # Joint histograms per rule: nodes of an exclude group that also hold
    # a PRESENT include-level ancestor.  A node can sit in a real exclude
    # group while its coarser ancestor is missing (e.g. a rack with no
    # zone parent): such a node is never in the shared include group, so
    # subtracting the full exclude-group count would over-subtract it.
    # Present ancestors are tree-consistent (same exclude group + present
    # include ancestor => same include group), so this joint count is
    # exactly |e ∩ g| for every e counted under g.
    cnt_pair: dict[tuple[int, int], NPArray] = {}
    for si in range(S):
        for (inc, exc) in (problem.rules.get(si) or []):
            if (inc, exc) in cnt_pair:
                continue
            sel = valid & gid_valid[exc] & gid_valid[inc] & \
                (gids[exc] >= 0) & (gids[inc] >= 0)
            cnt_pair[(inc, exc)] = np.bincount(
                gids[exc][sel], minlength=N)

    top_anchor = problem.prev[:, 0, 0]
    misses = 0
    used_ids: list[NPArray] = []  # [P] global node ids, -1 = none

    def point_sat(anchors, node, inc, exc):
        """[P] bool: does ``node`` satisfy (inc, exc) for every present
        anchor?  Validity gates on the anchor side only, exactly like
        _anchor_sat_np / the device _anchor_rule_sat."""
        nd = np.clip(node, 0, N - 1)
        out = np.ones(P, bool)
        for a in anchors:
            aa = np.clip(a, 0, N - 1)
            inc_same = (gids[inc][aa] == gids[inc][nd]) & gid_valid[inc][aa]
            exc_same = (gids[exc][aa] == gids[exc][nd]) & gid_valid[exc][aa]
            out &= np.where(a >= 0, inc_same & ~exc_same, True)
        return out

    def attainable_count(anchors, inc, exc):
        """[P] count of rule-satisfying candidates among valid & unused
        nodes, by group counting (see docstring)."""
        # Shared include group across present anchors (else unsatisfiable).
        g = np.full(P, -1, np.int64)
        ok = np.ones(P, bool)
        for a in anchors:
            aa = np.clip(a, 0, N - 1)
            a_g = np.where(gid_valid[inc][aa], gids[inc][aa], -2)
            present = a >= 0
            ok &= np.where(present & (g >= 0), a_g == g, True)
            ok &= np.where(present & (g < 0), a_g >= 0, True)
            g = np.where(present & (g < 0), a_g, g)
        gc = np.clip(g, 0, N - 1)
        count = cnt[inc][gc].astype(np.int64)

        # Subtract distinct anchor exclude groups (each nested inside the
        # shared include group, so each subtracts its full valid count).
        e_seen: list[NPArray] = []
        for a in anchors:
            aa = np.clip(a, 0, N - 1)
            e = np.where((a >= 0) & gid_valid[exc][aa], gids[exc][aa], -1)
            dup = np.zeros(P, bool)
            for prev_e in e_seen:
                dup |= (e == prev_e) & (e >= 0)
            count -= np.where((e >= 0) & ~dup,
                              cnt_pair[(inc, exc)][np.clip(e, 0, N - 1)], 0)
            e_seen.append(e)

        # Subtract already-used nodes still standing in the include group:
        # used nodes inside a counted exclude group are subtracted above
        # already, so only those OUTSIDE every counted group go here.
        for u in used_ids:
            uu = np.clip(u, 0, N - 1)
            in_g = (u >= 0) & valid[uu] & (gids[inc][uu] == g)
            in_excl = np.zeros(P, bool)
            for e in e_seen:
                in_excl |= (e >= 0) & (gids[exc][uu] == e)
            count -= (in_g & ~in_excl).astype(np.int64)
        return np.where(ok & (g >= 0), count, 0)

    for si in range(S):
        rules_si = problem.rules.get(si) or []
        big = len(rules_si)
        if rules_si:
            base = top_anchor if si == 0 else np.where(
                assign[:, 0, 0] >= 0, assign[:, 0, 0], top_anchor)
            anchors: list[NPArray] = [base]
            any_anchor = base >= 0
        for j in range(R):
            node_j = assign[:, si, j]
            has = node_j >= 0
            if rules_si and has.any():
                achieved = np.full(P, big, np.int64)
                attainable = np.full(P, big, np.int64)
                for idx in reversed(range(big)):
                    inc, exc = rules_si[idx]
                    achieved = np.where(
                        point_sat(anchors, node_j, inc, exc), idx, achieved)
                    attainable = np.where(
                        attainable_count(anchors, inc, exc) > 0,
                        idx, attainable)
                misses += int((has & any_anchor
                               & (achieved > attainable)).sum())
            if rules_si:
                anchors.append(node_j)
                any_anchor = any_anchor | has
            # Cross-state exclusivity: every pick occupies its node for
            # the whole partition.  Deduplicate (a malformed assignment
            # can repeat a node; the matrix path's bool [P, N] ``used``
            # dedups structurally, and duplicates are already counted by
            # check_assignment separately).
            dup = np.zeros(P, bool)
            for u in used_ids:
                dup |= (node_j == u) & has
            used_ids.append(np.where(has & ~dup, node_j, -1))
    return misses


def _count_hier_misses(problem: DenseProblem, assign: NPArray) -> int:
    """Feasible-tier hierarchy misses: a copy counts when it sits at a
    WORSE rule tier than some still-open valid node could have achieved
    given the same anchors (the solver's prefix anchoring, reference
    plan.go:185-191): state 0 anchors on the PREVIOUS primary (the
    solver's top_anchor — never on the node being judged), later states
    on the assigned primary plus the state's earlier picks.
    Unsatisfiable rules never count: when no candidate reaches a better
    tier, the flat fallback is correct behavior (plan.go:214-220).

    Two implementations, same contract: the group-counting fast path
    (O(P + N·L), _count_hier_misses_fast) whenever every rule's exclude
    level is strictly finer than its include level — the common tree
    shape — and the exhaustive [P, N] matrix path otherwise, run in
    P-blocks of _HIER_CHUNK so peak memory stays flat in P (at the
    north-star 100k x 10k that is ~40 MB of bool temporaries per rule,
    not ~1 GB)."""
    if _audit_rules_nest(problem):
        return _count_hier_misses_fast(problem, assign)
    P = assign.shape[0]
    total = 0
    for lo in range(0, P, _HIER_CHUNK):
        hi = min(lo + _HIER_CHUNK, P)
        total += _count_hier_misses_block(
            problem, assign[lo:hi], problem.prev[lo:hi])
    return total


def _count_hier_misses_block(
    problem: DenseProblem, assign: NPArray, prev: NPArray
) -> int:
    """One partition block of _count_hier_misses; per-anchor rule
    satisfaction folds in incrementally — each rule-bearing state costs
    one [n_rules, B, N] table plus one AND per ordinal."""
    P, S, R = assign.shape
    N = problem.N
    if not any(problem.rules.get(si) for si in range(S)):
        return 0
    rows = np.arange(P)
    top_anchor = prev[:, 0, 0]
    misses = 0
    used = np.zeros((P, N), bool)  # nodes this partition already occupies
    for si in range(S):
        rules_si = problem.rules.get(si) or []
        if rules_si:
            big = len(rules_si)
            base = top_anchor if si == 0 else np.where(
                assign[:, 0, 0] >= 0, assign[:, 0, 0], top_anchor)
            sat = _anchor_sat_np(base, problem.gids, problem.gid_valid,
                                 rules_si)
            any_anchor = base >= 0
        for j in range(R):
            node_j = assign[:, si, j]
            has = node_j >= 0
            if rules_si and has.any():
                tier = np.full((P, N), big, np.int32)
                for idx in reversed(range(len(rules_si))):
                    tier = np.where(sat[idx], idx, tier)
                cand_ok = problem.valid_node[None, :] & ~used
                attainable = np.min(np.where(cand_ok, tier, big), axis=1)
                achieved = tier[rows, np.clip(node_j, 0, N - 1)]
                misses += int((has & any_anchor
                               & (achieved > attainable)).sum())
            if rules_si:
                # This pick anchors the state's later ordinals.
                sat &= _anchor_sat_np(node_j, problem.gids,
                                      problem.gid_valid, rules_si)
                any_anchor = any_anchor | has
            used[rows, np.clip(node_j, 0, N - 1)] |= has
    return misses


def check_assignment(
    problem: DenseProblem, assign: NPArray
) -> dict[str, int]:
    """Constraint checker — the '0 violations' gate for the TPU backend.

    Counts (a) slot shortfalls beyond what an honest solver could fill,
    (b) same-partition node duplicates across states/slots, (c) assignments
    to removed nodes, (d) feasible-tier hierarchy-rule misses — copies
    placed at a worse rule tier than an open valid node could achieve
    (unmeetable rules degrade softly to the flat fallback and do NOT
    count, like the reference's warnings, plan.go:214-235).

    Pure numpy.  With nesting rules (every exclude level strictly finer
    than its include level — the common tree shape) the hierarchy audit
    runs by group counting in O(P + N·L), noise next to the solve at any
    size, so maybe_validate defaults it ON at every scale.  Exotic
    non-nesting rules fall back to the exhaustive [P, N] matrix audit
    (streamed in P-blocks: bounded memory, but O(P*N) time — tens of
    seconds at 100k x 10k), which stays behind the auto-validation
    ceiling unless explicitly requested.  See the
    ``validate_assignment`` wiring in plan_next_map_tpu /
    PlannerSession.replan.

    Every audit runs inside a ``plan.audit`` span."""
    with get_recorder().span("plan.audit"):
        return _audit_counts(problem, np.asarray(assign))


def _audit_counts(problem: DenseProblem, assign: NPArray) -> dict[str, int]:
    """check_assignment's counts."""
    P, S, R = assign.shape
    n_valid = int(problem.valid_node.sum())
    if P == 0:
        return {"duplicates": 0, "on_removed_nodes": 0,
                "unfilled_feasible_slots": 0, "hierarchy_misses": 0}

    def row_dups(rows: NPArray) -> NPArray:
        """Per row: count of valid entries equal to an earlier entry."""
        srt = np.sort(rows, axis=1)
        return ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).sum(axis=1)

    flat = assign.reshape(P, S * R)
    dup = int(row_dups(flat).sum())
    held = flat[flat >= 0]
    removed = int((~problem.valid_node[held]).sum())

    # Shortfall per (partition, state): want vs got, capped by what an
    # honest solver could still fill given the distinct nodes the
    # partition already occupies through this state (prefix-distinct).
    shortfall = 0
    got_ps = (assign >= 0).sum(axis=2)  # [P, S]
    for si in range(S):
        want = int(problem.constraints[si])
        if want <= 0:
            continue
        pre = assign[:, :si + 1, :].reshape(P, -1)
        distinct = (pre >= 0).sum(axis=1) - row_dups(pre)
        got = got_ps[:, si]
        achievable = np.minimum(want, np.maximum(n_valid - distinct + got, 0))
        shortfall += int(np.maximum(achievable - got, 0).sum())
    return {"duplicates": dup, "on_removed_nodes": removed,
            "unfilled_feasible_slots": shortfall,
            "hierarchy_misses": _count_hier_misses(problem, assign)}


# Auto-validation ceiling for the EXOTIC-rules path only: the exhaustive
# matrix audit is O(P*N) time, so above this many cells it needs an
# explicit opt-in.  Nesting rules (the common case) audit in O(P + N·L)
# and validate by default at every scale.
_VALIDATE_AUTO_CELLS = 1 << 22


def maybe_validate(
    problem: DenseProblem, assign: NPArray, validate: Optional[bool],
    context: str,
) -> Optional[dict[str, int]]:
    """Run check_assignment per the ``validate_assignment`` policy and
    surface violations as a UserWarning (reference analogue: constraint
    problems degrade to warnings, plan.go:231-235).  Returns the counts
    when the check ran, else None."""
    import warnings as _warnings

    if validate is None:
        validate = _audit_rules_nest(problem) or \
            problem.P * problem.N <= _VALIDATE_AUTO_CELLS
    if not validate:
        return None
    counts = check_assignment(problem, assign)
    if any(counts.values()):
        _warnings.warn(
            f"blance_tpu_torch {context}: solver produced a constraint-violating "
            f"assignment: {counts}", UserWarning, stacklevel=3)
    return counts

