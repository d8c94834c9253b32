# Copied from blance_tpu/plan/resident.py.
"""Encode residency: the tenant's encoded problem as delta-patched state.

PR 13 made the fleet's *solves* one coalesced dispatch and the solver
state resident (``SolveCarry``/``CarryCache``), but every converge cycle
still re-ran the whole host round trip: ``encode_problem`` from the
``PartitionMap`` (string interning + the full ``[P, S, R]`` prev
scatter + the Python weight/stickiness/hierarchy loops), a fresh
``TenantProblem``, and a full ``decode_assignment`` back to a brand-new
map — O(cluster) host work per cycle even when the delta was one dark
node.  Following GSPMD's one-program-many-shapes discipline
(arXiv:2105.04663) and the on-device mapping thesis of GPU-accelerated
process mapping (arXiv:2510.12196), this module makes the ENCODED
problem resident too:

- :class:`EncodedState` holds one tenant's interned id tables
  (node/partition indexes, per-level hierarchy group-id interns), the
  live ``DenseProblem`` arrays, the per-row fill ``counts`` and the
  held decoded map — everything a cycle used to rebuild from strings.
- Delta-apply kernels patch it in O(delta): an abrupt-fail strip
  removes the dark nodes' placements from exactly the holder rows
  (``core.encode.strip_prev_rows`` — the array twin of re-encoding the
  stripped map), weight drift writes only the touched
  weight/stickiness rows, a dark-set change flips only the changed
  ``valid_node`` entries, and a node ADD appends columns (weights,
  validity, hierarchy group ids via the resident intern tables — the
  zero-fill-new-columns recipe ``pad_carry_nodes`` uses for the solver
  carry).  Existing columns are untouched by construction:
  ``core.hierarchy.level_group_ids`` interns group ids first-seen in
  node order, so appended nodes can never renumber existing ones.
- The post-cycle apply replaces ``prev`` with the solve's PACKED
  assignment — a scatter over exactly the rows the solve changed
  (``core.encode.pack_slot_rows``, decode's own pack spelling) — so
  adopting a proposal costs O(changed rows), not a re-encode of the
  whole map.
- Decode is incremental too: the held map is patched at the changed
  rows (same ``Partition`` row spelling as ``decode_assignment``'s
  fast branch) and shortfall warnings regenerate from the resident
  ``counts``; the full ``decode_assignment`` runs only on a cold
  cycle's first decode.

The CONSERVATIVE protocol (the ServicePlanner side lives in
``blance_tpu_torch/fleetloop.py``): warm state is keyed to the *identity* of
the controller's current map object — any off-protocol event (a pass
that didn't land the proposal verbatim, a supersede, a shape change, a
statics change, a cache eviction) demotes to a full re-encode, never a
stale map.  Cold is always correct: it is ``encode_problem`` on the
current inputs, and ``tests/test_encode_resident.py`` pins the patched
arrays bit-equal to that re-encode across every delta family.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from ..core.encode import (
    DenseProblem,
    NPArray,
    decode_assignment,
    pack_slot_rows,
    strip_prev_rows,
)
from ..core.hierarchy import find_ancestor
from ..core.types import (
    Partition,
    PartitionMap,
    PartitionModel,
    PlanOptions,
)

__all__ = ["EncodedState", "Proposal", "build_encoded_state"]

_WARN_FMT = ("could not meet constraints: %d, stateName: %s,"
             " partitionName: %s")


@dataclass
class Proposal:
    """One un-adopted solve outcome, held until the pass lands.

    ``packed`` is the solve's assignment with every row's non-empty
    slots packed left — exactly what a fresh ``encode_problem`` of
    ``map`` would scatter, so adoption makes it the next ``prev``
    without re-encoding.  ``changed`` names the rows that differ from
    the pre-solve ``prev`` (the only rows a clean pass may move)."""

    map: PartitionMap
    packed: NPArray  # [P, S, R] int32
    counts: NPArray  # [P, S] int64 per-row filled slots
    changed: list[str]


def _gid_interns(nodes: list[str], parents: Optional[dict[str, str]],
                 max_level: int) -> list[dict[str, int]]:
    """Per-level ancestor-name -> group-id tables, replaying
    ``core.hierarchy.level_group_ids``'s exact first-seen interning so
    appending a node reuses (or extends) the SAME id space the resident
    ``gids`` rows were built with."""
    out: list[dict[str, int]] = []
    get = (parents or {}).get
    names = list(nodes)
    for level in range(max_level + 1):
        if level:
            names = [get(nm, "") for nm in names]
        table: dict[str, int] = {}
        for nm in names:
            if nm not in table:
                table[nm] = len(table)
        out.append(table)
    return out


class EncodedState:
    """One tenant's resident encoded problem (module doc).

    Mutated only from the tenant's own control-loop task (the
    ServicePlanner discipline); the shared :class:`~blance_tpu_torch.plan.
    carry.EncodeCache` only ever drops whole states, which costs a cold
    re-encode, never staleness."""

    __slots__ = (
        "problem", "node_index", "pindex", "gid_interns", "max_level",
        "counts", "map", "expected", "pending", "mod",
        "model", "hierarchy", "hrules", "msc", "ss", "ss_standalone",
        "pw", "nw", "removes",
    )

    def __init__(self, problem: DenseProblem, current: PartitionMap,
                 removes: frozenset[str], model: PartitionModel,
                 opts: PlanOptions) -> None:
        self.problem = problem
        self.node_index = {n: i for i, n in enumerate(problem.nodes)}
        self.pindex = {p: i for i, p in enumerate(problem.partitions)}
        self.max_level = problem.gids.shape[0] - 1
        self.gid_interns = _gid_interns(
            problem.nodes, opts.node_hierarchy, self.max_level)
        self.counts: NPArray = \
            (problem.prev >= 0).sum(axis=2).astype(np.int64)
        # The held decoded map: None until a decode-produced proposal is
        # adopted — a caller-supplied map may spell rows differently
        # (missing vs empty state keys), so the first decode after a
        # cold encode is always the full one.
        self.map: Optional[PartitionMap] = None
        # Identity token: the exact map object ``prev`` encodes.  Warm
        # cycles require ``current is expected`` — anything else is a
        # divergence and demotes to cold.
        self.expected: Optional[PartitionMap] = current
        self.pending: Optional[Proposal] = None
        self.mod: list[tuple[int, str]] = [
            (si, s) for si, s in enumerate(problem.states)
            if int(problem.constraints[si]) > 0]
        # Statics: identity-tracked; a swap demotes to cold.
        self.model = model
        self.hierarchy = opts.node_hierarchy
        self.hrules = opts.hierarchy_rules
        self.msc = opts.model_state_constraints
        self.ss = opts.state_stickiness
        self.ss_standalone = bool(opts.state_stickiness_standalone)
        # Weight-dict snapshots for the O(delta) diff.
        self.pw: dict[str, Any] = dict(opts.partition_weights or {})
        self.nw: dict[str, Any] = dict(opts.node_weights or {})
        self.removes = removes

    # -- bookkeeping ---------------------------------------------------------

    def nbytes(self) -> int:
        pr = self.problem
        total = 0
        for arr in (pr.prev, pr.partition_weights, pr.node_weights,
                    pr.valid_node, pr.stickiness, pr.gids, pr.gid_valid,
                    self.counts):
            total += int(np.asarray(arr).nbytes)
        if self.pending is not None:
            total += int(self.pending.packed.nbytes)
            total += int(self.pending.counts.nbytes)
        return total

    def statics_match(self, model: PartitionModel,
                      opts: PlanOptions) -> bool:
        """True when every encode-time static still holds (identity
        checks — the controller never swaps these mid-loop).  With
        ``state_stickiness`` configured, any partition-weight change
        also fails the check: stickiness resolution couples the two
        (core/encode.py), so the rare re-priced-with-state-stickiness
        cycle re-encodes cold rather than model the interplay."""
        if not (model is self.model
                and opts.node_hierarchy is self.hierarchy
                and opts.hierarchy_rules is self.hrules
                and opts.model_state_constraints is self.msc
                and opts.state_stickiness is self.ss
                and bool(opts.state_stickiness_standalone)
                == self.ss_standalone):
            return False
        if self.ss is not None and \
                (opts.partition_weights or {}) != self.pw:
            return False
        return True

    def shape_drifted(self) -> bool:
        """True when a fresh ``encode_problem`` of the current map
        would pick a different slot depth R (the widest row shrank
        below — or a constraint override pushed past — the resident
        one): shapes are jit statics, so the cycle must re-encode cold
        exactly like the pre-residency planner did."""
        pr = self.problem
        c_max = int(pr.constraints.max()) if pr.constraints.size else 0
        r_need = max(c_max,
                     int(self.counts.max()) if self.counts.size else 0,
                     1)
        return r_need != pr.R

    # -- delta-apply kernels -------------------------------------------------

    def apply_nodes(self, nodes: list[str],
                    opts: PlanOptions) -> Optional[tuple[int, int]]:
        """Fold the cycle's node list in.  Unchanged: (0, 0).  A pure
        append extends every [N]-shaped column in O(new nodes) —
        weights, validity, hierarchy group ids via the resident intern
        tables (the ``pad_carry_nodes`` zero-fill recipe, with real
        values instead of zeros) — and returns (nodes added, bytes
        written).  Anything else (reorder, removal, duplicate) returns
        None: demote to cold."""
        pr = self.problem
        old = pr.nodes
        if nodes == old:
            return 0, 0
        if len(nodes) <= len(old) or nodes[:len(old)] != old:
            return None
        fresh = nodes[len(old):]
        if any(n in self.node_index for n in fresh):
            return None
        nw = opts.node_weights or {}
        add_w = np.array([nw.get(n, 1) for n in fresh], np.float32)
        add_valid = np.array([n not in self.removes for n in fresh],
                             bool)
        levels = self.max_level + 1
        add_gids = np.empty((levels, len(fresh)), np.int32)
        add_gvalid = np.empty((levels, len(fresh)), bool)
        for j, n in enumerate(fresh):
            for level in range(levels):
                name = n if level == 0 else find_ancestor(
                    n, self.hierarchy, level)
                table = self.gid_interns[level]
                gid = table.get(name)
                if gid is None:
                    gid = len(table)
                    table[name] = gid
                add_gids[level, j] = gid
                add_gvalid[level, j] = name != ""
        pr.node_weights = np.concatenate([pr.node_weights, add_w])
        pr.valid_node = np.concatenate([pr.valid_node, add_valid])
        pr.gids = np.concatenate([pr.gids, add_gids], axis=1)
        pr.gid_valid = np.concatenate([pr.gid_valid, add_gvalid],
                                      axis=1)
        pr.nodes = list(nodes)
        for j, n in enumerate(fresh):
            self.node_index[n] = len(old) + j
        nbytes = int(add_w.nbytes + add_valid.nbytes + add_gids.nbytes
                     + add_gvalid.nbytes)
        return len(fresh), nbytes

    def apply_removes(self, removes: frozenset[str]) -> int:
        """Flip ``valid_node`` for exactly the nodes whose dark status
        changed; returns entries flipped."""
        if removes == self.removes:
            return 0
        valid = self.problem.valid_node
        flips = 0
        for n in self.removes ^ removes:
            ni = self.node_index.get(n)
            if ni is not None:
                valid[ni] = n not in removes
                flips += 1
        self.removes = removes
        return flips

    def apply_weights(self, opts: PlanOptions) -> tuple[int, int]:
        """Write exactly the weight/stickiness rows the option dicts
        changed (encode_problem's resolution per row: partition weight
        else default 1, stickiness = that weight else 1.5 — the
        state-stickiness interplay is excluded by statics_match).
        Returns (rows written, bytes written)."""
        rows = 0
        nbytes = 0
        new_pw = opts.partition_weights or {}
        if new_pw != self.pw:
            pweights = self.problem.partition_weights
            stick = self.problem.stickiness
            touched = set()
            for k, v in new_pw.items():
                if k in self.pindex and self.pw.get(k) != v:
                    touched.add(k)
            for k in self.pw:
                if k not in new_pw and k in self.pindex:
                    touched.add(k)
            for name in touched:
                pi = self.pindex[name]
                v = new_pw.get(name)
                wv = np.float32(1.0 if v is None else v)
                sv = np.float32(1.5 if v is None else v)
                if pweights[pi] != wv or stick[pi, 0] != sv:
                    pweights[pi] = wv
                    stick[pi, :] = sv
                    rows += 1
                    nbytes += 4 + 4 * stick.shape[1]
            self.pw = dict(new_pw)
        new_nw = opts.node_weights or {}
        if new_nw != self.nw:
            nweights = self.problem.node_weights
            touched = set()
            for k, v in new_nw.items():
                if k in self.node_index and self.nw.get(k) != v:
                    touched.add(k)
            for k in self.nw:
                if k not in new_nw and k in self.node_index:
                    touched.add(k)
            for name in touched:
                ni = self.node_index[name]
                wv = np.float32(1.0 if new_nw.get(name) is None
                                else new_nw[name])
                if nweights[ni] != wv:
                    nweights[ni] = wv
                    rows += 1
                    nbytes += 4
            self.nw = dict(new_nw)
        return rows, nbytes

    def apply_strip(self, nodes: set[str],
                    after: PartitionMap) -> tuple[int, int]:
        """An abrupt-fail strip: remove the dark nodes' placements from
        their holder rows (prev re-packed via the decode pack spelling)
        and patch the held map's rows to the strip spelling; ``after``
        becomes the new identity token.  Any un-adopted proposal is
        stale by definition (it was solved from the pre-strip prev) and
        is discarded.  Returns (rows patched, bytes written)."""
        pr = self.problem
        ids = np.array(sorted(self.node_index[n] for n in nodes
                              if n in self.node_index), np.int32)
        self.pending = None
        self.expected = after
        if ids.size == 0:
            return 0, 0
        new_prev, dirty = strip_prev_rows(pr.prev, ids)
        pr.prev = new_prev
        rows = int(dirty.sum())
        if rows:
            self.counts[dirty] = \
                (new_prev[dirty] >= 0).sum(axis=2).astype(np.int64)
            if self.map is not None:
                patched = dict(self.map)
                for pi in np.flatnonzero(dirty).tolist():
                    pname = pr.partitions[pi]
                    p = patched[pname]
                    patched[pname] = Partition(pname, {
                        s: [n for n in ns if n not in nodes]
                        for s, ns in p.nodes_by_state.items()})
                self.map = patched
        return rows, rows * (pr.S * pr.R * 4 + pr.S * 8)

    def adopt(self, proposal: Proposal,
              expected: PartitionMap) -> tuple[int, int]:
        """The post-cycle apply: the landed proposal's packed
        assignment becomes ``prev`` (a scatter over exactly the rows
        the solve changed — here a whole-array swap, since the packed
        table was built by patching a copy of ``prev`` at those rows),
        the proposal map becomes the held map, and ``expected`` (the
        controller's new current object) the identity token.  Returns
        (rows adopted, bytes)."""
        pr = self.problem
        pr.prev = proposal.packed
        self.counts = proposal.counts
        self.map = proposal.map
        self.expected = expected
        self.pending = None
        rows = len(proposal.changed)
        return rows, rows * (pr.S * pr.R * 4 + pr.S * 8)

    # -- incremental decode --------------------------------------------------

    def decode(self, assign: NPArray, current: PartitionMap,
               removes: list[str]) -> tuple[
                   PartitionMap, dict[str, list[str]], bool, int]:
        """Decode a solve against the resident state: patch the held
        map at the changed rows (full ``decode_assignment`` only when
        no canonical held map exists yet), regenerate shortfall
        warnings from the resident counts, and stage the proposal for
        adoption.  Returns (map, warnings, was_full_decode, changed
        rows).  Bit-identity to the full decode is pinned by
        tests/test_encode_resident.py."""
        pr = self.problem
        prev = pr.prev
        changed_idx = np.flatnonzero(
            (assign != prev).any(axis=(1, 2)))
        sub = np.ascontiguousarray(assign[changed_idx], np.int32)
        packed_rows, counts_rows = pack_slot_rows(sub)
        packed = prev.copy()
        packed[changed_idx] = packed_rows
        counts_new = self.counts.copy()
        counts_new[changed_idx] = counts_rows
        warnings: dict[str, list[str]]
        full = self.map is None
        if full:
            next_map, warnings = decode_assignment(
                pr, assign, current, removes)
        else:
            next_map = dict(self.map)
            # Vectorized over the changed rows, decode_assignment's
            # exact spelling per modeled state: one object-array name
            # gather + tolist per state, rows sliced by their counts.
            names_arr = np.asarray(pr.nodes, dtype=object)
            rows_per_state: list[list[list[str]]] = []
            for si, _sname in self.mod:
                ids = packed_rows[:, si, :]
                nested = names_arr[np.maximum(ids, 0)].tolist()
                cts = counts_rows[:, si].tolist()
                rows_per_state.append(
                    [row[:c] for row, c in zip(nested, cts)])
            mod_names = [s for _si, s in self.mod]
            for j, pi in enumerate(changed_idx.tolist()):
                pname = pr.partitions[pi]
                next_map[pname] = Partition(pname, dict(zip(
                    mod_names, (rows[j] for rows in rows_per_state))))
            # Shortfall warnings, decode_assignment's exact loop (state
            # order, then partition index order) off the updated counts.
            warnings = {}
            for si, sname in self.mod:
                want = int(pr.constraints[si])
                short = np.nonzero(counts_new[:, si] < want)[0]
                for pi in short:
                    pname = pr.partitions[pi]
                    warnings.setdefault(pname, []).append(
                        _WARN_FMT % (want, sname, pname))
        self.pending = Proposal(
            map=next_map, packed=packed, counts=counts_new,
            changed=[pr.partitions[i] for i in changed_idx.tolist()])
        return next_map, warnings, full, int(changed_idx.size)


def build_encoded_state(
    problem: DenseProblem,
    current: PartitionMap,
    removes: list[str],
    model: PartitionModel,
    opts: PlanOptions,
) -> Optional[EncodedState]:
    """Residency entry: wrap a freshly encoded problem as resident
    state, or None when the tenant is out of protocol — a degenerate
    problem, or a map with pass-through states (unmodeled or
    zero-constraint states in some partition's source: decode must then
    consult the live map per row, so its output cannot be patched from
    arrays alone and ``prev`` cannot be rebuilt from the packed
    assignment).  Out-of-protocol tenants simply stay on the full
    re-encode path."""
    if problem.P == 0 or problem.S == 0 or problem.N == 0:
        return None
    solved = {s for si, s in enumerate(problem.states)
              if int(problem.constraints[si]) > 0}
    for p in current.values():
        if not (p.nodes_by_state.keys() <= solved):
            return None
    return EncodedState(problem, current, frozenset(removes), model,
                        opts)
