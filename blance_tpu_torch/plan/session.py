# Copied from blance_tpu/plan/session.py.  The session solves on a torch
# device ("cuda" by default) through the port's solvers; ``current`` and
# ``proposed`` stay host numpy arrays, so the carry cache's identity match
# works as in the reference.  A mesh (a port Mesh, parallel/mesh.py) runs
# every solve sharded through parallel/sharded.py, as the reference's does.
"""Long-lived dense planning sessions.

``plan_next_map`` is a pure function of PartitionMaps: every call pays the
string<->id marshalling at the edges.  A real cluster rebalances the
*same* index repeatedly: same partitions, same states, a slowly-changing
node set.  ``PlannerSession`` encodes once and keeps the current dense
assignment; the steady-state loop is

    session.remove_nodes(["n7"])       # cluster delta, O(delta)
    proposed = session.replan()        # solve on the device
    nodes, states, ops = session.moves()   # diff on the device
    session.apply()                    # adopt the proposed assignment

with PartitionMaps materializing only at the edges (``load_map`` /
``to_map``).

Replans are INCREMENTAL by default: every apply() promotes the solve's
auction state (a plan.tensor.SolveCarry: prices, assignment, per-state
fill) to the session's warm carry, and each cluster delta marks the
partitions it can move in a dirty mask.  The next replan() then runs one
carry-seeded repair sweep instead of the cold fixpoint, bitwise the cold
result, and falls back to the cold solve whenever the repair leaks
outside the dirty mask, a capacity rail shrank under held load, the
solve engine fails, or the post-solve audit flags a violation.  The
recorder's ``plan.solve.carry_hit`` / ``carry_miss`` / ``warm_fallback``
and ``plan.solve.sweeps`` counters show which path ran.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..convert import problem_to_torch, resolve_device
from ..core.encode import DenseProblem, NPArray, decode_assignment, \
    encode_problem
from ..core.types import Partition, PartitionMap, PartitionModel, \
    PlanOptions
from ..obs import device as _obs_device
from ..obs import get_recorder
from . import tensor as _tensor
from .audit import _VALIDATE_AUTO_CELLS, _audit_rules_nest, \
    check_assignment, maybe_validate
from .carry import CarryCache, capacity_shrank, effective_dirty
from .tensor import Constraints, Rules, SolveCarry

__all__ = ["PlannerSession"]


class PlannerSession:
    """Stateful dense planner for one logical index.

    Parameters
    ----------
    model: state name -> PartitionModelState (priorities + constraints).
    nodes: every node that may ever appear, in tie-break order (node order
        is the planner's deterministic tie-break, reference plan.go:617-628).
    partitions: partition names; placement order is the planner's canonical
        name sort.
    opts: planner knobs; weights/stickiness/hierarchy are encoded once.
    mesh: optional port Mesh (parallel/sharded.make_mesh / make_mesh_2d):
        shards every solve over its ranks; the session then runs its
        diffs on the mesh's rank-0 device and ignores ``device``.
    carry_cache, cache_key: a shared CarryCache and this session's key in
        it (by default a private, unbounded cache).
    device: where every solve and diff runs ("cuda" unless the caller asks
        for the CPU, where the kernels run their plain versions).
    """

    def __init__(
        self,
        model: PartitionModel,
        nodes: list[str],
        partitions: list[str],
        opts: Optional[PlanOptions] = None,
        mesh: Any = None,
        carry_cache: Optional[CarryCache] = None,
        cache_key: str = "session",
        device: Any = "cuda",
    ) -> None:
        if mesh is not None:
            from ..parallel.sharded import check_mesh

            check_mesh(mesh, "PlannerSession")
            self.device = mesh.device
        else:
            self.device = resolve_device(device, "PlannerSession")
        self.mesh = mesh
        self.model = model
        self.opts = opts or PlanOptions()
        self._removed: set[str] = set()
        self._nodes = list(nodes)
        self._partition_names = list(partitions)
        self._reencode(prev_map={})
        # current/proposed dense assignments [P, S, R] int32, -1 = empty.
        self.current = self._problem.prev.copy()
        self.proposed: Optional[NPArray] = None
        # Warm-start state lives in a plan.carry.CarryCache entry: the
        # SolveCarry matching ``current`` (valid iff entry.current IS the
        # ``current`` array, because every adoption path replaces the
        # array), the pending carry of ``proposed`` (promoted by apply()),
        # and the dirty/dirty-post masks.
        self._carries = carry_cache if carry_cache is not None \
            else CarryCache()
        self._ckey = cache_key
        self._carries.entry(self._ckey, len(self._partition_names))

    # -- encoding ------------------------------------------------------------

    def _reencode(self, prev_map: PartitionMap) -> None:
        """(Re)build the dense problem statics; prev_map seeds ``prev``."""
        pta = {name: Partition(name, {}) for name in self._partition_names}
        self._problem = encode_problem(
            prev_map, pta, self._nodes, sorted(self._removed),
            self.model, self.opts)
        self._node_index = {n: i for i, n in enumerate(self._problem.nodes)}

    @property
    def problem(self) -> DenseProblem:
        """The encoded statics (DenseProblem).

        ``problem.prev`` is only the encode-time seed (all -1, or the last
        load_map snapshot): it goes stale after add_nodes()/replan()/
        apply().  ``self.current`` is the authoritative live assignment."""
        return self._problem

    # -- cluster membership ----------------------------------------------------

    def add_nodes(self, names: list[str]) -> None:
        """Add nodes (new capacity attracts load on the next replan).

        Dirty-mask delta: partitions with a holder in a hierarchy group
        the new node joins are marked (their rule-tier floor may have
        improved, so a warm repair must let them re-bid).  Balance-side
        displacement is caught by replan()'s capacity precheck, which
        routes grown clusters to the cold solve."""
        grew = False
        added = []
        for n in names:
            self._removed.discard(n)
            if n not in self._node_index:
                self._nodes.append(n)
                self._node_index[n] = len(self._nodes) - 1
                added.append(n)
                grew = True
        if grew:
            current = self.current
            self._reencode(prev_map={})
            # Node ids are append-only, so the old assignment is still valid.
            r_new = self._problem.R
            if r_new > current.shape[2]:
                pad = np.full(
                    current.shape[:2] + (r_new - current.shape[2],),
                    -1, np.int32)
                current = np.concatenate([current, pad], axis=2)
                # ``current`` was replaced; the carry no longer matches
                # any live assignment array (the delta masks still do).
                self._carries.drop_carry_keep_dirty(self._ckey)
            self.current = current
            self._pad_carry_nodes()
            self._mark_dirty_for_added(
                [self._node_index[n] for n in added])
        else:
            self._problem.valid_node[:] = [
                n not in self._removed for n in self._problem.nodes]

    def remove_nodes(self, names: list[str]) -> None:
        """Mark nodes for removal: the next replan drains them.

        Dirty-mask delta: exactly the partitions holding a copy on a
        removed node."""
        self._removed.update(names)
        self._problem.valid_node[:] = [
            n not in self._removed for n in self._problem.nodes]
        ids = [self._node_index[n] for n in names if n in self._node_index]
        if ids:
            arr = np.asarray(ids, np.int32)
            mask = np.isin(self.current, arr).any(axis=(1, 2))
            if self.proposed is not None:
                # The pending proposal may have moved load ONTO the
                # victim: if it is adopted, those rows are the delta.
                mask |= np.isin(self.proposed, arr).any(axis=(1, 2))
            self._mark_dirty(mask)

    def set_node_weights(self, node_weights: dict[str, int]) -> None:
        """Re-weight nodes in place (capacity shares + score divisors).
        A weight change re-prices every node: the warm carry is
        invalidated and the next replan solves cold."""
        self.opts.node_weights = dict(node_weights)
        prob = self._problem
        for ni, n in enumerate(prob.nodes):
            prob.node_weights[ni] = node_weights.get(n, 1)
        self.invalidate_carry()

    def set_partition_weights(self, weights: dict[str, int]) -> None:
        """Re-weight partitions in place (missing names weigh 1, as in
        the encoder).  Invalidates the warm carry, like
        ``set_node_weights``."""
        self.opts.partition_weights = dict(weights)
        prob = self._problem
        for pi, name in enumerate(prob.partitions):
            prob.partition_weights[pi] = weights.get(name, 1)
        self.invalidate_carry()

    def invalidate_carry(self) -> None:
        """Drop the warm-start state: the next replan() solves cold.

        Called automatically on load_map / weight changes; call it
        manually after mutating ``current``, ``opts``, or the problem
        arrays directly."""
        self._carries.invalidate(self._ckey)

    # -- warm-start internals (thin views over the CarryCache entry) ---------

    @property
    def _carry(self) -> Optional[SolveCarry]:
        """The live warm carry (None = the next replan solves cold)."""
        e = self._carries.peek(self._ckey)
        return e.carry if e is not None else None

    def _mark_dirty(self, mask: NPArray) -> None:
        """Record delta marks; while a proposal is pending they land in
        the post-proposal mask, which apply() carries forward."""
        self._carries.mark_dirty(self._ckey, mask,
                                 pending=self.proposed is not None)

    def _pad_carry_nodes(self) -> None:
        """Grow both carries' [N]-shaped tables after add_nodes."""
        self._carries.pad_nodes(self._ckey, self._problem.N)

    def _mark_dirty_for_added(self, new_ids: list[int]) -> None:
        """Adds can improve a partition's attainable rule tier: any
        partition holding a copy in a hierarchy group the new node
        joins must be allowed to re-bid under a warm repair."""
        prob = self._problem
        if not new_ids or not prob.rules or not self.current.size:
            return
        assigns = [self.current]
        if self.proposed is not None:
            assigns.append(self.proposed)
        levels = {inc for rl in prob.rules.values() for (inc, _exc) in rl}
        for a_arr in assigns:
            held = a_arr >= 0
            cur = np.clip(a_arr, 0, prob.N - 1)
            for lv in levels:
                for a in new_ids:
                    if not prob.gid_valid[lv, a]:
                        continue
                    g = prob.gids[lv, a]
                    self._mark_dirty(
                        ((prob.gids[lv][cur] == g) & held).any(axis=(1, 2)))

    def _capacity_shrank(self, carry: SolveCarry, dirty: NPArray) -> bool:
        """Host-side warm-decline precheck (plan.carry.capacity_shrank);
        the session contributes its mesh's partition-shard count for the
        quantization allowance."""
        from ..parallel.sharded import shard_count

        prob = self._problem
        return capacity_shrank(
            carry.used, self.current, prob.partition_weights,
            prob.node_weights, prob.valid_node, prob.constraints, dirty,
            shards=shard_count(self.mesh))

    @property
    def nodes(self) -> list[str]:
        return list(self._problem.nodes)

    @property
    def removed_nodes(self) -> list[str]:
        return sorted(self._removed)

    # -- map edges ---------------------------------------------------------------

    def load_map(self, prev_map: PartitionMap) -> None:
        """Adopt an existing PartitionMap as the current assignment.

        Raises on placements the session cannot represent (nodes outside
        the session's node list); unmodeled states are dropped."""
        unknown_parts = set(prev_map) - set(self._partition_names)
        if unknown_parts:
            raise ValueError(
                "load_map: partitions outside this session: "
                f"{sorted(unknown_parts)[:8]}")
        modeled = set(self._problem.states)
        known = self._node_index
        unknown = sorted({
            node
            for partition in prev_map.values()
            for sname, ns in partition.nodes_by_state.items()
            if sname in modeled
            for node in ns if node not in known})
        if unknown:
            raise ValueError(
                "load_map: placements on nodes outside this session "
                f"(would be silently dropped): {unknown[:8]}")
        self._reencode(prev_map=prev_map)
        self.current = self._problem.prev.copy()
        self.proposed = None
        self.invalidate_carry()  # the adopted map is a cold start

    def to_map(
        self, which: str = "current"
    ) -> tuple[PartitionMap, dict[str, list[str]]]:
        """Materialize ``current`` or ``proposed`` as (PartitionMap,
        warnings)."""
        if which not in ("current", "proposed"):
            raise ValueError(f"to_map: unknown which={which!r}")
        assign = self.proposed if which == "proposed" else self.current
        if assign is None:
            raise ValueError("no proposed assignment; call replan() first")
        pta = {name: Partition(name, {}) for name in self._partition_names}
        return decode_assignment(
            self._problem, assign, pta, sorted(self._removed))

    # -- the loop -------------------------------------------------------------

    def _problem_arrays(self) -> tuple[NPArray, ...]:
        """The encoded host arrays after ``current`` (the sharded
        solves' positional operands 2-7)."""
        prob = self._problem
        return (prob.partition_weights, prob.node_weights, prob.valid_node,
                prob.stickiness, prob.gids, prob.gid_valid)

    def _solver_args(self) -> tuple[torch.Tensor, ...]:
        prob = self._problem
        return problem_to_torch(
            self.current, prob.partition_weights, prob.node_weights,
            prob.valid_node, prob.stickiness, prob.gids, prob.gid_valid,
            device=self.device)

    def replan(self) -> NPArray:
        """Solve placement from ``current`` on the session's device;
        stores and returns the proposed assignment (does not adopt it:
        see apply()).

        With a valid warm carry (built by the previous replan, promoted
        by apply()) the solve is one carry-seeded repair sweep, bitwise
        the cold fixpoint.  Falls back to the cold solve when the carry
        is missing or stale, capacity shrank under held load, the repair
        leaked outside the dirty mask, the engine failed, or the
        post-solve audit found a violation."""
        prob = self._problem
        rules = tuple(tuple(prob.rules.get(si, ())) for si in range(prob.S))
        constraints = tuple(int(c) for c in prob.constraints)
        if prob.P == 0 or prob.N == 0 or prob.S == 0:
            self.proposed = self.current.copy()
            return self.proposed

        rec = get_recorder()
        iters = max(int(self.opts.max_iterations), 1)
        mode = _tensor.resolve_default_fused_score(prob.P, prob.N,
                                                   self.device)

        # Warm attempt: consume the carry (single-use), accept only a
        # delta-contained repair.  The consume merges post-proposal marks
        # first: this solve absorbs every delta recorded so far.
        carry, dirty_base = self._carries.consume(self._ckey, self.current)
        if carry is None:
            rec.count("plan.solve.carry_miss")
        assign = new_carry = None
        if carry is not None:
            dirty = effective_dirty(dirty_base, self.current,
                                    prob.constraints)
            if self._capacity_shrank(carry, dirty):
                # The trim pass will displace clean holders: the repair
                # could never be accepted, so go straight to cold.
                rec.count("plan.solve.carry_miss")
            else:
                assign, new_carry = self._warm_solve(
                    carry, dirty, constraints, rules, mode)
                if assign is not None and self._audit_gate(prob, assign):
                    rec.count("plan.solve.warm_fallback")
                    assign = new_carry = None
                if assign is not None:
                    # Counted only after every gate (device acceptance
                    # AND the audit) passed: the replan cost one sweep.
                    rec.count("plan.solve.carry_hit")

        if assign is None and self.mesh is not None:
            from ..parallel.sharded import solve_dense_sharded

            assign, new_carry = solve_dense_sharded(
                self.mesh, self.current, *self._problem_arrays(),
                constraints, rules, max_iterations=iters, return_carry=True)
        elif assign is None:
            assign, _engine, new_carry = _tensor.solve_converged_resilient(
                *self._solver_args(), constraints, rules,
                max_iterations=iters, mode=mode,
                allow_fallback=_tensor._FUSED_SCORE_DEFAULT == "auto",
                context="PlannerSession.replan", return_carry=True)
        maybe_validate(prob, assign, self.opts.validate_assignment,
                       "PlannerSession.replan")
        self.proposed = assign
        self._carries.store_pending(self._ckey, new_carry)
        return assign

    def _warm_solve(
        self, carry: SolveCarry, dirty: NPArray,
        constraints: Constraints, rules: Rules, mode: str,
    ) -> tuple[Optional[NPArray], Optional[SolveCarry]]:
        """One warm repair attempt; (None, None) on decline/failure."""
        try:
            if self.mesh is not None:
                from ..parallel.sharded import solve_dense_sharded

                return solve_dense_sharded(
                    self.mesh, self.current, *self._problem_arrays(),
                    constraints, rules, dirty=dirty, carry=carry,
                    return_carry=True, warm_only=True)
            return _tensor.solve_dense_warm(
                *self._solver_args(), constraints, rules, dirty=dirty,
                carry=carry, fused_score=mode)
        except (ValueError, TypeError):
            raise  # deterministic input errors: same on the cold path
        except Exception as e:
            # Engine/runtime failure during the repair: degrade to the
            # cold resilient path, which has its own engine fallback.
            import warnings as _warnings

            first = (str(e).splitlines() or [""])[0][:200]
            _warnings.warn(
                f"blance_tpu_torch PlannerSession.replan: warm repair "
                f"failed ({type(e).__name__}: {first}); falling back to a "
                f"cold solve", UserWarning, stacklevel=3)
            get_recorder().count("plan.solve.warm_fallback")
            return None, None

    def _audit_gate(self, prob: DenseProblem, assign: NPArray) -> bool:
        """True when the audit policy is active AND finds violations:
        the warm path's fall-back-to-cold condition.  Follows
        opts.validate_assignment exactly like maybe_validate."""
        validate = self.opts.validate_assignment
        if validate is None:
            validate = _audit_rules_nest(prob) or \
                prob.P * prob.N <= _VALIDATE_AUTO_CELLS
        if not validate:
            return False
        return any(check_assignment(prob, assign).values())

    def recovery_replan(self, dead_nodes: list[str]) -> NPArray:
        """Failure-aware re-entry (rebalance_async recovery rounds):
        drain ``dead_nodes`` and replan.  ``remove_nodes`` marks exactly
        the partitions holding a copy on a dead node dirty, so with a
        live carry this is the one-sweep warm repair.  Returns the
        proposed assignment; adopt it with ``apply()``."""
        self.remove_nodes(list(dead_nodes))
        return self.replan()

    def replan_with_moves(
        self, favor_min_nodes: bool = False
    ) -> tuple[NPArray, tuple[NPArray, NPArray, NPArray]]:
        """Fused replan: the solve, the move diff and the decode pack on
        the session's device, their outputs back in one copy (the plan
        pipeline, plan/tensor.py).

        Semantically ``replan()`` followed by ``moves(favor_min_nodes)``,
        bitwise in the proposed assignment and the move arrays, but the
        delta replan crosses from the device once after the solve.  Falls
        back like replan(): the cold pipeline on a carry miss, a decline
        or an audit violation; the other engine on an engine failure.
        Stores ``proposed`` and the pending carry like replan()."""
        prob = self._problem
        rules = tuple(tuple(prob.rules.get(si, ())) for si in range(prob.S))
        constraints = tuple(int(c) for c in prob.constraints)
        if prob.P == 0 or prob.N == 0 or prob.S == 0:
            self.proposed = self.current.copy()
            width = 2 * prob.S * max(self.current.shape[2], 1)
            empty = np.full((prob.P, width), -1, np.int32)
            return self.proposed, (empty, empty.copy(), empty.copy())

        rec = get_recorder()
        rec.count("plan.pipeline.calls")
        iters = max(int(self.opts.max_iterations), 1)
        mode = _tensor.resolve_default_fused_score(prob.P, prob.N,
                                                   self.device)

        carry, dirty_base = self._carries.consume(self._ckey, self.current)
        if carry is None:
            rec.count("plan.solve.carry_miss")
        result = None
        if carry is not None:
            dirty = effective_dirty(dirty_base, self.current,
                                    prob.constraints)
            if self._capacity_shrank(carry, dirty):
                rec.count("plan.solve.carry_miss")
            else:
                result = self._warm_pipeline(
                    carry, dirty, constraints, rules, mode, favor_min_nodes)
                if result is not None and \
                        self._audit_gate(prob, result[0]):
                    rec.count("plan.solve.warm_fallback")
                    result = None
                if result is not None:
                    rec.count("plan.solve.carry_hit")
                    rec.count("plan.pipeline.warm")

        if result is None:
            result = self._cold_pipeline(constraints, rules, iters, mode,
                                         favor_min_nodes)
        assign, new_carry, darrs = result
        maybe_validate(prob, assign, self.opts.validate_assignment,
                       "PlannerSession.replan_with_moves")
        self.proposed = assign
        self._carries.store_pending(self._ckey, new_carry)
        return assign, darrs

    def _warm_pipeline(
        self, carry: SolveCarry, dirty: NPArray, constraints: Constraints,
        rules: Rules, mode: str, favor_min_nodes: bool,
    ) -> Optional[tuple[Any, ...]]:
        """One warm pipeline run; None on decline or failure.  Returns
        (assign, next_carry, (d_nodes, d_states, d_ops)), the arrays off
        the device in one copy that also carries the acceptance flag."""
        rec = get_recorder()
        dirty_np, dirty_t = _tensor._dirty_mask(dirty, self.device)
        try:
            if self.mesh is not None:
                # solve_pipeline_sharded records dirty_fraction itself
                # (like solve_dense_sharded on the staged path).
                from ..parallel.sharded import solve_pipeline_sharded

                return solve_pipeline_sharded(
                    self.mesh, self.current, *self._problem_arrays(),
                    constraints, rules, favor_min_nodes=favor_min_nodes,
                    dirty=dirty_np, carry=carry, warm_only=True)
            rec.observe("plan.solve.dirty_fraction",
                        float(dirty_np.mean()) if dirty_np.size else 0.0)
            t0 = rec.now()
            with rec.span("plan.pipeline.dispatch", warm=True, engine=mode), \
                    _obs_device.entry("pipeline.warm"), _obs_device.measure(
                        "pipeline.warm",
                        f"{self.current.shape[0]}x"
                        f"{self._problem.node_weights.shape[0]}",
                        self.device, (dirty_t, carry.used)):
                args = self._solver_args()
                (out, prices, used, ok, d_nodes, d_states, d_ops, _packed,
                 _counts) = _tensor._pipeline_warm_impl(
                    *args, dirty_t, carry.used.to(self.device),
                    constraints, rules, fused_score=mode,
                    favor_min_nodes=favor_min_nodes)
                out_np, ok_np, *darrs = _tensor._fetch(
                    out, ok, d_nodes, d_states, d_ops)
            rec.observe("plan.pipeline.dispatch_s", rec.now() - t0)
            if not bool(ok_np):
                rec.count("plan.solve.warm_fallback")
                rec.count("plan.solve.sweeps", 1)  # the spent repair
                return None
            _tensor._record_sweeps(1)
            rec.set_attr("warm", True)
            return (out_np, SolveCarry(prices=prices, assign=out, used=used),
                    tuple(darrs))
        except (ValueError, TypeError):
            raise  # deterministic input errors: same on the cold path
        except Exception as e:
            import warnings as _warnings

            first = (str(e).splitlines() or [""])[0][:200]
            _warnings.warn(
                f"blance_tpu_torch PlannerSession.replan_with_moves: warm "
                f"pipeline failed ({type(e).__name__}: {first}); falling "
                f"back to a cold solve", UserWarning, stacklevel=3)
            rec.count("plan.solve.warm_fallback")
            return None

    def _cold_pipeline(
        self, constraints: Constraints, rules: Rules, iters: int,
        mode: str, favor_min_nodes: bool,
    ) -> tuple[Any, ...]:
        """Cold pipeline run (mesh-sharded when the session has a mesh);
        returns (assign, next_carry, diff arrays)."""
        prob = self._problem
        if self.mesh is not None:
            from ..parallel.sharded import solve_pipeline_sharded

            return solve_pipeline_sharded(
                self.mesh, self.current, *self._problem_arrays(),
                constraints, rules, max_iterations=iters,
                favor_min_nodes=favor_min_nodes)
        assign, _sweeps, new_carry, darrs, _packed = \
            _tensor._dispatch_pipeline_cold(
                self.current, prob.partition_weights, prob.node_weights,
                prob.valid_node, prob.stickiness, prob.gids,
                prob.gid_valid, constraints, rules, max_iterations=iters,
                fused_score=mode,
                allow_fallback=_tensor._FUSED_SCORE_DEFAULT == "auto",
                favor_min_nodes=favor_min_nodes, device=self.device,
                entry="pipeline.cold")
        return assign, new_carry, darrs

    def moves(
        self, favor_min_nodes: bool = False
    ) -> tuple[NPArray, NPArray, NPArray]:
        """Diff current -> proposed on the session's device: (nodes,
        states, ops) as [P, L] int32 arrays with -1 padding (see
        moves/batch.py for codes).  Row i is partition
        ``self.problem.partitions[i]``."""
        from ..moves.batch import diff_assignments

        if self.proposed is None:
            raise ValueError("no proposed assignment; call replan() first")
        r = max(self.current.shape[2], self.proposed.shape[2])

        def widen(a):
            if a.shape[2] != r:
                pad = np.full(a.shape[:2] + (r - a.shape[2],), -1, np.int32)
                a = np.concatenate([a, pad], axis=2)
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        d_nodes, d_states, d_ops = diff_assignments(
            widen(self.current), widen(self.proposed),
            favor_min_nodes=favor_min_nodes)
        return (d_nodes.cpu().numpy(), d_states.cpu().numpy(),
                d_ops.cpu().numpy())

    def apply(self) -> None:
        """Adopt the proposed assignment as current (the app moved the
        data), promote the solve's carry to the warm-start state and
        retire the dirty marks the adopted solve absorbed; marks of
        deltas recorded after that solve carry forward."""
        if self.proposed is None:
            raise ValueError("no proposed assignment; call replan() first")
        self.current = self.proposed
        self.proposed = None
        self._carries.promote(self._ckey, self.current)
