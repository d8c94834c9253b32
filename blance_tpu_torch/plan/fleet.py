# Port of blance_tpu/plan/fleet.py.  The reference runs its per-tenant
# solve under jax.vmap; here the batch axis is explicit: the dense solver
# of plan/tensor.py takes [B, ...] arrays and keeps every element's
# arithmetic the single problem's.  With a 1-D port Mesh the batch axis
# shards over the mesh's ranks (parallel/mesh.py shard_map, no collective).
"""Fleet-scale multi-tenant batch planning: batched bucket-class solves.

Production deployments (cbgt/FTS-style) rebalance hundreds of tenant
*indexes* concurrently — each its own small, independent planning
problem.  Solved one at a time on the card, every tenant pays the
auction's host-synced round loop (one exit-flag read per round); this
module is the batch tier:

- tenants are admitted as :class:`TenantProblem`\\ s and grouped into
  **batch classes**: the shape buckets (core/encode.py ``bucket_size``)
  on (P, N) plus the solver statics (S, R, constraints, rules);
- each class stacks its tenants' padded arrays into ``[B, P, S, R]`` /
  ``[B, S, N]`` batch tensors (core/encode.py ``pad_problem_arrays`` +
  ``stack_problem_arrays`` — the inert-padding contract of the bucketed
  single-problem path) and runs the dense auction over the batch axis:
  one round loop per class, each element's result bitwise its single
  bucketed solve's.  The round loop runs while any element runs, and
  an element that stopped keeps its state (``vmap``'s loop rule);
- warm tenants (a caller-provided :class:`plan.tensor.SolveCarry` +
  dirty mask, typically via a :class:`plan.carry.CarryCache`) run the
  one-sweep carry-seeded repair over the batch, with the same
  per-element acceptance flags as ``solve_dense_warm``; declined
  elements fall back into the class's cold batch.

The per-element arithmetic is exactly the single-problem bucketed
path's: padded shapes, the real partition count threaded as the
``p_real`` fill denominator.  The sequential reference for every fleet
solve is therefore ``solve_dense_converged`` / ``solve_dense_warm`` on
the same padded arrays — and the results match those bit-for-bit.

The asyncio front door (request coalescing, backpressure, per-tenant
carry cache) lives in plan/service.py; this module is the synchronous
compute core.  It solves on ``device`` ("cuda" unless the caller passes
the CPU, where the kernels run their plain versions); with a 1-D port
``Mesh`` each class's batch axis is sharded over the mesh's ranks —
tenant solves are independent, so this is pure data parallelism with no
collective, and each element's result is still its single solve's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..convert import resolve_device
from ..core.encode import (
    DenseProblem,
    NPArray,
    bucket_size,
    pad_problem_arrays,
    pad_to,
    stack_problem_arrays,
)
from ..obs import device as _device
from ..obs import counting_to, get_recorder
from .carry import capacity_shrank, effective_dirty
from .tensor import (
    Constraints,
    Rules,
    SolveCarry,
    _check_tier_band_scale,
    _solve_dense_converged_impl,
    _used_by_state,
    _warm_repair,
    resolve_default_fused_score,
    resolve_fused_score,
)

__all__ = ["TenantProblem", "BatchClass", "FleetResult", "batch_class_of",
           "validate_tenant", "solve_fleet", "FLEET_AXIS"]

# The reference's default mesh axis name for batch sharding (any 1-D
# mesh works: the axis carries no collective).
FLEET_AXIS = "fleet"


class BatchClass(NamedTuple):
    """One batch-shape equivalence class of tenant problems."""

    p: int  # bucketed partition count (bucket_size(P_real))
    n: int  # bucketed node count (bucket_size(N_real))
    s: int  # states
    r: int  # slot depth
    levels: int  # hierarchy levels (gids rows)
    constraints: tuple[int, ...]
    rules: tuple[tuple[tuple[int, int], ...], ...]


@dataclass(frozen=True)
class TenantProblem:
    """One tenant's dense planning problem, ready to batch.

    Arrays follow plan/tensor.py solve_dense's positional layout, as
    host numpy arrays.  The optional ``carry``/``dirty`` pair requests
    the warm path: ``carry`` must match ``prev`` exactly (the
    solve_dense_warm contract — the CarryCache's consume() validates
    this for service callers) and ``dirty`` marks the partitions the
    delta since the carry may move."""

    key: str
    prev: NPArray  # [P, S, R] int32, -1 empty
    partition_weights: NPArray  # [P] float32
    node_weights: NPArray  # [N] float32
    valid_node: NPArray  # [N] bool
    stickiness: NPArray  # [P, S] float32
    gids: NPArray  # [L, N] int32
    gid_valid: NPArray  # [L, N] bool
    constraints: tuple[int, ...]
    rules: tuple[tuple[tuple[int, int], ...], ...]
    carry: Optional[SolveCarry] = None
    dirty: Optional[NPArray] = None

    @classmethod
    def from_dense(cls, key: str, problem: DenseProblem,
                   carry: Optional[SolveCarry] = None,
                   dirty: Optional[NPArray] = None,
                   prev: Optional[NPArray] = None) -> "TenantProblem":
        """Wrap an encoded DenseProblem (``prev`` overrides the encode-
        time seed — pass a session's live ``current``)."""
        return cls(
            key=key,
            prev=np.asarray(problem.prev if prev is None else prev,
                            np.int32),
            partition_weights=np.asarray(problem.partition_weights,
                                         np.float32),
            node_weights=np.asarray(problem.node_weights, np.float32),
            valid_node=np.asarray(problem.valid_node, bool),
            stickiness=np.asarray(problem.stickiness, np.float32),
            gids=np.asarray(problem.gids, np.int32),
            gid_valid=np.asarray(problem.gid_valid, bool),
            constraints=tuple(int(c) for c in problem.constraints),
            rules=tuple(tuple(problem.rules.get(si, ()))
                        for si in range(problem.S)),
            carry=carry,
            dirty=dirty,
        )


@dataclass
class FleetResult:
    """One tenant's solve outcome (arrays at the REAL, unpadded shape)."""

    key: str
    assign: NPArray  # [P, S, R] int32
    carry: Optional[SolveCarry]  # rebuilt warm-start state, real-N used
    warm: bool  # solved by an accepted one-sweep repair
    sweeps: int  # converged-loop passes executed
    klass: Optional[BatchClass]  # None for degenerate (empty) problems


def batch_class_of(t: TenantProblem) -> BatchClass:
    """The tenant's batch class: bucketed shape + solver statics."""
    p, s, r = t.prev.shape
    n = t.node_weights.shape[0]
    return BatchClass(
        p=bucket_size(p), n=bucket_size(n), s=s, r=r,
        levels=t.gids.shape[0],
        constraints=tuple(int(c) for c in t.constraints),
        rules=tuple(tuple(rl) for rl in t.rules))


def validate_tenant(t: TenantProblem) -> None:
    """Raise ValueError when one tenant's problem cannot be solved —
    the per-tenant preconditions the single-problem entry points check,
    plus cross-array shape consistency (a malformed array would
    otherwise only explode inside the batched solve).  solve_fleet runs
    this for every admitted tenant (a raise fails the whole call); the
    plan service runs it per request BEFORE batching, so one tenant's
    bad arrays fail that request alone instead of its co-batched
    neighbors."""
    prev = np.asarray(t.prev)
    if prev.ndim != 3:
        raise ValueError(
            f"tenant {t.key!r}: prev must be [P, S, R], got shape "
            f"{prev.shape}")
    p, s, r = prev.shape
    n = np.asarray(t.node_weights).shape[0]
    shapes = {
        "partition_weights": (np.asarray(t.partition_weights).shape,
                              (p,)),
        "stickiness": (np.asarray(t.stickiness).shape, (p, s)),
        "valid_node": (np.asarray(t.valid_node).shape, (n,)),
        "gids": (np.asarray(t.gids).shape[-1:], (n,)),
        "gid_valid": (np.asarray(t.gid_valid).shape,
                      np.asarray(t.gids).shape),
    }
    if t.dirty is not None:
        shapes["dirty"] = (np.asarray(t.dirty).shape, (p,))
    for name, (got, want) in shapes.items():
        if tuple(got) != tuple(want):
            raise ValueError(
                f"tenant {t.key!r}: {name} shape {tuple(got)} does not "
                f"match prev/nodes (want {tuple(want)})")
    if t.constraints and max(t.constraints) > r:
        raise ValueError(
            f"tenant {t.key!r}: prev slot depth R={r} "
            f"< max constraints {max(t.constraints)}")
    # Host-side guard parity with the single-problem entry points.
    _check_tier_band_scale(
        t.prev, t.partition_weights, t.node_weights, t.valid_node,
        t.stickiness, t.constraints, t.rules)


# -- batched solves ----------------------------------------------------------
#
# The per-element body is the SAME code as the single-problem path —
# _solve_dense_converged_impl / _warm_repair with the p_real fill
# denominator — run over the batch axis, so per-element outputs are
# bitwise single solves (tests/test_torch_fleet.py pins this, cold and
# warm).


def _fleet_cold_batch(prev, pweights, nweights, valid, stickiness, gids,
                      gid_valid, p_real, constraints: Constraints,
                      rules: Rules, max_iterations: int = 10,
                      fused_score: str = "off"):
    """Batched cold fixpoint: (assign[B,P,S,R], sweeps[B], used[B,S,N]).

    ``used`` is each element's carry table (_used_by_state, the scatter
    the single-problem carry_from_assignment runs), so the next warm
    solve seeds bitwise."""
    out, sweeps = _solve_dense_converged_impl(
        prev, pweights, nweights, valid, stickiness, gids, gid_valid,
        constraints, rules, max_iterations=max_iterations,
        fused_score=fused_score, p_real=p_real)
    used = _used_by_state(out, pweights, nweights.shape[-1], out.shape[-2])
    return out, sweeps, used


def _fleet_warm_batch(prev, pweights, nweights, valid, stickiness, gids,
                      gid_valid, dirty, carry_used, p_real,
                      constraints: Constraints, rules: Rules,
                      fused_score: str = "off"):
    """Batched one-sweep warm repair: (assign, used, ok) per element."""
    return _warm_repair(prev, pweights, nweights, valid, stickiness, gids,
                        gid_valid, dirty, carry_used, constraints, rules,
                        fused_score=fused_score, p_real=p_real)


# -- host orchestration ------------------------------------------------------


def _host(x: Any) -> NPArray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _normalized(t: TenantProblem) -> TenantProblem:
    """Dtype-normalize a tenant's arrays (solver dtypes, C-contiguous)."""
    return TenantProblem(
        key=t.key,
        prev=np.ascontiguousarray(t.prev, np.int32),
        partition_weights=np.ascontiguousarray(t.partition_weights,
                                               np.float32),
        node_weights=np.ascontiguousarray(t.node_weights, np.float32),
        valid_node=np.ascontiguousarray(t.valid_node, bool),
        stickiness=np.ascontiguousarray(t.stickiness, np.float32),
        gids=np.ascontiguousarray(t.gids, np.int32),
        gid_valid=np.ascontiguousarray(t.gid_valid, bool),
        constraints=tuple(int(c) for c in t.constraints),
        rules=tuple(tuple(rl) for rl in t.rules),
        carry=t.carry,
        dirty=None if t.dirty is None
        else np.ascontiguousarray(t.dirty, bool),
    )


def _padded_solver_arrays(t: TenantProblem,
                          k: BatchClass) -> tuple[NPArray, ...]:
    """One tenant's arrays padded to its class shape (inert padding)."""
    return pad_problem_arrays(
        t.prev, t.partition_weights, t.node_weights, t.valid_node,
        t.stickiness, t.gids, t.gid_valid, k.p, k.n)


def _warm_eligible(t: TenantProblem, rec, record: bool
                   ) -> Optional[tuple[NPArray, NPArray]]:
    """(effective dirty mask, the carry's host ``used`` table) when the
    warm path may run, else None (demoted to cold).  Mirrors
    PlannerSession.replan's gating: a carry + dirty mask must be
    present, the carry must match prev's shape, and the host capacity
    precheck must not predict a clean-holder displacement (which the
    repair could never accept)."""
    if t.carry is None or t.dirty is None:
        return None
    used = _host(t.carry.used)
    if tuple(t.carry.assign.shape) != t.prev.shape or \
            used.shape != (t.prev.shape[1], t.node_weights.shape[0]):
        if record:
            rec.count("plan.solve.carry_miss")
        return None
    dirty = effective_dirty(t.dirty, t.prev, t.constraints)
    if capacity_shrank(torch.from_numpy(np.asarray(used)), t.prev,
                       t.partition_weights, t.node_weights, t.valid_node,
                       t.constraints, dirty):
        # Grown cluster: the trim pass would displace clean holders —
        # the repair could never be accepted, so skip straight to cold
        # instead of wasting a sweep (PlannerSession parity).
        if record:
            rec.count("plan.solve.carry_miss")
        return None
    return dirty, used


def _pad_batch(stacked: Sequence[NPArray],
               b_target: int) -> tuple[list[NPArray], int]:
    """Pad the batch axis to ``b_target`` by replicating the last
    element (a real problem solves to a real answer, discarded) —
    returns (padded arrays, padded B)."""
    b = stacked[0].shape[0]
    if b_target <= b:
        return list(stacked), b
    reps = np.full(b_target - b, b - 1, np.intp)
    return [np.concatenate([a, a[reps]]) for a in stacked], b_target


# Mesh-sharded dispatchers, bound per (mesh, statics) and cached with
# the reference's LRU bound.  The port compiles nothing per shape, so
# the cache only saves rebuilding the binding; it is kept so that the
# hot classes of a long-lived service resolve their dispatch once.
_MESH_FN_CACHE: dict[tuple[object, ...], Any] = {}
_MESH_FN_CACHE_MAX = 128


def _mesh_callable(mesh, warm: bool, constraints: Constraints, rules: Rules,
                   max_iterations: int, fused_score: str):
    """The fleet batch body shard_map'd over ``mesh`` (1-D): every
    operand's and output's leading (batch) axis is sharded over the
    ranks and nothing is replicated — tenant solves are independent, so
    no collective rides the mesh."""
    from ..parallel import sharded as _sh

    key = (mesh, warm, constraints, rules, max_iterations, fused_score)
    fn = _MESH_FN_CACHE.get(key)
    if fn is not None:
        # Move-to-end: insertion order doubles as LRU recency.
        _MESH_FN_CACHE[key] = _MESH_FN_CACHE.pop(key)
        return fn
    _sh.check_mesh(mesh, "solve_fleet", one_d=True)
    statics = dict(constraints=constraints, rules=rules,
                   fused_score=fused_score)
    if warm:
        body, lay_in, lay_out = ("fleet.warm", _sh.FLEET_WARM_IN_LAYOUT,
                                 _sh.FLEET_WARM_OUT_LAYOUT)
    else:
        body, lay_in, lay_out = ("fleet.cold", _sh.FLEET_COLD_IN_LAYOUT,
                                 _sh.FLEET_COLD_OUT_LAYOUT)
        statics["max_iterations"] = max_iterations

    def fn(*args):
        return mesh.shard_map(body, args, lay_in, lay_out, **statics)
    while len(_MESH_FN_CACHE) >= _MESH_FN_CACHE_MAX:
        # Evict the least-recently-used binding only.
        _MESH_FN_CACHE.pop(next(iter(_MESH_FN_CACHE)))
    _MESH_FN_CACHE[key] = fn
    return fn


def _dispatch(fn_args: list[NPArray], warm: bool, k: BatchClass,
              max_iterations: int, fused_score: str, rec, record: bool,
              device: torch.device, batch_floor: int = 1,
              mesh=None) -> tuple[torch.Tensor, ...]:
    """Run one class batch on ``device`` (mesh-sharded when given);
    returns its outputs as tensors there, batch padding stripped.

    B pads up to ``bucket_size(max(B, batch_floor))`` (and to mesh
    divisibility) by replicating the last element, as the reference pads
    its batch axis for its compile cache.  The port compiles nothing per
    shape, so the padding only costs device work; it is kept so that
    ``fleet.batch_occupancy`` and ``fleet.h2d_bytes`` read as the
    reference's."""
    b_real = fn_args[0].shape[0]
    b_target = bucket_size(max(b_real, batch_floor))
    ent = "fleet.warm" if warm else "fleet.cold"
    if mesh is not None:
        b_target += (-b_target) % mesh.size
    fn_args, b_padded = _pad_batch(fn_args, b_target)
    statics = dict(constraints=k.constraints, rules=k.rules,
                   fused_score=fused_score)
    # The solver's own counts (rounds, host syncs) go where the fleet's
    # do, and nowhere when it records nothing.
    counts = counting_to(rec if record else None)
    if mesh is not None:
        fn = _mesh_callable(mesh, warm, k.constraints, k.rules,
                            max_iterations, fused_score)
        with _device.entry(ent), counts:
            outs = fn(*fn_args)
    else:
        dev_args = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                    for a in fn_args]
        with _device.entry(ent), _device.measure(
                ent, f"{k.p}x{k.n}xB{b_padded}", device, dev_args), counts:
            if warm:
                outs = _fleet_warm_batch(*dev_args, **statics)
            else:
                outs = _fleet_cold_batch(*dev_args,
                                         max_iterations=max_iterations,
                                         **statics)
    if record:
        rec.observe("fleet.batch_tenants", float(b_real))
        rec.observe("fleet.batch_occupancy",
                    b_real / b_padded if b_padded else 0.0)
        # Host->device transfer accounting: the stacked batch arrays
        # this dispatch ships (a pure function of the batch's shapes).
        rec.count("fleet.h2d_bytes",
                  sum(int(np.asarray(a).nbytes) for a in fn_args))
    return tuple(o[:b_real] for o in outs)


def _count_solve(rec, sweeps: int) -> None:
    """One solved element's plan.solve.* accounting — the
    tensor._record_sweeps spelling, routed to THIS recorder (the
    executor-thread path must not fall back to the process global)."""
    rec.count("plan.solve.calls")
    rec.count("plan.solve.sweeps", sweeps)
    rec.observe("plan.solve.sweeps", sweeps)


def _real_carry(assign: torch.Tensor, used_padded: torch.Tensor,
                n_real: int) -> SolveCarry:
    """Strip node padding off a batched element's carry table.  Pad
    columns are invalid nodes with zero fill (inert-padding contract),
    so the slice is exact; prices re-derive as the per-node sum.  Both
    tensors are COPIED off the batch tensors (``clone``): a view would
    pin the whole [B, ...] batch tensor alive per tenant while
    CarryCache's byte accounting sees only the slice."""
    used = used_padded[:, :n_real].clone()
    return SolveCarry(prices=used.sum(dim=0), assign=assign.clone(),
                      used=used)


def _trace_attrs(trace_ids: Optional[dict[str, str]],
                 keys: Sequence[str]) -> dict[str, str]:
    """Span attrs carrying the batch members' trace ids (capped: a
    thousand-tenant batch must not serialize a novel per span)."""
    if not trace_ids:
        return {}
    ids = [str(trace_ids[k]) for k in keys if k in trace_ids]
    if not ids:
        return {}
    shown = ",".join(ids[:16])
    if len(ids) > 16:
        shown += f",+{len(ids) - 16}"
    return {"trace_ids": shown}


def solve_fleet(
    problems: Sequence[TenantProblem],
    *,
    mesh=None,
    max_iterations: int = 10,
    fused_score: Optional[str] = None,
    record: bool = True,
    recorder=None,
    trace_ids: Optional[dict[str, str]] = None,
    batch_floor: int = 1,
    device: Any = "cuda",
) -> list[FleetResult]:
    """Solve every tenant, batched by bucket class: one batched solve per
    (class, warm/cold) instead of one per tenant.

    Results are returned in input order, each bitwise equal to running
    that tenant through the single-problem path on the same padded
    arrays (``solve_dense_converged`` / ``solve_dense_warm`` with the
    class shape and the tenant's real-P fill denominator).  Tenants
    with a ``carry`` + ``dirty`` pair attempt the one-sweep warm repair
    first; declined elements (ripple / fresh over-capacity — the same
    per-element flags the single warm path checks) fall back into the
    class's cold batch, exactly like a session's warm decline.

    ``fused_score`` None resolves the module default per class shape
    (P, N), like every other solve entry point; the matrix engine's
    working set grows with B on top of that.  ``device`` is where the
    batches solve ("cuda" unless the caller passes the CPU); ``mesh``, a
    1-D port Mesh, shards each class's batch axis over its ranks (pure
    data parallelism, results unchanged) and the batches then solve on
    its ranks' devices, ``device`` ignored.

    obs: per-batch ``fleet.batch_tenants`` / ``fleet.batch_occupancy``
    histograms and a ``fleet.dispatch`` span per batched solve with the
    ``fleet.dispatch_s`` histogram; per-tenant ``plan.solve.*``
    carry/sweep counters mirror the single-problem spellings.
    ``recorder`` overrides the process recorder (the plan service
    passes its own so executor-thread solves report to the right one).
    ``trace_ids`` (tenant key -> trace id) rides into each
    ``fleet.dispatch`` span's attrs.
    """
    if mesh is not None:
        from ..parallel.sharded import check_mesh

        check_mesh(mesh, "solve_fleet", one_d=True)
        dev = mesh.device
    else:
        dev = resolve_device(device, "solve_fleet")
    rec = recorder if recorder is not None else get_recorder()
    results: dict[int, FleetResult] = {}
    tenants = [_normalized(t) for t in problems]

    by_class: dict[BatchClass, list[int]] = {}
    for i, t in enumerate(tenants):
        # Validate FIRST: a malformed prev must surface as the keyed
        # per-tenant diagnostic, not an opaque shape-unpack error.
        validate_tenant(t)
        p, s, _r = t.prev.shape
        n = t.node_weights.shape[0]
        if p == 0 or n == 0 or s == 0:
            # Degenerate problem: nothing to place (PlannerSession
            # returns current unchanged for these).
            results[i] = FleetResult(
                key=t.key, assign=t.prev.copy(), carry=None, warm=False,
                sweeps=0, klass=None)
            continue
        by_class.setdefault(batch_class_of(t), []).append(i)

    for k, idxs in by_class.items():
        mode = fused_score
        if mode is None:
            mode = resolve_default_fused_score(k.p, k.n, dev)
        else:
            mode = resolve_fused_score(mode, k.p, k.n, dev)

        warm_idx: list[int] = []
        warm_in: dict[int, tuple[NPArray, NPArray]] = {}
        cold_idx: list[int] = []
        for i in idxs:
            eligible = _warm_eligible(tenants[i], rec, record)
            if eligible is None:
                cold_idx.append(i)
            else:
                warm_idx.append(i)
                warm_in[i] = eligible

        if warm_idx:
            batch = []
            for i in warm_idx:
                t = tenants[i]
                dirty, used = warm_in[i]
                arrs = _padded_solver_arrays(t, k)
                # Pad rows are marked dirty (their synthetic assignments
                # must not read as a ripple) and the carry table's pad
                # columns are zero-fill.
                dirty_p = pad_to(dirty, 0, k.p, True)
                cu = pad_to(np.asarray(used, np.float32), 1, k.n, 0.0)
                batch.append(arrs + (dirty_p, cu,
                                     np.float32(t.prev.shape[0])))
                if record:
                    rec.observe(
                        "plan.solve.dirty_fraction",
                        float(dirty.mean()) if dirty.size else 0.0)
            stacked = list(stack_problem_arrays(batch))
            t0 = rec.now()
            with rec.span("fleet.dispatch", warm=True,
                          tenants=len(warm_idx),
                          klass=f"{k.p}x{k.n}",
                          **_trace_attrs(trace_ids,
                                         [tenants[i].key
                                          for i in warm_idx])):
                out_b, used_b, ok_b = _dispatch(
                    stacked, True, k, max_iterations, mode, rec, record,
                    dev, batch_floor=batch_floor, mesh=mesh)
                out_np = out_b.cpu().numpy()
                ok_np = ok_b.cpu().numpy()
            if record:
                rec.observe("fleet.dispatch_s", rec.now() - t0)
                rec.count("fleet.batches")
            for j, i in enumerate(warm_idx):
                t = tenants[i]
                if bool(ok_np[j]):
                    p_real = t.prev.shape[0]
                    n_real = t.node_weights.shape[0]
                    # Copy off the batch array: a view per tenant would
                    # pin the whole [B, P, S, R] array alive.
                    assign = out_np[j][:p_real].copy()
                    if record:
                        _count_solve(rec, 1)
                        rec.count("plan.solve.carry_hit")
                    results[i] = FleetResult(
                        key=t.key, assign=assign,
                        carry=_real_carry(out_b[j, :p_real], used_b[j],
                                          n_real),
                        warm=True, sweeps=1, klass=k)
                else:
                    # Declined repair: same accounting as
                    # solve_dense_warm's decline, then the cold batch
                    # picks the tenant up.
                    if record:
                        rec.count("plan.solve.warm_fallback")
                        rec.count("plan.solve.sweeps", 1)
                    cold_idx.append(i)

        if cold_idx:
            batch = []
            for i in cold_idx:
                t = tenants[i]
                arrs = _padded_solver_arrays(t, k)
                batch.append(arrs + (np.float32(t.prev.shape[0]),))
            stacked = list(stack_problem_arrays(batch))
            t0 = rec.now()
            with rec.span("fleet.dispatch", warm=False,
                          tenants=len(cold_idx),
                          klass=f"{k.p}x{k.n}",
                          **_trace_attrs(trace_ids,
                                         [tenants[i].key
                                          for i in cold_idx])):
                out_b, sweeps_b, used_b = _dispatch(
                    stacked, False, k, max_iterations, mode, rec, record,
                    dev, batch_floor=batch_floor, mesh=mesh)
                out_np = out_b.cpu().numpy()
                sweeps_np = sweeps_b.cpu().numpy()
            if record:
                rec.observe("fleet.dispatch_s", rec.now() - t0)
                rec.count("fleet.batches")
            for j, i in enumerate(cold_idx):
                t = tenants[i]
                p_real = t.prev.shape[0]
                n_real = t.node_weights.shape[0]
                assign = out_np[j][:p_real].copy()
                if record:
                    _count_solve(rec, int(sweeps_np[j]))
                results[i] = FleetResult(
                    key=t.key, assign=assign,
                    carry=_real_carry(out_b[j, :p_real], used_b[j], n_real),
                    warm=False, sweeps=int(sweeps_np[j]), klass=k)

    return [results[i] for i in range(len(tenants))]
