# Port of blance_tpu/analysis/shape_audit.py: the same contract table, its
# 12 sharded contracts included, each contract run on a small concrete
# problem on the audit's device, and the same four host checks.
"""Shape audit: the solver's [P, S, N, R] contracts, enforced.

The dense solver's shape conventions — assign[P, S, R] int32 with -1
empties, carry.used[S, N] float32, prices[N], the bucketed-pad layouts —
live in docstrings and comments; nothing fails when an entry point
drifts.  This module pins them in a declarative contract table: every
public solver entry point runs across a (P, S, N, R) x bucketing x carry
matrix, and the shapes and dtypes of what it returns are compared with
the table's.

The reference checks its table with ``jax.eval_shape``: zero FLOPs.  The
port cannot: its solvers read a scalar back in every sweep and every
auction round (the fixpoint's changed flag, the round's progress test),
and a ``bool()`` of a ``meta`` or fake tensor raises.  So each contract
runs for real, on small concrete arrays made from
``numpy.random.default_rng(seed)`` on the audit's device — milliseconds
per contract at P <= 24 — and on the card it launches the same kernels
the entry point launches in production (min2 for the dense, pipeline and
fleet contracts, the sparse kernel for the sparse ones).  Its output's
torch dtypes are named as numpy names for the comparison; a host scalar
the port keeps as a Python value (a sweep count, an acceptance flag that
stays a Python bool) reads as a 0-d ``int32`` / ``bool``, the
reference's type for the same output.

Covered entry points (the reference's):

- ``solve_dense``            — cold, carry-seeded, bucketed, bucketed+carry
- ``solve_dense_converged``  — via ``_solve_dense_converged_impl`` (the
  public wrapper adds host-side recording only), cold + carry
- ``solve_dense_warm``       — via ``_warm_repair`` (the public wrapper
  adds host gates around exactly this core)
- fleet batch solves         — ``plan.fleet._fleet_cold_batch`` /
  ``_fleet_warm_batch``, the batched bucket-class programs the
  multi-tenant tier dispatches (stacked ``[B, ...]`` layouts)
- fused plan pipeline        — ``plan.tensor._pipeline_cold_impl`` /
  ``_pipeline_warm_impl`` (cold/carry/bucketed/warm: solve→diff→pack)
- sparse shortlist solve     — ``plan.tensor._solve_sparse_converged_impl``
  (cold + carry: (assign, sweeps, exhausted)), ``_warm_repair_sparse``
  ((assign, used, ok, exhausted)), the shortlist builder
  (``core.shortlist.build_shortlist_core``: [P, K] int32, saturating
  K -> [P, N]), and a concrete host-side check of the per-row dense
  exhaustion fallback (fills flagged rows audit-clean)
- carry construction         — ``carry_from_assignment`` (its ``used``)
- sharded solves             — ``solve_dense_sharded``,
  ``solve_sparse_sharded`` and the sharded plan pipeline (cold, warm):
  the bodies ``Mesh.shard_map`` runs, dispatched with the layout tables
  of parallel/sharded.py (the same rows the runtime dispatch uses, so
  the audited layout cannot drift from the dispatched one) on a
  ``_AUDIT_RANKS``-rank mesh of the audit's device, started once per
  audit run and closed after it
- ``encode_problem`` / ``decode_assignment`` — dense-encoding dtypes and
  the decode round trip (tiny concrete problem; host-only, milliseconds)
- ``bucket_size`` / ``pad_to`` — the bucketing algebra (monotone, >= x,
  bounded overhead)
- the scheduler's rank sweep  — ``orchestrate.sched.ranks.rank_levels``

Failures surface as findings: SHP001 (shape/dtype mismatch), SHP002
(entry point raised on its audit problem), SHP003 (host-side contract
violation).  Add a new entry point by appending to CONTRACTS — the table
IS the documentation of the contract.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

from . import Finding

__all__ = ["run_shape_audit", "CONTRACTS", "HOST_CHECKS", "Dims"]

_PATH = "blance_tpu_torch/analysis/shape_audit.py"


class Dims(NamedTuple):
    """One point in the audit matrix."""

    P: int
    S: int
    N: int
    R: int
    L: int = 1  # hierarchy levels (gids rows)

    @property
    def constraints(self) -> tuple[int, ...]:
        # Full-depth slots for every state; max(constraints) == R by
        # construction, the solver's own validity precondition.
        return (self.R,) * self.S

    @property
    def rules(self) -> tuple[tuple[tuple[int, int], ...], ...]:
        # One (include, exclude) rule on the last state when there is
        # more than one hierarchy level, else rule-free.
        if self.L < 2 or self.S < 2:
            return ((),) * self.S
        return ((),) * (self.S - 1) + (((1, 0),),)


@dataclass(frozen=True)
class ShapeContract:
    """One declarative entry-point contract.

    ``build(device)`` returns (callable, args, kwargs) with the array
    arguments as tensors on ``device``; ``expect()`` returns the expected
    output as a tree of (shape, dtype) pairs.  The runner calls the
    callable and compares structurally."""

    entry: str  # reported entry-point name
    variant: str  # "cold" / "carry" / "bucketed" / ...
    build: Callable[..., object]
    expect: Callable[..., object]


# -- concrete audit problems --------------------------------------------------


def _host_problem(d: Dims, seed: int):
    """One placement problem of shape ``d`` as numpy arrays, in the
    solver's positional order (prev, pweights, nweights, valid,
    stickiness, gids, gid_valid): every row holds distinct nodes with a
    few empty slots, one node is removed where the others still cover
    every slot, and the hierarchy levels are nodes and node pairs."""
    import numpy as np

    rng = np.random.default_rng(seed)
    slots = d.S * d.R
    prev = np.stack([rng.permutation(d.N)[:slots] for _ in range(d.P)])
    prev = prev.astype(np.int32).reshape(d.P, d.S, d.R)
    prev[rng.random(prev.shape) < 0.1] = -1
    pweights = rng.integers(1, 3, d.P).astype(np.float32)
    nweights = np.ones(d.N, np.float32)
    valid = np.ones(d.N, bool)
    if d.N > slots:
        valid[d.N - 1] = False
    stickiness = np.full((d.P, d.S), 1.5, np.float32)
    levels = np.stack([np.arange(d.N), np.arange(d.N) // 2])
    gids = levels[:d.L].astype(np.int32)
    gid_valid = np.ones((d.L, d.N), bool)
    return prev, pweights, nweights, valid, stickiness, gids, gid_valid


def _host_padded(d: Dims, seed: int):
    """The problem of shape ``d`` padded inertly to its bucketed shape
    (core.encode.pad_problem_arrays, as the bucketed paths pad)."""
    from ..core.encode import pad_problem_arrays

    db = _bucketed_dims(d)
    return pad_problem_arrays(*_host_problem(d, seed), db.P, db.N)


def _dev(device, *arrays):
    import torch

    return tuple(torch.from_numpy(a.copy()).to(device) for a in arrays)


def _solver_args(d: Dims, device, seed: int = 0):
    """The seven positional array args every solver entry shares."""
    return _dev(device, *_host_problem(d, seed))


def _carry_used_of(assign, pweights, nweights):
    """carry_from_assignment's ``used`` table (the reference's
    _carry_used_jit output): the carry that matches ``assign``."""
    from ..plan.tensor import carry_from_assignment

    return carry_from_assignment(assign, pweights, nweights).used


def _dirty(d: Dims, device, seed: int = 0):
    import numpy as np

    rng = np.random.default_rng(seed + 1)
    return _dev(device, rng.random(d.P) < 0.25)[0]


def _p_real(p: int, device):
    import torch

    return torch.tensor(float(p), dtype=torch.float32, device=device)


def _expect_assign(d: Dims):
    import numpy as np

    return ((d.P, d.S, d.R), np.int32)


def _expect_used(d: Dims):
    import numpy as np

    return ((d.S, d.N), np.float32)


# -- builders ---------------------------------------------------------------


def _build_solve_dense(d: Dims, device, carry: bool = False,
                       bucketed: bool = False):
    from ..plan.tensor import solve_dense

    if bucketed:
        db = _bucketed_dims(d)
        args = _dev(device, *_host_padded(d, 0))
    else:
        db, args = d, _solver_args(d, device)
    kwargs: dict[str, Any] = {"constraints": db.constraints,
                              "rules": db.rules, "fused_score": "off"}
    if carry:
        kwargs["carry_used"] = _carry_used_of(*args[:3])
    if bucketed:
        # Bucketed solves take the REAL partition count as a 0-d tensor,
        # the reference's traced scalar operand.
        kwargs["p_real"] = _p_real(d.P, device)
    return solve_dense, args, kwargs


def _build_converged(d: Dims, device, carry: bool = False):
    from ..plan.tensor import _solve_dense_converged_impl

    args = _solver_args(d, device)
    kwargs: dict[str, Any] = {"constraints": d.constraints,
                              "rules": d.rules, "fused_score": "off",
                              "max_iterations": 4}
    if carry:
        kwargs["carry_used"] = _carry_used_of(*args[:3])
    return _solve_dense_converged_impl, args, kwargs


def _build_warm(d: Dims, device):
    from ..plan.tensor import _warm_repair

    args = _solver_args(d, device)
    args = args + (_dirty(d, device), _carry_used_of(*args[:3]))
    return _warm_repair, args, {"constraints": d.constraints,
                                "rules": d.rules, "fused_score": "off"}


def _build_carry_used(d: Dims, device):
    args = _solver_args(d, device)
    return _carry_used_of, args[:3], {}


def _diff_len(d: Dims) -> int:
    """The device move-diff's padded op-list length (moves/batch.py)."""
    return 2 * d.S * d.R


def _expect_pipeline_cold(d: Dims):
    import numpy as np

    L = _diff_len(d)
    return (
        _expect_assign(d),  # assign
        ((), "int32"),  # sweeps
        ((d.N,), np.float32),  # prices
        _expect_used(d),  # used
        ((d.P, L), np.int32),  # d_nodes
        ((d.P, L), np.int32),  # d_states
        ((d.P, L), np.int32),  # d_ops
        _expect_assign(d),  # packed
        ((d.P, d.S), np.int32),  # counts
    )


def _expect_pipeline_warm(d: Dims):
    import numpy as np

    L = _diff_len(d)
    return (
        _expect_assign(d),
        ((d.N,), np.float32),  # prices
        _expect_used(d),
        ((), "bool"),  # ok
        ((d.P, L), np.int32),
        ((d.P, L), np.int32),
        ((d.P, L), np.int32),
        _expect_assign(d),
        ((d.P, d.S), np.int32),
    )


def _build_pipeline_cold(d: Dims, device, carry: bool = False,
                         bucketed: bool = False):
    from ..plan.tensor import _pipeline_cold_impl

    kwargs: dict[str, Any] = {"max_iterations": 4, "fused_score": "off",
                              "favor_min_nodes": False}
    if bucketed:
        db = _bucketed_dims(d)
        args = _dev(device, *_host_padded(d, 0))
        kwargs["p_real"] = _p_real(d.P, device)
    else:
        db = d
        args = _solver_args(d, device)
    kwargs.update(constraints=db.constraints, rules=db.rules)
    if carry:
        kwargs["carry_used"] = _carry_used_of(*args[:3])
    return _pipeline_cold_impl, args, kwargs


def _build_pipeline_warm(d: Dims, device):
    from ..plan.tensor import _pipeline_warm_impl

    args = _solver_args(d, device)
    args = args + (_dirty(d, device), _carry_used_of(*args[:3]))
    return _pipeline_warm_impl, args, {
        "constraints": d.constraints, "rules": d.rules,
        "fused_score": "off", "favor_min_nodes": False}


def _sparse_k(d: Dims) -> int:
    """A K < N candidate width for the sparse contracts (saturation is
    covered separately by the builder contract)."""
    return max(1, min(d.N - 1, d.R + 2))


def _shortlist(d: Dims, args):
    """The [P, K] shortlist the sparse engine would build for ``args``."""
    from ..core.shortlist import build_shortlist_core

    prev, pweights, nweights, valid, _stick, gids, gid_valid = args
    return build_shortlist_core(prev, pweights, nweights, valid, gids,
                                gid_valid, d.constraints, d.rules,
                                _sparse_k(d))


def _build_sparse_cold(d: Dims, device, carry: bool = False):
    from ..plan.tensor import _solve_sparse_converged_impl

    args = _solver_args(d, device)
    kwargs: dict[str, Any] = {"constraints": d.constraints,
                              "rules": d.rules, "max_iterations": 4}
    if carry:
        kwargs["carry_used"] = _carry_used_of(*args[:3])
    return _solve_sparse_converged_impl, args + (_shortlist(d, args),), \
        kwargs


def _expect_sparse_cold(d: Dims):
    import numpy as np

    return (_expect_assign(d), ((), "int32"), ((d.P,), np.bool_))


def _build_sparse_warm(d: Dims, device):
    from ..plan.tensor import _warm_repair_sparse

    args = _solver_args(d, device)
    args = args + (_shortlist(d, args), _dirty(d, device),
                   _carry_used_of(*args[:3]))
    return _warm_repair_sparse, args, {
        "constraints": d.constraints, "rules": d.rules}


def _expect_sparse_warm(d: Dims):
    import numpy as np

    return (_expect_assign(d), _expect_used(d), ((), "bool"),
            ((d.P,), np.bool_))


# -- the sharded contracts: one mesh per audit run ---------------------------

_AUDIT_RANKS = 2  # every _MATRIX P divides over it: a real 2-shard mesh
_MESHES: dict[str, Any] = {}


def _audit_mesh(device):
    """The audit's mesh on ``device``, started on first use."""
    from ..parallel.sharded import make_mesh

    key = str(device)
    if key not in _MESHES:
        _MESHES[key] = make_mesh(_AUDIT_RANKS, device=device)
    return _MESHES[key]


def close_audit_meshes() -> None:
    """Stop the audit's meshes (run_shape_audit does after its table)."""
    while _MESHES:
        _MESHES.popitem()[1].close()


def _build_sharded_body(d: Dims, device, body: str, in_layout, out_layout,
                        extra=(), keep=None, **statics):
    """``Mesh.shard_map`` of ``body`` over the audit problem (plus
    ``extra`` operands) with the runtime's layout tables; ``keep`` picks
    the outputs the reference's contract names."""
    mesh = _audit_mesh(device)
    args = _solver_args(d, device)
    args = args + tuple(x(args) if callable(x) else x for x in extra)

    def run(*a):
        out = mesh.shard_map(body, a, in_layout, out_layout,
                             constraints=d.constraints, rules=d.rules,
                             **statics)
        return out if keep is None else out[keep]
    return run, args, {}


def _build_sharded(d: Dims, device):
    """solve_dense_sharded's cold dispatch (its assign)."""
    from ..parallel import sharded as sh

    return _build_sharded_body(
        d, device, "dense.cold", sh.SOLVER_IN_LAYOUT,
        sh.DENSE_COLD_OUT_LAYOUT, keep=0, max_iterations=4,
        fused_score="off")


def _build_sparse_sharded(d: Dims, device):
    """solve_sparse_sharded's cold dispatch: (assign, sweeps,
    exhausted), the shortlist riding the partition axis."""
    from ..parallel import sharded as sh

    return _build_sharded_body(
        d, device, "sparse.cold",
        sh.SOLVER_IN_LAYOUT + sh.SPARSE_EXTRA_LAYOUT,
        sh.SPARSE_COLD_OUT_LAYOUT, extra=(lambda a: _shortlist(d, a),),
        max_iterations=4)


def _build_pipeline_sharded(d: Dims, device, warm: bool = False):
    """solve_pipeline_sharded's dispatch, cold or warm."""
    from ..parallel import sharded as sh

    if warm:
        return _build_sharded_body(
            d, device, "pipeline.warm",
            sh.SOLVER_IN_LAYOUT + sh.WARM_EXTRA_LAYOUT,
            sh.PIPELINE_WARM_OUT_LAYOUT,
            extra=(_dirty(d, device), lambda a: _carry_used_of(*a[:3])),
            fused_score="off", favor_min_nodes=False)
    return _build_sharded_body(
        d, device, "pipeline.cold", sh.SOLVER_IN_LAYOUT,
        sh.PIPELINE_COLD_OUT_LAYOUT, max_iterations=4, fused_score="off",
        favor_min_nodes=False)


def _build_shortlist_builder(d: Dims, device, saturating: bool = False):
    from ..core.shortlist import build_shortlist_core

    k = d.N + 2 if saturating else _sparse_k(d)
    prev, pweights, nweights, valid, _stick, gids, gid_valid = \
        _solver_args(d, device)
    return build_shortlist_core, (
        prev, pweights, nweights, valid, gids, gid_valid), {
        "constraints": d.constraints, "rules": d.rules, "k": k}


def _expect_shortlist(d: Dims, saturating: bool = False):
    import numpy as np

    k = d.N if saturating else _sparse_k(d)
    return ((d.P, k), np.int32)


def _bucketed_dims(d: Dims) -> Dims:
    from ..core.encode import bucket_size

    return Dims(P=bucket_size(d.P), S=d.S, N=bucket_size(d.N), R=d.R,
                L=d.L)


_FLEET_B = 4  # batch width for the fleet contracts


def _fleet_args(d: Dims, b: int, device):
    """The stacked [B, ...] operands of one bucket class: ``b`` tenants
    of shape ``d``, each padded to the class, and their real counts."""
    import numpy as np

    from ..core.encode import stack_problem_arrays

    stacked = stack_problem_arrays([_host_padded(d, seed)
                                    for seed in range(b)])
    return _dev(device, *stacked), \
        _dev(device, np.full(b, float(d.P), np.float32))[0]


def _build_fleet_cold(d: Dims, device, b: int = _FLEET_B):
    """plan.fleet._fleet_cold_batch: the batched converged fixpoint over
    one bucket class — (assign, sweeps, carry-used) per element."""
    from ..plan.fleet import _fleet_cold_batch

    db = _bucketed_dims(d)
    args, p_real = _fleet_args(d, b, device)
    return _fleet_cold_batch, args + (p_real,), {
        "constraints": db.constraints, "rules": db.rules,
        "max_iterations": 4, "fused_score": "off"}


def _build_fleet_warm(d: Dims, device, b: int = _FLEET_B):
    """plan.fleet._fleet_warm_batch: the batched one-sweep repair —
    (assign, new_used, accept flag) per element."""
    import numpy as np

    import torch

    from ..plan.tensor import _used_by_state
    from ..plan.fleet import _fleet_warm_batch

    db = _bucketed_dims(d)
    args, p_real = _fleet_args(d, b, device)
    rng = np.random.default_rng(1)
    dirty = torch.from_numpy(rng.random((b, db.P)) < 0.25).to(device)
    used = _used_by_state(args[0], args[1], db.N, db.S)
    return _fleet_warm_batch, args + (dirty, used, p_real), {
        "constraints": db.constraints, "rules": db.rules,
        "fused_score": "off"}


def _expect_fleet_cold(d: Dims, b: int = _FLEET_B):
    import numpy as np

    db = _bucketed_dims(d)
    return (((b, db.P, db.S, db.R), np.int32), ((b,), np.int32),
            ((b, db.S, db.N), np.float32))


def _expect_fleet_warm(d: Dims, b: int = _FLEET_B):
    import numpy as np

    db = _bucketed_dims(d)
    return (((b, db.P, db.S, db.R), np.int32),
            ((b, db.S, db.N), np.float32), ((b,), np.bool_))


def _build_sched_ranks(d: Dims, device):
    import numpy as np

    from ..orchestrate.sched.ranks import rank_levels

    # The critical-path scheduler's device rank sweep: [P, L] per-move
    # costs (chains x levels, zero-padded) -> [P, L] upward ranks.  L
    # here is a representative 4-move chain depth (promote/add + del +
    # repair is 3; 4 covers a demote leg).
    rng = np.random.default_rng(0)
    costs = rng.random((d.P, 4)).astype(np.float32)
    return rank_levels, _dev(device, costs), {}


def _expect_sched_ranks(d: Dims):
    import numpy as np

    return ((d.P, 4), np.float32)


# -- the table --------------------------------------------------------------

# The audit matrix: small/typical/awkward sizes (the reference's).
_MATRIX = (
    Dims(P=8, S=1, N=5, R=1),
    Dims(P=16, S=2, N=8, R=2, L=2),
    Dims(P=24, S=3, N=9, R=3, L=2),
)

CONTRACTS: tuple[ShapeContract, ...] = tuple(
    [
        ShapeContract(
            entry="solve_dense", variant=f"cold@{d.P}x{d.N}",
            build=(lambda dev, d=d: _build_solve_dense(d, dev)),
            expect=(lambda d=d: _expect_assign(d)))
        for d in _MATRIX
    ] + [
        ShapeContract(
            entry="solve_dense", variant=f"carry@{d.P}x{d.N}",
            build=(lambda dev, d=d: _build_solve_dense(d, dev, carry=True)),
            expect=(lambda d=d: _expect_assign(d)))
        for d in _MATRIX
    ] + [
        ShapeContract(
            entry="solve_dense", variant=f"bucketed@{d.P}x{d.N}",
            build=(lambda dev, d=d: _build_solve_dense(
                d, dev, bucketed=True)),
            expect=(lambda d=d: _expect_assign(_bucketed_dims(d))))
        for d in _MATRIX
    ] + [
        ShapeContract(
            entry="solve_dense", variant=f"bucketed+carry@{d.P}x{d.N}",
            build=(lambda dev, d=d: _build_solve_dense(
                d, dev, carry=True, bucketed=True)),
            expect=(lambda d=d: _expect_assign(_bucketed_dims(d))))
        for d in _MATRIX
    ] + [
        ShapeContract(
            entry="solve_dense_converged", variant=f"cold@{d.P}x{d.N}",
            build=(lambda dev, d=d: _build_converged(d, dev)),
            # (assign, executed-sweep count)
            expect=(lambda d=d: (_expect_assign(d), ((), "int32"))))
        for d in _MATRIX
    ] + [
        ShapeContract(
            entry="solve_dense_converged", variant=f"carry@{d.P}x{d.N}",
            build=(lambda dev, d=d: _build_converged(d, dev, carry=True)),
            expect=(lambda d=d: (_expect_assign(d), ((), "int32"))))
        for d in _MATRIX
    ] + [
        ShapeContract(
            entry="solve_dense_warm", variant=f"repair@{d.P}x{d.N}",
            build=(lambda dev, d=d: _build_warm(d, dev)),
            # (assign, new_used, accept flag)
            expect=(lambda d=d: (_expect_assign(d), _expect_used(d),
                                 ((), "bool"))))
        for d in _MATRIX
    ] + [
        ShapeContract(
            entry="carry_from_assignment", variant=f"used@{d.P}x{d.N}",
            build=(lambda dev, d=d: _build_carry_used(d, dev)),
            expect=(lambda d=d: _expect_used(d)))
        for d in _MATRIX
    ] + [
        ShapeContract(
            entry="solve_dense_sharded", variant=f"1d@{d.P}x{d.N}",
            build=(lambda dev, d=d: _build_sharded(d, dev)),
            expect=(lambda d=d: _expect_assign(d)))
        for d in _MATRIX
    ] + [
        ShapeContract(
            entry="fleet_cold_batch",
            variant=f"B{_FLEET_B}@{d.P}x{d.N}",
            build=(lambda dev, d=d: _build_fleet_cold(d, dev)),
            expect=(lambda d=d: _expect_fleet_cold(d)))
        for d in _MATRIX
    ] + [
        ShapeContract(
            entry="fleet_warm_batch",
            variant=f"B{_FLEET_B}@{d.P}x{d.N}",
            build=(lambda dev, d=d: _build_fleet_warm(d, dev)),
            expect=(lambda d=d: _expect_fleet_warm(d)))
        for d in _MATRIX
    ] + [
        # -- sparse shortlist solve ------------------------------------
        ShapeContract(
            entry="solve_sparse", variant=f"cold@{d.P}x{d.N}",
            build=(lambda dev, d=d: _build_sparse_cold(d, dev)),
            expect=(lambda d=d: _expect_sparse_cold(d)))
        for d in _MATRIX
    ] + [
        ShapeContract(
            entry="solve_sparse", variant=f"carry@{d.P}x{d.N}",
            build=(lambda dev, d=d: _build_sparse_cold(d, dev, carry=True)),
            expect=(lambda d=d: _expect_sparse_cold(d)))
        for d in _MATRIX
    ] + [
        ShapeContract(
            entry="solve_sparse_warm", variant=f"repair@{d.P}x{d.N}",
            build=(lambda dev, d=d: _build_sparse_warm(d, dev)),
            expect=(lambda d=d: _expect_sparse_warm(d)))
        for d in _MATRIX
    ] + [
        ShapeContract(
            entry="solve_sparse_sharded", variant=f"1d@{d.P}x{d.N}",
            build=(lambda dev, d=d: _build_sparse_sharded(d, dev)),
            expect=(lambda d=d: _expect_sparse_cold(d)))
        for d in _MATRIX
    ] + [
        ShapeContract(
            entry="build_shortlist", variant=f"topk@{d.P}x{d.N}",
            build=(lambda dev, d=d: _build_shortlist_builder(d, dev)),
            expect=(lambda d=d: _expect_shortlist(d)))
        for d in _MATRIX
    ] + [
        ShapeContract(
            entry="build_shortlist", variant=f"saturating@{d.P}x{d.N}",
            build=(lambda dev, d=d: _build_shortlist_builder(
                d, dev, saturating=True)),
            expect=(lambda d=d: _expect_shortlist(d, saturating=True)))
        for d in _MATRIX
    ] + [
        # -- the plan pipeline (solve→diff→pack) -----------------------
        ShapeContract(
            entry="plan_pipeline", variant=f"cold@{d.P}x{d.N}",
            build=(lambda dev, d=d: _build_pipeline_cold(d, dev)),
            expect=(lambda d=d: _expect_pipeline_cold(d)))
        for d in _MATRIX
    ] + [
        ShapeContract(
            entry="plan_pipeline", variant=f"carry@{d.P}x{d.N}",
            build=(lambda dev, d=d: _build_pipeline_cold(
                d, dev, carry=True)),
            expect=(lambda d=d: _expect_pipeline_cold(d)))
        for d in _MATRIX
    ] + [
        ShapeContract(
            entry="plan_pipeline", variant=f"bucketed@{d.P}x{d.N}",
            build=(lambda dev, d=d: _build_pipeline_cold(
                d, dev, bucketed=True)),
            expect=(lambda d=d: _expect_pipeline_cold(_bucketed_dims(d))))
        for d in _MATRIX
    ] + [
        ShapeContract(
            entry="plan_pipeline", variant=f"warm@{d.P}x{d.N}",
            build=(lambda dev, d=d: _build_pipeline_warm(d, dev)),
            expect=(lambda d=d: _expect_pipeline_warm(d)))
        for d in _MATRIX
    ] + [
        ShapeContract(
            entry="plan_pipeline_sharded", variant=f"cold@{d.P}x{d.N}",
            build=(lambda dev, d=d: _build_pipeline_sharded(d, dev)),
            expect=(lambda d=d: _expect_pipeline_cold(d)))
        for d in _MATRIX
    ] + [
        ShapeContract(
            entry="plan_pipeline_sharded", variant=f"warm@{d.P}x{d.N}",
            build=(lambda dev, d=d: _build_pipeline_sharded(
                d, dev, warm=True)),
            expect=(lambda d=d: _expect_pipeline_warm(d)))
        for d in _MATRIX
    ] + [
        # -- critical-path scheduler device rank sweep -----------------
        ShapeContract(
            entry="sched_rank_levels", variant=f"chains@{d.P}",
            build=(lambda dev, d=d: _build_sched_ranks(d, dev)),
            expect=(lambda d=d: _expect_sched_ranks(d)))
        for d in _MATRIX
    ]
)


# -- runner -----------------------------------------------------------------


def _flatten_expect(exp):
    """(shape, dtype) | tuple thereof -> flat list, mirroring how the
    output tree flattens."""
    if isinstance(exp, tuple) and len(exp) == 2 and \
            isinstance(exp[0], tuple) and \
            all(isinstance(x, int) for x in exp[0]):
        return [exp]
    out = []
    for e in exp:
        out.extend(_flatten_expect(e))
    return out


def _leaves(out) -> list[tuple[tuple[int, ...], str]]:
    """The output tree's leaves as (shape, numpy dtype name): tensors by
    their torch dtype, numpy arrays by theirs, a Python bool as 0-d
    ``bool`` and a Python int as 0-d ``int32`` (host scalars the
    reference returns as 0-d arrays of those types)."""
    import numpy as np

    import torch

    if isinstance(out, torch.Tensor):
        name = str(out.dtype).removeprefix("torch.")
        return [(tuple(out.shape), np.dtype(name).name)]
    if isinstance(out, np.ndarray):
        return [(tuple(out.shape), out.dtype.name)]
    if isinstance(out, bool):
        return [((), "bool")]
    if isinstance(out, int):
        return [((), "int32" if -2**31 <= out < 2**31 else "int64")]
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    raise TypeError(f"unexpected output leaf {type(out).__name__}")


def _check_one(contract: ShapeContract, device) -> list[Finding]:
    import numpy as np

    findings: list[Finding] = []
    label = f"{contract.entry}[{contract.variant}]"
    try:
        fn, args, kwargs = contract.build(device)
        got = _leaves(fn(*args, **kwargs))
    except Exception as e:
        first = (str(e).splitlines() or [""])[0][:200]
        findings.append(Finding(
            rule="SHP002", path=_PATH, line=0, symbol=label,
            message=f"entry point raised on its audit problem "
                    f"({type(e).__name__}: {first})"))
        return findings

    want = _flatten_expect(contract.expect())
    if len(got) != len(want):
        findings.append(Finding(
            rule="SHP001", path=_PATH, line=0, symbol=label,
            message=f"output arity drift: expected {len(want)} arrays, "
                    f"got {len(got)}"))
        return findings
    for i, ((gshape, gdtype), (shape, dtype)) in enumerate(zip(got, want)):
        if tuple(gshape) != tuple(shape) or \
                np.dtype(gdtype) != np.dtype(dtype):
            findings.append(Finding(
                rule="SHP001", path=_PATH, line=0, symbol=label,
                message=f"output #{i} drifted: expected "
                        f"{tuple(shape)} {np.dtype(dtype).name}, got "
                        f"{tuple(gshape)} {gdtype}"))
    return findings


def _check_encode_decode() -> list[Finding]:
    """Concrete (tiny) encode/decode round trip: dense dtypes + map
    shape.  Host-only, milliseconds."""
    import numpy as np

    from ..core.encode import decode_assignment, encode_problem
    from ..core.types import Partition, PartitionModelState, PlanOptions

    findings: list[Finding] = []
    label = "encode_problem/decode_assignment"
    try:
        model = {
            "primary": PartitionModelState(priority=0, constraints=1),
            "replica": PartitionModelState(priority=1, constraints=1),
        }
        nodes = ["a", "b", "c"]
        pmap = {
            "00": Partition("00", {"primary": ["a"], "replica": ["b"]}),
            "01": Partition("01", {"primary": ["b"], "replica": ["c"]}),
        }
        problem = encode_problem(pmap, pmap, nodes, None, model,
                                 PlanOptions())
        expect = {
            "prev": ((2, 2, 1), np.int32),
            "constraints": ((2,), np.int32),
            "partition_weights": ((2,), np.float32),
            "node_weights": ((3,), np.float32),
            "valid_node": ((3,), np.bool_),
            "stickiness": ((2, 2), np.float32),
            "gids": ((1, 3), np.int32),
            "gid_valid": ((1, 3), np.bool_),
        }
        for field_name, (shape, dtype) in expect.items():
            arr = getattr(problem, field_name)
            if tuple(arr.shape) != shape or \
                    np.dtype(arr.dtype) != np.dtype(dtype):
                findings.append(Finding(
                    rule="SHP001", path=_PATH, line=0, symbol=label,
                    message=f"DenseProblem.{field_name} drifted: "
                            f"expected {shape} {np.dtype(dtype).name}, "
                            f"got {tuple(arr.shape)} {arr.dtype}"))
        decoded, warns = decode_assignment(problem, problem.prev, pmap)
        if set(decoded) != set(pmap) or warns:
            findings.append(Finding(
                rule="SHP001", path=_PATH, line=0, symbol=label,
                message=f"decode(encode(m).prev) did not round-trip the "
                        f"partition set cleanly (warnings: {warns})"))
        elif decoded["00"].nodes_by_state != pmap["00"].nodes_by_state:
            findings.append(Finding(
                rule="SHP001", path=_PATH, line=0, symbol=label,
                message="decode(encode(m).prev) changed placements"))
    except Exception as e:
        first = (str(e).splitlines() or [""])[0][:200]
        findings.append(Finding(
            rule="SHP002", path=_PATH, line=0, symbol=label,
            message=f"encode/decode audit raised "
                    f"({type(e).__name__}: {first})"))
    return findings


def _check_bucketing_algebra() -> list[Finding]:
    """bucket_size/pad_to host contracts: result >= x, monotone,
    overhead bounded by 1/granularity, idempotent."""
    import numpy as np

    from ..core.encode import _BUCKET_GRANULARITY, bucket_size, pad_to

    findings: list[Finding] = []
    label = "bucket_size/pad_to"
    prev = 0
    for x in list(range(1, 200)) + [255, 256, 257, 1000, 1007, 4096,
                                    99_999, 100_001]:
        b = bucket_size(x)
        if b < x:
            findings.append(Finding(
                rule="SHP003", path=_PATH, line=0, symbol=label,
                message=f"bucket_size({x}) = {b} < x: padding would "
                        f"TRUNCATE the axis"))
            break
        if bucket_size(b) != b:
            findings.append(Finding(
                rule="SHP003", path=_PATH, line=0, symbol=label,
                message=f"bucket_size not idempotent at {x}: "
                        f"bucket_size({b}) = {bucket_size(b)}"))
            break
        if x > _BUCKET_GRANULARITY and \
                (b - x) * _BUCKET_GRANULARITY > b:
            findings.append(Finding(
                rule="SHP003", path=_PATH, line=0, symbol=label,
                message=f"bucket_size({x}) = {b}: padding overhead "
                        f"exceeds the 1/{_BUCKET_GRANULARITY} bound"))
            break
        if b < prev:
            findings.append(Finding(
                rule="SHP003", path=_PATH, line=0, symbol=label,
                message=f"bucket_size not monotone at {x}"))
            break
        prev = b
    arr = np.arange(6, dtype=np.int32).reshape(2, 3)
    padded = pad_to(arr, 1, 5, -1)
    if padded.shape != (2, 5) or not (padded[:, 3:] == -1).all() or \
            not (padded[:, :3] == arr).all():
        findings.append(Finding(
            rule="SHP003", path=_PATH, line=0, symbol=label,
            message="pad_to contract violated (shape/fill/prefix)"))
    if pad_to(arr, 1, 2, -1) is not arr:
        findings.append(Finding(
            rule="SHP003", path=_PATH, line=0, symbol=label,
            message="pad_to must be a no-op when already long enough"))
    return findings


def _check_sparse_fallback() -> list[Finding]:
    """Concrete host contract of the per-row dense exhaustion fallback:
    a row flagged exhausted (its shortlist was all removed nodes) must
    come back with every feasible slot filled, duplicate-free, off
    removed nodes, and untouched rows bit-unchanged.  Tiny problem,
    host + one small solve, milliseconds."""
    import numpy as np

    findings: list[Finding] = []
    label = "sparse_fallback"
    try:
        from ..plan.tensor import _sparse_fallback_rows

        P, S, R, N = 6, 2, 1, 8
        rng = np.random.default_rng(5)
        prev = np.full((P, S, R), -1, np.int32)
        prev[:, 0, 0] = rng.integers(0, N, P)
        prev[:, 1, 0] = (prev[:, 0, 0] + 1) % N
        assign = prev.copy()
        assign[0] = -1  # the exhausted row the sparse solve left empty
        valid = np.ones(N, bool)
        valid[prev[0, 0, 0]] = False
        gids = np.stack([np.arange(N, dtype=np.int32),
                         np.arange(N, dtype=np.int32) // 2,
                         np.zeros(N, np.int32)])
        out = _sparse_fallback_rows(
            assign, np.array([0]), prev, np.ones(P, np.float32),
            np.ones(N, np.float32), valid,
            np.full((P, S), 1.5, np.float32), gids,
            np.ones((3, N), bool), (1, 1), ((), ((2, 1),)))
        row = out[0]
        if (row < 0).any():
            findings.append(Finding(
                rule="SHP003", path=_PATH, line=0, symbol=label,
                message=f"fallback left feasible slots empty: {row}"))
        held = row[row >= 0]
        if held.size and (~valid[held]).any():
            findings.append(Finding(
                rule="SHP003", path=_PATH, line=0, symbol=label,
                message="fallback placed a copy on a removed node"))
        if held.size != np.unique(held).size:
            findings.append(Finding(
                rule="SHP003", path=_PATH, line=0, symbol=label,
                message=f"fallback duplicated a node in one row: {row}"))
        if not np.array_equal(out[1:], assign[1:]):
            findings.append(Finding(
                rule="SHP003", path=_PATH, line=0, symbol=label,
                message="fallback mutated rows it was not asked to"))
    except Exception as e:
        first = (str(e).splitlines() or [""])[0][:200]
        findings.append(Finding(
            rule="SHP002", path=_PATH, line=0, symbol=label,
            message=f"sparse fallback audit raised "
                    f"({type(e).__name__}: {first})"))
    return findings


def _check_encode_residency() -> list[Finding]:
    """Concrete host contract of the encode-residency delta kernels
    (plan/resident.py): strip_prev_rows must equal
    strip-the-map-then-re-encode bit-exactly (new array, untouched rows
    byte-identical), and pack_slot_rows must be the decode pack —
    non-negative prefix in original slot order with exact counts.
    Tiny problem, host-only, milliseconds."""
    import numpy as np

    findings: list[Finding] = []
    label = "encode_residency"
    try:
        from ..core.encode import (
            encode_problem,
            pack_slot_rows,
            strip_prev_rows,
        )
        from ..core.types import Partition, PartitionModelState, PlanOptions

        model = {
            "primary": PartitionModelState(priority=0, constraints=1),
            "replica": PartitionModelState(priority=1, constraints=2),
        }
        nodes = [f"n{i}" for i in range(5)]
        pmap = {
            f"{i:02d}": Partition(f"{i:02d}", {
                "primary": [nodes[i % 5]],
                "replica": [nodes[(i + 1) % 5], nodes[(i + 2) % 5]]})
            for i in range(7)
        }
        problem = encode_problem(pmap, pmap, nodes, [], model,
                                 PlanOptions())
        dark = {"n1"}
        ids = np.array([1], np.int32)
        patched, dirty = strip_prev_rows(problem.prev, ids)
        stripped = {
            name: Partition(name, {
                s: [n for n in ns if n not in dark]
                for s, ns in p.nodes_by_state.items()})
            for name, p in pmap.items()}
        want = encode_problem(stripped, stripped, nodes, sorted(dark),
                              model, PlanOptions())
        if patched.shape != want.prev.shape or \
                not np.array_equal(patched, want.prev):
            findings.append(Finding(
                rule="SHP003", path=_PATH, line=0, symbol=label,
                message="strip_prev_rows != strip-map-then-re-encode"))
        if patched is problem.prev:
            findings.append(Finding(
                rule="SHP003", path=_PATH, line=0, symbol=label,
                message="strip_prev_rows returned the input array — "
                        "identity memos would serve stale hits"))
        if dirty.shape != (problem.P,) or not dirty.any():
            findings.append(Finding(
                rule="SHP003", path=_PATH, line=0, symbol=label,
                message="strip_prev_rows dirty mask drifted"))
        rows = np.array([[[2, -1, 0], [-1, -1, 4]]], np.int32)
        packed, counts = pack_slot_rows(rows)
        if packed.tolist() != [[[2, 0, -1], [4, -1, -1]]] or \
                counts.tolist() != [[2, 1]]:
            findings.append(Finding(
                rule="SHP003", path=_PATH, line=0, symbol=label,
                message=f"pack_slot_rows drifted: {packed.tolist()} "
                        f"{counts.tolist()}"))
    except Exception as e:
        first = (str(e).splitlines() or [""])[0][:200]
        findings.append(Finding(
            rule="SHP002", path=_PATH, line=0, symbol=label,
            message=f"encode-residency audit raised "
                    f"({type(e).__name__}: {first})"))
    return findings


#: The four host-side contracts, run after the table.
HOST_CHECKS: tuple[Callable[[], list[Finding]], ...] = (
    _check_encode_decode,
    _check_bucketing_algebra,
    _check_sparse_fallback,
    _check_encode_residency,
)


def run_shape_audit(device: Any = "cuda",
                    timings: "dict[str, float] | None" = None
                    ) -> tuple[list[Finding], int]:
    """Run the whole table on ``device`` (the card unless the caller asks
    for the CPU; raises without a card), then the host checks.
    ``timings``, when given, receives each contract's label -> seconds
    (its build and run, the card drained after it).  Returns (findings,
    entries_checked)."""
    import time

    import torch

    from ..convert import resolve_device

    device = resolve_device(device, "run_shape_audit")
    findings: list[Finding] = []
    try:
        for contract in CONTRACTS:
            t0 = time.perf_counter()
            findings.extend(_check_one(contract, device))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            if timings is not None:
                timings[f"{contract.entry}[{contract.variant}]"] = \
                    time.perf_counter() - t0
    finally:
        close_audit_meshes()
    for check in HOST_CHECKS:
        findings.extend(check())
    return findings, len(CONTRACTS) + len(HOST_CHECKS)
