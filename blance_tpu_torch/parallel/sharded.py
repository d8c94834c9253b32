# Port of blance_tpu/parallel/sharded.py.  The pure half (the layout
# tables, layout_specs, slice_major_order, mesh_shape_for with _PART_CAP /
# _NODE_CAP, pad_partitions, pad_nodes; reference lines 68-318) is copied;
# the mesh builders and the sharded entry points run on the port's Mesh
# (parallel/mesh.py), whose shard_map takes the place of jax.shard_map.
# The reference's _build_checked (shard_map's varying-axes checker), its
# jax.transfer_guard scopes and _pipeline_sharded_fn (a jit cache of the
# built pipeline) are JAX-only and have no counterpart.
"""Multi-device sharded planning: a mesh over the partition axis.

The planning problem shards cleanly over partitions: scores[P, N] are
embarrassingly parallel in P, and the only cross-shard state is per-node
aggregate weight (counts, capacity usage), which rides psums over the
mesh.  Each rank runs the same auction rounds on its partition shard
with 1/n of every node's capacity, and psums its per-node accepted
weight so the price and counts every shard sees stay globally
consistent.  No [P, N] tensor ever gathers on one rank.

A SECOND mesh axis (make_mesh_2d) shards the node dimension of every
[P, N] intermediate: per-row (min, argmin, second) stats combine across
node shards by all_gather plus index arithmetic, remote column reads
ride a masked psum, and the [N]-sized vectors stay replicated along the
node axis so the capacity and acceptance logic is identical math on
every node shard (plan/tensor.py).

On one card every rank of a mesh shares the card, so a mesh there
measures the mesh's overhead and correctness, not scaling.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.encode import DenseProblem, pad_to
from ..obs import device as _obs_device
from ..obs import get_recorder
from ..plan import tensor as _tensor
from ..plan.tensor import SolveCarry, carry_from_assignment
from .mesh import NODE_AXIS, PARTITION_AXIS, Mesh, register_body

__all__ = ["make_mesh", "make_mesh_2d", "make_hybrid_mesh",
           "make_mesh_auto", "mesh_shape_for", "slice_major_order",
           "solve_dense_sharded", "solve_pipeline_sharded",
           "solve_sparse_sharded", "solve_problem_sharded",
           "pad_partitions", "pad_nodes", "SOLVER_IN_LAYOUT",
           "WARM_EXTRA_LAYOUT", "SPARSE_EXTRA_LAYOUT", "layout_specs",
           "Mesh", "PARTITION_AXIS", "NODE_AXIS", "SHARD_BODIES"]

# --- declarative shard layouts ----------------------------------------------
#
# THE one table of how solver operands lay out on a mesh: each entry is
# (operand name, "parts" = sharded over the partition axis | "replicated").
# Every shard_map dispatch here derives its layout from these rows, and
# the shape audit (analysis/shape_audit.py) builds its sharded contracts
# from the SAME table — so the audited layout and the dispatched layout
# cannot drift apart.  The node axis of a 2-D mesh never appears in the
# specs: [N]-shaped operands stay REPLICATED along it by design (see the
# module docstring) and the [P, N] splits happen inside solve_dense.

SOLVER_IN_LAYOUT: tuple[tuple[str, str], ...] = (
    ("prev", "parts"),
    ("pweights", "parts"),
    ("nweights", "replicated"),
    ("valid", "replicated"),
    ("stickiness", "parts"),
    ("gids", "replicated"),
    ("gid_valid", "replicated"),
)
WARM_EXTRA_LAYOUT: tuple[tuple[str, str], ...] = (
    ("dirty", "parts"),
    ("carry_used", "replicated"),
)
# Sparse solve: the [P, K] shortlist rides the partition axis with its
# prev rows; every [N]-shaped table stays replicated exactly like the
# dense layout (the sparse engine's fill/price/capacity are full-width
# by design).
SPARSE_EXTRA_LAYOUT: tuple[tuple[str, str], ...] = (
    ("shortlist", "parts"),
)
# Sparse solve outputs: assign + exhaustion flags are row-wise in P;
# the executed-sweep count is globally agreed.
SPARSE_COLD_OUT_LAYOUT: tuple[tuple[str, str], ...] = (
    ("assign", "parts"), ("sweeps", "replicated"),
    ("exhausted", "parts"),
)
SPARSE_WARM_OUT_LAYOUT: tuple[tuple[str, str], ...] = (
    ("assign", "parts"), ("used", "replicated"),
    ("ok", "replicated"), ("exhausted", "parts"),
)
# Pipeline outputs: assign + the diff/pack tensors are row-wise in P
# (shardable with zero collectives); the carry tables and scalars are
# psum'd/globally-agreed inside the body, hence replicated.
PIPELINE_COLD_OUT_LAYOUT: tuple[tuple[str, str], ...] = (
    ("assign", "parts"), ("sweeps", "replicated"),
    ("prices", "replicated"), ("used", "replicated"),
    ("d_nodes", "parts"), ("d_states", "parts"), ("d_ops", "parts"),
    ("packed", "parts"), ("counts", "parts"),
)
PIPELINE_WARM_OUT_LAYOUT: tuple[tuple[str, str], ...] = (
    ("assign", "parts"), ("prices", "replicated"),
    ("used", "replicated"), ("ok", "replicated"),
    ("d_nodes", "parts"), ("d_states", "parts"), ("d_ops", "parts"),
    ("packed", "parts"), ("counts", "parts"),
)
# The dense solves' outputs (the reference's out_specs spelled as rows;
# the cold body also hands back its sweep count, which every shard
# agrees on).
DENSE_COLD_OUT_LAYOUT: tuple[tuple[str, str], ...] = (
    ("assign", "parts"), ("sweeps", "replicated"),
)
DENSE_WARM_OUT_LAYOUT: tuple[tuple[str, str], ...] = (
    ("assign", "parts"), ("used", "replicated"), ("ok", "replicated"),
)
# The fleet batch (plan/fleet.py): every operand and output rides the
# batch axis; tenant solves are independent, so no collective runs.
FLEET_COLD_IN_LAYOUT: tuple[tuple[str, str], ...] = tuple(
    (name, "parts") for name in ("prev", "pweights", "nweights", "valid",
                                 "stickiness", "gids", "gid_valid",
                                 "p_real"))
FLEET_WARM_IN_LAYOUT: tuple[tuple[str, str], ...] = tuple(
    (name, "parts") for name in ("prev", "pweights", "nweights", "valid",
                                 "stickiness", "gids", "gid_valid",
                                 "dirty", "carry_used", "p_real"))
FLEET_COLD_OUT_LAYOUT: tuple[tuple[str, str], ...] = (
    ("assign", "parts"), ("sweeps", "parts"), ("used", "parts"))
FLEET_WARM_OUT_LAYOUT: tuple[tuple[str, str], ...] = (
    ("assign", "parts"), ("used", "parts"), ("ok", "parts"))


def layout_specs(layout: tuple) -> tuple:
    """Rows of a layout table -> the per-operand kinds ``Mesh.shard_map``
    takes ("parts" or "replicated"), validated."""
    specs = []
    for name, kind in layout:
        if kind not in ("parts", "replicated"):
            raise ValueError(
                f"layout row {name!r}: unknown kind {kind!r}")
        specs.append(kind)
    return tuple(specs)


# --- the shard_map'd bodies --------------------------------------------------
#
# The reference's eight shard_map'd bodies, by name: each rank resolves
# the name here (parallel/mesh.py runs them) and passes its axes on as
# the solver's ``axis`` / ``node_axis`` / ``node_shards``.


def _dense_cold(*args, axes, constraints, rules, max_iterations,
                fused_score):
    return _tensor._solve_dense_converged_impl(
        *args, constraints, rules, max_iterations, fused_score,
        axis=axes.parts, node_axis=axes.nodes,
        node_shards=axes.node_shards)


def _dense_warm(*args, axes, constraints, rules, fused_score):
    return _tensor._warm_repair(
        *args, constraints, rules, fused_score, axis=axes.parts,
        node_axis=axes.nodes, node_shards=axes.node_shards)


def _sparse_cold(*args, axes, constraints, rules, max_iterations):
    return _tensor._solve_sparse_converged_impl(
        *args, constraints, rules, max_iterations, axis=axes.parts)


def _sparse_warm(*args, axes, constraints, rules):
    return _tensor._warm_repair_sparse(
        *args, constraints, rules, axis=axes.parts)


def _pipeline_cold(*args, axes, constraints, rules, max_iterations,
                   fused_score, favor_min_nodes):
    return _tensor._pipeline_cold_impl(
        *args, constraints, rules, max_iterations, fused_score,
        favor_min_nodes, axis=axes.parts, node_axis=axes.nodes,
        node_shards=axes.node_shards)


def _pipeline_warm(*args, axes, constraints, rules, fused_score,
                   favor_min_nodes):
    return _tensor._pipeline_warm_impl(
        *args, constraints, rules, fused_score, favor_min_nodes,
        axis=axes.parts, node_axis=axes.nodes,
        node_shards=axes.node_shards)


def _fleet_cold(*args, axes, constraints, rules, max_iterations,
                fused_score):
    from ..plan.fleet import _fleet_cold_batch

    return _fleet_cold_batch(*args, constraints=constraints, rules=rules,
                             max_iterations=max_iterations,
                             fused_score=fused_score)


def _fleet_warm(*args, axes, constraints, rules, fused_score):
    from ..plan.fleet import _fleet_warm_batch

    return _fleet_warm_batch(*args, constraints=constraints, rules=rules,
                             fused_score=fused_score)


SHARD_BODIES = {
    "dense.cold": _dense_cold, "dense.warm": _dense_warm,
    "sparse.cold": _sparse_cold, "sparse.warm": _sparse_warm,
    "pipeline.cold": _pipeline_cold, "pipeline.warm": _pipeline_warm,
    "fleet.cold": _fleet_cold, "fleet.warm": _fleet_warm,
}
for _name, _fn in SHARD_BODIES.items():
    register_body(_name, _fn)


# --- meshes ------------------------------------------------------------------


def _pool_args(devices, n: Optional[int], device, timeout):
    """(shape-independent Mesh kwargs, rank count) for a builder's
    ``devices``: None (new ranks, ordinals 0..n-1), an existing Mesh
    (its ranks) or a list of device ordinals (new ranks on those)."""
    if isinstance(devices, Mesh):
        return dict(share=devices, timeout=timeout), devices.size
    if devices is not None:
        ords = [int(d) for d in devices]
        return dict(device=device, ordinals=ords, timeout=timeout), len(ords)
    if n is None:
        kind = torch.device(device).type
        n = torch.cuda.device_count() if kind == "cuda" else 1
        if kind == "cuda" and n == 0:
            raise RuntimeError("make_mesh(device='cuda'): no CUDA card is "
                               "available")
    return dict(device=device, timeout=timeout), n


def make_mesh(n_devices: Optional[int] = None, devices=None, *,
              device="cuda", timeout: Optional[float] = None) -> Mesh:
    """1-D mesh over the partition axis: ``n_devices`` ranks (all cards
    by default; one rank on the CPU), or the first of ``devices`` (an
    existing mesh, whose ranks it shares, or device ordinals)."""
    kw, avail = _pool_args(devices, n_devices, device, timeout)
    n = avail if n_devices is None else int(n_devices)
    if n > avail:
        raise ValueError(f"need {n} devices, have {avail}")
    if "ordinals" in kw:
        kw["ordinals"] = kw["ordinals"][:n]
    return Mesh((n,), **kw)


def slice_major_order(slice_ids: list) -> list:
    """Stable slice-major device ordering: indices sorted by slice id,
    original order preserved within a slice.  Pure so the multi-slice
    path is unit-testable without multi-slice hardware."""
    return sorted(range(len(slice_ids)), key=lambda i: (slice_ids[i], i))


def make_hybrid_mesh(
    devices: Optional[list] = None,
    slice_ids: Optional[list] = None,
    *, device="cuda", timeout: Optional[float] = None,
) -> Mesh:
    """Multi-host 1-D mesh with its devices ordered slice-major (stable
    within a slice), so the ranks that share a fast interconnect are
    contiguous on the partition axis.  torch has no slice index, so
    ``slice_ids`` are explicit and default to one slice (then it is
    :func:`make_mesh` over ``devices``, device ordinals defaulting to
    every card)."""
    if devices is None:
        kind = torch.device(device).type
        devices = list(range(torch.cuda.device_count() if kind == "cuda"
                             else 1))
    devices = [int(d) for d in devices]
    if slice_ids is None:
        slice_ids = [0] * len(devices)
    if len(slice_ids) != len(devices):
        raise ValueError(
            f"{len(slice_ids)} slice ids for {len(devices)} devices")
    if len(set(slice_ids)) > 1:
        devices = [devices[i] for i in slice_major_order(slice_ids)]
    return Mesh((len(devices),), device=device, ordinals=devices,
                timeout=timeout)


def make_mesh_2d(
    parts_shards: int, node_shards: int, devices=None, *,
    device="cuda", timeout: Optional[float] = None,
) -> Mesh:
    """2-D (parts x nodes) mesh for node-axis sharding, the node axis
    minor (rank = parts_idx * node_shards + node_idx): its per-round
    all_gather of [P_l]-sized stats is the latency-bound traffic, so it
    rides adjacent ranks."""
    need = parts_shards * node_shards
    kw, avail = _pool_args(devices, need, device, timeout)
    if avail < need:
        raise ValueError(f"need {need} devices, have {avail}")
    if "ordinals" in kw:
        kw["ordinals"] = kw["ordinals"][:need]
    return Mesh((parts_shards, node_shards), **kw)


# Per-axis shard caps for mesh_shape_for.  The per-shard [P_l, N_l]
# block is P*N/n_devices for EVERY factorization (memory cannot prefer
# one), so the factorization is chosen by per-AXIS extents instead:
# _PART_CAP is the partition rows one device handles comfortably,
# _NODE_CAP the column width past which the ">> 10k nodes" guidance
# (module docstring) wants the node axis engaged — [N] replicated
# vectors and psums stay kilobytes-to-small below it.
_PART_CAP = 1 << 17  # 131072 partition rows per shard
_NODE_CAP = 1 << 14  # 16384 node columns per shard


def mesh_shape_for(
    n_devices: int,
    p: int,
    n: int,
    *,
    part_cap: int = _PART_CAP,
    node_cap: int = _NODE_CAP,
) -> tuple[int, int]:
    """(parts_shards, node_shards) for ANY device count — the mesh
    factorization rule that replaces the hand-picked 8-chip meshes.

    Pure and deterministic (unit-testable without devices).  Preference
    order: the partition axis (its only collectives are [N]-sized
    psums; the node axis adds per-round all_gathers of row stats), so
    among factorizations keeping both per-shard axis extents within
    their caps the fewest node shards wins — small problems on any
    fleet resolve to the plain 1-D partition mesh.  When no divisor of
    ``n_devices`` fits both caps (beyond-fleet problems: 1M x 1M on 8
    chips), the factorization minimizing the worst RELATIVE axis
    overload is returned, ties toward fewer node shards — both axes
    degrade together instead of one exploding.
    parts_shards * node_shards == n_devices always: every chip works.
    """
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if p < 0 or n < 0:
        raise ValueError(f"negative problem dims ({p}, {n})")
    divisors = [d for d in range(1, n_devices + 1) if n_devices % d == 0]

    def overload(node_shards: int) -> float:
        parts = n_devices // node_shards
        p_l = -(-max(p, 1) // parts)
        n_l = -(-max(n, 1) // node_shards)
        return max(p_l / part_cap, n_l / node_cap)

    fitting = [d for d in divisors if overload(d) <= 1.0]
    if fitting:
        best = fitting[0]  # smallest node_shards: prefer the parts axis
    else:
        best = min(divisors, key=lambda d: (overload(d), d))
    return n_devices // best, best


def make_mesh_auto(
    p: int,
    n: int,
    devices: Optional[list] = None,
    slice_ids: Optional[list] = None,
    *, device="cuda", timeout: Optional[float] = None,
) -> Mesh:
    """Problem-shaped mesh over all the given devices (device ordinals,
    every card by default): 1-D partition mesh (slice-major ordered
    across slices, like make_hybrid_mesh) while a partition-only split
    fits, 2-D (parts x nodes) beyond that."""
    if devices is None:
        kind = torch.device(device).type
        devices = list(range(torch.cuda.device_count() if kind == "cuda"
                             else 1))
    devices = [int(d) for d in devices]
    if slice_ids is None:
        slice_ids = [0] * len(devices)
    if len(set(slice_ids)) > 1:
        devices = [devices[i] for i in slice_major_order(slice_ids)]
    parts, nodes = mesh_shape_for(len(devices), p, n)
    if nodes == 1:
        return Mesh((len(devices),), device=device, ordinals=devices,
                    timeout=timeout)
    return make_mesh_2d(parts, nodes, devices=devices, device=device,
                        timeout=timeout)


def pad_partitions(arr: np.ndarray, multiple: int,
                   fill: float | int | bool) -> np.ndarray:
    """Pad axis 0 to a multiple of the mesh size.

    Padding rows use weight 0 so they bid without consuming capacity or
    affecting counts; their assignments are discarded at decode.
    """
    p = arr.shape[0]
    return pad_to(arr, 0, p + (-p) % multiple, fill)


def pad_nodes(arr: np.ndarray, multiple: int,
              fill: float | int | bool) -> np.ndarray:
    """Pad the trailing (node) axis to a multiple of the node-shard count.

    Padding nodes are invalid (valid=False ⇒ zero capacity, +INF score,
    gid_valid=False), so they can never be chosen; assignments therefore
    only ever reference real node ids.
    """
    n = arr.shape[-1]
    return pad_to(arr, arr.ndim - 1, n + (-n) % multiple, fill)


# --- the sharded entry points ------------------------------------------------


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _mesh_axes(mesh: Mesh) -> tuple[int, int]:
    axes = dict(zip(mesh.axis_names, mesh.devices.shape))
    return axes[PARTITION_AXIS], axes.get(NODE_AXIS, 1)


def _resolve_engine(fused_score: Optional[str], shard_p: int, shard_n: int,
                    mesh: Mesh) -> str:
    """Resolve against the PER-SHARD slice: each rank holds P/n_shards
    rows (x N/node_shards columns) of every [P, N] intermediate, so that
    is the working set its card must fit.  None follows the module
    default, as the single-device entry points do."""
    if fused_score is None:
        return _tensor.resolve_default_fused_score(shard_p, shard_n,
                                                   mesh.device)
    return _tensor.resolve_fused_score(fused_score, shard_p, shard_n,
                                       mesh.device)


def _padded_inputs(prev, pweights, nweights, valid, stickiness, gids,
                   gid_valid, n_shards: int, node_shards: int) -> tuple:
    """The solver operands padded to mesh divisibility (inert rows:
    weight 0, no holder; inert columns: invalid nodes)."""
    prev_p = pad_partitions(_host(prev), n_shards, -1)
    pw_p = pad_partitions(_host(pweights), n_shards, 0.0)
    st_p = pad_partitions(_host(stickiness), n_shards, 0.0)
    nw_p, valid_p = _host(nweights), _host(valid)
    gids_p, gv_p = _host(gids), _host(gid_valid)
    if node_shards > 1:
        nw_p = pad_nodes(nw_p, node_shards, 1.0)
        valid_p = pad_nodes(valid_p, node_shards, False)
        gids_p = pad_nodes(gids_p, node_shards, -1)
        gv_p = pad_nodes(gv_p, node_shards, False)
    return (prev_p, pw_p, nw_p, valid_p, st_p, gids_p, gv_p)


def _warm_operands(dirty, carry: SolveCarry, n_shards: int,
                   node_shards: int) -> tuple[np.ndarray, np.ndarray]:
    """dirty padded over the partition axis (padding rows dirty: their
    synthetic assignments must not read as a ripple) and the carry's
    [S, N] fill table, node-padded with zero fill."""
    dirty_p = pad_partitions(np.asarray(dirty, bool), n_shards, True)
    cu = _host(carry.used).astype(np.float32)
    if node_shards > 1:
        cu = pad_nodes(cu, node_shards, 0.0)
    return dirty_p, cu


def _observe_dirty(rec, dirty) -> None:
    d = np.asarray(dirty, bool)
    rec.observe("plan.solve.dirty_fraction",
                float(d.mean()) if d.size else 0.0)


def _note_call(stats: Optional[dict], mesh: Mesh, **extra) -> None:
    if stats is not None:
        stats.update(mesh=dict(mesh.last_call), **extra)


def solve_dense_sharded(
    mesh: Mesh,
    prev,
    pweights,
    nweights,
    valid,
    stickiness,
    gids,
    gid_valid,
    constraints: tuple,
    rules: tuple,
    max_iterations: int = 10,
    fused_score: Optional[str] = None,
    dirty: Optional[np.ndarray] = None,
    carry: Optional[SolveCarry] = None,
    return_carry: bool = False,
    warm_only: bool = False,
    *,
    stats: Optional[dict] = None,
    capture: Optional[int] = None,
):
    """Run the converged solve on ``mesh``, partition axis sharded.

    Accepts a 1-D ("parts",) or 2-D ("parts", "nodes") mesh (make_mesh /
    make_mesh_2d).  On a 2-D mesh the [P, N] intermediates inside the
    solver are sharded on BOTH axes; inputs here stay partition-sharded +
    node-replicated.  Takes host arrays (or tensors); returns
    assign[P_original, S, R] as numpy (padding stripped), or (assign,
    SolveCarry) with ``return_carry``, the carry's tensors on rank 0's
    device.

    With ``dirty`` + ``carry`` (both matching ``prev``) the WARM path
    runs first: one carry-seeded repair sweep on the mesh — the carry's
    fill table rides replicated while the assignment stays sharded —
    accepted when the repair stayed inside the dirty mask, else falling
    back to the cold fixpoint — or, with ``warm_only``, returning
    (None, None) so the caller owns the fallback.  The carry is consumed
    either way; ``carry_hit`` is the caller's to count.

    ``stats``, when given, receives the executed sweeps (cold), the
    engine, and ``mesh``: the call's per-rank stats (solve time, peak
    allocation, collectives, their time, bytes and host staging copies,
    kernel launches).  ``capture`` names a rank that records its first
    kernel calls' inputs (``stats["mesh"]["captured"]``)."""
    n_shards, node_shards = _mesh_axes(mesh)
    p_orig = prev.shape[0]
    n_orig = _host(nweights).shape[-1]
    # Asserted on the host values once for the whole mesh.
    _tensor._check_tier_band_scale(
        prev, pweights, nweights, valid, stickiness, constraints, rules)
    shard_p = -(-p_orig // n_shards)
    shard_n = -(-n_orig // node_shards)
    fused_score = _resolve_engine(fused_score, shard_p, shard_n, mesh)
    args = _padded_inputs(prev, pweights, nweights, valid, stickiness,
                          gids, gid_valid, n_shards, node_shards)
    statics = dict(constraints=tuple(constraints),
                   rules=tuple(tuple(r) for r in rules),
                   fused_score=fused_score)
    if stats is not None:
        stats["engine"] = fused_score

    rec = get_recorder()
    if dirty is not None and carry is not None:
        dirty_p, cu = _warm_operands(dirty, carry, n_shards, node_shards)
        _observe_dirty(rec, dirty)
        with rec.span("plan.solve.attempt", warm=True, sharded=True), \
                _obs_device.entry("sharded.warm"):
            out, new_used, ok = mesh.shard_map(
                "dense.warm", args + (dirty_p, cu),
                SOLVER_IN_LAYOUT + WARM_EXTRA_LAYOUT, DENSE_WARM_OUT_LAYOUT,
                capture=capture, **statics)
            accepted = bool(ok)
        _note_call(stats, mesh, accepted=accepted)
        if accepted:
            _tensor._record_sweeps(1)
            rec.set_attr("warm", True)
            assign = out.cpu().numpy()[:p_orig]
            if not return_carry:
                return assign
            # Strip node padding: pad columns are invalid nodes with
            # zero fill, and the session's carry is unpadded-N shaped.
            used = new_used[:, :n_orig].contiguous()
            return assign, SolveCarry(
                prices=used.sum(0), assign=out[:p_orig].contiguous(),
                used=used)
        rec.count("plan.solve.warm_fallback")
        rec.count("plan.solve.sweeps", 1)  # the executed repair pass
        if warm_only:
            return (None, None) if return_carry else None

    # The observatory attribution is first-wins, so the body's inner
    # labels stay subordinate to "sharded.cold".
    with _obs_device.entry("sharded.cold"):
        out, sweeps = mesh.shard_map(
            "dense.cold", args, SOLVER_IN_LAYOUT, DENSE_COLD_OUT_LAYOUT,
            capture=capture, max_iterations=int(max_iterations), **statics)
    _note_call(stats, mesh, sweeps=int(sweeps))
    assign = out.cpu().numpy()[:p_orig]
    if return_carry:
        return assign, carry_from_assignment(
            out[:p_orig], _as_tensor(pweights, mesh),
            _as_tensor(nweights, mesh))
    return assign


def _as_tensor(x, mesh: Mesh) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        _host(x), np.float32)).to(mesh.device)


def solve_sparse_sharded(
    mesh: Mesh,
    prev,
    pweights,
    nweights,
    valid,
    stickiness,
    gids,
    gid_valid,
    constraints: tuple,
    rules: tuple,
    *,
    k: Optional[int] = None,
    shortlist: Optional[np.ndarray] = None,
    max_iterations: int = 10,
    dirty: Optional[np.ndarray] = None,
    carry: Optional[SolveCarry] = None,
    return_carry: bool = False,
    warm_only: bool = False,
    stats: Optional[dict] = None,
    capture: Optional[int] = None,
):
    """The sparse shortlist solve on ``mesh``, partition axis sharded —
    the [P, K] score tables (and the shortlist itself) ride the
    partition axis (``SPARSE_EXTRA_LAYOUT``) while every [N]-shaped
    fill/price table stays replicated, exactly like the dense layout.
    1-D partition meshes only: the shortlist already bounds the column
    working set, so a node axis would shard kilobytes.

    The shortlist is derived on the PADDED problem (pad rows are
    weight-0 bidders with the same global candidates as the dense
    engine's pads see), or adopted from ``shortlist`` and padded.  With
    ``dirty`` + ``carry`` the warm one-sweep sparse repair runs first
    under the solve_dense_sharded warm contract (``warm_only``
    included); exhausted rows of an accepted result are re-placed by
    the host-side per-row dense fallback, after padding strips.  The
    sparse min2 runs its kernel on a card and its plain version on the
    CPU (the reference's ``sparse_impl`` has no counterpart).
    ``stats``: as solve_dense_sharded, plus k, exhausted_rows and
    fallback_rows."""
    n_shards, node_shards = _mesh_axes(mesh)
    if node_shards > 1:
        raise ValueError(
            "solve_sparse_sharded: node-axis meshes are not supported "
            "(the [P, K] shortlist already bounds the column working "
            "set); use a 1-D partition mesh")
    p_orig = prev.shape[0]
    constraints = tuple(int(c) for c in constraints)
    rules = tuple(tuple(r) for r in rules)
    if not _tensor.sparse_rules_supported(rules):
        raise ValueError(
            "sparse solve requires nesting hierarchy rules "
            "(exclude_level < include_level); use solve_dense_sharded")
    _tensor._check_tier_band_scale(
        prev, pweights, nweights, valid, stickiness, constraints, rules)
    args = _padded_inputs(prev, pweights, nweights, valid, stickiness,
                          gids, gid_valid, n_shards, 1)
    rec = get_recorder()
    sl_in = None if shortlist is None \
        else pad_partitions(_host(shortlist), n_shards, -1)
    # The shortlist builds on rank 0's device from the padded problem.
    sl_p, _built_s = _tensor._build_or_adopt_shortlist(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)
          for a in (args[0], args[1], args[2], args[3], args[5], args[6])),
        constraints, rules, sl_in, k, True)
    sl_p = sl_p.cpu().numpy()
    args = args + (sl_p,)
    statics = dict(constraints=constraints, rules=rules)

    def finish(assign_np, exh_np, used=None, out_t=None):
        """Strip padding, run the host fallback on flagged REAL rows,
        rebuild the carry when asked (always from the final patched
        assignment — the fallback invalidates any device-side used)."""
        assign_np = assign_np[:p_orig]
        patched, replaced = _tensor._apply_sparse_fallback(
            assign_np, exh_np[:p_orig], _host(prev), pweights, nweights,
            valid, stickiness, gids, gid_valid, constraints, rules)
        if stats is not None:
            stats.update(k=int(sl_p.shape[1]),
                         exhausted_rows=int(exh_np[:p_orig].sum()),
                         fallback_rows=replaced)
        if not return_carry:
            return patched
        if replaced or used is None:
            return patched, carry_from_assignment(
                patched, _as_tensor(pweights, mesh),
                _as_tensor(nweights, mesh))
        return patched, SolveCarry(prices=used.sum(0),
                                   assign=out_t[:p_orig].contiguous(),
                                   used=used)

    if dirty is not None and carry is not None:
        dirty_p, cu = _warm_operands(dirty, carry, n_shards, 1)
        _observe_dirty(rec, dirty)
        with rec.span("plan.solve.attempt", warm=True, sharded=True,
                      engine="sparse"), \
                _obs_device.entry("sparse.sharded.warm"):
            out, new_used, ok, exh = mesh.shard_map(
                "sparse.warm", args + (dirty_p, cu),
                SOLVER_IN_LAYOUT + SPARSE_EXTRA_LAYOUT + WARM_EXTRA_LAYOUT,
                SPARSE_WARM_OUT_LAYOUT, capture=capture, **statics)
            accepted = bool(ok)
        _note_call(stats, mesh, accepted=accepted)
        if accepted:
            _tensor._record_sweeps(1)
            rec.set_attr("warm", True)
            return finish(out.cpu().numpy(), exh.cpu().numpy(), new_used,
                          out)
        rec.count("plan.solve.warm_fallback")
        rec.count("plan.solve.sweeps", 1)  # the executed repair pass
        if warm_only:
            return (None, None) if return_carry else None

    with rec.span("plan.solve.attempt", sharded=True, engine="sparse"), \
            _obs_device.entry("sparse.sharded.cold"):
        out, sweeps, exh = mesh.shard_map(
            "sparse.cold", args, SOLVER_IN_LAYOUT + SPARSE_EXTRA_LAYOUT,
            SPARSE_COLD_OUT_LAYOUT, capture=capture,
            max_iterations=int(max_iterations), **statics)
    _tensor._record_sweeps(sweeps)
    _note_call(stats, mesh, sweeps=int(sweeps))
    return finish(out.cpu().numpy(), exh.cpu().numpy())


def solve_pipeline_sharded(
    mesh: Mesh,
    prev,
    pweights,
    nweights,
    valid,
    stickiness,
    gids,
    gid_valid,
    constraints: tuple,
    rules: tuple,
    max_iterations: int = 10,
    fused_score: Optional[str] = None,
    favor_min_nodes: bool = False,
    dirty: Optional[np.ndarray] = None,
    carry: Optional[SolveCarry] = None,
    warm_only: bool = False,
    *,
    stats: Optional[dict] = None,
):
    """The fused plan pipeline (solve -> diff -> pack) on ``mesh``.

    The diff and the decode pack are row-wise in P — they shard over the
    partition axis with ZERO additional collectives, so the pipeline
    scales exactly as far as the solve does (1-D or 2-D).  Returns
    (assign, SolveCarry, (d_nodes, d_states, d_ops)) with padding
    stripped — the tuple PlannerSession.replan_with_moves consumes — or
    None when ``warm_only`` and the repair declined.

    With ``dirty`` + ``carry`` the warm one-sweep repair runs first,
    accepted under the solve_dense_warm contract; declined repairs fall
    through to the cold fixpoint unless ``warm_only``."""
    n_shards, node_shards = _mesh_axes(mesh)
    p_orig = prev.shape[0]
    n_orig = _host(nweights).shape[-1]
    _tensor._check_tier_band_scale(
        prev, pweights, nweights, valid, stickiness, constraints, rules)
    shard_p = -(-p_orig // n_shards)
    shard_n = -(-n_orig // node_shards)
    fused_score = _resolve_engine(fused_score, shard_p, shard_n, mesh)
    args = _padded_inputs(prev, pweights, nweights, valid, stickiness,
                          gids, gid_valid, n_shards, node_shards)
    statics = dict(constraints=tuple(constraints),
                   rules=tuple(tuple(r) for r in rules),
                   fused_score=fused_score,
                   favor_min_nodes=bool(favor_min_nodes))
    rec = get_recorder()

    def strip(out, new_used, darrs):
        # The padded run's prices/packed ride along unused: the carry is
        # rebuilt off the node-stripped used table, and the session's
        # decode runs off ``current``/``proposed``, not the batch.
        assign = out.cpu().numpy()[:p_orig]
        used = new_used[:, :n_orig].contiguous()
        carry_out = SolveCarry(prices=used.sum(0),
                               assign=out[:p_orig].contiguous(), used=used)
        d_nodes, d_states, d_ops = (a.cpu().numpy()[:p_orig] for a in darrs)
        return assign, carry_out, (d_nodes, d_states, d_ops)

    if dirty is not None and carry is not None:
        dirty_p, cu = _warm_operands(dirty, carry, n_shards, node_shards)
        _observe_dirty(rec, dirty)
        t0 = rec.now()
        with rec.span("plan.pipeline.dispatch", warm=True, sharded=True), \
                _obs_device.entry("sharded.pipeline"):
            (out, _prices, new_used, ok, d_nodes, d_states, d_ops,
             _packed, _counts) = mesh.shard_map(
                "pipeline.warm", args + (dirty_p, cu),
                SOLVER_IN_LAYOUT + WARM_EXTRA_LAYOUT,
                PIPELINE_WARM_OUT_LAYOUT, **statics)
            accepted = bool(ok)
        rec.observe("plan.pipeline.dispatch_s", rec.now() - t0)
        _note_call(stats, mesh, accepted=accepted)
        if accepted:
            _tensor._record_sweeps(1)
            rec.set_attr("warm", True)
            return strip(out, new_used, (d_nodes, d_states, d_ops))
        rec.count("plan.solve.warm_fallback")
        rec.count("plan.solve.sweeps", 1)  # the executed repair pass
        if warm_only:
            return None

    t0 = rec.now()
    with rec.span("plan.pipeline.dispatch", sharded=True), \
            _obs_device.entry("sharded.pipeline"):
        (out, sweeps, _prices, new_used, d_nodes, d_states, d_ops,
         _packed, _counts) = mesh.shard_map(
            "pipeline.cold", args, SOLVER_IN_LAYOUT,
            PIPELINE_COLD_OUT_LAYOUT, max_iterations=int(max_iterations),
            **statics)
    rec.observe("plan.pipeline.dispatch_s", rec.now() - t0)
    _tensor._record_sweeps(sweeps)
    _note_call(stats, mesh, sweeps=int(sweeps))
    return strip(out, new_used, (d_nodes, d_states, d_ops))


def solve_problem_sharded(
    mesh: Mesh, problem: DenseProblem, fused_score: Optional[str] = None
) -> np.ndarray:
    """Convenience: solve an encoded DenseProblem on a mesh."""
    rules = tuple(tuple(problem.rules.get(si, ())) for si in range(problem.S))
    constraints = tuple(int(c) for c in problem.constraints)
    return solve_dense_sharded(
        mesh,
        problem.prev,
        problem.partition_weights,
        problem.node_weights,
        problem.valid_node,
        problem.stickiness,
        problem.gids,
        problem.gid_valid,
        constraints,
        rules,
        fused_score=fused_score,
    )


def shard_count(mesh: Optional[Mesh]) -> int:
    """The partition-axis size of ``mesh`` (1 without one)."""
    return 1 if mesh is None else _mesh_axes(mesh)[0]


def check_mesh(mesh, where: str, one_d: bool = False) -> None:
    """Reject a ``mesh=`` argument that is not a port Mesh (or, with
    ``one_d``, not a 1-D one) with a clear error."""
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"{where}: mesh must be a blance_tpu_torch.parallel Mesh "
            f"(make_mesh / make_mesh_2d), got {type(mesh).__name__}")
    if one_d and len(mesh.axis_names) != 1:
        raise ValueError(f"{where}: wants a 1-D mesh, got axes "
                         f"{mesh.axis_names}")
