"""Batched cost-tensor planner on PyTorch — port of blance_tpu/plan/tensor.py.

The dense cold-solve path, one function per reference function and under
the same name: the score of every partition against every node, and
each state/replica slot assigned in vectorized auction rounds (price ->
min2 -> two stable argsorts -> per-node prefix acceptance -> phase-B
waterfall -> capacity top-up), then a force step, the whole sweep
iterated to a fixpoint.  See the reference module's docstring for the
score formula and the auction's rules.

Three score engines sit behind ``_assign_slot``'s callables:

- "off" (the matrix engine): the [P, N] score matrix is built in plain
  PyTorch once per slot and reduced each round by the priced min2 kernel
  (ops/reduce2.py, csrc/min2.cu);
- "on" (the fused engine): the score is evaluated inside the kernel
  (ops/score_fused.py, csrc/score_fused.cu) and the matrix never exists;
- the sparse shortlist engine (``solve_sparse``): the same score formula
  evaluated only at each row's K candidate columns (core/shortlist.py),
  reduced each round by the sparse min2 kernel, which gathers each
  candidate's price from the [N] price row itself (ops/sparse2.py
  ``sparse_priced_min2_cand``, csrc/sparse_min2.cu), with fill, price
  and capacity kept at full [N] width.  Rows whose shortlist cannot
  serve a slot are re-placed by a per-row dense fallback on the host.

On CPU tensors the kernels run their plain PyTorch versions; on CUDA
tensors they launch the CUDA kernels.

What JAX compiles into one program runs here eagerly: ``lax.while_loop``
and ``lax.cond`` became Python loops and ``if``s over device tensors, so
every loop exit test and branch reads one scalar back to the host (one
sync per auction round, per slot branch and per sweep).  Making that
device-resident (CUDA graphs) is later work.

Bit-equality with the reference on the CPU rests on three rules kept
throughout: integer weights (float32 sums of whole numbers below 2**24
are exact in any order, so atomic ``index_add_`` order on CUDA cannot
change them); stable argsorts where JAX's are stable (all of them); and
the fill/jitter rounding of ops/score_fused.py (``fill_term``,
``jitter_add``).

Warm replans (``SolveCarry``, ``solve_dense_warm``, ``solve_sparse_warm``)
seed one repair sweep from the previous converged solve's per-state fill
and accept it only when it stayed inside the delta's dirty rows; the
acceptance flag is computed on the device and read once.  Sweeps, engine
choice and warm outcomes are counted on the port's recorder
(``blance_tpu_torch.obs``) under the reference's ``plan.solve.*`` names.
The fused plan pipeline (``plan_pipeline``, and the session's
``replan_with_moves`` through ``_dispatch_pipeline_cold`` and
``_pipeline_warm_impl``) runs the solve, the move diff and the decode
pack on the device and brings their outputs back in one copy.  Shape
bucketing (``PlanOptions.shape_bucketing``) pads a plan to a static
bucket with inert rows and columns and threads the real partition count
(``p_real``) to the fill term; custom placement hooks run on the exact
planner (``_cuda_supported``).

Sharding (parallel/sharded.py): the solver entries take the reference's
``axis_name`` / ``node_axis`` as ``axis`` / ``node_axis``, each an
``Axis`` of a port ``Mesh`` (parallel/mesh.py) or None (unsharded, where
every collective helper below is the identity).  The partition axis
psums the [N] fills, counts and flags; the node axis splits every
[P, N] intermediate by columns and combines the per-row min2 stats by
an all_gather.  Every host-read loop test or branch that guards a
collective is decided from a value every rank of that axis holds alike
(a psum'd flag, or math replicated after the node-axis combine), so no
rank issues a collective the others never reach.
"""

from __future__ import annotations

import contextlib
import time
import warnings as _warnings
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.encode import (NPArray, bucket_size, decode_assignment,
                           encode_problem, pack_assignment_core,
                           pad_problem_arrays)
from ..core.shortlist import (
    auto_shortlist_k,
    build_shortlist_core,
    shortlist_rules_nest,
)
from ..core.types import PartitionMap, PartitionModel, PlanOptions
from ..ops import launch_counts
from ..ops.reduce2 import priced_min2_argmin
from ..ops.sparse2 import sparse_priced_min2_cand
from ..convert import problem_to_torch, resolve_device
from ..ops.score_fused import (
    _ROW_CELLS,
    fill_term,
    fused_score_min2,
    jitter_add,
    pack_score_inputs,
    score_at_columns,
)
from ..moves.batch import diff_assignments, moves_from_arrays
from ..obs import device as _device
from ..obs import get_recorder
from ..obs.recorder import phase_span
from ..utils.trace import PhaseTimer
from .audit import maybe_validate

__all__ = ["plan_next_map_cuda", "solve_dense", "solve_dense_converged",
           "solve_converged_resilient", "resolve_fused_score",
           "resolve_default_fused_score",
           "set_fused_score_default", "check_dense_memory",
           "DenseScoreMemoryError", "projected_score_bytes",
           "set_dense_score_budget", "dense_score_budget_bytes",
           "solve_sparse", "sparse_rules_supported", "SolveCarry",
           "carry_from_assignment", "solve_dense_warm",
           "solve_sparse_warm", "plan_pipeline"]

Constraints = tuple[int, ...]
StateRules = tuple[tuple[int, int], ...]
Rules = tuple[StateRules, ...]

_INF = 1.0e9  # hard-forbidden
_RULE_MISS = 1.0e6  # satisfies no hierarchy rule (uniform => flat fallback)
_RULE_TIER = 1.0e4  # penalty step per rule index (earlier rules win)
_TIER_BAND_HEADROOM = 0.45  # max allowed within-tier mass, in tiers
_tier_scale_memo: dict[tuple[object, ...], object] = {}
_MAX_AUCTION_ROUNDS = 16
_JITTER = 1.0e-5

# Score-engine default for plan_next_map_cuda: "off" = matrix engine,
# "on" = in-kernel score, "auto" = resolved per problem size by
# resolve_fused_score.
_FUSED_SCORE_DEFAULT = "auto"

# Working-set model of the matrix engine, kept from the reference:
# ~20 bytes per [P, N] cell, against 60% of the card's memory.
_MATRIX_BYTES_PER_CELL = 20
_HBM_BUDGET_FRACTION = 0.6


def set_fused_score_default(mode: str) -> None:
    """Select the score engine for subsequent plan_next_map_cuda calls."""
    global _FUSED_SCORE_DEFAULT
    if mode not in ("off", "on", "auto"):
        raise ValueError(f"unknown fused-score mode: {mode!r}")
    _FUSED_SCORE_DEFAULT = mode


def _device_hbm_bytes(device: torch.device) -> int:
    """The card's memory; 16 GiB for the CPU, the reference's figure
    when the runtime reports no limit (the CPU tests)."""
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return 16 * 2 ** 30


def resolve_fused_score(mode: str, p: int, n: int,
                        device: torch.device) -> str:
    """Resolve "auto" to a concrete engine for a [P, N]-sized problem:
    "on" when the matrix engine's working set would exceed 60% of the
    card's memory, "off" otherwise.  On the CPU there is no kernel, so
    auto is always "off" (the reference's choice without Pallas)."""
    if mode != "auto":
        return mode
    if device.type != "cuda":
        return "off"
    if p * n * _MATRIX_BYTES_PER_CELL > \
            _HBM_BUDGET_FRACTION * _device_hbm_bytes(device):
        return "on"
    return "off"


def resolve_default_fused_score(p: int, n: int,
                                 device: torch.device) -> str:
    """The module default (``set_fused_score_default``) resolved for a
    [P, N] problem on ``device``: the one spelling plan_next_map_cuda
    and PlannerSession.replan share."""
    return resolve_fused_score(_FUSED_SCORE_DEFAULT, p, n, device)


# --- dense-memory guard ------------------------------------------------------

# Byte budget of the guard and of the sparse auto-routing; None = 60% of
# the device's memory.
_DENSE_GUARD_BUDGET: Optional[int] = None


def set_dense_score_budget(n_bytes: Optional[int]) -> None:
    """Override the dense-memory budget (None = derive from the device
    again)."""
    global _DENSE_GUARD_BUDGET
    if n_bytes is not None and int(n_bytes) <= 0:
        raise ValueError(f"budget must be positive, got {n_bytes}")
    _DENSE_GUARD_BUDGET = None if n_bytes is None else int(n_bytes)


def dense_score_budget_bytes(device: torch.device) -> int:
    """The byte budget the dense-memory guard enforces on ``device``."""
    if _DENSE_GUARD_BUDGET is not None:
        return _DENSE_GUARD_BUDGET
    return int(_HBM_BUDGET_FRACTION * _device_hbm_bytes(device))


def projected_score_bytes(p: int, n: int) -> int:
    return int(p) * int(n) * _MATRIX_BYTES_PER_CELL


class DenseScoreMemoryError(ValueError):
    """The matrix engine's projected [P, N] footprint exceeds the
    memory budget (``projected_bytes`` / ``budget_bytes`` / ``shape``)."""

    def __init__(self, projected_bytes: int, budget_bytes: int,
                 shape: tuple[int, ...]):
        self.projected_bytes = int(projected_bytes)
        self.budget_bytes = int(budget_bytes)
        self.shape = tuple(shape)
        p, s, n = shape
        super().__init__(
            f"dense score sweep would materialize ~"
            f"{projected_bytes / 2**30:.1f} GiB of [P, N] intermediates "
            f"(P={p}, S={s}, N={n}, ~{_MATRIX_BYTES_PER_CELL} B/cell) — "
            f"over the {budget_bytes / 2**30:.1f} GiB budget; use the "
            f"sparse shortlist engine (PlanOptions(sparse=True)) or the "
            f"in-kernel fused engine (set_fused_score_default('on'))")


def check_dense_memory(p: int, s: int, n: int, engine: str,
                       device: torch.device) -> None:
    """Raise DenseScoreMemoryError when the MATRIX engine is about to
    materialize a [P, N] score sweep past the budget (60% of the
    device's memory unless overridden)."""
    if engine != "off":
        return
    projected = projected_score_bytes(p, n)
    budget = dense_score_budget_bytes(device)
    if projected > budget:
        raise DenseScoreMemoryError(projected, budget, (p, s, n))


class SolveCarry(NamedTuple):
    """Auction state carried across delta replans (the warm start), as
    tensors on the solve's device.

    ``used`` is the ground truth: [S, N] per-state per-node accepted
    weight, built with the same per-state scatter the solver's seed pass
    runs, so seeding a sweep from it is bitwise a recompute from
    ``assign``.  ``prices`` [N] is its per-node sum (the fill vector the
    balance term divides), kept for O(N) host prechecks.  ``assign``
    [P, S, R] is the converged assignment the carry matches; a carry is
    valid only against a ``prev`` equal to it (sessions check identity
    of the host array, plan/carry.py)."""

    prices: torch.Tensor
    assign: torch.Tensor
    used: torch.Tensor


def _used_by_state(assign: torch.Tensor, pweights: torch.Tensor, n: int,
                   s: int, axis=None) -> torch.Tensor:
    """[S, N] per-state weighted fill: one ``_scatter_counts`` per state,
    in state order, as the seed pass of ``_solve_assign`` runs them
    ([B, S, N] for a batch of assignments [B, P, S, R]); psum'd over the
    partition ``axis`` when sharded."""
    return _psum(torch.stack([_scatter_counts(assign[..., si, :], pweights,
                                              n)
                              for si in range(s)], dim=-2), axis)


def carry_from_assignment(assign, pweights: torch.Tensor,
                          nweights: torch.Tensor) -> SolveCarry:
    """Package a converged assignment (tensor or numpy) as a SolveCarry
    on ``pweights``' device."""
    if not isinstance(assign, torch.Tensor):
        assign = torch.from_numpy(np.array(assign, dtype=np.int32))
    assign = assign.to(pweights.device, torch.int32)
    used = _used_by_state(assign, pweights, nweights.shape[0],
                          assign.shape[1])
    return SolveCarry(prices=used.sum(0), assign=assign, used=used)


# --- helpers -----------------------------------------------------------------
#
# Every dense helper below takes one problem ([P]-, [N]-, [P, ...]-shaped
# tensors) or a batch of same-shaped problems (the same tensors with a
# leading [B] axis: the fleet tier).  Scans, sorts, reductions, gathers and
# scatters run on the last axis, per batch element, so a batch element's
# arithmetic is the single problem's.  Each helper reads the batch rank off
# an argument whose unbatched rank it knows.


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along the last axis, per batch element: ``x`` [*B, N] at
    ``idx`` [*B, *rest] (any trailing shape) gives [*B, *rest]."""
    flat = idx.reshape(*idx.shape[:x.dim() - 1], -1).long()
    return torch.gather(x, -1, flat).reshape(idx.shape)


def _take_rows(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``x[rows]`` for [*B, P, W] rows at ``rows`` [*B, K]: [*B, K, W]."""
    idx = rows.long()[..., None].expand(*rows.shape, x.shape[-1])
    return torch.gather(x, -2, idx)


def _drop_empty(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Map empty (-1) ids to n, the drop bucket of an [n + 1] scatter.
    A raw -1 must never wrap onto the last node."""
    return torch.where(ids >= 0, ids, n)


def _scatter_add(n: int, ids: torch.Tensor, w: torch.Tensor,
                 nb: int = 0) -> torch.Tensor:
    """``zeros(n).at[ids].add(w, mode="drop")`` with -1 (and n) dropped:
    a scatter-add into an [n + 1] buffer, then sliced.  On CUDA the adds
    are atomic and unordered; the weights are whole numbers, so float32
    sums below 2**24 come out exact in any order.  With ``nb`` = 1 the
    first axis of ``ids`` and ``w`` is a batch: one [n] histogram per
    element, [B, n]."""
    lead = ids.shape[:nb]
    out = torch.zeros(*lead, n + 1, dtype=torch.float32, device=w.device)
    out.scatter_add_(-1, _drop_empty(ids, n).long().reshape(*lead, -1),
                     w.to(torch.float32).reshape(*lead, -1))
    return out[..., :n]


def _scatter_counts(ids: torch.Tensor, weights: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Weighted histogram of node ids [P, R] -> [N]; -1 entries dropped."""
    w = weights[..., None].expand(ids.shape)
    return _scatter_add(n, ids, w, weights.dim() - 1)


def _anchor_rule_sat(
    anchor: torch.Tensor,  # [P] global node ids, -1 = absent
    cand_inc: torch.Tensor,  # candidates' include-level gids, [P] or [1, N]
    cand_exc: torch.Tensor,
    gids: torch.Tensor,
    gid_valid: torch.Tensor,
    inc: int,
    exc: int,
) -> torch.Tensor:
    """Rule gate for ONE anchor column: the candidate shares the anchor's
    include-level ancestor and NOT its exclude-level ancestor; absent
    anchors satisfy everything; validity gates on the anchor side."""
    aa = anchor.clamp(min=0)
    sh = anchor.shape + (1,) * (cand_inc.dim() - anchor.dim())
    inc_same = (_take(gids[..., inc, :], aa).reshape(sh) == cand_inc) & \
        _take(gid_valid[..., inc, :], aa).reshape(sh)
    exc_same = (_take(gids[..., exc, :], aa).reshape(sh) == cand_exc) & \
        _take(gid_valid[..., exc, :], aa).reshape(sh)
    return torch.where((anchor >= 0).reshape(sh), inc_same & ~exc_same, True)


def _hier_penalty(
    anchors: torch.Tensor,  # [P, A] GLOBAL node ids, -1 = absent anchor
    gids: torch.Tensor,  # [L, N]
    gid_valid: torch.Tensor,  # [L, N]
    rules: StateRules,
    gids_cand: Optional[torch.Tensor] = None,  # [L, N_l]
) -> torch.Tensor:
    """Tiered rule penalty [P, N] anchored on every prior pick at once:
    the first rule every present anchor satisfies sets the tier (index
    * 1e4); satisfying none costs _RULE_MISS; no anchor costs 0."""
    if gids_cand is None:
        gids_cand = gids
    p, a_width = anchors.shape[-2:]
    shape = anchors.shape[:-2] + (p, gids_cand.shape[-1])
    dev = anchors.device
    any_anchor = (anchors >= 0).any(dim=-1)
    pen = torch.full(shape, _RULE_MISS, dtype=torch.float32, device=dev)
    for idx, (inc, exc) in enumerate(rules):
        sat = torch.ones(shape, dtype=torch.bool, device=dev)
        for ai in range(a_width):
            sat &= _anchor_rule_sat(
                anchors[..., ai], gids_cand[..., inc, :].unsqueeze(-2),
                gids_cand[..., exc, :].unsqueeze(-2), gids, gid_valid, inc,
                exc)
        pen = torch.where(sat, pen.clamp(max=idx * _RULE_TIER), pen)
    return torch.where(any_anchor[..., None], pen, 0.0)


def _hier_tier_at(
    anchors: torch.Tensor,  # [P, A] global node ids, -1 absent
    node: torch.Tensor,  # [P] or [P, K] global node ids
    gids: torch.Tensor,
    gid_valid: torch.Tensor,
    rules: StateRules,
) -> torch.Tensor:
    """_hier_penalty evaluated at gathered columns — O(rows * cols)."""
    any_anchor = (anchors >= 0).any(dim=-1)
    sh = any_anchor.shape + (1,) * (node.dim() - any_anchor.dim())
    nd = node.clamp(0, gids.shape[-1] - 1)
    pen = torch.full(node.shape, _RULE_MISS, dtype=torch.float32,
                     device=node.device)
    for idx, (inc, exc) in enumerate(rules):
        sat = torch.ones(node.shape, dtype=torch.bool, device=node.device)
        for ai in range(anchors.shape[-1]):
            sat &= _anchor_rule_sat(
                anchors[..., ai], _take(gids[..., inc, :], nd),
                _take(gids[..., exc, :], nd), gids, gid_valid, inc, exc)
        pen = torch.where(sat, pen.clamp(max=idx * _RULE_TIER), pen)
    return torch.where(any_anchor.reshape(sh), pen, 0.0)


def _hier_floor_counts(
    anchors: torch.Tensor,  # [P, A] global node ids, -1 absent
    gids: torch.Tensor,
    gid_valid: torch.Tensor,
    valid: torch.Tensor,  # [N]
    rules: StateRules,
    taken_stack: Optional[torch.Tensor] = None,  # [P, T] GLOBAL node ids
) -> torch.Tensor:
    """Best attainable rule tier over valid nodes, by GROUP COUNTING
    (exclude groups nest inside include groups for rules with
    exclude < include): [N] histograms plus [P] gathers instead of a
    [P, N] row-min.  Returns the floor penalty [P], 0.0 with no anchor."""
    p, a_width = anchors.shape[-2:]
    lead = anchors.shape[:-2]
    n = gids.shape[-1]
    dev = anchors.device
    any_anchor = (anchors >= 0).any(dim=-1)
    floor = torch.full(lead + (p,), _RULE_MISS, dtype=torch.float32,
                       device=dev)
    ones = torch.ones(lead + (n,), dtype=torch.float32, device=dev)
    for idx, (inc, exc) in enumerate(rules):
        g_inc, g_exc = gids[..., inc, :], gids[..., exc, :]
        gi = torch.where(valid, g_inc, -1)
        ge = torch.where(valid, g_exc, -1)
        cnt_inc = _scatter_add(n, gi, ones, len(lead))
        cnt_exc = _scatter_add(n, ge, ones, len(lead))

        # Shared include group across present anchors (else unsatisfiable).
        g = torch.full(lead + (p,), -1, dtype=torch.int32, device=dev)
        ok = torch.ones(lead + (p,), dtype=torch.bool, device=dev)
        for ai in range(a_width):
            a = anchors[..., ai]
            aa = a.clamp(min=0)
            a_g = torch.where(_take(gid_valid[..., inc, :], aa),
                              _take(g_inc, aa), -2)
            present = a >= 0
            ok &= torch.where(present & (g >= 0), a_g == g, True)
            ok &= torch.where(present & (g < 0), a_g >= 0, True)
            g = torch.where(present & (g < 0), a_g, g)

        # Exclusion mass: distinct exclude groups among present anchors.
        excl = torch.zeros(lead + (p,), dtype=torch.float32, device=dev)
        e_seen: list[torch.Tensor] = []
        for ai in range(a_width):
            a = anchors[..., ai]
            aa = a.clamp(min=0)
            e = torch.where((a >= 0) & _take(gid_valid[..., exc, :], aa),
                            _take(g_exc, aa), -1)
            dup = torch.zeros(lead + (p,), dtype=torch.bool, device=dev)
            for prev_e in e_seen:
                dup |= (e == prev_e) & (e >= 0)
            excl += torch.where((e >= 0) & ~dup,
                                _take(cnt_exc, e.clamp(0, n - 1)), 0.0)
            e_seen.append(e)

        count = torch.where(ok & (g >= 0),
                            _take(cnt_inc, g.clamp(0, n - 1)) - excl, 0.0)

        # Taken-aware: the row's own occupied nodes in the include group
        # but outside every counted exclude group are not attainable.
        if taken_stack is not None:
            t_seen: list[torch.Tensor] = []
            for ti in range(taken_stack.shape[-1]):
                u = taken_stack[..., ti]
                uu = u.clamp(0, n - 1)
                ok_u = (u >= 0) & _take(valid, uu)
                in_g = ok_u & (_take(g_inc, uu) == g) & (g >= 0)
                in_excl = torch.zeros(lead + (p,), dtype=torch.bool,
                                      device=dev)
                for e in e_seen:
                    in_excl |= (e >= 0) & (_take(g_exc, uu) == e)
                dup = torch.zeros(lead + (p,), dtype=torch.bool, device=dev)
                for prev_u in t_seen:
                    dup |= (u == prev_u) & (u >= 0)
                count = count - torch.where(in_g & ~in_excl & ~dup, 1.0, 0.0)
                t_seen.append(u)

        floor = torch.where(count > 0, floor.clamp(max=idx * _RULE_TIER),
                            floor)
    return torch.where(any_anchor, floor, 0.0)


def _member_ids(ids: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """[P, K] GLOBAL node ids x [N] column ids -> [P, N] membership, as K
    broadcast compares ORed together; -1 ids never match."""
    out = None
    for k in range(ids.shape[-1]):
        m = ids[..., k, None] == cols
        out = m if out is None else (out | m)
    if out is None:  # K == 0
        return torch.zeros(ids.shape[:-1] + cols.shape, dtype=torch.bool,
                           device=ids.device)
    return out


def _in_id_list(node: torch.Tensor,
                id_list: list[torch.Tensor]) -> torch.Tensor:
    """[P] node id -> [P] bool: held by any of the [P] id columns."""
    out = torch.zeros(node.shape, dtype=torch.bool, device=node.device)
    for ids in id_list:
        out = out | ((node == ids) & (node >= 0))
    return out


# --- collectives over a mesh axis --------------------------------------------
#
# ``axis`` / ``node_axis`` are parallel.mesh.Axis objects or None; None is
# the unsharded solve, where each helper is the identity (the reference's
# ``lax.psum(x, axis_name) if axis_name else x``).  Under a 2-D mesh every
# [N] vector stays replicated along the node axis while the [P, N] score
# holds only this shard's columns; the node-axis collectives combine the
# per-row min2 stats and fetch a matrix value at a remote column.


def _psum(x: torch.Tensor, axis) -> torch.Tensor:
    return axis.psum(x) if axis is not None else x


def _flag_any(flag: torch.Tensor, axis) -> torch.Tensor:
    """``any`` of a 0-d bool across the axis (psum of its int32 > 0)."""
    if axis is None:
        return flag
    return axis.psum(flag.to(torch.int32)) > 0


def _node_off(node_axis, n_l: int) -> int:
    """Global column offset of this node shard."""
    return node_axis.index * n_l if node_axis is not None else 0


def _node_slice(vec: torch.Tensor, node_axis, n_l: int) -> torch.Tensor:
    """Local [.., N_l] slice of a node-replicated [.., N] array."""
    if node_axis is None:
        return vec
    off = _node_off(node_axis, n_l)
    return vec[..., off:off + n_l]


def _gather_cols(mat: torch.Tensor, rows: torch.Tensor,
                 cols_global: torch.Tensor, node_axis=None) -> torch.Tensor:
    """mat[rows, cols] with global column ids: the owner shard supplies
    the value, a masked psum over the node axis delivers it everywhere
    (one device: global column ids are local)."""
    n_l = mat.shape[-1]
    loc = cols_global.long() - _node_off(node_axis, n_l)
    vals = _take(mat.flatten(-2), rows.long() * n_l + loc.clamp(0, n_l - 1))
    if node_axis is None:
        return vals
    ok = (loc >= 0) & (loc < n_l)
    return node_axis.psum(torch.where(ok, vals, 0.0))


def _row_min_global(mat: torch.Tensor, node_axis) -> torch.Tensor:
    """Per-row min over the full (sharded) column axis."""
    m = mat.amin(dim=-1)
    return node_axis.pmin(m) if node_axis is not None else m


def _combine_min2(best_l, choice_g, second_l, raw_l, node_axis):
    """Merge per-shard (min, argmin, second, raw-at-min) into global
    stats: global second = min(second of the winning shard, best of
    every other shard); ties in best break toward the lowest shard
    index, the lowest global node id.  The four [P] rows ride one
    all_gather (the int32 choice bit-cast into the float32 block)."""
    if node_axis is None:
        return best_l, choice_g, second_l, raw_l
    block = torch.stack([best_l, choice_g.to(torch.int32).view(
        torch.float32), second_l, raw_l])
    g = node_axis.all_gather(block)  # [ns, 4, P]
    bests, seconds, raws = g[:, 0], g[:, 2], g[:, 3]
    choices = g[:, 1].contiguous().view(torch.int32)
    ns = bests.shape[0]
    k_star = torch.argmin(bests, dim=0)  # first min: the lowest shard

    def take(a):
        return a.gather(0, k_star[None, :])[0]

    others = torch.where(
        torch.arange(ns, device=bests.device)[:, None] == k_star[None, :],
        float("inf"), bests)
    second = torch.minimum(take(seconds), others.amin(dim=0))
    return take(bests), take(choices), second, take(raws)


def _shard_capacity(cap: torch.Tensor, axis) -> torch.Tensor:
    """Split global per-node capacity into integral per-shard shares:
    floor(cap / ns) each, the remainder rotated by node id and shard
    index so no shard systematically holds the extras."""
    if axis is None:
        return cap
    ns, idx = axis.size, axis.index
    base_cap = torch.floor(cap / ns)
    rem = cap - base_cap * ns
    node_ids = torch.arange(cap.shape[-1], dtype=torch.int32,
                            device=cap.device)
    extra = ((node_ids + idx) % ns) < rem.to(torch.int32)
    return base_cap + extra.to(torch.float32)


def _segment_accept(
    node_s: torch.Tensor,  # [K] node ids, sorted so equal nodes are adjacent
    ok_s: torch.Tensor,  # [K] participating entries
    w_s: torch.Tensor,  # [K] weights (0 where not participating)
    cap_here: torch.Tensor,  # [K] per-entry capacity budget (node's cap)
) -> torch.Tensor:
    """Per-node prefix acceptance: keep entries while the running weight
    on their node fits ``cap_here``; the first entry per node always fits
    if the node has any capacity (the auction's progress rule).  The
    scans run per batch element, so no element's weight enters another's
    prefix."""
    csum = torch.cumsum(w_s, dim=-1)
    ecs = csum - w_s  # exclusive prefix over ALL entries
    seg_start = torch.cat(
        [torch.ones(node_s.shape[:-1] + (1,), dtype=torch.bool,
                    device=node_s.device),
         node_s[..., 1:] != node_s[..., :-1]], dim=-1)
    seg_base = torch.cummax(
        torch.where(seg_start, ecs, -float("inf")), dim=-1).values
    before_me = ecs - seg_base  # weight of earlier entries on my node
    return ok_s & (
        (before_me + w_s <= cap_here) | (before_me == 0.0) & (cap_here > 0))


def _scatter_set(p: int, perm: torch.Tensor, vals: torch.Tensor,
                 fill=False) -> torch.Tensor:
    """``full(p, fill).at[perm].set(vals)`` for a permutation ``perm``
    (per batch element for [B, P])."""
    out = torch.full(perm.shape, fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_(-1, perm.long(), vals)


def _pin_prev_holders(
    prev_slot: torch.Tensor,  # [P] node id or -1
    pin_ok: torch.Tensor,  # [P] eligible to keep its previous node
    pweights: torch.Tensor,  # [P]
    cap: torch.Tensor,  # [N] capacity for this state
    slack: torch.Tensor,  # [P] per-holder capacity tolerance (stickiness)
    load_div: Optional[torch.Tensor] = None,  # [N] node weight (>= 1)
    taken_stack: Optional[torch.Tensor] = None,  # [P, T] GLOBAL node ids
    axis=None,  # the partition axis (sharded solve) or None
) -> torch.Tensor:
    """Capacity-capped warm start: returns pinned[P] bool.

    The keep-ceiling per node is max(fair-share quota, (least-loaded open
    node's load + stickiness) * node_weight); holders barred from the
    emptiest node by exclusivity keep their place first, then partition
    order; the first holder per node always stays.  ``lax.cond`` became an
    ``if`` on one host-read flag; over a batch, the trim runs when any
    element needs it and is selected back per element (vmap's rule).

    Sharded over ``axis``, load and over-capacity are global questions
    (the held weight is psum'd, so every shard takes the same branch),
    while the trim quota and the lmin band are the shard's share: each
    shard orders only its own holders."""
    p = prev_slot.shape[-1]
    n = cap.shape[-1]
    nb = cap.dim() - 1
    dev = prev_slot.device
    pin_w = torch.where(pin_ok, pweights, 0.0)
    node_w = _psum(_scatter_add(n, prev_slot, pin_w, nb), axis)
    div = load_div if load_div is not None else \
        torch.ones(n, dtype=torch.float32, device=dev)
    load = node_w / div
    inf = torch.tensor(float("inf"), device=dev)
    lmin = torch.where(cap > 0, load, inf).amin(dim=-1, keepdim=True) \
        if n else inf

    need = (node_w > cap).any(dim=-1)
    if not bool(need.any()):
        # Common case (caps only grew): every eligible holder fits.
        return pin_ok
    if taken_stack is not None:
        deficit_node = torch.argmin(torch.where(cap > 0, load, inf), dim=-1)
        blocked = (taken_stack == deficit_node[..., None, None]).any(dim=-1)
        perm1 = torch.argsort((~blocked).to(torch.int32), dim=-1,
                              stable=True)
    else:
        perm1 = torch.arange(p, device=dev).expand(prev_slot.shape)
    sort_node = torch.where(pin_ok, prev_slot, n)
    perm2 = torch.argsort(_take(sort_node, perm1), dim=-1,
                          stable=True)  # groups by node
    perm = _take(perm1, perm2)
    node_s = _take(sort_node, perm)
    ok_s = _take(pin_ok, perm)
    w_s = torch.where(ok_s, _take(pweights, perm), 0.0)
    nclip = node_s.clamp(0, n - 1)
    band = (lmin + _take(slack, perm)) * _take(div, nclip)
    if axis is not None:
        band = band / axis.size
    cap_here = torch.maximum(_take(_shard_capacity(cap, axis), nclip), band)
    keep_s = _segment_accept(node_s, ok_s, w_s, cap_here)
    keep = _scatter_set(p, perm, keep_s)
    return torch.where(need[..., None], keep, pin_ok)


def _sparse_score_cols(
    cols: torch.Tensor,  # [M, K] GLOBAL node ids; -1 = pad (scores +_INF)
    rows: torch.Tensor,  # [M] local row ids
    pbase: int = 0,  # global partition index of local row 0 (jitter)
    *,
    total: torch.Tensor,  # [N] fill vector
    total_p,  # partition count, or the 0-d p_real tensor (fill_term)
    w_div: torch.Tensor,  # [N]
    neg_boost: torch.Tensor,  # [N]
    valid: torch.Tensor,  # [N] bool
    gids: torch.Tensor,
    gid_valid: torch.Tensor,
    stick_si: torch.Tensor,  # [P]
    prev_slot: torch.Tensor,  # [P] global ids
    prev_state: torch.Tensor,  # [P, R]
    taken_ids: tuple[torch.Tensor, ...],
    anchors: Optional[torch.Tensor],  # [P, A] (rules only)
    rules: StateRules,
    jitter_scale: float,
) -> torch.Tensor:
    """The matrix engine's score formula at gathered columns, [M, K]:
    term order as ``_matrix_score``, so a saturating shortlist (row r's
    columns = 0..N-1) gives the dense matrix bitwise.  Pad columns score
    +_INF like any forbidden node.  O(M * K); no [P, N] tensor."""
    n = w_div.shape[0]
    c = cols.clamp(0, n - 1)
    cl = c.long()
    okc = cols >= 0
    st = stick_si[rows][:, None]
    score = fill_term(total[cl], total_p, w_div[cl])
    score = score - 0.01 * ((prev_slot[rows][:, None] == cols) & okc)
    nb = neg_boost[cl]
    score = score + torch.maximum(nb, torch.where(nb > 0, st, 0.0))
    sticky = torch.zeros(cols.shape, dtype=torch.bool, device=cols.device)
    for r in range(prev_state.shape[1]):
        sticky = sticky | ((prev_state[rows, r][:, None] == cols) & okc)
    score = score - st * sticky
    if rules:
        score = score + _hier_tier_at(anchors[rows], c, gids, gid_valid,
                                      rules)
    taken = torch.zeros(cols.shape, dtype=torch.bool, device=cols.device)
    for tid in taken_ids:
        taken = taken | ((tid[rows][:, None] == cols) & okc)
    score = score + _INF * (taken | ~valid[cl] | ~okc)
    pi = (pbase + rows)[:, None].to(torch.int32)
    return jitter_add(score, pi, c.to(torch.int32), jitter_scale)


def _assign_slot(
    min2_fn: Callable,  # price_vec[N] -> (best, choice, second, raw)
    score_at_fn: Callable,  # (rows[K], cols[K]) -> unpriced score [K]
    p: int,
    pweights: torch.Tensor,  # [P]
    cap: torch.Tensor,  # [N] weighted capacity for this slot
    price_scale: torch.Tensor,  # [N] accepted weight -> score units
    init_assign: Optional[torch.Tensor] = None,  # [P] warm start (or -1)
    init_used: Optional[torch.Tensor] = None,  # [N] weight behind it
    topup_share: Optional[torch.Tensor] = None,  # [N] top-up share
    has_rules: bool = True,
    feasible_hint: Optional[torch.Tensor] = None,  # [P] bool
    allow: Optional[torch.Tensor] = None,  # [P] bool: rows that may take
    # this slot at all (the sparse engine's shortlist gate); the others
    # neither bid nor get forced and stay -1
    axis=None,  # the partition axis (sharded solve) or None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Auction: returns (slot_assign[P] int32 node id or -1, used[N]).

    Each round: bid on the best open node, accept most-urgent bidders up
    to remaining capacity (at least the first bidder per node), pour the
    rejected ones into the remaining capacity of nodes ordered by price
    (phase B), raise the rail by ``topup_share`` when a round stalls with
    feasible bidders left; then force whatever is left onto its best
    feasible node.  The JAX ``while_loop`` is a Python loop that reads its
    exit flag back to the host once per round.

    Over a batch ([B, P] / [B, N]) the loop runs while any element runs,
    and an element whose own exit test failed keeps its carry (the rule
    ``vmap`` gives a ``while_loop`` with a batched predicate); the force
    step runs when any element has an unassigned row and adds 0.0 to the
    others' fill, which leaves it bitwise unchanged.  Rounds run are
    counted in ``_assign_slot.rounds``.

    Partition axis: the rounds are shard-local (the caller hands each
    shard its share of capacity and psums the returned usage), so shards
    may run different round counts; the force step prices on the psum'd
    usage, and that psum runs on every shard whether or not its force
    step does.  Node axis: the callables see only this shard's columns
    and combine their stats inside ``min2_fn``; ``unassigned`` and every
    [N] table are identical on the node shards of a row, so all of them
    take the same loop exits and branches."""
    n = cap.shape[-1]
    nb = cap.dim() - 1
    dev = pweights.device
    zeros_n = torch.zeros_like(cap)

    if has_rules:
        raw_best_all, _, _, _ = min2_fn(zeros_n)
        hard_feasible = raw_best_all < _INF / 2
    else:
        raw_best_all = None
        hard_feasible = feasible_hint
    if allow is not None and hard_feasible is not None:
        hard_feasible = hard_feasible & allow

    if init_assign is None:
        init_assign = torch.full(pweights.shape, -1, dtype=torch.int32,
                                 device=dev)
    if init_used is None:
        init_used = zeros_n
    slot_assign = init_assign
    unassigned = init_assign < 0
    rem_cap = cap - init_used
    used = init_used
    progress = torch.ones(cap.shape[:-1], dtype=torch.bool, device=dev)
    it = 0

    while it < _MAX_AUCTION_ROUNDS:
        run = unassigned.any(dim=-1) & progress
        if not bool(run.any().item()):
            break
        carry0 = (slot_assign, unassigned, rem_cap, used, progress)
        price_vec = used * price_scale + torch.where(rem_cap > 0, 0.0, _INF)
        best, choice, second, raw_choice = min2_fn(price_vec)
        margin = torch.clamp(
            torch.nan_to_num(second - best, nan=0.0, posinf=10.0), 0.0, 10.0)

        if has_rules:
            rule_ok = (raw_choice < raw_best_all + _RULE_TIER * 0.5) | \
                (raw_best_all >= _RULE_MISS / 2)
            active = unassigned & (best < _INF / 2) & rule_ok
        else:
            active = unassigned & (best < _INF / 2)
        if allow is not None:
            active = active & allow

        # Sort bidders by (node, urgency desc) via two stable argsorts;
        # inactive bidders sort to the end.
        inv_margin = torch.where(active, -margin, float("inf"))
        sort_choice = torch.where(active, choice, n)
        perm1 = torch.argsort(inv_margin, dim=-1, stable=True)
        perm2 = torch.argsort(_take(sort_choice, perm1), dim=-1, stable=True)
        perm = _take(perm1, perm2)

        choice_s = _take(choice, perm)
        w_s = _take(pweights, perm)
        active_s = _take(active, perm)
        accept_s = _segment_accept(
            choice_s, active_s, torch.where(active_s, w_s, 0.0),
            _take(rem_cap, choice_s))

        accept = _scatter_set(p, perm, accept_s)
        slot_assign = torch.where(accept, choice, slot_assign)
        unassigned = unassigned & ~accept

        used_round = _scatter_add(n, choice, torch.where(accept, pweights,
                                                         0.0), nb)
        rem_cap = rem_cap - used_round
        used = used + used_round

        # Phase B — waterfall into the remaining capacity by price.
        price = used * price_scale
        node_order = torch.argsort(price, dim=-1, stable=True)
        rem_sorted = _take(rem_cap.clamp(min=0.0), node_order)
        cum_rem = torch.cumsum(rem_sorted, dim=-1)

        straggler = active & ~accept
        skey = torch.where(straggler, -margin, float("inf"))
        sperm = torch.argsort(skey, dim=-1, stable=True)
        s_mask = _take(straggler, sperm)
        s_w = torch.where(s_mask, _take(pweights, sperm), 0.0)
        s_excl = torch.cumsum(s_w, dim=-1) - s_w
        pos = torch.searchsorted(cum_rem, s_excl + 0.5 * s_w, right=True)
        in_range = pos < n
        choice2 = _take(node_order, pos.clamp(0, n - 1)).to(torch.int32)

        raw2 = score_at_fn(sperm, choice2)
        hard_ok = raw2 < _INF / 2
        if has_rules:
            best_s = _take(raw_best_all, sperm)
            soft_ok = (raw2 < best_s + _RULE_TIER * 0.5) | \
                (best_s >= _RULE_MISS / 2)
            accept2_s = s_mask & in_range & hard_ok & soft_ok
        else:
            accept2_s = s_mask & in_range & hard_ok

        accept2 = _scatter_set(p, sperm, accept2_s)
        choice2_un = _scatter_set(p, sperm, choice2, fill=0)
        slot_assign = torch.where(accept2, choice2_un, slot_assign)
        unassigned = unassigned & ~accept2

        used2 = _scatter_add(n, choice2_un, torch.where(accept2, pweights,
                                                        0.0), nb)
        rem_cap = rem_cap - used2
        used = used + used2

        progress = (accept | accept2).any(dim=-1)
        if topup_share is not None:
            rem_w = torch.where(unassigned & hard_feasible, pweights,
                                0.0).sum(dim=-1, keepdim=True)
            stalled = ~progress[..., None] & (rem_w > 0)
            topup = torch.ceil(rem_w * topup_share)
            rem_cap = torch.where(stalled, rem_cap + topup, rem_cap)
            progress = progress | (stalled[..., 0] & (topup > 0).any(dim=-1))
        # Elements whose exit test failed keep their carry.
        slot_assign, unassigned, rem_cap, used, progress = (
            torch.where(run.reshape(run.shape + (1,) * (new.dim()
                                                       - run.dim())),
                        new, old)
            for new, old in zip((slot_assign, unassigned, rem_cap, used,
                                 progress), carry0))
        it += 1
        _assign_slot.rounds += 1

    # Force step: remaining partitions take their best feasible node,
    # ignoring capacity, priced on the global usage; skipped when the
    # rounds assigned everyone.
    used_global = _psum(used, axis)
    if bool(unassigned.any()):
        best, choice, _second, _raw = min2_fn(used_global * price_scale)
        forced = unassigned & (best < _INF / 2)
        if allow is not None:
            forced = forced & allow
        slot_assign = torch.where(forced, choice, slot_assign)
        used = used + _scatter_add(n, choice, torch.where(forced, pweights,
                                                          0.0), nb)
    return slot_assign, used


_assign_slot.rounds = 0


def _matrix_score(total, total_p, w_div, neg_boost, valid, stick_si,
                  prev_slot, prev_state_ids, anchors, gids, gid_valid,
                  state_rules: StateRules, taken_ids, pbase: int = 0,
                  noff: int = 0, gids_cand=None) -> torch.Tensor:
    """The matrix engine's score[P, N] ([B, P, N] for a batch), term
    order as the reference's build (tensor.py:1526-1560), in row chunks
    so that temporaries stay bounded at any P.  The fill term is
    ``fill_term`` (XLA's fold of ``0.001 * total / P``, or its one
    division under a traced ``p_real``) and the jitter add rounds once
    (``jitter_add``, XLA's fused multiply-add).  The jitter hashes
    GLOBAL row and column ids: under sharding ``total``, ``w_div``,
    ``neg_boost`` and ``valid`` are this node shard's [N_l] slices,
    ``gids_cand`` its [L, N_l] candidate gids, ``noff`` its first column
    and ``pbase`` the global index of local row 0."""
    p = prev_slot.shape[-1]
    n = total.shape[-1]
    lead = total.shape[:-1]
    dev = total.device
    cols = torch.arange(n, dtype=torch.int32, device=dev) + noff
    score_row = fill_term(total, total_p, w_div).unsqueeze(-2)
    nb = neg_boost.unsqueeze(-2)
    bad = ~valid.unsqueeze(-2)
    taken = torch.stack(list(taken_ids), dim=-1) if taken_ids else None
    out = torch.empty(lead + (p, n), dtype=torch.float32, device=dev)
    step = max(1, _ROW_CELLS // max(n * int(np.prod(lead, dtype=np.int64)),
                                    1))
    for lo in range(0, p, step):
        hi = min(p, lo + step)
        st = stick_si[..., lo:hi, None]
        score = score_row - 0.01 * _member_ids(prev_slot[..., lo:hi, None],
                                               cols)
        score = score + torch.maximum(nb, torch.where(nb > 0, st, 0.0))
        score = score - st * _member_ids(prev_state_ids[..., lo:hi, :], cols)
        if state_rules:
            score = score + _hier_penalty(anchors[..., lo:hi, :], gids,
                                          gid_valid, state_rules,
                                          gids_cand=gids_cand)
        tk = _member_ids(taken[..., lo:hi, :], cols) \
            if taken is not None else \
            torch.zeros(lead + (hi - lo, n), dtype=torch.bool, device=dev)
        score = score + _INF * (tk | bad)
        pi = (pbase + torch.arange(lo, hi, dtype=torch.int32,
                                   device=dev))[:, None]
        out[..., lo:hi, :] = jitter_add(score, pi, cols[None, :], _JITTER)
    return out


def _solve_assign(
    prev: torch.Tensor,  # [P, S, R] int32
    pweights: torch.Tensor,  # [P] float32
    nweights: torch.Tensor,  # [N] float32
    valid: torch.Tensor,  # [N] bool
    stickiness: torch.Tensor,  # [P, S] float32
    gids: torch.Tensor,  # [L, N] int32
    gid_valid: torch.Tensor,  # [L, N] bool
    constraints: Constraints,
    rules: Rules,
    fused_score: str = "off",
    shortlist: Optional[torch.Tensor] = None,  # [P, K] GLOBAL candidate
    # node ids (-1 pads), ascending per row: the sparse engine
    carry_used: Optional[torch.Tensor] = None,  # [S, N] warm seed
    # (SolveCarry.used matching prev): replaces the seed scatters
    p_real=None,  # the count of REAL partitions when prev carries inert
    # pad rows (shape bucketing): a number or a 0-d tensor, the fill
    # term's denominator as the reference's traced scalar (fill_term)
    axis=None,  # partition-axis Axis (sharded solve) or None
    node_axis=None,  # node-axis Axis of a 2-D mesh or None
    node_shards: int = 1,  # size of the node axis (N must divide)
) -> tuple[torch.Tensor, torch.Tensor]:
    """One assignment sweep on one device; returns (assign[P, S, R],
    exhausted[P]).  ``exhausted`` is all-False on the dense engines; on
    the sparse engine it flags rows whose shortlist could not reach the
    globally attainable rule tier (or had no feasible candidate) for
    some slot, for the per-row dense fallback.  ``carry_used`` must equal
    the per-state scatter of ``prev``; the seed then reads it instead of
    re-scattering, bitwise the same.

    Sharded (``axis`` / ``node_axis``, one problem): the rows are this
    partition shard's and node ids stay global; the fill, capacity and
    counts are psum'd over the partition axis, and with a node axis every
    [P, N] intermediate holds this shard's N/node_shards columns while
    the [N] vectors stay replicated (the reference's _solve_assign).

    The dense engines also take a batch of same-shaped problems: every
    array with a leading [B] axis and ``p_real`` a [B] tensor (the fleet
    tier); each element's result is its single solve's."""
    p, s, r_max = prev.shape[-3:]
    lead = prev.shape[:-3]
    n = nweights.shape[-1]
    dev = prev.device
    if fused_score not in ("off", "on"):
        raise ValueError(f"unresolved fused-score mode: {fused_score!r}")
    if shortlist is not None and not sparse_rules_supported(rules):
        raise ValueError(
            "sparse solve requires nesting hierarchy rules "
            "(exclude_level < include_level for every rule); use the "
            "dense engines for exotic rule shapes")
    if shortlist is not None and lead:
        raise ValueError("the sparse engine solves one problem at a time")
    if shortlist is not None and node_axis is not None:
        raise ValueError(
            "sparse solve does not support node-axis sharding: the [P, K] "
            "shortlist already bounds the column working set; shard the "
            "partition axis instead")
    if nweights.shape[-1] % node_shards:
        raise ValueError(
            f"N={nweights.shape[-1]} not divisible by node_shards="
            f"{node_shards}; pad nodes")
    if constraints and max(constraints) > r_max:
        raise ValueError(
            f"prev slot depth R={r_max} < max constraints {max(constraints)}")

    n_l = n // node_shards
    valid_l = _node_slice(valid, node_axis, n_l)
    gids_l = _node_slice(gids, node_axis, n_l)
    if p_real is not None:
        total_p = torch.as_tensor(p_real, dtype=torch.float32,
                                  device=dev).reshape(lead + (1,))
    elif axis is not None:
        # The psum of the shard row counts, as the reference's traced
        # psum: the fill term then divides once (fill_term).
        total_p = axis.psum(torch.tensor(float(p), dtype=torch.float32,
                                         device=dev))
    else:
        total_p = p
    total_w = _psum(pweights.sum(dim=-1, keepdim=True), axis)
    w_div = torch.where(nweights > 0, nweights, 1.0)
    neg_boost = torch.where(nweights < 0, -nweights, 0.0)
    cap_w = torch.where(valid & (nweights >= 0), nweights.clamp(min=1.0), 0.0)
    cap_share = cap_w / cap_w.sum(dim=-1, keepdim=True).clamp(min=1.0)

    # Seed the total-fill factor from prev (plan.go:94), or off the carry.
    if carry_used is not None:
        total = carry_used.sum(dim=-2)
    else:
        total = _psum(_used_by_state(prev, pweights, n, s).sum(dim=-2), axis)

    assign = torch.full(lead + (p, s, r_max), -1, dtype=torch.int32,
                        device=dev)
    exhausted = torch.zeros(lead + (p,), dtype=torch.bool, device=dev)
    taken_ids: list[torch.Tensor] = []
    top_anchor = prev[..., 0, 0]
    arange_p = torch.arange(p, device=dev).expand(lead + (p,))
    no_id = torch.full(lead + (p,), -1, dtype=torch.int32, device=dev)

    for si in range(s):
        k = constraints[si]
        if k <= 0:
            continue
        total = total - (carry_used[..., si, :] if carry_used is not None
                         else _psum(_scatter_counts(prev[..., si, :],
                                                    pweights, n), axis))
        prev_state_ids = prev[..., si, :]
        anchor = torch.where(assign[..., 0, 0] >= 0, assign[..., 0, 0],
                             top_anchor) if si > 0 else top_anchor

        # Warm start, decided per STATE across all k ordinals.
        kk = min(k, r_max)
        prev_k = prev[..., si, :kk]
        safe_k = prev_k.clamp(0, n - 1)
        taken_prev = torch.stack(
            [_in_id_list(prev_k[..., j], taken_ids) for j in range(kk)],
            dim=-1)
        pin_ok_k = (prev_k >= 0) & _take(valid, safe_k) & ~taken_prev & \
            (_take(neg_boost, safe_k) <= stickiness[..., si][..., None])
        for j in range(1, kk):
            dup = torch.zeros(lead + (p,), dtype=torch.bool, device=dev)
            for i in range(j):
                dup |= (prev_k[..., j] == prev_k[..., i]) & \
                    (prev_k[..., j] >= 0)
            pin_ok_k[..., j] = pin_ok_k[..., j] & ~dup
        anchors = None
        if rules[si]:
            anchors = torch.full(lead + (p, 1 + k), -1, dtype=torch.int32,
                                 device=dev)
            anchors[..., 0] = anchor
            counts_ok = all(exc < inc for (inc, exc) in rules[si])
            for j in range(kk):
                if counts_ok:
                    floor_j = _hier_floor_counts(
                        anchors[..., :1 + j], gids, gid_valid, valid,
                        rules[si])
                    hier_at_prev = _hier_tier_at(
                        anchors[..., :1 + j], safe_k[..., j], gids,
                        gid_valid, rules[si])
                else:
                    hier_j = _hier_penalty(anchors[..., :1 + j], gids,
                                           gid_valid, rules[si],
                                           gids_cand=gids_l)
                    floor_j = _row_min_global(
                        torch.where(valid_l.unsqueeze(-2), hier_j, _INF),
                        node_axis)
                    hier_at_prev = _gather_cols(hier_j, arange_p,
                                                safe_k[..., j], node_axis)
                ok_j = pin_ok_k[..., j] & (
                    hier_at_prev < floor_j + _RULE_TIER * 0.5)
                pin_ok_k[..., j] = ok_j
                anchors[..., 1 + j] = torch.where(ok_j, prev_k[..., j], -1)
        state_cap = torch.ceil(k * total_w * cap_share)
        pins = _pin_prev_holders(
            prev_k.reshape(lead + (-1,)),
            pin_ok_k.reshape(lead + (-1,)),
            torch.repeat_interleave(pweights, kk, dim=-1),
            state_cap,
            torch.repeat_interleave(stickiness[..., si], kk, dim=-1),
            load_div=w_div,
            taken_stack=(torch.repeat_interleave(
                torch.stack(taken_ids, dim=-1), kk, dim=-2)
                if taken_ids else None),
            axis=axis,
        ).reshape(lead + (p, kk))
        pin_base = len(taken_ids)
        for j in range(kk):
            taken_ids.append(torch.where(pins[..., j], prev_k[..., j], -1))
        if rules[si]:
            # Re-seed anchors from the capacity-trimmed pins.
            anchors = torch.full(lead + (p, 1 + k), -1, dtype=torch.int32,
                                 device=dev)
            anchors[..., 0] = anchor
            for j in range(kk):
                anchors[..., 1 + j] = torch.where(pins[..., j],
                                                  prev_k[..., j], -1)

        for ri in range(k):
            if ri < kk:
                init_assign = torch.where(pins[..., ri], prev[..., si, ri],
                                          -1)
            else:
                init_assign = no_id
            pin_used = _scatter_add(
                n, init_assign, torch.where(init_assign >= 0, pweights, 0.0),
                len(lead))

            # Every copy pinned on every shard (the confirming sweep's
            # common case): no score, no auction.  The flag is psum'd, so
            # all shards agree; the auction's collectives are node-axis
            # only, over rows every node shard holds alike.
            if not bool(_flag_any(~(init_assign >= 0).all(), axis)):
                slot_assign, used = init_assign, pin_used
            else:
                slot_assign, used, exh_slot = _run_auction(
                    fused_score, p, n, total, w_div, neg_boost, valid,
                    stickiness[..., si],
                    prev[..., si, ri] if ri < r_max else no_id,
                    prev_state_ids, anchors, gids, gid_valid, rules[si],
                    tuple(taken_ids), pweights, total_w, cap_share,
                    init_assign, pin_used, shortlist, total_p,
                    axis=axis, node_axis=node_axis, n_l=n_l)
                exhausted = exhausted | exh_slot
            used = _psum(used, axis)  # global per-node accepted weight

            assign[..., si, ri] = slot_assign
            total = total + used
            if ri < kk:
                taken_ids[pin_base + ri] = slot_assign  # supersedes the pin
            else:
                taken_ids.append(slot_assign)
            if rules[si]:
                anchors[..., 1 + ri] = slot_assign
    return assign, exhausted


def _run_auction(fused_score, p, n, total, w_div, neg_boost, valid,
                 stick_si, prev_slot, prev_state_ids, anchors, gids,
                 gid_valid, state_rules, taken_ids, pweights, total_w,
                 cap_share, init_assign, pin_used, shortlist, total_p,
                 axis=None, node_axis=None, n_l=None):
    """Score + auction + force for one slot, through any engine; returns
    (slot_assign, used, exhausted[P] for this slot).  ``shortlist`` is
    the sparse engine's [P, K] table (None on the dense engines);
    ``total_p`` the fill term's partition count (see fill_term).  Under
    sharding the rows are the partition shard's (``pbase`` their global
    offset) and the dense engines score the node shard's ``n_l`` columns
    from ``noff`` on, combining their min2 stats over ``node_axis``."""
    dev = total.device
    lead = total.shape[:-1]
    n_l = n if n_l is None else n_l
    pbase = axis.index * p if axis is not None else 0
    noff = _node_off(node_axis, n_l)
    anchors_k = anchors if state_rules else \
        torch.full(lead + (p, 1), -1, dtype=torch.int32, device=dev)
    if shortlist is not None:
        # Sparse engine: the matrix formula at the [P, K] shortlist
        # columns only; phase B's probes outside a row's shortlist score
        # +_INF, so stragglers never leave their candidate set.
        cand = shortlist.contiguous()
        score_kw = dict(
            total=total, total_p=total_p, w_div=w_div, neg_boost=neg_boost,
            valid=valid, gids=gids, gid_valid=gid_valid, stick_si=stick_si,
            prev_slot=prev_slot, prev_state=prev_state_ids,
            taken_ids=taken_ids, anchors=anchors_k, rules=state_rules,
            jitter_scale=_JITTER)
        score_pk = _sparse_score_cols(cand, torch.arange(p, device=dev),
                                      pbase, **score_kw)

        def min2_fn(price_vec):
            b, _kidx, s2, raw, choice = sparse_priced_min2_cand(
                score_pk, cand, price_vec)
            return b, choice, s2, raw

        def score_at_fn(rows, cols_global):
            vals = _sparse_score_cols(cols_global[:, None], rows, pbase,
                                      **score_kw)[:, 0]
            in_sl = (cand[rows] == cols_global[:, None]).any(dim=1)
            return torch.where(in_sl, vals, _INF)
    elif fused_score == "on":
        si_pack = pack_score_inputs(
            total_l=_node_slice(total, node_axis, n_l), total_p=total_p,
            w_div_l=_node_slice(w_div, node_axis, n_l),
            neg_boost_l=_node_slice(neg_boost, node_axis, n_l),
            valid_l=_node_slice(valid, node_axis, n_l),
            stickiness_si=stick_si, prev_slot=prev_slot,
            prev_state=prev_state_ids, taken_ids=list(taken_ids),
            anchors=anchors_k, gids_l=_node_slice(gids, node_axis, n_l),
            gid_valid=gid_valid, gids=gids, rules=state_rules)

        def min2_fn(price_vec):
            b, cl, s2, raw = fused_score_min2(
                _node_slice(price_vec, node_axis, n_l), si_pack, pbase,
                noff, nrules=len(state_rules), jitter_scale=_JITTER)
            if node_axis is None:
                return b, cl, s2, raw
            return _combine_min2(b, cl + noff, s2, raw, node_axis)

        base_full = fill_term(total, total_p, w_div)

        def score_at_fn(rows, cols_global):
            return score_at_columns(
                rows, cols_global, base_full=base_full,
                neg_boost_full=neg_boost, valid_full=valid, gids=gids,
                gid_valid=gid_valid, anchors=anchors_k, rules=state_rules,
                prev_slot=prev_slot, prev_state=prev_state_ids,
                taken_ids=taken_ids, stick=stick_si, jitter_scale=_JITTER,
                pbase=pbase)
    else:
        score = _matrix_score(
            _node_slice(total, node_axis, n_l), total_p,
            _node_slice(w_div, node_axis, n_l),
            _node_slice(neg_boost, node_axis, n_l),
            _node_slice(valid, node_axis, n_l), stick_si, prev_slot,
            prev_state_ids, anchors, gids, gid_valid, state_rules,
            taken_ids, pbase=pbase, noff=noff,
            gids_cand=_node_slice(gids, node_axis, n_l))

        def min2_fn(price_vec):
            b, c, s2 = priced_min2_argmin(
                score, _node_slice(price_vec, node_axis, n_l))
            raw = score.gather(-1, c.long()[..., None])[..., 0]
            if node_axis is None:
                return b, c, s2, raw
            return _combine_min2(b, c + noff, s2, raw, node_axis)

        def score_at_fn(rows, cols_global):
            return _gather_cols(score, rows, cols_global, node_axis)

    if state_rules:
        feasible_hint = None
    else:
        # Rule-less hard feasibility without a [P, N] row-min: an allowed
        # node exists iff the taken VALID nodes are fewer than all valid.
        n_valid_total = valid.to(torch.int32).sum(dim=-1, keepdim=True)
        tkn = torch.zeros(lead + (p,), dtype=torch.int32, device=dev)
        for tid in taken_ids:
            tkn += ((tid >= 0) & _take(valid, tid.clamp(0, n - 1))) \
                .to(torch.int32)
        feasible_hint = tkn < n_valid_total
    allow = None
    exh_slot = torch.zeros(lead + (p,), dtype=torch.bool, device=dev)
    if shortlist is not None:
        # Shortlist adequacy against GLOBAL state: a row takes this slot
        # only when its shortlist best reaches the globally attainable
        # rule tier (group-counting floor, taken-aware) or, rule-less,
        # offers a feasible candidate while one exists anywhere.  The
        # others sit the slot out and are flagged for the fallback.
        raw_best_sl = score_pk.amin(dim=1)
        if state_rules:
            floor_sl = _hier_floor_counts(
                anchors, gids, gid_valid, valid, state_rules,
                taken_stack=(torch.stack(list(taken_ids), dim=1)
                             if taken_ids else None))
            allow = raw_best_sl < floor_sl + _RULE_TIER * 0.5
        else:
            sl_feas = raw_best_sl < _INF / 2
            allow = sl_feas | ~feasible_hint
            # Top-up weighs shortlist-feasible rows, not the globally
            # feasible ones the gate excluded.
            feasible_hint = sl_feas
        exh_slot = (init_assign < 0) & ~allow
    cap = _shard_capacity(torch.ceil(total_w * cap_share), axis)
    slot_assign, used = _assign_slot(
        min2_fn, score_at_fn, p, pweights, cap, 1.0 / w_div,
        init_assign=init_assign, init_used=pin_used, topup_share=cap_share,
        has_rules=bool(state_rules), feasible_hint=feasible_hint,
        allow=allow, axis=axis)
    return slot_assign, used, exh_slot


def solve_dense(prev, pweights, nweights, valid, stickiness, gids,
                gid_valid, constraints: Constraints, rules: Rules,
                fused_score: str = "off",
                carry_used: Optional[torch.Tensor] = None,
                p_real=None, axis=None, node_axis=None,
                node_shards: int = 1) -> torch.Tensor:
    """Solve the whole placement problem once; returns assign[P, S, R].
    ``carry_used`` seeds the sweep's fill totals, ``p_real`` is the real
    partition count under padding and ``axis`` / ``node_axis`` /
    ``node_shards`` shard it (see _solve_assign)."""
    return _solve_assign(prev, pweights, nweights, valid, stickiness, gids,
                         gid_valid, constraints, rules, fused_score,
                         carry_used=carry_used, p_real=p_real, axis=axis,
                         node_axis=node_axis, node_shards=node_shards)[0]


def _solve_dense_converged_impl(prev, pweights, nweights, valid, stickiness,
                                gids, gid_valid, constraints, rules,
                                max_iterations: int = 10,
                                fused_score: str = "off",
                                carry_used: Optional[torch.Tensor] = None,
                                p_real=None, trace_sweeps: bool = False,
                                axis=None, node_axis=None,
                                node_shards: int = 1):
    """The fixpoint loop; returns (assign, sweeps executed).  One host
    read of the changed flag per sweep; sharded (``axis`` / ``node_axis``
    / ``node_shards``, see _solve_assign) the flag is psum'd over the
    partition axis, so every shard runs the same sweeps.  ``carry_used`` seeds the FIRST
    sweep only: later sweeps re-derive their seed from their own input;
    ``p_real`` is the real partition count under padding (see
    _solve_assign).

    ``trace_sweeps`` (one problem only) also counts each sweep's changed
    rows on the device and returns (assign, sweeps, fracs) with
    ``fracs`` a float32 numpy [max_iterations]: sweep i's changed-row
    count over max(p_real, 1) (max(P, 1) without ``p_real``), zeros past
    the last sweep, read back once after the loop (see
    _traced_fixpoint).  Off, the loop is the untraced one.

    Over a batch ([B, P, S, R] and the other arrays with a leading [B],
    ``p_real`` [B]) each element iterates until its own map stops
    changing, as ``vmap`` runs a ``while_loop`` with a batched
    predicate: a converged element is frozen, and later sweeps solve
    only the elements still changing (a subset, which changes no
    element's result).  Returns (assign[B, P, S, R], sweeps[B] int32,
    the reference's dtype)."""
    def solve(x, cu=None):
        return solve_dense(x, pweights, nweights, valid, stickiness, gids,
                           gid_valid, constraints, rules, fused_score,
                           carry_used=cu, p_real=p_real, axis=axis,
                           node_axis=node_axis, node_shards=node_shards)

    if prev.dim() == 3:
        if trace_sweeps:
            return _traced_fixpoint(solve, prev, carry_used, max_iterations,
                                    p_real)
        out, prev_i, it = solve(prev, carry_used), prev, 1
        while it < max_iterations and \
                bool(_flag_any((out != prev_i).any(), axis)):
            out, prev_i, it = solve(out), out, it + 1
        return out, it

    out = solve(prev, carry_used)
    last_in = prev
    sweeps = torch.ones(prev.shape[0], dtype=torch.int32)
    live = torch.arange(prev.shape[0], device=prev.device)
    pr = None if p_real is None else \
        torch.as_tensor(p_real, dtype=torch.float32, device=prev.device)
    for _ in range(1, max_iterations):
        changed = (out[live] != last_in[live]).flatten(1).any(dim=1)
        live = live[changed]
        if live.numel() == 0:
            break
        x = out[live]
        y = solve_dense(x, pweights[live], nweights[live], valid[live],
                        stickiness[live], gids[live], gid_valid[live],
                        constraints, rules, fused_score,
                        p_real=None if pr is None else pr[live])
        last_in = last_in.clone()
        last_in[live] = x
        out = out.clone()
        out[live] = y
        sweeps[live.cpu()] += 1
    return out, sweeps


def _traced_fixpoint(solve, prev, carry_used, max_iterations: int, p_real):
    """The single-problem fixpoint with the sweep trace: the untraced
    loop, plus each sweep's changed-row count kept on the device (sweep
    0 compares its output with ``prev``).  The counts are summed exactly
    (int64) and cast to float32 (exact below 2**24 rows), then scaled as
    the reference's compiled program scales its float32 sum: divided
    once by a traced ``p_real``, but multiplied by the float32
    reciprocal of the static max(P, 1) (XLA rewrites a division by a
    constant so).  They come back in one copy after the loop."""
    def changed_rows(a, b):
        return (a != b).any(dim=2).any(dim=1).sum()

    out, prev_i, it = solve(prev, carry_used), prev, 1
    counts = [changed_rows(out, prev_i)]
    while it < max_iterations and bool((out != prev_i).any()):
        out, prev_i, it = solve(out), out, it + 1
        counts.append(changed_rows(out, prev_i))
    total = torch.stack(counts).to(torch.float32)
    if p_real is None:
        fracs = total * (np.float32(1.0) / np.float32(max(prev.shape[0], 1)))
    else:
        fracs = total / torch.clamp(torch.as_tensor(
            p_real, dtype=torch.float32, device=prev.device), min=1.0)
    full = np.zeros(max_iterations, np.float32)
    full[:it] = fracs.cpu().numpy()
    return out, it, full


def _record_sweeps(sweeps: int) -> None:
    """Publish a converged solve's pass count to the port's recorder."""
    n = int(sweeps)
    rec = get_recorder()
    rec.count("plan.solve.calls")
    rec.count("plan.solve.sweeps", n)
    rec.observe("plan.solve.sweeps", n)
    rec.set_attr("sweeps", n)


def _check_tier_band_scale(prev, pweights, nweights, valid, stickiness,
                           constraints, rules) -> None:
    """Assert the tier-equality band's scale assumption (the reference's
    _RULE_TIER note): raise ValueError when the within-tier score mass a
    node can carry eats into the _RULE_TIER/2 band.  Host numpy, memoized
    per (prev identity, weight fingerprint).  Takes host arrays or
    tensors; the pipeline checks its host arrays before the upload, so
    nothing comes back from the device for it."""
    if not any(rl for rl in rules):
        return
    prev_in = prev
    prev = _np(prev)
    pw = _np(pweights).astype(np.float64)
    nw = _np(nweights).astype(np.float64)
    valid = _np(valid).astype(bool)
    stick = _np(stickiness).astype(np.float64)
    n = nw.shape[0]
    if prev.size == 0 or n == 0:
        return
    key = (id(prev_in), prev.shape, n, tuple(constraints),
           tuple(tuple(r) for r in rules))
    fingerprint = (float(pw.sum()), float(stick.max()) if stick.size else 0.0,
                   float(nw.min()), float(nw.max()), int(valid.sum()))
    if _tier_scale_memo.get(key) == fingerprint:
        return
    total_w = float(pw.sum())
    cap_w = np.where(valid & (nw >= 0), np.maximum(nw, 1.0), 0.0)
    w_div = np.where(nw > 0, nw, 1.0)
    k_total = float(sum(max(int(c), 0) for c in constraints))
    rail_term = k_total * total_w / max(float(cap_w.sum()), 1.0)
    ids = prev.reshape(prev.shape[0], -1)
    w_rep = np.broadcast_to(pw[:, None], ids.shape)
    m = ids >= 0
    fill = np.bincount(ids[m].ravel(), weights=w_rep[m].ravel(),
                       minlength=n)[:n]
    seed_term = float((fill / w_div).max()) if n else 0.0
    bound = max(rail_term, seed_term)
    bound += float(stick.max()) if stick.size else 0.0
    bound += float(np.maximum(-nw, 0.0).max())
    if bound >= _TIER_BAND_HEADROOM * _RULE_TIER:
        raise ValueError(
            f"hierarchy tier band overflow: within-tier score mass "
            f"~{bound:.0f} >= {_TIER_BAND_HEADROOM:.2f} * _RULE_TIER "
            f"({_RULE_TIER:.0f}) — at this partitions-per-node scale "
            f"(P={prev.shape[0]}, usable N={int(cap_w.nonzero()[0].size)}, "
            f"slots={k_total:.0f}) the band test that separates hierarchy "
            f"tiers would misclassify rule conformance.  Add nodes or "
            f"split the problem")
    if len(_tier_scale_memo) >= 256:
        _tier_scale_memo.clear()
    _tier_scale_memo[key] = fingerprint


def solve_dense_converged(prev, pweights, nweights, valid, stickiness,
                          gids, gid_valid, constraints: Constraints,
                          rules: Rules, max_iterations: int = 10,
                          fused_score: str = "off", record: bool = True,
                          carry_used: Optional[torch.Tensor] = None,
                          return_carry: bool = False,
                          stats: Optional[dict] = None, p_real=None):
    """solve_dense iterated to a fixpoint (reference plan.go:23-58); the
    first pass does the work, later passes confirm.  The executed pass
    count goes to the recorder's ``plan.solve.sweeps`` (``record=False``
    skips it) and, when ``stats`` is given, under its "sweeps".
    ``carry_used`` (SolveCarry.used matching ``prev``) seeds the first
    sweep; ``return_carry`` returns (assign, SolveCarry) instead of
    assign; ``p_real`` is the real partition count when the arrays carry
    inert pad rows (shape bucketing; see _solve_assign).

    Device observatory (obs/device.py), all opt-in: the dispatch is the
    entry ``solve_dense.cold`` (``solve_dense.carry`` with a carry, or
    the enclosing dispatch site's label, as the bucketed plan path's)
    and its first run per shape is measured; with the sweep trace armed
    and ``record``, the sweeps' changed-row fractions go out as
    ``device.sweep_accept_frac`` samples across the solve's interval."""
    _check_tier_band_scale(prev, pweights, nweights, valid, stickiness,
                           constraints, rules)
    ent = _device.ambient_entry() or (
        "solve_dense.carry" if carry_used is not None
        else "solve_dense.cold")
    want_trace = record and prev.dim() == 3 and \
        _device.sweep_trace_enabled()
    rec = get_recorder()
    t0 = rec.now()
    operands = (prev, pweights, nweights, valid, stickiness, gids,
                gid_valid, carry_used, p_real)
    with _device.entry(ent), _device.measure(
            ent, f"{prev.shape[-3]}x{nweights.shape[-1]}", prev.device,
            operands):
        res = _solve_dense_converged_impl(
            prev, pweights, nweights, valid, stickiness, gids, gid_valid,
            constraints, rules, max_iterations, fused_score, carry_used,
            p_real, trace_sweeps=want_trace)
    out, sweeps = res[0], res[1]
    if record:
        _record_sweeps(sweeps)
    if want_trace:
        _device.record_sweep_trace(rec, t0, rec.now(), sweeps, res[2])
    if stats is not None:
        stats["sweeps"] = sweeps
    if return_carry:
        return out, carry_from_assignment(out, pweights, nweights)
    return out


_ENGINE_NAMES = {"off": "matrix", "on": "fused"}


def _annotate(timer, key: str, value: str) -> None:
    """``timer.annotate`` forwards to the recorder's current span, so
    write to the recorder directly only when there is no timer."""
    if timer is not None:
        timer.annotate(key, value)
    else:
        get_recorder().set_attr(key, value)


def solve_converged_resilient(
    prev, pweights, nweights, valid, stickiness, gids, gid_valid,
    constraints, rules, *, max_iterations: int, mode: str,
    allow_fallback: bool, context: str, carry_used=None,
    return_carry: bool = False, stats: Optional[dict] = None, timer=None,
    p_real=None,
):
    """solve_dense_converged with engine-failure degradation: with
    ``allow_fallback`` (the mode came from "auto") a failed engine
    retries once on the other kernel, with a UserWarning and a
    ``plan.engine_fallback`` count.  Returns (assignment as numpy,
    engine mode that ran), plus the converged SolveCarry with
    ``return_carry``; ``carry_used`` seeds the first sweep.  The engine
    that ran (and any fallback) is annotated on ``timer`` (a PhaseTimer,
    which forwards to the recorder) or, without one, on the recorder's
    current span.  ``p_real``: see solve_dense_converged."""
    device = prev.device
    rec = get_recorder()

    def run(m: str):
        check_dense_memory(prev.shape[0], prev.shape[1], nweights.shape[-1],
                           m, device)
        with rec.span("plan.solve.attempt", engine=m):
            out = solve_dense_converged(
                prev, pweights, nweights, valid, stickiness, gids,
                gid_valid, constraints, rules, max_iterations=max_iterations,
                fused_score=m, carry_used=carry_used, stats=stats,
                p_real=p_real)
            return out, out.cpu().numpy()

    try:
        out, out_np = run(mode)
    except (ValueError, TypeError):
        raise
    except Exception as e:
        alt = {"off": "on", "on": "off"}.get(mode)
        if not allow_fallback or alt is None or device.type != "cuda":
            raise
        first = (str(e).splitlines() or [""])[0][:200]
        _warnings.warn(
            f"blance_tpu_torch {context}: score engine {mode!r} failed "
            f"({type(e).__name__}: {first}); retrying with {alt!r}",
            UserWarning, stacklevel=3)
        rec.count("plan.engine_fallback")
        out, out_np = run(alt)
        mode = alt
        _annotate(timer, "engine_fallback", f"-> {alt}")
    _annotate(timer, "engine", _ENGINE_NAMES[mode])
    if return_carry:
        return out_np, mode, carry_from_assignment(out, pweights, nweights)
    return out_np, mode


# --- warm repair -------------------------------------------------------------


def _warm_repair(prev, pweights, nweights, valid, stickiness, gids,
                 gid_valid, dirty, carry_used, constraints: Constraints,
                 rules: Rules, fused_score: str = "off", p_real=None,
                 axis=None, node_axis=None, node_shards: int = 1):
    """ONE carry-seeded repair sweep and its acceptance flag; returns
    (assign, new_used[S, N], ok) with ``ok`` a 0-d bool tensor on the
    device (over a batch: [B, S, N] and ``ok`` [B], one flag each).

    The sweep is ``solve_dense`` itself with the totals seeded from the
    carry, so it equals a cold solve's first sweep exactly; what a warm
    replan skips is the fixpoint's confirming sweep, which is sound only
    when the repair stayed inside the delta (``_repair_ok``).  Sharded,
    ``new_used`` is the global fill and ``ok`` the globally agreed flag
    (the carry's tables are replicated; the rows are the shard's)."""
    out = solve_dense(prev, pweights, nweights, valid, stickiness, gids,
                      gid_valid, constraints, rules, fused_score,
                      carry_used=carry_used, p_real=p_real, axis=axis,
                      node_axis=node_axis, node_shards=node_shards)
    new_used = _used_by_state(out, pweights, nweights.shape[-1],
                              prev.shape[-2], axis)
    ok = _repair_ok(prev, out, new_used, carry_used, dirty, pweights,
                    nweights, valid, constraints, axis)
    return out, new_used, ok


def _repair_ok(prev, out, new_used, carry_used, dirty, pweights, nweights,
               valid, constraints, axis=None) -> torch.Tensor:
    """The warm repair's acceptance gates, on the device:

    - ripple: a row outside the dirty mask changed (the delta leaked; a
      second sweep could move more);
    - fresh over-capacity: a node's new fill exceeds its state rail by
      more than one max-weight partition (the auction's first-bidder
      overshoot, which replans unchanged) AND exceeds its previous fill.

    Every reduction runs per batch element ([B] flags for a batch).
    Sharded over ``axis``, the ripple flag and the weights are psum'd
    and the allowance is one max-weight partition per shard.
    """
    p = prev.shape[-3]
    lead = prev.shape[:-3]
    dev = prev.device
    rippled = _flag_any(((out != prev) & ~dirty[..., None, None])
                        .flatten(-3).any(dim=-1), axis)
    total_w = _psum(pweights.sum(dim=-1, keepdim=True), axis)
    cap_w = torch.where(valid & (nweights >= 0), nweights.clamp(min=1.0),
                        0.0)
    cap_share = cap_w / cap_w.sum(dim=-1, keepdim=True).clamp(min=1.0)
    allowance = pweights.amax(dim=-1, keepdim=True) if p else \
        torch.zeros(lead + (1,), device=dev)
    if axis is not None:
        allowance = axis.size * axis.pmax(allowance)
    overcap = torch.zeros(lead, dtype=torch.bool, device=dev)
    for si, k in enumerate(constraints):
        if k <= 0:
            continue
        rail = torch.ceil(k * total_w * cap_share)
        overcap = overcap | ((new_used[..., si, :] > rail + allowance)
                             & (new_used[..., si, :]
                                > carry_used[..., si, :])).any(dim=-1)
    return ~rippled & ~overcap


def _dirty_mask(dirty, device: torch.device):
    """The host dirty mask [P] as numpy (for the recorded fraction) and
    as a bool tensor on ``device``."""
    dirty_np = np.array(dirty, bool)
    return dirty_np, torch.from_numpy(dirty_np).to(device)


def _warm_declined(record: bool) -> tuple[None, None]:
    if record:
        rec = get_recorder()
        rec.count("plan.solve.warm_fallback")
        rec.count("plan.solve.sweeps", 1)  # the executed repair pass
    return None, None


def solve_dense_warm(
    prev, pweights, nweights, valid, stickiness, gids, gid_valid,
    constraints, rules, *, dirty, carry: SolveCarry,
    fused_score: str = "off", record: bool = True,
    donate: Optional[bool] = None, p_real=None,
) -> tuple[Optional[NPArray], Optional[SolveCarry]]:
    """Warm delta replan: one repair sweep from the carry, or decline.

    The arrays are tensors on one device, ``dirty`` is a host bool mask
    [P] and the carry's tensors move to that device.  Returns (assign
    as numpy, next SolveCarry) when the repair is accepted as converged,
    or (None, None) when it leaked outside ``dirty`` and the caller must
    run the cold path (``solve_converged_resilient``).  The carry is
    single-use by contract; ``donate`` is accepted for the reference's
    signature and changes nothing (no buffer is reused in place).
    ``p_real`` is the real partition count when the arrays carry inert
    pad rows (shape bucketing; see _solve_assign).

    Records ``plan.solve.dirty_fraction``, ``plan.solve.warm_fallback``
    on a decline, the executed sweep in ``plan.solve.sweeps`` and a
    ``warm`` attribute on acceptance; ``plan.solve.carry_hit`` is the
    caller's to count once its own gates pass."""
    del donate
    if fused_score not in ("off", "on"):
        raise ValueError(f"unresolved fused-score mode: {fused_score!r}")
    rec = get_recorder()
    _check_tier_band_scale(prev, pweights, nweights, valid, stickiness,
                           constraints, rules)
    check_dense_memory(prev.shape[0], prev.shape[1], nweights.shape[-1],
                       fused_score, prev.device)
    dirty_np, dirty_t = _dirty_mask(dirty, prev.device)
    if record:
        rec.observe("plan.solve.dirty_fraction",
                    float(dirty_np.mean()) if dirty_np.size else 0.0)
    used = carry.used.to(prev.device)
    with rec.span("plan.solve.attempt", warm=True,
                  engine=_ENGINE_NAMES[fused_score]), \
            _device.entry("solve_dense.warm"), _device.measure(
                "solve_dense.warm", f"{prev.shape[0]}x{nweights.shape[-1]}",
                prev.device, (prev, pweights, nweights, valid, stickiness,
                              gids, gid_valid, dirty_t, used, p_real)):
        out, new_used, ok = _warm_repair(
            prev, pweights, nweights, valid, stickiness, gids, gid_valid,
            dirty_t, used, constraints, rules, fused_score, p_real)
        accepted = bool(ok)
    if not accepted:
        return _warm_declined(record)
    if record:
        _record_sweeps(1)
        rec.set_attr("warm", True)
    return out.cpu().numpy(), SolveCarry(prices=new_used.sum(0), assign=out,
                                         used=new_used)


# --- sparse shortlist solve --------------------------------------------------
#
# The dense engines score [P, N] per slot; 1M partitions x 10k nodes is a
# 200 GB matrix-engine working set.  The sparse engine scores only a
# [P, K] candidate shortlist (core/shortlist.py) while fill, price and
# capacity stay full [N] width, so acceptance and the audit contracts
# run against global state.  Rows whose shortlist cannot serve a slot
# are flagged and re-placed by a per-row dense fallback on the host.  A
# saturating K = N shortlist is bitwise the dense matrix engine.


def sparse_rules_supported(rules: Rules) -> bool:
    """True when the sparse engine can solve these rules (every exclude
    level strictly finer than its include level)."""
    return shortlist_rules_nest(rules)


def _solve_sparse_converged_impl(prev, pweights, nweights, valid,
                                 stickiness, gids, gid_valid, shortlist,
                                 constraints, rules,
                                 max_iterations: int = 10,
                                 carry_used: Optional[torch.Tensor] = None,
                                 p_real=None, axis=None):
    """The sparse fixpoint; returns (assign, sweeps, exhausted[P]).  The
    exhaustion flags are the LAST executed sweep's: rows still unservable
    at the fixpoint, which the host fallback re-places.  ``carry_used``
    seeds the first sweep only, as on the dense loop; ``axis`` shards the
    partition axis (psum'd changed flag)."""
    def solve(x, cu=None):
        return _solve_assign(x, pweights, nweights, valid, stickiness, gids,
                             gid_valid, constraints, rules, "off",
                             shortlist=shortlist, carry_used=cu,
                             p_real=p_real, axis=axis)

    (out, exh), prev_i, it = solve(prev, carry_used), prev, 1
    while it < max_iterations and \
            bool(_flag_any((out != prev_i).any(), axis)):
        (new, exh), prev_i, it = solve(out), out, it + 1
        out = new
    return out, it, exh


def _warm_repair_sparse(prev, pweights, nweights, valid, stickiness, gids,
                        gid_valid, shortlist, dirty, carry_used,
                        constraints: Constraints, rules: Rules, p_real=None,
                        axis=None):
    """ONE carry-seeded sparse repair sweep; returns (assign,
    new_used[S, N], ok, exhausted[P]) with ``_warm_repair``'s acceptance
    gates.  Exhausted rows come back -1 and, being changed rows, are
    acceptable only where ``dirty`` covers them; the caller routes them
    through the per-row dense fallback."""
    out, exh = _solve_assign(prev, pweights, nweights, valid, stickiness,
                             gids, gid_valid, constraints, rules, "off",
                             shortlist=shortlist, carry_used=carry_used,
                             p_real=p_real, axis=axis)
    new_used = _used_by_state(out, pweights, nweights.shape[0],
                              prev.shape[1], axis)
    ok = _repair_ok(prev, out, new_used, carry_used, dirty, pweights,
                    nweights, valid, constraints, axis)
    return out, new_used, ok, exh


# Cells of one [B, N] score block in the host fallback; a slot's rows are
# scored in chunks below this (bitwise the same: see _sparse_fallback_rows).
_FALLBACK_CELLS = 1 << 26


# Host numpy copy of blance_tpu/plan/tensor.py:2291 _sparse_fallback_rows,
# with a slot's rows scored in chunks.
def _sparse_fallback_rows(
    assign: NPArray,  # [P, S, R] the sparse result (NOT mutated)
    rows: NPArray,  # indices of exhausted rows
    prev: NPArray,
    pweights: NPArray,
    nweights: NPArray,
    valid: NPArray,
    stickiness: NPArray,
    gids: NPArray,
    gid_valid: NPArray,
    constraints: Constraints,
    rules: Rules,
) -> NPArray:
    """Per-row DENSE fallback for shortlist-exhausted partitions.

    Discards the flagged rows' sparse placements and re-places every slot
    in order against the full node axis (anchors, taken set and rule
    tiers as the audit judges them), priced by the live global fill so
    the fallback rows spread.  Within one slot every row reads ``total``
    and ``used_s`` from before the slot, and the slot's updates land
    after all its rows chose; so scoring a slot's rows in chunks of at
    most _FALLBACK_CELLS cells, then updating once, is bitwise the
    reference's one [B, N] block.  Returns a patched copy."""
    assign = np.array(np.asarray(assign), copy=True)
    rows = np.asarray(rows)
    P, S, R = assign.shape
    nw = np.asarray(nweights, np.float32)
    n = nw.shape[0]
    if rows.size == 0 or n == 0:
        return assign
    pw = np.asarray(pweights, np.float32)
    valid = np.asarray(valid, bool)
    gids = np.asarray(gids)
    gid_valid = np.asarray(gid_valid)
    w_div = np.where(nw > 0, nw, 1.0)
    neg_boost = np.maximum(-nw, 0.0)

    kept = assign.copy()
    kept[rows] = -1
    used_s = np.zeros((S, n), np.float32)
    for si in range(S):
        ids = kept[:, si, :]
        m = ids >= 0
        if m.any():
            w_rep = np.broadcast_to(pw[:, None], ids.shape)
            used_s[si] = np.bincount(
                ids[m].ravel(), weights=w_rep[m].ravel(),
                minlength=n)[:n].astype(np.float32)
    total = used_s.sum(axis=0)

    B = rows.size
    prev_b = np.asarray(prev)[rows]
    stick_b = np.asarray(stickiness, np.float32)[rows]
    pw_b = pw[rows]
    top_anchor = prev_b[:, 0, 0]
    new_rows = np.full((B, S, R), -1, np.int32)
    taken: list[NPArray] = []
    step = max(1, _FALLBACK_CELLS // n)

    def pick_rows(lo, hi, si, prev_slot, anchors, rules_si):
        """Choices of rows [lo, hi) for slot si (-1 where infeasible)."""
        ar = np.arange(hi - lo)
        score = (0.001 * total[None, :] / max(float(P), 1.0)) \
            / w_div[None, :]
        align = np.zeros((hi - lo, n), bool)
        ps = prev_slot[lo:hi]
        hold = ps >= 0
        align[ar[hold], ps[hold]] = True
        score = score - 0.01 * align
        st = stick_b[lo:hi, si][:, None]
        score = score + np.maximum(
            neg_boost[None, :],
            np.where(neg_boost[None, :] > 0, st, 0.0))
        sticky = np.zeros((hi - lo, n), bool)
        for r in range(prev_b.shape[2]):
            ps = prev_b[lo:hi, si, r]
            hold = ps >= 0
            sticky[ar[hold], ps[hold]] = True
        score = score - st * sticky
        if rules_si:
            pen = np.full((hi - lo, n), _RULE_MISS, np.float32)
            for idx, (inc, exc) in enumerate(rules_si):
                sat = np.ones((hi - lo, n), bool)
                for a in anchors:
                    a = a[lo:hi]
                    aa = np.clip(a, 0, n - 1)
                    inc_same = (gids[inc][aa][:, None]
                                == gids[inc][None, :]) \
                        & gid_valid[inc][aa][:, None]
                    exc_same = (gids[exc][aa][:, None]
                                == gids[exc][None, :]) \
                        & gid_valid[exc][aa][:, None]
                    sat &= np.where((a >= 0)[:, None],
                                    inc_same & ~exc_same, True)
                pen = np.where(sat, np.minimum(pen, idx * _RULE_TIER), pen)
            any_anchor = np.zeros(hi - lo, bool)
            for a in anchors:
                any_anchor |= a[lo:hi] >= 0
            score = score + np.where(any_anchor[:, None], pen, 0.0)
        tk = np.zeros((hi - lo, n), bool)
        for t in taken:
            t = t[lo:hi]
            held = t >= 0
            tk[ar[held], t[held]] = True
        score = score + _INF * (tk | ~valid[None, :])
        # Price by the state's live global fill so concurrent fallback
        # rows spread (the force step's pricing idiom).
        score = score + used_s[si][None, :] / w_div[None, :]
        choice = np.argmin(score, axis=1).astype(np.int32)
        feas = score[ar, choice] < _INF / 2
        return np.where(feas, choice, -1).astype(np.int32)

    for si in range(S):
        kcon = int(constraints[si])
        if kcon <= 0:
            continue
        rules_si = list(rules[si]) if si < len(rules) else []
        anchors: list[NPArray] = []
        if rules_si:
            base = top_anchor if si == 0 else np.where(
                new_rows[:, 0, 0] >= 0, new_rows[:, 0, 0], top_anchor)
            anchors = [base]
        for ri in range(min(kcon, R)):
            prev_slot = prev_b[:, si, ri] if ri < prev_b.shape[2] \
                else np.full(B, -1, np.int32)
            pick = np.concatenate([
                pick_rows(lo, min(B, lo + step), si, prev_slot, anchors,
                          rules_si) for lo in range(0, B, step)])
            feas = pick >= 0
            new_rows[:, si, ri] = pick
            placed = pick[feas]
            np.add.at(used_s[si], placed, pw_b[feas])
            np.add.at(total, placed, pw_b[feas])
            taken.append(pick)
            if rules_si:
                anchors.append(pick)
    assign[rows] = new_rows
    return assign


def _np(x) -> NPArray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _apply_sparse_fallback(assign: NPArray, exhausted: NPArray, prev,
                           pweights, nweights, valid, stickiness, gids,
                           gid_valid, constraints, rules,
                           record: bool = True) -> tuple[NPArray, int]:
    """Route flagged rows through the dense fallback; returns (patched
    assign, rows whose placement the fallback changed), counted as
    ``plan.sparse.shortlist_exhausted`` / ``dense_fallback_rows``."""
    rows = np.nonzero(np.asarray(exhausted))[0]
    if rows.size == 0:
        return np.asarray(assign), 0
    rec = get_recorder()
    if record:
        rec.count("plan.sparse.shortlist_exhausted", int(rows.size))
    patched = _sparse_fallback_rows(
        assign, rows, _np(prev), _np(pweights), _np(nweights), _np(valid),
        _np(stickiness), _np(gids), _np(gid_valid), constraints, rules)
    replaced = int(np.any(
        patched[rows] != np.asarray(assign)[rows], axis=(1, 2)).sum())
    if record and replaced:
        rec.count("plan.sparse.dense_fallback_rows", replaced)
    return patched, replaced


def _build_or_adopt_shortlist(prev, pweights, nweights, valid, gids,
                              gid_valid, constraints, rules, shortlist,
                              k, record: bool = True
                              ) -> tuple[torch.Tensor, float]:
    """Adopt a caller-built [P, K] table (moved to prev's device) or
    derive one with ``k`` columns (auto-sized when None); returns it
    with the build's wall time (device synchronised; 0 when adopted),
    observed as ``plan.sparse.shortlist_build_s``, and publishes the
    ``plan.sparse.k_effective`` gauge."""
    rec = get_recorder()
    t0 = time.perf_counter()
    if shortlist is None:
        n = nweights.shape[-1]
        kk = int(k) if k is not None \
            else auto_shortlist_k(n, constraints, rules)
        shortlist = build_shortlist_core(prev, pweights, nweights, valid,
                                         gids, gid_valid, constraints,
                                         rules, kk)
        _sync(prev.device)
        built_s = time.perf_counter() - t0
        if record:
            rec.observe("plan.sparse.shortlist_build_s", built_s)
    else:
        shortlist = torch.as_tensor(shortlist, dtype=torch.int32,
                                    device=prev.device)
        built_s = 0.0
    if record:
        rec.set_gauge("plan.sparse.k_effective", float(shortlist.shape[1]))
    return shortlist, built_s


def _sparse_statics(prev, pweights, nweights, valid, stickiness,
                    constraints, rules):
    """The sparse entries' shared checks; returns (constraints, rules)
    as tuples."""
    constraints = tuple(int(c) for c in constraints)
    rules = tuple(tuple(r) for r in rules)
    if not sparse_rules_supported(rules):
        raise ValueError(
            "sparse solve requires nesting hierarchy rules "
            "(exclude_level < include_level); use the dense engines")
    _check_tier_band_scale(prev, pweights, nweights, valid, stickiness,
                           constraints, rules)
    return constraints, rules


def solve_sparse(
    prev, pweights, nweights, valid, stickiness, gids, gid_valid,
    constraints, rules, *, shortlist=None, k: Optional[int] = None,
    max_iterations: int = 10, record: bool = True, carry_used=None,
    return_carry: bool = False, p_real=None, stats: Optional[dict] = None,
):
    """Sparse converged solve: shortlist -> [P, S, K] auction -> per-row
    dense fallback for exhausted rows.  Same positional contract as
    solve_dense_converged (tensors on one device); returns the
    assignment as numpy, and with ``return_carry`` also the SolveCarry
    built from it after the fallback patched it.  ``carry_used`` seeds
    the first sweep, as on the dense loop.

    ``shortlist`` adopts a caller-built [P, K] table; otherwise one is
    derived with ``k`` columns (auto-sized when None).  A saturating
    K >= N is bitwise the dense matrix engine.  The sparse min2 runs its
    CUDA kernel on a card and its plain version on the CPU: the tensors'
    device decides (the reference's ``sparse_impl`` has no counterpart).
    ``stats``, when given, receives sweeps, k, shortlist_s (build wall
    time, device synchronised), exhausted_rows (the last sweep's flags)
    and fallback_rows (rows the fallback changed).  ``p_real`` is the
    real partition count when the arrays carry inert pad rows (shape
    bucketing; see _solve_assign)."""
    constraints, rules = _sparse_statics(prev, pweights, nweights, valid,
                                         stickiness, constraints, rules)
    # The entry scope (obs/device.py) opens before the shortlist step, as
    # the reference's does; the measured dispatch is the fixpoint.
    ent = _device.ambient_entry() or (
        "sparse.carry" if carry_used is not None else "sparse.cold")
    with _device.entry(ent):
        shortlist, shortlist_s = _build_or_adopt_shortlist(
            prev, pweights, nweights, valid, gids, gid_valid, constraints,
            rules, shortlist, k, record)
        with get_recorder().span("plan.solve.attempt", engine="sparse"), \
                _device.measure(
                    ent, f"{prev.shape[0]}x{nweights.shape[-1]}",
                    prev.device, (prev, pweights, nweights, valid,
                                  stickiness, gids, gid_valid, shortlist,
                                  carry_used, p_real)):
            out, sweeps, exh = _solve_sparse_converged_impl(
                prev, pweights, nweights, valid, stickiness, gids,
                gid_valid, shortlist, constraints, rules,
                max(int(max_iterations), 1), carry_used, p_real)
            out_np = out.cpu().numpy()
            exh_np = exh.cpu().numpy()
    if record:
        _record_sweeps(sweeps)
    out_np, replaced = _apply_sparse_fallback(
        out_np, exh_np, prev, pweights, nweights, valid, stickiness, gids,
        gid_valid, constraints, rules, record)
    if stats is not None:
        stats.update(sweeps=sweeps, k=int(shortlist.shape[1]),
                     shortlist_s=shortlist_s,
                     exhausted_rows=int(exh_np.sum()),
                     fallback_rows=replaced)
    if return_carry:
        return out_np, carry_from_assignment(out_np, pweights, nweights)
    return out_np


def solve_sparse_warm(
    prev, pweights, nweights, valid, stickiness, gids, gid_valid,
    constraints, rules, *, dirty, carry: SolveCarry, shortlist=None,
    k: Optional[int] = None, record: bool = True,
    donate: Optional[bool] = None, p_real=None,
    stats: Optional[dict] = None,
) -> tuple[Optional[NPArray], Optional[SolveCarry]]:
    """Warm delta replan on the sparse engine: one carry-seeded repair
    sweep over the shortlist, or decline, with ``solve_dense_warm``'s
    contract ((None, None) on decline, the carry single-use, the same
    counters).  Exhausted rows of an ACCEPTED repair go through the
    per-row dense fallback, against the pre-repair ``prev``, and the
    returned carry is rebuilt from the patched assignment when the
    fallback replaced rows.  ``stats``, when given, receives k,
    shortlist_s, accepted, exhausted_rows and fallback_rows.  ``p_real``:
    see solve_sparse."""
    del donate
    constraints, rules = _sparse_statics(prev, pweights, nweights, valid,
                                         stickiness, constraints, rules)
    rec = get_recorder()
    dirty_np, dirty_t = _dirty_mask(dirty, prev.device)
    if record:
        rec.observe("plan.solve.dirty_fraction",
                    float(dirty_np.mean()) if dirty_np.size else 0.0)
    with _device.entry("sparse.warm"):
        shortlist, shortlist_s = _build_or_adopt_shortlist(
            prev, pweights, nweights, valid, gids, gid_valid, constraints,
            rules, shortlist, k, record)
        used = carry.used.to(prev.device)
        with rec.span("plan.solve.attempt", warm=True, engine="sparse"), \
                _device.measure(
                    "sparse.warm", f"{prev.shape[0]}x{nweights.shape[-1]}",
                    prev.device, (prev, pweights, nweights, valid,
                                  stickiness, gids, gid_valid, shortlist,
                                  dirty_t, used, p_real)):
            out, new_used, ok, exh = _warm_repair_sparse(
                prev, pweights, nweights, valid, stickiness, gids,
                gid_valid, shortlist, dirty_t, used, constraints, rules,
                p_real)
            accepted = bool(ok)
    if stats is not None:
        stats.update(k=int(shortlist.shape[1]), shortlist_s=shortlist_s,
                     accepted=accepted, exhausted_rows=int(exh.sum()),
                     fallback_rows=0)
    if not accepted:
        return _warm_declined(record)
    if record:
        _record_sweeps(1)
        rec.set_attr("warm", True)
    patched, replaced = _apply_sparse_fallback(
        out.cpu().numpy(), exh.cpu().numpy(), prev, pweights, nweights,
        valid, stickiness, gids, gid_valid, constraints, rules, record)
    if stats is not None:
        stats["fallback_rows"] = replaced
    if replaced:
        return patched, carry_from_assignment(patched, pweights, nweights)
    return patched, SolveCarry(prices=new_used.sum(0), assign=out,
                               used=new_used)


def _sparse_selected(opts: PlanOptions, p: int, n: int, rules: Rules,
                     device: torch.device) -> bool:
    """Route a plan through the sparse engine?  ``opts.sparse`` True or
    False forces it (True with non-nesting rules is an error); None =
    sparse exactly when the matrix engine's projected [P, N] footprint
    exceeds the budget and the rules nest."""
    sel = opts.sparse
    if sel is False:
        return False
    nest = sparse_rules_supported(rules)
    if sel:
        if not nest:
            raise ValueError(
                "PlanOptions(sparse=True) requires nesting hierarchy "
                "rules (exclude_level < include_level for every rule)")
        return True
    return nest and projected_score_bytes(p, n) > \
        dense_score_budget_bytes(device)


def _opts_shortlist_k(opts: PlanOptions, n: int, constraints: Constraints,
                      rules: Rules) -> int:
    """PlanOptions.sparse_k, or the auto-derived K."""
    k = opts.sparse_k
    if k is not None:
        if int(k) < 1:
            raise ValueError(f"PlanOptions.sparse_k must be >= 1, got {k}")
        return min(int(k), max(n, 1))
    return auto_shortlist_k(n, constraints, rules)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _cuda_supported(opts: PlanOptions) -> bool:
    """Can the batched solver honor these options' placement policy?
    The reference's ``_tpu_supported`` under the port's name.

    The device score bakes in the default scoring formula plus the cbgt
    booster shape max(-weight, stickiness); an arbitrary Python
    ``node_scorer``/``node_sorter`` or a non-cbgt ``node_score_booster``
    cannot run on the card (reference contract: plan.go:566-580,693-697).
    Negative node weights WITHOUT a booster are unsupported too: the
    reference ignores them (plan.go:675-684 boosts only when the booster
    is set), while the device score would pin them."""
    if opts.node_scorer is not None or opts.node_sorter is not None:
        return False
    booster = opts.node_score_booster
    if booster is not None and \
            getattr(booster, "__blance_native__", None) != "cbgt":
        return False
    if booster is None and opts.node_weights and \
            any(w < 0 for w in opts.node_weights.values()):
        return False
    return True


def _solver_arrays(problem, opts: PlanOptions, device: torch.device):
    """The solver's host arrays for ``problem``, the (P, N) shape it
    solves at and its ``p_real``.  With ``opts.shape_bucketing`` the
    arrays are padded to (bucket_size(P), bucket_size(N)) with inert rows
    and columns (``pad_problem_arrays``: weight-0 pad partitions, invalid
    pad nodes) and ``p_real`` is the real P as a 0-d float32 tensor on
    ``device``, the fill term's denominator; without it the arrays are the
    encoded ones and ``p_real`` None."""
    arrays = (problem.prev, problem.partition_weights, problem.node_weights,
              problem.valid_node, problem.stickiness, problem.gids,
              problem.gid_valid)
    if not opts.shape_bucketing:
        return arrays, (problem.P, problem.N), None
    solve_p, solve_n = bucket_size(problem.P), bucket_size(problem.N)
    return (pad_problem_arrays(*arrays, solve_p, solve_n), (solve_p, solve_n),
            torch.tensor(float(problem.P), dtype=torch.float32,
                         device=device))


def plan_next_map_cuda(
    prev_map: PartitionMap,
    partitions_to_assign: PartitionMap,
    nodes_all: list[str],
    nodes_to_remove: Optional[list[str]],
    nodes_to_add: Optional[list[str]],
    model: PartitionModel,
    opts: Optional[PlanOptions] = None,
    timer=None,
    *,
    device="cuda",
    timings: Optional[dict] = None,
) -> tuple[PartitionMap, dict[str, list[str]]]:
    """The batched planner on one device: encode on the host, the
    converged solve on ``device`` (the sparse engine when
    ``opts.sparse`` asks for it or, with ``sparse=None``, when the
    matrix engine's projected footprint exceeds the budget and the rules
    nest; else a dense engine), the audit, decode.  Same inputs and
    outputs as the reference's plan_next_map_tpu, and the same
    ``plan.encode`` / ``plan.solve`` / ``plan.decode`` spans, which also
    accumulate into ``timer`` (a PhaseTimer) when one is given.
    ``timings``, when given, receives encode_s / solve_s / audit_s /
    decode_s wall times (the device synchronised before each clock
    read), the engine that ran ("matrix", "fused" or "sparse"), the
    sweep count and the kernel launches of the solve; on the sparse
    engine also k, shortlist_s, exhausted_rows and fallback_rows (see
    solve_sparse).

    Custom placement hooks the device score cannot express
    (``_cuda_supported``) run the exact native planner (the Python greedy
    where that cannot run) inside a ``plan.solve`` span with
    ``engine="exact-fallback"``, so a cbgt-style app keeps its policy.
    ``opts.shape_bucketing`` pads the problem to the next bucket
    (``_solver_arrays``), chooses the engine at the padded shape, solves
    with the real P as ``p_real`` (recorded as ``bucketed_shape`` on
    ``plan.solve``) and slices the pad rows off before the audit."""
    opts = opts or PlanOptions()
    device = resolve_device(device, "plan_next_map_cuda")
    timer = timer if timer is not None else PhaseTimer()
    if not _cuda_supported(opts):
        from .native import plan_next_map_native  # falls back to greedy

        # The exact path has no encode/solve/decode split; attribute it
        # all to "solve" so a caller's timer still sees the wall-clock.
        with phase_span("plan.solve", timer=timer, engine="exact-fallback"):
            return plan_next_map_native(
                prev_map, partitions_to_assign, nodes_all,
                nodes_to_remove, nodes_to_add, model, opts)
    del nodes_to_add
    stamps = {"t0": time.perf_counter()}
    with phase_span("plan.encode", timer=timer):
        problem = encode_problem(prev_map, partitions_to_assign, nodes_all,
                                 nodes_to_remove, model, opts)
    stamps["t1"] = time.perf_counter()
    if problem.P == 0 or problem.N == 0 or problem.S == 0:
        return decode_assignment(
            problem,
            np.full((problem.P, problem.S, max(problem.R, 1)), -1, np.int32),
            partitions_to_assign, nodes_to_remove)
    rules = tuple(tuple(problem.rules.get(si, ()))
                  for si in range(problem.S))
    constraints = tuple(int(c) for c in problem.constraints)
    stats: dict = {}
    launches0 = launch_counts()
    max_iterations = max(int(opts.max_iterations), 1)
    arrays, (solve_p, solve_n), p_real = _solver_arrays(problem, opts,
                                                        device)
    use_sparse = _sparse_selected(opts, solve_p, solve_n, rules, device)
    # Observatory attribution: the bucketed path owns its dispatch as
    # "solve_dense.bucketed" (first-wins, so the inner cold/carry labels
    # of the solvers yield to it); the unbucketed path lets them stand.
    obs_entry = _device.entry("solve_dense.bucketed") \
        if opts.shape_bucketing else contextlib.nullcontext()
    with phase_span("plan.solve", timer=timer, partitions=problem.P,
                    nodes=problem.N,
                    engine=("sparse" if use_sparse else None),
                    bucketed_shape=((solve_p, solve_n)
                                    if opts.shape_bucketing else None)), \
            obs_entry:
        args = problem_to_torch(*arrays, device=device)
        if use_sparse:
            assign = solve_sparse(
                *args, constraints, rules,
                k=_opts_shortlist_k(opts, solve_n, constraints, rules),
                max_iterations=max_iterations, stats=stats, p_real=p_real)
            engine = "sparse"
            timer.annotate("engine", engine)
        else:
            assign, mode = solve_converged_resilient(
                *args, constraints, rules, max_iterations=max_iterations,
                mode=resolve_default_fused_score(solve_p, solve_n, device),
                allow_fallback=_FUSED_SCORE_DEFAULT == "auto",
                context="plan_next_map_cuda", stats=stats, timer=timer,
                p_real=p_real)
            engine = _ENGINE_NAMES[mode]
        _sync(device)
    assign = assign[:problem.P]  # bucketing's pad rows are not real work
    stamps["t2"] = time.perf_counter()
    maybe_validate(problem, assign, opts.validate_assignment,
                   "plan_next_map_cuda")
    stamps["t2a"] = time.perf_counter()
    with phase_span("plan.decode", timer=timer):
        result = decode_assignment(problem, assign, partitions_to_assign,
                                   nodes_to_remove)
    stamps["t3"] = time.perf_counter()
    if timings is not None:
        timings.update(
            encode_s=stamps["t1"] - stamps["t0"],
            solve_s=stamps["t2"] - stamps["t1"],
            audit_s=stamps["t2a"] - stamps["t2"],
            decode_s=stamps["t3"] - stamps["t2a"],
            engine=engine,
            launches={name: c - launches0[name]
                      for name, c in launch_counts().items()},
            **stats)
    return result


# --- the fused plan pipeline -------------------------------------------------
#
# The reference chains solve -> move diff -> decode pack into ONE jitted
# program.  Here the fixpoint's exit test and the auction's rounds read a
# scalar back per sweep and per round, so the pipeline cannot be one
# program.  Its counterpart of "one dispatch" is ONE device-to-host copy
# for every output after the solve: the diff and the pack run on the
# solver's own tensors, and the assignment, the three diff arrays, the
# packed rows and their counts (and the warm path's acceptance flag) come
# back together in one int32 buffer (``_fetch``).  The reference donates
# ``prev`` (and the warm carry table) into its outputs; torch has no
# donation and the port needs none: the uploaded ``prev`` tensor is the
# diff's beginning state as it is, never copied.


def _fetch(*tensors: torch.Tensor) -> list[NPArray]:
    """Bring ``tensors`` (int32 or bool, on one device) to the host in one
    copy: flattened into one int32 buffer on their device, copied once,
    and split into numpy arrays of their shapes (bool ones as bool)."""
    flat = torch.cat([t.reshape(-1).to(torch.int32)
                      for t in tensors]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        a = flat[off:off + t.numel()].reshape(tuple(t.shape))
        out.append(a.astype(bool) if t.dtype == torch.bool else a)
        off += t.numel()
    return out


def _pipeline_cold_impl(prev, pweights, nweights, valid, stickiness, gids,
                        gid_valid, constraints: Constraints, rules: Rules,
                        max_iterations: int = 10, fused_score: str = "off",
                        favor_min_nodes: bool = False,
                        carry_used: Optional[torch.Tensor] = None,
                        p_real=None, axis=None, node_axis=None,
                        node_shards: int = 1):
    """Cold pipeline body: the converged solve, then diff(prev, out) and
    the decode pack on the solver's own tensors (row-wise, so a shard
    diffs and packs its own rows with no further collective).

    Returns (assign, sweeps, prices, used, d_nodes, d_states, d_ops,
    packed, counts): tensors on prev's device, ``sweeps`` an int.
    ``prices``/``used`` are the next SolveCarry's tables, built with
    carry_from_assignment's own ops.  The solve is the unchanged
    fixpoint, so ``assign`` is bitwise the staged path's."""
    out, sweeps = _solve_dense_converged_impl(
        prev, pweights, nweights, valid, stickiness, gids, gid_valid,
        constraints, rules, max_iterations, fused_score, carry_used, p_real,
        axis=axis, node_axis=node_axis, node_shards=node_shards)
    used = _used_by_state(out, pweights, nweights.shape[0], prev.shape[1],
                          axis)
    d_nodes, d_states, d_ops = diff_assignments(
        prev, out, favor_min_nodes=favor_min_nodes)
    packed, counts = pack_assignment_core(out)
    return (out, sweeps, used.sum(0), used, d_nodes, d_states, d_ops,
            packed, counts)


def _pipeline_warm_impl(prev, pweights, nweights, valid, stickiness, gids,
                        gid_valid, dirty, carry_used,
                        constraints: Constraints, rules: Rules,
                        fused_score: str = "off",
                        favor_min_nodes: bool = False, p_real=None,
                        axis=None, node_axis=None, node_shards: int = 1):
    """Warm pipeline body: one carry-seeded repair sweep (``_warm_repair``,
    its acceptance flag included), then the diff and the pack.

    Returns (assign, prices, used, ok, d_nodes, d_states, d_ops, packed,
    counts); ``ok`` (a 0-d bool tensor) False means the repair leaked and
    the caller runs the cold pipeline, the diff and pack then wasted:
    declines are the rare path."""
    out, new_used, ok = _warm_repair(
        prev, pweights, nweights, valid, stickiness, gids, gid_valid,
        dirty, carry_used, constraints, rules, fused_score, p_real,
        axis=axis, node_axis=node_axis, node_shards=node_shards)
    d_nodes, d_states, d_ops = diff_assignments(
        prev, out, favor_min_nodes=favor_min_nodes)
    packed, counts = pack_assignment_core(out)
    return (out, new_used.sum(0), new_used, ok, d_nodes, d_states, d_ops,
            packed, counts)


def _pipeline_sparse_cold_impl(prev, pweights, nweights, valid, stickiness,
                               gids, gid_valid, constraints: Constraints,
                               rules: Rules, max_iterations: int = 10,
                               shortlist_k: int = 16,
                               favor_min_nodes: bool = False,
                               carry_used: Optional[torch.Tensor] = None,
                               p_real=None):
    """Sparse pipeline body: shortlist build, the sparse converged solve,
    the diff and the pack.  Returns the cold pipeline's tuple plus the
    exhaustion flags; the dispatcher re-places flagged rows on the host
    and re-derives the diff and the pack for them."""
    shortlist = build_shortlist_core(prev, pweights, nweights, valid, gids,
                                     gid_valid, constraints, rules,
                                     shortlist_k)
    out, sweeps, exh = _solve_sparse_converged_impl(
        prev, pweights, nweights, valid, stickiness, gids, gid_valid,
        shortlist, constraints, rules, max_iterations, carry_used, p_real)
    used = _used_by_state(out, pweights, nweights.shape[0], prev.shape[1])
    d_nodes, d_states, d_ops = diff_assignments(
        prev, out, favor_min_nodes=favor_min_nodes)
    packed, counts = pack_assignment_core(out)
    return (out, sweeps, used.sum(0), used, d_nodes, d_states, d_ops,
            packed, counts, exh)


def _seeded_beg_map(prev_map: PartitionMap,
                    partitions_to_assign: PartitionMap) -> PartitionMap:
    """The beginning state the planner actually diffs against: prev_map
    entries where present, partitions_to_assign seeds elsewhere — the
    same ``prev_map.get(p) or partitions_to_assign[p]`` rule
    encode_problem fills prev[P, S, R] with."""
    return {name: (prev_map.get(name) or partitions_to_assign[name])
            for name in partitions_to_assign}


def plan_pipeline(
    prev_map: PartitionMap,
    partitions_to_assign: PartitionMap,
    nodes_all: list[str],
    nodes_to_remove: Optional[list[str]],
    nodes_to_add: Optional[list[str]],
    model: PartitionModel,
    opts: Optional[PlanOptions] = None,
    timer=None,
    *,
    favor_min_nodes: bool = False,
    want_moves: bool = True,
    device="cuda",
):
    """plan_next_map_cuda and the move diff with one device-to-host copy.

    Returns (next_map, warnings, moves): the map and warnings are bitwise
    ``plan_next_map_cuda``'s, and ``moves`` equals
    ``calc_all_moves(_seeded_beg_map(prev_map, partitions_to_assign),
    next_map, model, favor_min_nodes)``, the per-partition ordered op
    lists the orchestrator consumes.  The encode stays on the host
    (string interning); the solve, the diff and the decode pack run on
    ``device`` and come back in one copy, and the decode's host share is
    the id->name gather.

    Caveat shared with PlannerSession.moves(): partitions whose beginning
    state holds one node in several states diff through the dense
    one-state-per-node encoding (calc_all_moves's irregular-partition
    host fallback does not apply); the solver's own outputs never do
    that.

    Engine or runtime failures degrade to the staged path
    (plan_next_map_cuda and calc_all_moves, on the same device) with a
    UserWarning, counted as ``plan.pipeline.fallback``.  ``want_moves=
    False`` skips the host move materialization and returns ``{}`` as the
    third element (plan_next_map's ``fused_pipeline`` option).

    Custom placement hooks (``_cuda_supported``) take the exact path:
    ``plan_next_map_cuda``'s exact fallback, then ``calc_all_moves`` on
    ``device``.  ``opts.shape_bucketing`` pads as plan_next_map_cuda does
    and slices the pad rows off every output."""
    from ..moves.batch import calc_all_moves

    opts = opts or PlanOptions()
    device = resolve_device(device, "plan_pipeline")
    timer = timer if timer is not None else PhaseTimer()
    rec = get_recorder()
    if not _cuda_supported(opts):
        # The exact path keeps custom placement hooks; the move diff
        # still runs on the device against the dense maps.
        next_map, warnings = plan_next_map_cuda(
            prev_map, partitions_to_assign, nodes_all, nodes_to_remove,
            nodes_to_add, model, opts, timer, device=device)
        moves = calc_all_moves(
            _seeded_beg_map(prev_map, partitions_to_assign), next_map,
            model, favor_min_nodes, device=device) if want_moves else {}
        return next_map, warnings, moves
    del nodes_to_add

    with rec.span("plan.pipeline", partitions=len(partitions_to_assign),
                  nodes=len(nodes_all)):
        rec.count("plan.pipeline.calls")
        with phase_span("plan.encode", timer=timer):
            problem = encode_problem(prev_map, partitions_to_assign,
                                     nodes_all, nodes_to_remove, model, opts)
        if problem.P == 0 or problem.N == 0 or problem.S == 0:
            next_map, warnings = decode_assignment(
                problem,
                np.full((problem.P, problem.S, max(problem.R, 1)), -1,
                        np.int32),
                partitions_to_assign, nodes_to_remove)
            return next_map, warnings, {n: [] for n in problem.partitions}

        rules = tuple(tuple(problem.rules.get(si, ()))
                      for si in range(problem.S))
        constraints = tuple(int(c) for c in problem.constraints)
        arrays, (solve_p, solve_n), p_real = _solver_arrays(problem, opts,
                                                            device)
        _check_tier_band_scale(*arrays[:5], constraints, rules)
        max_iterations = max(int(opts.max_iterations), 1)
        try:
            if _sparse_selected(opts, solve_p, solve_n, rules, device):
                res = _dispatch_pipeline_sparse(
                    *arrays, constraints, rules,
                    max_iterations=max_iterations,
                    shortlist_k=_opts_shortlist_k(opts, solve_n,
                                                  constraints, rules),
                    favor_min_nodes=favor_min_nodes, device=device,
                    timer=timer, p_real=p_real)
            else:
                res = _dispatch_pipeline_cold(
                    *arrays, constraints, rules,
                    max_iterations=max_iterations,
                    fused_score=resolve_default_fused_score(
                        solve_p, solve_n, device),
                    allow_fallback=_FUSED_SCORE_DEFAULT == "auto",
                    favor_min_nodes=favor_min_nodes, device=device,
                    entry=("solve_dense.bucketed" if opts.shape_bucketing
                           else "pipeline.cold"),
                    timer=timer, p_real=p_real)
        except (ValueError, TypeError):
            raise  # deterministic input errors: the same on the staged path
        except Exception as e:
            first = (str(e).splitlines() or [""])[0][:200]
            _warnings.warn(
                f"blance_tpu_torch plan_pipeline: the pipeline failed "
                f"({type(e).__name__}: {first}); degrading to the staged "
                f"path", UserWarning, stacklevel=2)
            rec.count("plan.pipeline.fallback")
            next_map, warnings = plan_next_map_cuda(
                prev_map, partitions_to_assign, nodes_all, nodes_to_remove,
                None, model, opts, timer, device=device)
            moves = calc_all_moves(
                _seeded_beg_map(prev_map, partitions_to_assign), next_map,
                model, favor_min_nodes, device=device) if want_moves else {}
            return next_map, warnings, moves

        assign, _sweeps, _carry, (d_nodes, d_states, d_ops), \
            (packed, counts) = res
        real = problem.P  # bucketing's pad rows are sliced off
        assign = assign[:real]
        maybe_validate(problem, assign, opts.validate_assignment,
                       "plan_pipeline")
        with phase_span("plan.decode", timer=timer):
            next_map, warnings = decode_assignment(
                problem, assign, partitions_to_assign, nodes_to_remove,
                packed=packed[:real], counts=counts[:real])
        if not want_moves:
            return next_map, warnings, {}
        with phase_span("plan.pipeline.materialize", timer=timer):
            moves = moves_from_arrays(problem.partitions, problem.states,
                                      problem.nodes, d_nodes[:real],
                                      d_states[:real], d_ops[:real])
        return next_map, warnings, moves


def _dispatch_pipeline_cold(
    prev_a, pw_a, nw_a, valid_a, stick_a, gids_a, gv_a,
    constraints: Constraints, rules: Rules, *, max_iterations: int,
    fused_score: str, allow_fallback: bool, favor_min_nodes: bool,
    device: torch.device, entry: str, timer=None, carry_used=None,
    p_real=None,
):
    """One cold pipeline run on ``device`` from host arrays, with
    solve_converged_resilient's engine-failure degradation (retry once on
    the other engine when the mode came from "auto", on a card).  Returns
    (assign, sweeps, SolveCarry, (d_nodes, d_states, d_ops), (packed,
    counts)), the arrays numpy and off the device in one copy.
    ``entry`` is the dispatch's observatory label (obs/device.py)."""
    rec = get_recorder()

    def run(m: str):
        check_dense_memory(prev_a.shape[0], prev_a.shape[1],
                           nw_a.shape[-1], m, device)
        t0 = rec.now()
        with phase_span("plan.pipeline.dispatch", timer=timer, engine=m), \
                _device.entry(entry), _device.measure(
                    entry, f"{prev_a.shape[0]}x{nw_a.shape[-1]}", device,
                    (carry_used,)):
            args = problem_to_torch(prev_a, pw_a, nw_a, valid_a, stick_a,
                                    gids_a, gv_a, device=device)
            (assign, sweeps, prices, used, d_nodes, d_states, d_ops,
             packed, counts) = _pipeline_cold_impl(
                *args, constraints, rules, max_iterations=max_iterations,
                fused_score=m, favor_min_nodes=favor_min_nodes,
                carry_used=(None if carry_used is None
                            else carry_used.to(device)), p_real=p_real)
            host = _fetch(assign, d_nodes, d_states, d_ops, packed, counts)
        rec.observe("plan.pipeline.dispatch_s", rec.now() - t0)
        _record_sweeps(sweeps)
        if timer is not None:
            timer.annotate("engine", _ENGINE_NAMES[m])
        return (host[0], sweeps,
                SolveCarry(prices=prices, assign=assign, used=used),
                tuple(host[1:4]), tuple(host[4:6]))

    try:
        return run(fused_score)
    except (ValueError, TypeError):
        raise
    except Exception as e:
        alt = {"off": "on", "on": "off"}.get(fused_score)
        if not allow_fallback or alt is None or device.type != "cuda":
            raise
        first = (str(e).splitlines() or [""])[0][:200]
        _warnings.warn(
            f"blance_tpu_torch plan_pipeline: score engine {fused_score!r} "
            f"failed ({type(e).__name__}: {first}); retrying with {alt!r}",
            UserWarning, stacklevel=3)
        rec.count("plan.engine_fallback")
        if timer is not None:
            timer.annotate("engine_fallback", f"-> {alt}")
        return run(alt)


def _dispatch_pipeline_sparse(
    prev_a, pw_a, nw_a, valid_a, stick_a, gids_a, gv_a,
    constraints: Constraints, rules: Rules, *, max_iterations: int,
    shortlist_k: int, favor_min_nodes: bool, device: torch.device,
    timer=None, p_real=None,
):
    """One sparse pipeline run on ``device`` from host arrays; returns
    ``_dispatch_pipeline_cold``'s tuple.  Exhausted rows are re-placed by
    the host fallback against the host ``prev_a``, and their diff, pack
    and carry re-derived on the device from the patched assignment (one
    more copy, on that rare path only).  The dispatch is the
    observatory's "sparse.pipeline" entry (obs/device.py)."""
    rec = get_recorder()
    t0 = rec.now()
    with phase_span("plan.pipeline.dispatch", timer=timer, engine="sparse"), \
            _device.entry("sparse.pipeline"), _device.measure(
                "sparse.pipeline", f"{prev_a.shape[0]}x{nw_a.shape[-1]}",
                device):
        args = problem_to_torch(prev_a, pw_a, nw_a, valid_a, stick_a,
                                gids_a, gv_a, device=device)
        (assign, sweeps, prices, used, d_nodes, d_states, d_ops, packed,
         counts, exh) = _pipeline_sparse_cold_impl(
            *args, constraints, rules, max_iterations=max_iterations,
            shortlist_k=shortlist_k, favor_min_nodes=favor_min_nodes,
            p_real=p_real)
        host = _fetch(assign, d_nodes, d_states, d_ops, packed, counts, exh)
    rec.observe("plan.pipeline.dispatch_s", rec.now() - t0)
    rec.set_gauge("plan.sparse.k_effective", float(shortlist_k))
    _record_sweeps(sweeps)
    if timer is not None:
        timer.annotate("engine", "sparse")
    patched, replaced = _apply_sparse_fallback(
        host[0], host[6], prev_a, pw_a, nw_a, valid_a, stick_a, gids_a,
        gv_a, constraints, rules)
    if not replaced:
        return (host[0], sweeps,
                SolveCarry(prices=prices, assign=assign, used=used),
                tuple(host[1:4]), tuple(host[4:6]))
    dev_assign = torch.from_numpy(patched).to(device)
    redo = _fetch(*diff_assignments(args[0], dev_assign,
                                    favor_min_nodes=favor_min_nodes),
                  *pack_assignment_core(dev_assign))
    return (patched, sweeps, carry_from_assignment(dev_assign, args[1],
                                                   args[2]),
            tuple(redo[:3]), tuple(redo[3:]))
