"""Auction score computed in-kernel, fused with the priced min2.

Port of blance_tpu/ops/score_fused.py.  The score is a function of tiny
inputs: [N] vectors (fill factor, weights, validity, price, candidate
group ids) and [P, few] id columns (previous holders, exclusivity list,
rule anchors).  ``fused_score_min2`` evaluates it per (row, column)
inside the CUDA kernel ``csrc/score_fused.cu`` and reduces it on the
fly, so the [P, N] matrix never exists on the card.

Outputs per row: (best = min of score + price, choice = LOCAL argmin,
second = second-best by position, raw = best - price at the argmin).

Two rounding rules keep the port bitwise equal to the jitted reference
on the CPU (XLA):

- the fill term ``0.001 * total / P`` with P a trace-time constant is
  folded by XLA into ``total * fl32(fl32(0.001) * fl32(1 / P))``; the
  port multiplies by that constant (:func:`fill_scale`).  With P a
  traced scalar (``p_real``, shape bucketing) XLA instead divides once
  by the product ``(fl32(0.001) * total) / (max(P, 1) * w_div)``, and so
  does the port (:func:`fill_term`);
- XLA contracts the jitter add ``score + 1e-5 * jitter_hash`` into one
  fused multiply-add; the port rounds it once too (:func:`jitter_add`),
  and the kernel spells it ``fmaf``.

A second kernel, :func:`score_write` (``csrc/score_write.cu`` and, for
runtime widths, ``csrc/score_write_any.cu``, which share the per-cell
score ``csrc/score_cell.cuh`` with the fused one),
writes the matrix engine's unpriced [P, N] score from the same packed
inputs, in that engine's term order, for the priced min2 kernel to
reduce (``plan/tensor.py`` ``_matrix_score`` on the card).

The score is spelled once in plain PyTorch, :func:`score_cells`, at any
set of (row, column) cells of the packed inputs: the matrix build on
the CPU, the sparse engine's shortlist columns, both engines' phase-B
probes and the two kernels' plain versions all call it.  On a CPU
tensor ``fused_score_min2`` runs its plain version
(:func:`fused_score_min2_reference`); on a CUDA tensor it launches the
kernel or raises; so does ``score_write``
(:func:`score_write_reference`).  ``fused_score_min2.launches`` counts
launches, and ``fused_score_min2.variants`` counts them by kernel
instantiation (the name :func:`fused_variant` gives, prefixed
``batched_`` for a launch over a batch of problems, and suffixed
``_rows_per_warp`` where the narrow-row layout that :func:`fused_lanes`
picks for narrow rows ran it).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..obs import counts_recorder
from . import cost as _cost

__all__ = ["fused_score_min2", "fused_score_min2_reference",
           "batched_fused_reference", "score_write",
           "score_write_reference", "ScoreInputs",
           "pack_score_inputs", "score_cells", "jitter_hash",
           "jitter_add", "fill_scale", "fill_term", "FUSED_VARIANTS",
           "fused_variant", "fused_lanes", "FUSED_LANES_BY_N"]

_INF = 1.0e9
_RULE_MISS = 1.0e6
_RULE_TIER = 1.0e4
_J_MUL_P = 2654435761 - (1 << 32)  # int32 two's-complement bits of the
_J_MUL_N = 40503                   # unsigned Weyl multiplier 2654435761
# Rows per chunk of the plain score build: bounds its float64 jitter
# temporaries to a few hundred MB at any P.
_ROW_CELLS = 1 << 24


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along the last axis, per batch element: ``x`` [*B, N] at
    ``idx`` [*B, *rest] (any trailing shape) gives [*B, *rest]."""
    flat = idx.reshape(*idx.shape[:x.dim() - 1], -1).long()
    return torch.gather(x, -1, flat).reshape(idx.shape)


def _take_rows(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``x[rows]`` for [*B, P, W] rows at ``rows`` [*B, K]: [*B, K, W]."""
    idx = rows.long()[..., None].expand(*rows.shape, x.shape[-1])
    return torch.gather(x, -2, idx)


def jitter_hash(pi: torch.Tensor, ni: torch.Tensor) -> torch.Tensor:
    """THE deterministic tie-break hash, in [0, 1): Weyl-style over GLOBAL
    (partition, node) indices, int32 inputs.  int32 products wrap in
    two's complement, so the masked low 16 bits equal the unsigned
    sequence bit-for-bit (pinned against the reference by tests)."""
    h = (pi.to(torch.int32) * _J_MUL_P + ni.to(torch.int32) * _J_MUL_N) \
        & 0xFFFF
    return h.to(torch.float32) / 65536.0


def jitter_add(score: torch.Tensor, pi: torch.Tensor, ni: torch.Tensor,
               jitter_scale: float) -> torch.Tensor:
    """``score + jitter_scale * jitter_hash(pi, ni)`` rounded ONCE, as
    the fused multiply-add XLA emits for it on the reference.

    The product is exact in float64 (24 + 16 significant bits); the sum
    is taken in float64 with round-to-odd (TwoSum error term, then the
    last bit forced toward the exact value), which makes the final
    rounding to float32 the correctly rounded fused result."""
    prod = jitter_hash(pi, ni).double() * float(np.float32(jitter_scale))
    c = score.double()
    s = prod + c
    bv = s - prod
    err = (prod - (s - bv)) + (c - bv)
    bits = s.view(torch.int64)
    fix = (err != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    return torch.where(fix, bits + step, bits).view(torch.float64) \
        .to(torch.float32)


def fill_scale(total_p) -> float:
    """The fill term's multiplier for ``0.001 * total / max(P, 1)`` as
    XLA folds it with P a trace-time constant: fl32(0.001) times the
    float32 reciprocal, rounded to float32."""
    p = np.float32(max(float(total_p), 1.0))
    return float(np.float32(np.float32(0.001) * (np.float32(1.0) / p)))


def fill_term(total: torch.Tensor, total_p, w_div: torch.Tensor) \
        -> torch.Tensor:
    """The balance term ``(0.001 * total / max(P, 1)) / w_div`` as the
    jitted reference computes it.  ``total_p`` a Python number (the
    partition count, a trace-time constant there): multiply by
    :func:`fill_scale`.  ``total_p`` a 0-d float32 tensor (``p_real``,
    traced there): XLA rewrites the two divisions into one by the
    product, ``(fl32(0.001) * total) / (max(P, 1) * w_div)``, as
    :func:`pack_score_inputs` builds the ``base`` every engine's score
    starts from."""
    if isinstance(total_p, torch.Tensor):
        return (total * float(np.float32(0.001))) / \
            (total_p.clamp(min=1.0) * w_div)
    return (total * fill_scale(total_p)) / w_div


class ScoreInputs(NamedTuple):
    """Packed per-slot score inputs.

    [N]-shaped:
      base       f32 — fill factor / node weight (the balance term)
      neg_boost  f32 — -min(node_weight, 0)
      validf     f32 — 1.0 valid / 0.0 removed
      cand_g     [2*nrules (or 1), N] i32 — per rule: candidates'
                 include-level gids, then exclude-level gids
    [P]-shaped:
      stick      f32 — stickiness[:, si]
      prev_slot  i32 — prev[:, si, ri] (-1 none): same-ordinal bonus
      prev_state [P, R] i32 — prev[:, si, :]: sticky-holder bonus
      taken      [P, T] i32 — exclusivity id columns (-1 padded)
      present    [P, A] f32 — 1.0 where the rule anchor exists
      a_inc_g / a_exc_g [P, A*nrules (or 1)] i32 — anchors' gids per
                 rule level, -3 where the anchor's gid is invalid
      any_anchor f32 — 1.0 where any anchor present (penalty gate)"""

    base: torch.Tensor
    neg_boost: torch.Tensor
    validf: torch.Tensor
    cand_g: torch.Tensor
    stick: torch.Tensor
    prev_slot: torch.Tensor
    prev_state: torch.Tensor
    taken: torch.Tensor
    present: torch.Tensor
    a_inc_g: torch.Tensor
    a_exc_g: torch.Tensor
    any_anchor: torch.Tensor


def pack_score_inputs(
    *,
    total_l, total_p, w_div_l, neg_boost_l, valid_l,
    stickiness_si, prev_slot, prev_state, taken_ids,
    anchors, gids_l, gid_valid, gids, rules,
) -> ScoreInputs:
    """Build ScoreInputs from the auction's terms (plain PyTorch).

    ``total_p`` is the partition count as a Python number (the
    reference's trace-time constant) or, under shape bucketing, the real
    partition count as a 0-d float32 tensor (see :func:`fill_term`).
    Every input may carry a leading batch axis (the fleet tier), with
    ``total_p`` then a [B, 1] tensor; the fields then do too."""
    base = fill_term(total_l, total_p, w_div_l)
    validf = valid_l.to(torch.float32)

    p = prev_slot.shape[-1]
    lead = prev_slot.shape[:-1]
    dev = base.device
    nrules = len(rules)
    if nrules:
        cand_g = torch.cat(
            [torch.stack([gids_l[..., inc, :] for (inc, _exc) in rules],
                         dim=-2),
             torch.stack([gids_l[..., exc, :] for (_inc, exc) in rules],
                         dim=-2)], dim=-2)
        a_width = anchors.shape[-1]
        aa = anchors.clamp(min=0)
        inc_cols = []
        exc_cols = []
        for ai in range(a_width):
            for (inc, exc) in rules:
                inc_cols.append(torch.where(
                    _take(gid_valid[..., inc, :], aa[..., ai]),
                    _take(gids[..., inc, :], aa[..., ai]), -3))
                exc_cols.append(torch.where(
                    _take(gid_valid[..., exc, :], aa[..., ai]),
                    _take(gids[..., exc, :], aa[..., ai]), -3))
        a_inc_g = torch.stack(inc_cols, dim=-1).to(torch.int32)
        a_exc_g = torch.stack(exc_cols, dim=-1).to(torch.int32)
        present = (anchors >= 0).to(torch.float32)
        any_anchor = (anchors >= 0).any(dim=-1).to(torch.float32)
    else:
        cand_g = torch.zeros(lead + (1, base.shape[-1]), dtype=torch.int32,
                             device=dev)
        a_inc_g = torch.full(lead + (p, 1), -3, dtype=torch.int32,
                             device=dev)
        a_exc_g = torch.full(lead + (p, 1), -3, dtype=torch.int32,
                             device=dev)
        present = torch.zeros(lead + (p, 1), dtype=torch.float32,
                              device=dev)
        any_anchor = torch.zeros(lead + (p,), dtype=torch.float32,
                                 device=dev)
    if taken_ids:
        taken = torch.stack(list(taken_ids), dim=-1)
    else:
        taken = torch.full(lead + (p, 1), -1, dtype=torch.int32, device=dev)
    return ScoreInputs(
        base=base, neg_boost=neg_boost_l, validf=validf,
        cand_g=cand_g.to(torch.int32), stick=stickiness_si,
        prev_slot=prev_slot, prev_state=prev_state, taken=taken,
        present=present, a_inc_g=a_inc_g, a_exc_g=a_exc_g,
        any_anchor=any_anchor)


def score_cells(si: ScoreInputs, rows: torch.Tensor,
                cols: Optional[torch.Tensor], pbase: int, noff: int, *,
                nrules: int, jitter_scale: float, order: str) -> torch.Tensor:
    """The unpriced auction score at (row, column) cells from the packed
    inputs: the one plain spelling, which every engine evaluates and both
    kernels (``csrc/score_cell.cuh``) are held against.

    ``rows`` [*B, M] local row ids ([M]: the same rows of every batch
    element).  ``cols`` None: the whole block of the [N_l] fields, the
    global columns ``noff`` .. ``noff + N_l - 1``, giving [*B, M, N_l];
    [*B, M]: one global column a row, giving [*B, M]; [*B, M, K]: K
    global columns a row, -1 pads scoring +INF (hashed as the block's
    first column), giving [*B, M, K].  The jitter hashes ``pbase + row``
    and the global column.

    ``order`` "matrix" subtracts the same-ordinal bonus before it adds
    the negative-weight boost (the matrix and sparse engines, the score
    write); "fused" adds the boost first (the fused kernel).  The two
    round differently where both are nonzero."""
    lead = si.base.shape[:-1]
    n_l = si.base.shape[-1]
    rows = rows.expand(lead + rows.shape[-1:])
    pairs = cols is not None and cols.dim() == rows.dim()
    if cols is None:
        ok = None
        gcol = noff + torch.arange(n_l, dtype=torch.int32,
                                   device=si.base.device)

        def at(x):
            return x.unsqueeze(-2)
    else:
        if pairs:
            cols = cols.unsqueeze(-1)
        ok = cols >= 0
        gcol = cols.clamp(noff, noff + n_l - 1).to(torch.int32)

        def at(x):
            return _take(x, gcol - noff)

    def hit(ids):  # any of a row's [W] ids is the cell's column
        out = ids[..., 0:1] == gcol
        for w in range(1, ids.shape[-1]):
            out = out | (ids[..., w:w + 1] == gcol)
        return out if ok is None else out & ok

    stick = _take(si.stick, rows)[..., None]
    nb = at(si.neg_boost)
    boost = torch.where(nb > 0, torch.maximum(nb, stick), 0.0)
    bonus = 0.01 * hit(_take(si.prev_slot, rows)[..., None]) \
        .to(torch.float32)
    score = (at(si.base) - bonus) + boost if order == "matrix" else \
        (at(si.base) + boost) - bonus
    del nb, boost, bonus  # freed before the jitter's float64 peak
    score = score - stick * hit(_take_rows(si.prev_state, rows)) \
        .to(torch.float32)
    if nrules:
        score = score + _rule_penalty(si, rows, at, nrules, score.shape)
    bad = hit(_take_rows(si.taken, rows)) | (at(si.validf) == 0.0)
    if ok is not None:
        bad = bad | ~ok
    score = score + _INF * bad.to(torch.float32)
    pi = (pbase + rows).to(torch.int32)[..., None]
    out = jitter_add(score, pi, gcol, jitter_scale)
    return out[..., 0] if pairs else out


def _rule_penalty(si: ScoreInputs, rows: torch.Tensor, at: Callable,
                  nrules: int, shape: torch.Size) -> torch.Tensor:
    """The tiered rule penalty of :func:`score_cells` at its cells (``at``
    gathers an [N_l] field there): the first rule every present anchor
    satisfies sets the tier (index * 1e4); none costs _RULE_MISS; a row
    without anchors pays nothing."""
    dev = si.base.device
    ainc = _take_rows(si.a_inc_g, rows)
    aexc = _take_rows(si.a_exc_g, rows)
    present = _take_rows(si.present, rows)
    pen = torch.full(shape, _RULE_MISS, dtype=torch.float32, device=dev)
    for idx in range(nrules):
        cinc = at(si.cand_g[..., idx, :])
        cexc = at(si.cand_g[..., nrules + idx, :])
        sat = torch.ones(shape, dtype=torch.bool, device=dev)
        for ai in range(present.shape[-1]):
            col = ai * nrules + idx
            sat = sat & ((present[..., ai:ai + 1] <= 0.0)
                         | ((ainc[..., col:col + 1] == cinc)
                            & ~(aexc[..., col:col + 1] == cexc)))
        pen = torch.where(sat, torch.clamp(pen, max=idx * _RULE_TIER), pen)
    return torch.where(_take(si.any_anchor, rows)[..., None] > 0, pen, 0.0)


def _row_step(si: ScoreInputs) -> int:
    """Rows per chunk of a plain [*B, P, N] build (B·N cells a row)."""
    return max(1, _ROW_CELLS // max(si.base.numel(), 1))


def fused_score_min2_reference(price: torch.Tensor, si: ScoreInputs,
                               pbase: int, noff: int, *, nrules: int,
                               jitter_scale: float):
    """Plain PyTorch version of the fused kernel: the score in the
    kernel's term order, then (best, choice, second, raw).  Built in row
    chunks, so peak memory stays bounded at any P."""
    from .reduce2 import min2_argmin_reference

    p = si.stick.shape[0]
    step = _row_step(si)
    outs = []
    for lo in range(0, p, step):
        score = score_cells(
            si, torch.arange(lo, min(p, lo + step), device=price.device),
            None, pbase, noff, nrules=nrules, jitter_scale=jitter_scale,
            order="fused")
        b, c, s2 = min2_argmin_reference(score + price[None, :])
        outs.append((b, c, s2, b - price[c.long()]))
    if not outs:
        e = torch.empty(0, dtype=torch.float32, device=price.device)
        return e, e.to(torch.int32), e, e
    return tuple(torch.cat(t) for t in zip(*outs))


def score_write_reference(si: ScoreInputs, pbase: int, noff: int, *,
                          nrules: int, jitter_scale: float) -> torch.Tensor:
    """Plain PyTorch version of the score write: the unpriced score
    [P, N] ([B, P, N] for inputs with a leading [B]) in the matrix
    engine's term order, built in row chunks."""
    p = si.stick.shape[-1]
    dev = si.base.device
    out = torch.empty(si.stick.shape + si.base.shape[-1:],
                      dtype=torch.float32, device=dev)
    step = _row_step(si)
    for lo in range(0, p, step):
        hi = min(p, lo + step)
        out[..., lo:hi, :] = score_cells(
            si, torch.arange(lo, hi, device=dev), None, pbase, noff,
            nrules=nrules, jitter_scale=jitter_scale, order="matrix")
    return out


def batched_fused_reference(price: torch.Tensor, si: ScoreInputs,
                            pbase: int, noff: int, *, nrules: int,
                            jitter_scale: float):
    """Plain version of the batched launch: ``price`` [B, N] and every
    ScoreInputs field with a leading [B] axis; each problem through
    :func:`fused_score_min2_reference` on its own rows and columns.
    Outputs [B, P] each."""
    outs = [fused_score_min2_reference(
        price[b], ScoreInputs(*(t[b] for t in si)), pbase, noff,
        nrules=nrules, jitter_scale=jitter_scale)
        for b in range(price.shape[0])]
    return tuple(torch.stack(t) for t in zip(*outs))


# The kernel's fixed-width instantiations, by (nrules, R, T, A), in the
# order of their ids in csrc/score_fused.cu; A is 0 without rules.  The
# main path's two slots (a rule-less primary; a replica with one rule,
# two anchors and two taken columns) and the fixtures' small plans.
FUSED_VARIANTS = ((1, 1, 2, 2), (0, 1, 1, 0), (0, 2, 1, 0), (1, 2, 3, 3))


def fused_variant(nrules: int, r_width: int, t_width: int,
                  a_width: int) -> str:
    """The name of the kernel instantiation that runs these widths:
    ``"n{nrules}r{R}t{T}a{A}"`` for a fixed-width one, else
    ``"generic"`` (runtime widths)."""
    key = (nrules, r_width, t_width, a_width if nrules else 0)
    if key in FUSED_VARIANTS:
        return "n%dr%dt%da%d" % key
    return "generic"


# Instantiation name -> its id in the kernel's launcher ("generic": -1).
_VARIANT_IDS = {fused_variant(*v): i for i, v in enumerate(FUSED_VARIANTS)}

# Lanes per row of the narrow-row layout, by the widest N each count
# serves (the first entry whose bound is >= N); wider rows than the last
# bound take the wide tile of 16 rows x 2 columns a thread (lanes 0).
# Measured on the H100 by chip_smoke.py's narrow sweep (PERF.md).
FUSED_LANES_BY_N = ((64, 1), (128, 2), (256, 4), (512, 8), (1024, 16))
_SMEM_BYTES = 48 * 1024  # the launcher's limit on a block's staged rows
_THREADS = 256


def _row_words(nrules: int, r_width: int, t_width: int,
               a_width: int) -> int:
    """A staged row's 32-bit words, as csrc/score_fused.cu row_words."""
    a = a_width if nrules else 0
    return (5 + r_width + t_width + 2 * nrules * a + 3) // 4 * 4


def fused_lanes(n: int, nrules: int, r_width: int, t_width: int,
                a_width: int) -> int:
    """Lanes per row for rows of ``n`` columns: a power of two up to 32
    (the narrow-row layout, ``256 / lanes`` rows a block), or 0 for the
    wide tile.  Where a block's staged rows would pass the launcher's
    48 KB, more lanes a row (fewer rows a block) make them fit."""
    lanes = 0
    for bound, count in FUSED_LANES_BY_N:
        if n <= bound:
            lanes = count
            break
    if lanes:
        words = _row_words(nrules, r_width, t_width, a_width)
        while lanes < 32 and (_THREADS // lanes) * words * 4 > _SMEM_BYTES:
            lanes *= 2
    return lanes


_C_FN = None


def _kernel():
    global _C_FN
    if _C_FN is None:
        from ._build import load

        lib = load("score_fused")
        head = [ctypes.c_void_p] * 17 + [
            ctypes.c_float, ctypes.c_longlong, ctypes.c_longlong] + \
            [ctypes.c_int] * 8
        fn = lib.blance_fused_score_min2
        fn.argtypes = head + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fb = lib.blance_fused_score_min2_batched
        fb.argtypes = head + [ctypes.c_longlong, ctypes.c_int,
                              ctypes.c_void_p]
        fb.restype = ctypes.c_int
        _C_FN = (fn, fb)
    return _C_FN


@functools.cache
def _write_kernel(runtime_widths: bool):
    """The score write's launcher for the fixed-width instantiations
    (``csrc/score_write.cu``) or the runtime-width one
    (``csrc/score_write_any.cu``), each a library of its own, apart from
    the fused kernel's: a matrix plan builds only the one its widths
    need, and min2's library in the same build, since the engine reduces
    the score with it next."""
    from ._build import load

    name = "score_write_any" if runtime_widths else "score_write"
    fw = getattr(load(name, beside=("min2",)), f"blance_{name}")
    fw.argtypes = [ctypes.c_void_p] * 13 + [
        ctypes.c_float, ctypes.c_longlong, ctypes.c_longlong] + \
        [ctypes.c_int] * 8 + [ctypes.c_longlong, ctypes.c_void_p]
    fw.restype = ctypes.c_int
    return fw


_F32 = ("price", "base", "neg_boost", "validf", "stick", "present",
        "any_anchor")


def _checked(what: str, si: ScoreInputs, lead, dev, nrules: int,
             price=None) -> ScoreInputs:
    """``si`` (and ``price``) checked for the kernels' dtypes, device,
    batch and rule columns, made contiguous; raises on what a launch
    does not take."""
    n = si.base.shape[-1]
    named = list(si._asdict().items())
    if price is not None:
        named.insert(0, ("price", price))
    for name, t in named:
        want = torch.float32 if name in _F32 else torch.int32
        if t.dtype != want or t.device != dev:
            raise TypeError(f"{what}: {name} must be {want} on "
                            f"{dev}, got {t.dtype} on {t.device}")
        if t.shape[:len(lead)] != lead:
            raise ValueError(f"{what}: {name} has shape "
                             f"{tuple(t.shape)}, not a batch of {lead}")
    if nrules and (si.cand_g.shape[-2:] != (2 * nrules, n)
                   or si.a_inc_g.shape[-1] != si.present.shape[-1] * nrules):
        raise ValueError(f"{what}: rule columns do not match "
                         f"nrules={nrules}")
    return ScoreInputs(*(t.contiguous() for t in si))


def _launch(price, si: ScoreInputs, pbase: int, noff: int, nrules: int,
            jitter_scale: float, lanes=None):
    """Launch the kernel in the layout :func:`fused_lanes` picks (or
    ``lanes``, for a measurement that compares layouts); a refused launch
    raises."""
    batched = price.dim() == 2
    lead = price.shape[:-1]
    p = si.stick.shape[-1]
    n = price.shape[-1]
    dev = price.device
    si = _checked("fused_score_min2", si, lead, dev, nrules, price)
    price = price.contiguous()
    r_width = si.prev_state.shape[-1]
    t_width = si.taken.shape[-1]
    a_width = si.present.shape[-1]
    g_width = si.a_inc_g.shape[-1]
    variant = fused_variant(nrules, r_width, t_width, a_width)
    best = torch.empty(lead + (p,), dtype=torch.float32, device=dev)
    choice = torch.empty(lead + (p,), dtype=torch.int32, device=dev)
    second = torch.empty(lead + (p,), dtype=torch.float32, device=dev)
    raw = torch.empty(lead + (p,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (
        price.data_ptr(), si.base.data_ptr(), si.neg_boost.data_ptr(),
        si.validf.data_ptr(), si.cand_g.data_ptr(), si.stick.data_ptr(),
        si.prev_slot.data_ptr(), si.prev_state.data_ptr(),
        si.taken.data_ptr(), si.present.data_ptr(), si.a_inc_g.data_ptr(),
        si.a_exc_g.data_ptr(), si.any_anchor.data_ptr(), best.data_ptr(),
        choice.data_ptr(), second.data_ptr(), raw.data_ptr(),
        float(jitter_scale), p, n, int(nrules), r_width, t_width, a_width,
        g_width, int(pbase), int(noff), _VARIANT_IDS.get(variant, -1))
    if lanes is None:
        lanes = fused_lanes(n, nrules, r_width, t_width, a_width)
    if batched:
        err = _kernel()[1](*args, lead[0], lanes, stream)
    else:
        err = _kernel()[0](*args, lanes, stream)
    if err != 0:
        raise RuntimeError(f"score_fused kernel launch failed: CUDA error "
                           f"{err} (lanes {lanes})")
    fused_score_min2.launches += 1
    name = f"{variant}_rows_per_warp" if lanes else variant
    fused_score_min2.variants[f"batched_{name}" if batched else name] += 1
    return best, choice, second, raw


def fused_score_min2(price: torch.Tensor, si: ScoreInputs, pbase: int,
                     noff: int, *, nrules: int, jitter_scale: float):
    """(best, choice_LOCAL, second, raw) per row; score built in-kernel.

    The caller adds ``noff`` to the returned choice for global ids.  A
    batch of problems (``price`` [B, N], every ScoreInputs field with a
    leading [B]) gives [B, P] outputs in one launch, counted under
    ``variants["batched_<instantiation>"]``; its plain version is
    :func:`batched_fused_reference`."""
    if price.shape[-1] == 0:
        raise ValueError("fused_score_min2 requires N >= 1")
    _cost.note(_cost.fused_work, price, si, nrules)
    if price.device.type == "cpu":
        if price.dim() == 2:
            return batched_fused_reference(
                price, si, pbase, noff, nrules=nrules,
                jitter_scale=jitter_scale)
        return fused_score_min2_reference(
            price, si, pbase, noff, nrules=nrules,
            jitter_scale=jitter_scale)
    if price.device.type != "cuda":
        raise RuntimeError(
            f"fused_score_min2: no kernel for device {price.device}")
    return _launch(price, si, pbase, noff, nrules, jitter_scale)


fused_score_min2.launches = 0
fused_score_min2.variants = collections.Counter()


def score_write(si: ScoreInputs, pbase: int, noff: int, *, nrules: int,
                jitter_scale: float) -> torch.Tensor:
    """The matrix engine's unpriced score [P, N] from the packed inputs,
    in its term order (:func:`score_write_reference`), written by the
    kernel ``score_write_kernel`` (``csrc/score_write.cu``) in one pass;
    [B, P, N] in one launch for fields with a leading [B].  Columns are
    local, the jitter hashes ``pbase + row`` and ``noff + column``.

    Each launch adds its cells (B·P·N) to the counter
    ``ops.score_write.cells`` of ``obs.counts_recorder()``, and raises
    ``launches`` and ``variants[<instantiation>]`` (``batched_`` before
    it for a batch) by one; a CPU call runs the plain version and counts
    none of them."""
    _cost.note(_cost.score_write_work, si)
    dev = si.base.device
    if dev.type == "cpu":
        return score_write_reference(si, pbase, noff, nrules=nrules,
                                     jitter_scale=jitter_scale)
    if dev.type != "cuda":
        raise RuntimeError(f"score_write: no kernel for device {dev}")
    lead = si.base.shape[:-1]
    p = si.stick.shape[-1]
    n = si.base.shape[-1]
    si = _checked("score_write", si, lead, dev, nrules)
    out = torch.empty(lead + (p, n), dtype=torch.float32, device=dev)
    batch = int(np.prod(lead, dtype=np.int64))
    if out.numel() == 0:
        return out
    r_width = si.prev_state.shape[-1]
    t_width = si.taken.shape[-1]
    a_width = si.present.shape[-1]
    variant = fused_variant(nrules, r_width, t_width, a_width)
    err = _write_kernel(variant == "generic")(
        si.base.data_ptr(), si.neg_boost.data_ptr(), si.validf.data_ptr(),
        si.cand_g.data_ptr(), si.stick.data_ptr(), si.prev_slot.data_ptr(),
        si.prev_state.data_ptr(), si.taken.data_ptr(),
        si.present.data_ptr(), si.a_inc_g.data_ptr(),
        si.a_exc_g.data_ptr(), si.any_anchor.data_ptr(), out.data_ptr(),
        float(jitter_scale), p, n, int(nrules), r_width, t_width, a_width,
        si.a_inc_g.shape[-1], int(pbase), int(noff),
        _VARIANT_IDS.get(variant, -1), batch,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"score_write kernel launch failed: CUDA error "
                           f"{err}")
    counts_recorder().count("ops.score_write.cells", out.numel())
    score_write.launches += 1
    score_write.variants[f"batched_{variant}" if lead else variant] += 1
    return out


score_write.launches = 0
score_write.variants = collections.Counter()
