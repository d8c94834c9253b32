"""Priced row-wise (min, argmin, second-min): the matrix engine's hot op.

Port of blance_tpu/ops/reduce2.py.  Per row of ``eff = score + price``:

    best   = min(eff, axis=1)
    choice = argmin(eff, axis=1)          (first occurrence)
    second = min(eff with the argmin POSITION masked out, axis=1)

``priced_min2_argmin`` launches the hand-written CUDA kernel
(``csrc/min2.cu``) on a CUDA tensor and runs the plain PyTorch version
(``min2_argmin_reference``) on a CPU tensor; on any other device it
raises.  There is no fallback from the kernel to the plain version.
``priced_min2_argmin.launches`` counts kernel launches, and ``variants``
counts them by layout: "block_per_row" (a 256-thread block a row, for
wide rows) or "rows_per_warp" (a group of lanes a row, for narrow rows,
:func:`min2_layout`), each prefixed "batched_" for a batch of problems,
score [B, P, N] with price [B, N] (the launch the fleet tier makes; its
wide form keeps the name "batched").
"""

from __future__ import annotations

import collections
import ctypes

import torch

from . import cost as _cost

__all__ = ["min2_argmin", "min2_argmin_reference", "priced_min2_argmin",
           "batched_min2_reference", "min2_lanes", "min2_vec", "min2_layout",
           "LANES_BY_N", "LANES_BY_N_SCALAR"]

# Lanes per row of the rows-per-warp layout, by the widest N each count
# serves (the first entry whose bound is >= N): for rows that take
# float4 loads (:func:`min2_vec`) and for rows of 4-byte loads, where a
# block a row wins sooner.  Wider rows than a table's last bound take a
# 256-thread block a row (lanes 0).  Measured on the H100 by
# chip_smoke.py's narrow sweep (PERF.md).
LANES_BY_N = ((8, 1), (16, 2), (64, 4), (256, 8), (1024, 16), (2048, 32))
LANES_BY_N_SCALAR = ((8, 1), (16, 2), (128, 4), (256, 8), (777, 32))


def min2_vec(score: torch.Tensor, price: torch.Tensor) -> bool:
    """Whether the rows can take float4 loads: ``n % 4 == 0`` and both
    operands start 16-byte aligned."""
    return score.shape[-1] % 4 == 0 and score.data_ptr() % 16 == 0 and \
        price.data_ptr() % 16 == 0


def min2_lanes(n: int, vec: bool) -> int:
    """Lanes per row for rows of ``n`` columns, from the table of rows
    that take float4 loads (``vec``) or of rows that do not: a power of
    two up to 32 (rows per warp), or 0 for a block per row."""
    for bound, lanes in LANES_BY_N if vec else LANES_BY_N_SCALAR:
        if n <= bound:
            return lanes
    return 0


def min2_layout(score: torch.Tensor, price: torch.Tensor) -> tuple:
    """(lanes, vec) of the launch on these operands: float4 loads decided
    first, the lane count from that decision's table; float4 only in the
    rows-per-warp layout."""
    vec = min2_vec(score, price)
    lanes = min2_lanes(score.shape[-1], vec)
    return lanes, vec and lanes > 0


def min2_argmin_reference(eff: torch.Tensor):
    """Plain PyTorch spelling: the CPU path and the kernel's oracle."""
    p = eff.shape[0]
    best = torch.amin(eff, dim=1)
    choice = torch.argmin(eff, dim=1)
    masked = eff.clone()
    masked[torch.arange(p, device=eff.device), choice] = float("inf")
    second = torch.amin(masked, dim=1)
    return best, choice.to(torch.int32), second


_C_FN = None


def _kernel():
    global _C_FN
    if _C_FN is None:
        from ._build import load

        lib = load("min2")
        fn = lib.blance_priced_min2
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fb = lib.blance_priced_min2_batched
        fb.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fb.restype = ctypes.c_int
        _C_FN = (fn, fb)
    return _C_FN


def _launch(score: torch.Tensor, price: torch.Tensor, lanes=None):
    """Launch the kernel in the layout :func:`min2_layout` picks, or with
    ``lanes`` lanes a row (0: a block a row), as a measurement that
    compares layouts asks; a refused launch raises."""
    batched = score.dim() == 3
    p, n = score.shape[-2:]
    lead = score.shape[:-2]
    if score.dtype != torch.float32 or price.dtype != torch.float32:
        raise TypeError("priced_min2_argmin takes float32 score and price")
    if price.shape != lead + (n,) or price.device != score.device:
        raise ValueError(f"price must be {list(lead) + [n]} on "
                         f"{score.device}")
    score = score.contiguous()
    price = price.contiguous()
    best = torch.empty(lead + (p,), dtype=torch.float32, device=score.device)
    choice = torch.empty(lead + (p,), dtype=torch.int32, device=score.device)
    second = torch.empty(lead + (p,), dtype=torch.float32,
                         device=score.device)
    stream = torch.cuda.current_stream(score.device).cuda_stream
    ptrs = (score.data_ptr(), price.data_ptr(), best.data_ptr(),
            choice.data_ptr(), second.data_ptr())
    if lanes is None:
        lanes, vec = min2_layout(score, price)
    else:
        vec = bool(lanes) and min2_vec(score, price)
    if batched:
        err = _kernel()[1](*ptrs, lead[0] * p, n, p, lanes, vec, stream)
    else:
        err = _kernel()[0](*ptrs, p, n, lanes, vec, stream)
    if err != 0:
        raise RuntimeError(f"min2 kernel launch failed: CUDA error {err} "
                           f"(lanes {lanes}, vec {vec})")
    priced_min2_argmin.launches += 1
    name = "rows_per_warp" if lanes else "block_per_row"
    if batched:
        name = "batched_rows_per_warp" if lanes else "batched"
    priced_min2_argmin.variants[name] += 1
    return best, choice, second


def batched_min2_reference(score: torch.Tensor, price: torch.Tensor):
    """Plain version of the batched launch: ``score`` [B, P, N] priced by
    its element's ``price`` [B, N] row, reduced as one [B*P, N] matrix;
    outputs [B, P]."""
    b, p, n = score.shape
    out = min2_argmin_reference((score + price[:, None, :])
                                .reshape(b * p, n))
    return tuple(t.reshape(b, p) for t in out)


def priced_min2_argmin(score: torch.Tensor, price: torch.Tensor):
    """Fused (best, argmin, second-min) over axis 1 of ``score + price``.

    ``price[N]`` is broadcast-added per element, so the priced matrix
    never exists on the card.  Returns ``(best[P] f32, choice[P] i32,
    second[P] f32)``, bitwise equal to
    ``min2_argmin_reference(score + price[None, :])``.  A batch of
    problems, ``score`` [B, P, N] with ``price`` [B, N], gives [B, P]
    outputs, bitwise ``batched_min2_reference``."""
    p, n = score.shape[-2:]
    if n == 0:
        raise ValueError("min2_argmin requires N >= 1 (got shape %r)"
                         % (tuple(score.shape),))
    _cost.note(_cost.min2_work, score, price)
    if score.device.type == "cpu":
        if score.dim() == 3:
            return batched_min2_reference(score, price)
        return min2_argmin_reference(score + price[None, :])
    if score.device.type != "cuda":
        raise RuntimeError(
            f"priced_min2_argmin: no kernel for device {score.device}")
    return _launch(score, price)


priced_min2_argmin.launches = 0
priced_min2_argmin.variants = collections.Counter()


def min2_argmin(eff: torch.Tensor):
    """Fused (best, argmin, second-min) over axis 1 of ``eff[P, N]``."""
    return priced_min2_argmin(
        eff, torch.zeros(eff.shape[1], dtype=torch.float32,
                         device=eff.device))
