"""The work each kernel does per call, and the card's rates it is bounded by.

One formula per kernel, shared by the measurement script
(``chip_smoke.py``: each kernel's ``bound_ms``) and the device
observatory (``obs/device.py``: the ``device.flops`` and
``device.hbm_bytes`` gauges of a dispatch).  ``*_work`` returns
``(bytes, operations)`` for one call on these operands: the bytes the
function must move (each input read once, each output written once) and
the float32 operations it does on them.  The count depends only on the
operands' shapes and dtypes, so a call's plain PyTorch version (on the
CPU) counts the same work as its kernel launch.

A tally (:func:`tally`) sums the work of every kernel call made in its
body on the calling thread; outside one, :func:`note` returns after one
context-variable read.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Iterator, Optional

import torch

__all__ = ["HBM_BYTES_PER_S", "F32_OPS_PER_S", "LANE_INSTR_PER_S", "bound",
           "fused_ops_per_cell", "min2_work", "fused_work",
           "score_write_work", "sparse_work", "sparse_cand_work", "tally",
           "note"]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12      # float32 outside the tensor cores, same sheet
# Lane-instructions the card issues per second: 132 SMs x 4 schedulers x
# 32 lanes at the 1.98 GHz boost clock (same sheet).
LANE_INSTR_PER_S = 132 * 4 * 32 * 1.98e9


def bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take for this work: the larger of
    its bytes over the memory rate and its operations over the float32
    rate, in ms, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def fused_ops_per_cell(r: int, t: int, a: int, nrules: int) -> int:
    """Operations the in-kernel score does per (row, column): column id
    1, boost 3, same-ordinal 2, sticky 2R, rules nrules*(5A + 2) + 2,
    taken/valid 2T + 2, jitter 6, priced min2 3."""
    return 21 + 2 * r + 2 * t + nrules * (5 * a + 2)


def min2_work(score: torch.Tensor, price: torch.Tensor) -> tuple[int, int]:
    """priced_min2_argmin on score [P, N] (or [B, P, N]) and price [N]
    (or [B, N]): the score and price read, three [P] outputs written; a
    price add and two compares per element."""
    cells = score.numel()
    rows = cells // max(score.shape[-1], 1)
    return cells * 4 + price.numel() * 4 + rows * 12, cells * 3


def fused_work(price: torch.Tensor, si, nrules: int) -> tuple[int, int]:
    """fused_score_min2 on price [N] (or [B, N]) and the packed
    ScoreInputs: every input read, four [P] outputs written;
    :func:`fused_ops_per_cell` per (row, column)."""
    rows = si.stick.numel()
    cells = rows * price.shape[-1]
    in_bytes = sum(x.numel() * x.element_size() for x in si) + \
        price.numel() * 4
    ops = cells * fused_ops_per_cell(si.prev_state.shape[-1],
                                     si.taken.shape[-1],
                                     si.present.shape[-1], nrules)
    return in_bytes + rows * 16, ops


def score_write_work(si) -> tuple[int, int]:
    """score_write on the packed ScoreInputs: the [P, N] (or [B, P, N])
    score written, 4 bytes a cell, its inputs' bytes beside it; the
    score's operations a cell, :func:`fused_ops_per_cell` without the
    priced min2's 3."""
    cells = si.stick.numel() * si.base.shape[-1]
    in_bytes = sum(x.numel() * x.element_size() for x in si)
    ops = cells * (fused_ops_per_cell(si.prev_state.shape[-1],
                                      si.taken.shape[-1],
                                      si.present.shape[-1],
                                      si.cand_g.shape[-2] // 2) - 3)
    return in_bytes + cells * 4, ops


def sparse_work(score: torch.Tensor, price: torch.Tensor) -> tuple[int, int]:
    """sparse_priced_min2 on score and price, both [P, K]: both read,
    four [P] outputs written; a price add and two compares per
    element."""
    p, k = score.shape
    return p * k * 8 + p * 16, p * k * 3


def sparse_cand_work(score: torch.Tensor, cand: torch.Tensor,
                     price_n: torch.Tensor) -> tuple[int, int]:
    """sparse_priced_min2_cand: score and cand [P, K] read, the [N] price
    row once, five [P] outputs written; a price add and two compares
    per element."""
    p, k = score.shape
    return p * k * 8 + price_n.shape[0] * 4 + p * 20, p * k * 3


# [bytes, operations] of the open tally on this thread, or None.
_TALLY: contextvars.ContextVar[Optional[list]] = \
    contextvars.ContextVar("blance_kernel_tally", default=None)


@contextlib.contextmanager
def tally() -> Iterator[list]:
    """Sum the work of every kernel call in the body: yields a
    ``[bytes, operations]`` list that fills as the calls are made.  A
    nested tally adds to its own list only."""
    acc = [0, 0]
    token = _TALLY.set(acc)
    try:
        yield acc
    finally:
        _TALLY.reset(token)


def note(work: Callable[..., tuple[int, int]], *args) -> None:
    """Add ``work(*args)`` to the open tally; nothing without one."""
    acc = _TALLY.get()
    if acc is not None:
        nbytes, ops = work(*args)
        acc[0] += nbytes
        acc[1] += ops
