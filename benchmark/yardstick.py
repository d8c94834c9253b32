"""The card's peaks and the kernels' work, frozen for the benchmark.

Copied from ``blance_tpu_torch/ops/cost.py`` (``HBM_BYTES_PER_S``,
``F32_OPS_PER_S``, ``bound``, ``min2_work``), on shapes instead of
tensors, so that a later change to the program's own cost model cannot
move a roofline share the benchmark reports.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12      # float32 outside the tensor cores, same sheet


def bound_s(nbytes: int, ops: int) -> float:
    """The least time the card could take for this work: the larger of
    its bytes over the memory rate and its operations over the float32
    rate, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def min2_work(score_shape: tuple, price_shape: tuple) -> tuple[int, int]:
    """priced_min2_argmin on score [P, N] (or [B, P, N]) and price [N]
    (or [B, N]): the score and price read once, three [P] outputs of 4
    bytes written; a price add and two compares per element."""
    cells = 1
    for d in score_shape:
        cells *= int(d)
    price = 1
    for d in price_shape:
        price *= int(d)
    rows = cells // max(int(score_shape[-1]), 1)
    return cells * 4 + price * 4 + rows * 12, cells * 3
