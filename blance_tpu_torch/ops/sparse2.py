"""Priced (min, argmin, second-min, raw) over the sparse engine's
[P, K] candidate block.

Port of blance_tpu/ops/sparse2.py.  Per row of ``eff = score + price``
(``price`` is a per-candidate [P, K] matrix):

    best   = min(eff, axis=1)
    kidx   = argmin(eff, axis=1)             (first occurrence)
    second = min(eff with the argmin POSITION masked out, axis=1)
    raw    = score[row, kidx]                (UNPRICED score at the pick)

Two entry points share one CUDA kernel (``csrc/sparse_min2.cu``):

- ``sparse_priced_min2(score, price)``, the TPU kernel's counterpart,
  with the [P, K] price given;
- ``sparse_priced_min2_cand(score, cand, price_n)``, what the sparse
  engine calls: the price of column k is ``price_n[clamp(cand[r, k], 0,
  N - 1)]``, gathered inside the kernel, and a fifth output ``choice =
  max(cand[r, kidx], 0)`` is the picked node id.

Each launches the kernel on a CUDA tensor and runs its plain PyTorch
version on a CPU tensor; on any other device it raises.  There is no
fallback from the kernel to the plain version.  Each wrapper's
``launches`` counts its kernel launches, and ``variants`` counts them by
instantiation ("vec4": 16-byte loads, "scalar": 4-byte loads).

Every call, on either device, also counts its work on the solver's
recorder (``obs.counts_recorder``), the facts ``cost.sparse_work`` and
``cost.sparse_cand_work`` price: ``ops.sparse_min2.cells`` (P·K),
``ops.sparse_min2.price_cells`` (N for the gathered entry, 0 for the
[P, K]-price one) and ``ops.sparse_min2.out_cells`` (5·P or 4·P).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from ..obs import counts_recorder
from . import cost as _cost

__all__ = ["sparse_min2_reference", "sparse_min2_cand_reference",
           "sparse_priced_min2", "sparse_priced_min2_cand", "load_variant"]


def sparse_min2_reference(score: torch.Tensor, price: torch.Tensor):
    """Plain PyTorch spelling: the CPU path and the kernel's oracle.
    Returns ``(best[P] f32, kidx[P] i32, second[P] f32, raw[P] f32)``."""
    p = score.shape[0]
    eff = score + price
    best = torch.amin(eff, dim=1)
    kidx = torch.argmin(eff, dim=1)
    masked = eff.clone()
    masked[torch.arange(p, device=eff.device), kidx] = float("inf")
    second = torch.amin(masked, dim=1)
    raw = score.gather(1, kidx[:, None])[:, 0]
    return best, kidx.to(torch.int32), second, raw


def sparse_min2_cand_reference(score: torch.Tensor, cand: torch.Tensor,
                               price_n: torch.Tensor):
    """Plain PyTorch spelling of the gathered entry point: the exact
    composition the sparse engine ran around the TPU kernel.  Returns
    ``(best, kidx, second, raw, choice[P] i32)``."""
    n = price_n.shape[0]
    best, kidx, second, raw = sparse_min2_reference(
        score, price_n[cand.clamp(0, n - 1).long()])
    choice = cand.gather(1, kidx.long()[:, None])[:, 0].clamp(min=0)
    return best, kidx, second, raw, choice


def _count_work(cells: int, price_cells: int, out_cells: int) -> None:
    rec = counts_recorder()
    rec.count("ops.sparse_min2.cells", cells)
    rec.count("ops.sparse_min2.price_cells", price_cells)
    rec.count("ops.sparse_min2.out_cells", out_cells)


def load_variant(k: int, *operands: torch.Tensor) -> str:
    """The kernel instantiation for a [P, k] row: "vec4" (16-byte loads)
    when k % 4 == 0 and every [P, k] operand starts 16-byte aligned,
    else "scalar"."""
    if k % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in operands):
        return "vec4"
    return "scalar"


_C_FNS: dict = {}


def _kernel(name: str):
    if name not in _C_FNS:
        from ._build import load

        fn = getattr(load("sparse_min2"), name)
        if name == "blance_sparse_min2":
            fn.argtypes = [ctypes.c_void_p] * 6 + [
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_void_p]
        else:
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + \
                [ctypes.c_void_p] * 5 + [ctypes.c_longlong,
                                         ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _C_FNS[name] = fn
    return _C_FNS[name]


def _outputs(p: int, dev: torch.device, n_out: int):
    dts = (torch.float32, torch.int32, torch.float32, torch.float32,
           torch.int32)
    return tuple(torch.empty(p, dtype=dt, device=dev) for dt in dts[:n_out])


def _check_rows(what: str, score: torch.Tensor, other: torch.Tensor,
                other_name: str) -> None:
    p, k = score.shape
    if k == 0:
        # A zero-size row reduction has no defined argmin.
        raise ValueError(f"{what} requires K >= 1 (got shape {(p, k)!r})")
    if other.shape != score.shape:
        raise ValueError(f"{other_name} shape {tuple(other.shape)} != score "
                         f"shape {tuple(score.shape)}")


def _device_kind(what: str, score: torch.Tensor, *others) -> str:
    kind = score.device.type
    if kind not in ("cpu", "cuda"):
        raise RuntimeError(f"{what}: no kernel for device {score.device}")
    for t in others:
        if t.device != score.device:
            raise ValueError(f"{what}: every input must be on {score.device}")
    return kind


def sparse_priced_min2(score: torch.Tensor, price: torch.Tensor):
    """Fused (best, argmin, second, raw) over ``score + price``, both
    [P, K].  Bitwise equal to :func:`sparse_min2_reference`."""
    _check_rows("sparse_priced_min2", score, price, "price")
    _cost.note(_cost.sparse_work, score, price)
    _count_work(score.numel(), 0, 4 * score.shape[0])
    if _device_kind("sparse_priced_min2", score, price) == "cpu":
        return sparse_min2_reference(score, price)
    if score.dtype != torch.float32 or price.dtype != torch.float32:
        raise TypeError("sparse_priced_min2 takes float32 score and price")
    score = score.contiguous()
    price = price.contiguous()
    p, k = score.shape
    outs = _outputs(p, score.device, 4)
    variant = load_variant(k, score, price)
    stream = torch.cuda.current_stream(score.device).cuda_stream
    err = _kernel("blance_sparse_min2")(
        score.data_ptr(), price.data_ptr(), *(o.data_ptr() for o in outs),
        p, k, int(variant == "vec4"), stream)
    if err != 0:
        raise RuntimeError(
            f"sparse_min2 kernel launch failed: CUDA error {err}")
    sparse_priced_min2.launches += 1
    sparse_priced_min2.variants[variant] += 1
    return outs


def sparse_priced_min2_cand(score: torch.Tensor, cand: torch.Tensor,
                            price_n: torch.Tensor):
    """(best, kidx, second, raw, choice) over ``score[P, K] +
    price_n[clamp(cand, 0, N - 1)]`` with ``cand[P, K]`` int32 node ids
    (-1 pads) and ``price_n[N]``; ``choice = max(cand[r, kidx], 0)``.
    Bitwise equal to :func:`sparse_min2_cand_reference`."""
    what = "sparse_priced_min2_cand"
    _check_rows(what, score, cand, "cand")
    if cand.dtype != torch.int32:
        raise TypeError(f"{what} takes int32 cand, got {cand.dtype}")
    if price_n.dim() != 1 or price_n.shape[0] == 0:
        raise ValueError(f"{what} takes a non-empty 1-D price_n, got shape "
                         f"{tuple(price_n.shape)}")
    _cost.note(_cost.sparse_cand_work, score, cand, price_n)
    _count_work(score.numel(), price_n.shape[0], 5 * score.shape[0])
    if _device_kind(what, score, cand, price_n) == "cpu":
        return sparse_min2_cand_reference(score, cand, price_n)
    if score.dtype != torch.float32 or price_n.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 score and price_n")
    score = score.contiguous()
    cand = cand.contiguous()
    price_n = price_n.contiguous()
    p, k = score.shape
    outs = _outputs(p, score.device, 5)
    variant = load_variant(k, score, cand)
    stream = torch.cuda.current_stream(score.device).cuda_stream
    err = _kernel("blance_sparse_min2_cand")(
        score.data_ptr(), cand.data_ptr(), price_n.data_ptr(),
        price_n.shape[0], *(o.data_ptr() for o in outs), p, k,
        int(variant == "vec4"), stream)
    if err != 0:
        raise RuntimeError(
            f"sparse_min2 kernel launch failed: CUDA error {err}")
    sparse_priced_min2_cand.launches += 1
    sparse_priced_min2_cand.variants[variant] += 1
    return outs


for _fn in (sparse_priced_min2, sparse_priced_min2_cand):
    _fn.launches = 0
    _fn.variants = collections.Counter()
