"""Priced row-wise (min, argmin, second-min): the matrix engine's hot op.

Port of blance_tpu/ops/reduce2.py.  Per row of ``eff = score + price``:

    best   = min(eff, axis=1)
    choice = argmin(eff, axis=1)          (first occurrence)
    second = min(eff with the argmin POSITION masked out, axis=1)

``priced_min2_argmin`` launches the hand-written CUDA kernel
(``csrc/min2.cu``) on a CUDA tensor and runs the plain PyTorch version
(``min2_argmin_reference``) on a CPU tensor; on any other device it
raises.  There is no fallback from the kernel to the plain version.
``priced_min2_argmin.launches`` counts kernel launches (``variants`` by
instantiation: "block_per_row", and "batched" for a batch of problems,
score [B, P, N] with price [B, N], the launch the fleet tier makes).
"""

from __future__ import annotations

import collections
import ctypes

import torch

__all__ = ["min2_argmin", "min2_argmin_reference", "priced_min2_argmin",
           "batched_min2_reference"]


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
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fb = lib.blance_priced_min2_batched
        fb.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + [
            ctypes.c_void_p]
        fb.restype = ctypes.c_int
        _C_FN = (fn, fb)
    return _C_FN


def _launch(score: torch.Tensor, price: torch.Tensor):
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
    if batched:
        err = _kernel()[1](*ptrs, lead[0] * p, n, p, stream)
    else:
        err = _kernel()[0](*ptrs, p, n, stream)
    if err != 0:
        raise RuntimeError(f"min2 kernel launch failed: CUDA error {err}")
    priced_min2_argmin.launches += 1
    priced_min2_argmin.variants["batched" if batched
                                else "block_per_row"] += 1
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
