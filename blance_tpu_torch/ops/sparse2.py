"""Priced (min, argmin, second-min, raw) over the sparse engine's
gathered [P, K] candidate block.

Port of blance_tpu/ops/sparse2.py.  Per row of ``eff = score + price``
(``price`` is a per-candidate [P, K] matrix: the caller gathers the [N]
price row at each row's candidate ids):

    best   = min(eff, axis=1)
    kidx   = argmin(eff, axis=1)             (first occurrence)
    second = min(eff with the argmin POSITION masked out, axis=1)
    raw    = score[row, kidx]                (UNPRICED score at the pick)

``sparse_priced_min2`` launches the hand-written CUDA kernel
(``csrc/sparse_min2.cu``) on a CUDA tensor and runs the plain PyTorch
version (``sparse_min2_reference``) on a CPU tensor; on any other device
it raises.  There is no fallback from the kernel to the plain version.
``sparse_priced_min2.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["sparse_min2_reference", "sparse_priced_min2"]


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


_C_FN = None


def _kernel():
    global _C_FN
    if _C_FN is None:
        from ._build import load

        fn = load("sparse_min2").blance_sparse_min2
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _C_FN = fn
    return _C_FN


def _launch(score: torch.Tensor, price: torch.Tensor):
    p, k = score.shape
    if score.dtype != torch.float32 or price.dtype != torch.float32:
        raise TypeError("sparse_priced_min2 takes float32 score and price")
    if price.device != score.device:
        raise ValueError(f"price must be on {score.device}")
    score = score.contiguous()
    price = price.contiguous()
    dev = score.device
    best = torch.empty(p, dtype=torch.float32, device=dev)
    kidx = torch.empty(p, dtype=torch.int32, device=dev)
    second = torch.empty(p, dtype=torch.float32, device=dev)
    raw = torch.empty(p, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(score.data_ptr(), price.data_ptr(), best.data_ptr(),
                    kidx.data_ptr(), second.data_ptr(), raw.data_ptr(),
                    p, k, stream)
    if err != 0:
        raise RuntimeError(
            f"sparse_min2 kernel launch failed: CUDA error {err}")
    sparse_priced_min2.launches += 1
    return best, kidx, second, raw


def sparse_priced_min2(score: torch.Tensor, price: torch.Tensor):
    """Fused (best, argmin, second, raw) over ``score + price``, both
    [P, K].  Bitwise equal to :func:`sparse_min2_reference`."""
    p, k = score.shape
    if k == 0:
        # A zero-size row reduction has no defined argmin.
        raise ValueError("sparse_priced_min2 requires K >= 1 (got shape "
                         "%r)" % ((p, k),))
    if price.shape != score.shape:
        raise ValueError(f"price shape {tuple(price.shape)} != score shape "
                         f"{tuple(score.shape)}")
    if score.device.type == "cpu":
        return sparse_min2_reference(score, price)
    if score.device.type != "cuda":
        raise RuntimeError(
            f"sparse_priced_min2: no kernel for device {score.device}")
    return _launch(score, price)


sparse_priced_min2.launches = 0
