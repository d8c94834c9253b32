"""Carry state between the JAX package's numpy arrays and the port's
tensors, dtypes kept: int32 ids, float32 weights, bool masks.

The tests feed both packages the same arrays through these functions.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .ops.score_fused import ScoreInputs

__all__ = ["problem_to_torch", "assign_to_numpy", "resolve_device",
           "score_inputs_to_torch", "carry_to_torch", "carry_to_numpy"]

_DTYPES = {np.dtype(np.int32): torch.int32,
           np.dtype(np.float32): torch.float32,
           np.dtype(bool): torch.bool}


def resolve_device(device: Any, who: str) -> torch.device:
    """``device`` as a torch.device; an entry point asked for the card
    on a machine without one raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: device {str(device)!r} requested but "
            "torch.cuda.is_available() is False (pass device='cpu' to run "
            "the plain PyTorch path on the CPU)")
    return dev


def _to_torch(a: Any, want: torch.dtype, device) -> torch.Tensor:
    arr = np.asarray(a)
    got = _DTYPES.get(arr.dtype)
    if got != want:
        raise TypeError(f"expected {want} data, got numpy {arr.dtype}")
    return torch.from_numpy(np.array(arr, order="C")).to(device)


def problem_to_torch(prev, pweights, nweights, valid, stickiness, gids,
                     gid_valid, *, device) -> tuple[torch.Tensor, ...]:
    """The solver's seven array inputs, in the solver's positional order
    (prev, pweights, nweights, valid, stickiness, gids, gid_valid), as
    tensors on ``device``."""
    kinds = (torch.int32, torch.float32, torch.float32, torch.bool,
             torch.float32, torch.int32, torch.bool)
    arrays = (prev, pweights, nweights, valid, stickiness, gids, gid_valid)
    return tuple(_to_torch(a, k, device) for a, k in zip(arrays, kinds))


def assign_to_numpy(assign: torch.Tensor) -> np.ndarray:
    """An assignment tensor [P, S, R] as an int32 numpy array."""
    return assign.detach().to("cpu").numpy().astype(np.int32, copy=False)


def score_inputs_to_torch(si: Any, *, device) -> ScoreInputs:
    """A JAX ``ScoreInputs`` whose fields are numpy (or numpy-convertible)
    arrays, as the port's ScoreInputs on ``device``."""
    out = {}
    for name in ScoreInputs._fields:
        arr = np.asarray(getattr(si, name))
        out[name] = _to_torch(arr, _DTYPES[arr.dtype], device)
    return ScoreInputs(**out)


def _carry_field(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def carry_to_numpy(carry: Any):
    """A solve carry (either package's: anything with ``prices``,
    ``assign`` and ``used``) as the port's SolveCarry of numpy arrays,
    dtypes kept (float32 prices and used, int32 assign)."""
    from .plan.tensor import SolveCarry

    return SolveCarry(prices=_carry_field(carry.prices),
                      assign=_carry_field(carry.assign),
                      used=_carry_field(carry.used))


def carry_to_torch(carry: Any, device) -> Any:
    """A solve carry (either package's) as the port's SolveCarry of
    tensors on ``device``, ready to seed solve_dense_warm or
    solve_sparse_warm."""
    from .plan.tensor import SolveCarry

    c = carry_to_numpy(carry)
    return SolveCarry(prices=_to_torch(c.prices, torch.float32, device),
                      assign=_to_torch(c.assign, torch.int32, device),
                      used=_to_torch(c.used, torch.float32, device))
