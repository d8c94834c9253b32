"""blance_tpu_torch.ops — the hand-written CUDA kernels of the port and
their plain PyTorch versions."""

from .reduce2 import min2_argmin, min2_argmin_reference, priced_min2_argmin
from .score_fused import (fused_score_min2, fused_score_min2_reference,
                          score_write, score_write_reference)
from .sparse2 import (sparse_min2_cand_reference, sparse_min2_reference,
                      sparse_priced_min2, sparse_priced_min2_cand)

__all__ = ["min2_argmin", "min2_argmin_reference", "priced_min2_argmin",
           "fused_score_min2", "fused_score_min2_reference",
           "score_write", "score_write_reference",
           "sparse_min2_reference", "sparse_priced_min2",
           "sparse_min2_cand_reference", "sparse_priced_min2_cand",
           "KERNEL_WRAPPERS", "reset_launch_counts", "launch_counts",
           "launch_variants"]

# Every kernel wrapper, by name; each carries a ``launches`` count that it
# raises by one per kernel launch (never on the CPU path), and a
# ``variants`` Counter of the same launches by kernel instantiation.
KERNEL_WRAPPERS = {"priced_min2_argmin": priced_min2_argmin,
                   "fused_score_min2": fused_score_min2,
                   "score_write": score_write,
                   "sparse_priced_min2": sparse_priced_min2,
                   "sparse_priced_min2_cand": sparse_priced_min2_cand}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
        fn.variants.clear()


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def launch_variants() -> dict[str, dict[str, int]]:
    """Each wrapper's launches by instantiation since the last reset."""
    return {name: dict(fn.variants) for name, fn in KERNEL_WRAPPERS.items()}
