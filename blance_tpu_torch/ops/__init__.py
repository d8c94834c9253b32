"""blance_tpu_torch.ops — the hand-written CUDA kernels of the port and
their plain PyTorch versions."""

from .reduce2 import min2_argmin, min2_argmin_reference, priced_min2_argmin
from .score_fused import fused_score_min2, fused_score_min2_reference
from .sparse2 import sparse_min2_reference, sparse_priced_min2

__all__ = ["min2_argmin", "min2_argmin_reference", "priced_min2_argmin",
           "fused_score_min2", "fused_score_min2_reference",
           "sparse_min2_reference", "sparse_priced_min2",
           "KERNEL_WRAPPERS", "reset_launch_counts", "launch_counts"]

# Every kernel wrapper, by kernel name; each carries a ``launches`` count
# that it raises by one per kernel launch (never on the CPU path).
KERNEL_WRAPPERS = {"priced_min2_argmin": priced_min2_argmin,
                   "fused_score_min2": fused_score_min2,
                   "sparse_priced_min2": sparse_priced_min2}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}
