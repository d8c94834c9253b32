"""blance_tpu_torch.durability: epoch fencing.

Only the fence is ported: ``OrchestratorOptions.epoch_fence`` rejects a
batch completion that outlived a recovery with ``StaleEpochError``.  The
write-ahead journal and crash recovery of blance_tpu/durability are
ROADMAP A.7 and later items.
"""

from __future__ import annotations

from .epoch import EpochFence, StaleEpochError, fence_for, reset_fences

__all__ = ["EpochFence", "StaleEpochError", "fence_for", "reset_fences"]
