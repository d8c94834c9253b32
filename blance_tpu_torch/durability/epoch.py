# Copied from blance_tpu/durability/epoch.py.
"""Epoch fencing: make a recovered control plane safe from its ghosts.

Recovery creates a successor controller for state a predecessor may
still believe it owns — an orchestrator task not yet garbage-collected,
a mover callback resolving after the crash decision, or (across
processes) a stale controller that lost a lease but not its file
descriptors.  The classic defense is a fenced epoch: a monotone counter
per journal directory, bumped by every ``recover()``, stamped on every
journal append and every dispatched move.  A completion or append
carrying an older epoch is REJECTED and counted
(``durability.stale_epoch_rejections``); it is never applied, so the
worst a zombie can do is waste one callback, not corrupt the map.

Two layers enforce it:

- in-process: every :class:`~blance_tpu.durability.journal.Journal` and
  every ``Orchestrator`` capture ``fence.current`` at construction and
  re-check it at each append / batch completion.  The fence object is
  shared per journal directory through a process-level registry
  (:func:`fence_for`), so a bump is visible to the zombie immediately.
- cross-process: the epoch is persisted (``EPOCH`` file, crash-atomic)
  and every recovery writes a ``fence`` journal record freezing the
  valid record count of every pre-existing segment; replay truncates
  anything a fenced writer appended past that point
  (:func:`~blance_tpu.durability.journal.read_journal`).
"""

from __future__ import annotations

import json
import os
from typing import Optional

from ..utils.atomicio import atomic_write_json

__all__ = ["EPOCH_FILE", "EpochFence", "StaleEpochError", "fence_for",
           "reset_fences"]

EPOCH_FILE = "EPOCH"


class StaleEpochError(Exception):
    """A move completion (or append) carried a fenced epoch — the writer
    predates the last recovery and must not mutate state."""

    def __init__(self, what: str, epoch: int, current: int) -> None:
        super().__init__(
            f"{what}: epoch {epoch} is fenced (current epoch {current})")
        self.what = what
        self.epoch = epoch
        self.current = current


class EpochFence:
    """The monotone epoch counter for one journal directory.

    Plain sync state with no awaits (single-task discipline, see
    analysis/race_lint.py SHARED_STATE): ``bump`` happens on the
    recovery path, ``valid`` on append/completion paths — on one event
    loop these interleave atomically.
    """

    def __init__(self, journal_dir: str, epoch: int = 0) -> None:
        self._dir = journal_dir
        self._epoch = epoch

    @property
    def current(self) -> int:
        return self._epoch

    def valid(self, epoch: int) -> bool:
        """True when ``epoch`` is the live epoch (zombies carry older)."""
        return epoch == self._epoch

    def bump(self) -> int:
        """Advance the epoch and persist it (crash-atomic) before any
        successor writes under it — a crash between bump and first
        append must still fence the predecessor on the NEXT recovery."""
        self._epoch += 1
        os.makedirs(self._dir, exist_ok=True)
        atomic_write_json(os.path.join(self._dir, EPOCH_FILE),
                          {"epoch": self._epoch})
        return self._epoch


# Process-level registry: one fence object per journal directory, so a
# zombie controller in the SAME process shares the object a recovery
# bumped (the in-process fencing layer).
_fences: dict[str, EpochFence] = {}


def fence_for(journal_dir: str) -> EpochFence:
    """The shared fence for ``journal_dir`` (created on first use,
    seeded from the persisted ``EPOCH`` file when one exists)."""
    key = os.path.realpath(journal_dir)
    fence = _fences.get(key)
    if fence is None:
        fence = _fences[key] = EpochFence(
            journal_dir, _load_epoch(journal_dir))
    return fence


def _load_epoch(journal_dir: str) -> int:
    path = os.path.join(journal_dir, EPOCH_FILE)
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return 0
    epoch: Optional[object] = data.get("epoch") \
        if isinstance(data, dict) else None
    return epoch if isinstance(epoch, int) else 0


def reset_fences() -> None:
    """Drop the process-level fence registry (test isolation only —
    production code never unfences a directory)."""
    _fences.clear()
