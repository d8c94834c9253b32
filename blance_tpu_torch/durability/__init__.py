# Copied from blance_tpu/durability/__init__.py.
"""Crash-tolerant control plane: WAL, snapshots, epoch fencing, recovery.

The control plane (``CycleEngine`` / ``RebalanceController`` /
``FleetController``) is a long-lived process whose entire state —
current maps, pending deltas, breaker state, SLO horizon accounting,
in-flight move cursors — is process memory.  This package makes that
state survive the process:

- :mod:`.journal` — a versioned, CRC-checked, append-only write-ahead
  journal (tenant-tagged records, crash-atomic segment rotation) fed
  from the controllers' existing sync windows, plus periodic snapshots.
- :mod:`.epoch` — fenced epochs: every recovery bumps the journal
  directory's epoch, so a zombie pre-crash writer or stale process is
  rejected as a counted ``durability.stale_epoch_rejections`` event,
  never a state corruption.
- :mod:`.recover` — ``recover(journal_dir)``: rebuild controller/fleet
  state from snapshot + journal replay and resume mid-rebalance from
  the journaled achieved map through the existing recovery machinery.

The journal bytes are the reference's, record for record.
"""

from __future__ import annotations

from .epoch import EpochFence, StaleEpochError, fence_for, reset_fences
from .journal import (
    JOURNAL_FORMAT_VERSION,
    Journal,
    JournalFeed,
    Record,
    ReadStats,
    TenantView,
    encode_record,
    map_digest,
    read_journal,
    read_segment,
)
from .recover import RecoveredState, RecoveredTenant, recover, resume_controller

__all__ = [
    "EpochFence",
    "StaleEpochError",
    "fence_for",
    "reset_fences",
    "JOURNAL_FORMAT_VERSION",
    "Journal",
    "JournalFeed",
    "Record",
    "ReadStats",
    "TenantView",
    "encode_record",
    "map_digest",
    "read_journal",
    "read_segment",
    "RecoveredState",
    "RecoveredTenant",
    "recover",
    "resume_controller",
]
