# Copied from blance_tpu/durability/journal.py.
"""The write-ahead journal: versioned, CRC-checked, append-only.

Framing: one record per line, ``<crc32 hex, 8 chars> <canonical JSON>``.
The JSON is canonical (sorted keys, no whitespace) so a record's bytes
are a pure function of its content — the replay-determinism tests
compare journals byte-for-byte.  The CRC covers the JSON payload; a
torn final write (power loss mid-append) or a corrupted record fails
the CRC/parse and truncates replay to the last valid prefix, counted as
``durability.torn_tail`` — never a crash loop.

Every record carries::

    {"v": 1, "seq": N, "epoch": E, "tenant": key-or-null,
     "kind": ..., "t": virtual-seconds, "data": {...}}

Record kinds (schema detail in docs/DURABILITY.md):

- ``genesis``  — initial map + membership when a journal attaches to a
  controller; makes recovery self-contained before the first snapshot.
- ``delta``    — one ``ClusterDelta`` at intake (``_on_submit``).
- ``cycle``    — cycle begin: deltas taken from the pending queue.
- ``plan``     — a non-trivial plan landed (pass number, move count).
- ``batch``    — one executed batch outcome: the achieved-map delta
  (the journal is a ``MoveObserver``).
- ``strip``    — placements dropped for fresh-failed/quarantined nodes.
- ``quiesce``  — the controller went idle; carries a map digest.
- ``snapshot`` — pointer to a snapshot file (written AFTER the file is
  durable, so a pointer never references a torn snapshot).
- ``fence``    — written by every recovery: freezes each pre-existing
  segment's valid record count so a fenced writer's later appends are
  truncated on replay (see durability/epoch.py).

Segments are ``wal-<epoch>-<index>.log``; the index is globally
monotone, so replay order is the segment order.  Rotation is
crash-atomic: the new segment file is born via the shared fsync'd
temp+rename recipe (utils/atomicio.py), so a crash mid-rotation leaves
either the old tail or a complete empty successor — never a
half-created name.  Appends fsync by default (``BLANCE_WAL_FSYNC=0``
gates it off for CI).

Concurrency discipline (analysis/race_lint.py SHARED_STATE): all
journal methods are plain sync code with no awaits, called from the
controller's cycle task and the movers' observer window — on one event
loop each append is atomic, so seq numbers and segment state cannot
tear.
"""

from __future__ import annotations

import json
import os
import re
import zlib
from dataclasses import dataclass, field as dataclasses_field
from typing import Any, Callable, Mapping, Optional, Sequence

from ..obs import get_recorder
from ..utils.atomicio import atomic_write_json, atomic_write_text, \
    fsync_enabled
from .epoch import EpochFence, fence_for

__all__ = ["JOURNAL_FORMAT_VERSION", "Journal", "JournalFeed", "Record",
           "ReadStats", "TenantView", "encode_record", "list_segments",
           "map_digest", "read_journal", "read_segment"]

JOURNAL_FORMAT_VERSION = 1

_SEGMENT_RE = re.compile(r"^wal-(\d{6})-(\d{6})\.log$")
_TENANT_SAFE_RE = re.compile(r"[^A-Za-z0-9_.-]")


@dataclass(frozen=True)
class Record:
    """One decoded journal record."""

    seq: int
    epoch: int
    kind: str
    t: float
    tenant: Optional[str]
    data: dict[str, Any]


def _canon(obj: Any) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def encode_record(seq: int, epoch: int, kind: str, t: float,
                  tenant: Optional[str], data: Mapping[str, Any]) -> str:
    """One framed journal line (CRC + canonical JSON + newline)."""
    payload = _canon({"v": JOURNAL_FORMAT_VERSION, "seq": seq,
                      "epoch": epoch, "kind": kind, "t": t,
                      "tenant": tenant, "data": dict(data)})
    crc = zlib.crc32(payload.encode("utf-8")) & 0xFFFFFFFF
    return f"{crc:08x} {payload}\n"


def map_digest(pmap: Mapping[str, Any]) -> str:
    """Order-insensitive-at-the-top-level digest of a partition map
    (CRC32 of its canonical JSON) — the quiesce record's cheap
    divergence probe; full maps live in genesis/snapshot records."""
    canon = _canon({name: p.to_json() for name, p in sorted(pmap.items())})
    return f"{zlib.crc32(canon.encode('utf-8')) & 0xFFFFFFFF:08x}"


def _parse_line(line: bytes) -> Optional[Record]:
    """Decode one framed line; None on ANY defect (framing, CRC, JSON,
    schema) — the caller treats the defect as the torn tail."""
    if len(line) < 10 or line[8:9] != b" ":
        return None
    crc_hex, payload = line[:8], line[9:]
    try:
        want = int(crc_hex, 16)
    except ValueError:
        return None
    if (zlib.crc32(payload) & 0xFFFFFFFF) != want:
        return None
    try:
        obj = json.loads(payload)
    except ValueError:
        return None
    if not isinstance(obj, dict) or obj.get("v") != JOURNAL_FORMAT_VERSION:
        return None
    try:
        seq, epoch, kind, t = obj["seq"], obj["epoch"], obj["kind"], obj["t"]
        tenant, data = obj["tenant"], obj["data"]
    except KeyError:
        return None
    if not (isinstance(seq, int) and isinstance(epoch, int)
            and isinstance(kind, str)
            and isinstance(t, (int, float)) and not isinstance(t, bool)
            and (tenant is None or isinstance(tenant, str))
            and isinstance(data, dict)):
        return None
    return Record(seq=seq, epoch=epoch, kind=kind, t=float(t),
                  tenant=tenant, data=data)


def read_segment(path: str) -> "tuple[list[Record], bool]":
    """Decode one segment: (valid record prefix, torn?).  Torn means a
    partial/corrupt record (or a record past one) was dropped."""
    with open(path, "rb") as f:
        raw = f.read()
    chunks = raw.split(b"\n")
    complete, tail = chunks[:-1], chunks[-1]
    records: list[Record] = []
    torn = False
    for chunk in complete:
        rec = _parse_line(chunk)
        if rec is None:
            torn = True
            break
        records.append(rec)
    else:
        # A final chunk with no newline is a torn append even if its
        # bytes happen to parse: the framing contract is line-complete.
        if tail != b"":
            torn = True
    return records, torn


def list_segments(journal_dir: str) -> "list[tuple[int, int, str]]":
    """(index, epoch, basename) for every segment, in replay order
    (the index is globally monotone across epochs)."""
    out: list[tuple[int, int, str]] = []
    try:
        names = os.listdir(journal_dir)
    except FileNotFoundError:
        return out
    for name in names:
        m = _SEGMENT_RE.match(name)
        if m is not None:
            out.append((int(m.group(2)), int(m.group(1)), name))
    out.sort()
    return out


@dataclass
class ReadStats:
    """What :func:`read_journal` dropped on the floor (and counted),
    plus each segment's valid record count AFTER truncation — the
    numbers a recovery freezes into its ``fence`` record."""

    segments: int = 0
    torn_segments: int = 0
    stale_dropped: int = 0
    per_segment: dict[str, int] = dataclasses_field(default_factory=dict)


def read_journal(journal_dir: str) -> "tuple[list[Record], ReadStats]":
    """Replay-ready record stream for a journal directory.

    Two passes: decode every segment (truncating each torn tail,
    counted ``durability.torn_tail``), then apply the LAST ``fence``
    record — it froze the valid record count of every segment that
    existed at that recovery, so anything a fenced (zombie) writer
    appended past those counts is dropped and counted as
    ``durability.stale_epoch_rejections``.
    """
    rec_sink = get_recorder()
    stats = ReadStats()
    per: list[tuple[str, list[Record]]] = []
    for _index, _epoch, name in list_segments(journal_dir):
        stats.segments += 1
        records, torn = read_segment(os.path.join(journal_dir, name))
        if torn:
            stats.torn_segments += 1
            rec_sink.count("durability.torn_tail")
        per.append((name, records))
    last_fence: Optional[Record] = None
    for _name, records in per:
        for record in records:
            if record.kind == "fence":
                last_fence = record
    if last_fence is not None:
        counts = last_fence.data.get("segments", {})
        if isinstance(counts, dict):
            for i, (name, records) in enumerate(per):
                keep = counts.get(name)
                if isinstance(keep, int) and len(records) > keep:
                    dropped = len(records) - keep
                    stats.stale_dropped += dropped
                    rec_sink.count("durability.stale_epoch_rejections",
                                   dropped)
                    per[i] = (name, records[:keep])
    for name, records in per:
        stats.per_segment[name] = len(records)
    return [r for _name, records in per for r in records], stats


class JournalFeed:
    """The record vocabulary, shared by :class:`Journal` (untagged /
    single-tenant) and :class:`TenantView` (fleet fan-out) — both only
    need to provide :meth:`append`, :meth:`write_snapshot` and
    :attr:`fence`.  This is the duck type ``RebalanceController``'s
    ``journal=`` parameter accepts."""

    def append(self, kind: str, data: Mapping[str, Any], *,
               t: Optional[float] = None) -> bool:
        raise NotImplementedError

    def write_snapshot(self, payload: Mapping[str, Any], *,
                       t: Optional[float] = None) -> str:
        raise NotImplementedError

    def should_snapshot(self) -> bool:
        raise NotImplementedError

    @property
    def fence(self) -> EpochFence:
        raise NotImplementedError

    # -- controller sync-window records --------------------------------------

    def record_genesis(self, pmap: Mapping[str, Any], nodes: Sequence[str],
                       removing: Sequence[str], failed: Sequence[str],
                       pweights: Mapping[str, int],
                       nweights: Mapping[str, int], *,
                       t: Optional[float] = None) -> None:
        self.append("genesis", {
            "map": {name: p.to_json() for name, p in sorted(pmap.items())},
            "nodes": list(nodes),
            "removing": sorted(removing),
            "failed": sorted(failed),
            "pweights": dict(sorted(pweights.items())),
            "nweights": dict(sorted(nweights.items())),
        }, t=t)

    def record_delta(self, delta: Any, *, t: Optional[float] = None) -> None:
        """One ClusterDelta at intake (duck-typed: add/remove/fail +
        weight mappings)."""
        self.append("delta", {
            "add": list(delta.add),
            "remove": list(delta.remove),
            "fail": list(delta.fail),
            "pweights": (dict(sorted(delta.partition_weights.items()))
                         if delta.partition_weights is not None else None),
            "nweights": (dict(sorted(delta.node_weights.items()))
                         if delta.node_weights is not None else None),
        }, t=t)

    def record_cycle(self, n: int, deltas: int, *,
                     t: Optional[float] = None) -> None:
        self.append("cycle", {"n": n, "deltas": deltas}, t=t)

    def record_plan(self, pass_no: int, moves: int, *,
                    t: Optional[float] = None) -> None:
        self.append("plan", {"pass": pass_no, "moves": moves}, t=t)

    def record_strip(self, nodes: Sequence[str], *,
                     t: Optional[float] = None) -> None:
        self.append("strip", {"nodes": sorted(nodes)}, t=t)

    def record_quiesce(self, digest: str, *,
                       t: Optional[float] = None) -> None:
        self.append("quiesce", {"digest": digest}, t=t)

    def record_quiesce_map(self, pmap: Mapping[str, Any], *,
                           t: Optional[float] = None) -> None:
        """Quiesce record with the digest computed here, so callers
        (the controller) need no journal-format imports."""
        self.record_quiesce(map_digest(pmap), t=t)

    # -- the orchestrator observer hook (obs.slo.MoveObserver) ---------------

    def on_batch(self, node: str, moves: Sequence[Any], ok: bool,
                 now: float) -> None:
        """One executed-batch outcome: the achieved-map delta.  Only ok
        batches mutate the map on replay, but failures are journaled
        too — they are part of the deterministic event log."""
        self.append("batch", {
            "node": node,
            "ok": ok,
            "moves": [[m.partition, m.node, m.state, m.op] for m in moves],
        }, t=now)


class Journal(JournalFeed):
    """Append-only writer for one journal directory.

    ``clock`` stamps each record's ``t`` (pass the controller's
    ``recorder.now`` so journal time follows virtual time in tests);
    ``rotate_records`` bounds segment length; ``snapshot_every`` is the
    snapshot cadence in records (0 disables ``should_snapshot``).
    The journal captures the directory's epoch at construction: once a
    recovery bumps the fence, every further append on this handle is
    dropped and counted (``durability.stale_epoch_rejections``) — the
    in-process zombie defense.
    """

    def __init__(self, journal_dir: str, *,
                 tenant: Optional[str] = None,
                 fence: Optional[EpochFence] = None,
                 clock: Optional[Callable[[], float]] = None,
                 rotate_records: int = 1024,
                 snapshot_every: int = 0,
                 start_seq: int = 1) -> None:
        os.makedirs(journal_dir, exist_ok=True)
        self._dir = journal_dir
        self._tenant = tenant
        self._fence = fence if fence is not None else fence_for(journal_dir)
        self._epoch = self._fence.current
        self._clock: Callable[[], float] = (
            clock if clock is not None else (lambda: 0.0))
        self._rotate_records = max(int(rotate_records), 1)
        self._snapshot_every = max(int(snapshot_every), 0)
        self._seq = start_seq
        self._rec = get_recorder()
        self.records_since_snapshot = 0
        self._records_in_seg = 0
        self._f: Optional[Any] = None
        self._open_segment(rotated=False)

    # -- segment machinery ---------------------------------------------------

    def _next_index(self) -> int:
        segs = list_segments(self._dir)
        return (segs[-1][0] + 1) if segs else 1

    def _open_segment(self, rotated: bool) -> None:
        if self._f is not None:
            self._f.flush()
            if fsync_enabled():
                os.fsync(self._f.fileno())
            self._f.close()
        index = self._next_index()
        name = f"wal-{self._epoch:06d}-{index:06d}.log"
        path = os.path.join(self._dir, name)
        # Crash-atomic birth: temp + fsync'd rename (+ directory fsync)
        # so a crash mid-rotation never leaves a half-created segment.
        atomic_write_text(path, "")
        self._f = open(path, "a", encoding="utf-8")
        self._records_in_seg = 0
        self.segment = name
        if rotated:
            self._rec.count("durability.segments_rotated")

    # -- the single append funnel -------------------------------------------

    def append(self, kind: str, data: Mapping[str, Any], *,
               t: Optional[float] = None,
               tenant: "Optional[str]" = None) -> bool:
        """Append one record; True when it was written.  False means the
        epoch is fenced (a recovery superseded this handle): the record
        is DROPPED and counted, never half-written."""
        if not self._fence.valid(self._epoch):
            self._rec.count("durability.stale_epoch_rejections")
            return False
        line = encode_record(
            self._seq, self._epoch, kind,
            self._clock() if t is None else t,
            tenant if tenant is not None else self._tenant, data)
        assert self._f is not None
        self._f.write(line)
        self._f.flush()
        if fsync_enabled():
            os.fsync(self._f.fileno())
        self._seq += 1
        self._records_in_seg += 1
        self.records_since_snapshot += 1
        self._rec.count("durability.journal_records")
        self._rec.count("durability.journal_bytes", len(line))
        if self._records_in_seg >= self._rotate_records:
            self._open_segment(rotated=True)
        return True

    # -- snapshots ------------------------------------------------------------

    def should_snapshot(self) -> bool:
        return (self._snapshot_every > 0
                and self.records_since_snapshot >= self._snapshot_every)

    def write_snapshot(self, payload: Mapping[str, Any], *,
                       t: Optional[float] = None,
                       tenant: Optional[str] = None) -> str:
        """Write a snapshot file (crash-atomic) and then its pointer
        record — ordered so a journaled pointer always references a
        durable, complete snapshot.  Returns the snapshot basename."""
        tag = tenant if tenant is not None else self._tenant
        safe = _TENANT_SAFE_RE.sub("_", tag) if tag is not None else "all"
        name = f"snap-{self._seq:08d}-{safe}.json"
        atomic_write_json(os.path.join(self._dir, name), dict(payload))
        self.append("snapshot", {"file": name}, t=t, tenant=tag)
        self.records_since_snapshot = 0
        self._rec.count("durability.snapshots")
        return name

    # -- fleet fan-out ---------------------------------------------------------

    def for_tenant(self, tenant: str) -> "TenantView":
        """A tagged view for one tenant loop sharing this writer (one
        journal per fleet, tenant-tagged records)."""
        return TenantView(self, tenant)

    @property
    def fence(self) -> EpochFence:
        return self._fence

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def next_seq(self) -> int:
        return self._seq

    def close(self) -> None:
        if self._f is not None:
            self._f.flush()
            if fsync_enabled():
                os.fsync(self._f.fileno())
            self._f.close()
            self._f = None


class TenantView(JournalFeed):
    """One tenant's tagged facade over a shared :class:`Journal` — what
    ``FleetController`` hands each tenant loop."""

    def __init__(self, journal: Journal, tenant: str) -> None:
        self._journal = journal
        self.tenant = tenant

    def append(self, kind: str, data: Mapping[str, Any], *,
               t: Optional[float] = None) -> bool:
        return self._journal.append(kind, data, t=t, tenant=self.tenant)

    def should_snapshot(self) -> bool:
        return self._journal.should_snapshot()

    def write_snapshot(self, payload: Mapping[str, Any], *,
                       t: Optional[float] = None) -> str:
        return self._journal.write_snapshot(
            payload, t=t, tenant=self.tenant)

    @property
    def fence(self) -> EpochFence:
        return self._journal.fence
