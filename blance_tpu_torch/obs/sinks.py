# Copied from blance_tpu/obs/sinks.py.
"""Span sinks: where finished spans go.

A sink is any object with a ``span(span)`` method (and an optional
``close()``).  The Recorder itself keeps only aggregates; retention is the
sink's job, so attaching no sink costs no memory growth.  A sink may also
define ``counter(name, value, t)`` to receive live counter updates (the
Chrome exporter builds time-series counter tracks from them).

- ``InMemorySink``: keeps Span objects — the test/debug sink.
- ``JsonlSink``: one JSON object per finished span, streamed to a file —
  the production log-shipping shape (grep-able, tail-able, no buffering
  of the whole trace in memory).  With ``max_bytes`` set the file is
  size-capped and rotated (``path`` -> ``path.1`` -> ... -> ``path.N``),
  so an un-rotated sink can't grow unboundedly in a long-running
  service.
"""

from __future__ import annotations

import json
import os
import threading
from typing import IO, Optional, Protocol, Union, runtime_checkable

from .recorder import Span

__all__ = ["Sink", "InMemorySink", "JsonlSink", "span_to_dict"]


@runtime_checkable
class Sink(Protocol):
    """The structural contract a sink implements (duck-typed; this
    Protocol names it for annotations and the static tier).  The
    optional ``counter(name, value, t)`` hook is deliberately absent:
    the Recorder feature-detects it with ``hasattr``, so span-only
    sinks stay two methods."""

    def span(self, sp: Span) -> None: ...

    def close(self) -> None: ...


def span_to_dict(sp: Span, t0: float = 0.0) -> dict:
    """JSON-serializable view of a span; times shifted by ``t0`` so
    exported timestamps start near zero."""
    return {
        "name": sp.name,
        "t_start_s": sp.t_start - t0,
        "duration_s": sp.duration_s,
        "span_id": sp.span_id,
        "parent_id": sp.parent_id,
        "task": sp.task,
        "attrs": sp.attrs,
    }


class InMemorySink:
    """Retains every finished span (tests, small traces)."""

    def __init__(self) -> None:
        self.spans: list[Span] = []
        self._lock = threading.Lock()

    def span(self, sp: Span) -> None:
        with self._lock:
            self.spans.append(sp)

    def by_name(self, name: str) -> list[Span]:
        with self._lock:
            return [sp for sp in self.spans if sp.name == name]

    def close(self) -> None:  # symmetry with file-backed sinks
        pass


class JsonlSink:
    """Streams spans as JSON lines to ``path`` (or an open file object).

    Lines are written and flushed per span under a lock, so concurrent
    asyncio tasks / threads interleave whole records, never bytes.

    Rotation (path-owned sinks only): with ``max_bytes`` set, a write
    that carries the file to or past the cap closes it, shifts
    ``path.{i}`` -> ``path.{i+1}`` keeping the newest ``keep`` rotated
    files, renames ``path`` -> ``path.1``, and reopens ``path`` fresh.
    Rotation happens AFTER the triggering line is written whole, so a
    record is never split across files and every rotated file is valid
    JSONL; the cap is therefore a high-water mark, overshot by at most
    one record."""

    def __init__(self, path_or_file: Union[str, IO], t0: float = 0.0,
                 max_bytes: Optional[int] = None, keep: int = 3) -> None:
        self._own = isinstance(path_or_file, str)
        self._path: Optional[str] = path_or_file if self._own else None
        if max_bytes is not None and not self._own:
            raise ValueError("rotation (max_bytes) requires a path-owned "
                             "sink, not an open file object")
        if max_bytes is not None and max_bytes <= 0:
            raise ValueError(f"max_bytes must be positive, got {max_bytes}")
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self._max_bytes = max_bytes
        self._keep = keep
        self._f: Optional[IO] = (
            open(path_or_file, "w") if self._own else path_or_file)
        self._t0 = t0
        self._lock = threading.Lock()

    def span(self, sp: Span) -> None:
        with self._lock:
            if self._f is None:
                return
            json.dump(span_to_dict(sp, self._t0), self._f,
                      default=str, separators=(",", ":"))
            self._f.write("\n")
            self._f.flush()
            if self._max_bytes is not None and \
                    self._f.tell() >= self._max_bytes:
                self._rotate()

    def _rotate(self) -> None:
        """Shift the rotation chain and reopen; caller holds the lock.
        ``os.replace`` onto ``path.keep`` drops the oldest file."""
        assert self._f is not None and self._path is not None
        self._f.close()
        for i in range(self._keep - 1, 0, -1):
            src = f"{self._path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self._path}.{i + 1}")
        os.replace(self._path, f"{self._path}.1")
        self._f = open(self._path, "w")

    def close(self) -> None:
        with self._lock:
            if self._f is not None and self._own:
                self._f.close()
            self._f = None
