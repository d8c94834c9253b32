# Copied from blance_tpu/orchestrate/csp.py.
"""Minimal CSP layer for the orchestrator: rendezvous channels + select.

The reference's control plane is built from goroutines and unbuffered
channels (reference: orchestrate.go:258-261,319-335); this
module provides the same primitives for asyncio so the orchestrator's round
structure (broadcast, first-feed interrupt, in-flight waits) can be expressed
directly:

- ``Chan``: unbuffered rendezvous channel.  ``close()`` broadcasts: pending
  and future ``get``s complete with ``(None, False)`` — the Go
  closed-channel convention — which doubles as the stop/pause/broadcast
  signal (Go's ``close(stopCh)`` idiom).
- ``select(...)``: waits on several get/put operations, commits exactly one.

Single-threaded asyncio makes the commit discipline simple: all bookkeeping
between awaits is atomic, and a shared ``_Token`` per select guarantees
exactly-once completion.
"""

from __future__ import annotations

import asyncio
from collections import deque
from typing import Any, Optional

__all__ = ["Chan", "ChanClosed", "select", "GET", "PUT"]


class ChanClosed(Exception):
    """Raised when putting to a closed channel."""


class _Token:
    """Exactly-once commit token shared by all ops of one select."""

    __slots__ = ("claimed",)

    def __init__(self) -> None:
        self.claimed = False

    def claim(self) -> bool:
        if self.claimed:
            return False
        self.claimed = True
        return True


class _Waiter:
    """One registered get/put op: a future plus its select token."""

    __slots__ = ("future", "token", "index")

    def __init__(self, future: "asyncio.Future[object]", token: _Token,
                 index: int) -> None:
        self.future = future
        self.token = token
        self.index = index


class Chan:
    """Unbuffered (rendezvous) channel of Go semantics.

    get() -> (value, True) on receive, (None, False) once closed.
    put() blocks for a receiver; raises ChanClosed if/when closed.
    """

    def __init__(self) -> None:
        self._getters: deque[_Waiter] = deque()
        self._putters: deque[tuple[_Waiter, Any]] = deque()
        self._closed = False

    @property
    def closed(self) -> bool:
        return self._closed

    # -- non-blocking attempts (used by select's first pass) ----------------

    def _try_get(self) -> Optional[tuple[Any, bool]]:
        while self._putters:
            waiter, item = self._putters.popleft()
            # A done future here means the waiter was abandoned (its
            # awaiting task cancelled, e.g. an aborted timed wait) or its
            # select already committed elsewhere: skip it — resolving it
            # would raise InvalidStateError, and treating a cancelled
            # putter's item as delivered would lose the rendezvous
            # guarantee.
            if waiter.future.done():
                continue
            if waiter.token.claim():
                waiter.future.set_result((waiter.index, None))
                return (item, True)
        if self._closed:
            return (None, False)
        return None

    def _try_put(self, item: Any) -> bool:
        if self._closed:
            raise ChanClosed()
        while self._getters:
            waiter = self._getters.popleft()
            if waiter.future.done():  # abandoned/committed — see _try_get
                continue
            if waiter.token.claim():
                waiter.future.set_result((waiter.index, (item, True)))
                return True
        return False

    # -- registration (select's second pass) --------------------------------

    def _add_getter(self, waiter: _Waiter) -> None:
        self._getters.append(waiter)

    def _add_putter(self, waiter: _Waiter, item: Any) -> None:
        self._putters.append((waiter, item))

    def _gc(self) -> None:
        """Drop claimed AND abandoned (cancelled-future) waiters so
        deques don't grow across selects or expired timed waits."""
        self._getters = deque(
            w for w in self._getters
            if not w.token.claimed and not w.future.done())
        self._putters = deque(
            (w, i) for (w, i) in self._putters
            if not w.token.claimed and not w.future.done()
        )

    # -- blocking ops --------------------------------------------------------

    async def get(self) -> tuple[Any, bool]:
        got = self._try_get()
        if got is not None:
            return got
        token = _Token()
        fut: "asyncio.Future[object]" = \
            asyncio.get_running_loop().create_future()
        self._add_getter(_Waiter(fut, token, 0))
        _, value = await fut
        return value

    async def put(self, item: Any) -> None:
        if self._try_put(item):
            return
        token = _Token()
        fut: "asyncio.Future[object]" = \
            asyncio.get_running_loop().create_future()
        self._add_putter(_Waiter(fut, token, 0), item)
        _, err = await fut
        if err is not None:
            raise err

    def close(self) -> None:
        """Idempotent close; wakes all pending getters/putters (skipping
        abandoned waiters whose futures were cancelled)."""
        if self._closed:
            return
        self._closed = True
        while self._getters:
            waiter = self._getters.popleft()
            if waiter.future.done():
                continue
            if waiter.token.claim():
                waiter.future.set_result((waiter.index, (None, False)))
        while self._putters:
            waiter, _ = self._putters.popleft()
            if waiter.future.done():
                continue
            if waiter.token.claim():
                waiter.future.set_result((waiter.index, ChanClosed()))

    def __aiter__(self) -> "Chan":
        return self

    async def __anext__(self) -> Any:
        value, ok = await self.get()
        if not ok:
            raise StopAsyncIteration
        return value


GET = "get"
PUT = "put"


async def select(*ops: tuple[Any, ...]) -> tuple[int, Any]:
    """Wait for the first ready op among (GET, chan) / (PUT, chan, item).

    Returns (index, value) where value is (item, ok) for a get and None for
    a put.  Exactly one op commits, like Go's select.
    """
    # First pass: anything immediately ready?
    for i, op in enumerate(ops):
        if op[0] == GET:
            got = op[1]._try_get()
            if got is not None:
                return (i, got)
        else:
            if op[1]._try_put(op[2]):
                return (i, None)

    # Second pass: register on all, await first commit.
    token = _Token()
    fut: "asyncio.Future[object]" = \
        asyncio.get_running_loop().create_future()
    chans = []
    for i, op in enumerate(ops):
        waiter = _Waiter(fut, token, i)
        if op[0] == GET:
            op[1]._add_getter(waiter)
        else:
            op[1]._add_putter(waiter, op[2])
        chans.append(op[1])
    try:
        index, value = await fut
    finally:
        for ch in chans:
            ch._gc()
    if isinstance(value, ChanClosed):
        raise value
    return (index, value)
