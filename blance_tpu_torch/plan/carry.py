# Copied from blance_tpu/plan/carry.py (CarryCache and its helpers, and
# EncodeCache, the store of plan/resident.py's encode state).  The
# carry's fields are torch tensors on the solve's device: node padding
# concatenates on that device, byte accounting reads the tensors' sizes
# and the capacity precheck copies ``used`` to the host.
"""Keyed warm-start carry store: the SolveCarry lifecycle.

``PlannerSession`` (plan/session.py) is a thin view over a single-key
:class:`CarryCache`: the live carry and the pending carry of an
un-adopted proposal, the dirty/dirty-post masks, node-growth padding,
invalidation and the host-side capacity precheck.  A fleet of indexes
keys one shared cache by tenant (plan/service.py), and
:class:`EncodeCache` keeps each tenant's resident encode state.

The lifecycle invariants:

- a carry is valid only against the exact ``current`` assignment array
  it was built for.  Sessions enforce that by object identity (every
  adoption path replaces the array); the service — whose callers
  rebuild ``prev`` per request — checks by value (:meth:`CarryCache
  .consume` with ``match="equal"``).
- delta marks recorded while a proposal is pending land in the
  post-proposal mask: the pending solve did not absorb them, so a
  promote carries them forward instead of clearing them.
- node growth zero-pads the carries' [N]-shaped tables (fresh nodes
  hold nothing, so zero-fill keeps them exact) — BOTH the live carry
  and the pending one.
- eviction (the LRU byte budget) is always safe: a missing carry just
  means the next replan solves cold and rebuilds it, bit-identically.

Byte accounting covers the carry arrays themselves (prices + assign +
used, live and pending); the boolean dirty masks are kept even for
evicted keys — they are O(P) and the delta they record must survive the
carry's eviction (a cold solve absorbs them on the next promote).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Optional

import numpy as np
import torch

from ..core.encode import NPArray
from .tensor import SolveCarry

if TYPE_CHECKING:  # annotation-only
    from .resident import EncodedState

__all__ = ["CarryCache", "CarryEntry", "EncodeCache", "pad_carry_nodes",
           "effective_dirty", "capacity_shrank"]


def pad_carry_nodes(carry: Optional[SolveCarry],
                    n: int) -> Optional[SolveCarry]:
    """Grow a carry's [N]-shaped tables to ``n`` nodes by zero-fill.

    Fresh nodes hold nothing, so zero columns keep the table exact; the
    prices vector is re-derived as the padded table's per-node sum (the
    same relationship :class:`plan.tensor.SolveCarry` documents).
    No-op (returns the carry unchanged) when already wide enough."""
    if carry is None:
        return None
    used = carry.used
    if used.shape[1] >= n:
        return carry
    used = torch.cat(
        [used, torch.zeros((used.shape[0], n - used.shape[1]),
                           dtype=used.dtype, device=used.device)], dim=1)
    return SolveCarry(prices=used.sum(dim=0), assign=carry.assign,
                      used=used)


def effective_dirty(dirty: NPArray, current: NPArray,
                    constraints: "NPArray | tuple[int, ...]") -> NPArray:
    """The replan-time dirty mask: accumulated delta rows plus any
    partition with an unfilled constrained slot (it must bid).  Pure
    function of the mask, the live assignment and the per-state slot
    counts — the spelling PlannerSession and the fleet tier share."""
    d = dirty.copy()
    r = current.shape[2] if current.ndim == 3 else 0
    for si, c in enumerate(constraints):
        k = min(int(c), r)
        if k > 0:
            d |= (current[:, si, :k] < 0).any(axis=1)
    return d


def capacity_shrank(
    used: torch.Tensor,  # [S, N] the carry's per-state per-node fill
    current: NPArray,  # [P, S, R] the assignment the carry matches
    partition_weights: NPArray,  # [P]
    node_weights: NPArray,  # [N]
    valid_node: NPArray,  # [N]
    constraints: "NPArray | tuple[int, ...]",  # [S]
    dirty: NPArray,  # [P] effective dirty mask
    shards: int = 1,
) -> bool:
    """True when some node's clean-row held weight exceeds its new
    per-state capacity rail — the pin pass would then trim (displace)
    holders OUTSIDE the dirty mask, so a warm repair cannot be accepted
    and the cold solve should run directly (skipping the wasted repair
    sweep).  O(N + dirty) host work off the carry.

    Grants the same quantization allowance as the device-side
    acceptance check (plan/tensor.py _warm_repair): a converged
    fixpoint legitimately overshoots the ceil'd rail by up to one
    max-weight partition per shard (the auction's first-bidder
    progress rule) and replans unchanged, so flagging that steady
    state would silently demote every replan of such a session to
    cold.  A mis-grant only costs a wasted repair sweep — the
    in-graph ripple check still falls back when the trim actually
    displaces clean holders."""
    used = used.cpu().numpy()
    pw = np.asarray(partition_weights)
    nw = np.asarray(node_weights)
    total_w = float(pw.sum())
    cap_w = np.where(
        np.asarray(valid_node) & (nw >= 0),
        np.maximum(nw, 1.0), 0.0).astype(np.float64)
    share = cap_w / max(cap_w.sum(), 1.0)
    r = current.shape[2]
    any_dirty = bool(dirty.any())
    allowance = shards * (float(pw.max()) if pw.size else 0.0)
    for si, c in enumerate(constraints):
        k = int(c)
        if k <= 0:
            continue
        held = used[si].astype(np.float64).copy()
        if any_dirty:
            # Dirty rows re-bid regardless; their held weight cannot
            # pin, so it does not count against the rail.
            ids = current[dirty, si, :].ravel()
            w = np.repeat(pw[dirty], r)
            m = ids >= 0
            np.subtract.at(held, ids[m], w[m])
        cap = np.ceil(k * total_w * share)
        if (held > cap + allowance + 1e-6).any():
            return True
    return False


class CarryEntry:
    """One key's warm-start state.  Attribute-for-attribute the state
    PlannerSession used to hold inline:

    - ``carry``/``current``: the live SolveCarry and the assignment
      array it matches (validity is identity against ``current`` for
      sessions, value equality for the service).
    - ``pending``: the carry of an un-adopted proposal, promoted by
      :meth:`CarryCache.promote`.
    - ``dirty``/``dirty_post``: delta marks; ``dirty_post`` holds marks
      recorded while a proposal was pending.
    """

    __slots__ = ("carry", "current", "pending", "dirty", "dirty_post",
                 "_tick")

    def __init__(self, partitions: int) -> None:
        self.carry: Optional[SolveCarry] = None
        self.current: Optional[NPArray] = None
        self.pending: Optional[SolveCarry] = None
        self.dirty = np.zeros(partitions, bool)
        self.dirty_post = np.zeros(partitions, bool)
        self._tick = 0

    def nbytes(self) -> int:
        total = 0
        for c in (self.carry, self.pending):
            if c is not None:
                for t in (c.prices, c.assign, c.used):
                    total += int(t.element_size() * t.nelement())
        return total


class CarryCache:
    """Keyed store of warm-start carries with an LRU byte budget.

    One entry per key (a tenant, or a session's private slot).  Every
    accessor bumps the key's recency; whenever the summed carry bytes
    exceed ``max_bytes``, least-recently-used keys lose their carries
    (:meth:`CarryEntry.nbytes` drops to zero) until the budget holds —
    the masks and the entry itself survive, so the delta bookkeeping
    stays correct and the next replan simply solves cold.

    ``max_entries`` bounds the KEY COUNT: beyond it, whole
    least-recently-used entries are dropped (masks included).  Without
    it a service with churning tenant keys would grow one mask-bearing
    entry per distinct key forever.  Dropping an entry is as safe as
    eviction — the key's next replan is a cold start, which absorbs
    any delta the dropped masks recorded.

    Evictions are NEVER silent: every one counts
    ``fleet.carry_evictions{reason=...}`` (``bytes`` — byte-budget LRU,
    ``entries`` — key-count LRU drop, ``shape`` — an entry reset
    because its problem was re-shaped) on ``recorder`` (the process
    recorder by default) and accumulates in :attr:`evictions` /
    :meth:`stats`, so a fleet's cold solves are attributable to the
    cache pressure that caused them instead of reading as unexplained
    warm-path misses.

    Single-task discipline: every method is synchronous and mutates
    under one event-loop window; a shared cache's writes are serialized
    on one task, and sessions are single-owner by construction.
    """

    def __init__(self, max_bytes: Optional[int] = None,
                 max_entries: Optional[int] = None,
                 recorder: "Optional[Any]" = None) -> None:
        if max_bytes is not None and max_bytes < 0:
            raise ValueError(f"max_bytes must be >= 0, got {max_bytes}")
        if max_entries is not None and max_entries < 1:
            raise ValueError(
                f"max_entries must be >= 1, got {max_entries}")
        self.max_bytes = max_bytes
        self.max_entries = max_entries
        self._rec = recorder
        self._entries: dict[str, CarryEntry] = {}
        self._clock = 0
        # Running byte total, adjusted by _adjust around every carry
        # mutation: nbytes() must be O(1), not a sweep over every entry
        # (store() runs once per tenant per batch on the dispatcher's
        # event-loop thread).
        self._bytes = 0
        # Eviction counts by reason (the stats() twin of the
        # fleet.carry_evictions labeled counter).
        self.evictions: dict[str, int] = {}

    # -- bookkeeping ---------------------------------------------------------

    def _touch(self, e: CarryEntry) -> None:
        self._clock += 1
        e._tick = self._clock

    def _note_eviction(self, reason: str) -> None:
        """One eviction's accounting (sync window): the labeled
        ``fleet.carry_evictions`` counter plus the stats() dict, so the
        cold solve this eviction will cost is attributable."""
        self.evictions[reason] = self.evictions.get(reason, 0) + 1
        rec = self._rec
        if rec is None:
            from ..obs import get_recorder

            rec = get_recorder()
        rec.count(f'fleet.carry_evictions{{reason="{reason}"}}')

    def stats(self) -> dict[str, object]:
        """Cache-pressure snapshot: live entry/byte load against the
        budgets, plus cumulative evictions by reason."""
        return {
            "entries": len(self._entries),
            "bytes": self.nbytes(),
            "max_bytes": self.max_bytes,
            "max_entries": self.max_entries,
            "evictions": dict(self.evictions),
        }

    class _Adjust:
        """Context manager bracketing one entry's carry mutation: the
        entry's byte delta folds into the cache's running total."""

        __slots__ = ("cache", "entry", "before")

        def __init__(self, cache: "CarryCache", e: CarryEntry) -> None:
            self.cache = cache
            self.entry = e

        def __enter__(self) -> None:
            self.before = self.entry.nbytes()

        def __exit__(self, *exc: object) -> None:
            self.cache._bytes += self.entry.nbytes() - self.before

    def _adjust(self, e: CarryEntry) -> "CarryCache._Adjust":
        return CarryCache._Adjust(self, e)

    def entry(self, key: str, partitions: int) -> CarryEntry:
        """The key's entry, created (empty, mask length ``partitions``)
        on first use.  An existing entry whose mask length no longer
        matches ``partitions`` is reset — the problem was re-shaped, so
        any carried state is stale by construction."""
        e = self._entries.get(key)
        if e is None or e.dirty.shape[0] != partitions:
            if e is not None:  # shape reset drops the old carries
                self._bytes -= e.nbytes()
                if e.carry is not None or e.pending is not None:
                    self._note_eviction("shape")
            e = CarryEntry(partitions)
            self._entries[key] = e
            # Entry creation is the growth edge: enforce the key-count
            # bound here too, so consume-only key churn cannot outgrow
            # it between stores.  Touch FIRST — the new entry must
            # carry the highest tick so the LRU drop takes an old key,
            # never the one just created.
            self._touch(e)
            self._enforce_budget()
        else:
            self._touch(e)
        return e

    def peek(self, key: str) -> Optional[CarryEntry]:
        """The key's entry without creating one (no recency bump)."""
        return self._entries.get(key)

    def keys(self) -> list[str]:
        return list(self._entries)

    def nbytes(self) -> int:
        """Summed carry bytes across every entry (the budgeted mass);
        O(1) — maintained incrementally around every mutation (the
        recount twin below is the test oracle for that invariant)."""
        return self._bytes

    def _recount(self) -> int:
        """The O(entries) ground truth nbytes() must always equal."""
        return sum(e.nbytes() for e in self._entries.values())

    def _enforce_budget(self) -> None:
        if self.max_entries is not None and \
                len(self._entries) > self.max_entries:
            # Whole-entry LRU drop (masks included): churned-away
            # tenant keys must not accumulate forever.
            excess = len(self._entries) - self.max_entries
            for key in sorted(self._entries,
                              key=lambda k: self._entries[k]._tick
                              )[:excess]:
                e = self._entries[key]
                self._bytes -= e.nbytes()
                del self._entries[key]
                if e.carry is not None or e.pending is not None:
                    # Count only drops that cost a cold solve (the
                    # counter's contract); an already-empty entry loses
                    # nothing but its masks, which a cold start absorbs
                    # anyway — same guard as the shape-reset path.
                    self._note_eviction("entries")
        if self.max_bytes is None:
            return
        total = self.nbytes()
        if total <= self.max_bytes:
            return
        # Oldest first; the just-touched key has the highest tick and is
        # evicted last — but a single carry larger than the whole budget
        # still goes (the budget is a hard cap, not advisory).
        for key in sorted(self._entries,
                          key=lambda k: self._entries[k]._tick):
            e = self._entries[key]
            freed = e.nbytes()
            if freed == 0:
                continue
            e.carry = None
            e.current = None
            e.pending = None
            self._bytes -= freed
            total -= freed
            self._note_eviction("bytes")
            if total <= self.max_bytes:
                return

    # -- the lifecycle -------------------------------------------------------

    def invalidate(self, key: str) -> None:
        """Drop the key's warm-start state: the next replan solves cold.
        Masks clear too — a cold start absorbs every recorded delta."""
        e = self._entries.get(key)
        if e is None:
            return
        self._touch(e)
        with self._adjust(e):
            e.carry = None
            e.current = None
            e.pending = None
        e.dirty[:] = False
        e.dirty_post[:] = False

    def drop(self, key: str) -> None:
        """Forget the key entirely (entry included)."""
        e = self._entries.pop(key, None)
        if e is not None:
            self._bytes -= e.nbytes()

    def mark_dirty(self, key: str, mask: NPArray,
                   pending: bool) -> None:
        """Record delta marks.  With ``pending`` (a proposal is in
        flight) marks land in the post-proposal mask: the pending solve
        did not see this delta, so promote() must carry them forward
        instead of clearing them with the absorbed ones."""
        e = self._entries.get(key)
        if e is None:
            e = self.entry(key, mask.shape[0])
        self._touch(e)
        if pending:
            e.dirty_post |= mask
        else:
            e.dirty |= mask

    def drop_carry_keep_dirty(self, key: str) -> None:
        """Invalidate the live carry only: the masks and pending carry
        survive.  Used when ``current`` is replaced wholesale (R-growth
        padding) — the carry no longer matches any live array, but the
        recorded deltas still describe real cluster changes."""
        e = self._entries.get(key)
        if e is None:
            return
        self._touch(e)
        with self._adjust(e):
            e.carry = None
            e.current = None

    def pad_nodes(self, key: str, n: int) -> None:
        """Zero-pad BOTH carries' [N]-shaped tables after node growth
        (a delta can land between replan() and promote(), and promote
        will adopt the pending carry into the grown problem)."""
        e = self._entries.get(key)
        if e is None:
            return
        self._touch(e)
        with self._adjust(e):
            e.carry = pad_carry_nodes(e.carry, n)
            e.pending = pad_carry_nodes(e.pending, n)
        self._enforce_budget()

    def consume(
        self, key: str, current: NPArray, match: str = "identity",
    ) -> tuple[Optional[SolveCarry], NPArray]:
        """Take the key's carry for a replan attempt, merging the
        post-proposal marks into the dirty mask (this solve absorbs
        every delta recorded so far).

        Returns ``(carry, dirty)``; carry is None on a miss.  The carry
        is CONSUMED either way — its device buffers may be donated into
        the repair, so the caller must replace it via store_pending +
        promote (or the entry stays cold).  ``match`` selects validity:
        ``"identity"`` (sessions: current IS the array the carry was
        built against) or ``"equal"`` (the service: callers rebuild
        prev per request, so compare by value)."""
        if match not in ("identity", "equal"):
            raise ValueError(f"unknown match mode: {match!r}")
        e = self.entry(key, current.shape[0])
        e.dirty |= e.dirty_post
        e.dirty_post[:] = False
        carry, cur = e.carry, e.current
        with self._adjust(e):
            e.carry = None
            e.current = None
        dirty = e.dirty
        if carry is None or cur is None:
            return None, dirty
        if match == "identity":
            ok = cur is current
        else:
            ok = cur.shape == current.shape and \
                bool(np.array_equal(cur, current))
        return (carry, dirty) if ok else (None, dirty)

    def store_pending(self, key: str,
                      carry: Optional[SolveCarry]) -> None:
        """Hold a just-solved proposal's carry until promote()."""
        e = self._entries.get(key)
        if e is None:
            return
        self._touch(e)
        with self._adjust(e):
            e.pending = carry
        self._enforce_budget()

    def promote(self, key: str, current: NPArray) -> None:
        """Adopt the pending carry as the live warm-start state for
        ``current`` (the caller just adopted the proposal) and retire
        the absorbed delta marks; post-proposal marks roll forward."""
        e = self._entries.get(key)
        if e is None:
            return
        self._touch(e)
        with self._adjust(e):
            e.carry = e.pending
            e.current = current if e.pending is not None else None
            e.pending = None
        e.dirty = e.dirty_post
        e.dirty_post = np.zeros_like(e.dirty)
        self._enforce_budget()

    def store(self, key: str, carry: SolveCarry,
              current: NPArray) -> None:
        """Adopt ``carry`` directly as the live state for ``current``
        (the service's one-shot path: solve + adopt in one step), with
        clean masks — the solve absorbed everything."""
        e = self.entry(key, current.shape[0])
        with self._adjust(e):
            e.carry = carry
            e.current = current
            e.pending = None
        e.dirty[:] = False
        e.dirty_post[:] = False
        self._enforce_budget()


class EncodeCache:
    """Keyed LRU store of per-tenant resident encode state
    (:class:`plan.resident.EncodedState`) — the encode-layer sibling of
    :class:`CarryCache`, sharing its contracts:

    - **eviction is always safe**: a dropped state just means the
      tenant's next converge cycle runs a full ``encode_problem`` and
      rebuilds it, bit-identically (cold is the single-problem encode
      on current inputs).  ``max_entries`` bounds the key count,
      ``max_bytes`` the summed resident array bytes; whole states are
      dropped least-recently-used first.
    - **evictions are never silent**: every drop counts
      ``fleet.encode_evictions{reason=bytes|entries}``, and every
      protocol demotion the planner requests
      (:meth:`invalidate`) counts
      ``fleet.encode_demotions{reason=...}`` — so a fleet's cold
      re-encodes are exactly attributable: in steady state,
      ``fleet.encode_cold == first encodes + demotions + evictions``
      (the bench ``fleet_loop`` stage gates that identity).

    Shared-state discipline (analysis/race_lint.py ``SHARED_STATE``):
    the cache is shared by N tenant control-loop tasks, but every
    method is synchronous (one no-await event-loop window) and each KEY
    has a single writer — its own tenant's task.  A planner holds its
    state object across its solve await, so a concurrent eviction of
    that key only drops the cache's reference; the planner's ``put``
    re-inserts it and re-enforces the budget.
    """

    def __init__(self, max_bytes: Optional[int] = None,
                 max_entries: Optional[int] = None,
                 recorder: "Optional[Any]" = None) -> None:
        if max_bytes is not None and max_bytes < 0:
            raise ValueError(f"max_bytes must be >= 0, got {max_bytes}")
        if max_entries is not None and max_entries < 1:
            raise ValueError(
                f"max_entries must be >= 1, got {max_entries}")
        self.max_bytes = max_bytes
        self.max_entries = max_entries
        self._rec = recorder
        self._entries: "dict[str, EncodedState]" = {}
        self._ticks: dict[str, int] = {}
        self._clock = 0
        self.evictions: dict[str, int] = {}
        self.demotions: dict[str, int] = {}

    def _count(self, name: str, book: dict[str, int],
               reason: str) -> None:
        book[reason] = book.get(reason, 0) + 1
        rec = self._rec
        if rec is None:
            from ..obs import get_recorder

            rec = get_recorder()
        rec.count(f'{name}{{reason="{reason}"}}')

    def _touch(self, key: str) -> None:
        self._clock += 1
        self._ticks[key] = self._clock

    def get(self, key: str) -> "Optional[EncodedState]":
        st = self._entries.get(key)
        if st is not None:
            self._touch(key)
        return st

    def put(self, key: str, state: "EncodedState") -> None:
        self._entries[key] = state
        self._touch(key)
        self._enforce_budget()

    def invalidate(self, key: str, reason: str) -> None:
        """Drop one key's state on a protocol demotion (divergence /
        statics swap / node-list drift / shape drift): the next cycle
        re-encodes cold.  Counted once per live state dropped —
        ``fleet.encode_demotions{reason=}`` — so every later cold
        encode is attributable."""
        if self._entries.pop(key, None) is not None:
            self._ticks.pop(key, None)
            self._count("fleet.encode_demotions", self.demotions,
                        reason)

    def drop(self, key: str) -> None:
        """Forget a key silently (tenant teardown — not a demotion)."""
        self._entries.pop(key, None)
        self._ticks.pop(key, None)

    def keys(self) -> list[str]:
        return list(self._entries)

    def nbytes(self) -> int:
        return sum(st.nbytes() for st in self._entries.values())

    def stats(self) -> dict[str, object]:
        return {
            "entries": len(self._entries),
            "bytes": self.nbytes(),
            "max_bytes": self.max_bytes,
            "max_entries": self.max_entries,
            "evictions": dict(self.evictions),
            "demotions": dict(self.demotions),
        }

    def _enforce_budget(self) -> None:
        if self.max_entries is not None and \
                len(self._entries) > self.max_entries:
            excess = len(self._entries) - self.max_entries
            for key in sorted(self._entries,
                              key=lambda k: self._ticks[k])[:excess]:
                del self._entries[key]
                self._ticks.pop(key, None)
                self._count("fleet.encode_evictions", self.evictions,
                            "entries")
        if self.max_bytes is None:
            return
        total = self.nbytes()
        if total <= self.max_bytes:
            return
        for key in sorted(self._entries,
                          key=lambda k: self._ticks[k]):
            freed = self._entries[key].nbytes()
            del self._entries[key]
            self._ticks.pop(key, None)
            self._count("fleet.encode_evictions", self.evictions,
                        "bytes")
            total -= freed
            if total <= self.max_bytes:
                return
