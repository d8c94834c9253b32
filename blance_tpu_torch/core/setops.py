# Copied from blance_tpu/core/setops.py, verbatim but for the reference-path prefix in citations.
"""Ordered string-set operations.

These are the data-model-level primitives the planner and move calculus are
built from (reference: misc.go:13-66).  All operations are
order-preserving with respect to their first argument, which is load-bearing:
node ordering encodes priority (replica ordinals) throughout the framework.

On the dense/TPU path these same operations are boolean-mask ops over int32
node-id arrays (see blance_tpu.plan.tensor); this module is the host-side,
small-problem form.
"""

from __future__ import annotations

from collections.abc import Iterable, Sequence

__all__ = [
    "strings_to_set",
    "strings_remove",
    "strings_intersect",
    "strings_dedup",
]


def strings_to_set(strs: Iterable[str] | None) -> set[str] | None:
    """Build a membership set; None passes through (reference misc.go:13-22)."""
    if strs is None:
        return None
    return set(strs)


def strings_remove(strs: Sequence[str], remove: Sequence[str] | None) -> list[str]:
    """strs minus remove, preserving strs order (reference misc.go:27-36)."""
    if not remove:
        return list(strs)
    removed = set(remove)
    return [s for s in strs if s not in removed]


def strings_intersect(a: Sequence[str], b: Sequence[str] | None) -> list[str]:
    """Intersection in a's order, deduplicated (reference misc.go:40-51)."""
    if not b:
        return []
    bset = set(b)
    seen: set[str] = set()
    rv: list[str] = []
    for s in a:
        if s in bset and s not in seen:
            seen.add(s)
            rv.append(s)
    return rv


def strings_dedup(a: Sequence[str]) -> list[str]:
    """Deduplicate, preserving first-occurrence order (reference misc.go:55-66)."""
    seen: set[str] = set()
    rv: list[str] = []
    for s in a:
        if s not in seen:
            seen.add(s)
            rv.append(s)
    return rv
