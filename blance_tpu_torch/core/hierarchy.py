# Copied from blance_tpu/core/hierarchy.py, verbatim but for the reference-path prefix in citations.
"""Containment-hierarchy (rack/zone) tree helpers.

Host-side form of the hierarchy machinery (reference: 
plan.go:699-774).  The tree is given as a child->parent map; these helpers
derive parent->children, walk ancestors, and compute include/exclude leaf
sets per HierarchyRule semantics (reference api.go:76-105).

The dense/TPU planner does not use tree recursion: it compresses each level
into per-node group ids so rule checks become integer compares (see
blance_tpu.plan.tensor).
"""

from __future__ import annotations

from collections.abc import Sequence

from .setops import strings_intersect, strings_remove

__all__ = [
    "parents_to_children",
    "find_ancestor",
    "find_leaves",
    "include_exclude_nodes",
    "include_exclude_nodes_intersect",
    "level_group_ids",
]


def parents_to_children(parents: dict[str, str] | None) -> dict[str, list[str]]:
    """Invert child->parent into parent->sorted child list.

    Children are sorted by name for determinism (reference plan.go:703-717).
    """
    rv: dict[str, list[str]] = {}
    if not parents:
        return rv
    for child in sorted(parents):
        rv.setdefault(parents[child], []).append(child)
    return rv


def find_ancestor(node: str, parents: dict[str, str] | None, level: int) -> str:
    """Walk up ``level`` parents; a missing parent yields "" (plan.go:755-762)."""
    parents = parents or {}
    for _ in range(level):
        node = parents.get(node, "")
    return node


def find_leaves(node: str, children: dict[str, list[str]]) -> list[str]:
    """All leaf descendants; a childless node is itself a leaf (plan.go:764-774)."""
    kids = children.get(node)
    if not kids:
        return [node]
    rv: list[str] = []
    for c in kids:
        rv.extend(find_leaves(c, children))
    return rv


def include_exclude_nodes(
    node: str,
    include_level: int,
    exclude_level: int,
    parents: dict[str, str] | None,
    children: dict[str, list[str]],
) -> list[str]:
    """leaves(ancestor(include_level)) minus leaves(ancestor(exclude_level)).

    Reference plan.go:723-734; rule semantics documented at api.go:76-105.
    """
    inc = find_leaves(find_ancestor(node, parents, include_level), children)
    exc = find_leaves(find_ancestor(node, parents, exclude_level), children)
    return strings_remove(inc, exc)


def include_exclude_nodes_intersect(
    nodes: Sequence[str],
    include_level: int,
    exclude_level: int,
    parents: dict[str, str] | None,
    children: dict[str, list[str]],
) -> list[str]:
    """Intersection of include_exclude_nodes over all anchors (plan.go:738-753).

    The anchors are the primary plus all hierarchy picks made so far, so later
    picks are cognizant of earlier ones.
    """
    rv: list[str] = []
    first = True
    for node in nodes:
        res = include_exclude_nodes(node, include_level, exclude_level, parents, children)
        if first:
            rv = res
            first = False
            continue
        rv = strings_intersect(rv, res)
    return rv


def level_group_ids(
    nodes: Sequence[str], parents: dict[str, str] | None, max_level: int
) -> list[list[int]]:
    """Compress the tree into per-level group ids for the dense planner.

    Returns ``gid[level][i]`` = integer id of node ``nodes[i]``'s level-th
    ancestor (level 0 = the node itself).  Two nodes share a level-L subtree
    iff their level-L group ids are equal — which turns HierarchyRule
    include/exclude checks into integer comparisons with no N×N masks
    (SURVEY.md §7 hard part 2).  A missing ancestor maps every orphan to the
    shared "" group, matching find_ancestor's "" convention.
    """
    out: list[list[int]] = []
    get = (parents or {}).get
    names: list[str] = list(nodes)
    for level in range(max_level + 1):
        if level:
            # One parent step per level — identical to find_ancestor's
            # from-scratch walk (same get() sequence) at O(L*N) total
            # instead of O(L^2*N), which matters at 10k nodes.
            names = [get(nm, "") for nm in names]
        interned: dict[str, int] = {}
        row: list[int] = []
        for nm in names:
            if nm not in interned:
                interned[nm] = len(interned)
            row.append(interned[nm])
        out.append(row)
    return out
