# Copied from blance_tpu/orchestrate/sched/dag.py.
"""Move-DAG builder: dependencies + machine capacities for scheduling.

The orchestrator's per-partition move lists are already DEPENDENCY
CHAINS: the cursor (``NextMoves.next``) releases move ``i+1`` only after
move ``i``'s batch succeeded, which is exactly what makes the plans safe
(the ``del`` off the old holder must not run before the ``add`` onto the
new one completed, a ``promote`` must not run before the replica it
promotes was built).  This module makes that structure explicit as a
DAG the scheduler can reason about:

- one :class:`DagMove` per REMAINING move (cursor position onward;
  abandoned partitions contribute nothing),
- edges = the within-partition chain order (level ``k`` of the DAG is
  every chain's ``k``-th remaining move — the leveled form the device
  rank kernel scans over),
- machines = one lane set per destination node with capacity
  ``max_concurrent_partition_moves_per_node`` (the orchestrator feeds a
  node at most that many moves per batch).

``build_move_dag`` also VALIDATES the state-transition order per
(partition, node) lifecycle and raises :class:`MoveDagError` on a chain
that would tear coverage if reordered by a buggy policy: an op on a
node after its ``del``, or a ``promote``/``demote``/``del`` of a node
before the ``add`` that creates it (when the chain contains that
``add``).  The reference move calculus never produces such chains; the
check guards hand-built cursors.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Any, Mapping, Sequence

__all__ = ["DagMove", "MoveDag", "MoveDagError", "build_move_dag"]


class MoveDagError(ValueError):
    """A partition's move chain violates the state-transition order."""


@dataclass(frozen=True)
class DagMove:
    """One remaining move: a node of the DAG.

    ``index`` is the ABSOLUTE index into the partition's full move list
    (the cursor's coordinate system), so a plan entry maps back onto
    the live ``NextMoves`` state without translation.  ``level`` is the
    position within the REMAINING chain (the DAG layer)."""

    partition: str
    index: int
    level: int
    node: str
    state: str
    op: str


@dataclass(frozen=True)
class MoveDag:
    """The leveled move DAG plus its machine model.

    ``chains`` maps partition -> its remaining moves in dependency
    order; ``machines`` maps each schedulable destination node to its
    lane count.  Moves whose destination has no machine (no mover, or
    quarantined) are still IN the chains — the list scheduler reports
    them (and their chain successors) as stalled instead of placing
    them on a lane."""

    chains: Mapping[str, tuple[DagMove, ...]]
    machines: Mapping[str, int]

    @cached_property
    def levels(self) -> tuple[tuple[DagMove, ...], ...]:
        """``levels[k]`` = every chain's ``k``-th remaining move — the
        leveled form the device rank sweep's ``[P, L]`` padding mirrors.
        Derived lazily: the scheduler itself ranks/places off ``chains``
        directly, so a bind or mid-schedule rebuild (one sync no-await
        window) never pays for materializing it."""
        max_len = max((len(c) for c in self.chains.values()), default=0)
        return tuple(
            tuple(chain[k] for chain in self.chains.values()
                  if len(chain) > k)
            for k in range(max_len))

    def moves(self) -> list[DagMove]:
        """Every remaining move, chain-grouped, chain order preserved."""
        out: list[DagMove] = []
        for chain in self.chains.values():
            out.extend(chain)
        return out

    def predecessor(self, mv: DagMove) -> DagMove | None:
        """The move that must complete before ``mv`` (chain edge)."""
        if mv.level == 0:
            return None
        return self.chains[mv.partition][mv.level - 1]


def _validate_chain(partition: str, moves: Sequence[Any]) -> None:
    """State-transition order per (partition, node) lifecycle: add ->
    promote/demote -> del, with nothing after the del and nothing
    before an add the chain itself contains."""
    adds_at: dict[str, int] = {}
    deleted_at: dict[str, int] = {}
    for i, mv in enumerate(moves):
        if mv.op == "add":
            adds_at.setdefault(mv.node, i)
    for i, mv in enumerate(moves):
        dead = deleted_at.get(mv.node)
        if dead is not None:
            raise MoveDagError(
                f"partition {partition!r}: move {i} ({mv.op} on "
                f"{mv.node!r}) follows that node's del at move {dead} — "
                f"nothing may touch a node after its removal")
        add_i = adds_at.get(mv.node)
        if add_i is not None and i < add_i and mv.op != "add":
            raise MoveDagError(
                f"partition {partition!r}: move {i} ({mv.op} on "
                f"{mv.node!r}) precedes the add that creates that node "
                f"at move {add_i} — run the add first (make before "
                f"break)")
        if mv.op == "del":
            deleted_at[mv.node] = i


def build_move_dag(
    cursors: Mapping[str, Any],
    nodes_all: Sequence[str] = (),
    max_concurrent: int = 1,
    validate: bool = True,
) -> MoveDag:
    """Build the leveled move DAG from live move cursors.

    ``cursors`` is the orchestrator's ``map_partition_to_next_moves``
    view (anything mapping partition -> an object with ``next``,
    ``moves`` and optional ``failed_at``); only moves from the cursor
    position onward enter the DAG, and an abandoned partition
    (``failed_at`` set) contributes nothing — its remaining moves must
    never be scheduled.  ``nodes_all`` + ``max_concurrent`` define the
    machine model (lanes per destination node)."""
    lanes = max_concurrent if max_concurrent > 0 else 1
    chains: dict[str, tuple[DagMove, ...]] = {}
    for name in sorted(cursors):
        nm = cursors[name]
        if validate:
            _validate_chain(name, nm.moves)
        if getattr(nm, "failed_at", None) is not None:
            continue
        start = nm.next
        if start >= len(nm.moves):
            continue
        chains[name] = tuple(
            DagMove(partition=name, index=start + k, level=k,
                    node=mv.node, state=mv.state, op=mv.op)
            for k, mv in enumerate(nm.moves[start:]))
    machines = {node: lanes for node in nodes_all}
    return MoveDag(chains=chains, machines=machines)
