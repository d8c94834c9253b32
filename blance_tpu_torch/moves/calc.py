# Copied from blance_tpu/moves/calc.py.
"""Move calculus: diff two per-partition assignments into ordered state ops.

Reference: moves.go:17-136 of the Go original.  Pure functions; the orchestrator
consumes the op lists, and the batched on-device variant lives in
blance_tpu_torch.moves.batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from ..core.setops import strings_intersect, strings_remove
from ..core.order import flatten_nodes_by_state

__all__ = ["NodeStateOp", "calc_partition_moves"]


@dataclass(frozen=True)
class NodeStateOp:
    """One node's state transition for a partition (moves.go:17-21).

    op is one of "add", "del", "promote", "demote"; a del carries state "".
    """

    node: str
    state: str
    op: str


def _find_state_changes(
    beg_idx: int,
    end_idx: int,
    state: str,
    states: Sequence[str],
    beg: dict[str, list[str]],
    end: dict[str, list[str]],
) -> list[str]:
    """Nodes in end[state] that began in states[beg_idx:end_idx] — the
    promote/demote detector (moves.go:121-136)."""
    rv: list[str] = []
    for node in end.get(state, []):
        for i in range(beg_idx, end_idx):
            for n in beg.get(states[i], []):
                if n == node:
                    rv.append(node)
    return rv


def calc_partition_moves(
    states: Sequence[str],
    beg_nodes_by_state: dict[str, list[str]],
    end_nodes_by_state: dict[str, list[str]],
    favor_min_nodes: bool = False,
) -> list[NodeStateOp]:
    """Step-by-step moves from beg to end for one partition (moves.go:41-119).

    states must be ordered superior-first (e.g. ["primary", "replica"]).

    favor_min_nodes=False (availability-first): iterate states superior to
    inferior, emitting promote, demote, add, del per state — builds happen
    before teardowns so the partition stays served on multiple nodes.

    favor_min_nodes=True (min-copies-first): iterate inferior to superior,
    emitting del, demote, promote, add — the partition occupies the fewest
    nodes at any time, even if that leaves moments with no primary.

    A node gets at most one op per partition (the seen set, moves.go:49-58);
    a relocation is therefore two ops: add on the new node, del on the old.
    """
    moves: list[NodeStateOp] = []
    seen: set[str] = set()

    def add_moves(nodes: list[str], state: str, op: str) -> None:
        for node in nodes:
            if node not in seen:
                seen.add(node)
                moves.append(NodeStateOp(node, state, op))

    beg_nodes = flatten_nodes_by_state(beg_nodes_by_state)
    end_nodes = flatten_nodes_by_state(end_nodes_by_state)

    adds = strings_remove(end_nodes, beg_nodes)
    dels = strings_remove(beg_nodes, end_nodes)

    if not favor_min_nodes:
        for state_i, state in enumerate(states):
            add_moves(
                _find_state_changes(state_i + 1, len(states), state, states,
                                    beg_nodes_by_state, end_nodes_by_state),
                state, "promote")
            add_moves(
                _find_state_changes(0, state_i, state, states,
                                    beg_nodes_by_state, end_nodes_by_state),
                state, "demote")
            add_moves(
                strings_intersect(
                    strings_remove(end_nodes_by_state.get(state, []),
                                   beg_nodes_by_state.get(state, [])),
                    adds),
                state, "add")
            add_moves(
                strings_intersect(
                    strings_remove(beg_nodes_by_state.get(state, []),
                                   end_nodes_by_state.get(state, [])),
                    dels),
                "", "del")
    else:
        for state_i in range(len(states) - 1, -1, -1):
            state = states[state_i]
            add_moves(
                strings_intersect(
                    strings_remove(beg_nodes_by_state.get(state, []),
                                   end_nodes_by_state.get(state, [])),
                    dels),
                "", "del")
            add_moves(
                _find_state_changes(0, state_i, state, states,
                                    beg_nodes_by_state, end_nodes_by_state),
                state, "demote")
            add_moves(
                _find_state_changes(state_i + 1, len(states), state, states,
                                    beg_nodes_by_state, end_nodes_by_state),
                state, "promote")
            add_moves(
                strings_intersect(
                    strings_remove(end_nodes_by_state.get(state, []),
                                   beg_nodes_by_state.get(state, [])),
                    adds),
                state, "add")

    return moves
