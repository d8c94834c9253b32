# Port of blance_tpu/moves/batch.py: diff_assignments on tensors (on the
# device of its inputs) in place of the jitted jnp function;
# moves_from_arrays copied (numpy); calc_all_moves copied with a
# ``device`` and without the power-of-two padding of P, which only served
# jax's trace cache, its interning split out as encode_maps.
"""Batched move calculus: diff whole maps at once, on the device.

The host-side calc_partition_moves (moves/calc.py, reference moves.go:41-119)
is O(S^2 R^2) per partition with tiny constants — fine for one partition,
slow in Python for 100k.  This module computes the SAME ordered op lists for
every partition in one pass of tensor ops over dense assignments:

Each node involved in a partition has exactly one (beg_state, end_state)
pair, which determines its op:
  beg absent          -> add     (at end state)
  end absent          -> del     (emitted at beg state's turn)
  beg_state >  end    -> promote (moving up; emitted at end state's turn)
  beg_state <  end    -> demote  (moving down; emitted at end state's turn)
and an ordering key replicating the reference's two emission orders
(availability-first: promote, demote, add, del per state superior-first;
min-copies-first: del, demote, promote, add per state inferior-first), with
ties following slot order within a state.

Op codes: 0=add 1=del 2=promote 3=demote; -1 = empty.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..convert import resolve_device
from ..core.order import sort_state_names, sorted_by_partition_name
from ..core.types import PartitionMap, PartitionModel
from ..obs import get_recorder
from .calc import NodeStateOp, calc_partition_moves

__all__ = ["diff_assignments", "calc_all_moves", "encode_maps",
           "moves_from_arrays", "OP_NAMES"]

OP_NAMES = ["add", "del", "promote", "demote"]
_OP_ADD, _OP_DEL, _OP_PROMOTE, _OP_DEMOTE = 0, 1, 2, 3
_INVALID_KEY = 2**30


def _select(cond: torch.Tensor, a: Any, b: Any) -> torch.Tensor:
    """``torch.where`` kept in int32: a Python int beside an int32 tensor
    stays int32, but two Python ints would give int64."""
    out = torch.where(cond, a, b)
    return out if out.dtype == torch.int32 else out.to(torch.int32)


def diff_assignments(
    beg: torch.Tensor,  # [P, S, R] int32 node ids
    end: torch.Tensor,  # [P, S, R] int32 node ids
    n: int = 0,  # unused, kept for API compatibility with the reference
    favor_min_nodes: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Diff two dense assignments into ordered per-partition op lists, on
    the device of ``beg`` and ``end``.

    Returns (nodes[P, L], states[P, L], ops[P, L]) int32 with -1 padding
    at the tail; L = 2*S*R.  states[i] is -1 for del ops (the reference's
    "" state).  Bitwise the reference's jitted diff on the same arrays.
    """
    del n
    p, s, r = beg.shape
    sr = s * r
    dev = beg.device
    beg = beg.to(torch.int32)
    end = end.to(torch.int32)

    # State of each flat slot position (si-major), and each side's state
    # for every entry of the other side, by all-pairs compare over the
    # tiny SR axis (no [P, N] scratch, no node-count specialization).
    bflat = beg.reshape(p, sr)
    eflat = end.reshape(p, sr)
    pos = torch.arange(sr, dtype=torch.int32, device=dev)
    pos_state = pos // r  # [SR]
    slot = pos % r  # [SR]

    def lookup(entries: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
        """State holding each entry's node on the other side, -1 if absent
        (superior/lowest state wins on duplicates, like the reference's
        superior-first scans)."""
        match = (entries[:, :, None] == other[:, None, :]) & \
            (entries >= 0)[:, :, None]
        st = _select(match, pos_state[None, None, :], s)  # [P, SR, SR]
        found = st.amin(dim=2)
        return _select(found == s, -1, found)

    beg_state_of_end = lookup(eflat, bflat)  # [P, SR]
    end_state_of_beg = lookup(bflat, eflat)  # [P, SR]

    def op_and_key(b: torch.Tensor, e: torch.Tensor) \
            -> tuple[torch.Tensor, torch.Tensor]:
        """Op code + emission key for each (beg_state, end_state) pair."""
        is_add = (b < 0) & (e >= 0)
        is_del = (b >= 0) & (e < 0)
        is_pro = (b >= 0) & (e >= 0) & (b > e)
        is_dem = (b >= 0) & (e >= 0) & (b < e)
        op = _select(is_add, _OP_ADD,
             _select(is_del, _OP_DEL,
             _select(is_pro, _OP_PROMOTE,
             _select(is_dem, _OP_DEMOTE, -1))))
        # Emission state: the end state's turn, except del at the beg state.
        emit_state = _select(is_del, b, e)
        if not favor_min_nodes:
            rank = _select(is_pro, 0, _select(is_dem, 1,
                                              _select(is_add, 2, 3)))
            key = emit_state * 4 + rank
        else:
            rank = _select(is_del, 0, _select(is_dem, 1,
                                              _select(is_pro, 2, 3)))
            key = (s - 1 - emit_state) * 4 + rank
        return op, key

    def entries(slots: torch.Tensor, other_state: torch.Tensor,
                side_is_end: bool) -> tuple[torch.Tensor, ...]:
        """One side's [P, SR] entry columns in slot order (the reference
        appends them si-major, ri-minor): promote/demote/add from the end
        side, del from the beg side."""
        valid = slots >= 0
        # An entry's own-side state is just its slot's state index.
        own = _select(valid, pos_state[None, :], -1)
        other = _select(valid, other_state, -1)
        b, e = (other, own) if side_is_end else (own, other)
        op, key = op_and_key(b, e)
        if side_is_end:
            keep = valid & (op >= 0) & (op != _OP_DEL)
        else:
            keep = valid & (op == _OP_DEL)
        # Slot order breaks ties within (state, rank).
        full_key = _select(keep, key * (r + 1) + slot[None, :], _INVALID_KEY)
        out_state = _select(op == _OP_DEL, -1, e)
        return (_select(keep, slots, -1), _select(keep, out_state, -1),
                _select(keep, op, -1), full_key)

    end_cols = entries(eflat, beg_state_of_end, True)
    beg_cols = entries(bflat, end_state_of_beg, False)
    nodes, states, ops, keys = (torch.cat([a, b_], dim=1)
                                for a, b_ in zip(end_cols, beg_cols))

    # Valid keys are unique within a row; the invalid ones (all 2^30) give
    # -1 in all three outputs whatever their order.  Stable anyway, as the
    # reference's argsort is.
    order = torch.sort(keys, dim=1, stable=True).indices
    return (torch.gather(nodes, 1, order), torch.gather(states, 1, order),
            torch.gather(ops, 1, order))


def moves_from_arrays(
    partition_names: "list[str]",
    state_names: "list[str]",
    node_names: "list[str]",
    d_nodes: np.ndarray,  # [P, L] int32 node ids, -1 padding
    d_states: np.ndarray,  # [P, L] int32 state ids, -1 = "" (del)
    d_ops: np.ndarray,  # [P, L] int32 op codes, -1 padding
) -> dict[str, list[NodeStateOp]]:
    """Materialize diff arrays into per-partition ordered NodeStateOp
    lists — THE host step of the batched move calculus.

    Valid entries sort to the front of each row (the diff's invalid keys
    are 2^30), so row pi's moves are its first counts[pi] flat entries.
    One pass over the ~total-op count instead of P x L Python
    iterations.  Returns a dict keyed by ``partition_names`` order;
    records ``moves.total_ops`` on the ambient Recorder.
    """
    d_nodes = np.asarray(d_nodes)
    d_states = np.asarray(d_states)
    d_ops = np.asarray(d_ops)
    P = len(partition_names)
    mask = d_ops >= 0
    counts = mask.sum(axis=1)
    flat = mask.reshape(-1)
    node_arr = np.asarray(node_names, dtype=object)[
        d_nodes.reshape(-1)[flat]]
    state_arr = np.asarray(list(state_names) + [""], dtype=object)
    state_vals = state_arr[d_states.reshape(-1)[flat]]  # -1 wraps to ""
    op_arr = np.asarray(OP_NAMES, dtype=object)
    op_vals = op_arr[d_ops.reshape(-1)[flat]]
    flat_moves = [NodeStateOp(n_, s_, o_) for n_, s_, o_ in
                  zip(node_arr.tolist(), state_vals.tolist(),
                      op_vals.tolist())]
    offsets = np.zeros(P + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    out = {name: flat_moves[offsets[pi]:offsets[pi + 1]]
           for pi, name in enumerate(partition_names)}
    get_recorder().count("moves.total_ops", int(counts.sum()))
    return out


def calc_all_moves(
    beg_map: PartitionMap,
    end_map: PartitionMap,
    model: PartitionModel,
    favor_min_nodes: bool = False,
    device: Any = "cuda",
) -> dict[str, list[NodeStateOp]]:
    """Whole-map diff on ``device``; returns per-partition ordered op
    lists.

    Produces the same ops as running calc_partition_moves per partition
    (cross-checked in tests); use this for 100k-partition rebalances where
    the host loop is the bottleneck.
    """
    dev = resolve_device(device, "calc_all_moves")
    if beg_map.keys() != end_map.keys():
        # The host path (orchestrate_moves) raises KeyError on a partition
        # missing from end_map; silently emitting del-everything here would
        # be a behavior divergence between the two modes.
        missing = beg_map.keys() ^ end_map.keys()
        raise KeyError(
            f"beg_map/end_map partition sets differ: {sorted(missing)[:5]}")

    rec = get_recorder()
    with rec.span("moves.calc_all_moves", partitions=len(beg_map)):
        return _calc_all_moves(beg_map, end_map, model, favor_min_nodes,
                               rec, dev)


def encode_maps(
    beg_map: PartitionMap,
    end_map: PartitionMap,
    states: "list[str]",
) -> tuple[list[str], list[str], np.ndarray, np.ndarray, set[str]]:
    """Intern two maps with the same keys into dense [P, S, R] int32
    assignments: (partition names in planner order, node names by id,
    beg, end, the irregular partitions).  A partition is irregular when a
    node appears in more than one slot on either side; calc_all_moves
    diffs those on the host."""
    state_index = {sname: i for i, sname in enumerate(states)}

    # Planner iteration order (zero-padded numeric names), so device-diff
    # op logs replay in the same partition order the planner used — not
    # plain lexicographic (cf. orchestrate.go:264-287 trace reproducibility).
    names = sorted_by_partition_name(beg_map.keys())
    nodes: list[str] = []
    node_index: dict[str, int] = {}

    def intern(node: str) -> int:
        if node not in node_index:
            node_index[node] = len(nodes)
            nodes.append(node)
        return node_index[node]

    r_max = 1
    for m in (beg_map, end_map):
        for partition in m.values():
            for sname, ns in partition.nodes_by_state.items():
                if sname in state_index:
                    r_max = max(r_max, len(ns))

    P, S = len(names), len(states)
    beg = np.full((P, S, r_max), -1, np.int32)
    end = np.full((P, S, r_max), -1, np.int32)
    # Partitions where a node appears in more than one state on either
    # side need the host diff: the reference's per-state scan + seen-set
    # has order-dependent behavior there that the dense
    # one-state-per-node encoding cannot express (moves.go:49-58).
    irregular: set[str] = set()
    for pi, name in enumerate(names):
        for arr, m in ((beg, beg_map), (end, end_map)):
            partition = m[name]  # key equality enforced by the caller
            seen_nodes: set[str] = set()
            for sname, ns in partition.nodes_by_state.items():
                si = state_index.get(sname)
                if si is None:
                    continue
                for ri, node in enumerate(ns[:r_max]):
                    if node in seen_nodes:
                        irregular.add(name)
                    seen_nodes.add(node)
                    arr[pi, si, ri] = intern(node)
    return names, nodes, beg, end, irregular


def _calc_all_moves(
    beg_map: PartitionMap,
    end_map: PartitionMap,
    model: PartitionModel,
    favor_min_nodes: bool,
    rec: Any,
    dev: torch.device,
) -> dict[str, list[NodeStateOp]]:
    states = sort_state_names(model)
    with rec.span("moves.encode"):
        names, nodes, beg, end, irregular = encode_maps(beg_map, end_map,
                                                        states)
    P, S, r_max = beg.shape
    if P == 0 or not nodes:
        return {name: [] for name in names}

    rec.count("moves.diff_partitions", P)
    rec.count("moves.irregular_partitions", len(irregular))

    with rec.span("moves.device_diff", P=P, S=S, R=r_max):
        d_nodes, d_states, d_ops = (
            t.cpu().numpy() for t in diff_assignments(
                torch.from_numpy(beg).to(dev), torch.from_numpy(end).to(dev),
                favor_min_nodes=favor_min_nodes))

    with rec.span("moves.materialize"):
        out = moves_from_arrays(names, states, nodes,
                                d_nodes, d_states, d_ops)
        for name in irregular:
            out[name] = calc_partition_moves(
                states,
                beg_map[name].nodes_by_state,
                end_map[name].nodes_by_state,
                favor_min_nodes)
        return out
