"""The program under test, as the entries drive it: ``blance_tpu_torch``.

Builds the program's inputs (model, options, PartitionMaps) from the
benchmark's arrays, and reads its outputs back into arrays for the
reference.  The entries in ``entries/`` import this module; the
reference never does.
"""

from __future__ import annotations

import blance_tpu_torch as bt
import numpy as np

import deploy
import reference


class MapEntry:
    """Shared by the entries that take and return PartitionMaps."""

    has_moves = False

    def __init__(self, dep: deploy.Deployment, cfg: dict, traffic: dict,
                 start: np.ndarray, chain: deploy.Chain, device: str):
        self.bt, self.dep, self.chain = bt, dep, chain
        self.traffic, self.device = traffic, device
        self.names = dep.node_names()
        self.parts = dep.partition_names()
        self.node_index = {n: i for i, n in enumerate(self.names)}
        self.part_index = {p: i for i, p in enumerate(self.parts)}
        self.model = bt.model(**{s: tuple(cfg["states"][s])
                                 for s in dep.states})
        self.opts = options(dep, self.names)
        self.start = start

    def node_list(self, ids) -> list:
        return [self.names[i] for i in ids]

    def to_map(self, rows: np.ndarray) -> dict:
        """[P, C] node ids as the program's PartitionMap."""
        states, cols, names = self.dep.states, self.dep.cols, self.names
        out = {}
        for p, row in zip(self.parts, rows.tolist()):
            nbs: dict = {}
            for c, n in enumerate(row):
                if n >= 0:
                    nbs.setdefault(states[cols[c]], []).append(names[n])
            out[p] = bt.Partition(p, nbs)
        return out

    def initial(self):
        return (self.to_map(self.start), {})

    def record(self, raw) -> tuple:
        """The answer as the check reads it: ([P, C] node ids, entries
        that cannot be read so, and the move lists by row or None)."""
        pmap, warnings = raw[0], raw[1]
        rows, bad = reference.map_rows(pmap, self.part_index,
                                       self.node_index, self.dep.states,
                                       self.dep.cols)
        bad += sum(1 for w in warnings.values() if w)
        steps = None
        if self.has_moves:
            steps, unread = ops_rows(self.part_index, self.node_index,
                                     self.dep.states, raw[2],
                                     2 * len(self.dep.cols))
            bad += unread
        return rows, bad, steps

    def rows(self, rec) -> tuple:
        return rec[0], rec[1]

    def steps(self, rec):
        return rec[2]

    def close(self) -> None:
        pass


def options(dep: deploy.Deployment, names: list):
    """PlanOptions of the deployment: racks of ``rack_size`` under one
    zone and its hierarchy rules, where the configuration has them.  The
    stickiness is the planner's default (deploy.Deployment checks it)."""
    kw = {}
    if dep.rack_size:
        hier = {nd: f"r{i // dep.rack_size:05d}"
                for i, nd in enumerate(names)}
        hier.update({r: "z0" for r in set(hier.values())})
        kw["node_hierarchy"] = hier
    if dep.rules:
        kw["hierarchy_rules"] = {
            state: [bt.HierarchyRule(include_level=i, exclude_level=e)
                    for i, e in pairs] for state, pairs in dep.rules.items()}
    return bt.PlanOptions(**kw)


def ops_rows(part_index: dict, node_index: dict, states, moves: dict,
             width: int) -> tuple:
    """The program's move lists (partition name -> NodeStateOp list) as
    [P, width, 3] int32 (node id, state index or -1 for "", op index in
    reference.OPS; -1 padding), and the entries that cannot be read so."""
    out = np.full((len(part_index), width, 3), -1, np.int32)
    bad = 0
    for p, ops in moves.items():
        pi = part_index.get(p)
        if pi is None or len(ops) > width:
            bad += 1
            continue
        for j, m in enumerate(ops):
            node = node_index.get(m.node)
            if node is None or m.op not in reference.OPS or \
                    (m.state and m.state not in states):
                bad += 1
                continue
            out[pi, j] = (node, states.index(m.state) if m.state else -1,
                          reference.OPS.index(m.op))
    return out, bad
