"""The deployment and its traffic, made from the seed in NumPy.

A configuration file (``configs/<name>.json``) states the deployment: the
partition and node counts, the model's states, the rack layout and its
rules, the stickiness and the weights.  A traffic file
(``traffic/<name>.json``) states the mix: the entry it drives, the share
of nodes that leave in each request, and the warm-up.  This module turns
the two and a seed into:

- the start map: balanced and inside the rules, as a cluster is after its
  last rebalance (``start_assignment``);
- the chain of node lists: request k takes out ``out`` live nodes and
  brings back the ``out`` nodes request k-1 took out (``Chain``).

Nothing here imports the program: the same arrays feed the program (as
PartitionMaps) and the reference.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load_json(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


@dataclasses.dataclass(frozen=True)
class Deployment:
    """The sizes and rules of one configuration file.

    A map is [P, C]: column c holds a copy of state ``cols[c]`` (states
    superior first, a state of R copies in R adjacent columns); ``apart``
    lists the column pairs the placement rules keep on different racks."""

    partitions: int
    nodes: int
    states: tuple          # state names, superior first
    copies: tuple          # constraints (copies) per state
    rack_size: int         # 0: flat hierarchy
    rules: dict            # state -> [[include_level, exclude_level]]

    @classmethod
    def from_config(cls, cfg: dict) -> "Deployment":
        states = sorted(cfg["states"], key=lambda s: cfg["states"][s][0])
        rules = cfg.get("hierarchy_rules") or {}
        for state, pairs in rules.items():
            # One zone: "include the zone, exclude the rack" is "another
            # rack than the superior states' copies", all the reference
            # checks.
            if pairs != [[2, 1]] or cfg.get("zones", 1) != 1 or \
                    state not in states[1:]:
                raise ValueError(f"unsupported hierarchy rule {state}: "
                                 f"{pairs}")
        if cfg.get("partition_weight", 1) != 1 or \
                cfg.get("node_weight", 1) != 1 or cfg["stickiness"] != 1.5:
            raise ValueError("the deployments here have unit weights and "
                             "the planner's default stickiness 1.5")
        return cls(int(cfg["partitions"]), int(cfg["nodes"]), tuple(states),
                   tuple(int(cfg["states"][s][1]) for s in states),
                   int(cfg.get("rack_size") or 0), dict(rules))

    @property
    def cols(self) -> tuple:
        """State index of each column of a map."""
        return tuple(si for si, r in enumerate(self.copies)
                     for _ in range(r))

    @property
    def apart(self) -> tuple:
        """Column pairs on different racks: each copy of a ruled state
        against each copy of the states above it."""
        cols = self.cols
        return tuple((a, b) for b in range(len(cols))
                     if self.states[cols[b]] in self.rules
                     for a in range(len(cols)) if cols[a] < cols[b])

    def node_names(self) -> list:
        return [f"n{i:05d}" for i in range(self.nodes)]

    def partition_names(self) -> list:
        # Zero-padded, so every name order the planner could use is this.
        return [f"{i:07d}" for i in range(self.partitions)]

    def racks(self) -> np.ndarray:
        """Rack of each node id (racks of ``rack_size`` consecutive ids)."""
        ids = np.arange(self.nodes)
        return ids // self.rack_size if self.rack_size else ids


def out_count(dep: Deployment, traffic: dict) -> int:
    return int(round(traffic["out_share"] * dep.nodes))


def start_assignment(dep: Deployment, out0: np.ndarray,
                     rng: np.random.Generator) -> np.ndarray:
    """[P, C] node ids of a balanced start map on the nodes not in
    ``out0``: each column's copies spread over the live nodes within one
    of each other, every partition's copies on distinct nodes, and with
    the rack rule the columns kept apart on different racks.

    The live nodes are laid out rack by rack (racks and their nodes in a
    seeded order); partition i's column c goes to position
    (j_i + c * live // C) mod live, j_i a seeded permutation.  Positions of
    one rack are contiguous and the columns lie live // C positions apart,
    more than a rack, so the copies of a partition land on different
    racks."""
    live = np.setdiff1d(np.arange(dep.nodes), out0)
    rack = dep.racks()[live]
    rack_order = rng.permutation(np.unique(rack))
    rank_of_rack = np.empty(rack.max() + 1, np.int64)
    rank_of_rack[rack_order] = np.arange(rack_order.size)
    layout = live[np.lexsort((rng.random(live.size), rank_of_rack[rack]))]
    n_live, n_cols = layout.size, len(dep.cols)
    step = n_live // n_cols
    if dep.rack_size and step < dep.rack_size:
        raise ValueError("too few live nodes to keep the copies apart")
    j = rng.permutation(dep.partitions) % n_live
    return np.stack([layout[(j + c * step) % n_live]
                     for c in range(n_cols)], axis=1).astype(np.int32)


class Chain:
    """The node lists of a chained mix, drawn from the seed: request k
    takes out ``out[k]`` (``count`` of the nodes live before it) and
    brings back ``out[k - 1]``; ``out[-1]`` is out in the start map.

    Lists are drawn in order as they are first asked for, from one
    generator, so they depend on the seed alone."""

    def __init__(self, dep: Deployment, count: int,
                 rng: np.random.Generator) -> None:
        self._n = dep.nodes
        self._count = count
        self._rng = rng
        self.first_out = self._draw(np.zeros(0, np.int64))
        self._outs: list = []

    def _draw(self, prev_out: np.ndarray) -> np.ndarray:
        live = np.setdiff1d(np.arange(self._n), prev_out)
        return np.sort(self._rng.choice(live, self._count, replace=False))

    def out(self, k: int) -> np.ndarray:
        """Node ids taken out by request k (k = -1: out at the start)."""
        if k < 0:
            return self.first_out
        while k >= len(self._outs):
            self._outs.append(self._draw(self._outs[-1] if self._outs
                                         else self.first_out))
        return self._outs[k]


def build(cfg: dict, traffic: dict, seed: int):
    """(Deployment, start assignment [P, C], Chain) for one run."""
    dep = Deployment.from_config(cfg)
    rng = np.random.default_rng(seed)
    chain_rng, map_rng = (np.random.default_rng(s)
                          for s in rng.bit_generator.seed_seq.spawn(2))
    chain = Chain(dep, out_count(dep, traffic), chain_rng)
    start = start_assignment(dep, chain.out(-1), map_rng)
    return dep, start, chain
