"""A decode fixture whose states have different widths, as in the
multiprimary deployment: shared by the decode parity tests against the
JAX package and the device-pack tests."""

import numpy as np


def multiprimary_problem(lib, P=120, N=12, seed=7):
    """Two primaries, a replica and a read-only copy a partition, each on
    its own node: one state two copies wide and two one copy wide, so
    every row is as wide as the primaries' two slots."""
    rng = np.random.default_rng(seed)
    nodes = [f"n{i}" for i in range(N)]
    model = {
        "primary": lib.PartitionModelState(0, 2),
        "replica": lib.PartitionModelState(1, 1),
        "readonly": lib.PartitionModelState(2, 1),
    }
    prev = {}
    for i in range(P):
        held = [nodes[j] for j in rng.permutation(N)[:4]]
        prev[str(i)] = lib.Partition(str(i), {
            "primary": held[:2], "replica": held[2:3],
            "readonly": held[3:4]})
    return prev, nodes, model


def multi_width_assign(assign, case):
    """A copy of a [P, 3, 2] multiprimary assignment, for ``case``:
    ``full`` as it is; ``short`` with rows short of their constraint
    (a primary's first slot or second slot empty, replicas and read-only
    copies missing); ``over`` with those and one replica row filled
    beyond its constraint, so the other replica rows are trimmed to one."""
    assign = assign.copy()
    if case in ("short", "over"):
        assign[::5, 0, 1] = -1
        assign[3::11, 0, 0] = -1
        assign[::7, 1, 0] = -1
        assign[2::9, 2, :] = -1
    if case == "over":
        assign[4, 1, 1] = assign[4, 0, 0]
    return assign
