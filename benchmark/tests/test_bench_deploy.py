"""The deployment made from the seed: balanced start maps inside the
rules, and node lists that repeat for a seed."""

import numpy as np
import pytest

import _bench_path
import deploy
import reference

MIXES = _bench_path.mixes()


def _check_start(dep, start, out0):
    live = np.ones(dep.nodes, bool)
    live[out0] = False
    assert reference.violations(start, live, dep.racks(), dep.apart) == 0
    for c in range(start.shape[1]):
        per = np.bincount(start[:, c], minlength=dep.nodes)[live]
        assert per.max() - per.min() <= 1  # each column within one copy
    assert not np.isin(start, out0).any()


@pytest.mark.parametrize("cell", sorted(MIXES))
def test_start_map_balanced_and_in_rules_full_size(cell):
    w = MIXES[cell]
    cfg = deploy.load_json("configs", w["config"])
    traffic = deploy.load_json("traffic", w["traffic"])
    dep, start, chain = deploy.build(cfg, traffic, 2**31 + 5)
    assert start.shape == (dep.partitions, sum(dep.copies))
    assert chain.first_out.size == deploy.out_count(dep, traffic)
    _check_start(dep, start, chain.first_out)


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 7, 2**33 + 1])
def test_start_map_small_sizes(seed):
    cfg = deploy.load_json("configs", "northstar_100k_10k")
    cfg.update(partitions=3001, nodes=137)
    dep, start, chain = deploy.build(cfg, {"out_share": 0.05}, seed)
    _check_start(dep, start, chain.first_out)


@pytest.mark.parametrize("cell", sorted(MIXES))
def test_chain_repeats_for_a_seed(cell):
    w = MIXES[cell]
    cfg = deploy.load_json("configs", w["config"])
    traffic = deploy.load_json("traffic", w["traffic"])

    def lists(seed):
        _, start, chain = deploy.build(cfg, traffic, seed)
        return start, [chain.out(k) for k in range(-1, 12)]

    s1, a = lists(2**31 + 3)
    s2, b = lists(2**31 + 3)
    s3, c = lists(2**31 + 4)
    assert np.array_equal(s1, s2) and not np.array_equal(s1, s3)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    for prev, cur in zip(a, a[1:]):
        assert cur.size == prev.size
        assert not np.intersect1d(prev, cur).size
