"""The port's node-axis (2-D parts x nodes) sharded solves against the
JAX package, on the CPU.

On a 2-D mesh every [P, N] intermediate is split over both axes while
the [N] vectors stay replicated along the node axis; per-row min2 stats
combine by an all_gather whose tie-break is the lowest shard, and a
remote column read rides a masked psum.  The reference runs
``solve_dense_sharded`` on 2-D meshes of the 8 virtual CPU devices; the
port runs ``make_mesh_2d(..., device="cpu")`` on worker processes over
gloo.  Maps, warm decisions and carry tables must be equal bit for bit,
matrix and fused (the reference's "interpret"), cold and warm.  Also the
reference's "THE 2-D contract" on the port alone: a (k, m) mesh gives
the (k,) mesh's map bit for bit, and node padding (N not divisible by
the node shards) never places a pad node.  Rank numbering: rank =
parts_idx * node_shards + node_idx.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from blance_tpu.parallel import sharded as jsh  # noqa: E402
from blance_tpu.plan import tensor as jtensor  # noqa: E402
from blance_tpu_torch.parallel import sharded as tsh  # noqa: E402
from blance_tpu_torch.plan import tensor as ttensor  # noqa: E402
from test_torch_sparse import _dense_args  # noqa: E402

# (shape, port engine, reference engine): every shape on the matrix
# engine, the fused engine on one (each reference call recompiles its
# shard_map, seconds apiece).
COLD = [pytest.param(s, "off", "off", id=f"{s[0]}x{s[1]}-matrix")
        for s in ((2, 2), (4, 2), (1, 8))] + \
    [pytest.param((2, 4), "on", "interpret", id="2x4-fused")]
P, N = 150, 20


@pytest.fixture(scope="module")
def pool():
    mesh = tsh.make_mesh(8, device="cpu", timeout=60)
    yield mesh
    mesh.close()


def _args(seed=0, n=N):
    return _dense_args(P, n, seed, rack=5)


@pytest.mark.parametrize("shape,engine,ref_engine", COLD)
def test_2d_cold_bitwise(pool, shape, engine, ref_engine):
    arrays, cons, rules = _args()
    want = jsh.solve_dense_sharded(jsh.make_mesh_2d(*shape), *arrays, cons,
                                   rules, fused_score=ref_engine)
    with tsh.make_mesh_2d(*shape, devices=pool) as mesh:
        assert mesh.axis_names == ("parts", "nodes")
        assert mesh.devices.shape == shape
        stats = {}
        got = tsh.solve_dense_sharded(mesh, *arrays, cons, rules,
                                      fused_score=engine, stats=stats)
    assert np.array_equal(got, want)
    by_axis = stats["mesh"]["stats"][0]["by_axis"]
    assert by_axis.get("nodes", 0) > 0 and by_axis["parts"] > 0


@pytest.mark.parametrize("shape,engine,ref_engine", [
    ((2, 4), "on", "interpret")], ids=["2x4-fused"])
def test_2d_warm_bitwise(pool, shape, engine, ref_engine):
    arrays, cons, rules = _args(1)
    with tsh.make_mesh_2d(*shape, devices=pool) as mesh:
        base = tsh.solve_dense_sharded(mesh, *arrays, cons, rules,
                                       fused_score=engine)
        victim = int(base[0, 0, 0])
        valid2 = arrays[3].copy()
        valid2[victim] = False
        dirty = (base == victim).any(axis=(1, 2))
        carry = ttensor.carry_from_assignment(
            base, torch.from_numpy(arrays[1]), torch.from_numpy(arrays[2]))
        got = tsh.solve_dense_sharded(
            mesh, base, arrays[1], arrays[2], valid2, *arrays[4:], cons,
            rules, fused_score=engine, dirty=dirty, carry=carry,
            return_carry=True, warm_only=True)
    jcarry = jtensor.carry_from_assignment(
        base, jnp.asarray(arrays[1]), jnp.asarray(arrays[2]))
    want = jsh.solve_dense_sharded(
        jsh.make_mesh_2d(*shape), base, arrays[1], arrays[2], valid2,
        *arrays[4:], cons, rules, fused_score=ref_engine, dirty=dirty,
        carry=jcarry, return_carry=True, warm_only=True)
    assert (got[0] is None) == (want[0] is None)
    if want[0] is not None:
        assert np.array_equal(got[0], np.asarray(want[0]))
        assert np.array_equal(got[1].used.numpy(), np.asarray(want[1].used))


@pytest.mark.parametrize("parts,nodes", [(2, 2), (2, 4), (4, 2), (1, 8)])
def test_node_shard_count_invariance(pool, parts, nodes):
    """THE 2-D contract: adding node shards never changes the answer —
    the (k, m) map is the (k,) map bit for bit."""
    arrays, cons, rules = _args(4)
    with tsh.make_mesh(parts, devices=pool) as flat, \
            tsh.make_mesh_2d(parts, nodes, devices=pool) as grid:
        base = tsh.solve_dense_sharded(flat, *arrays, cons, rules)
        got = tsh.solve_dense_sharded(grid, *arrays, cons, rules)
    assert np.array_equal(base, got)


def test_2d_node_padding_bitwise(pool):
    """N = 18 does not divide over 4 node shards: pad columns are invalid
    nodes that are never chosen, and the map equals the reference's."""
    arrays, cons, rules = _args(5, n=18)
    want = jsh.solve_dense_sharded(jsh.make_mesh_2d(2, 4), *arrays, cons,
                                   rules)
    with tsh.make_mesh_2d(2, 4, devices=pool) as mesh:
        got = tsh.solve_dense_sharded(mesh, *arrays, cons, rules)
    assert np.array_equal(got, want)
    assert got.max() < 18 and (got >= 0).all()


def test_2d_hierarchy_rules_off_the_counting_floor(pool):
    """A rule whose exclude level is not finer than its include level
    takes the matrix floor (the node-axis pmin and masked-psum column
    read): equal to the 1-D mesh's map."""
    arrays, cons, _ = _args(6)
    rules = ((), ((1, 1),))
    with tsh.make_mesh(2, devices=pool) as flat, \
            tsh.make_mesh_2d(2, 4, devices=pool) as grid:
        base = tsh.solve_dense_sharded(flat, *arrays, cons, rules)
        stats = {}
        got = tsh.solve_dense_sharded(grid, *arrays, cons, rules,
                                      stats=stats)
    assert np.array_equal(base, got)
    assert stats["mesh"]["stats"][3]["by_axis"]["nodes"] > 0
