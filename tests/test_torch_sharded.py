"""The port's partition-sharded solves against the JAX package, on the CPU.

The reference runs ``solve_dense_sharded`` on 1-D meshes of the 8
virtual CPU devices that tests/conftest.py sets up; the port runs the
same inputs on ``make_mesh(..., device="cpu")``, a mesh of worker
processes joined by gloo.  Maps, warm decisions and carry tables must
be equal bit for bit, on the matrix engine and the in-kernel score
(the reference's "interpret" mode, the port's plain version), cold and
warm.  Exact equality holds across the two packages at the same mesh
size, never across mesh sizes: per-shard capacity quotas change the
auction (tests/test_sharded.py).

The reference's own ``solve_sparse_sharded`` cannot run at jax 0.9.0
(its ``lax.cond`` fails shard_map's varying-axes check), so the port's
sparse sharded solve is held by the property that reference test
states: at K = N it equals the dense sharded solve bit for bit, cold and
warm; below K = N it passes the audit.

Also here: the pure helpers (``mesh_shape_for``, ``slice_major_order``,
``pad_partitions``, ``pad_nodes``, the layout tables) against the
reference's, and the mesh itself: a worker's exception reaches rank 0,
a rank that skips a collective fails the call within the group timeout
naming that rank, and no worker outlives ``close()``.  One 8-rank mesh
serves the module; the smaller meshes run on its first ranks.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from blance_tpu.parallel import sharded as jsh  # noqa: E402
from blance_tpu.plan import tensor as jtensor  # noqa: E402
from blance_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from blance_tpu_torch.parallel import sharded as tsh  # noqa: E402
from blance_tpu_torch.plan import tensor as ttensor  # noqa: E402
from test_torch_sparse import _dense_args  # noqa: E402

# (ranks, port engine, reference engine): every mesh size on the matrix
# engine, the fused engine on one (each reference call recompiles its
# shard_map, seconds apiece).
COLD = [pytest.param(r, "off", "off", id=f"matrix-{r}") for r in (2, 4, 8)] \
    + [pytest.param(8, "on", "interpret", id="fused-8")]
WARM = [pytest.param(2, "off", "off", id="matrix-2"),
        pytest.param(4, "on", "interpret", id="fused-4")]
P, N = 150, 20  # P divides none of 4 and 8: the padding rows run too


@pytest.fixture(scope="module")
def pool():
    mesh = tsh.make_mesh(8, device="cpu", timeout=60)
    yield mesh
    mesh.close()


def _args(seed=0):
    arrays, cons, rules = _dense_args(P, N, seed, rack=5)
    return arrays, cons, rules


def _ref_carry(assign, arrays):
    return jtensor.carry_from_assignment(
        assign, jnp.asarray(arrays[1]), jnp.asarray(arrays[2]))


def _port_carry(assign, arrays):
    return ttensor.carry_from_assignment(
        assign, torch.from_numpy(arrays[1]), torch.from_numpy(arrays[2]))


def _delta(arrays, base):
    """One held node goes: the next valid mask and the dirty rows."""
    victim = int(base[0, 0, 0])
    valid2 = arrays[3].copy()
    valid2[victim] = False
    dirty = (base == victim).any(axis=(1, 2))
    return arrays[:3] + (valid2,) + arrays[4:], dirty


@pytest.mark.parametrize("ranks,engine,ref_engine", COLD)
def test_dense_sharded_cold_bitwise(pool, ranks, engine, ref_engine):
    arrays, cons, rules = _args()
    want = jsh.solve_dense_sharded(jsh.make_mesh(ranks), *arrays, cons,
                                   rules, fused_score=ref_engine)
    with tsh.make_mesh(ranks, devices=pool) as mesh:
        stats = {}
        got = tsh.solve_dense_sharded(mesh, *arrays, cons, rules,
                                      fused_score=engine, stats=stats)
    assert np.array_equal(got, want)
    assert stats["sweeps"] >= 1 and stats["engine"] == engine
    per_rank = stats["mesh"]["stats"]
    assert sorted(per_rank) == list(range(ranks))
    assert len({s["collectives"] for s in per_rank.values()}) == 1


@pytest.mark.parametrize("ranks,engine,ref_engine", WARM)
def test_dense_sharded_warm_bitwise(pool, ranks, engine, ref_engine):
    """The warm repair with dirty + carry: accept or decline equal, maps
    equal, the carry's fill tables equal; ``warm_only`` returns
    (None, None) on both sides together.  The base map is the port's
    cold solve (bitwise the reference's, test above)."""
    arrays, cons, rules = _args(1)
    with tsh.make_mesh(ranks, devices=pool) as mesh:
        base = tsh.solve_dense_sharded(mesh, *arrays, cons, rules,
                                       fused_score=engine)
        arrays2, dirty = _delta(arrays, base)
        got = tsh.solve_dense_sharded(
            mesh, base, *arrays2[1:], cons, rules, fused_score=engine,
            dirty=dirty, carry=_port_carry(base, arrays), return_carry=True,
            warm_only=True)
    want = jsh.solve_dense_sharded(
        jsh.make_mesh(ranks), base, *arrays2[1:], cons, rules,
        fused_score=ref_engine, dirty=dirty, carry=_ref_carry(base, arrays),
        return_carry=True, warm_only=True)
    assert (got[0] is None) == (want[0] is None)
    if want[0] is not None:
        assert np.array_equal(got[0], np.asarray(want[0]))
        assert np.array_equal(got[1].used.numpy(),
                              np.asarray(want[1].used))
        assert np.array_equal(got[1].assign.numpy(),
                              np.asarray(want[1].assign))


def test_dense_sharded_warm_falls_back_to_cold_bitwise(pool):
    """Without ``warm_only`` a declined repair runs the cold fixpoint:
    the returned map and carry equal the reference's either way."""
    arrays, cons, rules = _args(3)
    with tsh.make_mesh(4, devices=pool) as mesh:
        base = tsh.solve_dense_sharded(mesh, *arrays, cons, rules)
        # A held node goes but no row is dirty: the repair ripples and
        # is declined.
        arrays2, _ = _delta(arrays, base)
        dirty = np.zeros(P, bool)
        got, gc = tsh.solve_dense_sharded(
            mesh, base, *arrays2[1:], cons, rules, dirty=dirty,
            carry=_port_carry(base, arrays), return_carry=True)
    want, wc = jsh.solve_dense_sharded(
        jsh.make_mesh(4), base, *arrays2[1:], cons, rules, dirty=dirty,
        carry=_ref_carry(base, arrays), return_carry=True)
    assert np.array_equal(got, want)
    assert np.array_equal(gc.used.numpy(), np.asarray(wc.used))


def test_one_rank_mesh_equals_unsharded(pool):
    """A 1-rank mesh is the unsharded solve bit for bit, in the port as
    in the reference (checked here against the reference's make_mesh(1)
    and its unsharded solve_dense_converged)."""
    arrays, cons, rules = _args(1)
    ref_one = jsh.solve_dense_sharded(jsh.make_mesh(1), *arrays, cons, rules)
    ref_flat = np.asarray(jtensor.solve_dense_converged(
        *(jnp.asarray(a) for a in arrays), cons, rules))
    assert np.array_equal(ref_one, ref_flat)
    with tsh.make_mesh(1, devices=pool) as mesh:
        got = tsh.solve_dense_sharded(mesh, *arrays, cons, rules)
    flat = ttensor.solve_dense_converged(
        *(torch.from_numpy(a) for a in arrays), cons, rules).numpy()
    assert np.array_equal(got, flat) and np.array_equal(got, ref_one)


@pytest.mark.parametrize("case", ["cold", "warm"])
def test_sparse_sharded_saturating_k_equals_dense(pool, case):
    """The property of tests/test_sparse.py's sharded case: at K = N the
    sparse sharded solve is the dense sharded one bit for bit (cold, and
    the warm repair with the same carry)."""
    arrays, cons, rules = _args(2 if case == "cold" else 0)
    with tsh.make_mesh(4, devices=pool) as mesh:
        dense = tsh.solve_dense_sharded(mesh, *arrays, cons, rules)
        if case == "cold":
            stats = {}
            sparse = tsh.solve_sparse_sharded(mesh, *arrays, cons, rules,
                                              k=N, stats=stats)
            assert np.array_equal(dense, sparse)
            assert stats["k"] == N and stats["exhausted_rows"] == 0
            return
        arrays2, dirty = _delta(arrays, dense)
        wd = tsh.solve_dense_sharded(
            mesh, dense, *arrays2[1:], cons, rules, dirty=dirty,
            carry=_port_carry(dense, arrays), warm_only=True)
        ws = tsh.solve_sparse_sharded(
            mesh, dense, *arrays2[1:], cons, rules, k=N, dirty=dirty,
            carry=_port_carry(dense, arrays), warm_only=True)
    assert (wd is None) == (ws is None)
    if wd is not None:
        assert np.array_equal(wd, ws)


def test_sparse_sharded_below_k_audit_clean(pool):
    arrays, cons, rules = _dense_args(512, 64, 0, rack=8)
    with tsh.make_mesh(8, devices=pool) as mesh:
        stats = {}
        got = tsh.solve_sparse_sharded(mesh, *arrays, cons, rules, k=12,
                                       stats=stats)
    prev, pw, nw, valid, stick, gids, gv = arrays
    assert (got >= 0).all()
    assert valid[got].all()
    assert (got[:, 0, 0] != got[:, 1, 0]).all()
    rack = gids[1]
    assert (rack[got[:, 0, 0]] != rack[got[:, 1, 0]]).all()
    assert stats["k"] == 12 and stats["sweeps"] >= 1
    with pytest.raises(ValueError, match="node-axis"):
        with tsh.make_mesh_2d(2, 2, devices=pool) as m2:
            tsh.solve_sparse_sharded(m2, *arrays, cons, rules, k=12)


# --- the pure helpers ---------------------------------------------------------


@pytest.mark.parametrize("n_dev,p,n", [
    (1, 100, 10), (8, 100_000, 10_000), (8, 1_000_000, 1_000_000),
    (6, 300_000, 40_000), (4, 10, 70_000), (16, 5_000_000, 5_000),
    (64, 100_000_000, 100_000), (7, 1, 1)])
def test_mesh_shape_for_matches_reference(n_dev, p, n):
    got = tsh.mesh_shape_for(n_dev, p, n)
    assert got == jsh.mesh_shape_for(n_dev, p, n)
    assert got[0] * got[1] == n_dev
    small = tsh.mesh_shape_for(n_dev, p, n, part_cap=64, node_cap=8)
    assert small == jsh.mesh_shape_for(n_dev, p, n, part_cap=64,
                                       node_cap=8)


@pytest.mark.parametrize("ids", [[1, 0, 1, 0], [0, 0, 1, 1],
                                 [2, 0, 1, 0, 2, 1], [0] * 5, []])
def test_slice_major_order_matches_reference(ids):
    assert tsh.slice_major_order(ids) == jsh.slice_major_order(ids)


@pytest.mark.parametrize("fn", ["pad_partitions", "pad_nodes"])
@pytest.mark.parametrize("multiple", [1, 3, 4, 8])
def test_padding_helpers_match_reference(fn, multiple):
    rng = np.random.default_rng(multiple)
    for arr, fill in ((np.arange(6, dtype=np.int32), -1),
                      (rng.random((5, 7)).astype(np.float32), 0.0),
                      (np.ones((2, 6), bool), False)):
        got = getattr(tsh, fn)(arr, multiple, fill)
        want = getattr(jsh, fn)(arr, multiple, fill)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("table", [
    "SOLVER_IN_LAYOUT", "WARM_EXTRA_LAYOUT", "SPARSE_EXTRA_LAYOUT",
    "SPARSE_COLD_OUT_LAYOUT", "SPARSE_WARM_OUT_LAYOUT",
    "PIPELINE_COLD_OUT_LAYOUT", "PIPELINE_WARM_OUT_LAYOUT"])
def test_layout_tables_match_reference(table):
    got, want = getattr(tsh, table), getattr(jsh, table)
    assert got == want
    kinds = tsh.layout_specs(got)
    specs = jsh.layout_specs(want)
    assert kinds == tuple("parts" if s == jsh.P(jsh.PARTITION_AXIS)
                          else "replicated" for s in specs)


def test_layout_specs_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown kind"):
        tsh.layout_specs((("x", "nodes"),))


def test_hybrid_mesh_orders_slice_major(pool):
    """Slice-major device order; the logical result is the flat mesh's
    (shard i owns rows i*P/W.. whichever device hosts it)."""
    with tsh.make_hybrid_mesh(devices=[0, 1, 2, 3], slice_ids=[1, 0, 1, 0],
                              device="cpu") as mesh, \
            tsh.make_mesh(4, devices=pool) as flat:
        assert mesh.axis_names == ("parts",)
        assert mesh.devices.tolist() == [1, 3, 0, 2]
        arrays, cons, rules = _args()
        got = tsh.solve_dense_sharded(mesh, *arrays, cons, rules)
        want = tsh.solve_dense_sharded(flat, *arrays, cons, rules)
    assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="slice ids"):
        tsh.make_hybrid_mesh(devices=[0, 1], slice_ids=[0], device="cpu")


@pytest.mark.parametrize("p,n", [(100, 10), (10_000_000, 100)])
def test_make_mesh_auto_follows_mesh_shape_for(p, n):
    """One device: a 1-D mesh whatever the problem (the only
    factorization of 1); the shape rule itself is held above."""
    with tsh.make_mesh_auto(p, n, devices=[0], device="cpu") as mesh:
        assert mesh.axis_names == ("parts",)
        assert mesh.devices.shape == (1,)
        assert mesh.backend == "gloo"
    assert tsh.mesh_shape_for(1, p, n) == (1, 1)


# --- the mesh itself ----------------------------------------------------------


def test_mesh_surface(pool):
    assert pool.axis_names == ("parts",)
    assert pool.devices.shape == (8,)
    assert dict(zip(pool.axis_names, pool.devices.shape)) == {"parts": 8}
    assert pool.backend == "gloo" and pool.kind == "cpu"
    assert tmesh.backend_for("cpu", [0, 0]) == "gloo"
    with pytest.raises(ValueError, match="need 16"):
        tsh.make_mesh_2d(4, 4, devices=pool)


def test_mesh_on_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tsh.make_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tmesh.Mesh((1,), device="cuda")


def test_worker_exception_reaches_rank0(pool):
    with tsh.make_mesh(4, devices=pool) as mesh:
        x = np.arange(8, dtype=np.float32)
        with pytest.raises(tmesh.MeshError, match="probe failure on rank 2"):
            mesh.shard_map("probe.raise", (x,), (("x", "parts"),),
                           (("x", "parts"),), rank=2)
        # No collective diverged, so the mesh still serves.
        out, = mesh.shard_map("probe.psum", (x,), (("x", "parts"),),
                              (("x", "parts"),))
    assert out.tolist() == [12.0, 16.0] * 4


def test_skipped_collective_fails_naming_the_rank():
    """A rank that skips a psum the others run: the call fails inside
    the group timeout with the rank named, the mesh refuses further
    calls, and close() leaves no worker behind."""
    mesh = tsh.make_mesh(3, device="cpu", timeout=3)
    pids = mesh.worker_pids()
    assert len(pids) == 2
    x = np.ones(3, np.float32)
    with pytest.raises(tmesh.MeshError,
                       match=r"probe\.psum.*rank 1 made 0") as info:
        mesh.shard_map("probe.psum", (x,), (("x", "parts"),),
                       (("x", "parts"),), skip_rank=1)
    assert "collective counts diverged" in str(info.value)
    with pytest.raises(tmesh.MeshError, match="broken"):
        mesh.shard_map("probe.psum", (x,), (("x", "parts"),),
                       (("x", "parts"),))
    mesh.close()
    assert mesh.worker_pids() == []
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_close_stops_workers_and_views_keep_pool(pool):
    view = tsh.make_mesh_2d(2, 2, devices=pool)
    view.close()
    assert len(pool.worker_pids()) == 7  # a view leaves the workers
    with pytest.raises(tmesh.MeshError, match="closed"):
        view.shard_map("probe.psum", (np.ones(2, np.float32),),
                       (("x", "parts"),), (("x", "parts"),))
    own = tsh.make_mesh(2, device="cpu")
    pids = own.worker_pids()
    with own:
        pass
    assert own.worker_pids() == []
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_mesh_argument_rejected_unless_a_port_mesh():
    with pytest.raises(TypeError, match="must be a blance_tpu_torch"):
        tsh.check_mesh(object(), "solve_fleet")
