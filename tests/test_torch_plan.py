"""The port's dense planner against the JAX package, on the CPU.

Same inputs through both packages, compared exactly: the auction's
building blocks, the converged solve on both score engines, the public
plan_next_map map for map, and host encode/decode array for array.  The
port runs with ``device="cpu"``, where every kernel takes its plain
PyTorch version; the reference runs under XLA on the CPU (matrix engine)
and with its Pallas kernel in interpret mode (fused engine).
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import blance_tpu  # noqa: E402
import blance_tpu_torch as bt  # noqa: E402
from blance_tpu.core import encode as jencode  # noqa: E402
from blance_tpu.plan import tensor as jtensor  # noqa: E402
from blance_tpu_torch.core import encode as tencode  # noqa: E402
from blance_tpu_torch.plan import tensor as ttensor  # noqa: E402
from blance_tpu_torch.plan.audit import check_assignment  # noqa: E402

CLEAN = {"duplicates": 0, "on_removed_nodes": 0,
         "unfilled_feasible_slots": 0, "hierarchy_misses": 0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread is faster and steadier than
    a pool that competes with the other test workers for the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


# --- auction building blocks ----------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_segment_accept_matches_jax(seed):
    rng = np.random.default_rng(seed)
    k, n = 200, 9
    node_s = np.sort(rng.integers(0, n + 1, k)).astype(np.int32)
    ok_s = rng.random(k) < 0.8
    w_s = np.where(ok_s, rng.integers(1, 4, k), 0).astype(np.float32)
    cap = rng.integers(-1, 12, n + 1).astype(np.float32)
    cap_here = cap[node_s]
    want = np.asarray(jtensor._segment_accept(
        jnp.asarray(node_s), jnp.asarray(ok_s), jnp.asarray(w_s),
        jnp.asarray(cap_here)))
    got = ttensor._segment_accept(_t(node_s), _t(ok_s), _t(w_s),
                                  _t(cap_here)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("trim", [False, True])
@pytest.mark.parametrize("taken", [False, True])
def test_pin_prev_holders_matches_jax(trim, taken):
    rng = np.random.default_rng(int(trim) * 2 + int(taken))
    p, n = 300, 12
    prev_slot = rng.integers(-1, n, p).astype(np.int32)
    pin_ok = rng.random(p) < 0.9
    pw = rng.integers(1, 3, p).astype(np.float32)
    cap = np.full(n, 80.0 if not trim else 30.0, np.float32)
    cap[3] = 0.0
    slack = np.full(p, 1.5, np.float32)
    div = rng.integers(1, 3, n).astype(np.float32)
    tk = rng.integers(-1, n, (p, 2)).astype(np.int32) if taken else None
    want = np.asarray(jtensor._pin_prev_holders(
        jnp.asarray(prev_slot), jnp.asarray(pin_ok), jnp.asarray(pw),
        jnp.asarray(cap), jnp.asarray(slack), None,
        load_div=jnp.asarray(div),
        taken_stack=None if tk is None else jnp.asarray(tk)))
    got = ttensor._pin_prev_holders(
        _t(prev_slot), _t(pin_ok), _t(pw), _t(cap), _t(slack),
        load_div=_t(div), taken_stack=None if tk is None else _t(tk))
    np.testing.assert_array_equal(got.numpy(), want)
    if trim:
        assert not want.all()  # the capacity trim really ran


# --- converged solve ----------------------------------------------------------------


def _dense_args(P, N, seed):
    """The rack-rule delta shape of bench.py's build_dense (racks of 25,
    one zone, 5% of nodes removed, replica on another rack); seed 2 adds
    whole-number partition and node weights."""
    rng = np.random.default_rng(seed)
    prev = np.full((P, 2, 1), -1, np.int32)
    prev[:, 0, 0] = rng.integers(0, N, P)
    prev[:, 1, 0] = (prev[:, 0, 0] + 1 + rng.integers(0, N - 1, P)) % N
    pw = np.ones(P, np.float32)
    nw = np.ones(N, np.float32)
    if seed == 2:
        pw[::7] = rng.integers(2, 5, len(pw[::7]))
        nw[::5] = rng.integers(2, 4, len(nw[::5]))
    valid = np.ones(N, bool)
    valid[rng.choice(N, N // 20, replace=False)] = False
    stick = np.full((P, 2), 1.5, np.float32)
    gids = np.stack([np.arange(N, dtype=np.int32),
                     np.arange(N, dtype=np.int32) // 25,
                     np.zeros(N, np.int32)])
    gv = np.ones((3, N), bool)
    return (prev, pw, nw, valid, stick, gids, gv), (1, 1), ((), ((2, 1),))


@functools.lru_cache(maxsize=None)
def _jax_solve(P, N, seed, engine):
    arrays, constraints, rules = _dense_args(P, N, seed)
    return np.asarray(jtensor.solve_dense_converged(
        *[jnp.asarray(a) for a in arrays], constraints, rules,
        fused_score=engine, record=False))


def _problem(arrays, constraints, rules):
    prev, pw, nw, valid, stick, gids, gv = arrays
    P, S, _ = prev.shape
    return tencode.DenseProblem(
        nodes=[str(i) for i in range(nw.shape[0])],
        partitions=[str(i) for i in range(P)],
        states=[f"s{i}" for i in range(S)],
        constraints=np.asarray(constraints, np.int32), prev=prev,
        partition_weights=pw, node_weights=nw, valid_node=valid,
        stickiness=stick, gids=gids, gid_valid=gv,
        rules={si: list(r) for si, r in enumerate(rules) if r})


@pytest.mark.parametrize("engine,ref_engine", [("off", "off"),
                                               ("on", "interpret")])
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("P,N", [(1024, 64), (4096, 256)])
def test_solve_dense_converged_matches_jax(P, N, seed, engine, ref_engine):
    arrays, constraints, rules = _dense_args(P, N, seed)
    want = _jax_solve(P, N, seed, ref_engine)
    stats = {}
    got = bt.assign_to_numpy(bt.solve_dense_converged(
        *bt.problem_to_torch(*arrays, device="cpu"), constraints, rules,
        fused_score=engine, stats=stats))
    diff = np.argwhere(got != want)
    assert diff.size == 0, f"first differing [p, s, r]: {diff[:3].tolist()}"
    assert stats["sweeps"] >= 2
    assert (got != arrays[0]).any()  # the delta really moved copies
    assert check_assignment(_problem(arrays, constraints, rules),
                            got) == CLEAN


# --- plan_next_map, map for map ------------------------------------------------------


def _rack_delta():
    rng = np.random.default_rng(0)
    nodes = [f"n{i:03d}" for i in range(100)]
    hier = {nd: f"r{i // 5:02d}" for i, nd in enumerate(nodes)}
    hier.update({f"r{i:02d}": "z0" for i in range(20)})
    prev = {}
    for p in range(600):
        a = int(rng.integers(0, 100))
        b = (a + 1 + int(rng.integers(0, 99))) % 100
        prev[str(p)] = blance_tpu.Partition(
            str(p), {"primary": [nodes[a]], "replica": [nodes[b]]})
    removed = [nodes[i] for i in rng.choice(100, 5, replace=False)]
    opts = dict(node_hierarchy=hier, hierarchy_rules={
        "replica": [("HR", 2, 1)]})
    return prev, nodes, removed, dict(primary=(0, 1), replica=(1, 1)), opts


def _weighted():
    rng = np.random.default_rng(1)
    nodes = [f"w{i}" for i in range(24)]
    prev = {}
    for p in range(400):
        a = int(rng.integers(0, 20))
        prev[f"p{p}"] = blance_tpu.Partition(
            f"p{p}", {"primary": [nodes[a]],
                      "replica": [nodes[(a + 3) % 20]]})
    opts = dict(
        partition_weights={f"p{p}": int(rng.integers(1, 5))
                           for p in range(0, 400, 3)},
        node_weights={nd: int(rng.integers(1, 4)) for nd in nodes[::2]},
        state_stickiness={"primary": 3, "replica": 2})
    return prev, nodes, [nodes[5]], dict(primary=(0, 1), replica=(1, 1)), \
        opts


def _multi_state():
    nodes = [f"m{i:02d}" for i in range(16)]
    prev = {str(p): blance_tpu.Partition(str(p), {}) for p in range(300)}
    return prev, nodes, [], dict(primary=(0, 1), replica=(1, 2),
                                 readonly=(2, 1)), {}


def _opts(lib, spec):
    spec = dict(spec)
    rules = spec.pop("hierarchy_rules", None)
    if rules:
        spec["hierarchy_rules"] = {
            s: [lib.HierarchyRule(inc, exc) for (_, inc, exc) in rl]
            for s, rl in rules.items()}
    return lib.PlanOptions(**spec)


@pytest.mark.parametrize("fixture", [_rack_delta, _weighted, _multi_state])
def test_plan_next_map_matches_jax(fixture):
    prev, nodes, removed, states, spec = fixture()
    jmodel = blance_tpu.model(**states)
    want_map, want_warn = blance_tpu.plan_next_map(
        prev, prev, nodes, removed, [], jmodel, _opts(blance_tpu, spec),
        backend="tpu")
    tprev = bt.partition_map_from_json(blance_tpu.partition_map_to_json(prev))
    got_map, got_warn = bt.plan_next_map(
        tprev, tprev, nodes, removed, [], bt.model(**states),
        _opts(bt, spec), backend="cuda", device="cpu")
    assert bt.partition_map_to_json(got_map) == \
        blance_tpu.partition_map_to_json(want_map)
    assert got_warn == want_warn
    opts = _opts(bt, spec)
    problem = tencode.encode_problem(tprev, tprev, nodes, removed,
                                     bt.model(**states), opts)
    after = tencode.encode_problem(got_map, got_map, nodes, removed,
                                   bt.model(**states), opts)
    assert check_assignment(problem, after.prev) == CLEAN


# --- host encode / decode -------------------------------------------------------------


def test_encode_decode_match_jax():
    prev, nodes, removed, states, spec = _rack_delta()
    prev = dict(prev)
    # Unmodeled and zero-constraint states take decode's passthrough path.
    prev["7"] = blance_tpu.Partition("7", {
        "primary": [nodes[1]], "replica": [nodes[2], nodes[3]],
        "dead": [nodes[4], removed[0]]})
    states = dict(states, standby=(3, 0))
    jp = jencode.encode_problem(prev, prev, nodes, removed,
                                blance_tpu.model(**states),
                                _opts(blance_tpu, spec))
    tprev = bt.partition_map_from_json(blance_tpu.partition_map_to_json(prev))
    tp = tencode.encode_problem(tprev, tprev, nodes, removed,
                                bt.model(**states), _opts(bt, spec))
    for name in ("nodes", "partitions", "states", "rules"):
        assert getattr(tp, name) == getattr(jp, name), name
    for name in ("constraints", "prev", "partition_weights", "node_weights",
                 "valid_node", "stickiness", "gids", "gid_valid"):
        g, w = getattr(tp, name), getattr(jp, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    rng = np.random.default_rng(4)
    assign = rng.integers(-1, len(nodes), jp.prev.shape).astype(np.int32)
    want_map, want_warn = jencode.decode_assignment(jp, assign, prev, removed)
    got_map, got_warn = tencode.decode_assignment(tp, assign, tprev, removed)
    assert bt.partition_map_to_json(got_map) == \
        blance_tpu.partition_map_to_json(want_map)
    assert got_warn == want_warn


def test_engine_choice_and_memory_guard_on_cpu():
    cpu = torch.device("cpu")
    # No kernel on the CPU: auto is the matrix engine, like the reference
    # without Pallas; explicit modes pass through.
    assert ttensor.resolve_fused_score("auto", 10**6, 10**5, cpu) == "off"
    assert ttensor.resolve_fused_score("on", 8, 8, cpu) == "on"
    with pytest.raises(ttensor.DenseScoreMemoryError) as e:
        ttensor.check_dense_memory(10**6, 2, 10**5, "off", cpu)
    assert e.value.shape == (10**6, 2, 10**5)
    ttensor.check_dense_memory(10**6, 2, 10**5, "on", cpu)
    ttensor.check_dense_memory(1024, 2, 64, "off", cpu)
    with pytest.raises(ValueError):
        ttensor.set_fused_score_default("interpret")
