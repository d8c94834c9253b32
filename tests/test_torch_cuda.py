"""The port's CUDA kernels against their plain PyTorch versions, on a card.

CUDA kernels have no CPU mode, so every test here is marked ``cuda`` and
skips without a GPU.  Run them on a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -q

No jax here: the machine with the card has none.  The CPU parity of the
plain versions against the JAX package lives in tests/test_torch_ops.py
and tests/test_torch_plan.py.
"""

import os

import numpy as np
import pytest
import torch

from blance_tpu_torch import (problem_to_torch, solve_dense_converged,
                              solve_sparse)
from blance_tpu_torch.ops import launch_counts, reset_launch_counts
from blance_tpu_torch.ops import reduce2, score_fused, sparse2

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
    assert len(got) == len(want)


@pytest.fixture(params=["picked", "wide"])
def layout(request, monkeypatch):
    """Runs a test in the layouts the wrappers pick and, with the lane
    tables emptied, in the wide ones that rows past the tables take (a
    block a row; the 16-row tile)."""
    if request.param == "wide":
        monkeypatch.setattr(reduce2, "LANES_BY_N", ())
        monkeypatch.setattr(reduce2, "LANES_BY_N_SCALAR", ())
        monkeypatch.setattr(score_fused, "FUSED_LANES_BY_N", ())
    return request.param


def _min2_name(n, batched, vec=None):
    """The ``variants`` name of the min2 layout taken at N = n, on
    operands that take float4 loads where ``n % 4 == 0`` (or as ``vec``
    says)."""
    if reduce2.min2_lanes(n, n % 4 == 0 if vec is None else vec):
        return "batched_rows_per_warp" if batched else "rows_per_warp"
    return "batched" if batched else "block_per_row"


def _fused_name(n, nrules, r, t, a, batched=False):
    """The ``variants`` name of the in-kernel score launch at N = n."""
    name = score_fused.fused_variant(nrules, r, t, a)
    if score_fused.fused_lanes(n, nrules, r, t, a):
        name += "_rows_per_warp"
    return "batched_" + name if batched else name


@pytest.mark.parametrize("shape,quant", [((130, 300), False),
                                         ((67, 513), True), ((5, 1), False)])
def test_min2_kernel_matches_plain(dev, shape, quant, layout):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(shape, generator=g)
    if quant:
        x = torch.floor(x * 3) * 0.125
    x[::4] = float("inf")
    x = x.to(dev)
    price = torch.linspace(0, 2, shape[1], device=dev)
    reset_launch_counts()
    got = reduce2.priced_min2_argmin(x, price)
    assert reduce2.priced_min2_argmin.variants == {
        _min2_name(shape[1], False): 1}
    _same(got, reduce2.min2_argmin_reference(x + price[None, :]))


def _fused_inputs(dev, seed, P, N, R, T, A, nrules, total_p=None,
                  n_real=None):
    """Random in-kernel score inputs; ``total_p`` (default P) is the fill
    term's partition count, a 0-d tensor for a bucketed solve's p_real,
    and columns from ``n_real`` on are invalid pad nodes."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
    rack = rng.integers(0, 5, N).astype(np.int32)
    gids = t(np.stack([np.arange(N, dtype=np.int32), rack, rack // 3]))
    taken = rng.integers(-1, N, (P, T)).astype(np.int32)
    valid = rng.random(N) < 0.85
    valid[N if n_real is None else n_real:] = False
    si = score_fused.pack_score_inputs(
        total_l=t(rng.integers(0, 60, N).astype(np.float32)),
        total_p=P if total_p is None else total_p,
        w_div_l=t(rng.integers(1, 4, N).astype(np.float32)),
        neg_boost_l=t(np.where(rng.random(N) < 0.3, 2.0, 0.0)
                      .astype(np.float32)),
        valid_l=t(valid),
        stickiness_si=t(np.full(P, 1.5, np.float32)),
        prev_slot=t(rng.integers(-1, N, P).astype(np.int32)),
        prev_state=t(rng.integers(-1, N, (P, R)).astype(np.int32)),
        taken_ids=[t(taken[:, k]) for k in range(T)],
        anchors=t(rng.integers(-1, N, (P, A)).astype(np.int32)),
        gids_l=gids, gid_valid=t(rng.random((3, N)) < 0.9), gids=gids,
        rules=((2, 1), (1, 0))[:nrules])
    price = t((rng.random(N) + np.where(rng.random(N) < 0.2, 1e9, 0))
              .astype(np.float32))
    return price, si


@pytest.mark.parametrize("nrules", [0, 1, 2])
def test_fused_kernel_matches_plain(dev, nrules, layout):
    price, si = _fused_inputs(dev, nrules, 300, 257, 2, 3, 2, nrules)
    reset_launch_counts()
    got = score_fused.fused_score_min2(price, si, 7, 0, nrules=nrules,
                                       jitter_scale=1e-5)
    assert score_fused.fused_score_min2.variants == {
        _fused_name(257, nrules, 2, 3, 2): 1}
    _same(got, score_fused.fused_score_min2_reference(
        price, si, 7, 0, nrules=nrules, jitter_scale=1e-5))


@pytest.mark.parametrize("widths", list(score_fused.FUSED_VARIANTS)
                         + [(2, 2, 2, 2)])
@pytest.mark.parametrize("P", [300, 5])
def test_fused_kernel_every_instantiation(dev, widths, P, layout):
    """Each fixed-width instantiation and the runtime-width one (nrules =
    2, R = 2, T = 2), with a ragged last row tile (P % 16 != 0) and a
    tile shorter than a tile's rows; a row base and a column offset as a
    caller with a window of rows and columns passes them."""
    nrules, R, T, A = widths
    price, si = _fused_inputs(dev, P + nrules, P, 1003, R, T, max(A, 1),
                              nrules)
    name = score_fused.fused_variant(nrules, R, T, max(A, 1))
    assert name == ("generic" if widths == (2, 2, 2, 2) else
                    "n%dr%dt%da%d" % widths)
    reset_launch_counts()
    got = score_fused.fused_score_min2(price, si, 11, 40, nrules=nrules,
                                       jitter_scale=1e-5)
    assert score_fused.fused_score_min2.variants == {
        _fused_name(1003, nrules, R, T, max(A, 1)): 1}
    _same(got, score_fused.fused_score_min2_reference(
        price, si, 11, 40, nrules=nrules, jitter_scale=1e-5))


@pytest.mark.parametrize("variant", ["n1r1t2a2", "generic"])
@pytest.mark.parametrize("where", ["all", "head"])
def test_fused_kernel_inf_prices(dev, variant, where, layout):
    """+inf prices: every row all +inf (idx 0, raw NaN), and the first
    columns +inf, so some threads see only +inf."""
    widths = (1, 1, 2, 2) if variant != "generic" else (1, 2, 2, 2)
    price, si = _fused_inputs(dev, 3, 37, 603, *widths[1:], widths[0])
    if where == "all":
        price[:] = float("inf")
    else:
        price[:300] = float("inf")
    reset_launch_counts()
    got = score_fused.fused_score_min2(price, si, 0, 0, nrules=1,
                                       jitter_scale=1e-5)
    assert score_fused.fused_score_min2.variants == {
        _fused_name(603, *widths): 1}
    assert score_fused.fused_variant(*widths) == variant
    _same(got, score_fused.fused_score_min2_reference(
        price, si, 0, 0, nrules=1, jitter_scale=1e-5))


def _sparse_inputs(shape, seed=2):
    g = torch.Generator().manual_seed(seed)
    score = torch.randint(0, 6, shape, generator=g).to(torch.float32) * 0.125
    price = torch.randint(0, 3, shape, generator=g).to(torch.float32) * 0.25
    if shape[1] > 4:
        score[:, -3:] = float("inf")
    score[::5] = float("inf")
    return score, price


@pytest.mark.parametrize("shape", [(2048, 16), (4099, 37), (7, 1)])
def test_sparse_min2_kernel_matches_plain(dev, shape):
    """All four outputs, bitwise: quantized scores (many ties), +inf pad
    columns and all-+inf rows."""
    score, price = _sparse_inputs(shape)
    score, price = score.to(dev), price.to(dev)
    before = sparse2.sparse_priced_min2.launches
    got = sparse2.sparse_priced_min2(score, price)
    assert sparse2.sparse_priced_min2.launches == before + 1
    _same(got, sparse2.sparse_min2_reference(score, price))


@pytest.mark.parametrize("shape,offset", [((2048, 16), 0), ((4099, 37), 0),
                                          ((7, 1), 0), ((130, 32), 0),
                                          ((130, 16), 1)])
def test_sparse_min2_cand_kernel_matches_plain(dev, shape, offset):
    """The gathered instantiation, all five outputs bitwise: -1 pad
    columns, ids >= N, repeated ids, all-+inf rows; ragged K takes the
    4-byte loads, and so does a [P, 16] view that starts 4 bytes past a
    16-byte boundary."""
    n = 50
    score, _ = _sparse_inputs(shape, seed=3)
    g = torch.Generator().manual_seed(4)
    cand = torch.randint(0, n, shape, generator=g).to(torch.int32)
    if shape[1] > 4:
        cand[::3, -2:] = -1
        cand[1::7, 0] = n + 3
        cand[2::5, 1] = cand[2::5, 0]
    price_n = torch.randint(0, 4, (n,), generator=g).to(torch.float32) * 0.5
    price_n[::9] = 1e9
    score, price_n = score.to(dev), price_n.to(dev)
    buf = torch.empty(cand.numel() + offset, dtype=torch.int32, device=dev)
    cand = buf[offset:].view(shape).copy_(cand.to(dev))
    want_variant = "vec4" if shape[1] % 4 == 0 and not offset else "scalar"
    assert sparse2.load_variant(shape[1], score, cand) == want_variant
    reset_launch_counts()
    got = sparse2.sparse_priced_min2_cand(score, cand, price_n)
    assert sparse2.sparse_priced_min2_cand.launches == 1
    assert sparse2.sparse_priced_min2_cand.variants == {want_variant: 1}
    _same(got, sparse2.sparse_min2_cand_reference(score, cand, price_n))


# -- the kernels at shard offsets (parallel/sharded.py) ------------------------


@pytest.mark.parametrize("nrules", [0, 1])
@pytest.mark.parametrize("pbase,noff", [(512, 0), (0, 96), (4096, 130)])
def test_fused_kernel_at_shard_offsets_matches_plain(dev, nrules, pbase,
                                                     noff, layout):
    """The in-kernel score of a shard: the jitter hashes GLOBAL row ids
    (pbase + row) and column ids (noff + column), bitwise the plain
    version at the same offsets; and the offsets do move the result."""
    price, si = _fused_inputs(dev, 11 + nrules, 300, 133, 1, 2, 2, nrules)
    kw = dict(nrules=nrules, jitter_scale=1e-5)
    got = score_fused.fused_score_min2(price, si, pbase, noff, **kw)
    _same(got, score_fused.fused_score_min2_reference(
        price, si, pbase, noff, **kw))
    at_zero = score_fused.fused_score_min2_reference(price, si, 0, 0, **kw)
    assert not torch.equal(got[0], at_zero[0])


@pytest.mark.parametrize("noff", [0, 100, 4000])
def test_min2_on_a_column_block_shifted_matches_plain(dev, noff, layout):
    """min2 on one node shard's column block of a wider score: the
    kernel's local choice shifted by the block's first column is the
    plain version's, and where the block holds the row's global best
    it is the global argmin."""
    g = torch.Generator().manual_seed(5)
    full = torch.floor(torch.randn(257, 8000, generator=g) * 4) * 0.25
    n_l = 2000 if noff < 4000 else 4000
    block = full[:, noff:noff + n_l].contiguous().to(dev)
    price = torch.linspace(0, 1, 8000)[noff:noff + n_l].to(dev)
    b, c, s2 = reduce2.priced_min2_argmin(block, price)
    wb, wc, ws2 = reduce2.min2_argmin_reference(block + price[None, :])
    _same((b, c + noff, s2), (wb, wc + noff, ws2))
    eff = full + torch.linspace(0, 1, 8000)[None, :]
    gb, gc = eff.min(dim=1)
    here = (gc >= noff) & (gc < noff + n_l)
    first = (eff[:, noff:noff + n_l] == gb[:, None]).float().argmax(dim=1)
    np.testing.assert_array_equal(
        (c.cpu() + noff)[here].numpy(), (first + noff)[here].numpy())


def test_two_rank_mesh_on_card_equals_cpu_mesh(dev):
    """A 2-rank mesh on the one card (gloo: the ranks share it) solves
    the rack-rule problem bitwise as the 2-rank CPU mesh does, through
    min2 on both ranks."""
    from blance_tpu_torch.parallel.sharded import (make_mesh,
                                                   solve_dense_sharded)

    arrays, statics = _rack_rule_arrays()
    with make_mesh(2, device="cpu") as cpu:
        want = solve_dense_sharded(cpu, *arrays, *statics)
    with make_mesh(2, device=dev) as card:
        assert card.backend == "gloo"
        stats = {}
        got = solve_dense_sharded(card, *arrays, *statics, stats=stats)
    np.testing.assert_array_equal(got, want)
    per = stats["mesh"]["stats"]
    assert all(per[r]["launches"]["priced_min2_argmin"] > 0 for r in (0, 1))
    assert all(per[r]["staged_copies"] > 0 for r in (0, 1))


def _rack_rule_arrays():
    rng = np.random.default_rng(0)
    P, N = 1024, 64
    prev = np.full((P, 2, 1), -1, np.int32)
    prev[:, 0, 0] = rng.integers(0, N, P)
    prev[:, 1, 0] = (prev[:, 0, 0] + 1 + rng.integers(0, N - 1, P)) % N
    valid = np.ones(N, bool)
    valid[rng.choice(N, N // 20, replace=False)] = False
    arrays = (prev, np.ones(P, np.float32), np.ones(N, np.float32), valid,
              np.full((P, 2), 1.5, np.float32),
              np.stack([np.arange(N, dtype=np.int32),
                        np.arange(N, dtype=np.int32) // 25,
                        np.zeros(N, np.int32)]),
              np.ones((3, N), bool))
    return arrays, ((1, 1), ((), ((2, 1),)))


@pytest.mark.parametrize("engine", ["off", "on"])
def test_solve_on_card_matches_cpu(dev, engine):
    """A small rack-rule solve on the card equals the CPU plain path
    bitwise, and went through the engine's kernel."""
    arrays, statics = _rack_rule_arrays()
    cpu = solve_dense_converged(*problem_to_torch(*arrays, device="cpu"),
                                *statics, fused_score=engine)
    reset_launch_counts()
    gpu = solve_dense_converged(*problem_to_torch(*arrays, device=dev),
                                *statics, fused_score=engine)
    kernel = "priced_min2_argmin" if engine == "off" else "fused_score_min2"
    assert launch_counts()[kernel] > 0
    np.testing.assert_array_equal(gpu.cpu().numpy(), cpu.numpy())


@pytest.mark.parametrize("k", [3, 16])
def test_sparse_solve_on_card_matches_cpu(dev, k):
    """A small sparse solve (K < N; K = 3 exercises the host fallback)
    on the card equals the CPU plain path bitwise, through the kernel."""
    arrays, statics = _rack_rule_arrays()
    cpu_stats, gpu_stats = {}, {}
    cpu = solve_sparse(*problem_to_torch(*arrays, device="cpu"), *statics,
                       k=k, stats=cpu_stats)
    reset_launch_counts()
    gpu = solve_sparse(*problem_to_torch(*arrays, device=dev), *statics,
                       k=k, stats=gpu_stats)
    assert launch_counts()["sparse_priced_min2_cand"] > 0
    np.testing.assert_array_equal(gpu, cpu)
    assert gpu_stats["exhausted_rows"] == cpu_stats["exhausted_rows"]


# --- move diff, rank sweep and the one-shot rebalance on the card -----------------


@pytest.mark.parametrize("favor_min_nodes", [False, True])
@pytest.mark.parametrize("s,r", [(2, 1), (3, 2)])
def test_diff_assignments_on_card_matches_cpu(dev, s, r, favor_min_nodes):
    from blance_tpu_torch.moves.batch import diff_assignments

    rng = np.random.default_rng(10 * s + r)
    beg = torch.from_numpy(rng.integers(-1, 9, (5000, s, r)).astype(np.int32))
    end = torch.from_numpy(rng.integers(-1, 9, (5000, s, r)).astype(np.int32))
    cpu = diff_assignments(beg, end, favor_min_nodes=favor_min_nodes)
    gpu = diff_assignments(beg.to(dev), end.to(dev),
                           favor_min_nodes=favor_min_nodes)
    _same(gpu, cpu)


def test_rank_levels_on_card_matches_cpu(dev):
    from blance_tpu_torch.orchestrate.sched.ranks import rank_levels

    rng = np.random.default_rng(4)
    costs = torch.from_numpy(
        (rng.random((3000, 8)) * 10.0 ** rng.integers(-4, 4, (3000, 8)))
        .astype(np.float32))
    got = rank_levels(costs.to(dev)).cpu()
    assert got.numpy().tobytes() == rank_levels(costs).numpy().tobytes()


def test_small_rebalance_on_card_matches_cpu(dev):
    """A small rebalance(device="cuda") gives the CPU's map and op log,
    and its plan went through the min2 kernel."""
    import blance_tpu_torch as bt

    rng = np.random.default_rng(6)
    nodes = [f"n{i:02d}" for i in range(40)]
    prev = {str(i): bt.Partition(str(i), {
        "primary": [nodes[a]], "replica": [nodes[(a + 1 + b) % 40]]})
        for i, (a, b) in enumerate(zip(rng.integers(0, 40, 800).tolist(),
                                       rng.integers(0, 39, 800).tolist()))}
    out = {}
    for device in ("cpu", dev):
        log = []

        def assign(stop_ch, node, partitions, states, ops):
            log.extend(zip(partitions, [node] * len(ops), states, ops))

        reset_launch_counts()
        res = bt.rebalance(
            bt.model(primary=(0, 1), replica=(1, 1)), prev, nodes,
            nodes[:3], [], assign, backend="cuda", device=device,
            orchestrator_options=bt.OrchestratorOptions(
                device_diff=True, interrupt_on_first_feed=False))
        assert not res.progress.errors
        out[str(device)] = (bt.partition_map_to_json(res.next_map), log,
                            launch_counts()["priced_min2_argmin"])
    (cpu_map, cpu_log, _), (gpu_map, gpu_log, launches) = out.values()
    assert gpu_map == cpu_map and gpu_log == cpu_log and cpu_log
    assert launches > 0


# --- warm carry and the session on the card --------------------------------------


def _session_drive(device):
    """A 4096 x 256 rack-rule session: cold replan, apply, then 3 nodes
    removed and a warm replan; returns the proposals, the plan counters
    and the min2 launches of the warm replan."""
    import blance_tpu_torch as bt
    from blance_tpu_torch.obs import Recorder, use_recorder

    rng = np.random.default_rng(12)
    n = 256
    nodes = [f"n{i:03d}" for i in range(n)]
    hier = {nd: f"r{i // 16}" for i, nd in enumerate(nodes)}
    hier.update({f"r{i}": "z0" for i in range(n // 16)})
    prim = rng.integers(0, n, 4096)
    prev = {str(i): bt.Partition(str(i), {
        "primary": [nodes[a]], "replica": [nodes[(a + 1 + b) % n]]})
        for i, (a, b) in enumerate(zip(prim.tolist(),
                                       rng.integers(0, n - 1, 4096).tolist()))}
    opts = bt.PlanOptions(node_hierarchy=hier, hierarchy_rules={
        "replica": [bt.HierarchyRule(include_level=2, exclude_level=1)]})
    rec = Recorder()
    with use_recorder(rec):
        s = bt.PlannerSession(bt.model(primary=(0, 1), replica=(1, 1)),
                              nodes, sorted(prev), opts=opts, device=device)
        s.load_map(prev)
        s.remove_nodes(nodes[:8])
        cold = s.replan().copy()
        s.apply()
        s.remove_nodes([nodes[i] for i in rng.choice(
            np.arange(8, n), 3, replace=False)])
        reset_launch_counts()
        warm = s.replan().copy()
        launches = launch_counts()["priced_min2_argmin"]
    return cold, warm, {k: v for k, v in rec.counters.items()
                        if k.startswith("plan.")}, launches


def test_warm_session_on_card_matches_cpu(dev):
    """The session's cold and warm replans on the card equal the CPU's,
    counters included, and the warm one is a one-sweep carry hit that
    went through the min2 kernel."""
    cpu = _session_drive("cpu")
    gpu = _session_drive(dev)
    np.testing.assert_array_equal(gpu[0], cpu[0])
    np.testing.assert_array_equal(gpu[1], cpu[1])
    assert gpu[2] == cpu[2]
    assert gpu[2]["plan.solve.carry_hit"] == 1
    assert gpu[3] > 0


def test_carry_on_card_matches_cpu(dev):
    """carry_from_assignment on the card equals the CPU's, bitwise."""
    from blance_tpu_torch import carry_from_assignment

    arrays, statics = _rack_rule_arrays()
    cpu_args = problem_to_torch(*arrays, device="cpu")
    out = solve_dense_converged(*cpu_args, *statics, record=False)
    want = carry_from_assignment(out, cpu_args[1], cpu_args[2])
    gpu_args = problem_to_torch(*arrays, device=dev)
    got = carry_from_assignment(out.to(dev), gpu_args[1], gpu_args[2])
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert g.cpu().numpy().tobytes() == w.numpy().tobytes()


# --- the fused plan pipeline on the card -----------------------------------------


def _pipeline_fixture():
    """4096 partitions x 256 nodes in racks of 16, replica on another
    rack, 8 nodes removed."""
    import blance_tpu_torch as bt

    rng = np.random.default_rng(14)
    n = 256
    nodes = [f"n{i:03d}" for i in range(n)]
    hier = {nd: f"r{i // 16}" for i, nd in enumerate(nodes)}
    hier.update({f"r{i}": "z0" for i in range(n // 16)})
    prim = rng.integers(0, n, 4096)
    repl = (prim + 1 + rng.integers(0, n - 1, 4096)) % n
    prev = {str(i): bt.Partition(str(i), {"primary": [nodes[a]],
                                          "replica": [nodes[b]]})
            for i, (a, b) in enumerate(zip(prim.tolist(), repl.tolist()))}
    rules = {"replica": [bt.HierarchyRule(include_level=2, exclude_level=1)]}
    return prev, nodes, nodes[:8], hier, rules


def _pipeline_run(device, mode, **opts_kw):
    """plan_pipeline on ``device`` with the dense engine ``mode``; returns
    (map JSON, warnings, moves as tuples, plan counters, launches)."""
    import blance_tpu_torch as bt
    from blance_tpu_torch.obs import Recorder, use_recorder
    from blance_tpu_torch.plan import tensor as T

    prev, nodes, removed, hier, rules = _pipeline_fixture()
    opts = bt.PlanOptions(node_hierarchy=hier, hierarchy_rules=rules,
                          **opts_kw)
    rec = Recorder()
    T.set_fused_score_default(mode)
    try:
        reset_launch_counts()
        with use_recorder(rec):
            m, w, mv = bt.plan_pipeline(prev, prev, nodes, removed, [],
                                        bt.model(primary=(0, 1),
                                                 replica=(1, 1)),
                                        opts, device=device)
        launches = launch_counts()
    finally:
        T.set_fused_score_default("auto")
    moves = {k: [(o.node, o.state, o.op) for o in ops]
             for k, ops in mv.items()}
    counters = {k: v for k, v in rec.counters.items()
                if k.startswith("plan.")}
    return bt.partition_map_to_json(m), w, moves, counters, launches


@pytest.mark.parametrize("engine,kernel", [("off", "priced_min2_argmin"),
                                           ("on", "fused_score_min2")])
def test_pipeline_on_card_matches_cpu(dev, engine, kernel):
    """plan_pipeline on the card (matrix engine: min2 kernel; fused
    engine: the in-kernel score) equals the CPU's map, warnings, moves
    and counters at 4096 x 256, with no fallback."""
    cpu = _pipeline_run("cpu", engine)
    gpu = _pipeline_run(dev, engine)
    assert gpu[:4] == cpu[:4]
    assert gpu[4][kernel] > 0
    assert "plan.pipeline.fallback" not in gpu[3]
    assert "plan.engine_fallback" not in gpu[3]


def test_sparse_pipeline_on_card_matches_cpu(dev):
    """The sparse pipeline (K = 6 < N) on the card equals the CPU's, and
    went through the gathered sparse kernel."""
    cpu = _pipeline_run("cpu", "auto", sparse=True, sparse_k=6)
    gpu = _pipeline_run(dev, "auto", sparse=True, sparse_k=6)
    assert gpu[:4] == cpu[:4]
    assert gpu[4]["sparse_priced_min2_cand"] > 0
    assert "plan.pipeline.fallback" not in gpu[3]


# --- shape bucketing on the card ---------------------------------------------------


PADDED = [((2049, 61), (2304, 64)), ((4099, 777), (4608, 832))]


@pytest.mark.parametrize("real,padded", PADDED)
def test_min2_kernel_at_padded_shape_matches_plain(dev, real, padded,
                                                   layout):
    """The priced min2 at a bucket-padded, ragged shape: pad columns score
    +1e9 like invalid nodes, pad rows keep scores (weight-0 bidders)."""
    g = torch.Generator().manual_seed(3)
    x = torch.floor(torch.randn(padded, generator=g) * 3) * 0.125
    x[:, real[1]:] += 1e9
    x = x.to(dev)
    price = (torch.arange(padded[1], dtype=torch.float32) % 5 * 0.25).to(dev)
    reset_launch_counts()
    got = reduce2.priced_min2_argmin(x, price)
    assert reduce2.priced_min2_argmin.variants == {
        _min2_name(padded[1], False): 1}
    _same(got, reduce2.min2_argmin_reference(x + price[None, :]))


@pytest.mark.parametrize("nrules", [0, 1])
@pytest.mark.parametrize("real,padded", PADDED)
def test_fused_kernel_at_padded_shape_matches_plain(dev, real, padded,
                                                    nrules, layout):
    """The in-kernel score at a bucket-padded shape with the fill term's
    p_real a 0-d tensor on the card (the real P) and the pad columns
    invalid: all four outputs bitwise its plain version."""
    p_real = torch.tensor(float(real[0]), device=dev)
    price, si = _fused_inputs(dev, 5 + nrules, *padded, 1, 2, 2, nrules,
                              total_p=p_real, n_real=real[1])
    reset_launch_counts()
    got = score_fused.fused_score_min2(price, si, 0, 0, nrules=nrules,
                                       jitter_scale=1e-5)
    assert score_fused.fused_score_min2.variants == {
        _fused_name(padded[1], nrules, 1, 2, 2): 1}
    _same(got, score_fused.fused_score_min2_reference(
        price, si, 0, 0, nrules=nrules, jitter_scale=1e-5))


@pytest.mark.parametrize("engine,mode,kernel,extra", [
    ("matrix", "off", "priced_min2_argmin", {}),
    ("fused", "on", "fused_score_min2", {}),
    ("sparse", "auto", "sparse_priced_min2_cand", dict(sparse=True,
                                                        sparse_k=6)),
])
def test_bucketed_plan_on_card_matches_cpu(dev, engine, mode, kernel, extra):
    """A small off-bucket plan (2049 x 61, solved at 2304 x 64) with
    shape_bucketing: the card's map and warnings equal the CPU's, through
    the engine's kernel."""
    import blance_tpu_torch as bt
    from blance_tpu_torch.plan import tensor as T

    rng = np.random.default_rng(23)
    n, p = 61, 2049
    nodes = [f"s{i:02d}" for i in range(n)]
    hier = {nd: f"r{i // 8}" for i, nd in enumerate(nodes)}
    hier.update({f"r{i}": "z0" for i in range((n + 7) // 8)})
    prim = rng.integers(0, n, p)
    repl = (prim + 1 + rng.integers(0, n - 1, p)) % n
    prev = {str(i): bt.Partition(str(i), {"primary": [nodes[a]],
                                          "replica": [nodes[b]]})
            for i, (a, b) in enumerate(zip(prim.tolist(), repl.tolist()))}
    rules = {"replica": [bt.HierarchyRule(2, 1)]}
    opts = bt.PlanOptions(node_hierarchy=hier, shape_bucketing=True,
                          hierarchy_rules=rules, **extra)
    out = []
    T.set_fused_score_default(mode)
    try:
        for device in ("cpu", dev):
            reset_launch_counts()
            timings = {}
            m, w = bt.plan_next_map(prev, prev, nodes, nodes[:2], [],
                                    bt.model(primary=(0, 1), replica=(1, 1)),
                                    opts, device=device, timings=timings)
            out.append((bt.partition_map_to_json(m), w, timings["engine"]))
    finally:
        T.set_fused_score_default("auto")
    assert out[1] == out[0] and out[1][2] == engine
    assert launch_counts()[kernel] > 0


# -- the fleet tier: batched launches ------------------------------------------


@pytest.mark.parametrize("b,p,n", [(3, 17, 8), (5, 130, 33), (1, 7, 300),
                                   (16, 20, 64)])
def test_batched_min2_kernel_matches_plain(dev, b, p, n, layout):
    """A batch of [P, N] problems in one launch, each row priced by its
    own problem's price row; every element equals its unbatched launch."""
    g = torch.Generator().manual_seed(b * 1000 + n)
    x = torch.floor(torch.randn((b, p, n), generator=g) * 3) * 0.125
    x[:, ::5] = float("inf")
    price = torch.floor(torch.rand((b, n), generator=g) * 8) * 0.25
    x, price = x.to(dev), price.to(dev)
    reset_launch_counts()
    got = reduce2.priced_min2_argmin(x, price)
    assert reduce2.priced_min2_argmin.variants == {_min2_name(n, True): 1}
    _same(got, reduce2.batched_min2_reference(x, price))
    for e in range(b):
        _same([t[e] for t in got],
              reduce2.priced_min2_argmin(x[e], price[e]))


def _stack_fused(dev, b, p, n, widths, nrules, p_real=False):
    """``b`` problems' in-kernel score inputs, stacked on a batch axis."""
    r, t, a = widths
    per = [_fused_inputs(dev, 50 + e, p, n, r, t, a, nrules,
                         total_p=torch.tensor(float(p - e), device=dev)
                         if p_real else None)
           for e in range(b)]
    price = torch.stack([pr for pr, _si in per])
    si = score_fused.ScoreInputs(*(torch.stack(f) for f in
                                   zip(*[s for _pr, s in per])))
    return price, si, per


@pytest.mark.parametrize("nrules,widths", [(1, (1, 2, 2)), (0, (1, 1, 1)),
                                           (2, (2, 2, 2))])
@pytest.mark.parametrize("b,p,n", [(3, 18, 8), (4, 37, 65), (1, 300, 257)])
def test_batched_fused_kernel_matches_plain(dev, nrules, widths, b, p, n,
                                            layout):
    """The in-kernel score over a batch (the problem on blockIdx.y):
    bitwise the per-problem plain version and each problem's unbatched
    launch, ragged row tiles included; the jitter hashes each problem's
    own row and column ids."""
    price, si, per = _stack_fused(dev, b, p, n, widths, nrules,
                                  p_real=nrules == 1)
    reset_launch_counts()
    got = score_fused.fused_score_min2(price, si, 0, 0, nrules=nrules,
                                       jitter_scale=1e-5)
    assert score_fused.fused_score_min2.variants == {
        _fused_name(n, nrules, *widths, batched=True): 1}
    _same(got, score_fused.batched_fused_reference(
        price, si, 0, 0, nrules=nrules, jitter_scale=1e-5))
    for e, (pr, s) in enumerate(per):
        _same([t[e] for t in got], score_fused.fused_score_min2(
            pr, s, 0, 0, nrules=nrules, jitter_scale=1e-5))


# -- narrow rows: several rows a block, a group of lanes a row ------------------

# The widest rows that still take the narrow layouts (min2: float4 rows
# and rows of 4-byte loads).
_MIN2_EDGES = [reduce2.LANES_BY_N[-1][0], reduce2.LANES_BY_N_SCALAR[-1][0]]
_FUSED_EDGE = score_fused.FUSED_LANES_BY_N[-1][0]
_NARROW_N = [1, 3, 4, 7, 8, 31, 33, 64, 65, 128, 255, 256, 257]


def _narrow_rows(lead, n, seed):
    """Quantized scores (duplicate minima), whole +inf rows and rows
    whose only finite value is in the last column, score ``lead + (n,)``
    and price ``lead[:-1] + (n,)``."""
    g = torch.Generator().manual_seed(seed)
    x = torch.floor(torch.randn(lead + (n,), generator=g) * 3) * 0.125
    x[..., ::5, :] = float("inf")
    x[..., 2::7, :] = float("inf")
    x[..., 2::7, -1] = 1.5
    price = torch.floor(torch.rand(lead[:-1] + (n,), generator=g) * 8) * 0.25
    return x, price


def _offset(t):
    """``t``'s values in a view one float past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.flatten()
    return buf[1:].view(t.shape)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("b,p", [(1, 5), (3, 300), (7, 129)])
@pytest.mark.parametrize("n", sorted(set(
    _NARROW_N + [1024] + [e + d for e in _MIN2_EDGES for d in (-1, 0, 1, 4)])))
def test_min2_narrow_layouts_match_plain(dev, n, b, p, aligned):
    """Rows per warp at every width around its lane counts and its
    thresholds: bitwise the plain version, each problem of the batch equal
    to its unbatched launch; fewer rows than a block holds and ragged
    last blocks; float4 loads on aligned rows with N % 4 == 0, 4-byte
    loads otherwise, their lane count from the 4-byte table (N = 1024
    off alignment: a block a row)."""
    x, price = _narrow_rows((b, p), n, seed=n * 1000 + p)
    x, price = x.to(dev), price.to(dev)
    if not aligned:
        x, price = _offset(x), _offset(price)
    vec = aligned and n % 4 == 0
    lanes = reduce2.min2_lanes(n, vec)
    assert reduce2.min2_layout(x, price) == (lanes, vec and lanes > 0)
    reset_launch_counts()
    got = reduce2.priced_min2_argmin(x, price)
    _same(got, reduce2.batched_min2_reference(x, price))
    for e in range(b):
        assert reduce2.min2_layout(x[e], price[e])[0] == lanes
        _same([t[e] for t in got], reduce2.priced_min2_argmin(x[e],
                                                              price[e]))
    want = {_min2_name(n, True, vec): 1}
    want[_min2_name(n, False, vec)] = b
    assert reduce2.priced_min2_argmin.variants == want


@pytest.mark.parametrize("nrules,widths", [(1, (1, 2, 2)), (0, (1, 1, 1)),
                                           (2, (2, 2, 2))])
@pytest.mark.parametrize("b,p", [(1, 5), (3, 300)])
@pytest.mark.parametrize("n", sorted(set(
    _NARROW_N + [_FUSED_EDGE - 1, _FUSED_EDGE, _FUSED_EDGE + 1])))
def test_fused_narrow_layouts_match_plain(dev, n, b, p, nrules, widths):
    """The in-kernel score's narrow rows at every width around its lane
    counts and its threshold, in a fixed-width and the runtime-width
    instantiation: bitwise the plain version, each problem equal to its
    unbatched launch, fewer rows than a block holds and ragged blocks."""
    price, si, per = _stack_fused(dev, b, p, n, widths, nrules,
                                  p_real=nrules == 1)
    reset_launch_counts()
    got = score_fused.fused_score_min2(price, si, 0, 0, nrules=nrules,
                                       jitter_scale=1e-5)
    _same(got, score_fused.batched_fused_reference(
        price, si, 0, 0, nrules=nrules, jitter_scale=1e-5))
    for e, (pr, s) in enumerate(per):
        _same([t[e] for t in got], score_fused.fused_score_min2(
            pr, s, 0, 0, nrules=nrules, jitter_scale=1e-5))
    want = {_fused_name(n, nrules, *widths, batched=True): 1}
    want[_fused_name(n, nrules, *widths)] = b
    assert score_fused.fused_score_min2.variants == want


@pytest.mark.parametrize("n", [1, 8, 33, 64])
@pytest.mark.parametrize("where", ["all", "last"])
def test_fused_narrow_inf_prices(dev, n, where):
    """+inf prices in the narrow layout: every row all +inf (idx 0, raw
    NaN), or every column but the last +inf, so most lanes see only
    +inf."""
    price, si = _fused_inputs(dev, 9, 70, n, 1, 2, 2, 1)
    if where == "all":
        price[:] = float("inf")
    else:
        price[:-1] = float("inf")
    reset_launch_counts()
    got = score_fused.fused_score_min2(price, si, 0, 0, nrules=1,
                                       jitter_scale=1e-5)
    assert score_fused.fused_score_min2.variants == {
        _fused_name(n, 1, 1, 2, 2): 1}
    _same(got, score_fused.fused_score_min2_reference(
        price, si, 0, 0, nrules=1, jitter_scale=1e-5))


@pytest.mark.parametrize("lanes", [3, 64, -2])
def test_narrow_launch_error_raises(dev, lanes):
    """A lane count the launchers refuse raises RuntimeError and runs
    nothing else: no layout is taken instead and nothing is counted; the
    extern functions return the CUDA error, as they do for float4 loads
    asked of a ragged row."""
    x = torch.zeros((40, 12), device=dev)
    price = torch.zeros(12, device=dev)
    reset_launch_counts()
    with pytest.raises(RuntimeError, match="CUDA error"):
        reduce2._launch(x, price, lanes=lanes)
    with pytest.raises(RuntimeError, match="CUDA error"):
        reduce2._launch(x[None], price[None], lanes=lanes)
    fprice, si = _fused_inputs(dev, 1, 40, 12, 1, 2, 2, 1)
    for pr, s in ((fprice, si), (fprice[None], score_fused.ScoreInputs(
            *(t[None] for t in si)))):
        with pytest.raises(RuntimeError, match="CUDA error"):
            score_fused._launch(pr, s, 0, 0, 1, 1e-5, lanes=lanes)
    assert launch_counts() == {k: 0 for k in launch_counts()}
    out = torch.empty(40, device=dev)
    idx = torch.empty(40, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn, fb = reduce2._kernel()
    ptrs = (x.data_ptr(), price.data_ptr(), out.data_ptr(), idx.data_ptr(),
            out.data_ptr())
    assert fn(*ptrs, 40, 12, lanes, 0, stream) != 0
    assert fb(*ptrs, 40, 12, 40, lanes, 0, stream) != 0
    assert fn(*ptrs, 40, 11, 8, 1, stream) != 0  # float4 on N % 4 != 0
    assert fn(*ptrs, 40, 12, 0, 1, stream) != 0  # float4, block per row
    torch.cuda.synchronize()


def _fleet_tenant(p, n, seed, key):
    """A fleet tenant as the reference's test_fleet.make_tenant builds
    one: primary + replica on another rack of 4."""
    from blance_tpu_torch.plan.fleet import TenantProblem

    rng = np.random.default_rng(seed)
    prev = np.full((p, 2, 1), -1, np.int32)
    prev[:, 0, 0] = rng.integers(0, n, p)
    prev[:, 1, 0] = (prev[:, 0, 0] + 1 + rng.integers(0, n - 1, p)) % n
    return TenantProblem(
        key=key, prev=prev,
        partition_weights=rng.integers(1, 3, p).astype(np.float32),
        node_weights=np.ones(n, np.float32), valid_node=np.ones(n, bool),
        stickiness=np.full((p, 2), 1.5, np.float32),
        gids=np.stack([np.arange(n, dtype=np.int32),
                       np.arange(n, dtype=np.int32) // 4,
                       np.zeros(n, np.int32)]),
        gid_valid=np.ones((3, n), bool), constraints=(1, 1),
        rules=((), ((2, 1),)))


@pytest.mark.parametrize("engine,kernel,variant", [
    ("off", "priced_min2_argmin", _min2_name(8, True)),
    ("on", "fused_score_min2", _fused_name(8, 1, 1, 2, 2, batched=True))])
def test_fleet_on_card_matches_cpu(dev, engine, kernel, variant):
    """solve_fleet cold, then warm after one held node per tenant goes:
    the card's assignments, sweeps and warm flags equal the CPU's, and
    the batched launch ran."""
    import dataclasses

    from blance_tpu_torch.plan.fleet import solve_fleet

    tenants = [_fleet_tenant(17 + (i % 4), 8, i, f"t{i}") for i in range(6)]
    out = {}
    for device in ("cpu", dev):
        reset_launch_counts()
        r1 = solve_fleet(tenants, fused_score=engine, device=device)
        round2 = []
        for t, r in zip(tenants, r1):
            v = int(np.unique(r.assign[r.assign >= 0])[0])
            valid = t.valid_node.copy()
            valid[v] = False
            round2.append(dataclasses.replace(
                t, prev=r.assign, valid_node=valid, carry=r.carry,
                dirty=(r.assign == v).any(axis=(1, 2))))
        r2 = solve_fleet(round2, fused_score=engine, device=device)
        out[str(device)] = [(r.assign.tolist(), r.sweeps, r.warm)
                            for r in r1 + r2]
        if device != "cpu":
            from blance_tpu_torch.ops import launch_variants

            assert launch_variants()[kernel].get(variant, 0) > 0
    assert out[str(dev)] == out["cpu"]


TRACES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "traces")


def _harness_trace(name, tmp_path):
    """The port's regeneration of one committed artifact on the card."""
    import dataclasses

    from blance_tpu_torch.analysis.schedule import SCENARIOS
    from blance_tpu_torch.testing import (crashsim, fleetsim, scenarios,
                                          sched, simulate)

    if name == "sim_spot_preemption_s11.json":
        return simulate.run_scenario(scenarios.spot_preemption(11),
                                     device="cuda").log_text()
    if name == "sim_hetero_drain_s41.json":
        return simulate.run_scenario(dataclasses.replace(
            scenarios.hetero_drain(41), scheduler="critical_path"),
            device="cuda").log_text()
    if name == "crash_storm_s19.json":
        cs = scenarios.crash_storm(19)
        return crashsim.run_crash_scenario(
            cs.base, str(tmp_path), crashes=cs.crashes,
            snapshot_every=cs.snapshot_every,
            rotate_records=cs.rotate_records, device="cuda").log_text()
    if name == "fleet_zone_outage_s5_t8.json":
        return fleetsim.run_fleet_scenario(
            scenarios.fleet_zone_outage(seed=5, tenants=8),
            device="cuda").log_text()
    out = sched.replay(SCENARIOS["pause_cycle_guard"].factory,
                       sched.load_trace(os.path.join(TRACES, name)),
                       strict=False)
    assert out.ok, out.describe()
    return None


@pytest.mark.parametrize("name", [
    "sim_spot_preemption_s11.json", "sim_hetero_drain_s41.json",
    "crash_storm_s19.json", "fleet_zone_outage_s5_t8.json",
    "pause_cycle_guard.json"])
def test_harness_replays_committed_trace_on_card(dev, name, tmp_path,
                                                 monkeypatch):
    """Each committed trace replays through the port with device="cuda",
    byte for byte; the fleet's solves take the batched min2 launch."""
    from blance_tpu_torch import durability
    from blance_tpu_torch.ops import launch_variants

    monkeypatch.setenv("BLANCE_WAL_FSYNC", "0")
    durability.reset_fences()
    reset_launch_counts()
    text = _harness_trace(name, tmp_path)
    durability.reset_fences()
    if text is not None:
        with open(os.path.join(TRACES, name)) as f:
            assert text == f.read()
    if name.startswith("fleet"):
        assert any(v.startswith("batched") for v in
                   launch_variants()["priced_min2_argmin"])


def test_shape_audit_passes_on_card(dev):
    """The 72 shape contracts (the 12 sharded ones on a 2-rank mesh on
    the card) and 4 host checks pass with device="cuda"; the dense,
    pipeline and fleet contracts launch min2 (unbatched and batched) and
    the sparse ones the sparse kernel's gathered entry."""
    from blance_tpu_torch.analysis.shape_audit import run_shape_audit
    from blance_tpu_torch.ops import launch_variants

    reset_launch_counts()
    findings, entries = run_shape_audit(device="cuda")
    assert findings == [], "\n".join(f.render() for f in findings)
    assert entries == 76
    variants = launch_variants()["priced_min2_argmin"]
    assert any(v.startswith("batched") for v in variants), variants
    assert any(not v.startswith("batched") for v in variants), variants
    assert launch_counts()["sparse_priced_min2_cand"] > 0
