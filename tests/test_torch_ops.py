"""Kernel modules of the PyTorch/CUDA port against the JAX package.

The same inputs, made from a seed with numpy, go through the reference
(XLA and the Pallas kernels in interpret mode, on the CPU) and through
the port's plain PyTorch versions on the CPU; everything is compared
bitwise.  The CUDA kernels themselves are held against the plain
versions in tests/test_torch_cuda.py, which runs only where a card is
present, and by chip_smoke.py at the main path's shapes.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from blance_tpu.ops import reduce2 as jreduce2  # noqa: E402
from blance_tpu.ops import score_fused as jfused  # noqa: E402
from blance_tpu_torch.convert import score_inputs_to_torch  # noqa: E402
from blance_tpu_torch.ops import reduce2 as treduce2  # noqa: E402
from blance_tpu_torch.ops import score_fused as tfused  # noqa: E402

_INF = 1.0e9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread is faster and steadier than
    a pool that competes with the other test workers for the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_tuple_equal(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


# --- min2 ---------------------------------------------------------------------


def _min2_cases():
    rng = np.random.default_rng(11)
    cases = {}
    cases["random"] = rng.standard_normal((130, 300)).astype(np.float32)
    # Quantized scores: many duplicate minima, across 128-wide tiles.
    cases["quantized_ties"] = (rng.integers(0, 6, (67, 513))
                               .astype(np.float32) * 0.125)
    dup = np.ones((9, 300), np.float32)
    dup[:, 37] = dup[:, 157] = dup[:, 290] = -2.0
    cases["duplicate_minima"] = dup
    inf_rows = rng.standard_normal((12, 40)).astype(np.float32)
    inf_rows[::3] = np.inf
    cases["all_inf_rows"] = inf_rows
    cases["ragged_n"] = rng.standard_normal((33, 131)).astype(np.float32)
    cases["one_column"] = rng.standard_normal((5, 1)).astype(np.float32)
    return cases


_MIN2 = _min2_cases()


@pytest.mark.parametrize("case", sorted(_MIN2))
def test_min2_reference_matches_jax(case):
    x = _MIN2[case]
    want = jreduce2.min2_argmin_reference(jnp.asarray(x))
    _assert_tuple_equal(treduce2.min2_argmin_reference(_t(x)), want)
    _assert_tuple_equal(treduce2.min2_argmin(_t(x)), want)


@pytest.mark.parametrize("case", sorted(_MIN2))
def test_priced_min2_matches_jax_interpret(case):
    x = _MIN2[case]
    rng = np.random.default_rng(3)
    price = (rng.integers(0, 8, x.shape[1]) * 0.25).astype(np.float32)
    price[::5] = _INF  # closed nodes
    want = jreduce2.priced_min2_argmin(
        jnp.asarray(x), jnp.asarray(price), tile_p=8, tile_n=128,
        interpret=True)
    got = treduce2.priced_min2_argmin(_t(x), _t(price))
    _assert_tuple_equal(got, want)


def test_priced_min2_rejects_other_devices():
    x = torch.zeros((2, 3), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        treduce2.priced_min2_argmin(x, torch.zeros(3, device="meta"))


# --- jitter hash, fill term, jitter rounding ------------------------------------


def test_jitter_hash_matches_jax_extreme_int32():
    i32 = np.iinfo(np.int32)
    edge = np.array([i32.min, i32.min + 1, -65537, -65536, -2, -1, 0, 1, 2,
                     40503, 65535, 65536, 2**24 + 1, i32.max - 1, i32.max],
                    np.int32)
    rng = np.random.default_rng(5)
    pi = np.concatenate([np.repeat(edge, edge.size),
                         rng.integers(i32.min, i32.max, 4096,
                                      dtype=np.int64).astype(np.int32)])
    ni = np.concatenate([np.tile(edge, edge.size),
                         rng.integers(i32.min, i32.max, 4096,
                                      dtype=np.int64).astype(np.int32)])
    want = np.asarray(jfused.jitter_hash(jnp.asarray(pi), jnp.asarray(ni)))
    got = tfused.jitter_hash(_t(pi), _t(ni)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [1, 7, 64, 1000, 1024, 4093, 100000, 123457])
def test_fill_term_matches_jitted_jax(p):
    """XLA folds 0.001 * total / P (P a trace-time constant) into one
    multiplier; the port's fill_scale reproduces it bit for bit, where
    the literal division would not."""
    rng = np.random.default_rng(p)
    total = rng.integers(0, 5000, 4096).astype(np.float32)
    w_div = rng.integers(1, 5, 4096).astype(np.float32)

    @jax.jit
    def ref(total, w_div):
        return (0.001 * total / jnp.maximum(jnp.float32(p), 1.0)) / w_div

    want = np.asarray(ref(total, w_div))
    got = ((_t(total) * tfused.fill_scale(p)) / _t(w_div)).numpy()
    np.testing.assert_array_equal(got, want)


def _jitter_discriminating(n=100000, seed=2):
    """Rows whose score + 1e-5 * jitter rounds differently with one
    rounding than with two: a plain spelling fails on them."""
    rng = np.random.default_rng(seed)
    pi = torch.arange(n, dtype=torch.int32)
    ni = torch.zeros(n, dtype=torch.int32)
    prod = tfused.jitter_hash(pi, ni) * np.float32(1e-5)
    score = (rng.random(n) * 3 - 1.5).astype(np.float32)
    found = np.zeros(n, bool)
    for _ in range(40):
        cand = (rng.random(n) * 3 - 1.5).astype(np.float32)
        once = tfused.jitter_add(_t(cand), pi, ni, 1e-5).numpy()
        twice = (_t(cand) + prod).numpy()
        hit = (once != twice) & ~found
        score[hit] = cand[hit]
        found |= hit
    return score, found


def test_jitter_add_matches_jitted_jax_fma():
    score, found = _jitter_discriminating()
    assert found.sum() > 20  # the fixture really discriminates
    n = score.size
    pi = np.arange(n, dtype=np.int32)
    ni = np.zeros(n, np.int32)

    @jax.jit
    def ref(score, pi, ni):
        return score + jnp.float32(1.0e-5) * jfused.jitter_hash(pi, ni)

    want = np.asarray(ref(score, pi, ni))
    got = tfused.jitter_add(_t(score), _t(pi), _t(ni), 1e-5).numpy()
    np.testing.assert_array_equal(got, want)
    plain = (_t(score) + np.float32(1e-5)
             * tfused.jitter_hash(_t(pi), _t(ni))).numpy()
    assert (plain != want).sum() >= found.sum()


# --- fused score ------------------------------------------------------------------


def _raw_terms(seed, P, N, R=2, T=3, A=2, nrules=2):
    rng = np.random.default_rng(seed)
    racks = 5
    rack_of = rng.integers(0, racks, N).astype(np.int32)
    zone_of_rack = rng.integers(0, 2, racks).astype(np.int32)
    gids = np.stack([np.arange(N, dtype=np.int32), rack_of,
                     zone_of_rack[rack_of]])
    return dict(
        total=(rng.integers(0, 60, N)).astype(np.float32),
        w_div=rng.integers(1, 4, N).astype(np.float32),
        neg_boost=np.where(rng.random(N) < 0.3, rng.integers(1, 4, N),
                           0).astype(np.float32),
        valid=rng.random(N) < 0.85,
        stick=np.where(rng.random(P) < 0.5, 1.5, 2.0).astype(np.float32),
        prev_slot=rng.integers(-1, N, P).astype(np.int32),
        prev_state=rng.integers(-1, N, (P, R)).astype(np.int32),
        taken=rng.integers(-1, N, (P, T)).astype(np.int32),
        anchors=rng.integers(-1, N, (P, A)).astype(np.int32),
        gids=gids, gid_valid=rng.random((3, N)) < 0.9,
        rules=((2, 1), (1, 0))[:nrules],
        price=(rng.random(N).astype(np.float32)
               + np.where(rng.random(N) < 0.2, _INF, 0)).astype(np.float32))


def _pack_kwargs(terms, conv):
    T = terms["taken"].shape[1]
    return dict(
        total_l=conv(terms["total"]), w_div_l=conv(terms["w_div"]),
        neg_boost_l=conv(terms["neg_boost"]), valid_l=conv(terms["valid"]),
        stickiness_si=conv(terms["stick"]),
        prev_slot=conv(terms["prev_slot"]),
        prev_state=conv(terms["prev_state"]),
        taken_ids=[conv(terms["taken"][:, t]) for t in range(T)],
        anchors=conv(terms["anchors"]), gids_l=conv(terms["gids"]),
        gid_valid=conv(terms["gid_valid"]), gids=conv(terms["gids"]),
        rules=terms["rules"])


def _jax_pack(terms, P):
    """The reference packer, jitted with the partition count a trace-time
    constant, exactly as _solve_assign runs it."""
    kw = _pack_kwargs(terms, jnp.asarray)
    rules = kw.pop("rules")
    fn = jax.jit(lambda kw: jfused.pack_score_inputs(
        total_p=jnp.float32(P), rules=rules, **kw))
    return jax.tree_util.tree_map(np.asarray, fn(kw))


@pytest.mark.parametrize("nrules", [0, 1, 2])
def test_pack_score_inputs_matches_jitted_jax(nrules):
    P, N = 61, 45
    terms = _raw_terms(nrules, P, N, nrules=nrules)
    want = _jax_pack(terms, P)
    got = tfused.pack_score_inputs(total_p=P,
                                   **_pack_kwargs(terms, _t))
    for name in tfused.ScoreInputs._fields:
        g = getattr(got, name).numpy()
        w = getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("nrules", [0, 1, 2])
@pytest.mark.parametrize("seed,P,N,pbase,noff", [
    (0, 37, 23, 0, 0), (1, 300, 257, 0, 0), (2, 129, 70, 1000, 5)])
def test_fused_score_min2_matches_jax_interpret(nrules, seed, P, N, pbase,
                                                noff):
    """The plain version (the CPU path of fused_score_min2) equals the
    Pallas kernel in interpret mode on all four outputs, bitwise — with
    ragged tiles, closed nodes and the jitter's single rounding."""
    terms = _raw_terms(seed + 10 * nrules, P, N, nrules=nrules)
    si_np = _jax_pack(terms, P)
    si_j = jfused.ScoreInputs(*(jnp.asarray(x) for x in si_np))
    want = jfused.fused_score_min2(
        jnp.asarray(terms["price"]), si_j, pbase, noff, nrules=nrules,
        jitter_scale=1.0e-5, tile_p=16, tile_n=128, interpret=True)
    si_t = score_inputs_to_torch(si_np, device="cpu")
    got = tfused.fused_score_min2(_t(terms["price"]), si_t, pbase, noff,
                                  nrules=nrules, jitter_scale=1.0e-5)
    _assert_tuple_equal(got, want)


@pytest.mark.parametrize("nrules", [0, 2])
def test_score_at_columns_matches_jitted_jax(nrules):
    P, N, K = 300, 257, 4000
    terms = _raw_terms(7 + nrules, P, N, nrules=nrules)
    rng = np.random.default_rng(9)
    rows = rng.integers(0, P, K).astype(np.int32)
    cols = rng.integers(0, N, K).astype(np.int32)
    base = (terms["total"] * np.float32(tfused.fill_scale(P))
            / terms["w_div"]).astype(np.float32)
    T = terms["taken"].shape[1]

    def kw(conv):
        return dict(
            base_full=conv(base), neg_boost_full=conv(terms["neg_boost"]),
            valid_full=conv(terms["valid"]), gids=conv(terms["gids"]),
            gid_valid=conv(terms["gid_valid"]),
            anchors=conv(terms["anchors"]),
            prev_slot=conv(terms["prev_slot"]),
            prev_state=conv(terms["prev_state"]),
            taken_ids=tuple(conv(terms["taken"][:, t]) for t in range(T)),
            stick=conv(terms["stick"]))

    rules = terms["rules"]
    want = np.asarray(jax.jit(lambda r, c, k: jfused.score_at_columns(
        r, c, rules=rules, jitter_scale=1.0e-5,
        pbase=jnp.zeros((1, 1), jnp.int32), **k))(
            jnp.asarray(rows), jnp.asarray(cols), kw(jnp.asarray)))
    # The port's probe: the one score on the packed inputs, at (row,
    # column) pairs in the fused kernel's term order.
    si = tfused.pack_score_inputs(total_p=P, **_pack_kwargs(terms, _t))
    got = tfused.score_cells(si, _t(rows), _t(cols), 0, 0, nrules=nrules,
                             jitter_scale=1.0e-5, order="fused")
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_score_min2_rejects_other_devices():
    terms = _raw_terms(0, 4, 3, nrules=0)
    si = score_inputs_to_torch(_jax_pack(terms, 4), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tfused.fused_score_min2(torch.zeros(3, device="meta"), si, 0, 0,
                                nrules=0, jitter_scale=1e-5)
