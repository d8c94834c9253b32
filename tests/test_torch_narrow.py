"""The narrow-row layouts' choice, and the batched plain versions at
narrow widths, on the CPU against the JAX package.

The min2 and in-kernel score kernels run rows of up to a measured width
in a narrow-row layout (a group of lanes of a warp a row, several rows a
block) and wider rows in the layouts they had (a block a row; the 16-row
tile).  ``min2_lanes`` and ``fused_lanes`` make that choice in Python and
the CUDA launchers take what they are given, so the tables are pinned
here.  The card's batched launches are held bitwise to the plain
versions (tests/test_torch_cuda.py, chip_smoke.py); those plain versions
are held here against the reference under ``jax.vmap``, as the fleet
tier runs it, at the narrow widths the fleet sends: min2 against the
vmapped XLA oracle and the vmapped Pallas kernel in interpret mode, the
in-kernel score against the vmapped Pallas kernel in interpret mode.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from blance_tpu.ops import reduce2 as jreduce2  # noqa: E402
from blance_tpu.ops import score_fused as jfused  # noqa: E402
from blance_tpu_torch.convert import score_inputs_to_torch  # noqa: E402
from blance_tpu_torch.ops import reduce2, score_fused  # noqa: E402
from test_torch_ops import _jax_pack, _raw_terms  # noqa: E402

NARROW_N = [1, 3, 8, 33, 64]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _equal(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)
    assert len(got) == len(want)


# --- the layout tables ---------------------------------------------------------


@pytest.mark.parametrize("n,vec,want", [
    (4, True, 1), (8, True, 1), (12, True, 2), (16, True, 2), (20, True, 4),
    (64, True, 4), (68, True, 8), (256, True, 8), (260, True, 16),
    (1024, True, 16), (1028, True, 32), (2048, True, 32), (2052, True, 0),
    (10_000, True, 0),
    # rows of 4-byte loads (N % 4 != 0, or operands off 16-byte alignment)
    (1, False, 1), (7, False, 1), (9, False, 2), (15, False, 2),
    (17, False, 4), (127, False, 4), (129, False, 8), (255, False, 8),
    (257, False, 32), (777, False, 32), (779, False, 0), (1024, False, 0),
    (2047, False, 0), (9_999, False, 0), (10_000, False, 0)])
def test_min2_lanes_table(n, vec, want):
    """Lanes a row by N, rows of float4 loads and rows of 4-byte loads
    by their own table; the main path's N = 10 000 keeps a block a
    row."""
    assert reduce2.min2_lanes(n, vec) == want


@pytest.mark.parametrize("n,want", [
    (1, 1), (8, 1), (64, 1), (65, 2), (128, 2), (129, 4), (256, 4),
    (257, 8), (512, 8), (513, 16), (777, 16), (1024, 16), (1025, 0),
    (10_000, 0)])
def test_fused_lanes_table(n, want):
    """Lanes a row by N at the fleet's widths (one rule, R = 1, T = 2,
    A = 2); the main path's N = 10 000 keeps the 16-row tile."""
    assert score_fused.fused_lanes(n, 1, 1, 2, 2) == want


@pytest.mark.parametrize("widths,n,want", [
    ((0, 1, 1, 0), 8, 1), ((2, 2, 2, 2), 8, 1),
    # 5 + 1 + 1 + 2 * 2 * 12 = 55 -> 56 words: 256 rows pass 48 KB
    ((2, 1, 1, 12), 8, 2),
    ((2, 1, 1, 12), 512, 8),
    # 5 + 1 + 1 + 2 * 1 * 380 = 767 -> 768 words: only 16 rows fit
    ((1, 1, 1, 380), 8, 16),
    ((1, 1, 1, 380), 10_000, 0)])
def test_fused_lanes_fit_shared_memory(widths, n, want):
    """Where the block's staged rows would pass the launcher's 48 KB of
    shared memory, more lanes a row (fewer rows a block) make them
    fit."""
    got = score_fused.fused_lanes(n, *widths)
    assert got == want
    words = score_fused._row_words(*widths)
    assert got == 0 or (256 // got) * words * 4 <= 48 * 1024


@pytest.mark.parametrize("table", [reduce2.LANES_BY_N,
                                   reduce2.LANES_BY_N_SCALAR,
                                   score_fused.FUSED_LANES_BY_N])
def test_lane_tables_are_well_formed(table):
    """Bounds rise, lane counts are powers of two up to 32 and never
    fall as rows widen, and each table stops below the main path's
    width."""
    bounds = [b for b, _ in table]
    lanes = [c for _, c in table]
    assert bounds == sorted(set(bounds))
    assert lanes == sorted(lanes)
    assert all(c in (1, 2, 4, 8, 16, 32) for c in lanes)
    assert bounds[-1] < 10_000


@pytest.mark.parametrize("n,offset,lanes,vec", [
    (64, 0, 4, True), (8, 0, 1, True), (12, 0, 2, True),
    (33, 0, 4, False), (3, 0, 1, False),    # N % 4 != 0
    (64, 1, 4, False),                      # a view off 16-byte alignment
    (64, 4, 4, True),                       # a view back on it
    (1024, 0, 16, True),
    (1024, 1, 0, False),                    # off alignment: 4-byte table
    (2048, 1, 0, False), (512, 1, 32, False),
    (10_000, 0, 0, False)])                 # block a row: never float4
def test_min2_vec_choice(n, offset, lanes, vec):
    """float4 loads are decided first, on rows with N % 4 == 0 whose
    operands start 16-byte aligned; the lane count comes from that
    decision's table, and float4 only with rows per warp."""
    score = torch.zeros(3 * n + offset)[offset:].view(3, n)
    price = torch.zeros(n + offset)[offset:]
    assert reduce2.min2_vec(score, price) is (n % 4 == 0 and offset % 4 == 0)
    assert reduce2.min2_layout(score, price) == (lanes, vec)


# --- the batched plain versions against the vmapped reference ------------------


def _narrow_min2_case(b, p, n, seed):
    """Quantized scores (duplicate minima), whole +inf rows and rows
    whose only finite value is in the last column; closed nodes."""
    rng = np.random.default_rng(seed)
    score = (rng.integers(0, 6, (b, p, n)) * 0.125).astype(np.float32)
    score[:, ::5] = np.inf
    score[:, 2::7] = np.inf
    score[:, 2::7, -1] = 1.5
    price = (rng.integers(0, 8, (b, n)) * 0.25).astype(np.float32)
    price[:, ::5] = 1.0e9
    return score, price


@pytest.mark.parametrize("n", NARROW_N)
def test_batched_min2_matches_vmapped_reference(n):
    """``batched_min2_reference`` (the CPU path of a batched
    ``priced_min2_argmin``) equals the reference's min2 under vmap: its
    XLA oracle of score + price and its Pallas kernel in interpret
    mode."""
    score, price = _narrow_min2_case(3, 37, n, seed=n)
    oracle = jax.vmap(jreduce2.min2_argmin_reference)(
        jnp.asarray(score) + jnp.asarray(price)[:, None, :])
    pallas = jax.vmap(lambda s, pr: jreduce2.priced_min2_argmin(
        s, pr, tile_p=8, tile_n=128, interpret=True))(
        jnp.asarray(score), jnp.asarray(price))
    got = reduce2.batched_min2_reference(_t(score), _t(price))
    _equal(got, oracle)
    _equal(got, pallas)
    _equal(reduce2.priced_min2_argmin(_t(score), _t(price)), oracle)


@pytest.mark.parametrize("nrules", [0, 1, 2])
@pytest.mark.parametrize("n", NARROW_N)
def test_batched_fused_matches_vmapped_interpret(n, nrules):
    """``batched_fused_reference`` (the CPU path of a batched
    ``fused_score_min2``) equals the reference's Pallas kernel in
    interpret mode under vmap, on all four outputs, with each problem's
    own inputs: closed nodes, rule anchors, the jitter's one rounding."""
    b, p = 3, 37
    terms = [_raw_terms(100 * n + 10 * nrules + e, p, n, nrules=nrules)
             for e in range(b)]
    packed = [_jax_pack(tm, p) for tm in terms]
    si_np = jfused.ScoreInputs(*(np.stack(f) for f in zip(*packed)))
    price = np.stack([tm["price"] for tm in terms])
    want = jax.vmap(lambda pr, si: jfused.fused_score_min2(
        pr, si, 0, 0, nrules=nrules, jitter_scale=1.0e-5, tile_p=16,
        tile_n=128, interpret=True))(
        jnp.asarray(price),
        jfused.ScoreInputs(*(jnp.asarray(x) for x in si_np)))
    si_t = score_inputs_to_torch(si_np, device="cpu")
    got = score_fused.batched_fused_reference(
        _t(price), si_t, 0, 0, nrules=nrules, jitter_scale=1.0e-5)
    _equal(got, want)
    _equal(score_fused.fused_score_min2(_t(price), si_t, 0, 0,
                                        nrules=nrules, jitter_scale=1.0e-5),
           want)
