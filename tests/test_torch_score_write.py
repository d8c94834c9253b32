"""The matrix engine's score build on the CPU against the JAX package's,
bit for bit.

``plan/tensor.py`` ``_matrix_score`` packs its inputs
(``pack_score_inputs``) and writes the [P, N] score: one kernel on the
card (``ops.score_fused.score_write``), its plain version on the CPU,
row-chunked calls of the one plain spelling of the score
(``score_cells``).  Here that CPU build is held against the JAX
package's matrix-order spelling on the same terms, its
``_sparse_score_cols`` at every column (bitwise its dense build, as its
docstring states), jitted: rules, taken columns, anchors present and
absent, removed nodes, negative node weights, a partition shard's rows,
a node shard's columns, a traced partition count and a batch (one
element at a time on the JAX side).  The kernel is held against the
same build on the card (tests/test_torch_cuda.py).  A CPU build counts
no score write.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from blance_tpu.plan import tensor as jtensor  # noqa: E402
from blance_tpu_torch import (problem_to_torch,  # noqa: E402
                              solve_dense_converged)
from blance_tpu_torch.obs import (PORT_ONLY_COUNTERS, Recorder,  # noqa: E402
                                  counting_to)
from blance_tpu_torch.ops import score_fused  # noqa: E402
from blance_tpu_torch.plan import tensor as ttensor  # noqa: E402
from _score_terms import (RULES, bitwise, matrix_build, packed,  # noqa: E402
                          stacked, terms)

CELLS = "ops.score_write.cells"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_build(tm, nrules, total_p, pbase=0, noff=0, n_l=None):
    """The JAX package's matrix-order score on the terms, at every column
    of the node shard (``n_l`` from ``noff`` on), jitted: ``total_p`` a
    Python number is a trace-time constant, a tensor is traced (the
    reference's ``p_real``); a batch goes one element at a time."""
    if tm["total"].dim() == 2:
        return torch.stack([_jax_build(
            {k: tuple(x[b] for x in v) if k == "taken" else v[b]
             for k, v in tm.items()}, nrules, total_p[b, 0], pbase, noff,
            n_l) for b in range(tm["total"].shape[0])])
    p, n = tm["stick"].shape[0], tm["total"].shape[0]
    n_l = n if n_l is None else n_l
    cols = np.broadcast_to(np.arange(noff, noff + n_l, dtype=np.int32),
                           (p, n_l))
    arrays = {k: jnp.asarray(tm[src].numpy()) for k, src in (
        ("total", "total"), ("w_div", "w_div"), ("neg_boost", "neg_boost"),
        ("valid", "valid"), ("gids", "gids"), ("gid_valid", "gid_valid"),
        ("stick_si", "stick"), ("prev_slot", "prev_slot"),
        ("prev_state", "prev_state"), ("anchors", "anchors"))}
    traced = isinstance(total_p, torch.Tensor)

    def build(cols, arrays, taken, tp):
        return jtensor._sparse_score_cols(
            cols, jnp.arange(p, dtype=jnp.int32), pbase,
            total_p=tp if traced else jnp.array(total_p, jnp.float32),
            taken_ids=tuple(taken), rules=RULES[:nrules],
            jitter_scale=float(jtensor._JITTER), **arrays)

    out = jax.jit(build)(
        jnp.asarray(cols), arrays,
        [jnp.asarray(x.numpy()) for x in tm["taken"]],
        jnp.float32(total_p.item()) if traced else None)
    return torch.from_numpy(np.array(out))


def _both(tm, nrules, total_p, pbase=0, noff=0, n_l=None):
    """(the JAX package's build, ``_matrix_score`` on the CPU) on the
    same terms."""
    return (_jax_build(tm, nrules, total_p, pbase, noff, n_l),
            matrix_build(tm, nrules, total_p, pbase, noff, n_l))


@pytest.mark.parametrize("t_width", [0, 1, 2, 3])
@pytest.mark.parametrize("nrules", [0, 1, 2])
def test_plain_write_is_the_matrix_build(nrules, t_width):
    p, n = 300, 70
    want, got = _both(terms(10 * nrules + t_width, p, n, t_width),
                       nrules, p)
    bitwise(got, want)


@pytest.mark.parametrize("nrules", [1, 2])
@pytest.mark.parametrize("a_width", [1, 3])
def test_plain_write_without_anchors(nrules, a_width):
    p, n = 257, 64
    tm = terms(40 + nrules, p, n, 2, a_width=a_width, anchors=False)
    want, got = _both(tm, nrules, p)
    bitwise(got, want)


@pytest.mark.parametrize("nrules", [0, 1])
@pytest.mark.parametrize("pbase,noff,n_l", [(512, 0, 40), (0, 40, 40),
                                            (4096, 33, 47)])
def test_plain_write_on_a_shard(nrules, pbase, noff, n_l):
    """A partition shard's rows (the jitter hashes pbase + row) and a
    node shard's columns (noff + column, rule columns from its slice)."""
    p = 129
    tm = terms(50 + noff, p, 80, 2)
    want, got = _both(tm, nrules, 4 * p, pbase=pbase, noff=noff, n_l=n_l)
    assert got.shape == (p, n_l)
    bitwise(got, want)


@pytest.mark.parametrize("nrules", [0, 1])
def test_plain_write_with_a_traced_partition_count(nrules):
    """``p_real`` under shape bucketing: the fill term's one division."""
    p = 300
    tm = terms(60 + nrules, p, 70, 2)
    want, got = _both(tm, nrules, torch.tensor(271.0))
    bitwise(got, want)


@pytest.mark.parametrize("nrules", [0, 1])
def test_plain_write_over_a_batch(nrules):
    """The fleet's [B, P, N]: every term with a leading [B], ``p_real``
    [B, 1]; each problem's rows and columns hash from 0."""
    b, p, n = 3, 64, 33
    tm = stacked([terms(70 + e, p, n, 2) for e in range(b)])
    want, got = _both(tm, nrules, torch.tensor([[64.0], [50.0], [1.0]]))
    assert got.shape == (b, p, n)
    bitwise(got, want)


def test_the_orders_differ_where_a_weight_is_negative():
    """The fused kernel's order (boost, then the same-ordinal bonus) and
    the matrix build's (bonus, then boost) round differently on cells of
    a node with a negative weight that was the row's previous node;
    everywhere else they agree."""
    p, n = 300, 70
    tm = terms(3, p, n, 2)
    want = matrix_build(tm, 1, p)
    fused = score_fused.score_cells(
        packed(tm, 1, p), torch.arange(p), None, 0, 0, nrules=1,
        jitter_scale=ttensor._JITTER, order="fused")
    differ = want.view(torch.int32) != fused.view(torch.int32)
    both = (tm["neg_boost"][None, :] > 0) & \
        (tm["prev_slot"][:, None] == torch.arange(n)[None, :])
    assert differ.any()
    assert not (differ & ~both).any()


def test_cpu_builds_count_no_score_write():
    """The counter and the launch count move only at a launch on the
    card: a CPU solve through the matrix engine, and the plain write
    itself, count nothing."""
    rng = np.random.default_rng(0)
    p, n = 256, 16
    prev = np.full((p, 2, 1), -1, np.int32)
    prev[:, 0, 0] = rng.integers(0, n, p)
    prev[:, 1, 0] = (prev[:, 0, 0] + 1 + rng.integers(0, n - 1, p)) % n
    arrays = (prev, np.ones(p, np.float32), np.ones(n, np.float32),
              np.ones(n, bool), np.full((p, 2), 1.5, np.float32),
              np.stack([np.arange(n, dtype=np.int32),
                        np.arange(n, dtype=np.int32) // 4,
                        np.zeros(n, np.int32)]), np.ones((3, n), bool))
    launches = score_fused.score_write.launches
    rec = Recorder()
    with counting_to(rec):
        solve_dense_converged(*problem_to_torch(*arrays, device="cpu"),
                              (1, 1), ((), ((2, 1),)))
        tm = terms(1, 16, 8, 1)
        matrix_build(tm, 1, 16)
        score_fused.score_write(packed(tm, 1, 16), 0, 0, nrules=1,
                                jitter_scale=ttensor._JITTER)
    assert rec.counters["plan.solve.auction_rounds"] > 0
    assert CELLS not in rec.counters
    assert score_fused.score_write.launches == launches
    assert CELLS in PORT_ONLY_COUNTERS


def test_score_write_rejects_other_devices():
    si = packed(terms(0, 4, 3, 1), 0, 4)
    meta = score_fused.ScoreInputs(*(x.to("meta") for x in si))
    with pytest.raises(RuntimeError, match="no kernel"):
        score_fused.score_write(meta, 0, 0, nrules=0, jitter_scale=1e-5)
