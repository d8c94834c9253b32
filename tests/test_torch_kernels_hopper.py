"""The redesigned kernels' entry points, on the CPU, against the JAX package.

``sparse_priced_min2_cand`` (the sparse engine's min2 with the candidate
price gathered in the kernel) takes its plain version here; it must equal
the reference's composition around its TPU kernel
(blance_tpu/plan/tensor.py, the sparse ``min2_fn``): the JAX
``sparse_min2_reference`` of ``score`` and ``price_vec[clip(cand)]``,
then ``max(cand[r, kidx], 0)``.  Also the wrappers' argument checks, the
choice of kernel instantiation from shapes and alignment (which the CUDA
launch obeys), and that the fused kernel's fixed-width instantiations
cover every launch of a small main-path plan.  The CUDA kernels
themselves are held against these plain versions in
tests/test_torch_cuda.py and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import blance_tpu_torch as bt  # noqa: E402
from blance_tpu.ops import sparse2 as jsparse2  # noqa: E402
from blance_tpu_torch.ops import (launch_variants, reset_launch_counts,  # noqa: E402
                                  score_fused, sparse2)
from blance_tpu_torch.plan import tensor as ttensor  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cand_case(name):
    """(score[P, K] f32, cand[P, K] i32, price_n[N] f32)."""
    rng = np.random.default_rng(5)
    n = 40
    shape = {"quantized": (512, 16), "ragged": (33, 37), "k1": (7, 1),
             "pads_repeats": (200, 12), "ids_over_n": (64, 8),
             "inf_rows": (40, 19)}[name]
    score = rng.integers(0, 6, shape).astype(np.float32) * 0.125
    cand = rng.integers(0, n, shape).astype(np.int32)
    price_n = rng.integers(0, 4, n).astype(np.float32) * 0.25
    price_n[::7] = 1e9  # closed nodes
    if name == "ragged":
        score = rng.standard_normal(shape).astype(np.float32)
        price_n = rng.standard_normal(n).astype(np.float32)
    elif name == "pads_repeats":
        cand[::3, -4:] = -1
        score[::3, -4:] = np.inf  # the engine scores pad columns +inf
        cand[1::2, 1] = cand[1::2, 0]
        cand[5::11, :] = cand[5::11, :1]
    elif name == "ids_over_n":
        cand[::2, 3] = n + 5
        cand[1::4, 0] = -1
    elif name == "inf_rows":
        cand[:, 15:] = -1
        score[:, 15:] = np.inf
        score[::7] = np.inf
    return score, cand, price_n


def _jax_cand_min2(score, cand, price_n):
    """The reference's sparse min2_fn: price gather, its XLA oracle of
    the TPU kernel, then the picked id."""
    n = price_n.shape[0]
    cand_j = jnp.asarray(cand)
    price_pk = jnp.asarray(price_n)[jnp.clip(cand_j, 0, n - 1)]
    b, kidx, s2, raw = jsparse2.sparse_min2_reference(jnp.asarray(score),
                                                      price_pk)
    choice = jnp.maximum(jnp.take_along_axis(
        cand_j, kidx[:, None], axis=1)[:, 0], 0)
    return b, kidx, s2, raw, choice


@pytest.mark.parametrize("name", ["quantized", "ragged", "k1", "pads_repeats",
                                  "ids_over_n", "inf_rows"])
def test_sparse_min2_cand_matches_jax(name):
    score, cand, price_n = _cand_case(name)
    want = _jax_cand_min2(score, cand, price_n)
    before = sparse2.sparse_priced_min2_cand.launches
    got = sparse2.sparse_priced_min2_cand(_t(score), _t(cand), _t(price_n))
    assert sparse2.sparse_priced_min2_cand.launches == before  # plain, CPU
    assert len(got) == 5
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    # The same as the ungathered entry point on the gathered price.
    price_pk = _t(price_n)[_t(cand).clamp(0, price_n.shape[0] - 1).long()]
    for g, w in zip(got[:4], sparse2.sparse_priced_min2(_t(score), price_pk)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("bad,exc,match", [
    ("cand_int64", TypeError, "int32 cand"),
    ("cand_shape", ValueError, "cand shape"),
    ("price_2d", ValueError, "1-D price_n"),
    ("price_empty", ValueError, "1-D price_n"),
    ("k0", ValueError, "K >= 1"),
    ("meta", RuntimeError, "no kernel"),
    ("mixed_devices", ValueError, "every input"),
])
def test_sparse_min2_cand_refuses_bad_inputs(bad, exc, match):
    score = torch.zeros(4, 3)
    cand = torch.zeros(4, 3, dtype=torch.int32)
    price_n = torch.zeros(10)
    if bad == "cand_int64":
        cand = cand.long()
    elif bad == "cand_shape":
        cand = cand[:, :2]
    elif bad == "price_2d":
        price_n = price_n[None, :]
    elif bad == "price_empty":
        price_n = price_n[:0]
    elif bad == "k0":
        score, cand = score[:, :0], cand[:, :0]
    elif bad == "meta":
        score, cand, price_n = (t.to("meta") for t in (score, cand, price_n))
    else:
        price_n = price_n.to("meta")
    with pytest.raises(exc, match=match):
        sparse2.sparse_priced_min2_cand(score, cand, price_n)


@pytest.mark.parametrize("k,offsets,want", [
    (16, (0, 0), "vec4"), (32, (0, 0), "vec4"), (4, (0, 0), "vec4"),
    (37, (0, 0), "scalar"), (1, (0, 0), "scalar"), (18, (0, 0), "scalar"),
    (16, (1, 0), "scalar"), (16, (0, 2), "scalar"), (16, (4, 4), "vec4"),
])
def test_sparse_load_variant(k, offsets, want):
    """16-byte loads only where K % 4 == 0 and both [P, K] operands
    start on a 16-byte boundary (an offset in elements of 4 bytes)."""
    ops = [torch.zeros(3 * k + off)[off:].view(3, k) for off in offsets]
    assert sparse2.load_variant(k, *ops) == want


@pytest.mark.parametrize("widths,want", [
    ((1, 1, 2, 2), "n1r1t2a2"),  # main path, replica slot (1 rack rule)
    ((0, 1, 1, 1), "n0r1t1a0"),  # main path, rule-less primary slot
    ((0, 2, 1, 1), "n0r2t1a0"),  # small plan, primary with 2 replicas
    ((1, 2, 3, 3), "n1r2t3a3"),  # small plan, its replica slots
    ((0, 1, 1, 3), "n0r1t1a0"),  # A does not matter without rules
    ((2, 2, 2, 2), "generic"),
    ((1, 1, 1, 2), "generic"),
    ((1, 2, 3, 2), "generic"),
])
def test_fused_variant_picks_instantiation(widths, want):
    assert score_fused.fused_variant(*widths) == want


def test_fused_variants_cover_main_path_shapes(monkeypatch):
    """A small plan with the north-star's shape of problem (primary +
    replica, one rack rule, removed nodes) on the fused engine launches
    only widths with a fixed-width instantiation, and the ones the table
    names for it."""
    seen = []
    real = ttensor.fused_score_min2

    def spy(price, si, pbase, noff, *, nrules, jitter_scale):
        seen.append(score_fused.fused_variant(
            nrules, si.prev_state.shape[1], si.taken.shape[1],
            si.present.shape[1]))
        return real(price, si, pbase, noff, nrules=nrules,
                    jitter_scale=jitter_scale)

    monkeypatch.setattr(ttensor, "fused_score_min2", spy)
    rng = np.random.default_rng(0)
    n = 100
    nodes = [f"n{i:03d}" for i in range(n)]
    hier = {nd: f"r{i // 25:02d}" for i, nd in enumerate(nodes)}
    hier.update({f"r{i:02d}": "z0" for i in range(n // 25)})
    prim = rng.integers(0, n, 800)
    repl = (prim + 1 + rng.integers(0, n - 1, 800)) % n
    prev = {str(i): bt.Partition(str(i), {"primary": [nodes[a]],
                                          "replica": [nodes[b]]})
            for i, (a, b) in enumerate(zip(prim.tolist(), repl.tolist()))}
    opts = bt.PlanOptions(node_hierarchy=hier, hierarchy_rules={
        "replica": [bt.HierarchyRule(include_level=2, exclude_level=1)]})
    ttensor.set_fused_score_default("on")
    try:
        bt.plan_next_map(prev, prev, nodes, nodes[:5], [],
                         bt.model(primary=(0, 1), replica=(1, 1)), opts,
                         backend="cuda", device="cpu")
    finally:
        ttensor.set_fused_score_default("auto")
    assert seen and set(seen) <= {"n1r1t2a2", "n0r1t1a0"}
    assert "n1r1t2a2" in seen


def test_reset_clears_launches_and_variants():
    for fn in (sparse2.sparse_priced_min2_cand, score_fused.fused_score_min2):
        fn.launches += 3
        fn.variants["x"] += 3
    reset_launch_counts()
    assert all(v == {} for v in launch_variants().values())
    assert sparse2.sparse_priced_min2_cand.launches == 0
    assert score_fused.fused_score_min2.launches == 0


def test_fused_variant_table_matches_kernel_launcher():
    """The launcher in csrc/score_fused.cu dispatches the ids in the
    order of FUSED_VARIANTS (it refuses widths of another instantiation,
    so a drift would only show as a refused launch on the card)."""
    import os
    import re

    src = os.path.join(os.path.dirname(score_fused.__file__), "csrc",
                       "score_fused.cu")
    with open(src) as f:
        cases = re.findall(r"case (-?\d+): return launch<([^>]*)>", f.read())
    table = {int(i): tuple(int(w) if w.strip().lstrip("-").isdigit() else -1
                           for w in args.split(","))
             for i, args in cases}
    assert table.pop(-1) == (-1, -1, -1, -1)
    assert table == dict(enumerate(score_fused.FUSED_VARIANTS))


def test_write_variant_table_matches_kernel_launcher():
    """The score write's launchers dispatch the same ids to the same
    widths, so the wrapper's variant ids serve both kernels: the
    fixed-width ids in csrc/score_write.cu, runtime widths (-1) alone in
    csrc/score_write_any.cu."""
    import os
    import re

    def table(name):
        src = os.path.join(os.path.dirname(score_fused.__file__), "csrc",
                           name)
        with open(src) as f:
            cases = re.findall(r"case (-?\d+): return launch_write<([^>]*)>",
                               f.read())
        return {int(i): tuple(int(w) if w.strip().lstrip("-").isdigit()
                              else -1 for w in args.split(","))
                for i, args in cases}

    assert table("score_write_any.cu") == {-1: (-1, -1, -1, -1)}
    assert table("score_write.cu") == dict(
        enumerate(score_fused.FUSED_VARIANTS))
