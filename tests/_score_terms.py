"""Random terms of the matrix engine's score, for the score write's tests
on the CPU (tests/test_torch_score_write.py) and on the card
(tests/test_torch_cuda.py): the matrix build (``plan/tensor.py``
``_matrix_score``) and the packed inputs of the score write on the same
terms, on whichever device the terms lie."""

import numpy as np
import torch

from blance_tpu_torch.ops import score_fused
from blance_tpu_torch.plan import tensor as ttensor

RULES = ((2, 1), (1, 0))


def terms(seed, p, n, t_width, a_width=2, r_width=2, anchors=True,
          neg=True):
    """Random score terms over ``n`` nodes on racks under zones: ids -1
    or global node ids, 15% of the nodes removed, a third of them with a
    negative weight (``neg``), no anchor at all unless ``anchors``."""
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    rack = rng.integers(0, 7, n).astype(np.int32)

    def ids(*shape):
        return t(rng.integers(-1, n, shape).astype(np.int32))

    anchor_ids = ids(p, a_width)
    if not anchors:
        anchor_ids[:] = -1
    return dict(
        total=t(rng.integers(0, 60, n).astype(np.float32)),
        w_div=t(rng.integers(1, 4, n).astype(np.float32)),
        neg_boost=t(np.where(neg & (rng.random(n) < 0.3),
                             rng.integers(1, 4, n), 0).astype(np.float32)),
        valid=t(rng.random(n) < 0.85),
        stick=t(np.where(rng.random(p) < 0.5, 1.5, 2.0).astype(np.float32)),
        prev_slot=ids(p), prev_state=ids(p, r_width),
        taken=tuple(ids(p) for _ in range(t_width)), anchors=anchor_ids,
        gids=t(np.stack([np.arange(n, dtype=np.int32), rack, rack // 3])),
        gid_valid=t(rng.random((3, n)) < 0.9))


def stacked(per: list) -> dict:
    """A batch of same-shaped terms, each array with a leading [B]."""
    return {k: tuple(torch.stack(v) for v in zip(*(d[k] for d in per)))
            if k == "taken" else torch.stack([d[k] for d in per])
            for k in per[0]}


def on(tm: dict, dev) -> dict:
    return {k: tuple(x.to(dev) for x in v) if k == "taken" else v.to(dev)
            for k, v in tm.items()}


def _shard(tm, noff, n_l):
    n_l = tm["total"].shape[-1] if n_l is None else n_l
    sl = {k: tm[k][..., noff:noff + n_l]
          for k in ("total", "w_div", "neg_boost", "valid")}
    return sl, tm["gids"][..., noff:noff + n_l]


def matrix_build(tm, nrules, total_p, pbase=0, noff=0, n_l=None):
    """``_matrix_score`` on the terms (a node shard's ``n_l`` columns
    from ``noff`` on): the plain write on the CPU, the kernel on the
    card."""
    sl, gids_cand = _shard(tm, noff, n_l)
    return ttensor._matrix_score(
        sl["total"], total_p, sl["w_div"], sl["neg_boost"], sl["valid"],
        tm["stick"], tm["prev_slot"], tm["prev_state"], tm["anchors"],
        tm["gids"], tm["gid_valid"], RULES[:nrules], tm["taken"],
        pbase=pbase, noff=noff, gids_cand=gids_cand)


def packed(tm, nrules, total_p, noff=0, n_l=None):
    """The score write's packed inputs on the same terms."""
    sl, gids_cand = _shard(tm, noff, n_l)
    return score_fused.pack_score_inputs(
        total_l=sl["total"], total_p=total_p, w_div_l=sl["w_div"],
        neg_boost_l=sl["neg_boost"], valid_l=sl["valid"],
        stickiness_si=tm["stick"], prev_slot=tm["prev_slot"],
        prev_state=tm["prev_state"], taken_ids=list(tm["taken"]),
        anchors=tm["anchors"], gids_l=gids_cand, gid_valid=tm["gid_valid"],
        gids=tm["gids"], rules=RULES[:nrules])


def bitwise(got, want):
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape
    assert torch.equal(got.cpu().view(torch.int32),
                       want.cpu().view(torch.int32))
