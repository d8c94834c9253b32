"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and PyTorch; imports
nothing of jax or of the JAX package.  In order:

1. builds every kernel under blance_tpu_torch/ops/csrc with nvcc for
   sm_90a, all at once, and times the build;
2. holds each kernel against its plain PyTorch version on the card,
   bitwise: the priced min2 at [100000, 10000] (quantized scores, many
   ties) and at a ragged [4099, 777]; the in-kernel score, all four
   outputs, at [100000, 10000] in the main path's two instantiations
   (the replica's one rack rule, two anchors, two taken columns; the
   rule-less primary) and in the runtime-width one (two rules, R = 2,
   T = 2) at [4099, 777], whose last row tile is ragged; the score write
   (the matrix engine's [P, N] score) on the same inputs; the sparse min2
   at [1000000, 16] (ties, +inf pad columns, all-+inf rows), [4099, 37]
   and [7, 1] in both instantiations: the [P, K]-price one on all four
   outputs, and the gathered one the sparse engine calls (candidate ids
   with -1 pads, ids >= N and repeats, an [N] price row) on all five;
   then the narrow sweep (the ``narrow`` line): both the min2 and the
   in-kernel score at every N from 8 to 4096 (2^24 cells each),
   unbatched and batched, and min2 at N = 1024 on views off 16-byte
   alignment, in the layout each wrapper picks (rows per warp below its
   table's last bound) and in the wide one (past the table: its last
   narrow layout), each bitwise the plain version and timed
   (quantized scores, whole +inf rows, rows finite only in their last
   column, N = 777 with its 4-byte loads, problems priced all +inf or
   +inf but in the last column); then the small plan path, 2048 x 64
   through plan_next_map on the matrix and the fused engine, which must
   take the unbatched narrow layouts; each kernel, on the inputs of its
   first call there, joins the ``kernels`` line with ``path="small"``,
   its wide layout timed beside it (the score write, from the matrix
   engine's run, without one: its layout is set by N alone);
3. small plans on the card equal the plain CPU path's map for map (both
   dense engines, and the sparse engine with K < N), and a saturating
   K = N sparse plan equals the dense matrix engine's;
4. drives plan_next_map(backend="cuda") at the north-star deployment
   (100k partitions x 10k nodes, primary + 1 replica, racks of 25 under
   one zone, replica on another rack, 5% of nodes removed) on the engine
   auto picks, then again on the in-kernel score engine; then runs it
   under the device observatory (the ``obs`` line): both engines'
   plans with ``obs.device.enable()``, a fresh recorder and a Chrome
   trace with a torch.profiler log dir (maps bitwise the plain map,
   each engine's kernel launched and in the profiler's trace, one
   sweep-trace sample per sweep, the cold solve's peak allocation
   published once, the exposition parsing with nothing undeclared),
   ``device_check --check`` on the card in a cold process, and the
   membudget table's ``smoke`` and ``north`` rows on the card, each
   within its budget (both in processes of their own, beside the
   traced plans), then the plan's wall time with the observatory off
   and on (a warm-up call, then 5 alternating pairs: the solve stage's
   medians within 5%, the walls' within their spread);
5. builds the sparse deployment's shortlist (the same shape at 1M
   partitions x 10k nodes) and runs its sparse solve (3 sweeps) on the
   card and on the CPU, array for array equal, then drives
   plan_next_map(backend="cuda") there with ``sparse=None``, which must
   route to the sparse engine.  Every main-path run must pass the audit
   with every count 0, place nothing on a removed node, fill every slot,
   and launch its engine's kernel in the instantiation that step 2
   timed;
6. diffs the north-star plan into moves on the card (``calc_all_moves``,
   both emission orders): the device diff equals the CPU's array for
   array and the host ``calc_partition_moves`` on every partition;
7. drives the one-shot ``rebalance()`` (plan -> diff -> orchestrate) at
   the north star against an in-memory data plane that replays each op:
   it must finish without errors, execute exactly the diff's ops, reach
   the plain plan's map with a clean audit and nothing on a removed node,
   and its plan must launch the min2 kernel; a small rebalance on the
   card must equal the CPU's, map and op log (the ``rebalance`` line);
8. replans through the port's PlannerSession (the warm carry): at the
   north star a cold replan after the 5% removal, then 1% of the
   surviving nodes removed and a warm replan, which must be a one-sweep
   carry hit bitwise equal to a cold twin session's replan, audit-clean,
   with moves() equal to calc_all_moves, on the matrix engine (min2
   kernel) and again on the in-kernel score engine; at the sparse
   deployment a warm repair of the card's solve (3 sweeps) after 100 more
   nodes go (accepted or declined, both valid), its repair sweep on the
   card equal to the CPU's array for array, through the sparse kernel;
   and a small rebalance(session=) and RebalanceController(session=) on
   the card equal to the CPU's, map, op log and counters (the
   ``session`` line);
9. runs the fused plan pipeline (the ``pipeline`` line): at the north
   star ``plan_pipeline`` on the matrix engine (both emission orders) and
   on the in-kernel score engine, each against a staged twin
   (plan_next_map, then calc_all_moves on the card): map, warnings and
   moves equal, the engine's kernel launched, no fallback, and no more
   device-to-host copies (``Memcpy DtoH`` activities under
   torch.profiler) than the twin; ``plan_next_map`` with
   ``fused_pipeline`` equal too; twin sessions, ``replan_with_moves()``
   beside ``replan()`` + ``moves()``, cold and after the 1% delta warm,
   bitwise equal; at the sparse deployment ``plan_pipeline`` with
   ``sparse=None`` on the sparse engine, equal to the staged sparse
   plan's map and to calc_all_moves.  The native marshal extension must
   have loaded, and at the north star encode and decode give the same
   arrays and map with and without it;
10. runs the exact backends on the card's host (the ``exact`` line): the
   native planner must build from the port's own planner.cpp;
   backend="auto" routes 1024 x 255 nodes (261 120 cells) to native
   (no kernel launched) and 1024 x 256 to the card (min2 launched);
   native and greedy give the same map and warnings at BASELINE.json's
   second configuration (4096 x 64, primary + 2 replicas, rack rules);
   a node_sorter hook on backend="cuda" and in plan_pipeline takes the
   exact path (greedy's map, engine "exact-fallback", the pipeline's
   moves equal to calc_partition_moves); bench.py's exact CPU baseline
   (100k x 1k, one pass) runs through native beside the card, both
   audit-clean, and native against the card's plan wall time at eight
   sizes from 4096 cells to 64 times the threshold (the median of 3
   calls after a warm-up);
11. plans with shape bucketing (the ``bucketed`` line): the north star
   padded to 106 496 x 10 240 on the matrix and the fused engines
   (audit 0, no empty slot, no pad node; churn and spread beside the
   unbucketed plan's; plan_pipeline equal to the staged bucketed plan in
   map, warnings and moves), the north-star solve with p_real unpadded
   and padded equal on the real rows, a small off-bucket plan on the
   card equal to the CPU's on each engine, and the 1M sparse deployment
   padded to 1 048 576 on the sparse engine; each kernel, on the inputs
   the bucketed runs gave its first call, bitwise its plain version at
   the padded shape (added to the ``kernels`` line with
   ``path="bucketed"``; the score write from the matrix engine's run);
12. runs the fleet tier (the ``fleet`` line): bench.py's fleet stage
   (64 tenants, P 17-20 x N 8, two classes) through ``solve_fleet`` on
   the card, each tenant bitwise its single bucketed solve on the card
   and the port's CPU ``solve_fleet``, batched against the sequential
   loop (the median of 3 after a warm-up); a wave of 240 tenant indexes
   of up to 1024 partitions on 64 nodes (P 960-1024, two classes), cold
   and then warm after one held node per tenant goes, each tenant
   bitwise its single ``solve_dense_converged`` / ``solve_dense_warm``;
   ``PlanService`` over the wave's 240 concurrent requests (results equal
   the batched wave, p50/p99 latency); ``fused_score="on"`` on the bench
   tenants (each its single fused solve, the batched launch counted);
   the wave's cold batch with ``fused_score="on"`` (each tenant its
   single fused solve); and a ``FleetController`` of 8 tenants through
   one zone outage on the card and the CPU (maps and op logs equal).
   The batched launches take the narrow-row layouts (checked).  The
   batched min2 at the wave's [240, 1024, 64] and the batched in-kernel
   score at the bench tenants' class and at the wave's [240, 1024, 64]
   join the ``kernels`` line with ``path="fleet"``, each with its wide
   layout (the batched launch before the narrow rows) timed beside it,
   and so does the batched score write on the inputs of the wave's
   first replica-slot call at [240, 1024, 64];
13. drives the port's testing harness on the card (the ``harness``
   line): the five committed traces under tests/traces/ with
   ``device="cuda"``, each byte for byte the file (the pause guard's
   schedule replayed ok), the fleet trace's solves through the batched
   min2; spot_preemption(11) and mixed_week(7) on the card's planner
   (``backend="cuda"``), without and with a PlannerSession, each log on
   the card equal to its log on the CPU with min2 launched; the fleet
   week (240 tenants on 18 nodes, 7 virtual days) complete, every tenant
   available at the end, nothing unconverged, at least 4 plan requests a
   dispatch, its log and exposition hashing to the JAX package's pinned
   digests; and the schedule explorer's seeded walks over every scenario,
   clean and with the CPU's signatures; all inside the phase's budget.
   min2, on the inputs of its first unbatched (closed loop) and batched
   (fleet simulator) calls on the card, joins the ``kernels`` line with
   ``path="harness"``, its wide layout timed beside it, and so does the
   score write on the inputs of its first such calls;
14. runs the port's analysis gate (the ``analysis`` line):
   ``analysis.run_all(shape_audit=True, device="cuda")``, the AST lints
   over the package on the host and the 72 shape contracts on the card
   (then the 4 host checks; the 12 sharded ones on a 2-rank mesh on the
   card), with no new finding, no stale pin and no analyzer error, the
   audit launching min2 (unbatched and batched) and the sparse kernel,
   all inside the phase's budget; min2 and the score write on the
   inputs of their first unbatched and batched audit calls and the
   sparse kernel on its first join the ``kernels`` line with
   ``path="analysis"``;
15. shards the solves over meshes of ranks on the one card (the
   ``sharded`` line; parallel/mesh.py, parallel/sharded.py): starts a
   4-rank 1-D mesh, a 2x2 mesh (both gloo: the ranks share the card)
   and a 1-rank nccl mesh, each timed on its own; solves the north star
   on the 4-rank mesh (the engine each shard resolves, then the
   in-kernel score) and on the 2x2 mesh, each audit-clean with nothing
   on a removed node and no empty slot, churn and spread beside the
   single-device plan's, the 2x2 map bitwise a 1-D 2-rank mesh's (the
   2-D contract) and the 1-rank nccl mesh's bitwise the unsharded
   solve; the 1M sparse deployment on 4 ranks (audit-clean, its
   exhausted and fallback rows); a 4096 x 256 rack problem on both
   meshes and engines bitwise the same mesh shapes on the CPU, and its
   K = N sparse solve bitwise the dense one; PlannerSession(mesh=) at
   the north star (the 1% delta a one-sweep carry hit equal to a cold
   twin, replan_with_moves() equal to replan() + moves()); the
   240-tenant wave through solve_fleet(mesh=) cold and warm and
   PlanService(mesh=), equal to the card's unmeshed wave; every rank's
   solve time, peak allocation, collectives (count, time, bytes) and
   host staging copies; inside the phase's 240 s budget.  min2 and the
   score write (row and column offsets non-zero) on the 2x2 north
   star's rank 3, the in-kernel score on the 4-rank north
   star's rank 1 and on the 4096 x 256 2x2 mesh's rank 3 (row and
   column offsets non-zero) and the sparse kernel on the 1M run's rank
   1 join the ``kernels`` line with ``path="sharded"``, each on the
   inputs of its first call there;
16. prints one JSON line of kernel measurements, the card's name and
   power limit, the script's wall time, and last
   ``{"ok": true, "device": {...}}``.  A kernel's ``ms`` is its device
   time per call, from back-to-back calls in a CUDA graph
   (``graph_ms``); ``ms_events`` times one call at a time between CUDA
   events, host launch time included (``time_ms``); plain and library
   times are per call between events.

After the checked runs, one more main-path run per engine goes under
torch.profiler, for the device's kernel time beside the solve's wall
time and the kernels that took it (the ``profile`` line).

Any failure raises and exits non-zero; without a card it exits non-zero
before printing any result.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import functools
import gc
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

import blance_tpu_torch as bt
from blance_tpu_torch.ops import (_build, launch_counts, launch_variants,
                                  reset_launch_counts)
from blance_tpu_torch.core import marshal
from blance_tpu_torch.core.encode import bucket_size, pad_problem_arrays
from blance_tpu_torch.core.order import sort_state_names
from blance_tpu_torch.core.shortlist import build_shortlist_core
from blance_tpu_torch.moves import batch as moves_batch
from blance_tpu_torch.obs import (Recorder, get_recorder, parse_prometheus,
                                  use_recorder)
from blance_tpu_torch.obs.sinks import InMemorySink
from blance_tpu_torch.ops import cost, reduce2, score_fused, sparse2
from blance_tpu_torch.ops.cost import LANE_INSTR_PER_S, fused_ops_per_cell
from blance_tpu_torch import durability, fleetloop
from blance_tpu_torch.analysis import schedule
from blance_tpu_torch.plan import fleet
from blance_tpu_torch.plan import native as native_planner
from blance_tpu_torch.plan import service as plan_service
from blance_tpu_torch.plan import tensor as T
from blance_tpu_torch.testing import (crashsim, fleetsim, scenarios, sched,
                                      simulate)
from blance_tpu_torch.utils.trace import PhaseTimer

P_MAIN, N_MAIN = 100_000, 10_000
P_SPARSE = 1_000_000  # the sparse engine's deployment: 1M x 10k


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median per-call time, CUDA events around each call: device time
    plus whatever the host adds before the launch reaches the card
    (right for calls that take milliseconds)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device time per call of a kernel wrapper: ``calls`` calls captured
    in one CUDA graph, the graph replayed between two CUDA events, the
    median over ``replays`` divided by ``calls``.  No host time between
    launches, so a kernel of tens of microseconds is timed as the card
    runs it."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del g
    return float(np.median(times))


def compare(got, want, what: str) -> float:
    """Bitwise equality of output tuples; returns the max abs error over
    the finite float outputs (0.0 when bitwise equal)."""
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{what}: output {i} is {g.dtype}{tuple(g.shape)}"
                                 f", plain gives {w.dtype}{tuple(w.shape)}")
        same = (g == w) | (torch.isnan(g) & torch.isnan(w)) \
            if g.is_floating_point() else g == w
        if not bool(same.all()):
            bad = int((~same).sum())
            row = int(torch.nonzero(~same)[0, 0])
            raise AssertionError(
                f"{what}: output {i} differs from the plain version in {bad}"
                f" rows (first row {row}: kernel {g[row].item()!r}, plain "
                f"{w[row].item()!r})")
        if g.is_floating_point():
            fin = torch.isfinite(g) & torch.isfinite(w)
            if bool(fin.any()):
                err = max(err, float((g[fin] - w[fin]).abs().max()))
    return err


def check_min2(dev: torch.device) -> dict:
    gen = torch.Generator(device=dev).manual_seed(7)
    out = {}
    for p, n in ((P_MAIN, N_MAIN), (4099, 777)):
        # Quantized scores force duplicate minima (tie-break coverage).
        score = torch.randint(0, 50, (p, n), generator=gen, device=dev) \
            .to(torch.float32) * 0.125
        price = torch.randint(0, 8, (n,), generator=gen, device=dev) \
            .to(torch.float32) * 0.25
        got = reduce2.priced_min2_argmin(score, price)
        want = reduce2.min2_argmin_reference(score + price[None, :])
        err = compare(got, want, f"priced_min2_argmin [{p}, {n}]")
        log(f"min2 kernel == plain at [{p}, {n}] (bitwise)")
        if (p, n) == (P_MAIN, N_MAIN):
            eff = score + price[None, :]
            kernel = lambda: reduce2.priced_min2_argmin(score, price)  # noqa: E731
            out = dict(
                max_abs_err=err, ms=graph_ms(kernel), ms_events=time_ms(kernel),
                plain_ms=time_ms(lambda: reduce2.min2_argmin_reference(
                    score + price[None, :]), reps=3),
                library_ms=time_ms(lambda: torch.topk(
                    eff, 2, dim=1, largest=False), reps=3))
            out.update(_bound(*cost.min2_work(score, price)))
            del eff
        del score, price, got, want
    return out


# Each kernel's bound from its work on these inputs: the formulas of
# blance_tpu_torch/ops/cost.py, which the device observatory's
# device.flops / device.hbm_bytes gauges count with too.
_bound = cost.bound


def fused_inputs(dev: torch.device, p: int = P_MAIN, n: int = N_MAIN,
                 state: str = "replica", seed: int = 11):
    """The in-kernel score's inputs in the main path's instantiations:
    the replica slot (one rack rule; anchors the primary and, on half the
    rows, a pinned replica; taken the primary and that pin, T = 2;
    R = 1) or the rule-less primary slot (taken the primary's pin).
    Returns (price, ScoreInputs, nrules)."""
    rng = np.random.default_rng(seed)
    t = lambda x: torch.from_numpy(np.asarray(x)).to(dev)  # noqa: E731
    nodes = np.arange(n, dtype=np.int32)
    gids = t(np.stack([nodes, nodes // 25, np.zeros(n, np.int32)]))
    primary = rng.integers(0, n, p).astype(np.int32)
    replica = ((primary + 1 + rng.integers(0, n - 1, p)) % n).astype(np.int32)
    valid = np.ones(n, bool)
    valid[rng.choice(n, n // 20, replace=False)] = False
    anchors = np.stack([primary, np.where(rng.random(p) < 0.5, replica, -1)],
                       axis=1).astype(np.int32)
    rules = ((2, 1),) if state == "replica" else ()
    si = score_fused.pack_score_inputs(
        total_l=t(rng.integers(0, 40, n).astype(np.float32)), total_p=p,
        w_div_l=t(np.ones(n, np.float32)),
        neg_boost_l=t(np.zeros(n, np.float32)), valid_l=t(valid),
        stickiness_si=t(np.full(p, 1.5, np.float32)),
        prev_slot=t(replica if rules else primary),
        prev_state=t((replica if rules else primary)[:, None]),
        taken_ids=[t(primary), t(anchors[:, 1])] if rules else [t(primary)],
        anchors=t(anchors), gids_l=gids,
        gid_valid=t(np.ones((3, n), bool)), gids=gids, rules=rules)
    price = t((rng.integers(0, 3, n) * 0.5 + np.where(
        rng.random(n) < 0.1, 1e9, 0)).astype(np.float32))
    return price, si, len(rules)


def generic_fused_inputs(dev: torch.device, p: int, n: int):
    """Widths no fixed instantiation covers (two rules, R = 2, T = 2,
    A = 2), for the runtime-width one."""
    rng = np.random.default_rng(12)
    t = lambda x: torch.from_numpy(np.asarray(x)).to(dev)  # noqa: E731
    rack = rng.integers(0, 7, n).astype(np.int32)
    gids = t(np.stack([np.arange(n, dtype=np.int32), rack, rack // 3]))
    taken = rng.integers(-1, n, (p, 2)).astype(np.int32)
    si = score_fused.pack_score_inputs(
        total_l=t(rng.integers(0, 60, n).astype(np.float32)), total_p=p,
        w_div_l=t(rng.integers(1, 4, n).astype(np.float32)),
        neg_boost_l=t(np.where(rng.random(n) < 0.3, 2.0, 0.0)
                      .astype(np.float32)),
        valid_l=t(rng.random(n) < 0.9),
        stickiness_si=t(np.full(p, 1.5, np.float32)),
        prev_slot=t(rng.integers(-1, n, p).astype(np.int32)),
        prev_state=t(rng.integers(-1, n, (p, 2)).astype(np.int32)),
        taken_ids=[t(taken[:, 0]), t(taken[:, 1])],
        anchors=t(rng.integers(-1, n, (p, 2)).astype(np.int32)),
        gids_l=gids, gid_valid=t(rng.random((3, n)) < 0.9), gids=gids,
        rules=((2, 1), (1, 0)))
    price = t((rng.random(n) + np.where(rng.random(n) < 0.2, 1e9, 0))
              .astype(np.float32))
    return price, si, 2


def check_fused(dev: torch.device) -> dict:
    """The in-kernel score against its plain version, all four outputs
    bitwise, in the main path's two instantiations at [100000, 10000]
    and the runtime-width one at a ragged [4099, 777]; timed in the
    replica's instantiation, which carries most main-path launches."""
    kw = dict(jitter_scale=T._JITTER)
    out = {}
    for what, (price, si, nrules) in (
            ("replica", fused_inputs(dev)),
            ("primary", fused_inputs(dev, state="primary")),
            ("generic", generic_fused_inputs(dev, 4099, 777))):
        p, n = si.stick.shape[0], price.shape[0]
        widths = (nrules, si.prev_state.shape[1], si.taken.shape[1],
                  si.present.shape[1])
        variant = score_fused.fused_variant(*widths)
        if (what == "generic") != (variant == "generic"):
            raise AssertionError(f"fused {what} inputs pick {variant}")
        got = score_fused.fused_score_min2(price, si, 0, 0, nrules=nrules,
                                           **kw)
        want = score_fused.fused_score_min2_reference(
            price, si, 0, 0, nrules=nrules, **kw)
        err = compare(got, want, f"fused_score_min2 {variant} [{p}, {n}]")
        log(f"fused score kernel == plain at [{p}, {n}], {variant} "
            f"(bitwise, 4 outputs)")
        if what != "replica":
            continue
        ops_cell = fused_ops_per_cell(*widths[1:], nrules)
        kernel = lambda: score_fused.fused_score_min2(  # noqa: E731
            price, si, 0, 0, nrules=nrules, **kw)
        out = dict(
            timed_instantiation=variant, max_abs_err=err,
            ms=graph_ms(kernel, calls=5), ms_events=time_ms(kernel),
            plain_ms=time_ms(lambda: score_fused.fused_score_min2_reference(
                price, si, 0, 0, nrules=nrules, **kw), reps=2, warmup=1),
            library_ms=None,
            issue_floor_ms=p * n * ops_cell / LANE_INSTR_PER_S * 1e3)
        out.update(_bound(*cost.fused_work(price, si, nrules)))
    return out


def check_score_write(dev: torch.device) -> dict:
    """The score write against its plain version, bitwise, on the fused
    check's inputs (the main path's two instantiations at [100000,
    10000], the runtime-width one at [4099, 777]); timed in the
    replica's instantiation."""
    kw = dict(jitter_scale=T._JITTER)
    out = {}
    for what, (_price, si, nrules) in (
            ("replica", fused_inputs(dev)),
            ("primary", fused_inputs(dev, state="primary")),
            ("generic", generic_fused_inputs(dev, 4099, 777))):
        p, n = si.stick.shape[0], si.base.shape[0]
        variant = score_fused.fused_variant(
            nrules, si.prev_state.shape[1], si.taken.shape[1],
            si.present.shape[1])
        got = score_fused.score_write(si, 0, 0, nrules=nrules, **kw)
        want = score_fused.score_write_reference(si, 0, 0, nrules=nrules,
                                                 **kw)
        err = compare((got.flatten(),), (want.flatten(),),
                      f"score_write {variant} [{p}, {n}]")
        del got, want
        log(f"score write kernel == plain at [{p}, {n}], {variant} "
            "(bitwise)")
        if what != "replica":
            continue
        kernel = lambda: score_fused.score_write(  # noqa: E731
            si, 0, 0, nrules=nrules, **kw)
        out = dict(
            timed_instantiation=variant, max_abs_err=err,
            ms=graph_ms(kernel, calls=5), ms_events=time_ms(kernel),
            plain_ms=time_ms(lambda: score_fused.score_write_reference(
                si, 0, 0, nrules=nrules, **kw), reps=2, warmup=1),
            library_ms=None)
        out.update(_bound(*cost.score_write_work(si)))
        torch.cuda.empty_cache()
    return out


def sparse_inputs(gen, dev, p: int, k: int):
    """Quantized scores (many ties), +inf pad columns at the tail of
    every eighth row and whole +inf rows, as the engine makes them."""
    score = torch.randint(0, 40, (p, k), generator=gen, device=dev) \
        .to(torch.float32) * 0.125
    if k > 4:
        score[::8, -3:] = float("inf")
    score[3::97] = float("inf")
    return score


def check_sparse_min2(dev: torch.device) -> dict:
    """The sparse min2 kernel against its plain versions at the sparse
    main path's [1M, 16] and two ragged shapes, bitwise: the [P, K]-price
    instantiation on all four outputs, the gathered one on all five
    (candidate ids from N = 10 000 nodes with -1 pads, ids >= N and
    repeated ids; an [N] price row with closed nodes at 1e9).  Timed at
    [1M, 16]: the gathered kernel (what the engine launches), its plain
    composition, topk over the gathered priced block, and, beside them,
    the [P, K]-price kernel alone and with the two gathers the engine
    ran around it before."""
    gen = torch.Generator(device=dev).manual_seed(9)
    n = N_MAIN
    out = {}
    for p, k in ((P_SPARSE, 16), (4099, 37), (7, 1)):
        score = sparse_inputs(gen, dev, p, k)
        price = torch.randint(0, 6, (p, k), generator=gen, device=dev) \
            .to(torch.float32) * 0.25
        got = sparse2.sparse_priced_min2(score, price)
        want = sparse2.sparse_min2_reference(score, price)
        compare(got, want, f"sparse_priced_min2 [{p}, {k}]")
        log(f"sparse min2 kernel == plain at [{p}, {k}] (bitwise, 4 outputs)")
        cand = torch.randint(0, n, (p, k), generator=gen, device=dev) \
            .to(torch.int32)
        if k > 4:
            cand[::8, -3:] = -1
            cand[5::13, 2] = n + 7
            cand[1::3, 1] = cand[1::3, 0]
        price_n = torch.randint(0, 6, (n,), generator=gen, device=dev) \
            .to(torch.float32) * 0.25
        price_n[::10] = 1e9
        got = sparse2.sparse_priced_min2_cand(score, cand, price_n)
        want = sparse2.sparse_min2_cand_reference(score, cand, price_n)
        err = compare(got, want, f"sparse_priced_min2_cand [{p}, {k}]")
        log(f"gathered sparse min2 kernel == plain at [{p}, {k}] "
            f"(bitwise, 5 outputs)")
        if p == P_SPARSE:
            cand_c = cand.clamp(0, n - 1).long()

            def unfused():
                b, kidx, s2, raw = sparse2.sparse_priced_min2(
                    score, price_n[cand_c])
                return cand.gather(1, kidx.long()[:, None])

            kernel = lambda: sparse2.sparse_priced_min2_cand(  # noqa: E731
                score, cand, price_n)
            out = dict(
                timed_instantiation=sparse2.load_variant(k, score, cand),
                max_abs_err=err, ms=graph_ms(kernel),
                ms_events=time_ms(kernel),
                plain_ms=time_ms(lambda: sparse2.sparse_min2_cand_reference(
                    score, cand, price_n), reps=3),
                library_ms=time_ms(lambda: torch.topk(
                    score + price_n[cand.clamp(0, n - 1).long()], 2, dim=1,
                    largest=False), reps=3),
                ungathered_ms=graph_ms(lambda: sparse2.sparse_priced_min2(
                    score, price)),
                ungathered_with_gathers_ms=graph_ms(unfused))
            # score and cand read once, the [N] price row once, five [P]
            # outputs written; a price add and two compares per element.
            out.update(_bound(*cost.sparse_cand_work(score, cand,
                                                     price_n)))
            del cand_c
        del score, price, cand, price_n, got, want
    return out


def north_star_map(p: int = P_MAIN, n: int = N_MAIN):
    """The bench.py build_dense deployment as a PartitionMap, seed 0, at
    ``p`` partitions x ``n`` nodes (10k)."""
    rng = np.random.default_rng(0)
    nodes = [f"n{i:05d}" for i in range(n)]
    hier = {nd: f"r{i // 25:04d}" for i, nd in enumerate(nodes)}
    hier.update({f"r{i:04d}": "z0" for i in range(n // 25)})
    prim = rng.integers(0, n, p)
    repl = (prim + 1 + rng.integers(0, n - 1, p)) % n
    prev = {str(i): bt.Partition(str(i), {"primary": [nodes[a]],
                                          "replica": [nodes[b]]})
            for i, (a, b) in enumerate(zip(prim.tolist(), repl.tolist()))}
    removed = [nodes[i] for i in rng.choice(n, n // 20, replace=False)]
    opts = bt.PlanOptions(node_hierarchy=hier, hierarchy_rules={
        "replica": [bt.HierarchyRule(include_level=2, exclude_level=1)]})
    return prev, nodes, removed, bt.model(primary=(0, 1), replica=(1, 1)), \
        opts


def run_main_path(label, prev, nodes, removed, model, opts) -> dict:
    reset_launch_counts()
    timings: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, warn = bt.plan_next_map(prev, prev, nodes, removed, [], model, opts,
                                 backend="cuda", timings=timings)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    variants = launch_variants()
    problem = bt.encode_problem(prev, prev, nodes, removed, model, opts)
    after = bt.encode_problem(out, out, nodes, removed, model, opts)
    audit = bt.check_assignment(problem, after.prev)
    if any(audit.values()):
        raise AssertionError(f"{label}: audit not clean: {audit}")
    gone = set(removed)
    unassigned = sum(len(p.nodes_by_state.get(s, [])) != 1
                     for p in out.values() for s in ("primary", "replica"))
    on_removed = sum(nd in gone for p in out.values()
                     for ns in p.nodes_by_state.values() for nd in ns)
    if warn or unassigned or on_removed or len(out) != len(prev):
        raise AssertionError(f"{label}: {len(warn)} warnings, {unassigned} "
                             f"unassigned slots, {on_removed} copies on "
                             f"removed nodes")
    load = {nd: 0 for nd in nodes if nd not in gone}
    for p in out.values():
        for ns in p.nodes_by_state.values():
            for nd in ns:
                load[nd] += 1
    spread = max(load.values()) - min(load.values())
    moved = sum(out[k].nodes_by_state != prev[k].nodes_by_state for k in prev)
    info = dict(timings, wall_s=wall, launches=counts, variants=variants,
                audit=audit, load_spread=spread, partitions_moved=moved)
    log(f"{label}: {json.dumps(info)}")
    return info, out


def _placed(pmap_nbs) -> dict:
    """Placements by partition and state, empty states dropped."""
    return {k: {st: list(ns) for st, ns in nbs.items() if ns}
            for k, nbs in pmap_nbs.items()}


def diff_matches_host(prev, out, model, dev) -> dict:
    """The north-star plan diffed into moves on the card, in both emission
    orders: the device diff of the encoded maps equals the CPU's bitwise
    ([P, L] nodes, states and ops), and calc_all_moves on the card equals
    the host calc_partition_moves on every partition.  Times the device
    diff (a CUDA graph of back-to-back calls, and one call between events)
    and the whole calc_all_moves (host encode, device diff, materialize)
    on the host clock, with its spans, and profiles one diff call (its
    device kernels by name)."""
    states = sort_state_names(model)
    names, _nodes, beg, end, irregular = moves_batch.encode_maps(prev, out,
                                                                 states)
    beg_c, end_c = torch.from_numpy(beg), torch.from_numpy(end)
    beg_d, end_d = beg_c.to(dev), end_c.to(dev)
    res = {"P": len(names), "L": 2 * beg.shape[1] * beg.shape[2],
           "irregular": len(irregular)}
    for favor in (False, True):
        got = moves_batch.diff_assignments(beg_d, end_d,
                                           favor_min_nodes=favor)
        want = moves_batch.diff_assignments(beg_c, end_c,
                                            favor_min_nodes=favor)
        compare([g.cpu() for g in got], want,
                f"diff_assignments favor_min_nodes={favor}")
        diff = lambda: moves_batch.diff_assignments(  # noqa: E731
            beg_d, end_d, favor_min_nodes=favor)
        rec = Recorder()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with use_recorder(rec):
            moves = bt.calc_all_moves(prev, out, model, favor, device="cuda")
        calc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        bad = [name for name in names if moves[name] != bt.calc_partition_moves(
            states, prev[name].nodes_by_state, out[name].nodes_by_state,
            favor)]
        host_s = time.perf_counter() - t0
        if bad or list(moves) != names:
            raise AssertionError(f"calc_all_moves favor_min_nodes={favor} "
                                 f"differs from calc_partition_moves on "
                                 f"{len(bad)} partitions, first {bad[:3]}")
        spans = rec.summary()["spans"]
        ops = sum(len(m) for m in moves.values())
        rows = device_kernels(diff)
        res["favor_min_nodes" if favor else "availability"] = dict(
            diff_device_ms=graph_ms(diff), diff_events_ms=time_ms(diff),
            profile={"kernels": sum(r[2] for r in rows),
                     "device_ms": sum(r[1] for r in rows),
                     "top": [{"kernel": k[:80], "ms": ms, "calls": c}
                             for k, ms, c in rows[:4]]},
            calc_all_moves_s=calc_s,
            spans_s={k.split(".")[-1]: v["total_s"] for k, v in spans.items()},
            host_calc_partition_moves_s=host_s, ops=ops,
            partitions_moved=sum(1 for m in moves.values() if m))
        log(f"device diff [{len(names)}, {res['L']}] favor_min_nodes={favor}"
            f" == CPU (bitwise) == calc_partition_moves on every partition:"
            f" {json.dumps(res['favor_min_nodes' if favor else 'availability'])}")
    return res


def _replay_plane(current):
    """An in-memory data plane: replays each op onto a dict (no device
    work on the loop) and counts the ops; returns (cluster, counts,
    assign)."""
    cluster = {k: {st: list(ns) for st, ns in p.nodes_by_state.items()}
               for k, p in current.items()}
    done = {"ops": 0, "batches": 0}

    def assign(stop_ch, node, partitions, states, ops):
        for p, st, _op in zip(partitions, states, ops):
            for ns in cluster[p].values():
                if node in ns:
                    ns.remove(node)
            if st:
                cluster[p].setdefault(st, []).append(node)
        done["ops"] += len(ops)
        done["batches"] += 1

    return cluster, done, assign


REBALANCE_OPTIONS = dict(device_diff=True, interrupt_on_first_feed=False,
                         max_concurrent_partition_moves_per_node=4)


def rebalance_main_path(prev, nodes, removed, model, opts, plain_map,
                        diff) -> dict:
    """The port's one-shot rebalance() at the north star: plan on the card
    (matrix engine, min2 kernel), diff on the card, orchestrate against
    the replaying data plane with bench.py bench_pipeline's options."""
    cluster, done, assign = _replay_plane(prev)
    rec = Recorder()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with use_recorder(rec):
        res = bt.rebalance(model, prev, nodes, removed, [], assign,
                           plan_options=opts, backend="cuda", device="cuda",
                           orchestrator_options=bt.OrchestratorOptions(
                               **REBALANCE_OPTIONS))
    total_s = time.perf_counter() - t0
    counts = launch_counts()
    spans = rec.summary()["spans"]
    next_map = res.next_map
    problem = bt.encode_problem(prev, prev, nodes, removed, model, opts)
    after = bt.encode_problem(next_map, next_map, nodes, removed, model, opts)
    audit = bt.check_assignment(problem, after.prev)
    gone = set(removed)
    on_removed = sum(nd in gone for nbs in cluster.values()
                     for ns in nbs.values() for nd in ns)
    want_ops = diff["availability"]["ops"]
    checks = dict(
        min2_launched=counts["priced_min2_argmin"] >= 1,
        no_errors=not res.progress.errors and res.converged,
        ops_equal_diff=done["ops"] == want_ops,
        replay_equals_next_map=_placed(cluster) == _placed(
            {k: p.nodes_by_state for k, p in next_map.items()}),
        next_map_equals_plain_plan=bt.partition_map_to_json(next_map)
        == bt.partition_map_to_json(plain_map),
        audit_clean=not any(audit.values()),
        nothing_on_removed=on_removed == 0)
    timer = res.timer.totals
    info = dict(
        plan_s=timer["plan"], diff_device_ms=diff["availability"][
            "diff_device_ms"],
        device_diff_span_s=spans["moves.device_diff"]["total_s"],
        calc_all_moves_s=spans["moves.calc_all_moves"]["total_s"],
        orchestrate_s=timer["orchestrate"], total_s=total_s,
        ops=done["ops"], ops_from_diff=want_ops,
        partitions_moved=diff["availability"]["partitions_moved"],
        progress_events=res.progress_events,
        batches_ok=res.progress.tot_mover_assign_partition_ok,
        batches_fed=done["batches"], errors=len(res.progress.errors),
        launches=counts, audit=audit, options=REBALANCE_OPTIONS,
        checks=checks)
    log(f"rebalance (north star): {json.dumps(info)}")
    if not all(checks.values()):
        raise AssertionError(f"rebalance at the north star: {checks}")
    return info


def small_map(n: int = 64, p: int = 2048):
    """The small rebalance fixture, seed 5: p partitions over n nodes in
    racks of 8, replica on another rack, 3 nodes removed."""
    rng = np.random.default_rng(5)
    nodes = [f"s{i:02d}" for i in range(n)]
    hier = {nd: f"r{i // 8}" for i, nd in enumerate(nodes)}
    hier.update({f"r{i}": "z0" for i in range(n // 8)})
    prim = rng.integers(0, n, p)
    repl = (prim + 1 + rng.integers(0, n - 1, p)) % n
    prev = {str(i): bt.Partition(str(i), {"primary": [nodes[a]],
                                          "replica": [nodes[b]]})
            for i, (a, b) in enumerate(zip(prim.tolist(), repl.tolist()))}
    removed = [nodes[i] for i in rng.choice(n, 3, replace=False)]
    model = bt.model(primary=(0, 1), replica=(1, 1))
    opts = bt.PlanOptions(node_hierarchy=hier, hierarchy_rules={
        "replica": [bt.HierarchyRule(include_level=2, exclude_level=1)]})
    return prev, nodes, removed, model, opts


def small_rebalance_matches_cpu(dev) -> dict:
    """rebalance() at P = 2048, N = 64 on the card and on the CPU: the
    same final map and the same op log."""
    prev, nodes, removed, model, opts = small_map()
    n = len(nodes)
    out = []
    for device in (dev, "cpu"):
        oplog = []

        def assign(stop_ch, node, partitions, states, ops):
            oplog.extend(zip(partitions, [node] * len(ops), states, ops))

        res = bt.rebalance(model, prev, nodes, removed, [], assign,
                           plan_options=opts, backend="cuda", device=device,
                           orchestrator_options=bt.OrchestratorOptions(
                               **REBALANCE_OPTIONS))
        if res.progress.errors:
            raise AssertionError(f"small rebalance on {device}: "
                                 f"{res.progress.errors[:3]}")
        out.append((bt.partition_map_to_json(res.next_map), oplog))
    if out[0][0] != out[1][0] or out[0][1] != out[1][1] or not out[0][1]:
        raise AssertionError("small rebalance: the card's map or op log "
                             "differs from the CPU's")
    log(f"small rebalance [2048 x 64] on the card == CPU (map and "
        f"{len(out[0][1])} ops)")
    return {"P": 2048, "N": n, "ops": len(out[0][1]), "equal": True}


def small_map_matches_cpu(dev) -> None:
    rng = np.random.default_rng(3)
    nodes = [f"s{i:02d}" for i in range(40)]
    hier = {nd: f"r{i // 5}" for i, nd in enumerate(nodes)}
    hier.update({f"r{i}": "z0" for i in range(8)})
    prev = {str(i): bt.Partition(str(i), {
        "primary": [nodes[int(rng.integers(0, 40))]]}) for i in range(500)}
    rules = {"replica": [bt.HierarchyRule(2, 1)]}
    model = bt.model(primary=(0, 1), replica=(1, 2))

    def plan(device, mode="auto", **kw):
        T.set_fused_score_default(mode)
        timings: dict = {}
        out = bt.plan_next_map(
            prev, prev, nodes, nodes[:2], [], model,
            bt.PlanOptions(node_hierarchy=hier, hierarchy_rules=rules, **kw),
            device=device, timings=timings)
        T.set_fused_score_default("auto")
        return bt.partition_map_to_json(out[0]), out[1], timings["engine"]

    def same(got, want, what):
        if got[:2] != want[:2]:
            raise AssertionError(f"small plan: {what} differ")

    want = plan("cpu")
    for mode in ("off", "on"):
        same(plan(dev, mode), want, f"card ({mode}) and plain CPU path")
    sparse_cpu = plan("cpu", sparse=True, sparse_k=6)
    sparse_dev = plan(dev, sparse=True, sparse_k=6)
    if sparse_dev[2] != "sparse":
        raise AssertionError(f"sparse=True ran engine {sparse_dev[2]}")
    same(sparse_dev, sparse_cpu, "sparse K=6 on the card and on the CPU")
    same(plan(dev, sparse=True, sparse_k=len(nodes)), plan(dev, "off"),
         "saturating sparse K=N and the matrix engine on the card")
    log("small plans on the card == plain CPU path (both dense engines, "
        "sparse K=6); sparse K=N == matrix engine")


# Sweeps of the sparse solve held card against CPU at 1M x 10k: the CPU's
# sweeps cost 15 s apiece there, and the sweeps past the third run the
# same code on the same shapes as the first three.
SPARSE_PARITY_SWEEPS = 3


def sparse_engine_matches_cpu(prev, nodes, removed, model, opts,
                              dev) -> dict:
    """At the sparse deployment's full size, the shortlist and then the
    sparse solve (its first SPARSE_PARITY_SWEEPS sweeps, fallback
    included) on the card equal the plain CPU path's, array for array.
    The rotated window's int32 product wraps from row 53,021 on, so an
    int64 slip shows here.  Returns the card's and the CPU's seconds for
    each (device synchronised)."""
    problem = bt.encode_problem(prev, prev, nodes, removed, model, opts)
    rules = tuple(tuple(problem.rules.get(si, ())) for si in range(problem.S))
    cons = tuple(int(c) for c in problem.constraints)
    k = T._opts_shortlist_k(opts, problem.N, cons, rules)
    arrays = (problem.prev, problem.partition_weights, problem.node_weights,
              problem.valid_node, problem.stickiness, problem.gids,
              problem.gid_valid)
    built, solved, secs = [], [], {}
    for device in (dev, torch.device("cpu")):
        a = bt.problem_to_torch(*arrays, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        built.append(build_shortlist_core(
            a[0], a[1], a[2], a[3], a[5], a[6], cons, rules, k).cpu())
        t1 = time.perf_counter()
        stats: dict = {}
        solved.append(T.solve_sparse(*a, cons, rules, shortlist=built[-1],
                                     max_iterations=SPARSE_PARITY_SWEEPS,
                                     stats=stats))
        t2 = time.perf_counter()
        secs[device.type] = {"shortlist_s": t1 - t0, "solve_s": t2 - t1,
                             "sweeps": stats["sweeps"],
                             "exhausted_rows": stats["exhausted_rows"]}
    got, want = built
    if got.shape != want.shape or not bool((got == want).all()):
        bad = int((got != want).any(dim=1).sum()) \
            if got.shape == want.shape else -1
        raise AssertionError(f"shortlist [{problem.P}, {k}] on the card "
                             f"differs from the CPU's in {bad} rows")
    log(f"shortlist [{problem.P}, {k}] on the card == CPU (array for array)")
    bad = np.argwhere(solved[0] != solved[1])
    if bad.size:
        raise AssertionError(f"sparse solve [{problem.P}, {problem.N}] on the "
                             f"card differs from the CPU's at [p, s, r] "
                             f"{bad[:3].tolist()}")
    log(f"sparse solve [{problem.P}, {problem.N}] on the card == CPU: {secs}")
    return secs, dict(arrays=arrays, constraints=cons, rules=rules, k=k,
                      solved=solved[0])


SESSION_DELTA = 100  # nodes removed for the warm replans: 1% of 10k
_ENGINES = {"off": "matrix", "on": "fused"}


def session_delta(nodes, removed) -> list:
    """The session phases' delta: 1% of the surviving nodes, seed 17."""
    rng = np.random.default_rng(17)
    gone = set(removed)
    return sorted(rng.choice([nd for nd in nodes if nd not in gone],
                             SESSION_DELTA, replace=False).tolist())


def _plan_counts(after: dict, before: dict) -> dict:
    """The plan.* counters of ``after`` that moved since ``before``, by
    how much."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if k.startswith("plan.") and v != before.get(k, 0)}


def _session_replan(session, rec) -> dict:
    """One session replan with the launch counts set to 0 just before it
    and read just after; the replan's wall time, device synchronised,
    and the part of it spent inside the solver's ``plan.solve.attempt``
    spans (the repair or the converged solve, device synchronised)."""
    before = dict(rec.counters)
    span0 = rec.span_totals.get("plan.solve.attempt", 0.0)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = session.replan().copy()
    torch.cuda.synchronize()
    return dict(out=out, solve_s=time.perf_counter() - t0,
                solver_s=rec.span_totals.get("plan.solve.attempt", 0.0)
                - span0,
                launches=launch_counts(), variants=launch_variants(),
                counters=_plan_counts(rec.counters, before))


def _replan_info(r: dict, base, dirty_fraction=None) -> dict:
    return {"solve_s": r["solve_s"], "solver_s": r["solver_s"],
            "sweeps": r["counters"].get("plan.solve.sweeps", 0),
            "dirty_fraction": dirty_fraction,
            "partitions_moved": int(np.any(r["out"] != base,
                                           axis=(1, 2)).sum()),
            "launches": {k: v for k, v in r["launches"].items() if v},
            "counters": r["counters"]}


def session_north_star(prev, nodes, removed, model, opts, dev, mode,
                       fused_timed=None) -> dict:
    """The north star through a PlannerSession on engine ``mode``: load,
    remove 5%, cold replan (return_carry), apply; then 1% of the
    surviving nodes removed and a warm replan.  Checks: a carry hit of
    one sweep, no warm fallback, bitwise the replan of a cold twin
    session (same map, same removed set), audit zero, nothing on a
    removed node, the engine's kernel launched by the warm replan (the
    fused one in the instantiation the kernels phase timed), and on the
    matrix engine moves() equal to calc_all_moves on every partition."""
    T.set_fused_score_default(mode)
    try:
        delta = session_delta(nodes, removed)
        rec = Recorder()
        with use_recorder(rec):
            s = bt.PlannerSession(model, nodes, list(prev), opts=opts,
                                  device=dev)
            s.load_map(prev)
            s.remove_nodes(removed)
            first = _session_replan(s, rec)
            s.apply()
            base = s.current
            s.remove_nodes(delta)
            warm = _session_replan(s, rec)
            dirty = rec.histogram_summary("plan.solve.dirty_fraction")
            twin = bt.PlannerSession(model, nodes, list(prev), opts=opts,
                                     device=dev)
            twin.load_map(s.to_map("current")[0])
            twin.remove_nodes(removed + delta)
            cold = _session_replan(twin, rec)
        engine = T.resolve_default_fused_score(s.problem.P, s.problem.N, dev)
    finally:
        T.set_fused_score_default("auto")
    index = {nd: i for i, nd in enumerate(s.nodes)}
    ids = [index[nd] for nd in removed + delta]
    t0 = time.perf_counter()
    audit = bt.check_assignment(s.problem, warm["out"])
    audit_s = time.perf_counter() - t0
    kernel = "priced_min2_argmin" if mode == "auto" else "fused_score_min2"
    checks = dict(
        carry_hit=warm["counters"].get("plan.solve.carry_hit") == 1,
        no_warm_fallback="plan.solve.warm_fallback" not in warm["counters"],
        warm_one_sweep=warm["counters"].get("plan.solve.sweeps") == 1,
        equals_cold_twin=bool(np.array_equal(warm["out"], cold["out"])),
        audit_clean=not any(audit.values()),
        nothing_on_removed=not bool(np.isin(warm["out"], ids).any()),
        kernel_launched=warm["launches"][kernel] >= 1)
    if fused_timed is not None:
        checks["timed_instantiation_launched"] = \
            fused_timed in warm["variants"].get(kernel, {})
    info = dict(engine=_ENGINES[engine],
                delta_nodes=len(delta),
                first_cold=_replan_info(first, s.problem.prev),
                warm=_replan_info(warm, base, dirty and dirty["max"]),
                cold=_replan_info(cold, base),
                warm_over_cold=warm["solve_s"] / cold["solve_s"],
                variants=warm["variants"].get(kernel), audit=audit,
                audit_s=audit_s)
    info["solver_alternating"] = warm_vs_cold_solver(
        s, [index[nd] for nd in delta], engine)
    if mode == "auto":
        t0 = time.perf_counter()
        d_nodes, d_states, d_ops = s.moves()
        mv = moves_batch.moves_from_arrays(
            s.problem.partitions, s.problem.states, s.problem.nodes,
            d_nodes, d_states, d_ops)
        moves_s = time.perf_counter() - t0
        want = bt.calc_all_moves(s.to_map("current")[0],
                                 s.to_map("proposed")[0], model, False,
                                 device=dev)
        checks["moves_equal_calc_all_moves"] = mv == want
        info["moves"] = dict(moves_s=moves_s, ops=sum(map(len, mv.values())),
                             partitions=sum(1 for m in mv.values() if m))
    info["checks"] = checks
    log(f"session (north star, {info['engine']}): {json.dumps(info)}")
    if not all(checks.values()):
        raise AssertionError(f"session at the north star ({mode}): {checks}")
    return info


def warm_vs_cold_solver(s, delta_ids, mode: str, reps: int = 5) -> dict:
    """The solver alone on the session's warm delta (its adopted map,
    the delta's nodes invalid), on engine ``mode`` ("off" or "on"):
    solve_dense_warm from the carry of that map against the cold
    solve_converged_resilient, ``reps`` times each, alternating, each
    result checked equal; medians of the wall times, device
    synchronised, outside the session's host prechecks and audit gate."""
    prob = s.problem
    rules = tuple(tuple(prob.rules.get(si, ())) for si in range(prob.S))
    cons = tuple(int(c) for c in prob.constraints)
    args = s._solver_args()
    carry = bt.carry_from_assignment(args[0], args[1], args[2])
    dirty = np.isin(s.current, delta_ids).any(axis=(1, 2))
    times = {"warm": [], "cold": []}
    for _ in range(reps):
        for kind in ("warm", "cold"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "warm":
                out, _c = T.solve_dense_warm(*args, cons, rules, dirty=dirty,
                                             carry=carry, fused_score=mode,
                                             record=False)
            else:
                ref, _m = T.solve_converged_resilient(
                    *args, cons, rules, max_iterations=10, mode=mode,
                    allow_fallback=False, context="chip_smoke")
            torch.cuda.synchronize()
            times[kind].append(time.perf_counter() - t0)
        if out is None or not np.array_equal(out, ref):
            raise AssertionError("solve_dense_warm declined or differs from "
                                 "the cold solve on the session's delta")
    warm_s, cold_s = (float(np.median(times[k])) for k in ("warm", "cold"))
    return dict(engine=_ENGINES[mode], reps=reps, warm_s=warm_s,
                cold_s=cold_s,
                warm_over_cold=warm_s / cold_s, warm_all_s=times["warm"],
                cold_all_s=times["cold"])


def session_sparse(state, dev) -> dict:
    """The warm repair at the sparse deployment: the card's solve (the
    parity check's sweeps) as prev, its carry from
    carry_from_assignment, 100 more nodes gone and the rows that held
    them dirty; solve_sparse_warm on the card (accepted or declined),
    then the repair sweep alone on the card and on the CPU, equal array
    for array (assignment, new_used, ok, exhausted)."""
    prev, pw, nw, valid, stick, gids, gv = state["arrays"]
    prev = state["solved"]
    cons, rules, k = state["constraints"], state["rules"], state["k"]
    rng = np.random.default_rng(19)
    gone = rng.choice(np.nonzero(valid)[0], SESSION_DELTA, replace=False)
    valid2 = valid.copy()
    valid2[gone] = False
    dirty = np.isin(prev, gone).any(axis=(1, 2))
    arrays = (prev, pw, nw, valid2, stick, gids, gv)
    a = bt.problem_to_torch(*arrays, device=dev)
    carry = bt.carry_from_assignment(a[0], a[1], a[2])
    shortlist = build_shortlist_core(a[0], a[1], a[2], a[3], a[5], a[6],
                                     cons, rules, k)
    rec = Recorder()
    stats: dict = {}
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with use_recorder(rec):
        out, _nxt = T.solve_sparse_warm(*a, cons, rules, dirty=dirty,
                                        carry=carry, shortlist=shortlist,
                                        stats=stats)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = launch_counts()
    variants = launch_variants()
    sweeps = []
    for device in (dev, torch.device("cpu")):
        d = bt.problem_to_torch(*arrays, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = T._warm_repair_sparse(
            *d, shortlist.to(device), torch.from_numpy(dirty).to(device),
            carry.used.to(device), cons, rules)
        sweeps.append(([x.cpu() for x in res], time.perf_counter() - t0))
    (got, card_s), (want, cpu_s) = sweeps
    compare(got, want, f"sparse repair sweep [{prev.shape[0]}, {nw.shape[0]}]"
            " on the card vs the CPU")
    checks = dict(
        repair_sweep_card_equals_cpu=True,
        sparse_kernel_launched=launches["sparse_priced_min2_cand"] >= 1,
        decision_matches_sweep=stats["accepted"] == bool(got[2]),
        nothing_on_removed=out is None or not bool(np.isin(out, gone).any()))
    info = dict(P=int(prev.shape[0]), N=int(nw.shape[0]), k=k,
                delta_nodes=SESSION_DELTA,
                dirty_fraction=float(dirty.mean()),
                accepted=stats["accepted"],
                exhausted_rows=stats["exhausted_rows"],
                fallback_rows=stats["fallback_rows"],
                warm_s=warm_s, repair_sweep_card_s=card_s,
                repair_sweep_cpu_s=cpu_s,
                counters=_plan_counts(rec.counters, {}),
                launches={k_: v for k_, v in launches.items() if v},
                variants=variants.get("sparse_priced_min2_cand"),
                checks=checks)
    log(f"session (sparse 1M x 10k): {json.dumps(info)}")
    if not all(checks.values()):
        raise AssertionError(f"session at the sparse deployment: {checks}")
    return info


def small_session_matches_cpu(dev) -> dict:
    """The 2048 x 64 fixture through rebalance(session=) twice (the
    second through the adopted session must be a carry hit) and then a
    RebalanceController(session=) cycle, on the card and on the CPU: the
    maps, the op log and the session's plan counters equal."""
    prev, nodes, removed, model, opts = small_map()
    alive = [nd for nd in nodes if nd not in removed]
    extra, extra2 = alive[10], alive[20]
    orch = bt.OrchestratorOptions(**REBALANCE_OPTIONS)
    runs = []
    for device in (dev, "cpu"):
        oplog: list = []

        def assign(stop_ch, node, partitions, states, ops):
            oplog.extend(zip(partitions, [node] * len(ops), states, ops))

        rec = Recorder()
        session = bt.PlannerSession(model, nodes, list(prev), opts=opts,
                                    device=device)
        with use_recorder(rec):
            r1 = bt.rebalance(model, prev, nodes, removed, [], assign,
                              session=session, device=device,
                              orchestrator_options=orch)
            c1 = dict(rec.counters)
            r2 = bt.rebalance(model, r1.next_map, nodes, removed + [extra],
                              [], assign, session=session, device=device,
                              orchestrator_options=orch)
            c2 = dict(rec.counters)
            live = [nd for nd in nodes if nd not in removed + [extra]]

            async def drive():
                ctl = bt.RebalanceController(
                    model, live, r2.next_map, assign, session=session,
                    device=device, debounce_s=0.01,
                    orchestrator_options=orch)
                ctl.start()
                ctl.submit(bt.ClusterDelta(remove=(extra2,)))
                final = await ctl.quiesce()
                await ctl.stop()
                return ctl, final

            ctl, final = asyncio.run(drive())
        errors = r1.progress.errors + r2.progress.errors + ctl.failures
        if errors:
            raise AssertionError(f"small session run on {device}: "
                                 f"{errors[:3]}")
        runs.append(dict(
            maps=[bt.partition_map_to_json(m)
                  for m in (r1.next_map, r2.next_map, final)],
            oplog=list(oplog),
            counters=[_plan_counts(c1, {}), _plan_counts(c2, c1),
                      _plan_counts(rec.counters, c2)],
            current=session.current.copy()))
    card, cpu = runs
    checks = dict(
        maps_equal=card["maps"] == cpu["maps"],
        oplog_equal=card["oplog"] == cpu["oplog"] and bool(card["oplog"]),
        counters_equal=card["counters"] == cpu["counters"],
        current_equal=bool(np.array_equal(card["current"], cpu["current"])),
        second_rebalance_carry_hit=card["counters"][1].get(
            "plan.solve.carry_hit") == 1)
    info = dict(P=len(prev), N=len(nodes), ops=len(card["oplog"]),
                counters=dict(zip(("rebalance", "second_rebalance",
                                   "controller"), card["counters"])),
                checks=checks)
    log(f"small session runs [2048 x 64] on the card vs the CPU: "
        f"{json.dumps(info)}")
    if not all(checks.values()):
        raise AssertionError(f"small session runs: {checks}")
    return info


def device_kernels(fn) -> list:
    """Run ``fn`` under torch.profiler; the device kernels it ran as
    (name, device ms, calls), longest first."""
    from torch.profiler import ProfilerActivity, profile

    with warnings.catch_warnings():
        # The profiler's own notices are not engine fallbacks.
        warnings.filterwarnings("ignore", module=r"torch\.")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA  # kernels, not the host ops
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == cuda
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return rows


def profile_main_path(mode, prev, nodes, removed, model, opts) -> dict:
    """One more main-path run on engine ``mode`` (the dense engine mode;
    the sparse deployment routes itself) under torch.profiler:
    the device's kernel time against the solve's wall time (busy share)
    and the kernels that took it, by name."""
    T.set_fused_score_default(mode)
    timings: dict = {}
    rows = device_kernels(lambda: bt.plan_next_map(
        prev, prev, nodes, removed, [], model, opts, backend="cuda",
        timings=timings))
    T.set_fused_score_default("auto")
    device_ms = sum(r[1] for r in rows)
    wall_ms = timings["solve_s"] * 1e3
    return {"engine": timings["engine"], "solve_wall_ms": wall_ms,
            "device_kernel_ms": device_ms,
            "device_busy_share": (device_ms / wall_ms) if rows else None,
            "top": [{"kernel": k[:80], "ms": ms, "calls": c}
                    for k, ms, c in rows[:10]]}


def _ops_of(moves) -> dict:
    return {k: [(o.node, o.state, o.op) for o in ops]
            for k, ops in moves.items()}


def _same_map(a, b) -> bool:
    """Two PartitionMaps equal, partition order included (cheaper than
    comparing their JSON at 1M partitions)."""
    return list(a) == list(b) and a == b


@contextlib.contextmanager
def traced():
    """torch.profiler over the block with CUDA activities only (the
    card's kernels and copies, no host-op records, so the host runs at
    its own pace).  The dict it yields receives, after the block, the
    Memcpy activities by kind, their device-to-host count (each host
    read of a device value is one) and the full (generation-2) garbage
    collections that ran inside the block."""
    from torch.profiler import ProfilerActivity, profile

    res: dict = {}
    gen2 = gc.get_stats()[2]["collections"]
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", module=r"torch\.")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            yield res
            torch.cuda.synchronize()
    copies = {e.key: e.count for e in prof.key_averages()
              if e.key.startswith("Memcpy")}
    res.update(memcpy=copies, d2h_copies=sum(
        n for k, n in copies.items() if k.startswith("Memcpy DtoH")),
        gc_full=gc.get_stats()[2]["collections"] - gen2)


def run_pipeline(prev, nodes, removed, model, opts, favor=False) -> tuple:
    """One plan_pipeline on the card under a fresh recorder and timer,
    traced, the launch counts set to 0 just before it and read just
    after; wall time on the host clock, the device synchronised."""
    rec, timer = Recorder(), PhaseTimer()
    reset_launch_counts()
    with traced() as tr:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with use_recorder(rec):
            out = bt.plan_pipeline(prev, prev, nodes, removed, [], model,
                                   opts, timer, favor_min_nodes=favor)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    info = dict({f"{k}_s": v for k, v in timer.totals.items()}, wall_s=wall,
                engine=timer.annotations.get("engine"),
                launches={k: v for k, v in launch_counts().items() if v},
                variants={k: v for k, v in launch_variants().items() if v},
                counters=_plan_counts(rec.counters, {}), **tr)
    return out, info


def run_staged(prev, nodes, removed, model, opts, favor=False,
               plan=None) -> tuple:
    """The staged twin on the card, traced: plan_next_map (unless
    ``plan`` gives the (map, warnings, wall s) of one already run), then
    calc_all_moves of the map; each timed on the host clock, the device
    synchronised."""
    with traced() as tr:
        if plan is None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan = (*bt.plan_next_map(prev, prev, nodes, removed, [], model,
                                      opts, backend="cuda"),
                    time.perf_counter() - t0)
        smap, swarn, plan_s = plan
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moves = bt.calc_all_moves(T._seeded_beg_map(prev, prev), smap, model,
                                  favor, device="cuda")
        calc_s = time.perf_counter() - t0
    return (smap, swarn, moves), dict(plan_wall_s=plan_s,
                                      calc_all_moves_s=calc_s,
                                      wall_s=plan_s + calc_s, **tr)


def pipeline_vs_staged(label, prev, nodes, removed, model, opts, kernel,
                       timed_variant=None, plain=None,
                       favors=(False,)) -> dict:
    """plan_pipeline against its staged twin on the current engine, both
    traced alike: map, warnings and moves equal (``favors`` emission
    orders), the engine's kernel launched (in ``timed_variant`` when
    given), no fallback, and no more device-to-host copies than the
    twin's (which must show some, or the count says nothing); the map
    also equal to ``plain`` (the plain main-path map) when given.  The
    staged twin plans once and diffs in each order.  The objects alive
    before are frozen out of the garbage collector's passes (the script
    holds several maps of P partitions), so a full collection of them
    lands in neither side's window."""
    res = {}
    staged_plan = None
    gc.collect()
    gc.freeze()
    try:
        for favor in favors:
            (pmap, pwarn, pmoves), info = run_pipeline(prev, nodes, removed,
                                                       model, opts, favor)
            (smap, swarn, smoves), staged = run_staged(
                prev, nodes, removed, model, opts, favor, plan=staged_plan)
            staged_plan = (smap, swarn, staged["plan_wall_s"])
            checks = dict(
                map_equals_staged=_same_map(pmap, smap),
                warnings_equal_staged=pwarn == swarn,
                moves_equal_calc_all_moves=_ops_of(pmoves)
                == _ops_of(smoves),
                kernel_launched=info["launches"].get(kernel, 0) >= 1,
                no_pipeline_fallback="plan.pipeline.fallback" not in
                info["counters"],
                no_engine_fallback="plan.engine_fallback" not in
                info["counters"])
            if plain is not None:
                checks["map_equals_plain_map"] = _same_map(pmap, plain)
            if timed_variant is not None:
                checks["timed_instantiation_launched"] = \
                    timed_variant in info["variants"].get(kernel, {})
            if not favor:
                checks["staged_copies_seen"] = staged["d2h_copies"] > 0
                checks["d2h_copies_at_most_staged"] = \
                    info["d2h_copies"] <= staged["d2h_copies"]
            del pmap, pwarn, pmoves, smoves
            info.update(staged=staged, pipeline_over_staged=info["wall_s"]
                        / staged["wall_s"], checks=checks)
            res["favor_min_nodes" if favor else "availability"] = info
            log(f"pipeline ({label}, favor_min_nodes={favor}): "
                f"{json.dumps(info)}")
            if not all(checks.values()):
                raise AssertionError(f"pipeline {label} favor_min_nodes="
                                     f"{favor}: {checks}")
    finally:
        gc.unfreeze()
    return res


def session_pipeline_twin(prev, nodes, removed, model, opts, dev,
                          mode) -> dict:
    """Twin sessions on engine ``mode`` at the north star: one replans
    with replan() + moves(), the other with replan_with_moves(), cold
    after the 5% removal and warm after the session phase's 1% delta; the
    proposals and all three diff arrays bitwise equal, the warm fused
    replan a carry hit through the warm pipeline."""
    delta = session_delta(nodes, removed)
    T.set_fused_score_default(mode)
    runs = {}
    try:
        for kind in ("staged", "fused"):
            rec = Recorder()
            steps = []
            with use_recorder(rec):
                s = bt.PlannerSession(model, nodes, list(prev), opts=opts,
                                      device=dev)
                s.load_map(prev)
                for delta_nodes in (removed, delta):
                    s.remove_nodes(delta_nodes)
                    before = dict(rec.counters)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    if kind == "staged":
                        out = (s.replan().copy(), s.moves())
                    else:
                        a, mv = s.replan_with_moves()
                        out = (a.copy(), mv)
                    torch.cuda.synchronize()
                    steps.append(dict(out=out,
                                      s=time.perf_counter() - t0,
                                      counters=_plan_counts(rec.counters,
                                                            before)))
                    s.apply()
            runs[kind] = steps
    finally:
        T.set_fused_score_default("auto")
    equal = [bool(np.array_equal(a["out"][0], b["out"][0])) and all(
        np.array_equal(x, y) for x, y in zip(a["out"][1], b["out"][1]))
        for a, b in zip(runs["staged"], runs["fused"])]
    warm = runs["fused"][1]["counters"]
    checks = dict(cold_equal=equal[0], warm_equal=equal[1],
                  warm_pipeline=warm.get("plan.pipeline.warm") == 1,
                  carry_hit=warm.get("plan.solve.carry_hit") == 1)
    info = dict(engine=_ENGINES[mode if mode != "auto" else "off"],
                delta_nodes=len(delta),
                cold_s={k: v[0]["s"] for k, v in runs.items()},
                warm_s={k: v[1]["s"] for k, v in runs.items()},
                warm_counters=warm, checks=checks)
    log(f"session pipeline twin ({info['engine']}): {json.dumps(info)}")
    if not all(checks.values()):
        raise AssertionError(f"session pipeline twin ({mode}): {checks}")
    return info


def marshal_parity(prev, nodes, removed, model, opts, plain_map) -> dict:
    """encode_problem and decode_assignment at the north star with the
    native marshal extension and on the pure-Python path: the same arrays
    and the same map, and the time of each."""
    times, outs = {}, {}
    after = bt.encode_problem(plain_map, plain_map, nodes, removed, model,
                              opts).prev
    try:
        for native in (True, False):
            marshal._MOD, marshal._FAILED = None, not native
            if marshal.available() != native:
                raise AssertionError("marshal loader did not switch")
            t0 = time.perf_counter()
            problem = bt.encode_problem(prev, prev, nodes, removed, model,
                                        opts)
            t1 = time.perf_counter()
            out = bt.decode_assignment(problem, after, prev, removed)
            t2 = time.perf_counter()
            key = "native" if native else "python"
            times[key] = {"encode_s": t1 - t0, "decode_s": t2 - t1}
            outs[key] = (problem, bt.partition_map_to_json(out[0]), out[1])
    finally:
        marshal._MOD, marshal._FAILED = None, False
    if not marshal.available():
        raise AssertionError("the native marshal extension did not reload")
    (a, amap, awarn), (b, bmap, bwarn) = outs["native"], outs["python"]
    fields = ("prev", "partition_weights", "node_weights", "valid_node",
              "stickiness", "gids", "gid_valid", "constraints")
    checks = dict(
        encode_arrays_equal=all(
            getattr(a, f).dtype == getattr(b, f).dtype
            and np.array_equal(getattr(a, f), getattr(b, f)) for f in fields)
        and (a.partitions, a.nodes, a.states) == (b.partitions, b.nodes,
                                                  b.states),
        decode_equal=amap == bmap and awarn == bwarn,
        decode_equals_plain_map=amap == bt.partition_map_to_json(plain_map))
    info = dict(times, checks=checks)
    log(f"marshal (north star): {json.dumps(info)}")
    if not all(checks.values()):
        raise AssertionError(f"marshal parity: {checks}")
    return info


# --- the exact backends (the ``exact`` line) ---------------------------------


def bench_cpu_map(p: int, n: int):
    """bench.py's exact CPU baseline problem (``_make_map`` and
    ``_rack_opts``, seed 0): p partitions x n nodes, primary + 1 replica,
    racks of 25 under one zone, replica on another rack, 5% of nodes
    removed."""
    rng = np.random.default_rng(0)
    nodes = [f"n{i:05d}" for i in range(n)]
    removed = [nodes[i] for i in rng.choice(n, n // 20, replace=False)]
    prim = rng.integers(0, n, p)
    repl = (prim + 1 + rng.integers(0, n - 1, p)) % n
    prev = {str(i): bt.Partition(str(i), {"primary": [nodes[a]],
                                          "replica": [nodes[b]]})
            for i, (a, b) in enumerate(zip(prim.tolist(), repl.tolist()))}
    hier = {nd: f"r{i // 25}" for i, nd in enumerate(nodes)}
    hier.update({f"r{i}": "z0" for i in range((n + 24) // 25)})
    opts = bt.PlanOptions(node_hierarchy=hier, hierarchy_rules={
        "replica": [bt.HierarchyRule(include_level=2, exclude_level=1)]})
    return prev, nodes, removed, opts


def config2():
    """BASELINE.json's second configuration (bench_configs.py config 2):
    4096 partitions x 64 nodes, primary + 2 replicas, nodes in 8 racks
    under one zone, each replica on another rack.  Returns the fresh
    cluster's first native plan as the map to replan, the nodes, the
    options and the model."""
    nodes = [f"n{i:05d}" for i in range(64)]
    parts = {str(i): bt.Partition(str(i), {}) for i in range(4096)}
    hier = {nd: f"r{i % 8}" for i, nd in enumerate(nodes)}
    hier.update({f"r{i}": "z0" for i in range(8)})
    opts = bt.PlanOptions(node_hierarchy=hier, hierarchy_rules={
        "replica": [bt.HierarchyRule(include_level=2, exclude_level=1)]})
    model = bt.model(primary=(0, 1), replica=(1, 2))
    prev, _ = bt.plan_next_map(parts, parts, nodes, [], nodes, model, opts,
                               backend="native")
    return prev, nodes, opts, model


def plan_traced(prev, nodes, removed, model, opts, backend) -> tuple:
    """plan_next_map on the card (where the backend solves there) under a
    recorder with an in-memory sink, the launch counts set to 0 just
    before it and read just after; returns (map, warnings) and the
    resolved backend, the plan.solve engine, the wall time (device
    synchronised), the launches and the card's sweeps (None on the exact
    backends)."""
    rec, sink = Recorder(), InMemorySink()
    rec.add_sink(sink)
    timings: dict = {}
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with use_recorder(rec):
        out = bt.plan_next_map(prev, prev, nodes, removed, [], model, opts,
                               backend=backend, timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    top = sink.by_name("plan.plan_next_map")[-1].attrs
    solve = sink.by_name("plan.solve")
    return out, dict(backend=top["backend"], requested=top["requested"],
                     engine=solve[-1].attrs.get("engine") if solve else None,
                     wall_s=wall, sweeps=timings.get("sweeps"),
                     launches={k: v for k, v in launch_counts().items() if v})


def default_order_sorter(ctx, nodes):
    """A node_sorter hook that orders as the default score does (score,
    then node position): the device score cannot run it, so the "cuda"
    backend takes the exact path, and its map must be greedy's."""
    return sorted(nodes, key=lambda nd: (bt.default_node_score(ctx, nd),
                                         ctx.node_positions.get(nd, 0)))


CPU_BASELINE = (100_000, 1000)  # bench.py bench_cpu at the 100k x 1k config
CROSSOVER = ((256, 16), (1024, 32), (1024, 64), (1024, 128), (1024, 255),
             (1024, 256), (4096, 256), (16384, 1024))
CROSSOVER_REPEATS = 3  # timed calls per backend and size, after a warm-up


def exact_phase() -> dict:
    """The exact backends on the card's host: (a) backend="auto" routes
    1024 x 255 (261 120 cells) to native and 1024 x 256 (262 144) to the
    card; (b) native and greedy bit-identical at BASELINE.json's second
    configuration; (c) bench.py's exact CPU baseline (100k x 1k, one
    pass) through native, beside the card; (d) a node_sorter hook on
    backend="cuda" and in plan_pipeline takes the exact path (greedy's
    map, engine "exact-fallback", moves equal to calc_partition_moves);
    (e) native against cuda plan wall time from 4096 cells to 64 times
    the threshold (the crossover), the median of 3 calls after one
    warm-up call per backend and size."""
    if not native_planner.native_available():
        raise AssertionError("the native planner did not build or load "
                             "(g++ is needed)")
    model = bt.model(primary=(0, 1), replica=(1, 1))
    res: dict = {"library": native_planner._LIB._name}

    routing = {}
    for n in (255, 256):
        prev, nodes, removed, opts = bench_cpu_map(1024, n)
        _out, routing[f"1024x{n}"] = plan_traced(prev, nodes, removed, model,
                                                 opts, "auto")
    below, at = routing["1024x255"], routing["1024x256"]
    checks = dict(
        below_threshold_native=below["backend"] == "native",
        at_threshold_cuda=at["backend"] == "cuda",
        native_launched_no_kernel=not below["launches"],
        cuda_launched_min2=at["launches"].get("priced_min2_argmin", 0) >= 1)
    res["routing"] = routing

    prev2, nodes2, opts2, model2 = config2()
    gone2 = nodes2[5:7]  # the replan drops two nodes, so it moves copies
    outs, times = {}, {}
    for backend in ("native", "greedy"):
        t0 = time.perf_counter()
        outs[backend] = bt.plan_next_map(prev2, prev2, nodes2, gone2, [],
                                         model2, opts2, backend=backend)
        times[backend] = time.perf_counter() - t0
    greedy_map, greedy_warn = outs["greedy"]
    checks["native_equals_greedy"] = \
        _same_map(outs["native"][0], greedy_map) and \
        outs["native"][1] == greedy_warn
    res["native_vs_greedy"] = dict(P=4096, N=64, seconds=times,
                                   warnings=len(greedy_warn))

    hooked = dataclasses.replace(opts2, node_sorter=default_order_sorter)
    (fmap, fwarn), fb = plan_traced(prev2, nodes2, gone2, model2, hooked,
                                    "cuda")
    t0 = time.perf_counter()
    pmap, pwarn, pmoves = bt.plan_pipeline(prev2, prev2, nodes2, gone2, [],
                                           model2, hooked)
    fb["pipeline_wall_s"] = time.perf_counter() - t0
    states = sort_state_names(model2)
    bad = [k for k in prev2 if pmoves[k] != bt.calc_partition_moves(
        states, prev2[k].nodes_by_state, pmap[k].nodes_by_state)]
    checks.update(
        fallback_engine=fb["engine"] == "exact-fallback",
        fallback_equals_greedy=_same_map(fmap, greedy_map)
        and fwarn == greedy_warn,
        pipeline_equals_greedy=_same_map(pmap, greedy_map)
        and pwarn == greedy_warn,
        pipeline_moves_equal_host=not bad and list(pmoves) == list(pmap),
        pipeline_moved=any(pmoves.values()))
    fb["moves"] = sum(map(len, pmoves.values()))
    res["fallback"] = fb

    prev, nodes, removed, opts = bench_cpu_map(*CPU_BASELINE)
    opts.max_iterations = 1  # bench.py bench_cpu: one pass
    base = {}
    for backend in ("native", "cuda"):
        out, info = plan_traced(prev, nodes, removed, model, opts, backend)
        problem = bt.encode_problem(prev, prev, nodes, removed, model, opts)
        after = bt.encode_problem(out[0], out[0], nodes, removed, model, opts)
        info["audit"] = bt.check_assignment(problem, after.prev)
        base[backend] = info
    base["native_over_cuda"] = base["native"]["wall_s"] / \
        base["cuda"]["wall_s"]
    checks.update(
        baseline_native_no_kernel=not base["native"]["launches"],
        baseline_native_audit_clean=not any(base["native"]["audit"].values()),
        baseline_cuda_audit_clean=not any(base["cuda"]["audit"].values()))
    res["cpu_baseline"] = dict(P=CPU_BASELINE[0], N=CPU_BASELINE[1],
                               max_iterations=1, **base)

    cross = []
    for p, n in CROSSOVER:
        prev, nodes, removed, opts = bench_cpu_map(p, n)
        row = {"P": p, "N": n, "cells": p * n}
        for backend in ("native", "cuda"):
            # One warm-up call per shape, then the median of the timed
            # ones: the card's first call at a shape pays for allocation.
            infos = [plan_traced(prev, nodes, removed, model, opts,
                                 backend)[1]
                     for _ in range(1 + CROSSOVER_REPEATS)][1:]
            walls = [info["wall_s"] for info in infos]
            row[f"{backend}_s"] = statistics.median(walls)
            row[f"{backend}_walls_s"] = walls
        row.update(cuda_sweeps=infos[-1]["sweeps"],
                   cuda_launches=infos[-1]["launches"])
        row["native_over_cuda"] = row["native_s"] / row["cuda_s"]
        cross.append(row)
    res["crossover"] = dict(threshold_cells=256 * 1024, warmups=1,
                            repeats=CROSSOVER_REPEATS, rows=cross)
    res["checks"] = checks
    log(f"exact: {json.dumps(res)}")
    if not all(checks.values()):
        raise AssertionError(f"exact backends: {checks}")
    return res


# --- narrow rows (the ``narrow`` line) ------------------------------------------

# The sweep's widths: the fleet's (8-64), small plans' and bucketed
# classes' (to 2048), and 4096, past every table.
NARROW_N = (8, 16, 32, 64, 128, 256, 512, 777, 1024, 2048, 4096)
# Cells at each N: 64 MB of score, past the card's 50 MB L2, so graph
# replays read it from HBM.  Unbatched [2^24 / N, N]; batched
# [NARROW_B, 2^24 / (NARROW_B N), N].
NARROW_CELLS = 1 << 24
NARROW_B = 16


def narrow_min2_inputs(dev, lead: tuple, n: int):
    """Quantized scores (duplicate minima), whole +inf rows, and rows
    whose only finite value is in the last column; score ``lead + (n,)``,
    price ``lead[:-1] + (n,)``."""
    gen = torch.Generator(device=dev).manual_seed(n)
    score = torch.randint(0, 50, lead + (n,), generator=gen, device=dev) \
        .to(torch.float32) * 0.125
    score[..., ::97, :] = float("inf")
    score[..., 5::89, :] = float("inf")
    score[..., 5::89, -1] = 0.5
    price = torch.randint(0, 8, lead[:-1] + (n,), generator=gen,
                          device=dev).to(torch.float32) * 0.25
    return score, price


def narrow_fused_inputs(dev, b: int, p: int, n: int):
    """The fleet's instantiation (``n1r1t2a2``) at [p, n]; ``b`` > 0
    stacks b problems of their own seeds, the first priced all +inf and
    the second +inf but in its last column."""
    if not b:
        return fused_inputs(dev, p, n, seed=n)
    per = [fused_inputs(dev, p, n, seed=n + e) for e in range(b)]
    price = torch.stack([pr for pr, _si, _r in per])
    price[0] = float("inf")
    price[1, :-1] = float("inf")
    si = score_fused.ScoreInputs(*(torch.stack(f) for f in
                                   zip(*[s for _pr, s, _r in per])))
    return price, si, per[0][2]


def _wide_launch(kind: str, args: tuple, kw: dict, lanes: int = 0):
    """The wrapper's launch on its own arguments with ``lanes`` lanes a
    row: 0 is the wide layout (min2: a block a row; the in-kernel score:
    the 16-row tile)."""
    if kind == "min2":
        return reduce2._launch(*args, lanes=lanes)
    return score_fused._launch(*args[:4], kw["nrules"], kw["jitter_scale"],
                               lanes=lanes)


def narrow_sweep_row(kind: str, dev, n: int, batched: bool,
                     aligned: bool = True) -> dict:
    """One kernel at N = n, 2^24 cells: the layout its wrapper picks and
    the wide one, both bitwise the plain version, each timed; past the
    table (the wrapper picks the wide one), its last narrow layout
    instead, timed beside it.  ``aligned`` False: min2 on views one float
    off 16-byte alignment (4-byte loads)."""
    rows = NARROW_CELLS // n
    b = NARROW_B if batched else 0
    p = max(1, rows // NARROW_B) if batched else rows
    if kind == "min2":
        score, price = narrow_min2_inputs(dev, ((b,) if b else ()) + (p,), n)
        if not aligned:
            score, price = _offset_view(score), _offset_view(price)
        args, kw = (score, price), {}
        kernel = lambda: reduce2.priced_min2_argmin(score, price)  # noqa: E731
        if batched:
            plain = lambda: reduce2.batched_min2_reference(  # noqa: E731
                score, price)
        else:
            plain = lambda: reduce2.min2_argmin_reference(  # noqa: E731
                score + price[None, :])
        bound = _bound(*cost.min2_work(score, price))
        name = "priced_min2_argmin"
        vec = reduce2.min2_vec(score, price)
        lanes = reduce2.min2_lanes(n, vec)
        table = reduce2.LANES_BY_N if vec else reduce2.LANES_BY_N_SCALAR
    else:
        price, si, nrules = narrow_fused_inputs(dev, b, p, n)
        args, kw = (price, si, 0, 0), dict(nrules=nrules,
                                           jitter_scale=T._JITTER)
        kernel = lambda: score_fused.fused_score_min2(*args, **kw)  # noqa: E731
        plain = functools.partial(
            score_fused.batched_fused_reference if batched else
            score_fused.fused_score_min2_reference, *args, **kw)
        widths = (si.prev_state.shape[-1], si.taken.shape[-1],
                  si.present.shape[-1])
        bound = _bound(*cost.fused_work(price, si, nrules))
        name = "fused_score_min2"
        lanes = score_fused.fused_lanes(n, nrules, *widths)
        table = score_fused.FUSED_LANES_BY_N
    shape = ([b] if b else []) + [p, n]
    want = plain()
    reset_launch_counts()
    err = compare(kernel(), want, f"{kind} at {shape}")
    variant, = launch_variants()[name]
    other = table[-1][1] if lanes == 0 else 0
    err = max(err, compare(_wide_launch(kind, args, kw, other), want,
                           f"{kind} at {shape}, {other} lanes a row"))
    del want
    row = dict(kernel=name, shape=shape, aligned=aligned, variant=variant,
               lanes=lanes, max_abs_err=err,
               ms=graph_ms(kernel, calls=10, replays=3), **bound)
    key = "wide_ms" if other == 0 else f"lanes_{other}_ms"
    row[key] = graph_ms(lambda: _wide_launch(kind, args, kw, other),
                        calls=10, replays=3)
    return row


def _offset_view(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a view one float past a 16-byte boundary."""
    buf = t.new_empty(t.numel() + 1)
    buf[1:] = t.flatten()
    return buf[1:].view(t.shape)


def small_plan_path(dev) -> tuple:
    """The small rebalance fixture's plan (2048 x 64, racks of 8, 3 nodes
    removed) through plan_next_map on the card, on the matrix engine and
    the in-kernel score engine: the unbatched narrow layouts on a user's
    path, counted from 0 over each run.  Returns each run's summary and
    each kernel's entry, on the inputs of its first call (the in-kernel
    score's and the score write's: the replica slot's, ``n1r1t2a2``)."""
    prev, nodes, removed, model, opts = small_map()
    out, entries = {}, {}
    replica = lambda args, kw: kw.get("nrules") == 1  # noqa: E731
    for key, mode, name, want in (
            ("min2", "off", "priced_min2_argmin", lambda args, kw: True),
            ("fused", "on", "fused_score_min2", replica)):
        T.set_fused_score_default(mode)
        try:
            with first_call(name, want) as seen, \
                    first_call("score_write", replica) as seen_write:
                info, _map = run_main_path(f"small plan, {key}", prev,
                                           nodes, removed, model, opts)
        finally:
            T.set_fused_score_default("auto")
        variants = info["variants"][name]
        out[key] = dict(engine=info["engine"], wall_s=info["wall_s"],
                        launches=info["launches"][name], variants=variants,
                        narrow_taken=bool(variants) and all(
                            v.endswith("rows_per_warp") for v in variants))
        entries[key] = path_kernel_entry(key, seen, out[key]["launches"],
                                         "the small plan's", wide=True)
        if key == "min2":  # the matrix engine writes its score first
            out["write"] = dict(launches=info["launches"]["score_write"],
                                variants=info["variants"]["score_write"])
            entries["write"] = path_kernel_entry(
                "write", seen_write, out["write"]["launches"],
                "the small plan's")
    return out, entries


def narrow_phase(dev) -> tuple:
    """The narrow layouts (the ``narrow`` line): both kernels at every N
    of the sweep, unbatched and batched, and min2 at N = 1024 off
    alignment, each layout bitwise the plain version and timed beside
    the wide one; then the small plan path, whose entries join the
    ``kernels`` line."""
    sweep = [narrow_sweep_row(kind, dev, n, batched)
             for kind in ("min2", "fused") for n in NARROW_N
             for batched in (False, True)]
    sweep += [narrow_sweep_row("min2", dev, 1024, batched, aligned=False)
              for batched in (False, True)]
    torch.cuda.empty_cache()
    for r in sweep:
        log(f"narrow: {r['kernel']} {r['variant']} at {r['shape']} == plain"
            f" (bitwise), {r['ms']:.5f} ms, bound {r['bound_ms']:.5f}")
    small, entries = small_plan_path(dev)
    line = dict(tables=dict(min2=reduce2.LANES_BY_N,
                            min2_4byte=reduce2.LANES_BY_N_SCALAR,
                            fused=score_fused.FUSED_LANES_BY_N),
                sweep=sweep, small_plan=small,
                checks=dict(small_narrow_taken=all(
                    small[k]["narrow_taken"] for k in ("min2", "fused")),
                    small_write_launched=small["write"]["launches"] > 0))
    if not all(line["checks"].values()):
        raise AssertionError(f"narrow: {line['checks']}, {small}")
    return line, entries


# --- shape bucketing (the ``bucketed`` line) ----------------------------------


@contextlib.contextmanager
def first_call(name: str, want=lambda args, kw: True):
    """Record the arguments of the first call of ``plan.tensor.<name>``
    (a kernel wrapper the solver calls) that ``want`` accepts; the
    wrapper itself still runs, and counts, as before."""
    orig = getattr(T, name)
    seen: dict = {}

    def spy(*args, **kw):
        if not seen and want(args, kw):
            seen.update(args=args, kw=kw)
        return orig(*args, **kw)

    setattr(T, name, spy)
    try:
        yield seen
    finally:
        setattr(T, name, orig)


def bucketed_plan(label, prev, nodes, removed, model, opts, kernel,
                  want=lambda args, kw: True) -> tuple:
    """run_main_path with shape_bucketing under a recorder: the padded
    shape off the plan.solve span, the first ``kernel`` call's inputs,
    and no pad node (nor any unknown node) in the map."""
    rec, sink = Recorder(), InMemorySink()
    rec.add_sink(sink)
    with first_call(kernel, want) as seen, use_recorder(rec):
        info, out = run_main_path(label, prev, nodes, removed, model, opts)
    info["bucketed_shape"] = list(sink.by_name("plan.solve")[-1]
                                  .attrs["bucketed_shape"])
    known = set(nodes)
    info["pad_or_unknown_nodes"] = sum(nd not in known for p in out.values()
                                       for ns in p.nodes_by_state.values()
                                       for nd in ns)
    return info, out, seen


def path_kernel_entry(kind: str, seen: dict, launches: int,
                      where: str = "the padded", wide: bool = False) -> dict:
    """One kernel against its plain version on the inputs a path (the
    bucketed main path: at the padded shape) gave its first call,
    bitwise; timed like the kernels phase, with its bound from these
    inputs; ``wide``: its wide layout timed beside it (``wide_ms``)."""
    args, kw = seen["args"], seen["kw"]
    lead: list = []
    if kind == "min2":
        score, price = args
        p, n = score.shape
        kernel = lambda: reduce2.priced_min2_argmin(score, price)  # noqa: E731
        plain = lambda: reduce2.min2_argmin_reference(  # noqa: E731
            score + price[None, :])
        library = lambda: torch.topk(score + price[None, :], 2,  # noqa: E731
                                     dim=1, largest=False)
        bound = _bound(*cost.min2_work(score, price))
    elif kind == "fused":
        price, si = args[:2]
        p, n = si.stick.shape[0], price.shape[0]
        call = dict(nrules=kw["nrules"], jitter_scale=kw["jitter_scale"])
        kernel = lambda: score_fused.fused_score_min2(  # noqa: E731
            price, si, *args[2:4], **call)
        plain = lambda: score_fused.fused_score_min2_reference(  # noqa: E731
            price, si, *args[2:4], **call)
        library = None
        bound = _bound(*cost.fused_work(price, si, kw["nrules"]))
    elif kind == "write":
        si, pbase, noff = args
        lead = list(si.base.shape[:-1])
        p, n = si.stick.shape[-1], si.base.shape[-1]
        call = dict(nrules=kw["nrules"], jitter_scale=kw["jitter_scale"])
        kernel = lambda: (score_fused.score_write(  # noqa: E731
            si, pbase, noff, **call),)
        plain = lambda: (score_fused.score_write_reference(  # noqa: E731
            si, pbase, noff, **call),)
        library = None
        bound = _bound(*cost.score_write_work(si))
    else:
        score, cand, price_n = args
        p, n = score.shape
        kernel = lambda: sparse2.sparse_priced_min2_cand(  # noqa: E731
            score, cand, price_n)
        plain = lambda: sparse2.sparse_min2_cand_reference(  # noqa: E731
            score, cand, price_n)
        library = lambda: torch.topk(  # noqa: E731
            score + price_n[cand.clamp(0, price_n.shape[0] - 1).long()], 2,
            dim=1, largest=False)
        bound = _bound(*cost.sparse_cand_work(score, cand, price_n))
    before = launch_variants()
    shape = lead + [p, n]
    err = compare(kernel(), plain(), f"{kind} kernel at {where} {shape}")
    variant, = _variants_since(before)[{"min2": "priced_min2_argmin",
                                        "fused": "fused_score_min2",
                                        "write": "score_write"}.get(
        kind, "sparse_priced_min2_cand")]
    log(f"{kind} kernel == plain at {where} {shape} (bitwise)")
    extra = {}
    if wide:
        extra["wide_ms"] = graph_ms(lambda: _wide_launch(kind, args, kw))
    slow = kind in ("fused", "write")  # few calls: a write allocates P x N
    return dict(shape=shape, launches=launches, variant=variant,
                max_abs_err=err, **extra,
                ms=graph_ms(kernel, calls=5 if slow else 20),
                ms_events=time_ms(kernel),
                plain_ms=time_ms(plain, reps=2 if slow else 3, warmup=1),
                library_ms=None if library is None else time_ms(library,
                                                                reps=3),
                **bound)


def small_bucketed_matches_cpu(dev) -> dict:
    """A small off-bucket plan (2049 x 61, solved at 2304 x 64) with
    shape_bucketing on each engine: the card's map equals the CPU's."""
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
    model = bt.model(primary=(0, 1), replica=(1, 1))
    res = {}
    for engine, mode, kw in (("matrix", "off", {}), ("fused", "on", {}),
                             ("sparse", "auto", dict(sparse=True,
                                                     sparse_k=6))):
        opts = bt.PlanOptions(node_hierarchy=hier, shape_bucketing=True,
                              hierarchy_rules={"replica": [
                                  bt.HierarchyRule(2, 1)]}, **kw)
        got = []
        T.set_fused_score_default(mode)
        try:
            for device in (dev, "cpu"):
                timings: dict = {}
                out = bt.plan_next_map(prev, prev, nodes, nodes[:2], [],
                                       model, opts, device=device,
                                       timings=timings)
                got.append((bt.partition_map_to_json(out[0]), out[1],
                            timings["engine"]))
        finally:
            T.set_fused_score_default("auto")
        res[engine] = got[0] == got[1] and got[0][2] == engine
    log(f"small bucketed plans [2049 x 61] on the card == CPU: {res}")
    return res


def bucketed_phase(dev, prev, nodes, removed, model, ns_opts, plain, sp_map,
                   timed_fused) -> tuple:
    """Shape bucketing on the card: (a) the north star with
    shape_bucketing, padded to 106 496 x 10 240, on the engine auto picks
    (matrix) and on the fused engine: audit 0, no empty slot, no pad
    node, churn and spread beside the unbucketed plan's, and
    plan_pipeline bucketed equal to the staged bucketed plan (map,
    warnings, moves); (b) the north-star solve with p_real unpadded and
    padded equal on the real rows; (c) a small off-bucket plan on the
    card equal to the CPU's on each engine; (d) the 1M sparse deployment
    bucketed (to 1 048 576) on the sparse engine, audit 0, no pad node;
    (e) each kernel bitwise its plain version, and timed, on the inputs
    the bucketed runs gave it.  Returns the line and the kernel
    entries."""
    b_opts = dataclasses.replace(ns_opts, shape_bucketing=True)
    res, checks, entries = {}, {}, {}
    T.set_fused_score_default("auto")
    with first_call("score_write") as seen_write:
        info, b_map, seen = bucketed_plan(
            "bucketed north star, auto engine", prev, nodes, removed, model,
            b_opts, "priced_min2_argmin")
    res["matrix"] = info
    checks["matrix_engine"] = info["engine"] == "matrix" and \
        info["launches"]["priced_min2_argmin"] >= 1 and \
        info["launches"]["score_write"] >= 1
    entries["min2"] = path_kernel_entry(
        "min2", seen, info["launches"]["priced_min2_argmin"])
    del seen
    torch.cuda.empty_cache()
    entries["write"] = path_kernel_entry(
        "write", seen_write, info["launches"]["score_write"])
    del seen_write
    torch.cuda.empty_cache()

    def timed(args, kw):
        si = args[1]
        return score_fused.fused_variant(
            kw["nrules"], si.prev_state.shape[1], si.taken.shape[1],
            si.present.shape[1]) == timed_fused

    T.set_fused_score_default("on")
    try:
        info_f, f_map, seen = bucketed_plan(
            "bucketed north star, fused engine", prev, nodes, removed, model,
            dataclasses.replace(b_opts, sparse=False), "fused_score_min2",
            timed)
    finally:
        T.set_fused_score_default("auto")
    res["fused"] = info_f
    checks["fused_engine"] = info_f["engine"] == "fused" and \
        info_f["launches"]["fused_score_min2"] >= 1
    entries["fused"] = path_kernel_entry(
        "fused", seen, info_f["launches"]["fused_score_min2"])
    del seen, f_map
    padded_ns = [bucket_size(len(prev)), bucket_size(len(nodes))]
    for engine, i in (("matrix", info), ("fused", info_f)):
        i["unbucketed"] = {k: plain[engine][k] for k in
                           ("partitions_moved", "load_spread")}
        checks[f"{engine}_padded_shape"] = i["bucketed_shape"] == padded_ns
        checks[f"{engine}_no_pad_node"] = i["pad_or_unknown_nodes"] == 0

    gc.collect()
    gc.freeze()
    try:
        (pmap, pwarn, pmoves), pinfo = run_pipeline(prev, nodes, removed,
                                                    model, b_opts)
        (smap, swarn, smoves), staged = run_staged(
            prev, nodes, removed, model, b_opts)
    finally:
        gc.unfreeze()
    checks.update(
        pipeline_map_equals_staged=_same_map(pmap, smap) and
        _same_map(pmap, b_map),
        pipeline_warnings_equal=pwarn == swarn,
        pipeline_moves_equal=_ops_of(pmoves) == _ops_of(smoves),
        pipeline_no_fallback="plan.pipeline.fallback" not in
        pinfo["counters"])
    res["pipeline"] = dict(wall_s=pinfo["wall_s"],
                           staged_wall_s=staged["wall_s"],
                           launches=pinfo["launches"])
    del pmap, pmoves, smap, smoves, b_map

    problem = bt.encode_problem(prev, prev, nodes, removed, model, ns_opts)
    arrays = (problem.prev, problem.partition_weights, problem.node_weights,
              problem.valid_node, problem.stickiness, problem.gids,
              problem.gid_valid)
    rules = tuple(tuple(problem.rules.get(si, ())) for si in range(problem.S))
    cons = tuple(int(c) for c in problem.constraints)
    p_real = torch.tensor(float(problem.P), device=dev)
    solved, secs = [], []
    for arrs in (arrays, pad_problem_arrays(
            *arrays, bucket_size(problem.P), bucket_size(problem.N))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = T.solve_dense_converged(*bt.problem_to_torch(*arrs, device=dev),
                                      cons, rules, fused_score="off",
                                      record=False, p_real=p_real)
        solved.append(out[:problem.P].cpu().numpy())
        secs.append(time.perf_counter() - t0)
    bad = np.argwhere(solved[0] != solved[1])
    checks["padding_bit_neutral"] = bad.size == 0
    res["bit_neutral"] = dict(unpadded_s=secs[0], padded_s=secs[1],
                              first_diff=bad[:1].tolist())
    del solved, arrays, problem

    res["small_card_equals_cpu"] = small_bucketed_matches_cpu(dev)
    checks["small_card_equals_cpu"] = all(
        res["small_card_equals_cpu"].values())

    sp_prev, sp_nodes, sp_removed, sp_model, sp_opts = sp_map
    info_s, s_out, seen = bucketed_plan(
        "bucketed sparse 1M x 10k", sp_prev, sp_nodes, sp_removed, sp_model,
        dataclasses.replace(sp_opts, shape_bucketing=True),
        "sparse_priced_min2_cand")
    del s_out
    res["sparse"] = info_s
    checks.update(
        sparse_engine=info_s["engine"] == "sparse",
        sparse_padded_shape=info_s["bucketed_shape"] == [
            bucket_size(len(sp_prev)), bucket_size(len(sp_nodes))],
        sparse_no_pad_node=info_s["pad_or_unknown_nodes"] == 0)
    entries["sparse"] = path_kernel_entry(
        "sparse", seen, info_s["launches"]["sparse_priced_min2_cand"])
    del seen
    res["kernels"] = entries
    res["checks"] = checks
    log(f"bucketed: {json.dumps(res)}")
    if not all(checks.values()):
        raise AssertionError(f"bucketed: {checks}")
    return res, entries


# --- the fleet tier (the ``fleet`` line) --------------------------------------

FLEET_BENCH = 64  # bench.py bench_fleet's tenants (P 17-20 x N 8)
FLEET_WAVE = 240  # docs/FLEET.md's fleet-week tenant count
FLEET_WAVE_N = 64  # nodes per tenant index in the wave
FLEET_REPEATS = 3


def fleet_tenant(key: str, p: int, n: int, seed: int):
    """One tenant as bench.py bench_fleet builds it: primary + 1 replica,
    the replica on another rack of 4 nodes, unit weights, stickiness
    1.5."""
    rng = np.random.default_rng(seed)
    prev = np.full((p, 2, 1), -1, np.int32)
    prev[:, 0, 0] = rng.integers(0, n, p)
    prev[:, 1, 0] = (prev[:, 0, 0] + 1 + rng.integers(0, n - 1, p)) % n
    return fleet.TenantProblem(
        key=key, prev=prev, partition_weights=np.ones(p, np.float32),
        node_weights=np.ones(n, np.float32), valid_node=np.ones(n, bool),
        stickiness=np.full((p, 2), 1.5, np.float32),
        gids=np.stack([np.arange(n, dtype=np.int32),
                       np.arange(n, dtype=np.int32) // 4,
                       np.zeros(n, np.int32)]),
        gid_valid=np.ones((3, n), bool), constraints=(1, 1),
        rules=((), ((2, 1),)))


def bench_fleet_tenants() -> list:
    """bench.py:728-751: 64 tenants, P 17-20 x N 8, two classes."""
    return [fleet_tenant(f"tenant-{i:03d}", 17 + (i % 4), 8, 1000 + i)
            for i in range(FLEET_BENCH)]


def wave_tenants() -> list:
    """240 tenant indexes of up to 1024 partitions (Couchbase's vBuckets)
    on 64 nodes: P 960-1024, so the classes are 960 and 1024."""
    return [fleet_tenant(f"index-{i:03d}", 960 + (i * 7) % 65, FLEET_WAVE_N,
                         5000 + i) for i in range(FLEET_WAVE)]


def delta_tenant(t, result):
    """The next round of a tenant (tests/test_fleet.py:95 delta_tenant):
    its lowest held node removed, the holders dirty, the carry of
    ``result``."""
    v = int(np.unique(result.assign[result.assign >= 0])[0])
    valid = t.valid_node.copy()
    valid[v] = False
    return dataclasses.replace(
        t, prev=result.assign, valid_node=valid, carry=result.carry,
        dirty=(result.assign == v).any(axis=(1, 2)))


def _padded(t):
    k = fleet.batch_class_of(t)
    return k, pad_problem_arrays(
        t.prev, t.partition_weights, t.node_weights, t.valid_node,
        t.stickiness, t.gids, t.gid_valid, k.p, k.n)


def single_cold(t, dev, engine: str):
    """The tenant's single bucketed solve: solve_dense_converged on its
    class-padded arrays with p_real; (real-row assign, sweeps)."""
    _k, arrs = _padded(t)
    stats: dict = {}
    out = T.solve_dense_converged(
        *bt.problem_to_torch(*arrs, device=dev), t.constraints, t.rules,
        fused_score=engine, record=False, stats=stats,
        p_real=torch.tensor(float(t.prev.shape[0]), device=dev))
    return out[:t.prev.shape[0]].cpu().numpy(), stats["sweeps"]


def single_warm(t, dev, engine: str):
    """The tenant's single warm replan, as solve_fleet gates it: the
    host precheck, then solve_dense_warm on the class-padded arrays, and
    the cold solve where it demotes or declines; (assign, warm)."""
    eligible = fleet._warm_eligible(t, None, False)
    if eligible is None:
        return single_cold(t, dev, engine)[0], False
    dirty, used = eligible
    k, arrs = _padded(t)
    cu = torch.from_numpy(np.pad(used, ((0, 0), (0, k.n - used.shape[1])))
                          ).to(dev)
    out, _carry = T.solve_dense_warm(
        *bt.problem_to_torch(*arrs, device=dev), t.constraints, t.rules,
        dirty=np.pad(dirty, (0, k.p - dirty.shape[0]),
                     constant_values=True),
        carry=T.SolveCarry(prices=cu.sum(0),
                           assign=torch.from_numpy(arrs[0]).to(dev), used=cu),
        fused_score=engine, record=False,
        p_real=torch.tensor(float(t.prev.shape[0]), device=dev))
    if out is None:
        return single_cold(t, dev, engine)[0], False
    return out[:t.prev.shape[0]], True


def _sync_wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _variants_since(before: dict) -> dict:
    """Each wrapper's launches by variant since ``before`` (a
    launch_variants() snapshot)."""
    now = launch_variants()
    return {k: {v: c - before[k].get(v, 0) for v, c in now[k].items()
                if c > before[k].get(v, 0)} for k in now}


def _auction_rounds() -> int:
    """The process recorder's ``plan.solve.auction_rounds`` so far."""
    return int(get_recorder().counters.get("plan.solve.auction_rounds", 0))


def _fleet_run(tenants, dev, engine=None):
    """solve_fleet with the kernels' batched launches and the auction
    rounds counted: (results, wall s, info).  The launch counts are this
    run's, read as a difference: the fleet phase's own totals keep
    running; the rounds go to the run's own recorder."""
    before = launch_variants()
    rec = Recorder()
    res, wall = _sync_wall(lambda: fleet.solve_fleet(
        tenants, fused_score=engine, recorder=rec, device=dev))
    variants = _variants_since(before)
    info = dict(wall_s=wall, batches=int(rec.counters["fleet.batches"]),
                launches={k: sum(v.values()) for k, v in variants.items()},
                variants=variants,
                rounds=int(rec.counters.get("plan.solve.auction_rounds", 0)),
                max_sweeps=max(r.sweeps for r in res),
                warm=sum(r.warm for r in res))
    return res, info


def _same_results(got, want) -> dict:
    """Tenant-by-tenant bitwise equality; the first differing tenant and
    [p, s, r] where one differs."""
    for g, (w_assign, w_sweeps) in zip(got, want):
        if not np.array_equal(g.assign, w_assign) or \
                (w_sweeps is not None and g.sweeps != w_sweeps):
            bad = np.argwhere(g.assign != w_assign)
            return dict(equal=False, tenant=g.key,
                        first_diff=bad[:1].tolist(), sweeps=g.sweeps,
                        single_sweeps=w_sweeps)
    return dict(equal=True)


def fleet_bench_stage(dev) -> tuple:
    """(a) bench.py's fleet stage: 64 tenants batched on the card, each
    bitwise its single bucketed solve on the card and the port's CPU
    solve_fleet; the median of 3 calls after a warm-up both ways."""
    tenants = bench_fleet_tenants()
    engine = T.resolve_default_fused_score(18, 8, dev)
    res, info = _fleet_run(tenants, dev)
    cpu = fleet.solve_fleet(tenants, device="cpu")
    singles = [single_cold(t, dev, engine) for t in tenants]
    checks = dict(
        card_equals_single=_same_results(res, singles),
        card_equals_cpu=_same_results(res, [(c.assign, c.sweeps)
                                            for c in cpu]))
    batched, sequential = [], []
    for _ in range(1 + FLEET_REPEATS):
        batched.append(_fleet_run(tenants, dev)[1]["wall_s"])
        sequential.append(_sync_wall(
            lambda: [single_cold(t, dev, engine) for t in tenants])[1])
    b_s = statistics.median(batched[1:])
    s_s = statistics.median(sequential[1:])
    out = dict(tenants=len(tenants), classes=sorted(
        {f"{k.p}x{k.n}" for k in map(fleet.batch_class_of, tenants)}),
        engine=_ENGINES[engine], first_call=info, batched_s=b_s,
        sequential_s=s_s, batched_walls_s=batched,
        sequential_walls_s=sequential, batched_over_sequential=b_s / s_s,
        solves_per_s=dict(batched=len(tenants) / b_s,
                          sequential=len(tenants) / s_s),
        checks={k: v["equal"] for k, v in checks.items()},
        diffs={k: v for k, v in checks.items() if not v["equal"]})
    return out, res


def fleet_wave(dev) -> tuple:
    """(b) the 240-tenant wave at deployment width: cold, then a warm
    round with one held node per tenant removed; each tenant bitwise
    its single solve (cold: solve_dense_converged; warm:
    solve_dense_warm, accepted or declined alike); batched and
    sequential timed once each."""
    tenants = wave_tenants()
    engine = T.resolve_default_fused_score(1024, FLEET_WAVE_N, dev)
    # The kernel entries take the large class's first batched call (the
    # score write's: the replica slot's).
    with first_call("priced_min2_argmin",
                    lambda args, kw: args[0].dim() == 3
                    and args[0].shape[1] == 1024) as seen, \
            first_call("score_write", _replica_write_batch(1024)) \
            as seen_write:
        cold, cold_info = _fleet_run(tenants, dev)
        round2 = [delta_tenant(t, r) for t, r in zip(tenants, cold)]
        warm, warm_info = _fleet_run(round2, dev)
    launches = {name: sum(c for i in (cold_info, warm_info)
                          for v, c in i["variants"][name].items()
                          if v.startswith("batched"))
                for name in ("priced_min2_argmin", "score_write")}
    cold_single, cold_seq_s = _sync_wall(
        lambda: [single_cold(t, dev, engine) for t in tenants])
    warm_single, warm_seq_s = _sync_wall(
        lambda: [single_warm(t, dev, engine) for t in round2])
    checks = dict(
        cold_equals_single=_same_results(cold, cold_single),
        warm_equals_single=_same_results(
            warm, [(a, None) for a, _w in warm_single]))
    warm_flags = [w for _a, w in warm_single]
    checks["warm_flags_equal"] = dict(equal=warm_flags == [
        r.warm for r in warm])
    checks["narrow_min2_taken"] = dict(equal=all(
        "batched_rows_per_warp" in i["variants"]["priced_min2_argmin"]
        for i in (cold_info, warm_info)))
    checks["write_batched_launched"] = dict(
        equal=launches["score_write"] > 0)
    k_cells = sum(fleet.batch_class_of(t).p for t in tenants) * FLEET_WAVE_N
    out = dict(
        tenants=len(tenants), nodes=FLEET_WAVE_N, engine=_ENGINES[engine],
        classes={f"{k.p}x{k.n}": n for k, n in collections.Counter(
            map(fleet.batch_class_of, tenants)).items()},
        matrix_working_set_bytes=k_cells * T._MATRIX_BYTES_PER_CELL,
        cold=dict(cold_info, sequential_s=cold_seq_s,
                  batched_over_sequential=cold_info["wall_s"] / cold_seq_s),
        warm=dict(warm_info, accepted=sum(warm_flags),
                  sequential_s=warm_seq_s,
                  batched_over_sequential=warm_info["wall_s"] / warm_seq_s),
        checks={k: v["equal"] for k, v in checks.items()},
        diffs={k: v for k, v in checks.items() if not v["equal"]})
    return out, cold, (seen, seen_write), launches


def fleet_service(dev, cold) -> dict:
    """(c) PlanService on the card: the wave's 240 tenants submitted at
    once, coalesced into per-class batches; results equal the batched
    cold wave; p50/p99 admission-to-result latency."""
    tenants = wave_tenants()
    rec = Recorder()

    async def drive():
        svc = plan_service.PlanService(recorder=rec, device=dev)
        await svc.start()
        t0 = time.perf_counter()
        done = {}

        async def one(t):
            r = await svc.submit(t)
            done[t.key] = time.perf_counter() - t0
            return r

        results = await asyncio.gather(*[one(t) for t in tenants])
        await svc.stop()
        return results, [done[t.key] for t in tenants]

    (results, lat), wall = _sync_wall(lambda: asyncio.run(drive()))
    equal = all(np.array_equal(r.assign, c.assign)
                for r, c in zip(results, cold))
    return dict(tenants=len(tenants), wall_s=wall,
                batches=int(rec.counters["fleet.batches"]),
                requests=int(rec.counters["fleet.requests"]),
                latency_p50_s=float(np.percentile(lat, 50)),
                latency_p99_s=float(np.percentile(lat, 99)),
                checks=dict(equals_batched_wave=equal))


def _replica_batch(p: int):
    """A first_call filter: a batched in-kernel score launch of the
    replica slot (one rack rule: ``n1r1t2a2``, most of the fleet's
    launches) over P = p rows."""
    return lambda args, kw: args[0].dim() == 2 and kw["nrules"] == 1 \
        and args[1].stick.shape[-1] == p


def _replica_write_batch(p: int):
    """_replica_batch for the score write, whose first argument is the
    packed ScoreInputs."""
    return lambda args, kw: args[0].stick.dim() == 2 and \
        kw["nrules"] == 1 and args[0].stick.shape[-1] == p


def fleet_fused(dev) -> tuple:
    """(d) fused_score="on" on the bench tenants: each equal to its
    single fused solve, the batched fused launch counted."""
    tenants = bench_fleet_tenants()
    with first_call("fused_score_min2", _replica_batch(18)) as seen:
        res, info = _fleet_run(tenants, dev, "on")
    singles = [single_cold(t, dev, "on") for t in tenants]
    batched = {k: v for k, v in info["variants"]["fused_score_min2"].items()
               if k.startswith("batched_")}
    check = _same_results(res, singles)
    return dict(info, batched_variants=batched,
                checks=dict(equals_single=check["equal"],
                            batched_launched=sum(batched.values()) > 0,
                            narrow_taken=any(k.endswith("_rows_per_warp")
                                             for k in batched)),
                diff=None if check["equal"] else check), seen, \
        sum(batched.values())


def fleet_wave_fused(dev) -> tuple:
    """(f) the wave's cold batch with fused_score="on": each tenant
    bitwise its single fused solve, the narrow layout taken; the large
    class's first batched call kept for the kernels line."""
    tenants = wave_tenants()
    with first_call("fused_score_min2", _replica_batch(1024)) as seen:
        res, info = _fleet_run(tenants, dev, "on")
    singles = [single_cold(t, dev, "on") for t in tenants]
    batched = {k: v for k, v in info["variants"]["fused_score_min2"].items()
               if k.startswith("batched_")}
    check = _same_results(res, singles)
    return dict(info, batched_variants=batched,
                checks=dict(equals_single=check["equal"],
                            narrow_taken=any(k.endswith("_rows_per_warp")
                                             for k in batched)),
                diff=None if check["equal"] else check), seen, \
        sum(batched.values())


def _controller_run(device) -> tuple:
    """(e) 8 tenants under one FleetController, one zone-outage delta
    for all: final maps and each tenant's op log (sorted: the loop's
    interleaving across nodes is not part of the contract)."""
    nodes = [f"n{i:02d}" for i in range(16)]
    zone = tuple(nodes[:4])
    model = bt.model(primary=(0, 1), replica=(1, 1))
    logs: dict = {}

    def tenant_map(k):
        return {f"t{k}p{i:02d}": bt.Partition(f"t{k}p{i:02d}", {
            "primary": [nodes[(i + k) % 16]],
            "replica": [nodes[(i + k + 1 + i % 5) % 16]]})
            for i in range(12 + (k * 3) % 9)}

    async def drive():
        fc = fleetloop.FleetController(nodes, device=device,
                                       admission_window_s=0.02,
                                       debounce_s=0.02)
        await fc.start()
        for k in range(8):
            log = logs.setdefault(f"tenant{k}", [])

            async def assign(stop_ch, node, partitions, states, ops,
                             log=log):
                log.extend((node, p, s, o) for p, s, o in
                           zip(partitions, states, ops))
                await asyncio.sleep(0)

            fc.add_tenant(f"tenant{k}", model, tenant_map(k), assign)
        fc.submit_all(bt.ClusterDelta(fail=zone))
        maps = await fc.quiesce_all()
        await fc.stop()
        return {k: {p: dict(v.nodes_by_state) for p, v in m.items()}
                for k, m in maps.items()}, fc.service.host_solve_s

    (maps, solve_s), wall = _sync_wall(lambda: asyncio.run(drive())) \
        if device != "cpu" else (asyncio.run(drive()), 0.0)
    on_zone = sum(n in zone for m in maps.values() for nbs in m.values()
                  for ns in nbs.values() for n in ns)
    return maps, {k: sorted(v) for k, v in logs.items()}, on_zone, wall


def fleet_controller(dev) -> dict:
    card_maps, card_logs, on_zone, wall = _controller_run(dev)
    cpu_maps, cpu_logs, _z, _w = _controller_run("cpu")
    return dict(tenants=len(card_maps), wall_s=wall,
                ops=sum(map(len, card_logs.values())),
                checks=dict(maps_equal_cpu=card_maps == cpu_maps,
                            op_logs_equal_cpu=card_logs == cpu_logs,
                            nothing_on_failed_zone=on_zone == 0))


def fleet_kernel_entry(kind: str, seen: dict, launches: int,
                       plain_reps: int = 3) -> dict:
    """A batched launch against its plain version on the inputs of its
    first fleet call, bitwise; timed as the kernels phase times, with
    its bound from these inputs, and its wide layout (the batched launch
    before the narrow rows) timed beside it."""
    args, kw = seen["args"], seen["kw"]
    if kind == "min2":
        score, price = args
        b, p, n = score.shape
        kernel = lambda: reduce2.priced_min2_argmin(score, price)  # noqa: E731
        plain = lambda: reduce2.batched_min2_reference(  # noqa: E731
            score, price)
        library = lambda: torch.topk(  # noqa: E731
            (score + price[:, None, :]).reshape(b * p, n), 2, dim=1,
            largest=False)
        bound = _bound(*cost.min2_work(score, price))
        name = "priced_min2_argmin"
    else:
        price, si = args[:2]
        b, n = price.shape
        p = si.stick.shape[-1]
        call = dict(nrules=kw["nrules"], jitter_scale=kw["jitter_scale"])
        kernel = lambda: score_fused.fused_score_min2(  # noqa: E731
            price, si, *args[2:4], **call)
        plain = lambda: score_fused.batched_fused_reference(  # noqa: E731
            price, si, *args[2:4], **call)
        library = None
        bound = _bound(*cost.fused_work(price, si, kw["nrules"]))
        name = "fused_score_min2"
    reset_launch_counts()
    got = kernel()
    variant, = launch_variants()[name]
    err = compare(got, plain(), f"batched {kind} kernel at [{b}, {p}, {n}]")
    log(f"batched {kind} kernel == plain at [{b}, {p}, {n}] (bitwise)")
    # The plain version's compare call above is its warm-up.
    return dict(shape=[b, p, n], launches=launches, variant=variant,
                max_abs_err=err, ms=graph_ms(kernel),
                wide_ms=graph_ms(lambda: _wide_launch(kind, args, kw)),
                ms_events=time_ms(kernel),
                plain_ms=time_ms(plain, reps=plain_reps, warmup=0),
                library_ms=None if library is None else time_ms(library,
                                                                reps=3),
                **bound)


def fleet_phase(dev) -> tuple:
    """The fleet tier on the card (the ``fleet`` line): (a) bench.py's
    fleet stage, (b) the 240-tenant wave cold and warm, (c) PlanService
    over the wave, (d) the in-kernel score engine on the bench tenants,
    (e) a FleetController on the card and the CPU; returns the line and
    the batched kernels' entries."""
    T.set_fused_score_default("auto")
    reset_launch_counts()
    res: dict = {}
    parts: dict = {}
    t0 = time.perf_counter()
    res["bench_fleet"], _r = fleet_bench_stage(dev)
    parts["bench_fleet"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["wave"], cold, (seen_min2, seen_write), wave_launches = \
        fleet_wave(dev)
    min2_launches = wave_launches["priced_min2_argmin"]
    parts["wave"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["service"] = fleet_service(dev, cold)
    del cold
    parts["service"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["fused"], seen_fused, fused_launches = fleet_fused(dev)
    parts["fused"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["wave_fused"], seen_wave_fused, wave_fused_launches = \
        fleet_wave_fused(dev)
    parts["wave_fused"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["controller"] = fleet_controller(dev)
    parts["controller"] = time.perf_counter() - t0
    # Every launch of the phase's runs, by variant, before the kernel
    # entries' comparison launches.
    res["variants"] = launch_variants()
    t0 = time.perf_counter()
    entries = {"min2": fleet_kernel_entry("min2", seen_min2, min2_launches),
               "fused": fleet_kernel_entry("fused", seen_fused,
                                           fused_launches),
               "fused_wave": fleet_kernel_entry(
                   "fused", seen_wave_fused, wave_fused_launches,
                   plain_reps=1),
               "write": path_kernel_entry(
                   "write", seen_write, wave_launches["score_write"],
                   "the fleet wave's")}
    parts["kernels"] = time.perf_counter() - t0
    res["parts_s"] = parts
    checks = {f"{part}.{k}": v for part in ("bench_fleet", "wave", "service",
                                            "fused", "wave_fused",
                                            "controller")
              for k, v in res[part]["checks"].items()}
    checks["min2_batched_launched"] = min2_launches > 0
    res["checks"] = checks
    log(f"fleet: {json.dumps(res)}")
    if not all(checks.values()):
        raise AssertionError(f"fleet: {checks}")
    return res, entries


# --- the testing harness (the ``harness`` line) ------------------------------

TRACE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests", "traces")
# The fleet week at its full width: 240 tenants on 18 nodes over 7 virtual
# days, nothing cut.
FLEET_WEEK_DAYS = 7.0
# sha256 of the JAX package's own run_fleet_scenario(fleet_week()) log_text()
# and exposition, computed on the CPU with
#   JAX_PLATFORMS=cpu python -c "import hashlib; from blance_tpu.testing.\
#   scenarios import fleet_week; from blance_tpu.testing.fleetsim import \
#   run_fleet_scenario; r = run_fleet_scenario(fleet_week()); print(*(hashlib.\
#   sha256(t.encode()).hexdigest() for t in (r.log_text(), r.exposition)))"
# (tests/test_torch_harness.py holds the port's CPU run to them).
FLEET_WEEK_LOG_SHA256 = (
    "166bacaf16c693a1c2da9282a25e99326f65dff2cc9f0382ef73fa07308ac4ab")
FLEET_WEEK_EXPO_SHA256 = (
    "fd014693eeb2c88616c2f3f80bf2f455d5d6dc6c0af1f4d432601a324f11361f")
# The port's CPU walk signatures at CI_WALK_SEEDS (11, 23, 37), equal to
# the JAX package's (tests/test_torch_schedule.py holds both to them).
SCHEDULE_WALK_SIGNATURES = {
    "fleet_coalesce_window": (
        "159fb33ebc808000", "01bbbd938a1b65ba", "8bf4141b49e6e1bc"),
    "movers_race_breaker_trip": (
        "e2c9fcaa9ffc9e60", "7a837f43ef53499b", "ace49db6fef5ccb5"),
    "pause_cycle_guard": (
        "c69ab8e1ca8b32aa", "ef9d7591497494a8", "c42f63d98603dae1"),
    "pause_resume_during_retry_backoff": (
        "fa783af8d83ffa74", "15c29821e8e086e4", "7f7629588c92a5d7"),
    "reschedule_on_quarantine": (
        "fff2df369bd02dd2", "9ded7ff936fc5eb1", "114f9374254435fe"),
    "slo_gauges_under_chaos": (
        "07e66de1548cb0ff", "d4fc6367369e75ba", "57682c8fdc3c45b4"),
    "stop_during_quarantine_probe": (
        "894c36aae9a18570", "b0f2b1eca4844a62", "fdb86ab935246f4a"),
    "supersede_mid_rebalance": (
        "544896eef4f340a3", "03837cabb38dc844", "33785f277425fd7a"),
    "two_movers_three_partitions": (
        "00921d806035e624", "4c5d26bd87ddfa9c", "fef4b568e647f309"),
}
HARNESS_BUDGET_S = 180.0  # the phase's wall, kernel entries included


def _on_card(args, kw) -> bool:
    return bool(args) and args[0].is_cuda


def _write_on_card(batched: bool):
    """A first_call filter: a score write on the card, batched or not."""
    return lambda args, kw: args[0].base.is_cuda and \
        (args[0].base.dim() == 2) == batched


def _sha256(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def _committed_trace(name: str) -> str:
    with open(os.path.join(TRACE_DIR, name)) as f:
        return f.read()


def harness_traces(dev) -> dict:
    """The five committed traces through the port on the card, each byte
    for byte the file under tests/traces/ (the pause guard: its replay
    comes back ok, as the reference replays it)."""
    out: dict = {}

    def replayed(key, name, make_text):
        t0 = time.perf_counter()
        text = make_text()
        out[key] = dict(equal=text == _committed_trace(name),
                        wall_s=time.perf_counter() - t0)

    replayed("sim_spot_preemption_s11", "sim_spot_preemption_s11.json",
             lambda: simulate.run_scenario(scenarios.spot_preemption(11),
                                           device=dev).log_text())
    replayed("sim_hetero_drain_s41", "sim_hetero_drain_s41.json",
             lambda: simulate.run_scenario(dataclasses.replace(
                 scenarios.hetero_drain(41), scheduler="critical_path"),
                 device=dev).log_text())
    fsync = os.environ.get("BLANCE_WAL_FSYNC")
    os.environ["BLANCE_WAL_FSYNC"] = "0"
    try:
        with tempfile.TemporaryDirectory() as d:
            cs = scenarios.crash_storm(19)
            durability.reset_fences()
            replayed("crash_storm_s19", "crash_storm_s19.json",
                     lambda: crashsim.run_crash_scenario(
                         cs.base, d, crashes=cs.crashes,
                         snapshot_every=cs.snapshot_every,
                         rotate_records=cs.rotate_records,
                         device=dev).log_text())
            durability.reset_fences()
    finally:
        if fsync is None:
            del os.environ["BLANCE_WAL_FSYNC"]
        else:
            os.environ["BLANCE_WAL_FSYNC"] = fsync
    before = launch_variants()
    replayed("fleet_zone_outage_s5_t8", "fleet_zone_outage_s5_t8.json",
             lambda: fleetsim.run_fleet_scenario(
                 scenarios.fleet_zone_outage(seed=5, tenants=8),
                 device=dev).log_text())
    variants = _variants_since(before)["priced_min2_argmin"]
    out["fleet_zone_outage_s5_t8"]["min2_variants"] = variants
    out["fleet_zone_outage_s5_t8"]["min2_batched_launched"] = any(
        v.startswith("batched") for v in variants)
    t0 = time.perf_counter()
    res = sched.replay(schedule.SCENARIOS["pause_cycle_guard"].factory,
                       sched.load_trace(os.path.join(
                           TRACE_DIR, "pause_cycle_guard.json")),
                       strict=False)
    out["pause_cycle_guard"] = dict(ok=res.ok, signature=res.signature,
                                    steps=res.steps,
                                    wall_s=time.perf_counter() - t0)
    return out


def harness_closed_loop(dev) -> dict:
    """spot_preemption(11) and mixed_week(7) on the card's planner
    (backend "cuda"), without and with a PlannerSession: each run's log on
    the card equal to its log on the CPU, min2 launched on the card;
    ``plans`` counts the card run's solves (``plan.solve.calls``)."""
    out = {}
    for family, scn in (("spot_preemption_s11", scenarios.spot_preemption(11)),
                        ("mixed_week_s7", scenarios.mixed_week(7))):
        for session in (False, True):
            s = dataclasses.replace(scn, backend="cuda", use_session=session)
            before = launch_variants()
            card = simulate.run_scenario(s, device=dev)
            variants = _variants_since(before)
            cpu = simulate.run_scenario(s, device="cpu")
            samples, _types = parse_prometheus(card.exposition)
            out[family + ("_session" if session else "")] = dict(
                equal_cpu=card.log_text() == cpu.log_text(),
                complete=card.complete, passes=card.rebalances,
                plans=samples["blance_plan_solve_calls_total"],
                carry_hits=samples["blance_plan_solve_carry_hit_total"],
                card_wall_s=card.wall_s, cpu_wall_s=cpu.wall_s,
                launches={k: sum(v.values()) for k, v in variants.items()
                          if v},
                min2_variants=variants["priced_min2_argmin"])
    return out


def harness_fleet_week(dev) -> dict:
    """fleet_week() on the card: complete, every tenant available at the
    end, nothing unconverged, coalescing at least 4 plan requests a
    dispatch, and its log and exposition the JAX package's, by digest."""
    torch.cuda.synchronize()
    start_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    scn = scenarios.fleet_week(days=FLEET_WEEK_DAYS)
    before = launch_variants()
    r = fleetsim.run_fleet_scenario(scn, device=dev)
    torch.cuda.synchronize()
    variants = _variants_since(before)
    log_sha, expo_sha = _sha256(r.log_text()), _sha256(r.exposition)
    info = dict(
        days=FLEET_WEEK_DAYS, tenants=r.tenants, nodes=len(scn.nodes),
        wall_s=r.wall_s, dispatches=r.dispatches,
        plan_requests=r.plan_requests, complete=r.complete,
        availability_min=r.fleet.availability_min,
        unconverged=r.unconverged, carry_hits=r.carry_hits,
        min2_batched_launches=sum(
            c for v, c in variants["priced_min2_argmin"].items()
            if v.startswith("batched")),
        launches={k: sum(v.values()) for k, v in variants.items() if v},
        min2_variants=variants["priced_min2_argmin"],
        peak_alloc_bytes=torch.cuda.max_memory_allocated(),
        start_alloc_bytes=start_bytes, log_sha256=log_sha,
        expo_sha256=expo_sha, phase_wall=r.phase_wall)
    info["checks"] = dict(
        complete=r.complete, availability_1=r.fleet.availability_min == 1.0,
        converged=r.unconverged == 0,
        coalesced_4x=r.dispatches * 4 <= r.plan_requests,
        min2_batched_launched=info["min2_batched_launches"] > 0,
        log_digest_is_reference=log_sha == FLEET_WEEK_LOG_SHA256,
        expo_digest_is_reference=expo_sha == FLEET_WEEK_EXPO_SHA256)
    return info


def harness_walks() -> dict:
    """run_scenario_walks over every scenario of the explorer's registry
    at CI_WALK_SEEDS: every walk clean, every signature the CPU's."""
    out = {}
    for name, scenario in schedule.SCENARIOS.items():
        walks = schedule.run_scenario_walks(scenario, schedule.CI_WALK_SEEDS)
        out[name] = dict(
            ok=all(w.ok for _seed, w in walks),
            signatures=[w.signature for _seed, w in walks],
            steps=[w.steps for _seed, w in walks])
    return out


def harness_phase(dev) -> tuple:
    """The port's testing harness on the card (the ``harness`` line): the
    committed traces, the closed loop on the card's planner, the fleet
    week, the schedule walks; returns the line and the min2 entries on
    the inputs of its first unbatched (closed loop) and batched (fleet
    simulator) calls on the card."""
    T.set_fused_score_default("auto")
    reset_launch_counts()
    parts: dict = {}
    res: dict = {}
    t_phase = time.perf_counter()
    with first_call("priced_min2_argmin",
                    lambda a, kw: _on_card(a, kw) and a[0].dim() == 3) \
            as seen_batched, \
            first_call("score_write", _write_on_card(True)) \
            as seen_write_batched:
        t0 = time.perf_counter()
        res["traces"] = harness_traces(dev)
        parts["traces"] = time.perf_counter() - t0
        with first_call("priced_min2_argmin",
                        lambda a, kw: _on_card(a, kw) and a[0].dim() == 2) \
                as seen_flat, \
                first_call("score_write", _write_on_card(False)) \
                as seen_write_flat:
            t0 = time.perf_counter()
            res["closed_loop"] = harness_closed_loop(dev)
            parts["closed_loop"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["fleet_week"] = harness_fleet_week(dev)
        parts["fleet_week"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["walks"] = harness_walks()
    parts["walks"] = time.perf_counter() - t0
    # Every launch of the phase's runs, before the entries' comparisons.
    res["variants"] = launch_variants()
    min2 = res["variants"]["priced_min2_argmin"]
    batched = sum(c for v, c in min2.items() if v.startswith("batched"))
    write = res["variants"]["score_write"]
    write_batched = sum(c for v, c in write.items()
                        if v.startswith("batched"))
    t0 = time.perf_counter()
    entries = {
        "flat": path_kernel_entry("min2", seen_flat, sum(min2.values()) -
                                  batched, "the closed loop's", wide=True),
        "batched": fleet_kernel_entry("min2", seen_batched, batched),
        "write_flat": path_kernel_entry(
            "write", seen_write_flat, sum(write.values()) - write_batched,
            "the closed loop's"),
        "write_batched": path_kernel_entry(
            "write", seen_write_batched, write_batched,
            "the fleet simulator's")}
    parts["kernels"] = time.perf_counter() - t0
    res["parts_s"] = parts
    res["phase_s"] = time.perf_counter() - t_phase
    checks = {f"traces.{k}": v.get("equal", v.get("ok"))
              for k, v in res["traces"].items()}
    checks["traces.fleet_min2_batched"] = \
        res["traces"]["fleet_zone_outage_s5_t8"]["min2_batched_launched"]
    for k, v in res["closed_loop"].items():
        checks[f"closed_loop.{k}.equal_cpu"] = v["equal_cpu"]
        checks[f"closed_loop.{k}.complete"] = v["complete"]
        checks[f"closed_loop.{k}.min2_launched"] = \
            v["launches"].get("priced_min2_argmin", 0) > 0
    checks.update({f"fleet_week.{k}": v
                   for k, v in res["fleet_week"]["checks"].items()})
    for name, w in res["walks"].items():
        checks[f"walks.{name}.ok"] = w["ok"]
        checks[f"walks.{name}.signatures_cpu"] = \
            tuple(w["signatures"]) == SCHEDULE_WALK_SIGNATURES[name]
    checks["walks.registry"] = \
        sorted(res["walks"]) == sorted(SCHEDULE_WALK_SIGNATURES)
    checks["no_fused_or_sparse_launch"] = not any(
        res["variants"][k] for k in ("fused_score_min2",
                                     "sparse_priced_min2_cand"))
    checks["within_budget"] = res["phase_s"] <= HARNESS_BUDGET_S
    res["budget_s"] = HARNESS_BUDGET_S
    res["checks"] = checks
    log(f"harness: {json.dumps(res)}")
    if not all(checks.values()):
        raise AssertionError(
            f"harness: {[k for k, v in checks.items() if not v]}")
    return res, entries


# --- the analysis gate (the ``analysis`` line) ------------------------------

# The phase's wall, kernel entries included; since the sharded contracts
# it also starts the audit's 2-rank mesh on the card (10-11 s).
ANALYSIS_BUDGET_S = 45.0


def analysis_phase(dev) -> tuple:
    """The port's analysis gate on the card (the ``analysis`` line): the
    lints over the package (host work) and the shape audit with
    ``device="cuda"``, folded through the port's baseline; returns the
    line and the kernel entries on the inputs of the audit's first
    unbatched and batched min2 calls and its first sparse call."""
    from blance_tpu_torch.analysis import run_all

    T.set_fused_score_default("auto")
    t_phase = time.perf_counter()
    reset_launch_counts()
    with first_call("priced_min2_argmin",
                    lambda a, kw: _on_card(a, kw) and a[0].dim() == 3) \
            as seen_batched, \
            first_call("priced_min2_argmin",
                       lambda a, kw: _on_card(a, kw) and a[0].dim() == 2) \
            as seen_flat, \
            first_call("sparse_priced_min2_cand", _on_card) as seen_sparse, \
            first_call("score_write", _write_on_card(True)) \
            as seen_write_batched, \
            first_call("score_write", _write_on_card(False)) \
            as seen_write_flat:
        t0 = time.perf_counter()
        result = run_all(shape_audit=True, device=dev)
        gate_s = time.perf_counter() - t0
    # Every launch of the gate's run, before the entries' comparisons.
    counts = launch_counts()
    variants = launch_variants()
    min2 = variants["priced_min2_argmin"]
    batched = sum(c for v, c in min2.items() if v.startswith("batched"))
    write = variants["score_write"]
    write_batched = sum(c for v, c in write.items()
                        if v.startswith("batched"))
    t0 = time.perf_counter()
    entries = {
        "flat": path_kernel_entry("min2", seen_flat,
                                  sum(min2.values()) - batched,
                                  "the audit's"),
        "batched": fleet_kernel_entry("min2", seen_batched, batched),
        "sparse": path_kernel_entry("sparse", seen_sparse,
                                    counts["sparse_priced_min2_cand"],
                                    "the audit's"),
        "write_flat": path_kernel_entry(
            "write", seen_write_flat, sum(write.values()) - write_batched,
            "the audit's"),
        "write_batched": path_kernel_entry(
            "write", seen_write_batched, write_batched, "the audit's")}
    kernels_s = time.perf_counter() - t0
    timings = result.shape_timings
    res = {
        "checked_files": result.checked_files,
        "shape_entries": result.shape_entries,
        "new": [f.render() for f in result.new],
        "baselined": len(result.baselined),
        "stale": [e.render() for e in result.unused_baseline],
        "errors": result.errors,
        "launches": counts,
        "variants": variants,
        "contract_s": timings,
        "contracts_s": sum(timings.values()),
        "slowest_contract": max(timings, key=timings.get, default=None),
        "parts_s": {"gate": gate_s, "kernels": kernels_s},
        "phase_s": time.perf_counter() - t_phase,
        "budget_s": ANALYSIS_BUDGET_S,
    }
    res["checks"] = checks = {
        "no_new_findings": not res["new"],
        "no_stale_pins": not res["stale"],
        "no_errors": not res["errors"],
        "all_contracts_ran": res["shape_entries"] == 76 and len(timings) == 72,
        "min2_launched": sum(min2.values()) - batched > 0,
        "min2_batched_launched": batched > 0,
        "write_launched": sum(write.values()) - write_batched > 0,
        "write_batched_launched": write_batched > 0,
        "sparse_launched": counts["sparse_priced_min2_cand"] > 0,
        "within_budget": res["phase_s"] <= ANALYSIS_BUDGET_S,
    }
    log(f"analysis: {json.dumps(res)}")
    if not all(checks.values()):
        raise AssertionError(
            f"analysis: {[k for k, v in checks.items() if not v]}")
    return res, entries


# --- multi-GPU sharding on one card (the ``sharded`` line) -------------------

SHARDED_BUDGET_S = 240.0  # the phase's wall, the meshes' start-up included
SHARDED_MID = (4096, 256)  # the card-against-CPU rack problem
SHARDED_NOTE = ("every mesh's ranks share the one card: these walls measure "
                "the mesh's overhead and correctness, not scaling")


def _dense_problem(prev, nodes, removed, model, opts):
    """(problem, solver arrays, constraints, rules) of a PartitionMap."""
    problem = bt.encode_problem(prev, prev, nodes, removed, model, opts)
    return problem, (problem.prev, problem.partition_weights,
                     problem.node_weights, problem.valid_node,
                     problem.stickiness, problem.gids, problem.gid_valid), \
        tuple(int(c) for c in problem.constraints), \
        tuple(tuple(problem.rules.get(si, ())) for si in range(problem.S))


def _mesh_stats(stats: dict) -> dict:
    """One sharded call's per-rank numbers (parallel/mesh.py stats)."""
    per = stats["mesh"]["stats"]
    return dict(
        wall_rank0_s=stats["mesh"]["wall_s"],
        solve_s=[per[r]["solve_s"] for r in sorted(per)],
        peak_alloc_bytes=[per[r]["peak_alloc_bytes"] for r in sorted(per)],
        collectives=[per[r]["collectives"] for r in sorted(per)],
        collectives_by_axis=per[0]["by_axis"],
        collective_s=[per[r]["coll_s"] for r in sorted(per)],
        collective_bytes=[per[r]["coll_bytes"] for r in sorted(per)],
        staged_copies=[per[r]["staged_copies"] for r in sorted(per)],
        launches={k: [per[r]["launches"].get(k, 0) for r in sorted(per)]
                  for k in per[0]["launches"]})


def _map_quality(problem, assign) -> dict:
    """Audit, removed-node and empty-slot counts, churn and spread of a
    solved assignment against the problem's beginning state."""
    audit = bt.check_assignment(problem, assign)
    removed = np.flatnonzero(~problem.valid_node)
    held = assign[assign >= 0]
    load = np.bincount(held, minlength=problem.N)[problem.valid_node]
    return dict(audit=audit, on_removed=int(np.isin(assign, removed).sum()),
                empty_slots=int((assign < 0).sum()),
                partitions_moved=int(np.any(assign != problem.prev,
                                            axis=(1, 2)).sum()),
                load_spread=int(load.max() - load.min()))


def _sharded_run(label, solve, mesh, quality_of=None, **kw) -> tuple:
    """One sharded solve on ``mesh`` with rank 0's launch counts set to 0
    just before it and read just after (the workers report their own);
    returns (assign, info)."""
    reset_launch_counts()
    rounds0 = _auction_rounds()
    stats: dict = {}
    out, wall = _sync_wall(lambda: solve(mesh, stats=stats, **kw))
    assign = out[0] if isinstance(out, tuple) else out
    info = dict(backend=mesh.backend, shape=list(mesh.devices.shape),
                wall_s=wall, engine=stats.get("engine", "sparse"),
                sweeps=stats.get("sweeps"),
                rank0_auction_rounds=_auction_rounds() - rounds0,
                rank0_launches={k: v for k, v in launch_counts().items()
                                if v},
                **{k: stats[k] for k in ("k", "exhausted_rows",
                                         "fallback_rows", "accepted")
                   if k in stats},
                **_mesh_stats(stats))
    if quality_of is not None:
        info.update(_map_quality(quality_of, assign))
    log(f"sharded {label}: {json.dumps(info)}")
    return out, info, stats


def _captured(stats: dict, name: str, dev) -> dict:
    """A worker's first-call kernel inputs (host tensors) back on the
    card, as path_kernel_entry takes them."""
    def to_dev(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(to_dev(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(to_dev(v) for v in x)
        return x
    args, kw = stats["mesh"]["captured"][name]
    return {"args": to_dev(args), "kw": kw}


def _clean(info: dict) -> bool:
    return not any(info["audit"].values()) and info["on_removed"] == 0 \
        and info["empty_slots"] == 0


def _mid_problem():
    """SHARDED_MID racks of 8 under one zone, primary + 1 replica on
    another rack, 5% of nodes removed, whole-number partition weights
    1-3, numpy seed 3."""
    p, n = SHARDED_MID
    rng = np.random.default_rng(3)
    prev = np.full((p, 2, 1), -1, np.int32)
    prev[:, 0, 0] = rng.integers(0, n, p)
    prev[:, 1, 0] = (prev[:, 0, 0] + 1 + rng.integers(0, n - 1, p)) % n
    valid = np.ones(n, bool)
    valid[rng.choice(n, n // 20, replace=False)] = False
    arrays = (prev, rng.integers(1, 4, p).astype(np.float32),
              np.ones(n, np.float32), valid,
              np.full((p, 2), 1.5, np.float32),
              np.stack([np.arange(n), np.arange(n) // 8,
                        np.zeros(n)]).astype(np.int32),
              np.ones((3, n), bool))
    return arrays, (1, 1), ((), ((2, 1),))


def sharded_phase(dev, prev, nodes, removed, model, opts, single: dict,
                  sp_map) -> tuple:
    """Multi-GPU sharding on the one card (the ``sharded`` line): a
    4-rank 1-D mesh, a 2x2 mesh and a 1-rank nccl mesh, each started and
    timed on its own; the north star on the 4-rank mesh (the engine
    each shard resolves, then fused) and the 2x2 mesh, the 2x2 map equal
    to a 1-D 2-rank mesh's (the 2-D contract), the 1-rank nccl mesh
    equal to the unsharded solve; the 1M sparse deployment on 4 ranks;
    the mid-size problem on both meshes and engines equal to the same
    mesh shapes on the CPU, and its K = N sparse solve equal to the
    dense one; PlannerSession(mesh=) at the north star (a warm carry
    hit equal to its cold twin, replan_with_moves() equal to replan() +
    moves()); the 240-tenant wave through solve_fleet(mesh=) and
    PlanService(mesh=), equal to the card's unmeshed wave.  Returns the
    line and the kernel entries on the inputs the sharded runs gave
    their first calls on a worker rank."""
    from blance_tpu_torch.parallel import sharded as S

    T.set_fused_score_default("auto")
    t_phase = time.perf_counter()
    checks: dict = {}
    runs: dict = {}
    meshes: dict = {}
    seen: dict = {}
    try:
        for key, make in (("1d_4", lambda: S.make_mesh(4, device=dev)),
                          ("2x2", lambda: S.make_mesh_2d(2, 2, device=dev)),
                          ("nccl_1", lambda: S.make_mesh(1, device=dev))):
            meshes[key] = make()
        meshes["1d_2"] = S.make_mesh(2, devices=meshes["1d_4"])
        startup = {k: m.startup_s for k, m in meshes.items()}
        backends = {k: m.backend for k, m in meshes.items()}
        checks["backends"] = backends == {"1d_4": "gloo", "2x2": "gloo",
                                          "nccl_1": "nccl", "1d_2": "gloo"}
        log(f"sharded meshes: start-up {startup}, backends {backends}")

        # -- the north star ------------------------------------------------
        problem, arrays, cons, rules = _dense_problem(
            prev, nodes, removed, model, opts)
        dense = S.solve_dense_sharded
        ns = {}
        ns["1d_4"], runs["north_1d_4"], _ = _sharded_run(
            "north star, 4 ranks", lambda m, **k: dense(
                m, *arrays, cons, rules, **k), meshes["1d_4"], problem)
        ns["1d_4_fused"], runs["north_1d_4_fused"], st = _sharded_run(
            "north star, 4 ranks, fused", lambda m, **k: dense(
                m, *arrays, cons, rules, fused_score="on", **k),
            meshes["1d_4"], problem, capture=1)
        seen["fused"] = _captured(st, "fused_score_min2", dev)
        seen["fused_launches"] = runs["north_1d_4_fused"]["launches"][
            "fused_score_min2"]
        ns["2x2"], runs["north_2x2"], st = _sharded_run(
            "north star, 2x2", lambda m, **k: dense(
                m, *arrays, cons, rules, **k), meshes["2x2"], problem,
            capture=3)
        seen["min2"] = _captured(st, "priced_min2_argmin", dev)
        seen["min2_launches"] = runs["north_2x2"]["launches"][
            "priced_min2_argmin"]
        seen["write"] = _captured(st, "score_write", dev)
        seen["write_launches"] = runs["north_2x2"]["launches"]["score_write"]
        del st
        ns["1d_2"], runs["north_1d_2"], _ = _sharded_run(
            "north star, 2 ranks", lambda m, **k: dense(
                m, *arrays, cons, rules, **k), meshes["1d_2"], problem)
        checks["north_audit_clean"] = all(
            _clean(runs[f"north_{k}"]) for k in ns)
        checks["north_2x2_equals_1d_2"] = bool(np.array_equal(
            ns["2x2"], ns["1d_2"]))
        checks["north_engines"] = \
            runs["north_1d_4"]["engine"] == "off" and \
            runs["north_1d_4_fused"]["engine"] == "on"
        checks["north_kernels_every_rank"] = all(
            min(runs[r]["launches"][k]) > 0 for r, k in (
                ("north_1d_4", "priced_min2_argmin"),
                ("north_1d_4_fused", "fused_score_min2"),
                ("north_2x2", "priced_min2_argmin")))
        one, runs["north_nccl_1"], _ = _sharded_run(
            "north star, 1-rank nccl", lambda m, **k: dense(
                m, *arrays, cons, rules, **k), meshes["nccl_1"], problem)
        flat_args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in arrays]
        flat, flat_s = _sync_wall(lambda: T.solve_dense_converged(
            *flat_args, cons, rules, record=False).cpu().numpy())
        runs["north_unsharded"] = dict(wall_s=flat_s)
        checks["nccl_1_equals_unsharded"] = bool(np.array_equal(one, flat))
        del flat_args, flat, one

        # -- the sparse deployment ---------------------------------------
        sp_problem, sp_arrays, sp_cons, sp_rules = _dense_problem(*sp_map)
        _, runs["sparse_1d_4"], st = _sharded_run(
            "sparse 1M, 4 ranks", lambda m, **k: S.solve_sparse_sharded(
                m, *sp_arrays, sp_cons, sp_rules, **k), meshes["1d_4"],
            sp_problem, capture=1)
        seen["sparse"] = _captured(st, "sparse_priced_min2_cand", dev)
        seen["sparse_launches"] = runs["sparse_1d_4"]["launches"][
            "sparse_priced_min2_cand"]
        del st, sp_problem, sp_arrays
        checks["sparse_audit_clean"] = _clean(runs["sparse_1d_4"]) and \
            runs["sparse_1d_4"]["k"] == 16 and min(
                runs["sparse_1d_4"]["launches"][
                    "sparse_priced_min2_cand"]) > 0

        # -- the mid-size problem: the card against the CPU ------------------
        mid, m_cons, m_rules = _mid_problem()
        with S.make_mesh(4, device="cpu") as cpu4, \
                S.make_mesh_2d(2, 2, devices=cpu4) as cpu22:
            for key, cpu_mesh in (("1d_4", cpu4), ("2x2", cpu22)):
                for eng in ("off", "on"):
                    got, runs[f"mid_{key}_{eng}"], st = _sharded_run(
                        f"{SHARDED_MID} {key} {eng}", lambda m, **k: dense(
                            m, *mid, m_cons, m_rules, fused_score=eng, **k),
                        meshes[key], capture=3 if key == "2x2" and
                        eng == "on" else None)
                    if key == "2x2" and eng == "on":
                        seen["fused_2x2"] = _captured(
                            st, "fused_score_min2", dev)
                        seen["fused_2x2_launches"] = \
                            runs[f"mid_{key}_{eng}"]["launches"][
                                "fused_score_min2"]
                    want, cpu_s = _sync_wall(lambda: dense(
                        cpu_mesh, *mid, m_cons, m_rules, fused_score=eng))
                    runs[f"mid_{key}_{eng}"]["cpu_mesh_wall_s"] = cpu_s
                    checks[f"mid_{key}_{eng}_equals_cpu"] = bool(
                        np.array_equal(got, want))
        dense_mid = dense(meshes["1d_4"], *mid, m_cons, m_rules)
        sparse_mid = S.solve_sparse_sharded(
            meshes["1d_4"], *mid, m_cons, m_rules, k=SHARDED_MID[1])
        checks["mid_sparse_k_equals_n_is_dense"] = bool(
            np.array_equal(dense_mid, sparse_mid))
        mid_flat = [torch.from_numpy(a).to(dev) for a in mid]
        _, runs["mid_unsharded_wall_s"] = _sync_wall(
            lambda: T.solve_dense_converged(*mid_flat, m_cons, m_rules,
                                            record=False).cpu())
        del mid_flat

        # -- PlannerSession(mesh=) at the north star ---------------------
        t0 = time.perf_counter()
        session = sharded_session(prev, nodes, removed, model, opts,
                                  meshes["1d_4"], dev)
        session["phase_s"] = time.perf_counter() - t0
        checks.update({f"session_{k}": v
                       for k, v in session.pop("checks").items()})

        # -- the fleet wave and the service on the mesh -------------------
        t0 = time.perf_counter()
        fleet_line = sharded_fleet(meshes["1d_4"], dev)
        fleet_line["phase_s"] = time.perf_counter() - t0
        checks.update({f"fleet_{k}": v
                       for k, v in fleet_line.pop("checks").items()})
    finally:
        for m in meshes.values():
            m.close()

    # Each kernel on the inputs its first call on a worker rank got: the
    # launches are that rank's in the run, every rank's beside them.
    t0 = time.perf_counter()
    entries = {}
    for key, kind, rank, where in (
            ("min2", "min2", 3, "the 2x2 mesh's rank 3"),
            ("fused", "fused", 1, "the 4-rank mesh's rank 1"),
            ("fused_2x2", "fused", 3, "the mid 2x2 mesh's rank 3"),
            ("sparse", "sparse", 1, "the 4-rank mesh's rank 1"),
            ("write", "write", 3, "the 2x2 mesh's rank 3")):
        per_rank = seen[f"{key}_launches"]
        entries[key] = path_kernel_entry(kind, seen[key], per_rank[rank],
                                         where)
        # (pbase, noff): the fused launch's args 2-3, the write's 1-2.
        at = {"fused": 2, "write": 1}.get(kind)
        args = seen[key]["args"]
        entries[key].update(
            rank=rank, launches_per_rank=per_rank,
            pbase=None if at is None else args[at],
            noff=None if at is None else args[at + 1])
    checks["fused_offsets_nonzero"] = seen["fused"]["args"][2] > 0 and \
        seen["fused_2x2"]["args"][2] > 0 and seen["fused_2x2"]["args"][3] > 0
    checks["write_offsets_nonzero"] = seen["write"]["args"][1] > 0 and \
        seen["write"]["args"][2] > 0
    kernels_s = time.perf_counter() - t0
    line = dict(
        note=SHARDED_NOTE, startup_s=startup, backends=backends,
        single_device=dict(
            north_matrix_solve_s=single["matrix"]["solve_s"],
            north_fused_solve_s=single["fused"]["solve_s"],
            sparse_solve_s=single["sparse"]["solve_s"],
            north_moved=single["matrix"]["partitions_moved"],
            north_spread=single["matrix"]["load_spread"]),
        runs=runs, session=session, fleet=fleet_line,
        kernels_s=kernels_s, phase_s=time.perf_counter() - t_phase,
        budget_s=SHARDED_BUDGET_S)
    checks["within_budget"] = line["phase_s"] <= SHARDED_BUDGET_S
    line["checks"] = checks
    log(f"sharded: {json.dumps(line)}")
    if not all(checks.values()):
        raise AssertionError(
            f"sharded: {[k for k, v in checks.items() if not v]}")
    return line, entries


def sharded_session(prev, nodes, removed, model, opts, mesh, dev) -> dict:
    """PlannerSession(mesh=) at the north star, two sessions in lockstep
    (one through replan() + moves(), one through replan_with_moves()):
    a cold replan after the 5% removal, then 1% of the surviving nodes
    removed (seed 17) and a warm replan, which must be a one-sweep carry
    hit on both, equal to each other and to a cold twin session's replan
    on the same mesh, audit-clean."""
    delta = session_delta(nodes, removed)
    rec = Recorder()
    out: dict = {}
    with use_recorder(rec):
        s, s_pipe = (bt.PlannerSession(model, nodes, list(prev), opts=opts,
                                       mesh=mesh) for _ in range(2))
        for x in (s, s_pipe):
            x.load_map(prev)
            x.remove_nodes(removed)
        cold = _session_replan(s, rec)
        cold_moves = s.moves()
        cold_pipe, cold_pipe_s = _sync_wall(s_pipe.replan_with_moves)
        s.apply()
        s_pipe.apply()
        base = s.current
        s.remove_nodes(delta)
        s_pipe.remove_nodes(delta)
        warm = _session_replan(s, rec)
        warm_moves = s.moves()
        before = dict(rec.counters)
        warm_pipe, warm_pipe_s = _sync_wall(s_pipe.replan_with_moves)
        pipe_counts = _plan_counts(rec.counters, before)
        twin = bt.PlannerSession(model, nodes, list(prev), opts=opts,
                                 mesh=mesh)
        twin.load_map(s.to_map("current")[0])
        twin.remove_nodes(removed + delta)
        twin_cold = _session_replan(twin, rec)
    index = {nd: i for i, nd in enumerate(s.nodes)}
    ids = [index[nd] for nd in removed + delta]
    audit = bt.check_assignment(s.problem, warm["out"])

    def same(a, b):
        return bool(np.array_equal(a[0], b[0])) and all(
            np.array_equal(x, y) for x, y in zip(a[1], b[1]))
    out["checks"] = dict(
        carry_hit=warm["counters"].get("plan.solve.carry_hit") == 1,
        warm_one_sweep=warm["counters"].get("plan.solve.sweeps") == 1,
        no_warm_fallback="plan.solve.warm_fallback" not in warm["counters"],
        warm_equals_cold_twin=bool(np.array_equal(warm["out"],
                                                  twin_cold["out"])),
        pipe_carry_hit=pipe_counts.get("plan.solve.carry_hit") == 1,
        replan_with_moves_cold=same((cold["out"], cold_moves), cold_pipe),
        replan_with_moves_warm=same((warm["out"], warm_moves), warm_pipe),
        audit_clean=not any(audit.values()),
        nothing_on_removed=not bool(np.isin(warm["out"], ids).any()))
    out.update(
        delta_nodes=len(delta), cold=_replan_info(cold, s.problem.prev),
        warm=_replan_info(warm, base), cold_twin=_replan_info(twin_cold,
                                                              base),
        replan_with_moves_s=dict(cold=cold_pipe_s, warm=warm_pipe_s),
        warm_over_cold=warm["solve_s"] / twin_cold["solve_s"])
    log(f"sharded session: {json.dumps(out)}")
    return out


def sharded_fleet(mesh, dev) -> dict:
    """The 240-tenant wave through solve_fleet(mesh=), cold and warm,
    each tenant bitwise the card's unmeshed solve_fleet; then
    PlanService(mesh=) over the wave's 240 requests, results equal to
    the meshed cold wave."""
    tenants = wave_tenants()
    (flat_cold, flat_cold_s) = _sync_wall(
        lambda: fleet.solve_fleet(tenants, device=dev))
    round2 = [delta_tenant(t, r) for t, r in zip(tenants, flat_cold)]
    (flat_warm, flat_warm_s) = _sync_wall(
        lambda: fleet.solve_fleet(round2, device=dev))
    reset_launch_counts()
    cold, cold_s = _sync_wall(lambda: fleet.solve_fleet(tenants, mesh=mesh))
    cold_stats = _mesh_stats({"mesh": dict(mesh.last_call)})
    round2m = [delta_tenant(t, r) for t, r in zip(tenants, cold)]
    warm, warm_s = _sync_wall(lambda: fleet.solve_fleet(round2m, mesh=mesh))
    rank0 = launch_counts()
    rec = Recorder()

    async def drive():
        svc = plan_service.PlanService(recorder=rec, mesh=mesh)
        await svc.start()
        res = await asyncio.gather(*[svc.submit(t) for t in tenants])
        await svc.stop()
        return res

    service, service_s = _sync_wall(lambda: asyncio.run(drive()))

    def equal(a, b):
        return all(np.array_equal(x.assign, y.assign) and x.warm == y.warm
                   for x, y in zip(a, b))
    return dict(
        tenants=len(tenants), wall_s=dict(cold=cold_s, warm=warm_s,
                                          service=service_s),
        unmeshed_wall_s=dict(cold=flat_cold_s, warm=flat_warm_s),
        warm_accepted=sum(r.warm for r in warm),
        last_cold_batch=cold_stats, rank0_launches={
            k: v for k, v in rank0.items() if v},
        service_batches=int(rec.counters["fleet.batches"]),
        checks=dict(cold_equals_unmeshed=equal(cold, flat_cold),
                    warm_equals_unmeshed=equal(warm, flat_warm),
                    service_equals_wave=equal(service, cold),
                    min2_launched=rank0.get("priced_min2_argmin", 0) > 0))


# --- the device observatory (the ``obs`` line) -------------------------------

OBS_KERNELS = {"min2.cu": ("priced_min2",),
               "score_fused.cu": ("fused_score_min2_kernel",
                                  "fused_rows_kernel")}


def _obs_plan(prev, nodes, removed, model, opts, mode: str) -> tuple:
    """One north-star plan_next_map on engine ``mode``, the launch counts
    set to 0 just before it and read just after; (wall s, map, timings,
    launches), the wall on the host clock with the device synchronised,
    ``timings`` the plan's own (``solve_s``, ``sweeps``, ...)."""
    T.set_fused_score_default(mode)
    try:
        reset_launch_counts()
        timings: dict = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, warn = bt.plan_next_map(prev, prev, nodes, removed, [], model,
                                     opts, backend="cuda", timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
    finally:
        T.set_fused_score_default("auto")
    if warn:
        raise AssertionError(f"obs plan ({mode}): {len(warn)} warnings")
    return wall, out, timings, launches


def _trace_kernels(log_dir: str) -> dict:
    """Kernel launches by source file in the torch.profiler traces that
    device_profile exported into ``log_dir``."""
    import glob
    import os

    names: collections.Counter = collections.Counter()
    for path in glob.glob(os.path.join(log_dir, "trace.*.json")):
        with open(path) as f:
            for ev in json.load(f).get("traceEvents", []):
                if ev.get("cat") == "kernel":
                    names[ev.get("name", "")] += 1
    return {src: sum(c for nm, c in names.items()
                     if any(k in nm for k in keys))
            for src, keys in OBS_KERNELS.items()}


class _GcClock:
    """A ``gc.callbacks`` hook: the seconds the cyclic collector ran and
    its full (generation-2) collections, while installed."""

    def __init__(self) -> None:
        self.s, self.full, self._t0 = 0.0, 0, 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.s += time.perf_counter() - self._t0
            self.full += info["generation"] == 2


OBS_PAIRS = 15  # off/on pairs timed after the warm-up calls


# The membudget table in a process of its own, one shape class a
# process (``sys.argv[1]``): the ``smoke`` class through the whole check
# (MEM001-MEM003), the ``north`` rows measured alone; printed as one JSON
# object.
_MEMBUDGET_CHILD = """
import json
import sys
from blance_tpu_torch.analysis import membudget
if sys.argv[1] == "north":
    rows = membudget.measure_budget_table(["north"], device="cuda")
    measured = sum(r["ok"] is not None for r in rows)
    findings = [f"MEM001 {r['entry']}@north: {r.get('error', r.get('measured'))}"
                for r in rows if r["ok"] is not True]
else:
    rows = []
    found, measured = membudget.run_membudget_check(device="cuda",
                                                    rows_out=rows)
    findings = [f.render() for f in found]
print(json.dumps(dict(rows=rows, measured=measured, findings=findings)))
"""


def _start_checks() -> dict:
    """The observatory's checks, each in a process of its own, started
    now: ``python -m blance_tpu_torch.obs.device_check --check``
    (nothing is loaded there yet, so its build counts are a cold
    process's, the ones the retrace budgets bound) and the membudget
    table, its ``smoke`` class and its ``north`` rows apart (each peak
    is the child's own allocator's, whatever else runs on the card)."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k != "BLANCE_MEMBUDGET_NORTH"}
    cmds = {"device_check": [sys.executable, "-m",
                             "blance_tpu_torch.obs.device_check", "--check"]}
    for klass in ("smoke", "north"):
        cmds[f"membudget_{klass}"] = [sys.executable, "-c",
                                      _MEMBUDGET_CHILD, klass]
    return {name: subprocess.Popen(
        cmd, cwd=here, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, cmd in cmds.items()}


def _finish_check(proc: subprocess.Popen) -> tuple:
    """Wait for one check process; (exit code, stdout, stderr)."""
    try:
        out, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    log(err.strip())
    return proc.returncode, out, err


def _device_check_result(proc: subprocess.Popen) -> dict:
    """The cold check's exit code and the build counts it printed."""
    import ast
    import re

    rc, _out, err = _finish_check(proc)
    m = re.search(r"builds by entry (\{.*?\}), added by calls 2-4 "
                  r"(\{.*?\})", err)
    return dict(rc=rc,
                builds=ast.literal_eval(m.group(1)) if m else None,
                repeated=ast.literal_eval(m.group(2)) if m else None)


def _membudget_result(proc: subprocess.Popen) -> dict:
    """The membudget child's rows, findings and measured count."""
    rc, out, _err = _finish_check(proc)
    if rc != 0:
        raise AssertionError(f"membudget check process exited {rc}")
    return json.loads(out.strip().splitlines()[-1])


def _obs_traced(prev, nodes, removed, model, opts, plain_map, checks,
                parts, t_phase) -> tuple:
    """The observatory's traced plans (see obs_phase): (plans, sweep
    fractions, kernels in the profiler's trace, the recorder, the sweeps
    of each plan)."""
    import os
    import tempfile

    from blance_tpu_torch.obs import chrome
    from blance_tpu_torch.obs import device as obs_device

    rec = Recorder()
    samples_want = []
    with tempfile.TemporaryDirectory() as tmp, use_recorder(rec), \
            warnings.catch_warnings():
        # The profiler's own notices are not engine fallbacks.
        warnings.filterwarnings("ignore", module=r"torch\.")
        log_dir = os.path.join(tmp, "device")
        trace_path = os.path.join(tmp, "obs_trace.json")
        obs_device.enable()
        obs_device.reset_cost_cache()
        try:
            with chrome.trace(trace_path, recorder=rec,
                              device_log_dir=log_dir) as sink:
                plans = {}
                for mode, kernel in (("auto", "priced_min2_argmin"),
                                     ("on", "fused_score_min2")):
                    wall, out, timings, launches = _obs_plan(
                        prev, nodes, removed, model, opts, mode)
                    name = _ENGINES["off" if mode == "auto" else mode]
                    checks[f"{name}_map_equal"] = _same_map(out, plain_map)
                    checks[f"{name}_launched"] = launches[kernel] > 0
                    plans[name] = dict(wall_s=wall,
                                       sweeps=int(timings["sweeps"]),
                                       launches=launches[kernel])
                    samples_want.append(int(timings["sweeps"]))
                    del out
            fracs = [v for _, nm, v in sorted(sink._counter_samples)
                     if nm == "device.sweep_accept_frac"]
        finally:
            obs_device.disable()
        parts["traced_s"] = time.perf_counter() - t_phase
        t0 = time.perf_counter()
        kernels_in_trace = _trace_kernels(log_dir)
        parts["trace_read_s"] = time.perf_counter() - t0

    return plans, fracs, kernels_in_trace, rec, samples_want


def obs_phase(dev, prev, nodes, removed, model, opts, plain_map) -> dict:
    """The device observatory around the main path (the ``obs`` line).

    First the checks start, each in a process of its own
    (``_start_checks``): ``device_check --check`` in a cold process, its
    build counts bound by the retrace budgets, and the membudget table,
    the ``smoke`` class (MEM001 on the card) and the ``north`` rows, each
    peak beside its budget and the dense guard's projected P*N*20 B.

    Beside them, with ``obs.device.enable()``, a fresh Recorder and
    ``chrome.trace`` with a torch.profiler log dir: the north-star plan
    on the matrix engine and on the in-kernel score engine (the
    observatory's first calls), each map bitwise the plain map and each
    launching its engine's kernel; a sweep-trace sample per sweep, the
    last 0.0 when the plan converged; the cold solve's peak allocation
    published once, above 0 and below the card's memory; the profiler's
    trace holding both kernels' launches; the recorder's exposition
    parsing with nothing undeclared.

    Then, the checks finished, the plan's wall time with the observatory
    off and on (matrix engine): one warm-up call after the profiler's
    exit, then ``OBS_PAIRS`` pairs, alternating which side goes first;
    the medians and the spread of each side, of the wall and of the
    plan's own solve stage (the only stage the observatory touches), and
    the collector's pauses and full collections inside each call (none:
    the collector is off inside each timed call and runs between them).
    The objects alive before are frozen out of the collector's passes
    (the script holds several maps of P partitions), so a full
    collection of them lands in no timed call.  Since the score write
    the solve stage is ~35 ms of host-bound launches and syncs, which
    vary ~15% call to call, hence the 15 pairs and the collector kept
    out of the calls: 5% of it is ~2 ms.  The observatory passes when its solve
    stage's on median is within 5% of the off median, and the walls' on
    median exceeds the off median by no more than the wider side's
    spread (the host stages around the solve vary call to call)."""
    from blance_tpu_torch.analysis import membudget
    from blance_tpu_torch.obs import (default_registry, parse_prometheus,
                                      render_prometheus)
    from blance_tpu_torch.obs import device as obs_device

    t_phase = time.perf_counter()
    parts: dict = {}
    checks: dict = {}
    max_iter = opts.max_iterations
    children = _start_checks()
    try:
        plans, fracs, kernels_in_trace, rec, samples_want = _obs_traced(
            prev, nodes, removed, model, opts, plain_map, checks, parts,
            t_phase)
        t0 = time.perf_counter()
        device_check = _device_check_result(children["device_check"])
        budgets = [_membudget_result(children[f"membudget_{klass}"])
                   for klass in ("smoke", "north")]
        parts["checks_wait_s"] = time.perf_counter() - t0
    finally:
        for proc in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()

    checks["device_check"] = device_check["rc"] == 0
    # A cold process loads the libraries it calls: a count of 0 would
    # mean the budgets were not exercised.
    checks["device_check_cold"] = bool(device_check["builds"])
    rows = [row for b in budgets for row in b["rows"]]
    budget_findings = [f for b in budgets for f in b["findings"]]
    for row in rows:
        d = membudget.SHAPE_CLASSES[row["class"]]
        row["projected_pn20"] = d.P * d.N * 20
        log(f"membudget {row['entry']} @ {row['class']}: peak "
            f"{row.get('measured', row.get('error'))} B, budget "
            f"{row['budget']} B, P*N*20 {row['projected_pn20']} B")
    checks["membudget_clean"] = not budget_findings and \
        sum(b["measured"] for b in budgets) == len(rows) and \
        {r["class"] for r in rows} == set(membudget.SHAPE_CLASSES)

    t0 = time.perf_counter()
    clock = _GcClock()
    timed_calls: list = []
    calls = {"off": 0, "on": 0}

    def timed(state: str) -> dict:
        if state == "on":
            obs_device.enable()
        gc.disable()  # the collector runs between the timed calls
        try:
            s0, f0 = clock.s, clock.full
            wall, out, timings, _launches = _obs_plan(
                prev, nodes, removed, model, opts, "auto")
            pause, full = clock.s - s0, clock.full - f0
        finally:
            gc.enable()
            obs_device.disable()
        calls[state] += 1
        checks[f"{state}_call{calls[state]}_map_equal"] = _same_map(
            out, plain_map)
        if state == "on":
            samples_want.append(int(timings["sweeps"]))
        return dict(state=state, wall_s=wall, **{
            k: timings[k] for k in ("encode_s", "solve_s", "decode_s",
                                    "audit_s") if k in timings},
            gc_s=pause, gc_full=full)

    gc.collect()
    gc.freeze()
    gc.callbacks.append(clock)
    try:
        with use_recorder(rec):
            warm_up = timed("off")
            for i in range(OBS_PAIRS):
                for state in (("off", "on") if i % 2 == 0
                              else ("on", "off")):
                    timed_calls.append(timed(state))
    finally:
        gc.callbacks.remove(clock)
        gc.unfreeze()
    parts["timing_s"] = time.perf_counter() - t0

    checks["one_sample_per_sweep"] = len(fracs) == sum(samples_want[:2]) \
        and rec.histogram_summary("device.sweep_accept_frac")["count"] == \
        sum(samples_want)
    ends = np.cumsum(samples_want[:2]) - 1
    checks["converged_last_sample_zero"] = \
        checks["one_sample_per_sweep"] and all(
            fracs[e] == 0.0 for e, n in zip(ends, samples_want)
            if n < max_iter)
    key = 'device.peak_alloc_bytes{entry="solve_dense.cold",' \
          f'klass="{P_MAIN}x{N_MAIN}"}}'
    peak = rec.gauges.get(key, 0.0)
    total_mem = torch.cuda.get_device_properties(dev).total_memory
    summaries = obs_device.cost_summaries()
    checks["peak_published_once"] = key in rec.gauges and \
        rec.counters.get("device.cost_analyses") == sum(
            len(v) for v in summaries.values())
    checks["peak_in_range"] = 0 < peak < total_mem
    checks["trace_holds_kernels"] = all(kernels_in_trace.values())
    samples, _types = parse_prometheus(render_prometheus(rec))
    undeclared = default_registry().undeclared(rec)
    checks["exposition_parses_all_declared"] = bool(samples) and \
        not undeclared
    side = {st: {k: [c[k] for c in timed_calls if c["state"] == st]
                 for k in ("wall_s", "solve_s")} for st in ("off", "on")}
    median = {st: {k: statistics.median(v) for k, v in d.items()}
              for st, d in side.items()}
    spread = {st: {k: [min(v), max(v)] for k, v in d.items()}
              for st, d in side.items()}
    off, on = median["off"]["wall_s"], median["on"]["wall_s"]
    checks["wall_overhead_in_noise"] = on - off <= max(
        hi - lo for lo, hi in (spread["off"]["wall_s"],
                               spread["on"]["wall_s"]))
    checks["solve_overhead_under_5pct"] = \
        median["on"]["solve_s"] <= 1.05 * median["off"]["solve_s"]
    line = dict(
        checks=checks, timed_calls=timed_calls, warm_up=warm_up,
        median_s=median, spread_s=spread, overhead=on / off - 1.0,
        solve_overhead=median["on"]["solve_s"]
        / median["off"]["solve_s"] - 1.0, plans=plans,
        sweep_fracs=fracs, peak_alloc_bytes=peak, card_bytes=total_mem,
        cost=summaries.get("solve_dense.cold"),
        trace_kernel_launches=kernels_in_trace, undeclared=undeclared,
        device_check=device_check, membudget=rows,
        membudget_findings=budget_findings, parts_s=parts,
        phase_s=time.perf_counter() - t_phase)
    log(f"obs: {json.dumps(line)}")
    if not all(checks.values()):
        raise AssertionError(f"obs phase: failed checks "
                             f"{[k for k, v in checks.items() if not v]}")
    return line


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; needs one GPU")
        return 2
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build_logs = _build.build_all()
    build_s = time.perf_counter() - t0
    for name, text in build_logs.items():
        log(f"--- nvcc {name}.cu\n{text.strip()}")
    log(f"kernels built in {build_s:.1f} s")
    t0 = time.perf_counter()
    if not marshal.available():
        raise AssertionError("the native marshal extension did not build or "
                             "load (gcc and the Python headers are needed)")
    marshal_build_s = time.perf_counter() - t0
    log(f"native marshal extension loaded in {marshal_build_s:.1f} s: "
        f"{marshal.get().__file__}")

    min2 = check_min2(dev)
    fused = check_fused(dev)
    write = check_score_write(dev)
    sparse = check_sparse_min2(dev)
    t0 = time.perf_counter()
    narrow, narrow_kernels = narrow_phase(dev)
    narrow["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    warnings.simplefilter("error")  # an engine fallback must not hide
    small_map_matches_cpu(dev)
    prev, nodes, removed, model, opts = north_star_map()
    T.set_fused_score_default("auto")
    auto, plain_map = run_main_path("main path, auto engine", prev, nodes,
                                    removed, model, opts)
    if auto["engine"] != "matrix" or auto["launches"]["priced_min2_argmin"] < 1 \
            or auto["launches"]["score_write"] < 1:
        raise AssertionError(f"auto run: engine {auto['engine']}, launches "
                             f"{auto['launches']}")
    ns_opts = dataclasses.replace(opts)  # the auto run's options
    T.set_fused_score_default("on")
    opts.sparse = False
    on, _ = run_main_path("main path, fused engine", prev, nodes, removed,
                          model, opts)
    T.set_fused_score_default("auto")
    if on["engine"] != "fused" or on["launches"]["fused_score_min2"] < 1 \
            or fused["timed_instantiation"] not in \
            on["variants"]["fused_score_min2"]:
        raise AssertionError(f"fused run: engine {on['engine']}, launches "
                             f"{on['variants']}")

    obs = obs_phase(dev, prev, nodes, removed, model, ns_opts, plain_map)
    torch.cuda.empty_cache()

    diff = diff_matches_host(prev, plain_map, model, dev)
    rebalance = rebalance_main_path(prev, nodes, removed, model, ns_opts,
                                    plain_map, diff)
    rebalance["small_card_equals_cpu"] = small_rebalance_matches_cpu(dev)
    rebalance["diff"] = diff

    parts: dict = {}
    t0 = time.perf_counter()
    pipeline = {"native_marshal": marshal.available(),
                "marshal_build_s": marshal_build_s,
                "marshal": marshal_parity(prev, nodes, removed, model,
                                          ns_opts, plain_map)}
    parts["marshal"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    T.set_fused_score_default("auto")
    pipeline["north_star"] = {"matrix": pipeline_vs_staged(
        "north star, matrix", prev, nodes, removed, model, ns_opts,
        "priced_min2_argmin", plain=plain_map, favors=(False, True))}
    fused_opts = dataclasses.replace(ns_opts, fused_pipeline=True)
    checked = bt.plan_next_map(prev, prev, nodes, removed, [], model,
                               fused_opts, backend="cuda")
    if not _same_map(checked[0], plain_map) or checked[1]:
        raise AssertionError("plan_next_map(fused_pipeline=True) differs "
                             "from the staged map")
    pipeline["north_star"]["plan_next_map_fused_pipeline_equal"] = True
    del checked
    parts["matrix"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    T.set_fused_score_default("on")
    try:
        pipeline["north_star"]["fused"] = pipeline_vs_staged(
            "north star, fused", prev, nodes, removed, model, ns_opts,
            "fused_score_min2", timed_variant=fused["timed_instantiation"],
            plain=plain_map)
    finally:
        T.set_fused_score_default("auto")
    parts["fused"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipeline["sessions"] = {
        _ENGINES[m if m != "auto" else "off"]: session_pipeline_twin(
            prev, nodes, removed, model, ns_opts, dev, m)
        for m in ("auto", "on")}
    parts["sessions"] = time.perf_counter() - t0
    del plain_map
    t0 = time.perf_counter()
    session = {"north_star": {
        "matrix": session_north_star(prev, nodes, removed, model, ns_opts,
                                     dev, "auto"),
        "fused": session_north_star(prev, nodes, removed, model, ns_opts,
                                    dev, "on", fused["timed_instantiation"])}}
    session_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    sp_map = north_star_map(P_SPARSE)
    log(f"sparse deployment map built in {time.perf_counter() - t0:.1f} s")
    parity, sp_state = sparse_engine_matches_cpu(*sp_map, dev)
    t1 = time.perf_counter()
    session["sparse"] = session_sparse(sp_state, dev)
    session["small_card_equals_cpu"] = small_session_matches_cpu(dev)
    session["phase_s"] = session_s + time.perf_counter() - t1
    del sp_state
    sp, sp_out = run_main_path("main path, sparse engine (1M x 10k)",
                               *sp_map)
    sp["card_vs_cpu"] = parity
    sp_variants = sp["variants"]["sparse_priced_min2_cand"]
    if sp["engine"] != "sparse" or \
            sp["launches"]["sparse_priced_min2_cand"] < 1 or \
            set(sp_variants) != {sparse["timed_instantiation"]}:
        raise AssertionError(f"sparse run: engine {sp['engine']}, launches "
                             f"{sp['variants']}")
    t0 = time.perf_counter()
    (sp_prev, sp_nodes, sp_removed, sp_model, sp_opts) = sp_map
    pipeline["sparse"] = pipeline_vs_staged(
        "sparse 1M x 10k", sp_prev, sp_nodes, sp_removed, sp_model, sp_opts,
        "sparse_priced_min2_cand", plain=sp_out)["availability"]
    sp_pipe = pipeline["sparse"]
    if sp_pipe["engine"] != "sparse" or set(
            sp_pipe["variants"]["sparse_priced_min2_cand"]) != \
            {sparse["timed_instantiation"]}:
        raise AssertionError(f"sparse pipeline: engine {sp_pipe['engine']}, "
                             f"variants {sp_pipe['variants']}")
    del sp_out
    parts["sparse"] = time.perf_counter() - t0
    pipeline.update(parts_s=parts, phase_s=sum(parts.values()))

    t0 = time.perf_counter()
    exact = exact_phase()
    exact["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bucketed, padded = bucketed_phase(
        dev, prev, nodes, removed, model, ns_opts,
        {"matrix": auto, "fused": on}, sp_map, fused["timed_instantiation"])
    bucketed["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fleet_line, fleet_kernels = fleet_phase(dev)
    fleet_line["phase_s"] = time.perf_counter() - t0
    harness, harness_kernels = harness_phase(dev)
    analysis, analysis_kernels = analysis_phase(dev)
    sharded, sharded_kernels = sharded_phase(
        dev, prev, nodes, removed, model, ns_opts,
        {"matrix": auto, "fused": on, "sparse": sp}, sp_map)

    kernels = [
        dict(name="priced_min2_argmin", route="cuda",
             source="blance_tpu_torch/ops/csrc/min2.cu",
             replaces="blance_tpu/ops/reduce2.py:115",
             launches=auto["launches"]["priced_min2_argmin"],
             instantiations=auto["variants"]["priced_min2_argmin"],
             bitwise=True, **min2),
        dict(name="fused_score_min2", route="cuda",
             source="blance_tpu_torch/ops/csrc/score_fused.cu",
             replaces="blance_tpu/ops/score_fused.py:254",
             launches=on["launches"]["fused_score_min2"],
             instantiations=on["variants"]["fused_score_min2"],
             bitwise=True, **fused),
        dict(name="sparse_priced_min2", route="cuda",
             source="blance_tpu_torch/ops/csrc/sparse_min2.cu",
             replaces="blance_tpu/ops/sparse2.py:130",
             wrapper="sparse_priced_min2_cand",
             launches=sp["launches"]["sparse_priced_min2_cand"],
             instantiations=sp_variants, bitwise=True, **sparse),
    ]
    # The same kernels at the bucketed path's padded shapes, on the inputs
    # the bucketed runs gave their first calls.
    for entry, key in zip(list(kernels), ("min2", "fused", "sparse")):
        kernels.append(dict(
            name=entry["name"], route="cuda", source=entry["source"],
            replaces=entry["replaces"], path="bucketed", bitwise=True,
            **padded[key]))
    # The batched launches of the fleet tier, on the inputs of their first
    # fleet calls (the in-kernel score's at the bench tenants' class and
    # at the wave's).
    for entry, key in zip([kernels[0], kernels[1], kernels[1]],
                          ("min2", "fused", "fused_wave")):
        kernels.append(dict(
            name=entry["name"], route="cuda", source=entry["source"],
            replaces=entry["replaces"], path="fleet", bitwise=True,
            **fleet_kernels[key]))
    # The unbatched narrow layouts on the small plan's path, on the inputs
    # of its first calls; launches: that path's own runs.
    for entry, key in zip(kernels[:2], ("min2", "fused")):
        kernels.append(dict(
            name=entry["name"], route="cuda", source=entry["source"],
            replaces=entry["replaces"], path="small", bitwise=True,
            **narrow_kernels[key]))
    # The min2 kernel on the harness's path, on the inputs of its first
    # unbatched call (the closed loop on the card's planner) and of its
    # first batched call (the fleet simulator); launches: the phase's own.
    for key in ("flat", "batched"):
        kernels.append(dict(
            name=kernels[0]["name"], route="cuda",
            source=kernels[0]["source"], replaces=kernels[0]["replaces"],
            path="harness", call=key, bitwise=True, **harness_kernels[key]))
    # The analysis gate's shape audit: min2 on the inputs of its first
    # unbatched and batched calls, the sparse kernel on its first call;
    # launches: the gate's own run.
    for entry, key in zip((kernels[0], kernels[0], kernels[2]),
                          ("flat", "batched", "sparse")):
        kernels.append(dict(
            name=entry["name"], route="cuda", source=entry["source"],
            replaces=entry["replaces"], path="analysis", call=key,
            bitwise=True, **analysis_kernels[key]))
    # The sharded path: min2 on the 2x2 north star's rank 3 (its
    # [P/2, N/2] block), the in-kernel score on the 4-rank north star's
    # rank 1 (pbase != 0) and the mid 2x2's rank 3 (pbase and noff != 0),
    # the sparse kernel on the 1M deployment's rank 1; launches: that
    # rank's in the phase's run.
    for entry, key in zip((kernels[0], kernels[1], kernels[1], kernels[2]),
                          ("min2", "fused", "fused_2x2", "sparse")):
        kernels.append(dict(
            name=entry["name"], route="cuda", source=entry["source"],
            replaces=entry["replaces"], path="sharded", call=key,
            bitwise=True, **sharded_kernels[key]))
    # The score write, which replaces no TPU kernel: the matrix engine's
    # score, written for min2 on the main path's run; then on the inputs
    # of its first call on each other path that writes it, with that
    # path's own launches.
    write_entry = dict(
        name="score_write", route="cuda",
        source="blance_tpu_torch/ops/csrc/score_write.cu", replaces=None)
    kernels.append(dict(
        write_entry, launches=auto["launches"]["score_write"],
        instantiations=auto["variants"]["score_write"], bitwise=True,
        **write))
    for path, call, entry in (
            ("small", None, narrow_kernels["write"]),
            ("bucketed", None, padded["write"]),
            ("fleet", "batched", fleet_kernels["write"]),
            ("harness", "flat", harness_kernels["write_flat"]),
            ("harness", "batched", harness_kernels["write_batched"]),
            ("analysis", "flat", analysis_kernels["write_flat"]),
            ("analysis", "batched", analysis_kernels["write_batched"]),
            ("sharded", "write", sharded_kernels["write"])):
        kernels.append(dict(write_entry, path=path, bitwise=True,
                            **({} if call is None else {"call": call}),
                            **entry))
    prof = [profile_main_path(m, prev, nodes, removed, model, opts)
            for m in ("off", "on")]
    prof.append(profile_main_path("auto", *sp_map))
    print(json.dumps({"profile": prof}))
    print(json.dumps({"build_s": build_s, "main_path": {
        "matrix": auto, "fused": on, "sparse": sp}}))
    print(json.dumps({"wall_s": time.perf_counter() - t_start}))
    print(json.dumps({"rebalance": rebalance}))
    print(json.dumps({"session": session}))
    print(json.dumps({"pipeline": pipeline}))
    print(json.dumps({"exact": exact}))
    print(json.dumps({"bucketed": bucketed}))
    print(json.dumps({"fleet": fleet_line}))
    print(json.dumps({"narrow": narrow}))
    print(json.dumps({"obs": obs}))
    print(json.dumps({"harness": harness}))
    print(json.dumps({"analysis": analysis}))
    print(json.dumps({"sharded": sharded}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
