# Port of blance_tpu/analysis/membudget.py: the same table, classes and
# rules, with ceilings measured on the card (a real dispatch per row, read
# from device.peak_alloc_bytes) in place of XLA's AOT memory analysis.
"""HBM budgets: the device-memory contract as a declarative table.

The dense-memory guard (``plan/tensor.check_dense_memory``) rejects a
solve whose projected score matrix cannot fit the card — but it models
only the ONE dominant [P, N] allocation, and nothing bounds what a
dispatch actually allocates end to end (the fused pipeline's diff and
pack, the fleet's stacked [B, ...] batches).  ``HBM_BUDGETS`` declares,
for every solver dispatch entry (the ``obs/device.entry`` labels), the
most device memory that dispatch may take at each declared shape class.

Rules:

- MEM001 — an entry's measured peak exceeds its budget.  Each row's
  builder makes its problem with numpy from a seed and runs the entry's
  dispatch for real on the card under the observatory's cost
  measurement; the peak is ``device.peak_alloc_bytes`` (the caching
  allocator's peak above what it held before the dispatch, plus the
  dispatch's operands on the card).  Without a card MEM001 is NOT RUN,
  and the check says so (it does not pass).
- MEM002 — table drift: a measurable entry with no budget row, a budget
  row with no builder, a row naming an unknown class, or a row for a
  mesh-exempt entry.  Host-only.
- MEM003 — a dense row the dense-memory guard would already reject at
  that class's (P, N): dead, and letting it exist would let the two
  ceilings drift apart.  Host-only, judged against the memory of the
  card the table is calibrated for (``CALIBRATION_CARD_BYTES``), not the
  machine running the check, so every machine gives one verdict.

Shape classes: ``smoke`` (512 x 2 x 64) in every check; ``north`` (the
north star, 100k x 10k) opt-in via ``BLANCE_MEMBUDGET_NORTH=1``, for the
dense and sparse cold entries.  On the 80 GB card the guard admits the
matrix engine at the north star (P·N·20 B = 20 GB projected, under 60%
of 80 GB), so this table's ``north`` class carries a dense row
(``solve_dense.cold``), which the reference's 16 GiB table could not.
The reference's ``north`` rows for ``sparse.carry`` / ``sparse.warm`` /
``sparse.pipeline`` are left out, to keep the card check short; they
measured 54 434 800 / 50 662 544 / 54 925 680 B there, as linear in P as
``sparse.cold``.

Budgets are ceilings: the peak measured on an NVIDIA H100 80GB HBM3 with
~25% headroom.  Recalibrate after an intentional change with
``BLANCE_MEMBUDGET_CALIBRATE=1 BLANCE_MEMBUDGET_NORTH=1 python -c "from
blance_tpu_torch.analysis.membudget import run_membudget_check as r;
r(device='cuda')"`` on the card, which prints the measured-vs-budget
table, then update the rows.

The sharded entries are exempt (``MESH_EXEMPT``): their per-device peak
scales with the mesh, and the mesh is ROADMAP A.9.
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING, Any, Callable, NamedTuple, Optional

if TYPE_CHECKING:  # annotation-only
    from . import Finding

__all__ = [
    "HBM_BUDGETS",
    "SHAPE_CLASSES",
    "MESH_EXEMPT",
    "CALIBRATION_CARD_BYTES",
    "Dims",
    "run_membudget_check",
    "measure_budget_table",
]

_PATH = "blance_tpu_torch/analysis/membudget.py"


class Dims(NamedTuple):
    """One shape class (the reference's shape_audit.Dims)."""

    P: int
    S: int
    N: int
    R: int
    L: int = 1  # hierarchy levels (gids rows)

    @property
    def constraints(self) -> tuple[int, ...]:
        # Full-depth slots for every state; max(constraints) == R.
        return (self.R,) * self.S

    @property
    def rules(self) -> tuple[tuple[tuple[int, int], ...], ...]:
        # One (include, exclude) rule on the last state when there is
        # more than one hierarchy level, else rule-free.
        if self.L < 2 or self.S < 2:
            return ((),) * self.S
        return ((),) * (self.S - 1) + (((1, 0),),)


# -- shape classes -----------------------------------------------------------

SHAPE_CLASSES: dict[str, Dims] = {
    "smoke": Dims(P=512, S=2, N=64, R=2, L=2),
    "north": Dims(P=100_000, S=2, N=10_000, R=2, L=2),
}

_NORTH_ENV = "BLANCE_MEMBUDGET_NORTH"
_CALIBRATE_ENV = "BLANCE_MEMBUDGET_CALIBRATE"


def _classes_to_run() -> list[str]:
    out = ["smoke"]
    if os.environ.get(_NORTH_ENV):
        out.append("north")
    return out


# -- builders ----------------------------------------------------------------

_FLEET_B = 4  # batch width of the fleet rows


def _sparse_k(d: Dims) -> int:
    """A K < N candidate width for the sparse rows."""
    return max(1, min(d.N - 1, d.R + 2))


def _bucketed(d: Dims) -> Dims:
    from ..core.encode import bucket_size

    return d._replace(P=bucket_size(d.P), N=bucket_size(d.N))


def _arrays(d: Dims, seed: int = 0):
    """The seven solver arrays at ``d``, numpy from ``seed``: each
    partition's S*R copies on distinct nodes, unit weights, stickiness
    1.5, racks of 25 nodes as the second hierarchy level."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = rng.integers(0, d.N, d.P)
    step = max(d.N // (d.S * d.R), 1)
    prev = np.stack([(base + j * step) % d.N for j in range(d.S * d.R)],
                    axis=1).reshape(d.P, d.S, d.R).astype(np.int32)
    nodes = np.arange(d.N, dtype=np.int32)
    gids = np.stack([nodes, nodes // 25, np.zeros(d.N, np.int32)])[:d.L]
    return (prev, np.ones(d.P, np.float32), np.ones(d.N, np.float32),
            np.ones(d.N, bool), np.full((d.P, d.S), 1.5, np.float32),
            gids, np.ones((d.L, d.N), bool))


# A builder returns (klass, fn, args, kwargs): the entry's dispatch at
# one class, its operands already on ``device``.
_Builder = Callable[[Dims, Any], "tuple[str, Callable, tuple, dict]"]


def _dense(carry: bool = False, bucketed: bool = False) -> _Builder:
    def build(d: Dims, device):
        import torch

        from ..convert import problem_to_torch
        from ..plan.tensor import _solve_dense_converged_impl, \
            carry_from_assignment

        db = _bucketed(d) if bucketed else d
        args = problem_to_torch(*_arrays(db), device=device)
        kw: dict = {"constraints": db.constraints, "rules": db.rules,
                    "max_iterations": 4, "fused_score": "off"}
        if carry:
            kw["carry_used"] = carry_from_assignment(
                args[0], args[1], args[2]).used
        if bucketed:
            kw["p_real"] = torch.tensor(float(d.P), device=device)
        return f"{db.P}x{db.N}", _solve_dense_converged_impl, args, kw
    return build


def _dirty_carry(d: Dims, args, device) -> tuple:
    """A dirty mask over the first 1% of rows and the carry table of
    ``args``'s own assignment: a warm delta's operands."""
    import torch

    from ..plan.tensor import carry_from_assignment

    dirty = torch.zeros(d.P, dtype=torch.bool, device=device)
    dirty[:max(d.P // 100, 1)] = True
    return dirty, carry_from_assignment(args[0], args[1], args[2]).used


def _dense_warm(d: Dims, device):
    from ..convert import problem_to_torch
    from ..plan.tensor import _warm_repair

    args = problem_to_torch(*_arrays(d), device=device)
    return f"{d.P}x{d.N}", _warm_repair, (*args, *_dirty_carry(
        d, args, device)), {"constraints": d.constraints, "rules": d.rules,
                            "fused_score": "off"}


def _shortlist(d: Dims, args):
    from ..core.shortlist import build_shortlist_core

    return build_shortlist_core(args[0], args[1], args[2], args[3], args[5],
                                args[6], d.constraints, d.rules,
                                _sparse_k(d))


def _sparse_cold(carry: bool = False) -> _Builder:
    def build(d: Dims, device):
        from ..convert import problem_to_torch
        from ..plan.tensor import _solve_sparse_converged_impl, \
            carry_from_assignment

        args = problem_to_torch(*_arrays(d), device=device)
        used = carry_from_assignment(args[0], args[1], args[2]).used \
            if carry else None
        return (f"{d.P}x{d.N}", _solve_sparse_converged_impl,
                (*args, _shortlist(d, args), d.constraints, d.rules, 4,
                 used), {})
    return build


def _sparse_warm(d: Dims, device):
    from ..convert import problem_to_torch
    from ..plan.tensor import _warm_repair_sparse

    args = problem_to_torch(*_arrays(d), device=device)
    return (f"{d.P}x{d.N}", _warm_repair_sparse,
            (*args, _shortlist(d, args), *_dirty_carry(d, args, device),
             d.constraints, d.rules), {})


def _sparse_pipeline(d: Dims, device):
    from ..convert import problem_to_torch
    from ..plan.tensor import _pipeline_sparse_cold_impl

    return (f"{d.P}x{d.N}", _pipeline_sparse_cold_impl,
            problem_to_torch(*_arrays(d), device=device),
            {"constraints": d.constraints, "rules": d.rules,
             "max_iterations": 4, "shortlist_k": _sparse_k(d),
             "favor_min_nodes": False})


def _pipeline_cold(d: Dims, device):
    from ..convert import problem_to_torch
    from ..plan.tensor import _pipeline_cold_impl

    return (f"{d.P}x{d.N}", _pipeline_cold_impl,
            problem_to_torch(*_arrays(d), device=device),
            {"constraints": d.constraints, "rules": d.rules,
             "max_iterations": 4, "fused_score": "off",
             "favor_min_nodes": False})


def _pipeline_warm(d: Dims, device):
    from ..convert import problem_to_torch
    from ..plan.tensor import _pipeline_warm_impl

    args = problem_to_torch(*_arrays(d), device=device)
    return (f"{d.P}x{d.N}", _pipeline_warm_impl,
            (*args, *_dirty_carry(d, args, device)),
            {"constraints": d.constraints, "rules": d.rules,
             "fused_score": "off", "favor_min_nodes": False})


def _fleet(warm: bool) -> _Builder:
    def build(d: Dims, device):
        import numpy as np
        import torch

        from ..plan.fleet import _fleet_cold_batch, _fleet_warm_batch
        from ..plan.tensor import carry_from_assignment

        db = _bucketed(d)
        arrs = [_arrays(db, seed=i) for i in range(_FLEET_B)]
        stacked = [torch.from_numpy(np.stack(a)).to(device)
                   for a in zip(*arrs)]
        extra = []
        if warm:
            dirty = torch.zeros(_FLEET_B, db.P, dtype=torch.bool,
                                device=device)
            dirty[:, :max(db.P // 100, 1)] = True
            used = torch.stack([carry_from_assignment(
                stacked[0][b], stacked[1][b], stacked[2][b]).used
                for b in range(_FLEET_B)])
            extra = [dirty, used]
        p_real = torch.full((_FLEET_B,), float(d.P), device=device)
        kw: dict = {"constraints": db.constraints, "rules": db.rules,
                    "fused_score": "off"}
        if not warm:
            kw["max_iterations"] = 4
        return (f"{db.P}x{db.N}xB{_FLEET_B}",
                _fleet_warm_batch if warm else _fleet_cold_batch,
                (*stacked, *extra, p_real), kw)
    return build


def _sched_ranks(d: Dims, device):
    import numpy as np
    import torch

    from ..orchestrate.sched.ranks import rank_levels

    costs = np.random.default_rng(0).random((d.P, 4)).astype(np.float32)
    return (f"{d.P}x4", rank_levels,
            (torch.from_numpy(costs).to(device),), {})


def _builders() -> dict[str, _Builder]:
    # Keys are the live ``obs/device.entry`` labels of the dispatch
    # sites; each builder runs the function that site dispatches.
    return {
        "solve_dense.cold": _dense(),
        "solve_dense.carry": _dense(carry=True),
        "solve_dense.bucketed": _dense(bucketed=True),
        "solve_dense.warm": _dense_warm,
        "sparse.cold": _sparse_cold(),
        "sparse.carry": _sparse_cold(carry=True),
        "sparse.warm": _sparse_warm,
        "sparse.pipeline": _sparse_pipeline,
        "pipeline.cold": _pipeline_cold,
        "pipeline.warm": _pipeline_warm,
        "fleet.cold": _fleet(warm=False),
        "fleet.warm": _fleet(warm=True),
        "sched.ranks": _sched_ranks,
    }


# Entries whose peak scales with the constructed mesh (ROADMAP A.9): a
# budget row for one of these is MEM002 table drift.
MESH_EXEMPT: frozenset[str] = frozenset({
    "sharded.cold",
    "sharded.warm",
    "sharded.pipeline",
    "sparse.sharded.cold",
    "sparse.sharded.warm",
})

# Entries whose dispatch builds the dense [P, N] score matrix: MEM003
# cross-checks their rows against the dense-memory guard's projection.
_DENSE_ENTRIES: frozenset[str] = frozenset({
    "solve_dense.cold",
    "solve_dense.carry",
    "solve_dense.bucketed",
    "solve_dense.warm",
    "pipeline.cold",
    "pipeline.warm",
    "fleet.cold",
    "fleet.warm",
})

# The memory of the card this table is calibrated for, NVIDIA H100 80GB
# HBM3 as torch.cuda.get_device_properties reports it, FIXED here so the
# MEM003 verdict cannot vary with the machine running the check (the
# runtime guard keeps its live device query); the guard budgets
# plan/tensor._HBM_BUDGET_FRACTION of it.
CALIBRATION_CARD_BYTES = 85_031_714_816


def _dense_guard_ref_bytes() -> int:
    from ..plan.tensor import _HBM_BUDGET_FRACTION

    return int(_HBM_BUDGET_FRACTION * CALIBRATION_CARD_BYTES)


# -- the table ---------------------------------------------------------------

# entry -> class -> peak ceiling in bytes: the peak measured on an
# NVIDIA H100 80GB HBM3 (700 W) in a fresh process (noted inline) with
# ~25% headroom.  At smoke the allocator's peak is dominated by the
# eager build of each slot's score (a few dozen [P, N] temporaries of
# 128 KB); at the north star the matrix engine peaks at 5.19 GB, a
# quarter of the guard's P·N·20 B model (20 GB), and the sparse
# entries stay linear in P (~54 MB).
HBM_BUDGETS: dict[str, dict[str, int]] = {
    # Dense converged fixpoint: 2 518 976 B at smoke; 5 191 569 264 B
    # at the north star (R = 2: four slots, one [P, N] build at a time).
    "solve_dense.cold": {"smoke": 3_150_000, "north": 6_490_000_000},
    "solve_dense.carry": {"smoke": 3_150_000},  # 2 519 488 B measured
    # Padded to its bucket with the p_real scalar: 2 518 980 B measured.
    "solve_dense.bucketed": {"smoke": 3_150_000},
    # One-sweep repair: 2 502 592 B measured.
    "solve_dense.warm": {"smoke": 3_130_000},
    # Sparse shortlist fixpoint: [P, K] gathers, no [P, N] matrix
    # (278 464 B smoke, 54 354 800 B north measured).
    "sparse.cold": {"smoke": 348_000, "north": 68_000_000},
    "sparse.carry": {"smoke": 349_000},  # 278 976 B measured
    "sparse.warm": {"smoke": 329_000},  # 262 592 B measured
    # Fused sparse pipeline (shortlist -> solve -> diff -> pack):
    # 278 464 B measured.
    "sparse.pipeline": {"smoke": 348_000},
    # Fused dense pipeline: 2 518 976 / 2 502 592 B measured.
    "pipeline.cold": {"smoke": 3_150_000},
    "pipeline.warm": {"smoke": 3_130_000},
    # Fleet batches, B = 4 bucket-class elements: 9 353 488 / 9 192 208 B
    # measured.
    "fleet.cold": {"smoke": 11_700_000},
    "fleet.warm": {"smoke": 11_500_000},
    # Rank sweep, [P, 4] in and out: 20 480 B measured.
    "sched.ranks": {"smoke": 25_600},
}


# -- measurement -------------------------------------------------------------


def _measure_entry(entry: str, d: Dims, builder: _Builder,
                   device) -> float:
    """Run one entry's dispatch at one class on the card under the
    observatory's cost measurement; returns its
    ``device.peak_alloc_bytes``."""
    from ..obs import device as obs_device
    from ..obs.recorder import Recorder, use_recorder

    klass, fn, args, kwargs = builder(d, device)
    rec = Recorder()
    was = (obs_device.enabled(), obs_device.cost_enabled(),
           obs_device.sweep_trace_enabled())
    with use_recorder(rec):
        obs_device.enable(cost_analysis=True,
                          sweep_trace=was[2] if was[0] else False)
        try:
            obs_device.forget_cost(entry, klass)
            with obs_device.entry(entry):
                obs_device.maybe_publish_cost(entry, klass, device, fn,
                                              *args, **kwargs)
        finally:
            if was[0]:
                obs_device.enable(cost_analysis=was[1],
                                  sweep_trace=was[2])
            else:
                obs_device.disable()
    return float(rec.gauges[
        f'device.peak_alloc_bytes{{entry="{entry}",klass="{klass}"}}'])


def measure_budget_table(classes: Optional[list[str]] = None,
                         device: Any = "cuda") -> list[dict[str, object]]:
    """Measure every budgeted (entry, class) row on ``device``; returns
    dicts with entry/class/budget and measured/ok, ``error`` when the
    dispatch raised, or ``status`` "not run" (ok None) without a card —
    a row that was not measured never reads as passed."""
    import torch

    builders = _builders()
    dev = torch.device(device)
    on_card = dev.type == "cuda" and torch.cuda.is_available()
    rows: list[dict[str, object]] = []
    for ent in sorted(HBM_BUDGETS):
        for klass in sorted(HBM_BUDGETS[ent]):
            if classes is not None and klass not in classes:
                continue
            builder = builders.get(ent)
            dims = SHAPE_CLASSES.get(klass)
            if builder is None or dims is None:
                continue  # run_membudget_check reports these as MEM002
            budget = HBM_BUDGETS[ent][klass]
            row: dict[str, object] = {"entry": ent, "class": klass,
                                      "budget": budget}
            if not on_card:
                row.update(status="not run (no card)", ok=None)
            else:
                try:
                    measured = _measure_entry(ent, dims, builder, dev)
                except Exception as e:
                    first = (str(e).splitlines() or [""])[0][:200]
                    row["error"] = f"{type(e).__name__}: {first}"
                    row["ok"] = False
                else:
                    row["measured"] = measured
                    row["ok"] = measured <= budget
                torch.cuda.empty_cache()
            rows.append(row)
    return rows


def run_membudget_check(device: Any = "cuda",
                        rows_out: Optional[list] = None
                        ) -> tuple[list["Finding"], int]:
    """The structural table checks (MEM002 / MEM003, host-only) plus the
    measurement of every budgeted row at the classes in play (MEM001,
    on the card only).  ``rows_out``, when given, receives the measured
    rows.  Returns (findings, rows measured)."""
    import sys

    from . import Finding

    findings: list[Finding] = []
    builders = _builders()

    # MEM002: table drift, both directions, plus exemption violations.
    for ent in sorted(builders):
        if ent not in HBM_BUDGETS:
            findings.append(Finding(
                rule="MEM002", path=_PATH, line=1, symbol=ent,
                message=f"dispatch entry {ent!r} has a measurable "
                        f"builder but no row in HBM_BUDGETS"))
    for ent in sorted(HBM_BUDGETS):
        if ent in MESH_EXEMPT:
            findings.append(Finding(
                rule="MEM002", path=_PATH, line=1, symbol=ent,
                message=f"budget row for mesh-exempt entry {ent!r}: its "
                        f"peak scales with the mesh — remove the row"))
        elif ent not in builders:
            findings.append(Finding(
                rule="MEM002", path=_PATH, line=1, symbol=ent,
                message=f"budget row {ent!r} matches no measurable "
                        f"builder — a renamed/removed dispatch entry "
                        f"leaves a dead ceiling; update the row"))
        for klass in sorted(HBM_BUDGETS[ent]):
            if klass not in SHAPE_CLASSES:
                findings.append(Finding(
                    rule="MEM002", path=_PATH, line=1,
                    symbol=f"{ent}@{klass}",
                    message=f"budget row {ent!r} names unknown shape "
                            f"class {klass!r} (declared: "
                            f"{sorted(SHAPE_CLASSES)})"))

    # MEM003: a dense row at a class the guard would reject before
    # dispatch on the calibration card.
    from ..plan.tensor import projected_score_bytes

    ref = _dense_guard_ref_bytes()
    for ent in sorted(HBM_BUDGETS):
        if ent not in _DENSE_ENTRIES:
            continue
        for klass in sorted(HBM_BUDGETS[ent]):
            dims = SHAPE_CLASSES.get(klass)
            if dims is None:
                continue
            projected = projected_score_bytes(dims.P, dims.N)
            if projected > ref:
                findings.append(Finding(
                    rule="MEM003", path=_PATH, line=1,
                    symbol=f"{ent}@{klass}",
                    message=f"budget row {ent!r} at class {klass!r} "
                            f"({dims.P}x{dims.N}): check_dense_memory "
                            f"projects {projected} score-matrix bytes, "
                            f"over the {ref}-byte guard budget of the "
                            f"calibration card — the guard rejects this "
                            f"solve before dispatch, so the row is dead"))

    # MEM001: measure what the table budgets, at the classes in play.
    rows = measure_budget_table(_classes_to_run(), device)
    if rows_out is not None:
        rows_out.extend(rows)
    if os.environ.get(_CALIBRATE_ENV):
        print("membudget calibration (peak_alloc_bytes):")
        for row in rows:
            got = row.get("measured", row.get("error", row.get("status")))
            print(f"  {row['entry']:<24} {row['class']:<6} "
                  f"measured={got} budget={row['budget']} ok={row['ok']}")
    not_run = [r for r in rows if r["ok"] is None]
    if not_run:
        print(f"membudget: MEM001 not run for {len(not_run)} rows (no "
              f"card); MEM002/MEM003 checked", file=sys.stderr)
    for row in rows:
        ent = str(row["entry"])
        klass = str(row["class"])
        if "error" in row:
            findings.append(Finding(
                rule="MEM001", path=_PATH, line=1,
                symbol=f"{ent}@{klass}",
                message=f"dispatch of {ent!r} at class {klass!r} failed, "
                        f"so its budget is unverifiable: {row['error']}"))
        elif row["ok"] is False:
            findings.append(Finding(
                rule="MEM001", path=_PATH, line=1,
                symbol=f"{ent}@{klass}",
                message=f"entry {ent!r} at class {klass!r} peaks at "
                        f"{row['measured']:.0f} bytes, over its "
                        f"{row['budget']}-byte budget — recalibrate "
                        f"deliberately ({_CALIBRATE_ENV}=1) or shrink "
                        f"the dispatch"))
    return findings, len(rows) - len(not_run)
