"""The port's shape audit (blance_tpu_torch.analysis.shape_audit).

Its contract table is the reference's whole table, the twelve sharded
contracts included: the same labels and the same expected output trees.
The reference's ``expect()`` is numpy only, so the comparison never runs
its ``run_shape_audit``.  The port runs each contract on a small
concrete problem, here on the CPU (the sharded ones on a 2-rank CPU
mesh); on the card ``tests/test_torch_cuda.py`` runs it with
``device="cuda"``.
"""

import pytest
import torch

from blance_tpu_torch.analysis import shape_audit as sa

_SHARDED = {"solve_dense_sharded", "solve_sparse_sharded",
            "plan_pipeline_sharded"}


def _labels(contracts):
    return [f"{c.entry}[{c.variant}]" for c in contracts]


def test_table_is_the_reference_less_its_sharded_contracts():
    """The table is the reference's, in its order, now with the twelve
    sharded contracts it once left out."""
    pytest.importorskip("jax")  # the reference package imports it
    from blance_tpu.analysis import shape_audit as ref

    sharded = [c for c in ref.CONTRACTS if c.entry in _SHARDED]
    assert len(sharded) == 12
    assert _labels(sa.CONTRACTS) == _labels(ref.CONTRACTS)
    for mine, theirs in zip(sa.CONTRACTS, ref.CONTRACTS):
        assert mine.expect() == theirs.expect(), mine.entry
    assert len(sa.CONTRACTS) == 72 and len(sa.HOST_CHECKS) == 4


def test_audit_passes_on_the_cpu():
    timings = {}
    findings, entries = sa.run_shape_audit(device="cpu", timings=timings)
    rendered = "\n".join(f.render() for f in findings)
    assert findings == [], f"shape contract violations:\n{rendered}"
    assert entries == 72 + 4
    assert sorted(timings) == sorted(_labels(sa.CONTRACTS))
    entry_names = {c.entry for c in sa.CONTRACTS}
    assert {"solve_dense", "solve_dense_converged", "solve_dense_warm",
            "carry_from_assignment", "fleet_cold_batch", "solve_sparse",
            "plan_pipeline", "sched_rank_levels"} | _SHARDED <= entry_names
    assert sa._MESHES == {}  # the audit's mesh is closed after the run


def test_audit_catches_drift(monkeypatch):
    """A contract that expects the wrong R reports SHP001."""
    broken = sa.ShapeContract(
        entry="solve_dense", variant="drifted",
        build=lambda dev: sa._build_solve_dense(
            sa.Dims(P=8, S=1, N=5, R=1), dev),
        expect=lambda: ((8, 1, 2), "int32"))  # wrong R
    monkeypatch.setattr(sa, "CONTRACTS", (broken,))
    findings, _ = sa.run_shape_audit(device="cpu")
    assert [f.rule for f in findings] == ["SHP001"]
    assert "expected (8, 1, 2) int32, got (8, 1, 1) int32" in \
        findings[0].message


def test_audit_reports_a_raising_entry(monkeypatch):
    def boom(dev):
        raise ValueError("no such problem")

    broken = sa.ShapeContract(entry="solve_dense", variant="raises",
                              build=boom, expect=lambda: ((1,), "int32"))
    monkeypatch.setattr(sa, "CONTRACTS", (broken,))
    findings, _ = sa.run_shape_audit(device="cpu")
    assert [f.rule for f in findings] == ["SHP002"]
    assert "raised on its audit problem" in findings[0].message


def test_host_scalars_read_as_the_reference_types():
    leaves = sa._leaves((torch.zeros((2, 3), dtype=torch.int32), 4, True,
                         torch.tensor(True)))
    assert leaves == [((2, 3), "int32"), ((), "int32"), ((), "bool"),
                      ((), "bool")]


def test_audit_targets_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        sa.run_shape_audit()
