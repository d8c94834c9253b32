"""The check fails a broken timed path: the rest of a run on the CPU at
small sizes, with the program's entry broken underneath, and the control
(the plain planner breaking one guarantee) in the program's place.  The
cells run on one card, so there is no exchange between cards to leave
out."""

import numpy as np
import pytest

import _bench_path
import blance_tpu_torch as bt
import harness

MIXES = _bench_path.mixes()


def run(cell, **kw):
    result, _ = harness.run_cell(
        cell, _bench_path.SEED + 7, 1.0, False, device="cpu",
        cfg=_bench_path.small_cfg(cell), limits=_bench_path.SMALL_LIMITS,
        w=MIXES[cell], **kw)
    return result


def _unchanged_map(real):
    def entry(prev, pta, *args, **kw):
        out = real(prev, pta, *args, **kw)
        return (prev,) + tuple(out[1:])
    return entry


def _half_map(real):
    def entry(prev, pta, *args, **kw):
        out = real(prev, pta, *args, **kw)
        names = sorted(out[0])
        half = dict(out[0], **{k: prev[k] for k in names[::2]})
        return (half,) + tuple(out[1:])
    return entry


def _altered_map(real):
    def entry(prev, pta, *args, **kw):
        out = real(prev, pta, *args, **kw)
        m = dict(out[0])
        k = sorted(m)[0]
        nbs = dict(m[k].nodes_by_state)
        nbs["replica"] = list(nbs["primary"])  # one answer altered
        m[k] = bt.Partition(k, nbs)
        return (m,) + tuple(out[1:])
    return entry


def _altered_move(real):
    def entry(*args, **kw):
        nxt, warn, moves = real(*args, **kw)
        moves = dict(moves)
        k = next(k for k, v in moves.items() if v)
        moves[k] = moves[k][:-1]
        return nxt, warn, moves
    return entry


FAULTS = {"unchanged": _unchanged_map, "half": _half_map,
          "altered": _altered_map}
ENTRY = {"northstar.failover": "plan_next_map",
         "multiprimary.failover": "plan_next_map",
         "delta32k.pipeline": "plan_pipeline"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(ENTRY))
def test_fault_in_map_entry_fails(cell, fault, monkeypatch):
    name = ENTRY[cell]
    monkeypatch.setattr(bt, name, FAULTS[fault](getattr(bt, name)))
    result = run(cell)
    assert not result["correct"]
    assert result["checks"]["violations"][0] > 0


def test_altered_move_fails(monkeypatch):
    monkeypatch.setattr(bt, "plan_pipeline", _altered_move(bt.plan_pipeline))
    result = run("delta32k.pipeline")
    assert not result["correct"]
    assert result["checks"]["moves_mismatch"][0] > 0
    assert result["checks"]["violations"][0] == 0


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered",
                                   "altered_move"])
def test_fault_in_session_fails(fault, monkeypatch):
    real = bt.PlannerSession.replan_with_moves

    def broken(self, *a, **kw):
        cur = self.current
        assign, darrs = real(self, *a, **kw)
        assign = assign.copy()
        if fault == "unchanged":
            assign = cur.copy()
        elif fault == "half":
            assign[::2] = cur[::2]
        elif fault == "altered":
            assign[0, 1, 0] = assign[0, 0, 0]
        else:
            darrs = tuple(d.copy() for d in darrs)
            rows = np.flatnonzero((darrs[2] >= 0).any(axis=1))
            if rows.size:  # the set-up replan moves nothing
                darrs[2][rows[0], 0] = (darrs[2][rows[0], 0] + 1) % 4
        self.proposed = assign
        return assign, darrs

    monkeypatch.setattr(bt.PlannerSession, "replan_with_moves", broken)
    result = run("northstar.swap")
    assert not result["correct"]


def _controls():
    out = []
    for cell in sorted(MIXES):
        ruled = bool(_bench_path.small_cfg(cell).get("hierarchy_rules"))
        out += [(cell, "skip_returning", "balance_cv"),
                (cell, "fresh", "churn")]
        if ruled:
            out.append((cell, "no_rule", "violations"))
    return out


@pytest.mark.parametrize("cell,variant,number", _controls())
def test_control_fails(cell, variant, number):
    result = run(cell, control=variant)
    assert not result["correct"]
    value, limit = result["checks"][number]
    assert value > limit
    plain = run(cell, control="plain")
    assert plain["checks"]["violations"][0] == 0
