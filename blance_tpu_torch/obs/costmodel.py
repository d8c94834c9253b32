# Copied from blance_tpu/obs/costmodel.py.
"""Calibrated per-(node, op-kind) move-cost model.

ROADMAP item 2's critical-path move scheduler needs a per-move cost
estimate "calibrated online from the obs ``orchestrate.move_latency_s``
histograms".  This module is that artifact: :class:`CostModel` is a span
SINK — attach it to the Recorder and it learns from the exact same
``orchestrate.move.exec`` lifecycle spans the histograms are built from,
with no extra instrumentation in the orchestrator:

- each exec span carries its node and the batch's op kinds; the batch's
  wall-clock (retries included — that IS the cost of moving onto a flaky
  node) is amortized evenly across its moves, and each move's share
  updates an EWMA per ``(node, op)``:
  ``ewma' = alpha * observed + (1 - alpha) * ewma``;
- :meth:`predict` answers in fallback order — exact ``(node, op)``
  estimate, then the op-kind aggregate (a new node costs like the op
  does elsewhere), then the global aggregate, then ``default_s`` —
  so the scheduler always gets a number;
- prediction error is scored ONLINE: at each update where an estimate
  already existed, the relative error ``|predicted - observed| /
  observed`` lands in the ``costmodel.rel_err`` histogram and the
  calibration report (bench's costmodel stage publishes its p50);
- the whole model round-trips through JSON (:meth:`save` /
  :meth:`load`), so a scheduler can warm-start from the previous run's
  calibration instead of re-learning a fleet from scratch.

The sink methods are plain sync code (the Recorder calls them inline as
spans finish), so updates are atomic on the event loop; the race lint's
``SHARED_STATE`` table declares the mutable attributes.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional, TextIO, Union

from ..utils.atomicio import atomic_write_json
from .recorder import Recorder, Span, get_recorder, percentile

__all__ = ["CostModel", "EXEC_SPAN", "DEFAULT_PRIORS_PATH",
           "default_op_priors"]

# The move-lifecycle span the model learns from: the app-callback
# execution child, which carries node= and ops= attributes.
EXEC_SPAN = "orchestrate.move.exec"

_FORMAT_VERSION = 1
_PRIORS_VERSION = 1

# The committed bench calibration: per-op EWMA aggregates measured by
# bench.py's costmodel stage (regenerate from its ``op_priors_s``
# output).  Seeding these as op-level priors means a scheduler on a
# NEVER-OBSERVED cluster already prices a del cheaper than an add
# instead of running uniform-cost.
DEFAULT_PRIORS_PATH = os.path.join(os.path.dirname(__file__),
                                   "costmodel_priors.json")


def default_op_priors(path: Optional[str] = None) -> dict[str, float]:
    """Load the committed per-op prior table: op kind -> seconds.
    Raises on a version mismatch (regenerate the file from the bench
    costmodel stage) so a stale format can never silently mis-seed."""
    with open(path if path is not None else DEFAULT_PRIORS_PATH) as f:
        data = json.load(f)
    version = data.get("version")
    if version != _PRIORS_VERSION:
        raise ValueError(
            f"cost-model priors version {version!r} != {_PRIORS_VERSION}"
            f" (regenerate the file from the bench costmodel stage)")
    return {str(op): float(s)
            for op, s in data["op_priors_s"].items()}


class CostModel:
    """EWMA move-cost estimates per (node, op kind), learned from spans.

    alpha: EWMA smoothing factor in (0, 1] — higher adapts faster.
    default_s: the cold-start prediction before any observation.
    recorder: where ``costmodel.updates`` / ``costmodel.rel_err`` land;
        defaults to the process recorder at update time.
    """

    def __init__(self, alpha: float = 0.3, default_s: float = 0.05,
                 recorder: Optional[Recorder] = None) -> None:
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self._alpha = alpha
        self._default_s = default_s
        self._rec = recorder
        # (node, op) -> [ewma_seconds, n_observations]
        self._est: dict[tuple[str, str], list] = {}
        # op -> [ewma_seconds, n] (fallback for unseen nodes)
        self._op_est: dict[str, list] = {}
        # [ewma_seconds, n] (fallback for unseen ops)
        self._global: list = [0.0, 0]
        # Online relative errors, bounded exactly like the Recorder's
        # percentile sample: a systematic 1-in-stride subsample whose
        # stride doubles on each 2:1 decimation at the cap — the sample
        # stays spread over the WHOLE scoring history, not just the
        # most recent window.
        self._errors: list[float] = []
        self._err_stride = 1
        self._n_scored = 0

    # -- sink protocol --------------------------------------------------------

    def span(self, sp: Span) -> None:
        if sp.name != EXEC_SPAN or sp.t_end is None:
            return
        node = sp.attrs.get("node")
        ops_attr = sp.attrs.get("ops")
        if not isinstance(node, str) or not isinstance(ops_attr, str) \
                or not ops_attr:
            return
        ops = ops_attr.split(",")
        per_move_s = max(sp.duration_s, 0.0) / len(ops)
        rec = self._rec if self._rec is not None else get_recorder()
        for op in ops:
            self._update(node, op, per_move_s, rec)

    # NOTE: no ``counter`` hook — the Recorder feature-detects it, and
    # declaring one would put this sink on the hot path of every count().

    def close(self) -> None:
        pass

    def _update(self, node: str, op: str, observed_s: float,
                rec: Recorder) -> None:
        key = (node, op)
        est = self._est.get(key)
        if est is not None:
            # Score the prediction this observation falsifies, BEFORE
            # folding the observation in.
            err = abs(est[0] - observed_s) / max(observed_s, 1e-9)
            if self._n_scored % self._err_stride == 0:
                self._errors.append(err)
                if len(self._errors) >= 4096:
                    del self._errors[::2]
                    self._err_stride *= 2
            self._n_scored += 1
            rec.observe("costmodel.rel_err", err)
            est[0] = self._alpha * observed_s + (1 - self._alpha) * est[0]
            est[1] += 1
        else:
            self._est[key] = [observed_s, 1]
        for agg in (self._op_est.setdefault(op, [0.0, 0]), self._global):
            agg[0] = observed_s if agg[1] == 0 else \
                self._alpha * observed_s + (1 - self._alpha) * agg[0]
            agg[1] += 1
        rec.count("costmodel.updates")

    # -- cold-start priors ----------------------------------------------------

    def seed_priors(self, op_priors_s: "dict[str, float]",
                    n: int = 1) -> None:
        """Seed op-level fallback estimates (op kind -> seconds) for
        ops with NO observations yet — the committed bench calibration
        (``default_op_priors``) is the canonical source.  Live
        observations take over through the normal EWMA fold; aggregates
        that already learned from real spans are never overwritten."""
        for op, s in op_priors_s.items():
            agg = self._op_est.get(op)
            if agg is None or agg[1] == 0:
                self._op_est[op] = [float(s), max(int(n), 1)]

    @classmethod
    def with_priors(cls, path: Optional[str] = None,
                    **kwargs: Any) -> "CostModel":
        """A fresh model seeded from the committed bench calibration
        file — the scheduler's cold-start spelling."""
        model = cls(**kwargs)
        model.seed_priors(default_op_priors(path))
        return model

    # -- the scheduler-facing API ---------------------------------------------

    def predict(self, node: str, op: str) -> float:
        """Estimated seconds for one (node, op) move — exact estimate,
        else op aggregate, else global aggregate, else default.  Every
        answer below the exact level counts ``costmodel.cold_predictions``
        so dashboards can see how much of a schedule ran on priors."""
        est = self._est.get((node, op))
        if est is not None:
            return float(est[0])
        rec = self._rec if self._rec is not None else get_recorder()
        rec.count("costmodel.cold_predictions")
        agg = self._op_est.get(op)
        if agg is not None and agg[1] > 0:
            return float(agg[0])
        if self._global[1] > 0:
            return float(self._global[0])
        return self._default_s

    def predict_move(self, move: Any) -> float:
        """``predict`` over anything with ``node``/``op`` attributes
        (``PartitionMove``, a move cursor entry)."""
        return self.predict(move.node, move.op)

    def observations(self) -> int:
        return int(self._global[1])

    def estimates(self) -> dict[tuple[str, str], float]:
        """A copy of the exact (node, op) estimate table."""
        return {k: float(v[0]) for k, v in self._est.items()}

    def calibration(self) -> dict:
        """Online predicted-vs-actual scoring: relative-error p50/p95
        over the updates that had a prior estimate to falsify (exact up
        to ~4k scored updates, a systematic whole-history subsample
        beyond — same bounding as the Recorder's percentile sample)."""
        out = {
            "observations": self.observations(),
            "scored": self._n_scored,
            "estimates": len(self._est),
        }
        if self._errors:
            out["p50_rel_err"] = percentile(self._errors, 50)
            out["p95_rel_err"] = percentile(self._errors, 95)
        return out

    # -- persistence ----------------------------------------------------------

    def to_json(self) -> dict:
        """The on-disk format (docs/OBSERVABILITY.md documents it)."""
        return {
            "version": _FORMAT_VERSION,
            "alpha": self._alpha,
            "default_s": self._default_s,
            "estimates": [
                {"node": node, "op": op, "ewma_s": est[0], "n": est[1]}
                for (node, op), est in sorted(self._est.items())
            ],
            "op_estimates": {
                op: {"ewma_s": agg[0], "n": agg[1]}
                for op, agg in sorted(self._op_est.items())
            },
            "global": {"ewma_s": self._global[0], "n": self._global[1]},
        }

    @classmethod
    def from_json(cls, data: dict,
                  recorder: Optional[Recorder] = None) -> "CostModel":
        version = data.get("version")
        if version != _FORMAT_VERSION:
            raise ValueError(
                f"cost-model format version {version!r} != "
                f"{_FORMAT_VERSION} (regenerate the file)")
        model = cls(alpha=float(data["alpha"]),
                    default_s=float(data["default_s"]), recorder=recorder)
        for entry in data.get("estimates", ()):
            model._est[(str(entry["node"]), str(entry["op"]))] = [
                float(entry["ewma_s"]), int(entry["n"])]
        for op, agg in data.get("op_estimates", {}).items():
            model._op_est[str(op)] = [float(agg["ewma_s"]), int(agg["n"])]
        g = data.get("global", {"ewma_s": 0.0, "n": 0})
        model._global = [float(g["ewma_s"]), int(g["n"])]
        return model

    def save(self, path_or_file: Union[str, TextIO]) -> None:
        """Persist as JSON; a path write goes through the shared
        crash-atomic recipe (:mod:`blance_tpu_torch.utils.atomicio` — same-dir
        temp + fsync + rename + directory fsync) so a scheduler never
        loads a torn model and a completed save survives power loss."""
        if not isinstance(path_or_file, str):
            json.dump(self.to_json(), path_or_file, indent=1, sort_keys=True)
            return
        atomic_write_json(path_or_file, self.to_json(),
                          indent=1, sort_keys=True)

    @classmethod
    def load(cls, path_or_file: Union[str, TextIO],
             recorder: Optional[Recorder] = None) -> "CostModel":
        if isinstance(path_or_file, str):
            with open(path_or_file) as f:
                return cls.from_json(json.load(f), recorder=recorder)
        return cls.from_json(json.load(path_or_file), recorder=recorder)
