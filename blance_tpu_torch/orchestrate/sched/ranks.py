# Port of blance_tpu/orchestrate/sched/ranks.py: rank_levels on tensors in
# place of the jitted lax.scan; _upward_ranks_host copied.  The device
# sweep is the observatory's "sched.ranks" entry (obs/device.py).
"""Upward-rank (critical-path) priorities over the leveled move DAG.

The move DAG is a union of per-partition chains, so a move's upward
rank — its cost plus the longest path of predicted cost below it —
reduces to the SUFFIX SUM of its chain's remaining costs:

    rank[p][k] = cost[p][k] + rank[p][k + 1]

which is exactly a longest-path sweep over the DAG's levels, last level
first.  Two implementations share that recurrence:

- **host** (the default below ``device_threshold`` total moves): plain
  Python floats, zero dispatch overhead — the right tool for the
  simulator-scale move sets the control loop sees every cycle;
- **device** (``rank_levels``, a sweep over the level axis of the
  ``[P, L]`` zero-padded float32 cost matrix on ``device``): for the
  100k+-move sets a fleet-scale drain produces.

Both paths emit a counter (``sched.host_ranks`` / ``sched.device_ranks``)
so dashboards can see which engine a deployment actually runs.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ...convert import resolve_device
from ...obs import device as obs_device

__all__ = ["DEVICE_THRESHOLD", "rank_levels", "upward_ranks"]

# Total remaining moves at which the rank sweep moves on-device.  Host
# suffix sums are O(M) python-loop work — fine to ~thousands of moves;
# past that the padded [P, L] sweep amortizes its dispatch.
DEVICE_THRESHOLD = int(os.environ.get("BLANCE_SCHED_DEVICE_THRESHOLD",
                                      "4096"))


def rank_levels(costs: torch.Tensor) -> torch.Tensor:
    """Leveled-DAG longest-path sweep on the device of ``costs``: the
    ``[P, L]`` float32 per-move cost matrix (rows = chains, column k =
    the chain's level-k move, zero-padded past each chain's end);
    returns the ``[P, L]`` upward ranks (suffix sums).  Zero padding is
    inert: a padded level contributes nothing to the ranks before it.

    One add per level from the last to the first, in the scan's order
    (``level_cost + carry``), so the sums round exactly as the
    reference's ``lax.scan`` does, on the CPU and on the card alike
    (``torch.cumsum`` is a parallel scan on CUDA and rounds otherwise)."""
    out = torch.empty_like(costs)
    acc = torch.zeros(costs.shape[0], dtype=costs.dtype, device=costs.device)
    for k in range(costs.shape[1] - 1, -1, -1):
        acc = costs[:, k] + acc
        out[:, k] = acc
    return out


def _upward_ranks_host(
        chain_costs: Sequence[Sequence[float]]) -> list[list[float]]:
    out: list[list[float]] = []
    for costs in chain_costs:
        ranks = [0.0] * len(costs)
        acc = 0.0
        for k in range(len(costs) - 1, -1, -1):
            acc += costs[k]
            ranks[k] = acc
        out.append(ranks)
    return out


def _upward_ranks_device(
        chain_costs: Sequence[Sequence[float]],
        device: Any = "cuda") -> list[list[float]]:
    dev = resolve_device(device, "upward_ranks")
    lens = [len(c) for c in chain_costs]
    max_len = max(lens, default=0)
    if max_len == 0:
        return [[] for _ in chain_costs]
    padded = np.zeros((len(chain_costs), max_len), dtype=np.float32)
    for i, costs in enumerate(chain_costs):
        padded[i, :lens[i]] = costs
    with obs_device.entry("sched.ranks"), obs_device.measure(
            "sched.ranks", f"{padded.shape[0]}x{max_len}", dev):
        ranks = rank_levels(torch.from_numpy(padded).to(dev)).cpu().numpy()
    return [ranks[i, :lens[i]].tolist() for i in range(len(chain_costs))]


def upward_ranks(
    chain_costs: Sequence[Sequence[float]],
    device_threshold: Optional[int] = None,
    recorder: Optional[Any] = None,
    device: Any = "cuda",
) -> list[list[float]]:
    """Per-chain upward ranks (suffix sums of predicted move costs).

    ``chain_costs[i][k]`` is the predicted cost of chain ``i``'s
    level-``k`` remaining move; the result is shape-congruent.  Move
    sets of ``device_threshold`` moves or more run the device sweep
    (float32) on ``device``; smaller sets stay on host (python floats).
    Pass ``device_threshold=0`` to force the device path, or a huge
    value to pin the host path."""
    threshold = DEVICE_THRESHOLD if device_threshold is None \
        else device_threshold
    total = sum(len(c) for c in chain_costs)
    if total >= threshold:
        if recorder is not None:
            recorder.count("sched.device_ranks")
        return _upward_ranks_device(chain_costs, device)
    if recorder is not None:
        recorder.count("sched.host_ranks")
    return _upward_ranks_host(chain_costs)
