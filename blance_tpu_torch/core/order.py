# Copied from blance_tpu/plan/greedy.py (sort_state_names,
# _partition_name_key, sorted_by_partition_name, flatten_nodes_by_state):
# encode_problem, the move calculus, the orchestrator and the exact planners
# (plan/greedy.py, plan/native.py) share the planner's deterministic state
# and partition order, kept once here.
"""State and partition ordering shared by encode and the planners."""

from __future__ import annotations

from collections.abc import Iterable

import numpy as np

from .types import PartitionModel

__all__ = ["flatten_nodes_by_state", "sort_state_names",
           "sorted_by_partition_name"]


def sort_state_names(model: PartitionModel) -> list[str]:
    """State names ordered by priority ASC then name ASC (plan.go:437-470)."""
    return sorted(model.keys(), key=lambda s: (model[s].priority, s))


def _partition_name_key(name: str) -> str:
    """Zero-pad positive-integer-looking names to width 10 for sortability.

    The reference formats with %10d, which right-aligns with *spaces*
    (plan.go:524-528); spaces compare below digits so equal-width numerics
    order numerically.  Replicated exactly for golden parity.
    """
    digits = name[1:] if name[:1] in ("+", "-") else name
    # Match Go strconv.Atoi: optional sign then ASCII digits only, int64 range.
    if not digits or not all("0" <= c <= "9" for c in digits):
        return name
    n = int(name)
    if n < 0 or n >= 2**63:
        return name
    return f"{n:>10d}"


def sorted_by_partition_name(names: "Iterable[str]") -> list[str]:
    """Sort names by (zero-padded-numeric-else-raw key, name) — the static
    component of the reference's partition order (plan.go:524-528).

    Vectorized for large inputs: plain ASCII-digit names (the overwhelmingly
    common shape) get their sort key built with numpy byte-string ops and
    ordered via lexsort; signed or >18-digit numerics fall back to
    `_partition_name_key` per element, and any non-ASCII input drops the
    whole batch back to the pure-Python path.  Byte-wise bytes comparison
    equals Go's string comparison for ASCII, so the order is identical."""
    names = list(names)
    if len(names) < 4096:
        return sorted(names, key=lambda n: (_partition_name_key(n), n))
    try:
        arr = np.asarray(names, dtype="S")
    except UnicodeEncodeError:
        return sorted(names, key=lambda n: (_partition_name_key(n), n))
    lens = np.char.str_len(arr)
    digit = np.char.isdigit(arr) & (lens <= 18)
    width = max(int(arr.dtype.itemsize), 10)
    keys = arr.astype(f"S{width}")
    if digit.any():
        d = arr[digit]
        stripped = np.char.lstrip(d, b"0")
        stripped = np.where(stripped == b"", b"0", stripped)
        keys[digit] = np.char.rjust(stripped, 10)
    odd = np.char.startswith(arr, b"+") | np.char.startswith(arr, b"-") \
        | (np.char.isdigit(arr) & (lens > 18))
    for i in np.nonzero(odd)[0]:
        keys[i] = _partition_name_key(names[i]).encode()
    order = np.lexsort((arr, keys))
    return [names[i] for i in order]


def flatten_nodes_by_state(nodes_by_state: dict[str, list[str]]) -> list[str]:
    """All nodes across states, concatenated (plan.go:425-431)."""
    rv: list[str] = []
    for nodes in nodes_by_state.values():
        rv.extend(nodes)
    return rv
