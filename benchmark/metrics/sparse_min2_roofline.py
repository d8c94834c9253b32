"""sparse_min2_roofline: the sparse min2 kernel's share of its roofline
over the traced window: the least time the window's sparse min2 work
could take on the card (bytes over the H100's 3.35 TB/s or operations
over its float32 rate, ``yardstick.bound_s``) over the device time the
profiler gave the kernels named ``sparse_min2_kernel``.

The work is the program's ``ops.sparse_min2.*`` counters, summed over
the window's calls: ``cells`` (P·K), ``price_cells`` (the [N] price row
of the gathered entry, 0 for the [P, K]-price one) and ``out_cells``
(five or four [P] outputs).  Nothing when the program has no such
counters or the profiler saw no such kernel."""

import yardstick


def sparse_min2_work(cells: int, price_cells: int,
                     out_cells: int) -> tuple[int, int]:
    """(bytes, operations) of sparse min2 calls, frozen from
    ``blance_tpu_torch/ops/cost.py`` ``sparse_cand_work`` and
    ``sparse_work`` (ops/cost.py:77-91): score and cand (or the [P, K]
    price) read, 8 bytes a cell; the [N] price row once; 4 bytes an
    output; a price add and two compares a cell."""
    return 8 * cells + 4 * price_cells + 4 * out_cells, 3 * cells


def read(run):
    tl, c = run.trace, run.counters
    if tl is None or "ops.sparse_min2.cells" not in c:
        return None
    device_s = sum(s for name, s in tl.kernels.items()
                   if name.startswith("sparse_min2_kernel"))
    if device_s <= 0:
        return None
    least = yardstick.bound_s(*sparse_min2_work(
        c["ops.sparse_min2.cells"], c.get("ops.sparse_min2.price_cells", 0),
        c.get("ops.sparse_min2.out_cells", 0)))
    return 100.0 * least / device_s
