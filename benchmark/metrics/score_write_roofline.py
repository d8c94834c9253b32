"""score_write_roofline: the score write kernel's share of its roofline
over the traced window: the least time the window's score writes could
take on the card (the written [P, N] score, 4 bytes a cell, over the
H100's 3.35 TB/s, ``yardstick.bound_s``) over the device time the
profiler gave the kernels named ``score_write_kernel``.

The work is the program's ``ops.score_write.cells`` counter, summed over
the window's launches.  The bound counts the store alone, a floor on the
kernel's work, so the share cannot pass 100%.  Nothing when the program
has no such counter or the profiler saw no such kernel."""

import yardstick


def score_write_work(cells: int) -> tuple[int, int]:
    """(bytes, operations) of score writes of ``cells`` cells in all:
    each cell's float32 score stored once; the operations are not
    counted."""
    return 4 * cells, 0


def read(run):
    tl, c = run.trace, run.counters
    if tl is None or "ops.score_write.cells" not in c:
        return None
    device_s = sum(s for name, s in tl.kernels.items()
                   if name.startswith("score_write_kernel"))
    if device_s <= 0:
        return None
    least = yardstick.bound_s(*score_write_work(c["ops.score_write.cells"]))
    return 100.0 * least / device_s
