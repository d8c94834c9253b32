"""min2_roofline: the min2 kernel's share of its roofline over the
traced window: the least time its launches could take (the benchmark's
frozen yardstick at each launch's operand shapes: bytes over the H100's
3.35 TB/s) over the device time the profiler gave them.  Nothing when no
min2 launch ran, or when the launches the profiler saw do not pair one
for one with the shapes noted at launch."""

import yardstick


def read(run):
    tl = run.trace
    if tl is None or not tl.min2_s or \
            len(tl.min2_s) != len(tl.min2_shapes):
        return None
    least = sum(yardstick.bound_s(*yardstick.min2_work(s, p))
                for s, p in tl.min2_shapes)
    return 100.0 * least / sum(tl.min2_s)
