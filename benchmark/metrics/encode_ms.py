"""encode_ms: the program's ``plan.encode`` span (host encode of the
PartitionMap into arrays), mean per request of the traced window."""


def read(run):
    t = run.spans.get("plan.encode")
    if t is None or run.requests == 0:
        return None
    return t * 1e3 / run.requests
