"""moves_per_plan: copies placed on a (partition, state, node) that the
request's input map did not hold, summed over the window's requests by
the reference (reference.placed) and divided by the requests."""


def read(run):
    if run.requests == 0:
        return None
    return run.placed / run.requests
