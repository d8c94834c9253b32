"""shortlist_ms: the program's ``plan.sparse.shortlist`` span (the sparse
engine's [P, K] candidate shortlist built on the card, the card
synchronised at its end), mean per request of the traced window.
Nothing where the program has no such span or the sparse engine did not
run."""


def read(run):
    t = run.spans.get("plan.sparse.shortlist")
    if t is None or run.requests == 0:
        return None
    return t * 1e3 / run.requests
