"""exhausted_rows_per_plan: the program's
``plan.sparse.shortlist_exhausted`` counter (rows the sparse solve left
with no acceptable candidate in their shortlist, which the host fallback
re-places), per request of the traced window.  0 where the sparse engine
ran (its ``plan.sparse.shortlist`` span is there) and flagged no row;
nothing where it did not run."""


def read(run):
    if run.requests == 0:
        return None
    n = run.counters.get("plan.sparse.shortlist_exhausted")
    if n is not None:
        return n / run.requests
    return 0.0 if "plan.sparse.shortlist" in run.spans else None
