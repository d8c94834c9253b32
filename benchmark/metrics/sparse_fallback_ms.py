"""sparse_fallback_ms: the program's ``plan.sparse.fallback`` span (the
host dense fallback that re-places the rows the sparse solve flagged,
with the host copies of its inputs), per request of the traced window.
0 where the sparse engine ran (its ``plan.sparse.shortlist`` span is
there) and no row fell back; nothing where it did not run."""


def read(run):
    if run.requests == 0:
        return None
    t = run.spans.get("plan.sparse.fallback")
    if t is not None:
        return t * 1e3 / run.requests
    return 0.0 if "plan.sparse.shortlist" in run.spans else None
