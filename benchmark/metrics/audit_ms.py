"""audit_ms: the program's ``plan.audit`` span (the host audit of the
solved assignment, check_assignment), mean per request of the traced
window.  Nothing where the program has no such span."""


def read(run):
    t = run.spans.get("plan.audit")
    if t is None or run.requests == 0:
        return None
    return t * 1e3 / run.requests
