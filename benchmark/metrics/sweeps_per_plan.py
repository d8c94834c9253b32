"""sweeps_per_plan: the program's ``plan.solve.sweeps`` counter (passes
of the converged solve, or the warm repair's one), per request of the
traced window."""


def read(run):
    n = run.counters.get("plan.solve.sweeps")
    if n is None or run.requests == 0:
        return None
    return n / run.requests
