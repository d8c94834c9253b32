"""host_syncs_per_plan: the program's ``plan.solve.host_syncs`` counter
(each deliberate read of a device value back to the host on the plan
path: loop and branch flags, result copies, explicit synchronisation),
per request of the traced window.  Nothing where the program has no
such counter."""


def read(run):
    n = run.counters.get("plan.solve.host_syncs")
    if n is None or run.requests == 0:
        return None
    return n / run.requests
