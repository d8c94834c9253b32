"""carry_hit_pct: requests of the traced window whose session replan was
served by the warm carry (the program's ``plan.solve.carry_hit``
counter), as a share of the requests.  Nothing where the path keeps no
carry (neither a hit nor a miss counted)."""


def read(run):
    c = run.counters
    if "plan.solve.carry_hit" not in c and "plan.solve.carry_miss" not in c:
        return None
    if run.requests == 0:
        return None
    return 100.0 * c.get("plan.solve.carry_hit", 0) / run.requests
