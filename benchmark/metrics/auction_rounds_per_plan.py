"""auction_rounds_per_plan: the program's ``plan.solve.auction_rounds``
counter (rounds of the solver's auction, over every slot and sweep), per
request of the traced window.  Nothing where the program has no such
counter."""


def read(run):
    n = run.counters.get("plan.solve.auction_rounds")
    if n is None or run.requests == 0:
        return None
    return n / run.requests
