"""plan_s: the window's wall time over the plan requests completed in it
(one client, closed loop), host clock, the card synchronised after each
request."""


def read(run):
    if run.requests == 0:
        return None
    return run.window_s / run.requests
