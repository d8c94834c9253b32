"""solve_ms: the program's span around its device stage, mean per
request of the traced window: ``plan.solve`` (plan_next_map) or
``plan.pipeline.dispatch`` (the pipelines, cold or warm)."""


def read(run):
    for name in ("plan.solve", "plan.pipeline.dispatch"):
        if name in run.spans and run.requests:
            return run.spans[name] * 1e3 / run.requests
    return None
