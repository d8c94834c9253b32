"""decode_ms: the program's ``plan.decode`` span plus its
``plan.pipeline.materialize`` span (host decode of the assignment into a
PartitionMap, and the move lists built from the diff arrays), mean per
request of the traced window."""


def read(run):
    parts = [run.spans[n] for n in ("plan.decode",
                                    "plan.pipeline.materialize")
             if n in run.spans]
    if not parts or run.requests == 0:
        return None
    return sum(parts) * 1e3 / run.requests
