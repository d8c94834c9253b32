"""The control: the reference's plain planner in the program's place.

Not a traffic entry: ``run_cell(..., control=<variant>)`` puts it where
the traffic's entry would be, on the same inputs and the same chain, to
show that the check fails a plan that breaks one stated guarantee:

- ``skip_returning``: the nodes coming back are never chosen (balance);
- ``fresh``: every copy is laid out anew, the input map ignored
  (stickiness);
- ``no_rule``: the rack rule is not applied (placement rules);
- ``plain``: no guarantee broken, as a sanity reading."""

import reference

VARIANTS = ("skip_returning", "fresh", "no_rule", "plain")


class Entry:

    has_moves = False

    def __init__(self, dep, cfg, traffic, start, chain, variant):
        if variant not in VARIANTS:
            raise ValueError(f"unknown control {variant!r}")
        self.dep, self.chain, self.start = dep, chain, start
        self.variant = variant
        self.names = dep.node_names()
        self.racks = dep.racks()

    def initial(self):
        return self.start

    def request(self, k, prev):
        v = self.variant
        return reference.plain_plan(
            prev, self.chain.out(k), self.racks, self.dep.cols,
            () if v == "no_rule" else self.dep.apart,
            skip=self.chain.out(k - 1) if v == "skip_returning" else None,
            fresh=v == "fresh")

    def record(self, raw):
        return raw

    def rows(self, raw):
        return raw, 0

    def steps(self, raw):
        return None

    def close(self):
        pass
