"""The port's own telemetry in the parity tests.

The port records spans and counters that the reference does not
(``blance_tpu_torch.obs.PORT_ONLY_TELEMETRY``).  A parity test compares
every reference name exactly on ``ref_view`` of the port's counters or
span counts, and asserts the port's own names where their path runs
with ``port_names``.
"""

from blance_tpu_torch.obs import PORT_ONLY_TELEMETRY

# The solver's counters: every path that runs the auction counts both.
SOLVER = {"plan.solve.auction_rounds", "plan.solve.host_syncs"}
# The work of each sparse min2 call: every path on the sparse engine
# counts the three besides the solver's.
SPARSE_MIN2 = {"ops.sparse_min2.cells", "ops.sparse_min2.price_cells",
               "ops.sparse_min2.out_cells"}
# The cells of each score write: counted at each launch on the card
# only, so no CPU path records it.
SCORE_WRITE = {"ops.score_write.cells"}
# The sparse engine's spans: the shortlist build, and the host dense
# fallback where a row is flagged.
SPARSE_SPANS = {"plan.sparse.shortlist", "plan.sparse.fallback"}
ENCODE = {"plan.encode.order", "plan.encode.prev", "plan.encode.hierarchy"}
DECODE = {"plan.decode.rows", "plan.decode.build"}
# A plan that encodes, solves, audits and decodes; plan_next_map's
# staged path then releases the encoded problem in a span of its own.
PLAN_SPANS = ENCODE | DECODE | {"plan.audit"}
STAGED_SPANS = PLAN_SPANS | {"plan.release"}


def ref_view(d: dict) -> dict:
    """``d`` (counters or span counts) without the port's own names."""
    return {k: v for k, v in d.items() if k not in PORT_ONLY_TELEMETRY}


def port_names(d) -> set:
    """The port's own names among ``d``'s keys."""
    return {k for k in d if k in PORT_ONLY_TELEMETRY}
