"""Entry: ``blance_tpu_torch.plan_pipeline``, the plan and its moves.

As ``plan_next_map``'s entry, and the move lists come back too; the
reference checks them against the moves it derives from the request's
input and output maps."""

import program


class Entry(program.MapEntry):

    has_moves = True

    def request(self, k, prev):
        bt = self.bt
        cur = prev[0]
        return bt.plan_pipeline(
            cur, cur, self.names, self.node_list(self.chain.out(k)),
            self.node_list(self.chain.out(k - 1)), self.model, self.opts,
            device=self.device)
