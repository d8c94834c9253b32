"""Entry: ``blance_tpu_torch.plan_next_map`` on the previous request's map.

Request k plans ``prev`` with the nodes of ``chain.out(k)`` removed and
those of ``chain.out(k - 1)`` back, on the backend the traffic names
(``"auto"`` routes a large problem to the card)."""

import program


class Entry(program.MapEntry):

    def request(self, k, prev):
        bt = self.bt
        cur = prev[0]
        return bt.plan_next_map(
            cur, cur, self.names, self.node_list(self.chain.out(k)),
            self.node_list(self.chain.out(k - 1)), self.model, self.opts,
            backend=self.traffic["backend"], device=self.device)
