"""Entry: a ``blance_tpu_torch.PlannerSession`` held across requests.

Set-up loads the start map, takes out the nodes out at the start and runs
the session's first replan, so its warm carry exists before the window.
Request k: ``remove_nodes`` the nodes of ``chain.out(k)``, ``add_nodes``
those of ``chain.out(k - 1)``, ``replan_with_moves``, ``apply``.  The
outputs are the session's arrays; they are read by the session's own
row and column labels once the window has closed."""

import numpy as np

import program


class Entry(program.MapEntry):

    has_moves = True

    def initial(self):
        bt = self.bt
        self.session = bt.PlannerSession(
            self.model, self.names, self.parts, opts=self.opts,
            device=self.device)
        self.session.load_map(self.to_map(self.start))
        self.session.remove_nodes(self.node_list(self.chain.out(-1)))
        first = self.session.replan_with_moves()
        self.session.apply()
        return first

    def request(self, k, prev):
        s = self.session
        s.remove_nodes(self.node_list(self.chain.out(k)))
        s.add_nodes(self.node_list(self.chain.out(k - 1)))
        out = s.replan_with_moves()
        s.apply()
        return out

    def close(self):
        s = self.session
        self.labels = (list(s.problem.partitions), list(s.nodes),
                       list(s.problem.states))
        del self.session

    def record(self, raw):
        return raw  # the session's arrays, read by its labels at close

    def _index(self):
        parts, nodes, states = self.labels
        rows = np.array([self.part_index.get(p, -1) for p in parts])
        cols = np.array([self.node_index.get(n, -1) for n in nodes])
        return rows, cols, states

    def rows(self, raw):
        assign = np.asarray(raw[0])  # [P, S, R]: slot r of each state
        rows, cols, states = self._index()
        bad = int((rows < 0).sum() + (cols < 0).sum())
        out = np.full((len(self.parts), len(self.dep.cols)), -1, np.int32)
        order = [states.index(s) if s in states else -1
                 for s in self.dep.states]
        bad += order.count(-1)
        col = 0
        for si, so in enumerate(order):
            r_copies = self.dep.copies[si]
            if so >= 0:
                # Slots past the state's copies must be empty.
                bad += int((assign[:, so, r_copies:] >= 0).sum())
                for r in range(r_copies):
                    ids = assign[:, so, r]
                    ok = (rows >= 0) & (ids >= 0) & (ids < cols.size)
                    out[rows[ok], col + r] = cols[ids[ok]]
                    bad += int(((ids >= cols.size) & (rows >= 0)).sum())
            col += r_copies
        return out, bad

    def steps(self, raw):
        d_nodes, d_states, d_ops = (np.asarray(a) for a in raw[1])
        rows, cols, states = self._index()
        state_map = np.array([self.dep.states.index(s)
                              if s in self.dep.states else -2
                              for s in states] + [-1])  # -1 wraps: del
        node_map = np.append(cols, -2)  # -2: not a node of the session
        d_nodes = np.where((d_nodes >= 0) & (d_nodes < cols.size), d_nodes,
                           -1)
        got = np.full((len(self.parts), d_ops.shape[1], 3), -1, np.int32)
        keep = rows >= 0
        got[rows[keep], :, 0] = np.where(d_ops[keep] >= 0,
                                         node_map[d_nodes[keep]], -1)
        got[rows[keep], :, 1] = np.where(d_ops[keep] >= 0,
                                         state_map[d_states[keep]], -1)
        got[rows[keep], :, 2] = d_ops[keep]
        return got
