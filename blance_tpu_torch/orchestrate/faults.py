# Copied from blance_tpu/orchestrate/faults.py.
"""Deterministic fault injection for orchestrator chaos testing.

A :class:`FaultPlan` wraps the app's ``assign_partitions`` callback and
scripts failures, hangs, and flakes per ``(node, partition, attempt)``.
Decisions come from a SHA-256 hash of ``(seed, node, partition, attempt)``
— not ``random`` state and not Python's randomized ``hash()`` — so a
given seed produces the exact same fault schedule on every run, every
platform, and regardless of asyncio interleaving: the same (node,
partition) pair fails on the same attempt numbers no matter when the
orchestrator gets around to trying it.  That is what makes chaos
scenarios (flaky node at 30%, dead node, hung node) reproducible in
tier-1 CPU tests with no real hardware.

Hangs are virtual-time: a "hang" decision parks the callback on an event
that never fires, and the orchestrator's ``move_timeout_s`` deadline
(OrchestratorOptions) cancels it — so a test models a wedged node with a
10 ms timeout instead of a wall-clock sleep.

Typical use::

    plan = FaultPlan(seed=7, nodes={
        "flaky": NodeFaults(fail_rate=0.3),
        "dead":  NodeFaults(dead=True),
        "hung":  NodeFaults(dead=True, hang=True),
    })
    o = orchestrate_moves(model, ft_options, nodes, beg, end,
                          plan.wrap(assign))

``plan.injected`` / ``plan.events`` record exactly what was injected,
for assertions.
"""

from __future__ import annotations

import asyncio
import hashlib
import inspect
from dataclasses import dataclass, field
from typing import Callable, Optional

__all__ = ["FaultInjected", "NodeFaults", "FaultPlan"]


class FaultInjected(Exception):
    """The scripted failure a FaultPlan raises in place of the callback."""

    def __init__(self, node: str, partitions: tuple[str, ...],
                 attempt: int) -> None:
        super().__init__(
            f"injected fault: node={node} partitions={list(partitions)} "
            f"attempt={attempt}")
        self.node = node
        self.partitions = partitions
        self.attempt = attempt


@dataclass(frozen=True)
class NodeFaults:
    """Fault profile for one node.

    fail_rate: per-(partition, attempt) probability of a fast failure.
    hang_rate: per-(partition, attempt) probability of a hang (needs
        ``move_timeout_s`` set, or the mover stalls like the reference).
    dead: every attempt faults (with ``hang`` choosing the flavor).
    hang: with ``dead``, hang instead of failing fast.
    heal_after: node-level attempt count after which the node behaves
        perfectly — models a node that recovers, exercising the breaker's
        half-open probe re-admission.
    """

    fail_rate: float = 0.0
    hang_rate: float = 0.0
    dead: bool = False
    hang: bool = False
    heal_after: Optional[int] = None


def _unit_interval(seed: int, node: str, partition: str, attempt: int) -> float:
    """Deterministic u in [0, 1) from a stable cryptographic hash."""
    digest = hashlib.sha256(
        f"{seed}:{node}:{partition}:{attempt}".encode()).digest()
    return int.from_bytes(digest[:8], "big") / 2 ** 64


@dataclass
class FaultPlan:
    """Seeded, scripted chaos for an assign_partitions callback."""

    seed: int = 0
    nodes: dict[str, NodeFaults] = field(default_factory=dict)
    # bookkeeping (all deterministic given the schedule):
    attempts: dict[tuple[str, str], int] = field(default_factory=dict)
    node_attempts: dict[str, int] = field(default_factory=dict)
    injected: dict[str, int] = field(default_factory=dict)
    events: list[tuple[str, tuple[str, ...], str]] = \
        field(default_factory=list)

    def decide(self, node: str, partition: str, attempt: int) -> str:
        """Scripted outcome for one (node, partition, attempt): "ok",
        "fail", or "hang".  Pure given the plan's seed and profiles —
        callable from tests to predict the schedule."""
        nf = self.nodes.get(node)
        if nf is None:
            return "ok"
        if nf.heal_after is not None and \
                self.node_attempts.get(node, 0) >= nf.heal_after:
            return "ok"
        if nf.dead:
            return "hang" if nf.hang else "fail"
        u = _unit_interval(self.seed, node, partition, attempt)
        if u < nf.hang_rate:
            return "hang"
        if u < nf.hang_rate + nf.fail_rate:
            return "fail"
        return "ok"

    def _bump(self, kind: str) -> None:
        self.injected[kind] = self.injected.get(kind, 0) + 1

    def wrap(self, assign: Callable[..., object]) -> Callable[..., object]:
        """Wrap a sync-or-async assign_partitions callback.  The wrapper
        consults the schedule per batch (a batch faults when ANY of its
        partitions' next attempts is scripted to fault — hang beats fail
        when both appear) and otherwise forwards to the app."""

        async def chaotic(stop_ch, node, partitions, states, ops):
            decision = "ok"
            batch_attempt = self.node_attempts.get(node, 0)
            for p in partitions:
                att = self.attempts.get((node, p), 0)
                d = self.decide(node, p, att)
                if d == "hang" or (d == "fail" and decision == "ok"):
                    decision = d
            for p in partitions:
                self.attempts[(node, p)] = self.attempts.get((node, p), 0) + 1
            self.node_attempts[node] = batch_attempt + 1
            self.events.append((node, tuple(partitions), decision))
            if decision == "hang":
                self._bump("hang")
                # Virtual hang: parks forever; move_timeout_s cancels it.
                await asyncio.Event().wait()
            if decision == "fail":
                self._bump("fail")
                raise FaultInjected(node, tuple(partitions), batch_attempt)
            self._bump("ok")
            result = assign(stop_ch, node, partitions, states, ops)
            if inspect.isawaitable(result):
                result = await result
            return result

        return chaotic
