# Copied from blance_tpu/orchestrate/health.py.
"""Per-node health tracking: a circuit breaker for the orchestrator.

The reference orchestrator has no notion of node health — a node whose
assign callback keeps failing is fed moves forever (each one burning the
app's retry budget), and a dead node wedges the transition.  This module
adds the classic three-state breaker, per node:

    healthy ──(N consecutive failures)──> quarantined
    quarantined ──(probe_after_s elapsed)──> half-open
    half-open ──(probe succeeds)──> healthy
    half-open ──(probe fails)──> quarantined   (timer restarts)

While quarantined, the mover releases queued batches for the node
immediately as failures (``Orchestrator`` turns them into structured
``MoveFailure``s) instead of invoking the callback — so a dead node's
work drains fast and the failure-aware recovery replan
(``rebalance_async``) can re-place it on live nodes.  After
``probe_after_s`` the breaker admits exactly ONE probe batch at a time;
a success re-admits the node, a failure re-trips it.

Wall-clock enters only through the injectable ``clock`` callable
(default ``time.monotonic``), so tier-1 tests drive the breaker through
its whole state machine in virtual time, deterministically.

Every trip bumps the ``orchestrate.quarantine_trips`` counter on the
obs Recorder (docs/OBSERVABILITY.md).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..obs import get_recorder

__all__ = ["HEALTHY", "QUARANTINED", "HALF_OPEN", "NodeHealth",
           "HealthTracker", "HEALTH_FORMAT_VERSION"]

# On-disk schema version for HealthTracker.to_dict/from_dict (bumped on
# any incompatible field change; from_dict refuses other versions).
HEALTH_FORMAT_VERSION = 1

HEALTHY = "healthy"
QUARANTINED = "quarantined"
HALF_OPEN = "half-open"


@dataclass
class NodeHealth:
    """Mutable breaker state for one node."""

    state: str = HEALTHY
    consecutive_failures: int = 0
    trips: int = 0  # lifetime quarantine entries
    tripped_at: float = 0.0  # clock() of the last trip
    probe_in_flight: bool = False
    # Cumulative seconds spent quarantined/half-open across CLOSED
    # quarantine intervals; the currently-open interval (tripped_at ->
    # now) is added at read time (HealthTracker.exposure_s) — the SLO
    # plane's per-node quarantine-exposure gauge.
    exposure_s: float = 0.0


@dataclass
class HealthTracker:
    """Circuit breaker over a set of nodes.

    threshold: consecutive failures (or timeouts) that trip quarantine.
    probe_after_s: quarantine dwell before the first half-open probe.
    clock: monotonic-seconds source; injectable for virtual-time tests.
    """

    threshold: int = 3
    probe_after_s: float = 1.0
    clock: Callable[[], float] = time.monotonic
    _nodes: dict[str, NodeHealth] = field(default_factory=dict)

    def _get(self, node: str) -> NodeHealth:
        h = self._nodes.get(node)
        if h is None:
            h = self._nodes[node] = NodeHealth()
        return h

    # -- outcome reporting ---------------------------------------------------

    def record_success(self, node: str) -> bool:
        """A callback attempt for ``node`` succeeded: half-open heals,
        failure streaks reset.  Returns True when THIS success healed a
        quarantined/half-open node (the breaker's heal transition)."""
        h = self._get(node)
        healed = h.state in (QUARANTINED, HALF_OPEN)
        if healed:
            # Close the open quarantine interval into the exposure total.
            h.exposure_s += max(self.clock() - h.tripped_at, 0.0)
        h.consecutive_failures = 0
        h.probe_in_flight = False
        h.state = HEALTHY
        return healed

    def record_failure(self, node: str) -> bool:
        """A callback attempt for ``node`` failed or timed out.  Returns
        True when THIS failure tripped the node into quarantine (a
        half-open probe failure re-trips and also returns True)."""
        h = self._get(node)
        h.consecutive_failures += 1
        was_open = h.state in (QUARANTINED, HALF_OPEN)
        if h.state == HALF_OPEN:
            h.probe_in_flight = False
            tripped = True
        else:
            tripped = h.state == HEALTHY and \
                h.consecutive_failures >= max(self.threshold, 1)
        if tripped:
            if was_open:
                # Half-open re-trip: the dwell so far closes into the
                # exposure total before the interval clock restarts.
                h.exposure_s += max(self.clock() - h.tripped_at, 0.0)
            h.state = QUARANTINED
            h.tripped_at = self.clock()
            h.trips += 1
            get_recorder().count("orchestrate.quarantine_trips")
        elif was_open:
            # Failure while quarantined without an admitted probe (e.g. a
            # retry already in flight when the trip happened): stay put,
            # keep the original dwell timer.
            h.state = QUARANTINED
        return tripped

    # -- admission -----------------------------------------------------------

    def admit(self, node: str) -> str:
        """Gate one batch for ``node``: "ok" (healthy), "probe" (half-open
        trial admission — exactly one at a time), or "reject" (quarantined:
        release the batch as a failure without calling the app)."""
        h = self._nodes.get(node)
        if h is None or h.state == HEALTHY:
            return "ok"
        if h.state == QUARANTINED and \
                self.clock() - h.tripped_at >= self.probe_after_s:
            h.state = HALF_OPEN
        if h.state == HALF_OPEN and not h.probe_in_flight:
            h.probe_in_flight = True
            return "probe"
        return "reject"

    def forget(self, node: str) -> None:
        """Drop ``node``'s breaker state entirely — a node REPLACED by
        the control plane (e.g. a preempted spot instance or a flapped
        zone coming back) starts with a clean slate instead of
        inheriting the dead incarnation's quarantine.  Its accumulated
        exposure is forgotten with it; read ``exposures()`` before
        forgetting if the SLO account needs the history."""
        self._nodes.pop(node, None)

    # -- introspection -------------------------------------------------------

    def state(self, node: str) -> str:
        h = self._nodes.get(node)
        return h.state if h is not None else HEALTHY

    def quarantined_nodes(self) -> list[str]:
        """Nodes currently tripped (quarantined or half-open), sorted —
        the set the recovery replan treats as ``nodes_to_remove``."""
        return sorted(n for n, h in self._nodes.items()
                      if h.state in (QUARANTINED, HALF_OPEN))

    def total_trips(self) -> int:
        return sum(h.trips for h in self._nodes.values())

    def exposure_s(self, node: str, now: Optional[float] = None) -> float:
        """Cumulative quarantined/half-open seconds for ``node``: every
        closed interval plus the currently-open one (if tripped)."""
        h = self._nodes.get(node)
        if h is None:
            return 0.0
        total = h.exposure_s
        if h.state in (QUARANTINED, HALF_OPEN):
            t = self.clock() if now is None else now
            total += max(t - h.tripped_at, 0.0)
        return total

    def exposures(self, now: Optional[float] = None) -> dict[str, float]:
        """node -> cumulative exposure seconds, for every node that has
        ever been quarantined (the SLO per-node exposure gauge)."""
        out: dict[str, float] = {}
        for node, h in self._nodes.items():
            if h.trips > 0:
                out[node] = self.exposure_s(node, now)
        return out

    # -- serialization (durability snapshots) --------------------------------

    def to_dict(self, now: Optional[float] = None) -> dict[str, object]:
        """Versioned JSON-safe snapshot of the whole breaker.

        The open quarantine interval of a tripped node is stored as an
        AGE (``now - tripped_at``), not an absolute instant: the clock
        that measured ``tripped_at`` dies with the process, and a new
        incarnation's monotonic clock has an unrelated epoch.  Ages are
        epoch-free, so ``from_dict`` can re-base them onto whatever
        clock the restored tracker runs on, and exposure accounting
        stays continuous across the crash.
        """
        t = self.clock() if now is None else now
        nodes: dict[str, dict[str, object]] = {}
        for node, h in sorted(self._nodes.items()):
            open_interval = h.state in (QUARANTINED, HALF_OPEN)
            nodes[node] = {
                "state": h.state,
                "consecutive_failures": h.consecutive_failures,
                "trips": h.trips,
                "exposure_s": h.exposure_s,
                "tripped_age_s": (
                    max(t - h.tripped_at, 0.0) if open_interval else None),
            }
        return {
            "version": HEALTH_FORMAT_VERSION,
            "threshold": self.threshold,
            "probe_after_s": self.probe_after_s,
            "nodes": nodes,
        }

    @classmethod
    def from_dict(cls, data: dict[str, object], *,
                  clock: Callable[[], float] = time.monotonic,
                  now: Optional[float] = None) -> "HealthTracker":
        """Rebuild a tracker on a NEW clock from :meth:`to_dict` output.

        Open quarantine intervals are re-based: ``tripped_at`` becomes
        ``now - tripped_age_s`` on the new clock, so dwell timers and
        the open-interval exposure resume exactly where the crash cut
        them.  ``probe_in_flight`` is deliberately NOT restored — an
        in-flight probe died with the old process, and carrying the
        flag would wedge admission (half-open rejects everything until
        a completion that can never arrive); the restored node simply
        re-admits a fresh probe when its dwell allows.
        """
        version = data.get("version")
        if version != HEALTH_FORMAT_VERSION:
            raise ValueError(
                f"health snapshot version {version!r} != "
                f"{HEALTH_FORMAT_VERSION} (incompatible snapshot)")

        def num(v: object) -> float:
            assert isinstance(v, (int, float)) and not isinstance(v, bool)
            return float(v)

        tracker = cls(
            threshold=int(num(data["threshold"])),
            probe_after_s=num(data["probe_after_s"]),
            clock=clock)
        t = clock() if now is None else now
        raw_nodes = data.get("nodes", {})
        assert isinstance(raw_nodes, dict)
        for node, entry in raw_nodes.items():
            assert isinstance(entry, dict)
            age = entry.get("tripped_age_s")
            tracker._nodes[str(node)] = NodeHealth(
                state=str(entry["state"]),
                consecutive_failures=int(num(entry["consecutive_failures"])),
                trips=int(num(entry["trips"])),
                tripped_at=(t - num(age)) if age is not None else 0.0,
                probe_in_flight=False,
                exposure_s=num(entry["exposure_s"]),
            )
        return tracker
