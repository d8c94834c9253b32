# Copied from blance_tpu/obs/slo.py.
"""Online SLO accounting for a live rebalance.

The continuous-rebalance story (ROADMAP item 4) needs service-level
numbers DURING the transition, not after: how much of the keyspace is
serving right now, how much movement the convergence is costing, and
whether progress has stalled.  :class:`SloTracker` computes them online:

- **partition availability** — the fraction of partitions with at least
  one node in a serving-primary state.  Maintained INCREMENTALLY: the
  tracker holds a per-partition ``node -> state`` view seeded from the
  begin map and applies each successfully executed move as the
  orchestrator reports it (the achieved-map delta), so an update is
  O(moves in the batch), never a full-map recompute.
- **cumulative churn** — successfully executed moves divided by the
  minimum necessary (the primary plan's move count).  1.0 is a perfect
  run; retries burned on abandoned partitions and recovery-round
  re-placements push it above 1.
- **convergence lag** — seconds (on the tracker's clock, so virtual
  seconds under ``DeterministicLoop``) since the last successfully
  executed move: the "is it stuck" gauge.
- **per-node quarantine exposure** — cumulative seconds each node has
  spent quarantined/half-open, read from the orchestrator's
  ``HealthTracker``.

With ``track_timeline=True`` the tracker additionally keeps *horizon*
accounting for the continuous-rebalance control loop (the
``testing/simulate`` tier, docs/SIMULATOR.md): every availability
change is appended to a ``(t, availability)`` step timeline, from which
it derives

- **time-weighted availability** — the integral of the availability
  step function over the run divided by its duration: the fraction of
  (partition x seconds) that was actually serving, the honest headline
  for a run with transient dips;
- **SLO-violation intervals** — with ``availability_floor`` set, the
  maximal ``[start, end)`` intervals during which availability sat
  below the floor, plus their cumulative seconds.

Both are pure functions of the timeline, so under a virtual clock the
whole horizon account replays bit-identically.

The tracker is an orchestrator *move observer* (``on_batch``): the
mover calls it after every batch with the outcome.  Updates are plain
sync methods with no awaits — on the event loop they are atomic, so
concurrent movers cannot tear the placement view (the race lint's
``SHARED_STATE`` table declares the attributes; the schedule explorer's
``slo_gauges_under_chaos`` scenario checks the bounds dynamically).

Gauges are published to a Recorder (``slo.*`` — see the
``MetricsRegistry`` table in ``obs/expo.py``) on every update;
``publish`` is also the collector hook a ``MetricsServer`` calls before
each snapshot so time-derived gauges stay fresh between events.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Mapping, Optional, Protocol, \
    Sequence

from .recorder import Recorder, escape_label_value, get_recorder

__all__ = ["FleetSloRollup", "FleetSloSummary", "MoveObserver",
           "SloSummary", "SloTracker", "SLO_FORMAT_VERSION"]

# On-disk schema version for SloTracker.to_dict/from_dict (durability
# snapshots); from_dict refuses other versions.
SLO_FORMAT_VERSION = 1

# Kept as the module-local spelling; the one implementation lives in
# obs/recorder.py so it cannot drift from obs/device.py's labels.
_escape_label = escape_label_value


class MoveObserver(Protocol):
    """What the orchestrator notifies after every batch outcome.  A
    'move' is duck-typed (``partition``/``node``/``state``/``op``
    attributes) so observers need no import of the orchestrate layer."""

    def on_batch(self, node: str, moves: Sequence[Any], ok: bool,
                 now: float) -> None: ...


@dataclass
class SloSummary:
    """The end-of-run SLO snapshot (``RebalanceResult.slo``, the bench
    artifact's ``slo`` block).  Formulas in docs/OBSERVABILITY.md."""

    availability: float
    churn_ratio: float
    convergence_lag_s: float
    moves_executed: int
    moves_failed: int
    min_moves: int
    partitions: int
    available_partitions: int
    quarantine_exposure_s: dict[str, float] = field(default_factory=dict)
    # Per-incident makespan accounting: seconds
    # from incident open to the LAST required move executed, one entry
    # per closed incident.  ``convergence_lag_s`` ("seconds since the
    # last executed move") under-reports during a long scheduled tail —
    # moves keep landing, so the gauge hugs zero while the rebalance is
    # still hours from done; this is the honest time-to-converged the
    # critical-path scheduler minimizes.  None until an incident closed.
    first_converged_lag_s: Optional[float] = None
    first_converged_lags: list[float] = field(default_factory=list)
    # -- horizon accounting (None/empty unless track_timeline was on) --
    time_weighted_availability: Optional[float] = None
    availability_floor: Optional[float] = None
    violation_s: float = 0.0
    # Maximal [start, end) intervals with availability < floor, in
    # tracker-clock seconds.
    violation_intervals: list[tuple[float, float]] = \
        field(default_factory=list)


class SloTracker:
    """Incremental SLO gauges over one (possibly multi-round) rebalance.

    ``beg_map`` seeds the placement view; ``primary_states`` names the
    states that count as "serving" (the priority-0 states of the model;
    ``rebalance_async`` computes this automatically).  ``clock`` is the
    time source for convergence lag — pass ``recorder.now`` so SLO time
    and span time agree (and both follow a virtual clock in tests)."""

    def __init__(self, beg_map: Mapping[str, Any],
                 primary_states: Iterable[str] = ("primary",),
                 clock: Optional[Callable[[], float]] = None,
                 recorder: Optional[Recorder] = None,
                 track_timeline: bool = False,
                 availability_floor: Optional[float] = None,
                 publish_gauges: bool = True) -> None:
        self._rec = recorder
        # publish_gauges=False keeps the whole account (summaries,
        # timelines, incidents) but silences the slo.* gauge writes: a
        # fleet of per-tenant trackers must not fight last-writer-wins
        # over one process-wide gauge set — the FleetSloRollup publishes
        # the aggregate instead (docs/FLEET.md).
        self._publish_gauges = publish_gauges
        self._clock: Callable[[], float] = (
            clock if clock is not None
            else (recorder.now if recorder is not None else time.perf_counter))
        self._primary_states = frozenset(primary_states)
        # partition -> {node -> state}: the live placement view.
        self._placements: dict[str, dict[str, str]] = {}
        # partition -> number of serving-primary holders.
        self._primaries: dict[str, int] = {}
        self._available = 0
        for name, part in beg_map.items():
            d: dict[str, str] = {}
            for state, ns in part.nodes_by_state.items():
                for n in ns:
                    d[n] = state
            self._placements[name] = d
            prim = sum(1 for s in d.values() if s in self._primary_states)
            self._primaries[name] = prim
            if prim > 0:
                self._available += 1
        self._total = len(self._placements)
        self._min_moves = 0
        self.moves_executed = 0
        self.moves_failed = 0
        self._t_last_progress = self._clock()
        self._health: Optional[Any] = None
        # Incident accounting: open at the event that starts a
        # rebalance episode (delta submission / rebalance entry), close
        # at its quiesce; the lag is measured to the LAST executed move
        # inside the incident, so debounce/planning idle after the
        # final move never inflates it.
        self._incident_t0: Optional[float] = None
        self._incident_moves0 = 0
        self._incident_fails0 = 0
        self._t_last_fail: Optional[float] = None
        self._first_converged_lags: list[float] = []
        # Horizon accounting: a step timeline of (t, availability),
        # appended only on CHANGE (plus the seed point), so the
        # integral below is a plain fold over it.
        self._floor = availability_floor
        self._t0 = self._t_last_progress
        self._timeline: Optional[list[tuple[float, float]]] = (
            [(self._t0, self.availability())] if track_timeline else None)

    # -- wiring ---------------------------------------------------------------

    def set_min_moves(self, n: int) -> None:
        """Pin the churn denominator to the PRIMARY plan's move count.
        First call wins: recovery rounds re-plan, but the minimum
        necessary is what the original transition needed."""
        if self._min_moves == 0:
            self._min_moves = max(int(n), 0)

    def attach_health(self, health: Optional[Any]) -> None:
        """Adopt the orchestrator's HealthTracker (it carries across
        recovery rounds) as the quarantine-exposure source."""
        if health is not None:
            self._health = health

    # -- incident (makespan) accounting ---------------------------------------

    def open_incident(self, t: Optional[float] = None) -> None:
        """Mark the start of a rebalance incident (a cluster delta, a
        rebalance call).  First open wins until the incident closes, so
        a burst of coalesced deltas reads as ONE incident measured from
        its first event."""
        if self._incident_t0 is None:
            self._incident_t0 = self._clock() if t is None else t
            self._incident_moves0 = self.moves_executed
            self._incident_fails0 = self.moves_failed

    def close_incident(self, t: Optional[float] = None) -> Optional[float]:
        """Close the open incident (the control loop quiesced / the
        rebalance returned) and record its time-to-converged: incident
        open to the last executed move — 0.0 when the incident needed
        no moves.  An incident whose execution TAIL is failures (fails
        after the last execute, or no execute at all) never converged,
        so its lag is the whole open-to-close window (a lower bound),
        never a deflated time-to-last-execute; a failure that a retry
        or recovery round then executed past still reads as converged.
        Publishes ``slo.first_converged_lag_s``; returns the lag (None
        when no incident was open)."""
        if self._incident_t0 is None:
            return None
        executed = self.moves_executed > self._incident_moves0
        failed = self.moves_failed > self._incident_fails0
        fail_tail = failed and self._t_last_fail is not None and (
            not executed or self._t_last_fail > self._t_last_progress)
        if executed and not fail_tail:
            lag = max(self._t_last_progress - self._incident_t0, 0.0)
        elif fail_tail:
            t_close = self._clock() if t is None else t
            lag = max(t_close - self._incident_t0, 0.0)
        else:
            lag = 0.0
        self._first_converged_lags.append(lag)
        self._incident_t0 = None
        self.publish(t)
        return lag

    def discard_incident(self) -> None:
        """Drop the open incident WITHOUT recording a lag — the caller
        raised out of the episode (validation error, planner crash), so
        there is no makespan to account and the next episode's
        ``open_incident`` must not read a stale start.  No-op when
        nothing is open."""
        self._incident_t0 = None

    def first_converged_lags(self) -> list[float]:
        """Per-incident time-to-converged samples, in close order."""
        return list(self._first_converged_lags)

    # -- the orchestrator hook ------------------------------------------------

    def on_batch(self, node: str, moves: Sequence[Any], ok: bool,
                 now: float) -> None:
        """One batch outcome from a mover.  ``ok`` means the assign
        callback succeeded and the moves are applied cluster-side; a
        failed batch is assumed NOT applied (the orchestrator's
        achieved-map presumption) and only counts against churn
        bookkeeping as failures."""
        if ok:
            for mv in moves:
                self._apply(mv)
            self.moves_executed += len(moves)
            self._t_last_progress = now
            self._note_availability(now)
        else:
            self.moves_failed += len(moves)
            self._t_last_fail = now
        self.publish(now)

    def _apply(self, mv: Any) -> None:
        """One executed move against the placement view: remove the node
        from wherever it was, then (unless the move is a removal) place
        it in the move's state — mirroring ``Orchestrator.achieved_map``
        one move at a time."""
        d = self._placements.get(mv.partition)
        if d is None:  # a partition outside the begin map: ignore
            return
        was_available = self._primaries[mv.partition] > 0
        old = d.pop(mv.node, None)
        if old in self._primary_states:
            self._primaries[mv.partition] -= 1
        if mv.state:
            d[mv.node] = mv.state
            if mv.state in self._primary_states:
                self._primaries[mv.partition] += 1
        now_available = self._primaries[mv.partition] > 0
        if was_available != now_available:
            self._available += 1 if now_available else -1

    def strip_nodes(self, nodes: Iterable[str],
                    now: Optional[float] = None) -> None:
        """Drop every placement on ``nodes`` — the recovery-round
        presumption that a quarantined node's data is lost.  Mirrors
        ``rebalance._strip_nodes`` on the incremental view."""
        dead = set(nodes)
        if not dead:
            return
        for name, d in self._placements.items():
            was_available = self._primaries[name] > 0
            for n in list(d):
                if n in dead:
                    if d.pop(n) in self._primary_states:
                        self._primaries[name] -= 1
            now_available = self._primaries[name] > 0
            if was_available != now_available:
                self._available += 1 if now_available else -1
        self._note_availability(now)
        self.publish(now)

    def _note_availability(self, now: Optional[float] = None) -> None:
        """Append to the horizon timeline when availability changed
        (no-op unless ``track_timeline``).  The timeline is a step
        function: each entry holds from its ``t`` until the next."""
        if self._timeline is None:
            return
        a = self.availability()
        if a != self._timeline[-1][1]:
            t = self._clock() if now is None else now
            self._timeline.append((t, a))

    # -- gauges ---------------------------------------------------------------

    def availability(self) -> float:
        """available partitions / total partitions, in [0, 1]."""
        return self._available / self._total if self._total else 1.0

    def churn_ratio(self) -> float:
        """moves executed / minimum necessary (>= 0; 0 until a plan is
        pinned, 1.0 for a perfect single-pass run)."""
        return self.moves_executed / self._min_moves if self._min_moves \
            else 0.0

    def convergence_lag_s(self, now: Optional[float] = None) -> float:
        """Seconds since the last forward progress (executed move)."""
        t = self._clock() if now is None else now
        return max(t - self._t_last_progress, 0.0)

    def timeline(self) -> list[tuple[float, float]]:
        """The (t, availability) step timeline (empty unless
        ``track_timeline``); entry i holds from t_i until t_{i+1}."""
        return list(self._timeline) if self._timeline is not None else []

    def time_weighted_availability(
            self, now: Optional[float] = None) -> float:
        """Integral of the availability step function over [t0, now]
        divided by the duration — the fraction of partition-seconds
        that was serving.  Falls back to the instantaneous availability
        with no timeline or a zero-length horizon."""
        if self._timeline is None:
            return self.availability()
        t = self._clock() if now is None else now
        if t <= self._t0:
            return self.availability()
        total = 0.0
        for (t_i, a_i), (t_j, _a_j) in zip(self._timeline,
                                           self._timeline[1:]):
            total += (t_j - t_i) * a_i
        t_last, a_last = self._timeline[-1]
        total += (t - t_last) * a_last
        return total / (t - self._t0)

    def violation_intervals(
            self, now: Optional[float] = None) -> list[tuple[float, float]]:
        """Maximal [start, end) intervals with availability strictly
        below ``availability_floor`` (empty without a floor or
        timeline; an interval still open at ``now`` closes at it)."""
        if self._timeline is None or self._floor is None:
            return []
        t = self._clock() if now is None else now
        out: list[tuple[float, float]] = []
        open_at: Optional[float] = None
        for t_i, a_i in self._timeline:
            if a_i < self._floor and open_at is None:
                open_at = t_i
            elif a_i >= self._floor and open_at is not None:
                out.append((open_at, t_i))
                open_at = None
        if open_at is not None:
            out.append((open_at, max(t, open_at)))
        return out

    def violation_s(self, now: Optional[float] = None) -> float:
        """Cumulative seconds spent below the availability floor."""
        return sum(e - s for s, e in self.violation_intervals(now))

    def quarantine_exposure_s(self) -> dict[str, float]:
        """node -> cumulative quarantined seconds, from the attached
        HealthTracker (empty when no breaker is wired).  The tracker
        reads its OWN clock for the open interval — its ``tripped_at``
        stamps came from that clock, and mixing another clock's 'now'
        into the subtraction would corrupt the arithmetic (perf_counter
        and monotonic have unrelated epochs)."""
        if self._health is None:
            return {}
        out: dict[str, float] = self._health.exposures()
        return out

    # -- exposition -----------------------------------------------------------

    def publish(self, now: Optional[float] = None) -> None:
        """Write every gauge into the recorder (``slo.*``).  Collector-
        compatible: a MetricsServer calls this before each snapshot.
        No-op when the tracker was built with ``publish_gauges=False``
        (fleet mode: the rollup owns the process-wide gauges)."""
        if not self._publish_gauges:
            return
        rec = self._rec if self._rec is not None else get_recorder()
        t = self._clock() if now is None else now
        rec.set_gauge("slo.partition_availability", self.availability())
        rec.set_gauge("slo.churn_ratio", self.churn_ratio())
        rec.set_gauge("slo.convergence_lag_s", self.convergence_lag_s(t))
        rec.set_gauge("slo.moves_executed", self.moves_executed)
        rec.set_gauge("slo.moves_failed", self.moves_failed)
        rec.set_gauge("slo.min_moves", self._min_moves)
        if self._first_converged_lags:
            rec.set_gauge("slo.first_converged_lag_s",
                          self._first_converged_lags[-1])
        if self._timeline is not None:
            rec.set_gauge("slo.time_weighted_availability",
                          self.time_weighted_availability(t))
            if self._floor is not None:
                rec.set_gauge("slo.violation_seconds", self.violation_s(t))
        exposures = self.quarantine_exposure_s()
        rec.set_gauge("slo.quarantined_nodes", float(len(
            self._health.quarantined_nodes()) if self._health is not None
            else 0))
        for node, exposure in exposures.items():
            rec.set_gauge(
                f'slo.quarantine_exposure_s{{node="{_escape_label(node)}"}}',
                exposure)

    # -- serialization (durability snapshots) ---------------------------------

    def to_dict(self, now: Optional[float] = None) -> dict[str, Any]:
        """Versioned JSON-safe snapshot of the whole account — placement
        view, churn counters, incident state, and the horizon timeline.

        Every instant is stored as an AGE relative to ``now`` (the same
        epoch-free convention as ``HealthTracker.to_dict``): the clock
        that stamped the timeline dies with the process, so absolute
        instants would be meaningless to a restored tracker.  Ages keep
        every duration — integrals, dwell, lag — exact; only the
        absolute origin shifts to the new clock's epoch.
        """
        t = self._clock() if now is None else now
        return {
            "version": SLO_FORMAT_VERSION,
            "primary_states": sorted(self._primary_states),
            "placements": {name: dict(d)
                           for name, d in sorted(self._placements.items())},
            "min_moves": self._min_moves,
            "moves_executed": self.moves_executed,
            "moves_failed": self.moves_failed,
            "floor": self._floor,
            "last_progress_age_s": t - self._t_last_progress,
            "last_fail_age_s": (t - self._t_last_fail
                                if self._t_last_fail is not None else None),
            "incident_age_s": (t - self._incident_t0
                               if self._incident_t0 is not None else None),
            "incident_moves0": self._incident_moves0,
            "incident_fails0": self._incident_fails0,
            "first_converged_lags": list(self._first_converged_lags),
            "t0_age_s": t - self._t0,
            "timeline": ([[t - t_i, a] for t_i, a in self._timeline]
                         if self._timeline is not None else None),
        }

    @classmethod
    def from_dict(cls, data: dict[str, Any], *,
                  clock: Optional[Callable[[], float]] = None,
                  recorder: Optional[Recorder] = None,
                  now: Optional[float] = None,
                  publish_gauges: bool = True) -> "SloTracker":
        """Rebuild a tracker on a NEW clock from :meth:`to_dict` output.
        Ages re-base onto the new clock (``instant = now - age``); the
        placement-derived counts (primaries, availability) are
        recomputed from the serialized view rather than trusted."""
        version = data.get("version")
        if version != SLO_FORMAT_VERSION:
            raise ValueError(
                f"slo snapshot version {version!r} != {SLO_FORMAT_VERSION} "
                f"(incompatible snapshot)")
        tracker = cls({}, primary_states=tuple(data["primary_states"]),
                      clock=clock, recorder=recorder,
                      availability_floor=data.get("floor"),
                      publish_gauges=publish_gauges)
        t = tracker._clock() if now is None else now
        tracker._placements = {
            str(name): {str(n): str(s) for n, s in d.items()}
            for name, d in data["placements"].items()}
        tracker._primaries = {
            name: sum(1 for s in d.values() if s in tracker._primary_states)
            for name, d in tracker._placements.items()}
        tracker._available = sum(
            1 for prim in tracker._primaries.values() if prim > 0)
        tracker._total = len(tracker._placements)
        tracker._min_moves = int(data["min_moves"])
        tracker.moves_executed = int(data["moves_executed"])
        tracker.moves_failed = int(data["moves_failed"])
        tracker._t_last_progress = t - float(data["last_progress_age_s"])
        last_fail = data.get("last_fail_age_s")
        tracker._t_last_fail = (t - float(last_fail)
                                if last_fail is not None else None)
        incident = data.get("incident_age_s")
        tracker._incident_t0 = (t - float(incident)
                                if incident is not None else None)
        tracker._incident_moves0 = int(data["incident_moves0"])
        tracker._incident_fails0 = int(data["incident_fails0"])
        tracker._first_converged_lags = [
            float(x) for x in data["first_converged_lags"]]
        tracker._t0 = t - float(data["t0_age_s"])
        timeline = data.get("timeline")
        tracker._timeline = (
            [(t - float(age), float(a)) for age, a in timeline]
            if timeline is not None else None)
        return tracker

    def summary(self, now: Optional[float] = None) -> SloSummary:
        t = self._clock() if now is None else now
        return SloSummary(
            availability=self.availability(),
            churn_ratio=self.churn_ratio(),
            convergence_lag_s=self.convergence_lag_s(t),
            moves_executed=self.moves_executed,
            moves_failed=self.moves_failed,
            min_moves=self._min_moves,
            partitions=self._total,
            available_partitions=self._available,
            quarantine_exposure_s=self.quarantine_exposure_s(),
            first_converged_lag_s=(self._first_converged_lags[-1]
                                   if self._first_converged_lags
                                   else None),
            first_converged_lags=list(self._first_converged_lags),
            time_weighted_availability=(
                self.time_weighted_availability(t)
                if self._timeline is not None else None),
            availability_floor=self._floor,
            violation_s=self.violation_s(t),
            violation_intervals=self.violation_intervals(t),
        )


@dataclass
class FleetSloSummary:
    """One fleet-wide SLO reading rolled up over every tenant loop
    (``FleetSloRollup.summary``; the fleet simulator's scorecard and
    the ``slo.fleet_*`` gauges' source of truth)."""

    tenants: int
    availability_min: float
    availability_mean: float
    tenants_below_floor: int
    availability_floor: Optional[float]
    moves_executed: int
    moves_failed: int
    violation_s: float
    # The tenant at availability_min (ties: first registration order) —
    # the "who is hurting" pointer the scorecard renders.
    worst_tenant: Optional[str] = None
    per_tenant: dict[str, SloSummary] = field(default_factory=dict)


class FleetSloRollup:
    """Fleet-wide rollup over per-tenant :class:`SloTracker`\\ s.

    The fleet-of-loops tier (``blance_tpu/fleetloop.py``) runs one
    tracker per tenant; this class aggregates them into one scorecard —
    minimum / mean availability across tenants, how many sit below the
    SLO floor, total executed/failed moves, cumulative violation
    seconds — published as ``slo.fleet_*`` / ``fleet.tenants`` gauges
    so the EXISTING exposition plane (``obs/expo.py``
    ``MetricsServer``) renders the whole fleet without any new
    endpoint.  ``publish`` is collector-compatible: pass it in a
    ``MetricsServer(collectors=...)`` so every scrape snapshots a fresh
    rollup.

    Single-task discipline (analysis/race_lint.py SHARED_STATE): every
    method is sync with no await — registration happens on the fleet
    controller's task, reads on the exposition snapshot path — so the
    registry cannot tear mid-rollup."""

    def __init__(self, availability_floor: Optional[float] = None,
                 recorder: Optional[Recorder] = None,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self._rec = recorder
        self._floor = availability_floor
        self._clock: Callable[[], float] = (
            clock if clock is not None
            else (recorder.now if recorder is not None
                  else time.perf_counter))
        self._trackers: dict[str, SloTracker] = {}

    def register(self, key: str, tracker: SloTracker) -> None:
        """Adopt one tenant loop's tracker (re-registering a key
        replaces it — a re-onboarded tenant starts a fresh account)."""
        self._trackers[key] = tracker

    def forget(self, key: str) -> None:
        self._trackers.pop(key, None)

    def keys(self) -> list[str]:
        return list(self._trackers)

    def summary(self, now: Optional[float] = None,
                per_tenant: bool = True) -> FleetSloSummary:
        t = self._clock() if now is None else now
        avail: list[tuple[str, float]] = [
            (k, tr.availability()) for k, tr in self._trackers.items()]
        below = sum(1 for _k, a in avail
                    if self._floor is not None and a < self._floor)
        worst: Optional[str] = None
        amin = 1.0
        for k, a in avail:
            if a < amin:
                amin, worst = a, k
        return FleetSloSummary(
            tenants=len(avail),
            availability_min=amin if avail else 1.0,
            availability_mean=(sum(a for _k, a in avail) / len(avail)
                               if avail else 1.0),
            tenants_below_floor=below,
            availability_floor=self._floor,
            moves_executed=sum(tr.moves_executed
                               for tr in self._trackers.values()),
            moves_failed=sum(tr.moves_failed
                             for tr in self._trackers.values()),
            violation_s=sum(tr.violation_s(t)
                            for tr in self._trackers.values()),
            worst_tenant=worst,
            per_tenant=({k: tr.summary(t)
                         for k, tr in self._trackers.items()}
                        if per_tenant else {}),
        )

    def publish(self, now: Optional[float] = None) -> None:
        """Write the fleet gauges (collector-compatible, like
        :meth:`SloTracker.publish`)."""
        rec = self._rec if self._rec is not None else get_recorder()
        s = self.summary(now, per_tenant=False)
        rec.set_gauge("fleet.tenants", float(s.tenants))
        rec.set_gauge("slo.fleet_availability_min", s.availability_min)
        rec.set_gauge("slo.fleet_availability_mean", s.availability_mean)
        rec.set_gauge("slo.fleet_tenants_below_floor",
                      float(s.tenants_below_floor))
        rec.set_gauge("slo.fleet_violation_seconds", s.violation_s)
