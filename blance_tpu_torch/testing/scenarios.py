# Copied from blance_tpu/testing/scenarios.py.
"""Scenario DSL for the continuous-rebalance simulator.

A :class:`SimScenario` is a fully DECLARATIVE description of one run of
cluster life: the initial topology (nodes across zones, partitions,
replica count), a seeded trace of timed :class:`SimEvent`s (each one a
:class:`~blance_tpu_torch.rebalance.ClusterDelta` — joins, graceful
decommissions, abrupt spot preemptions, zone outages, hot-tenant weight
drift), the mover fault profiles (``orchestrate.faults.NodeFaults``,
SHA-seeded so flakes replay bit-identically), and the SLO floor the run
is scored against.  ``testing/simulate.py`` executes it under the
``DeterministicLoop`` virtual clock.

Determinism contract: builders derive every stochastic choice from
``random.Random(seed)`` at BUILD time — the scenario object is the
complete script, and running it twice (or on another machine) replays
the same cluster life bit-for-bit (docs/SIMULATOR.md).

The registry at the bottom maps scenario-family names to builders
taking a seed — the CI ``sim-smoke`` matrix is 3 fixed seeds x three
families, plus the ``slow``-marked 7-virtual-day ``mixed_week``.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Mapping

from ..core.types import Partition, PartitionMap, PartitionModel, model
from ..orchestrate.faults import NodeFaults
from ..rebalance import ClusterDelta

__all__ = [
    "SimEvent",
    "SimScenario",
    "initial_map",
    "scenario_model",
    "spot_preemption",
    "zone_flap",
    "weight_drift",
    "hetero_drain",
    "mixed_week",
    "SCENARIOS",
    "CrashScenario",
    "crash_smoke",
    "crash_storm",
    "CRASH_SCENARIOS",
    "FleetTenant",
    "FleetEvent",
    "FleetScenario",
    "fleet_zone_outage",
    "fleet_onboarding",
    "fleet_noisy_neighbor",
    "fleet_week",
    "FLEET_SCENARIOS",
]


@dataclass(frozen=True)
class SimEvent:
    """One timed cluster delta in a scenario trace.

    ``outage=True`` marks a SCRIPTED loss window: availability is
    allowed to drop from this event until the control loop's next
    quiesce.  Any availability drop OUTSIDE such a window is a
    simulator invariant violation (lost primaries nobody scripted)."""

    t: float
    delta: ClusterDelta
    label: str = ""
    outage: bool = False


@dataclass(frozen=True)
class SimScenario:
    """A complete, self-describing simulator run (see module doc)."""

    name: str
    seed: int
    horizon_s: float
    nodes: tuple[str, ...]
    partitions: int
    replicas: int = 1
    events: tuple[SimEvent, ...] = ()
    availability_floor: float = 0.85
    # Mover fault profiles (orchestrate/faults.py), keyed by node; the
    # FaultPlan seed is the scenario seed.
    fault_nodes: Mapping[str, NodeFaults] = field(default_factory=dict)
    # Virtual per-batch data-plane latency: base for every node, plus
    # per-node overrides (slow movers).
    base_latency_s: float = 2.0
    node_latency_s: Mapping[str, float] = field(default_factory=dict)
    # Control-loop knobs.
    debounce_s: float = 1.0
    move_timeout_s: float = 120.0
    max_retries: int = 3
    backoff_base_s: float = 1.0
    quarantine_after: int = 5
    probe_after_s: float = 86_400.0  # quarantine is terminal unless re-added
    max_passes_per_cycle: int = 8
    use_session: bool = False
    backend: str = "greedy"
    max_steps: int = 4_000_000
    # Moves fed per node per batch (OrchestratorOptions.
    # max_concurrent_partition_moves_per_node — the scheduler's lane
    # count per machine).
    max_concurrent_moves: int = 1
    # Move-ordering policy: "legacy" (the reference app-weight order)
    # or "critical_path" (orchestrate/sched.CriticalPathScheduler on a
    # prior-seeded CostModel learning online from the run's own spans).
    # Same deltas, same planner, same move SET either way — only the
    # order and the clock differ (docs/SCHEDULER.md).
    scheduler: str = "legacy"


def scenario_model(scn: SimScenario) -> PartitionModel:
    """primary(+replicas) model for a scenario."""
    if scn.replicas > 0:
        return model(primary=(0, 1), replica=(1, scn.replicas))
    return model(primary=(0, 1))


def initial_map(scn: SimScenario) -> PartitionMap:
    """Deterministic round-robin seed placement: partition i's primary
    on node i mod N, replicas on the next distinct nodes — balanced,
    zone-striped (node order interleaves zones), no RNG involved."""
    nodes = list(scn.nodes)
    n = len(nodes)
    out: PartitionMap = {}
    for i in range(scn.partitions):
        name = f"p{i:04d}"
        nbs: dict[str, list[str]] = {"primary": [nodes[i % n]]}
        if scn.replicas > 0:
            nbs["replica"] = [nodes[(i + 1 + r) % n]
                              for r in range(scn.replicas)]
        out[name] = Partition(name, nbs)
    return out


def _zone_nodes(zones: int, per_zone: int) -> tuple[str, ...]:
    """z0n0, z1n0, z2n0, z0n1, ... — zone-striped so round-robin seed
    placement spreads replicas across zones."""
    return tuple(f"z{z}n{i}" for i in range(per_zone)
                 for z in range(zones))


def _jitter(rng: random.Random, t: float, spread: float) -> float:
    """Deterministic +-spread jitter, quantized to ms so event-log
    timestamps stay platform-stable text."""
    return round(t + rng.uniform(-spread, spread), 3)


# -- scenario families --------------------------------------------------------


def spot_preemption(seed: int = 11) -> SimScenario:
    """Bulk simultaneous spot kills: ~a third of the fleet vanishes in
    ONE delta, replacements join later, then a graceful decommission —
    the cloud-capacity churn staple."""
    rng = random.Random(f"spot:{seed}")
    nodes = _zone_nodes(3, 4)  # 12 nodes
    victims = tuple(sorted(rng.sample(nodes, 4)))
    replacements = tuple(f"r{i}" for i in range(4))
    retire = rng.choice([n for n in nodes if n not in victims])
    events = (
        SimEvent(t=_jitter(rng, 300, 30),
                 delta=ClusterDelta(fail=victims),
                 label="spot-preemption", outage=True),
        SimEvent(t=_jitter(rng, 1200, 60),
                 delta=ClusterDelta(add=replacements),
                 label="replacements-join"),
        SimEvent(t=_jitter(rng, 2400, 60),
                 delta=ClusterDelta(remove=(retire,)),
                 label="graceful-retire"),
    )
    return SimScenario(
        name="spot_preemption", seed=seed, horizon_s=3600.0,
        nodes=nodes, partitions=48, replicas=1, events=events,
        availability_floor=0.6)


def zone_flap(seed: int = 23) -> SimScenario:
    """Rolling zone outages: each zone goes dark and comes back in
    turn, with overlap (the next zone fails before the previous
    recovery fully drains) and a flaky mover in the surviving set."""
    rng = random.Random(f"flap:{seed}")
    zones, per_zone = 3, 4
    nodes = _zone_nodes(zones, per_zone)
    by_zone = {z: tuple(n for n in nodes if n.startswith(f"z{z}"))
               for z in range(zones)}
    flaky = by_zone[2][-1]
    events: list[SimEvent] = []
    t = 600.0
    for z in range(zones):
        down = _jitter(rng, t, 30)
        events.append(SimEvent(
            t=down, delta=ClusterDelta(fail=by_zone[z]),
            label=f"zone-z{z}-outage", outage=True))
        # The zone returns while the NEXT zone's outage may already be
        # in flight — overlapping deltas are the point.
        events.append(SimEvent(
            t=_jitter(rng, down + 900, 30),
            delta=ClusterDelta(add=by_zone[z]),
            label=f"zone-z{z}-returns"))
        t += 1100.0
    return SimScenario(
        name="zone_flap", seed=seed, horizon_s=5400.0,
        nodes=nodes, partitions=48, replicas=1,
        events=tuple(events), availability_floor=0.5,
        fault_nodes={flaky: NodeFaults(fail_rate=0.2)},
        quarantine_after=8)


def weight_drift(seed: int = 37) -> SimScenario:
    """Hot-tenant weight drift, no faults: waves of partitions heat up
    (weight 1 -> 8) and cool back down, each wave a replan the loop
    must absorb without ever dropping availability."""
    rng = random.Random(f"drift:{seed}")
    nodes = _zone_nodes(2, 4)  # 8 nodes
    partitions = 32
    events: list[SimEvent] = []
    hot: list[str] = []
    t = 300.0
    for _wave in range(4):
        cooled = {p: 1 for p in hot}
        hot = sorted(rng.sample([f"p{i:04d}" for i in range(partitions)],
                                partitions // 8))
        heated = {p: 8 for p in hot}
        events.append(SimEvent(
            t=_jitter(rng, t, 20),
            delta=ClusterDelta(partition_weights={**cooled, **heated}),
            label="hot-tenant-wave"))
        t += 700.0
    return SimScenario(
        name="weight_drift", seed=seed, horizon_s=3600.0,
        nodes=nodes, partitions=partitions, replicas=1,
        events=tuple(events), availability_floor=0.999)


def hetero_drain(seed: int = 41) -> SimScenario:
    """Heterogeneous mover latencies with ONE slow node, drained into
    capacity joins: the critical-path scheduling showcase (docs/SCHEDULER.md).

    Every join pulls a near-uniform slice of placements onto the empty
    joiner — chains of ``[add(joiner), del(source)]`` whose level-0
    adds all CONTEND for the joiner's single lane while the del tails
    cost whatever their source node costs.  The makespan is therefore
    decided by WHEN the slow node's del chains start: app-weight order
    is blind to the tails (every add weighs 3, ties break on partition
    name), so the slow chain's add lands anywhere in the joiner's
    serial queue; critical-path order feeds the highest-upward-rank
    (slowest-tail) chains first.  The first join doubles as the cost
    model's calibration pass (every node executes a del, teaching its
    latency); the two joins after it are the measured incidents.  No
    faults: both orders execute the identical move set, so churn is
    exactly equal and only the clock differs."""
    rng = random.Random(f"hetero:{seed}")
    nodes = tuple(f"n{i}" for i in range(12))
    lat: dict[str, float] = {
        n: round(rng.choice([0.5, 1.0, 1.5, 2.0]), 3) for n in nodes}
    # One badly slow mover plus two laggards: the del tails the
    # critical path must order longest-first (LPT) off the joiner.
    lat[nodes[-1]] = 16.0
    lat[nodes[-2]] = 12.0
    lat[nodes[-3]] = 9.0
    for joiner in ("w0", "r0", "r1"):
        lat[joiner] = 1.0
    events = (
        SimEvent(t=_jitter(rng, 120, 10),
                 delta=ClusterDelta(add=("w0",)),
                 label="warmup-join-w0"),
        SimEvent(t=_jitter(rng, 1200, 30),
                 delta=ClusterDelta(add=("r0",)),
                 label="join-r0"),
        SimEvent(t=_jitter(rng, 2400, 30),
                 delta=ClusterDelta(add=("r1",)),
                 label="join-r1"),
    )
    return SimScenario(
        name="hetero_drain", seed=seed, horizon_s=3600.0,
        nodes=nodes, partitions=96, replicas=1, events=events,
        availability_floor=0.999, base_latency_s=1.0,
        node_latency_s=lat, max_retries=0, quarantine_after=0,
        max_concurrent_moves=1)


def mixed_week(seed: int = 7, days: float = 7.0) -> SimScenario:
    """The long-horizon soak: ``days`` of virtual cluster life mixing
    every fault family — daily join/decommission churn, two spot
    preemption bursts, a zone flap, hot-tenant waves, plus
    deliberately OVERLAPPING deltas (a second event a few virtual
    seconds after the first, landing mid-rebalance to exercise the
    supersede path).  >= 20 deltas at the default horizon."""
    rng = random.Random(f"week:{seed}")
    nodes = _zone_nodes(3, 4)
    partitions = 48
    horizon = days * 86_400.0
    day = 86_400.0
    events: list[SimEvent] = []
    spare = [f"s{i}" for i in range(16)]  # standby capacity to rotate in
    in_cluster = list(nodes)

    def take_spare() -> str:
        return spare.pop(0)

    # Daily churn: one join + one graceful decommission per day, a few
    # virtual minutes apart.
    for d in range(int(days)):
        base = d * day
        join = take_spare()
        t_join = _jitter(rng, base + 0.25 * day, 1800)
        events.append(SimEvent(
            t=t_join, delta=ClusterDelta(add=(join,)),
            label=f"day{d}-join"))
        in_cluster.append(join)
        retire = rng.choice(sorted(in_cluster))
        in_cluster.remove(retire)
        # Overlap: the decommission lands seconds after the join's
        # rebalance began — a supersede, not a fresh cycle.
        events.append(SimEvent(
            t=round(t_join + rng.uniform(5.0, 30.0), 3),
            delta=ClusterDelta(remove=(retire,)),
            label=f"day{d}-retire-overlapping"))
    # Two spot bursts.
    for burst, when in enumerate((1.4 * day, 4.6 * day)):
        victims = tuple(sorted(rng.sample(sorted(in_cluster), 3)))
        for v in victims:
            in_cluster.remove(v)
        t_kill = _jitter(rng, when, 3600)
        events.append(SimEvent(
            t=t_kill, delta=ClusterDelta(fail=victims),
            label=f"spot-burst-{burst}", outage=True))
        repl = tuple(take_spare() for _ in range(3))
        in_cluster.extend(repl)
        events.append(SimEvent(
            t=_jitter(rng, t_kill + 0.1 * day, 600),
            delta=ClusterDelta(add=repl),
            label=f"spot-burst-{burst}-replacements"))
    # One zone flap mid-week (whichever z1 originals are still in).
    z1 = tuple(n for n in sorted(in_cluster) if n.startswith("z1"))
    if z1:
        t_down = _jitter(rng, 3.2 * day, 3600)
        events.append(SimEvent(
            t=t_down, delta=ClusterDelta(fail=z1),
            label="zone-z1-outage", outage=True))
        events.append(SimEvent(
            t=_jitter(rng, t_down + 0.05 * day, 600),
            delta=ClusterDelta(add=z1), label="zone-z1-returns"))
    # Hot-tenant waves every other day.
    hot: list[str] = []
    for w in range(3):
        cooled = {p: 1 for p in hot}
        hot = sorted(rng.sample([f"p{i:04d}" for i in range(partitions)],
                                6))
        events.append(SimEvent(
            t=_jitter(rng, (2 * w + 0.8) * day, 3600),
            delta=ClusterDelta(
                partition_weights={**cooled, **{p: 8 for p in hot}}),
            label=f"hot-wave-{w}"))
    events.sort(key=lambda e: (e.t, e.label))
    return SimScenario(
        name="mixed_week", seed=seed, horizon_s=horizon,
        nodes=nodes, partitions=partitions, replicas=1,
        events=tuple(events), availability_floor=0.6,
        fault_nodes={"z0n3": NodeFaults(fail_rate=0.1)},
        quarantine_after=8, max_steps=8_000_000)


# Scenario-family registry: name -> builder(seed).  The CI sim-smoke
# matrix crosses the first three with its fixed seeds; mixed_week is
# the slow-marked long-horizon soak.
SCENARIOS: dict[str, Callable[[int], SimScenario]] = {
    "spot_preemption": spot_preemption,
    "zone_flap": zone_flap,
    "weight_drift": weight_drift,
    "hetero_drain": hetero_drain,
    "mixed_week": mixed_week,
}


# -- crash scenarios (blance_tpu_torch/testing/crashsim.py) -------------------------
#
# A CrashScenario scripts controller process deaths on top of a small
# SimScenario: ``crashes[i]`` is the journal-record boundary life i
# dies at (a life past the end of the chain runs crash-free).  The
# crash harness recovers each death from the WAL and asserts the run
# still converges to the crash-free reference's final map
# bit-identically (docs/DURABILITY.md "Crash injection").


@dataclass(frozen=True)
class CrashScenario:
    """A cluster life plus its scripted crash chain."""

    name: str
    seed: int
    base: SimScenario
    crashes: tuple[int, ...]
    snapshot_every: int = 0
    rotate_records: int = 64


def crash_smoke(seed: int = 17) -> SimScenario:
    """The bounded-exhaustive crash target: a DELIBERATELY small life
    (one outage, one return, one graceful retire — every membership
    fold path) so crashing at every journal-record boundary stays a
    smoke-test-sized matrix."""
    rng = random.Random(f"crash:{seed}")
    nodes = ("n0", "n1", "n2", "n3")
    events = (
        SimEvent(t=_jitter(rng, 60, 5),
                 delta=ClusterDelta(fail=("n1",)),
                 label="fail-n1", outage=True),
        SimEvent(t=_jitter(rng, 180, 5),
                 delta=ClusterDelta(add=("n1",)),
                 label="return-n1"),
        SimEvent(t=_jitter(rng, 300, 5),
                 delta=ClusterDelta(remove=("n0",)),
                 label="retire-n0"),
    )
    return SimScenario(
        name="crash_smoke", seed=seed, horizon_s=480.0,
        nodes=nodes, partitions=8, replicas=1, events=events,
        availability_floor=0.5, base_latency_s=1.0, debounce_s=0.5,
        move_timeout_s=30.0, max_retries=0, quarantine_after=0)


def crash_storm(seed: int = 19) -> CrashScenario:
    """Repeated controller crash-restarts landing mid-incident: the
    first death falls inside the outage's converge cycle, the second
    inside the window where a graceful retire OVERLAPS the outage
    rebalance (a supersede in flight), the third late in the life.
    Snapshots are on, so later recoveries exercise the snapshot
    fast-forward + post-snapshot replay path, not just raw folds."""
    rng = random.Random(f"storm:{seed}")
    nodes = _zone_nodes(2, 3)  # 6 nodes
    t_fail = _jitter(rng, 90, 5)
    events = (
        SimEvent(t=t_fail, delta=ClusterDelta(fail=(nodes[0],)),
                 label="zone-fail", outage=True),
        # The retire lands seconds into the outage rebalance — a
        # supersede, not a fresh cycle (mixed_week's overlap pattern).
        SimEvent(t=round(t_fail + rng.uniform(2.0, 6.0), 3),
                 delta=ClusterDelta(remove=(nodes[1],)),
                 label="retire-overlapping"),
        SimEvent(t=_jitter(rng, 300, 10),
                 delta=ClusterDelta(add=(nodes[0],)),
                 label="zone-returns"),
        SimEvent(t=_jitter(rng, 420, 10),
                 delta=ClusterDelta(partition_weights={"p0000": 8}),
                 label="hot-partition"),
    )
    base = SimScenario(
        name="crash_storm", seed=seed, horizon_s=600.0,
        nodes=nodes, partitions=12, replicas=1, events=events,
        availability_floor=0.5, base_latency_s=1.0, debounce_s=0.5,
        move_timeout_s=30.0, max_retries=0, quarantine_after=0)
    # Boundaries drawn at build time (determinism contract): the first
    # two land inside the incident/supersede convergence records, the
    # third well into the recovered life's tail.
    crashes = (rng.randint(6, 10), rng.randint(10, 16),
               rng.randint(22, 30))
    return CrashScenario(
        name="crash_storm", seed=seed, base=base, crashes=crashes,
        snapshot_every=8)


# Crash scenario-family registry: name -> builder(seed).
CRASH_SCENARIOS: dict[str, Callable[[int], CrashScenario]] = {
    "crash_storm": crash_storm,
}


# -- multi-tenant fleet scenarios (blance_tpu_torch/fleetloop.py) -------------------
#
# A FleetScenario scripts N tenant indexes over ONE shared node fleet —
# the cbgt/FTS production shape.  Events either fan to every onboarded
# tenant (tenants=(): correlated membership changes — a zone outage is
# ONE event hitting all loops at once) or target specific tenants
# (per-tenant weight drift: the noisy neighbor).  Tenants with
# onboard_t > 0 join mid-run with EMPTY placements and converge from
# nothing (staggered onboarding).  testing/fleetsim.py executes a
# scenario under the DeterministicLoop; the same seed replays the whole
# fleet's week bit-identically (docs/SIMULATOR.md "Multi-tenant
# scenario families").


@dataclass(frozen=True)
class FleetTenant:
    """One tenant index in a fleet scenario.  ``onboard_t == 0`` means
    present from the start with round-robin seed placements; ``> 0``
    means the tenant onboards mid-run with empty placements and its
    first converge cycle places everything."""

    key: str
    partitions: int
    replicas: int = 1
    onboard_t: float = 0.0


@dataclass(frozen=True)
class FleetEvent:
    """One timed delta in a fleet trace.  ``tenants == ()`` fans the
    delta to every onboarded tenant (correlated membership events);
    otherwise it targets exactly the named tenants (weight drift)."""

    t: float
    delta: ClusterDelta
    tenants: tuple[str, ...] = ()
    label: str = ""
    outage: bool = False


@dataclass(frozen=True)
class FleetScenario:
    """A complete multi-tenant simulator run (module comment above)."""

    name: str
    seed: int
    horizon_s: float
    nodes: tuple[str, ...]
    tenants: tuple[FleetTenant, ...]
    events: tuple[FleetEvent, ...] = ()
    availability_floor: float = 0.85
    # Virtual per-batch data-plane latency (shared by every tenant).
    base_latency_s: float = 2.0
    node_latency_s: Mapping[str, float] = field(default_factory=dict)
    # Control-loop + plan-service knobs.
    debounce_s: float = 1.0
    admission_window_s: float = 0.25
    fair_share: "int | None" = None
    carry_bytes: "int | None" = None  # None = unbounded (identity runs)
    carry_entries: "int | None" = None
    max_passes_per_cycle: int = 8
    max_steps: int = 20_000_000


def _fleet_tenants(rng: random.Random, n: int,
                   choices: "tuple[int, ...]",
                   onboard: Callable[[int], float]) -> tuple[
                       FleetTenant, ...]:
    """Tenant specs with partition counts drawn from a SMALL choice
    set: at cbgt-index sizes the shape buckets step finely, so free
    size choice would give nearly every tenant its own compiled
    program — a handful of bucket-exact sizes keeps the whole fleet on
    a couple of shared programs (the GSPMD-bucketing point)."""
    return tuple(
        FleetTenant(key=f"t{i:03d}",
                    partitions=rng.choice(choices),
                    replicas=1, onboard_t=onboard(i))
        for i in range(n))


def fleet_zone_outage(seed: int = 5, tenants: int = 8,
                      partitions: "tuple[int, ...]" = (12, 16),
                      ) -> FleetScenario:
    """Correlated zone outage: one zone's nodes fail for EVERY tenant
    at once — N coalesced converge cycles through a handful of fleet
    dispatches — then return; two tenants heat up afterwards.

    ``partitions`` overrides the tenant-size choice set (bench's
    encode-residency A/B uses bigger tenants so the host-encode share
    is visible); the default reproduces the committed traces."""
    rng = random.Random(f"fzone:{seed}:{tenants}")
    nodes = _zone_nodes(3, 4)
    z1 = tuple(n for n in nodes if n.startswith("z1"))
    ts = _fleet_tenants(rng, tenants, partitions, lambda i: 0.0)
    hot = sorted(rng.sample([t.key for t in ts], min(2, tenants)))
    t_down = _jitter(rng, 600, 30)
    events = [
        FleetEvent(t=t_down, delta=ClusterDelta(fail=z1),
                   label="zone-z1-outage", outage=True),
        FleetEvent(t=_jitter(rng, t_down + 1200, 30),
                   delta=ClusterDelta(add=z1),
                   label="zone-z1-returns"),
    ]
    for i, key in enumerate(hot):
        events.append(FleetEvent(
            t=_jitter(rng, 2400 + 120 * i, 20),
            delta=ClusterDelta(partition_weights={"p0000": 8, "p0001": 8}),
            tenants=(key,), label=f"hot-tenant-{key}"))
    events.sort(key=lambda e: (e.t, e.label))
    return FleetScenario(
        name="fleet_zone_outage", seed=seed, horizon_s=3600.0,
        nodes=nodes, tenants=ts, events=tuple(events),
        availability_floor=0.5)


def fleet_onboarding(seed: int = 13, tenants: int = 12) -> FleetScenario:
    """Staggered tenant onboarding: a third of the fleet is live at t0,
    the rest join over the first half of the horizon (each converging
    from empty placements), then one graceful node retirement drains
    across every live tenant."""
    rng = random.Random(f"fonboard:{seed}:{tenants}")
    # Same node fleet + size choices as fleet_zone_outage: every smoke
    # family shares the same two compiled bucket classes.
    nodes = _zone_nodes(3, 4)
    head = max(tenants // 3, 1)

    def onboard(i: int) -> float:
        if i < head:
            return 0.0
        return _jitter(rng, 300 + (i - head) * (1500 / max(
            tenants - head, 1)), 20)

    ts = _fleet_tenants(rng, tenants, (12, 16), onboard)
    retire = rng.choice(sorted(nodes))
    events = (
        FleetEvent(t=_jitter(rng, 2600, 30),
                   delta=ClusterDelta(remove=(retire,)),
                   label=f"graceful-retire-{retire}"),
    )
    return FleetScenario(
        name="fleet_onboarding", seed=seed, horizon_s=3600.0,
        nodes=nodes, tenants=ts, events=events,
        availability_floor=0.85)


def fleet_noisy_neighbor(seed: int = 29,
                         tenants: int = 10) -> FleetScenario:
    """Noisy-neighbor churn: one chatty tenant submits a weight-drift
    delta every few virtual seconds for a long stretch while its
    neighbors ride out a node fail/return — with ``fair_share`` set,
    the chatty tenant cannot fill the coalescing windows
    (``fleet.starved_admissions`` counts its deferrals) and the
    neighbors' converge cycles stay prompt."""
    rng = random.Random(f"fnoisy:{seed}:{tenants}")
    # Same node fleet + size choices as fleet_zone_outage (shared
    # compiled classes across the smoke families).
    nodes = _zone_nodes(3, 4)
    ts = _fleet_tenants(rng, tenants, (12, 16), lambda i: 0.0)
    noisy = ts[0].key
    events: list[FleetEvent] = []
    t = 200.0
    for wave in range(24):
        p = rng.randrange(ts[0].partitions)
        events.append(FleetEvent(
            t=round(t, 3),
            delta=ClusterDelta(
                partition_weights={f"p{p:04d}": rng.choice([1, 4, 8])}),
            tenants=(noisy,), label=f"noisy-wave-{wave:02d}"))
        t += rng.uniform(8.0, 20.0)
    victim = nodes[-1]
    events.append(FleetEvent(
        t=_jitter(rng, 900, 20), delta=ClusterDelta(fail=(victim,)),
        label=f"fail-{victim}", outage=True))
    events.append(FleetEvent(
        t=_jitter(rng, 1800, 20), delta=ClusterDelta(add=(victim,)),
        label=f"return-{victim}"))
    events.sort(key=lambda e: (e.t, e.label))
    return FleetScenario(
        name="fleet_noisy_neighbor", seed=seed, horizon_s=2700.0,
        nodes=nodes, tenants=ts, events=tuple(events),
        availability_floor=0.5, fair_share=2,
        admission_window_s=0.5)


def fleet_week(seed: int = 3, tenants: int = 240,
               days: float = 7.0) -> FleetScenario:
    """The fleet soak: a multi-hundred-tenant virtual week mixing every
    family — staggered onboarding over the first two days, a
    correlated zone outage on day 3 hitting ALL tenants at once, a
    two-node spot burst on day 5, and rotating noisy-neighbor weight
    waves throughout.  Replays bit-identically under the
    DeterministicLoop (the fleet tier's acceptance scenario)."""
    rng = random.Random(f"fweek:{seed}:{tenants}")
    nodes = _zone_nodes(3, 6)  # 18 nodes
    day = 86_400.0
    horizon = days * day
    head = max(tenants // 4, 1)

    def onboard(i: int) -> float:
        if i < head:
            return 0.0
        return _jitter(rng, 0.1 * day + (i - head) * (1.9 * day / max(
            tenants - head, 1)), 600)

    ts = _fleet_tenants(rng, tenants, (8, 12), onboard)
    events: list[FleetEvent] = []
    # Day 3: correlated zone outage (one event, every tenant's loop).
    z2 = tuple(n for n in nodes if n.startswith("z2"))
    t_down = _jitter(rng, 3.0 * day, 3600)
    events.append(FleetEvent(t=t_down, delta=ClusterDelta(fail=z2),
                             label="zone-z2-outage", outage=True))
    events.append(FleetEvent(t=_jitter(rng, t_down + 0.1 * day, 600),
                             delta=ClusterDelta(add=z2),
                             label="zone-z2-returns"))
    # Day 5: spot burst (two survivors of z0).
    victims = tuple(sorted(rng.sample(
        [n for n in nodes if n.startswith("z0")], 2)))
    t_kill = _jitter(rng, 5.0 * day, 3600)
    events.append(FleetEvent(t=t_kill, delta=ClusterDelta(fail=victims),
                             label="spot-burst", outage=True))
    events.append(FleetEvent(t=_jitter(rng, t_kill + 0.05 * day, 600),
                             delta=ClusterDelta(add=victims),
                             label="spot-burst-returns"))
    # Rotating noisy neighbors: every half-day, one tenant heats up.
    for w in range(int(days * 2)):
        key = rng.choice([t.key for t in ts[:head]])
        p = rng.randrange(6)
        events.append(FleetEvent(
            t=_jitter(rng, (w + 0.6) * 0.5 * day, 1800),
            delta=ClusterDelta(
                partition_weights={f"p{p:04d}": rng.choice([1, 4, 8])}),
            tenants=(key,), label=f"hot-wave-{w:02d}-{key}"))
    events.sort(key=lambda e: (e.t, e.label))
    return FleetScenario(
        name="fleet_week", seed=seed, horizon_s=horizon,
        nodes=nodes, tenants=ts, events=tuple(events),
        availability_floor=0.5, fair_share=4,
        max_steps=200_000_000)


# Fleet scenario-family registry: name -> builder(seed, tenants).  The
# CI fleet-sim smoke crosses fixed seeds with small tenant-scale
# points; fleet_week at multi-hundred tenants is the slow-marked soak.
FLEET_SCENARIOS: dict[str, Callable[..., FleetScenario]] = {
    "fleet_zone_outage": fleet_zone_outage,
    "fleet_onboarding": fleet_onboarding,
    "fleet_noisy_neighbor": fleet_noisy_neighbor,
    "fleet_week": fleet_week,
}
