"""The port's orchestrator and scheduler ranks against the JAX package, on
the CPU.

The rank sweep is compared bitwise with the reference's jitted scan.  The
orchestrator is the same host code in both packages: each run drives the
reference and the port on the same maps, options and (seeded) fault plan
under a DeterministicLoop of the reference's testing tier, with each
package's own recorder on the loop's virtual clock, and compares the op
log, the final progress counters and the achieved map.
"""

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import blance_tpu  # noqa: E402
import blance_tpu.obs as jobs  # noqa: E402
import blance_tpu.orchestrate as jorch  # noqa: E402
import blance_tpu_torch as bt  # noqa: E402
import blance_tpu_torch.obs as tobs  # noqa: E402
import blance_tpu_torch.orchestrate as torch_orch  # noqa: E402
from blance_tpu.orchestrate.sched import ranks as jranks  # noqa: E402
from blance_tpu.testing.sched import DeterministicLoop  # noqa: E402
from blance_tpu_torch.orchestrate.sched import ranks as tranks  # noqa: E402

STATES = dict(primary=(0, 1), replica=(1, 2))
NODES = [f"n{i}" for i in range(8)]
# (reference package, its obs, its orchestrate) and the port's.
REF = (blance_tpu, jobs, jorch)
PORT = (bt, tobs, torch_orch)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# --- rank sweep -------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1), (37, 5), (500, 9), (64, 33)])
def test_rank_levels_matches_jax(shape):
    """Bitwise on float32 costs of mixed magnitudes (so the order of the
    adds shows in the rounding)."""
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    costs = (rng.random(shape) * 10.0 ** rng.integers(-4, 4, shape)) \
        .astype(np.float32)
    costs[:, -1:][rng.random((shape[0], 1)) < 0.3] = 0.0  # padded tails
    want = np.asarray(jranks.rank_levels(jnp.asarray(costs)))
    got = tranks.rank_levels(torch.from_numpy(costs))
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.tobytes()


def _chains(seed, n_chains):
    rng = np.random.default_rng(seed)
    return [[float(c) for c in rng.random(int(rng.integers(0, 7))) * 3.0]
            for _ in range(n_chains)]


@pytest.mark.parametrize("side", ["host", "device"])
def test_upward_ranks_matches_reference(side):
    """Below the threshold both packages sum on the host in Python
    floats; at or past it both run the float32 sweep (the port on the
    CPU here)."""
    chains = _chains(3, 200)
    threshold = 10**9 if side == "host" else 0
    jrec, trec = jobs.Recorder(), tobs.Recorder()
    want = jranks.upward_ranks(chains, device_threshold=threshold,
                               recorder=jrec)
    got = tranks.upward_ranks(chains, device_threshold=threshold,
                              recorder=trec, device="cpu")
    assert got == want
    assert trec.counters == jrec.counters == {f"sched.{side}_ranks": 1}


def test_upward_ranks_device_side_asks_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tranks.upward_ranks([[1.0]], device_threshold=10) == [[1.0]]
    with pytest.raises(RuntimeError, match="is_available"):
        tranks.upward_ranks([[1.0]], device_threshold=0)


# --- orchestrate_moves, reference and port on the same loop schedule ---------------


def _maps(lib, seed, n_partitions=60):
    """Random regular maps over NODES: up to four distinct nodes per
    partition, at most one primary, the end map independent of the beg
    map (so every op kind occurs)."""
    rng = np.random.default_rng(seed)

    def one():
        pool = [NODES[i] for i in rng.permutation(len(NODES))[
            :int(rng.integers(1, 5))]]
        k = int(rng.integers(0, 2))
        return {"primary": pool[:k], "replica": pool[k:]}

    nbs = [(one(), one()) for _ in range(n_partitions)]
    beg = {str(i): lib.Partition(str(i), b) for i, (b, _) in enumerate(nbs)}
    end = {str(i): lib.Partition(str(i), e) for i, (_, e) in enumerate(nbs)}
    return beg, end


def _orchestrate(pkg, opts_kw, sched, faults, seed, nodes=NODES):
    """One orchestration with ``pkg``'s orchestrator on a fresh
    DeterministicLoop; returns (op log, final progress, achieved map as
    JSON, recorder counters)."""
    lib, obs, orch = pkg
    beg, end = _maps(lib, seed)
    log = []

    async def assign(stop_ch, node, partitions, states, ops):
        log.append((tuple(partitions), node, tuple(states), tuple(ops)))
        await asyncio.sleep(0)

    cb = assign
    if faults is not None:
        cb = orch.FaultPlan(seed=faults[0], nodes={
            n: orch.NodeFaults(**f) for n, f in faults[1].items()}).wrap(assign)
    kw = dict(opts_kw)
    if sched is not None:
        kind, skw = sched
        if lib is bt:
            skw = dict(skw, device="cpu")
        kw["scheduler"] = orch.CriticalPathScheduler(**skw)
    if lib is bt:
        kw["device"] = "cpu"
    options = orch.OrchestratorOptions(**kw)
    loop = DeterministicLoop()
    rec = obs.Recorder(clock=loop.time)

    async def main():
        o = orch.orchestrate_moves(lib.model(**STATES), options, nodes, beg,
                                   end, cb)
        last = None
        async for progress in o.progress_ch():
            last = progress
        o.stop()
        return o, last

    with obs.use_recorder(rec):
        o, last = loop.run_until_complete(main())
    fields = {f.name: getattr(last, f.name)
              for f in dataclasses.fields(last)}
    fields["errors"] = [str(e) for e in last.errors]
    achieved = lib.partition_map_to_json(o.achieved_map())
    return log, fields, achieved, dict(rec.counters), end


CASES = {
    "exact-host": (dict(), None, None),
    "throughput-host": (dict(interrupt_on_first_feed=False,
                             max_concurrent_partition_moves_per_node=2),
                        None, None),
    "exact-device": (dict(device_diff=True), None, None),
    "exact-host-favor-min": (dict(favor_min_nodes=True), None, None),
    "throughput-device-favor-min": (
        dict(device_diff=True, favor_min_nodes=True,
             interrupt_on_first_feed=False), None, None),
    "critical-path-host-ranks": (
        dict(interrupt_on_first_feed=False,
             max_concurrent_partition_moves_per_node=2),
        ("cp", {}), None),
    "critical-path-device-ranks": (
        dict(device_diff=True), ("cp", dict(device_threshold=0)), None),
    "faults-retry-quarantine": (
        dict(move_timeout_s=0.25, max_retries=2, quarantine_after=3,
             probe_after_s=600.0, interrupt_on_first_feed=False,
             device_diff=True),
        None, (7, {"n1": dict(fail_rate=0.3), "n5": dict(dead=True)})),
    "faults-critical-path-heal": (
        dict(move_timeout_s=0.25, max_retries=1, quarantine_after=1,
             probe_after_s=0.0),
        ("cp", {}), (9, {"n2": dict(dead=True, heal_after=2)})),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_orchestrate_matches_reference(case, seed):
    opts_kw, sched, faults = CASES[case]
    want = _orchestrate(REF, opts_kw, sched, faults, seed)
    got = _orchestrate(PORT, opts_kw, sched, faults, seed)
    log, fields, achieved, counters, end = got
    assert log == want[0]
    assert fields == want[1]
    assert achieved == want[2]
    assert counters == want[3]
    assert log, "no batch ran"
    if faults is None:
        # A clean run reaches the end map (slot order within a state aside).
        assert not fields["errors"]
        assert _placed(achieved) == _placed(bt.partition_map_to_json(end))
    else:
        assert fields["tot_move_failures"] > 0 or \
            fields["tot_mover_assign_partition_retry"] > 0


def _placed(pmap_json):
    return {name: {s: sorted(ns) for s, ns in p["nodesByState"].items() if ns}
            for name, p in pmap_json.items()}
