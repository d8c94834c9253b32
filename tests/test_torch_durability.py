"""The port's durability tier (journal, recovery) against the reference's.

Two kinds of check, on the CPU:

- every case of the reference's ``tests/test_durability.py`` (none of
  them needs jax) runs again with its module names bound to the port's
  modules: the same assertions hold of the port's copies;
- a fleet of control loops with a journal runs through both packages,
  each on its own package's deterministic event loop: the journal segments are
  byte-identical, and ``recover`` and ``resume_tenant`` give equal
  state and equal resumed maps.
"""

import asyncio
import inspect
import os
import types

import pytest

pytest.importorskip("jax")  # the reference package imports it

import blance_tpu  # noqa: E402
import blance_tpu.durability as jdur  # noqa: E402
import blance_tpu.fleetloop as jfleetloop  # noqa: E402
import blance_tpu.obs as jobs  # noqa: E402
from blance_tpu.rebalance import ClusterDelta as JDelta  # noqa: E402
import blance_tpu.testing.sched as jsched  # noqa: E402

import blance_tpu_torch as bt  # noqa: E402
import blance_tpu_torch.durability as tdur  # noqa: E402
import blance_tpu_torch.fleetloop as tfleetloop  # noqa: E402
import blance_tpu_torch.obs as tobs  # noqa: E402
from blance_tpu_torch.durability import epoch as t_epoch  # noqa: E402
from blance_tpu_torch.durability import journal as t_journal  # noqa: E402
from blance_tpu_torch.obs.slo import SloTracker  # noqa: E402
from blance_tpu_torch.orchestrate import health as t_health  # noqa: E402
from blance_tpu_torch.rebalance import ClusterDelta as TDelta  # noqa: E402
from blance_tpu_torch.testing import sched as tsched  # noqa: E402
from blance_tpu_torch.utils import atomicio as t_atomicio  # noqa: E402

import test_durability as ref_cases  # noqa: E402


def rebind(module, bindings):
    """The reference test module's functions and classes as copies whose
    globals (and their helpers') resolve ``bindings`` first: the
    reference's cases run on the port's modules.  Module constants
    built at import time from a reference module must be in
    ``bindings`` too."""
    g = dict(vars(module))
    g.update(bindings)

    def copy_fn(fn):
        return types.FunctionType(fn.__code__, g, fn.__name__,
                                  fn.__defaults__, fn.__closure__)

    for name, obj in list(g.items()):
        if getattr(obj, "__module__", None) != module.__name__:
            continue
        if isinstance(obj, types.FunctionType):
            g[name] = copy_fn(obj)
        elif isinstance(obj, type):
            body = {k: copy_fn(v) if isinstance(v, types.FunctionType)
                    else v for k, v in vars(obj).items()
                    if k not in ("__dict__", "__weakref__")}
            g[name] = type(obj.__name__, obj.__bases__, body)
    return g


def call_with_fixtures(fn, request):
    """Call ``fn`` with each parameter taken from the pytest fixture of
    that name; coroutines run to completion."""
    kwargs = {name: request.getfixturevalue(name)
              for name in inspect.signature(fn).parameters}
    out = fn(**kwargs)
    if inspect.iscoroutine(out):
        asyncio.run(out)


PORT = rebind(ref_cases, {
    "Partition": bt.Partition,
    "EPOCH_FILE": t_epoch.EPOCH_FILE,
    "EpochFence": t_epoch.EpochFence,
    "fence_for": t_epoch.fence_for,
    "reset_fences": t_epoch.reset_fences,
    "Journal": t_journal.Journal,
    "encode_record": t_journal.encode_record,
    "list_segments": t_journal.list_segments,
    "map_digest": t_journal.map_digest,
    "read_journal": t_journal.read_journal,
    "read_segment": t_journal.read_segment,
    "recover": tdur.recover,
    "Recorder": tobs.Recorder,
    "use_recorder": tobs.use_recorder,
    "SloTracker": SloTracker,
    "HALF_OPEN": t_health.HALF_OPEN,
    "HEALTHY": t_health.HEALTHY,
    "QUARANTINED": t_health.QUARANTINED,
    "HealthTracker": t_health.HealthTracker,
    "atomic_write_json": t_atomicio.atomic_write_json,
    "atomic_write_text": t_atomicio.atomic_write_text,
})

CASES = sorted(n for n in vars(ref_cases) if n.startswith("test_"))


@pytest.fixture(autouse=True)
def _durability_env(monkeypatch):
    """fsync off (the reference tests' speed valve) and both packages'
    process-level fence registries cleared around every test."""
    monkeypatch.setenv("BLANCE_WAL_FSYNC", "0")
    jdur.reset_fences()
    tdur.reset_fences()
    yield
    jdur.reset_fences()
    tdur.reset_fences()


@pytest.mark.parametrize("case", CASES)
def test_reference_durability_case_on_port(case, request):
    call_with_fixtures(PORT[case], request)


def test_port_durability_exports_the_reference_surface():
    assert sorted(tdur.__all__) == sorted(jdur.__all__)
    assert tdur.JOURNAL_FORMAT_VERSION == jdur.JOURNAL_FORMAT_VERSION


# -- a journaled fleet through both packages ----------------------------------

NODES = [f"n{i}" for i in range(12)]


def _cluster(lib, seed):
    pmap = {}
    for i in range(12):
        p = f"p{i:03d}"
        pmap[p] = lib.Partition(p, {
            "primary": [NODES[(i + seed) % 12]],
            "replica": [NODES[(i + seed + 1 + i % 3) % 12]]})
    return pmap


def _nbs(pmap):
    return {k: {s: list(ns) for s, ns in p.nodes_by_state.items()}
            for k, p in pmap.items()}


PKGS = {
    "ref": dict(lib=blance_tpu, obs=jobs, dur=jdur, fleet=jfleetloop,
                delta=JDelta, sched=jsched, kw={}),
    "port": dict(lib=bt, obs=tobs, dur=tdur, fleet=tfleetloop,
                 delta=TDelta, sched=tsched, kw={"device": "cpu"}),
}


def _journaled_fleet(pkg, jdir):
    """Two tenants with a journal: a node failure, quiesce, stop, then a
    second life recovered from the journal with a weight delta."""
    lib, obs, dur = pkg["lib"], pkg["obs"], pkg["dur"]
    m = lib.model(primary=(0, 1), replica=(1, 1))
    log = []

    async def assign(stop_ch, node, partitions, states, ops):
        log.append((node, tuple(partitions), tuple(states), tuple(ops)))
        await asyncio.sleep(0.01)

    sched = pkg["sched"]
    loop = sched.DeterministicLoop(sched.FifoPolicy(), max_steps=500_000)
    rec = obs.Recorder(clock=loop.time)

    async def first_life():
        j = dur.Journal(jdir, clock=loop.time, snapshot_every=6)
        fc = pkg["fleet"].FleetController(
            NODES, inline_solve=True, recorder=rec, journal=j, **pkg["kw"])
        await fc.start()
        for i, key in enumerate(("ta", "tb")):
            fc.add_tenant(key, m, _cluster(lib, i), assign)
        fc.submit_all(pkg["delta"](fail=("n0",)))
        maps = await fc.quiesce_all()
        await fc.stop()
        j.close()
        return {k: _nbs(v) for k, v in maps.items()}

    with obs.use_recorder(rec):
        first = loop.run_until_complete(first_life())

    loop2 = sched.DeterministicLoop(sched.FifoPolicy(), max_steps=500_000)
    rec2 = obs.Recorder(clock=loop2.time)

    async def second_life():
        st = dur.recover(jdir, clock=loop2.time)
        folded = {k: (_nbs(t.pmap), sorted(t.nodes), sorted(t.failed),
                      sorted(t.removing), t.quiesced)
                  for k, t in st.tenants.items() if k is not None}
        fc = pkg["fleet"].FleetController(
            NODES, inline_solve=True, recorder=rec2, journal=st.journal,
            **pkg["kw"])
        await fc.start()
        for key in ("ta", "tb"):
            fc.resume_tenant(st, key, m, assign)
        fc.submit("ta", pkg["delta"](partition_weights={"p001": 3}))
        maps = await fc.quiesce_all()
        await fc.stop()
        st.journal.close()
        return folded, {k: _nbs(v) for k, v in maps.items()}

    with obs.use_recorder(rec2):
        folded, resumed = loop2.run_until_complete(second_life())
    files = {name: open(os.path.join(jdir, name), "rb").read()
             for name in sorted(os.listdir(jdir))}
    counters = {k: v for k, v in rec2.counters.items()
                if k.startswith("durability.")}
    return dict(first=first, folded=folded, resumed=resumed, files=files,
                log=log, counters=counters)


def test_journaled_fleet_bytes_and_recovery_equal_reference(tmp_path):
    out = {}
    for name, pkg in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        out[name] = _journaled_fleet(pkg, str(d))
    ref, port = out["ref"], out["port"]
    assert ref["log"] and ref["counters"]
    assert port["first"] == ref["first"]
    assert sorted(port["files"]) == sorted(ref["files"])
    for name in ref["files"]:
        assert port["files"][name] == ref["files"][name], name
    assert port["folded"] == ref["folded"]
    assert port["resumed"] == ref["resumed"]
    assert port["log"] == ref["log"]
    assert port["counters"] == ref["counters"]
    assert port["counters"]["durability.recoveries"] == 1
    assert all("n0" not in ns for m in port["resumed"].values()
               for p in m.values() for ns in p.values())
