"""Device meshes for the port: one controller, W ranks, torch.distributed.

The reference hands a ``jax.sharding.Mesh`` to its sharded entry points
and ``shard_map`` runs a body on every device of it.  The port keeps the
reference's single controller: a :class:`Mesh` owns W ranks, rank 0 is
the calling process and ranks 1..W-1 are worker processes the mesh
starts itself, each a fresh interpreter (the ``spawn`` start method,
never a fork after CUDA is initialised) that imports only torch and the
port, not the caller's main module, and connects back to rank 0 over an
authenticated localhost socket.  Services that coalesce requests on one asyncio loop
(``PlanService``, ``FleetController``) keep running on rank 0 alone; only
the bodies of :meth:`Mesh.shard_map` run on every rank.

Devices.  ``device="cuda"`` (the default) puts rank r on
``cuda:{ordinal_r % torch.cuda.device_count()}`` and raises without a
card; ``device="cpu"`` runs every rank on the CPU (the tests), each
worker with one thread.

Backend, one rule: ``nccl`` when every rank has a card of its own,
``gloo`` otherwise (several ranks sharing one card, or the CPU), since
NCCL refuses two ranks on one device.  The mesh reports its backend and
never switches it.  A gloo collective on CUDA tensors is staged through
a host buffer (one copy each way), explicitly, and counted.

Process groups.  Every mesh builds its own groups from raw process-group
objects over its own store, never the process-wide default group, so
one process may hold meshes of any shape at once.  Rank numbering is
rank = parts_idx * node_shards + node_idx, the node axis minor; the
partition axis is the column group of ranks sharing a node index, the
node axis the row group of ranks sharing a partition index.  A mesh may
share the worker processes of another (``devices=`` an existing mesh),
over that mesh's first ranks.

Timeouts.  Every group has one (60 s on the CPU and 300 s on a card by
default), and rank 0 waits on its workers with a deadline past it.  A
collective that one rank skips fails the call with a :class:`MeshError`
that names the body and the ranks whose collective counts differ; the
mesh is then broken and refuses further calls.

``shard_map(body, args, in_layout, out_layout)`` is the port of
``jax.shard_map`` over the reference's layout tables: rank 0 splits the
"parts" operands by rows over the partition axis and hands every rank
the "replicated" ones, each rank runs ``body(*local, axes=...)`` on its
device, "parts" outputs are concatenated on rank 0 and "replicated"
outputs are rank 0's own.  The operands and outputs travel over each
worker's connection to rank 0; the collectives the body calls
(:class:`Axis`) travel over the mesh's process groups.  A worker's exception comes back to
rank 0 and is raised there.
"""

from __future__ import annotations

import datetime
import itertools
import os
import secrets
import socket
import subprocess
import sys
import threading
import time
import traceback
from multiprocessing.connection import (Client, Connection,
                                        answer_challenge, deliver_challenge)
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "Axis", "Axes", "MeshError", "PARTITION_AXIS",
           "NODE_AXIS", "backend_for", "register_body", "BODIES"]

PARTITION_AXIS = "parts"
NODE_AXIS = "nodes"

_STARTUP_S = 180.0  # deadline for a worker to import the port and connect
_mesh_ids = itertools.count()


class MeshError(RuntimeError):
    """A mesh call failed on some rank, or the mesh is closed or broken."""


def _td(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=float(seconds))


def _default_timeout(kind: str) -> float:
    return 300.0 if kind == "cuda" else 60.0


def backend_for(kind: str, ordinals: Sequence[int]) -> str:
    """THE backend rule: ``nccl`` when every rank has a card of its own,
    else ``gloo``."""
    if kind != "cuda":
        return "gloo"
    cards = [o % max(torch.cuda.device_count(), 1) for o in ordinals]
    return "nccl" if len(set(cards)) == len(cards) else "gloo"


# --- the body table ----------------------------------------------------------
#
# Bodies run on every rank, so they are named, not pickled: a worker
# resolves the name in this table.  parallel/sharded.py registers the
# reference's eight shard_map'd bodies; the probes below are the mesh's
# own checks (a worker that raises, a rank that skips a collective, what
# a rank has imported).

BODIES: dict[str, Callable] = {}


def register_body(name: str, fn: Callable) -> None:
    BODIES[name] = fn


def _resolve_body(name: str) -> Callable:
    if name not in BODIES:
        from . import sharded  # noqa: F401  (registers the solver bodies)
    try:
        return BODIES[name]
    except KeyError:
        raise MeshError(f"unknown mesh body {name!r}") from None


def _probe_raise(x, *, axes, rank: int = 1):
    """Raise on ``rank``; every other rank returns its rows."""
    if axes.rank == rank:
        raise ValueError(f"probe failure on rank {rank}")
    return (x,)


def _probe_psum(x, *, axes, skip_rank: int = -1):
    """psum ``x`` over the partition axis; ``skip_rank`` skips it."""
    if axes.rank == skip_rank:
        return (x,)
    return (axes.parts.psum(x),)


def _probe_imports(x, *, axes):
    """``x`` plus the count of jax and JAX-package modules this rank has
    imported (a worker must have none)."""
    bad = sum(1 for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "blance_tpu"))
    return (x + bad,)


register_body("probe.raise", _probe_raise)
register_body("probe.psum", _probe_psum)
register_body("probe.imports", _probe_imports)


# --- collectives -------------------------------------------------------------


class Axis:
    """One mesh axis as a solver body sees it: this rank's ``index`` on
    it, its ``size``, and the collectives over the ranks that share the
    other axis' index.  Each call is counted in the rank's call stats
    (collectives, seconds, bytes sent, host staging copies)."""

    def __init__(self, name: str, size: int, index: int, group,
                 stage: bool, stats: dict):
        self.name = name
        self.size = size
        self.index = index
        self._group = group
        self._stage = stage
        self._stats = stats

    def __repr__(self) -> str:
        return f"Axis({self.name!r}, {self.index}/{self.size})"

    def _run(self, x: torch.Tensor, op: Callable) -> torch.Tensor:
        if x.dtype == torch.bool:
            raise TypeError(f"{self.name}: collectives take numbers, not "
                            f"bool (cast first)")
        st = self._stats
        # Counted before the call: a rank stuck in a collective the others
        # skipped must show one more than they do.
        st["collectives"] += 1
        st["by_axis"][self.name] = st["by_axis"].get(self.name, 0) + 1
        t0 = time.perf_counter()
        dev = x.device
        h = x.detach().reshape(-1)
        staged = self._stage and dev.type == "cuda"
        if staged:
            h = h.cpu()  # gloo on a card's tensor: stage through the host
            st["staged_copies"] += 1
        else:
            h = h.clone()
        out = op(h)
        if staged:
            out = out.to(dev)
            st["staged_copies"] += 1
        elif dev.type == "cuda":
            torch.cuda.synchronize(dev)
        st["coll_bytes"] += x.numel() * x.element_size()
        st["coll_s"] += time.perf_counter() - t0
        return out

    def _reduce(self, x: torch.Tensor, red) -> torch.Tensor:
        def op(h):
            opts = dist.AllreduceOptions()
            opts.reduceOp = red
            self._group.allreduce([h], opts).wait()
            return h
        return self._run(x, op).reshape(x.shape)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.SUM)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MIN)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MAX)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[size, *x.shape]: every rank's ``x`` in axis-index order."""
        def op(h):
            outs = [torch.empty_like(h) for _ in range(self.size)]
            self._group.allgather([outs], [h]).wait()
            return torch.stack(outs)
        return self._run(x, op).reshape((self.size,) + tuple(x.shape))


class Axes(NamedTuple):
    """What a body receives as ``axes``: the partition axis, the node
    axis (None on a 1-D mesh), the node-shard count and this rank."""

    parts: Axis
    nodes: Optional[Axis]
    node_shards: int
    rank: int


def _new_stats() -> dict:
    return dict(collectives=0, coll_s=0.0, coll_bytes=0, staged_copies=0,
                by_axis={}, solve_s=0.0, peak_alloc_bytes=0, launches={})


def _new_group(store, prefix: str, rank: int, size: int, backend: str,
               timeout_s: float):
    st = dist.PrefixStore(prefix, store)
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = _td(timeout_s)
        return dist.ProcessGroupNCCL(st, rank, size, opts)
    opts = dist.ProcessGroupGloo._Options()
    opts._timeout = _td(timeout_s)
    opts._devices = [dist.ProcessGroupGloo.create_device(
        hostname="127.0.0.1")]
    return dist.ProcessGroupGloo(st, rank, size, opts)


class _RankMesh:
    """One rank's view of one mesh: its groups and its device."""

    def __init__(self, store, mesh_id: int, shape: tuple[int, int],
                 rank: int, backend: str, timeout_s: float,
                 device: torch.device):
        parts, nodes = shape
        self.shape = shape
        self.rank = rank
        self.backend = backend
        self.device = device
        self.pi, self.ni = divmod(rank, nodes)
        # Column groups (the partition axis) first, then row groups (the
        # node axis), in one global order: every rank meets its groups'
        # other members in the same sequence, so no construction waits on
        # a rank still blocked in an earlier one.
        self.parts_group = _new_group(
            store, f"m{mesh_id}/parts{self.ni}/", self.pi, parts, backend,
            timeout_s)
        self.nodes_group = _new_group(
            store, f"m{mesh_id}/nodes{self.pi}/", self.ni, nodes, backend,
            timeout_s) if nodes > 1 else None

    def close(self) -> None:
        """Shut the groups down (NCCL asks for it before exit)."""
        for g in (self.parts_group, self.nodes_group):
            shutdown = getattr(g, "shutdown", None)
            if shutdown is not None and self.backend == "nccl":
                shutdown()

    def axes(self, stats: dict) -> Axes:
        parts, nodes = self.shape
        stage = self.backend == "gloo"
        return Axes(
            parts=Axis(PARTITION_AXIS, parts, self.pi, self.parts_group,
                       stage, stats),
            nodes=(Axis(NODE_AXIS, nodes, self.ni, self.nodes_group, stage,
                        stats) if self.nodes_group is not None else None),
            node_shards=nodes, rank=self.rank)


_CAPTURED_KERNELS = ("priced_min2_argmin", "fused_score_min2",
                     "sparse_priced_min2_cand")


class _HostArray(NamedTuple):
    """A tensor crossing a worker's connection as a plain numpy array
    (torch's own pickling would hand it over by a shared file
    descriptor, which only a multiprocessing child can open)."""

    array: np.ndarray


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return _HostArray(x.detach().cpu().numpy())
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_host(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_to_host(v) for v in x)
    return x


def _from_host(x):
    """``_to_host`` undone: host (CPU) tensors."""
    if isinstance(x, _HostArray):
        return torch.from_numpy(x.array)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_from_host(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_from_host(v) for v in x)
    return x


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(dev)


def _run_call(rm: _RankMesh, body: str, statics: dict, local: list,
              capture: bool):
    """Run ``body`` on this rank; returns (outputs or None, error text or
    None, stats, captured kernel inputs)."""
    from ..ops import launch_counts
    from ..plan import tensor as _tensor

    stats = _new_stats()
    dev = rm.device
    captured: dict = {}
    spies = {}
    if capture:
        for name in _CAPTURED_KERNELS:
            orig = getattr(_tensor, name)

            def spy(*a, _orig=orig, _name=name, **kw):
                if _name not in captured:
                    captured[_name] = (_to_host(a), dict(kw))
                return _orig(*a, **kw)
            spies[name] = orig
            setattr(_tensor, name, spy)
    try:
        fn = _resolve_body(body)
        args = [_upload(a, dev) if isinstance(a, np.ndarray) else a
                for a in local]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        launches0 = launch_counts()
        t0 = time.perf_counter()
        outs = fn(*args, axes=rm.axes(stats), **statics)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            stats["peak_alloc_bytes"] = int(
                torch.cuda.max_memory_allocated(dev))
        stats["solve_s"] = time.perf_counter() - t0
        stats["launches"] = {k: v - launches0[k]
                             for k, v in launch_counts().items()}
        return outs, None, stats, captured
    except BaseException as e:  # noqa: BLE001 — reported to rank 0
        return None, f"{type(e).__name__}: {e}\n" + \
            "".join(traceback.format_exc(limit=12)), stats, captured
    finally:
        for name, orig in spies.items():
            setattr(_tensor, name, orig)


def _worker_main(rank: int, port: int, kind: str, ordinal: int,
                 timeout_s: float, conn) -> None:
    """A worker rank: connect to rank 0's store, then serve its calls
    until told to stop or until the connection to rank 0 closes (rank 0
    exited or died: the worker ends with it)."""
    if kind == "cpu":
        torch.set_num_threads(1)
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", ordinal % torch.cuda.device_count())
        torch.cuda.set_device(device)
    store = dist.TCPStore("127.0.0.1", port, None, False, _td(timeout_s))
    meshes: dict[int, _RankMesh] = {}
    conn.send(("ready", os.getpid()))
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return
        op = msg[0]
        if op == "stop":
            for m in meshes.values():
                m.close()
            return
        try:
            if op == "mesh":
                _, mid, shape, backend, t_s = msg
                meshes[mid] = _RankMesh(store, mid, shape, rank, backend,
                                        t_s, device)
                conn.send(("ok",))
            elif op == "drop":
                gone = meshes.pop(msg[1], None)
                if gone is not None:
                    gone.close()
                conn.send(("ok",))
            elif op == "call":
                _, mid, body, statics, local, want, capture = msg
                outs, err, stats, captured = _run_call(
                    meshes[mid], body, statics, local, capture)
                if err is not None:
                    conn.send(("err", err, stats, {}))
                    continue
                kept = [o.cpu().numpy() if isinstance(o, torch.Tensor)
                        else np.asarray(o)
                        for o, w in zip(outs, want) if w]
                conn.send(("ok", kept, stats, captured))
        except (EOFError, OSError, BrokenPipeError):
            return
        except BaseException as e:  # noqa: BLE001 — reported to rank 0
            conn.send(("err", f"{type(e).__name__}: {e}", _new_stats(), {}))


def _worker_entry() -> None:
    """``python -c`` entry of a worker process: argv carries rank 0's
    address, the authentication key and the rank's placement."""
    rank, addr_port, key, store_port, kind, ordinal, timeout_s = \
        sys.argv[1:8]
    conn = Client(("127.0.0.1", int(addr_port)),
                  authkey=bytes.fromhex(key))
    conn.send(("hello", int(rank)))
    _worker_main(int(rank), int(store_port), kind, int(ordinal),
                 float(timeout_s), conn)


_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class _Pool:
    """The processes behind one or more meshes: rank 0 (this process),
    the spawned workers, their connections and the store they
    rendezvous on."""

    def __init__(self, size: int, kind: str, ordinals: list[int],
                 timeout_s: float):
        self.size = size
        self.kind = kind
        self.ordinals = ordinals
        self.timeout_s = timeout_s
        self.closed = False
        self.store = dist.TCPStore("127.0.0.1", 0, None, True,
                                   _td(timeout_s), wait_for_workers=False)
        self.procs: list[subprocess.Popen] = []
        self.conns: list[Connection] = []
        if size == 1:
            return
        key = secrets.token_bytes(32)
        server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_REPO_ROOT] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        try:
            server.bind(("127.0.0.1", 0))
            server.listen(size)
            for r in range(1, size):
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-c",
                     "from blance_tpu_torch.parallel.mesh import "
                     "_worker_entry; _worker_entry()",
                     str(r), str(server.getsockname()[1]), key.hex(),
                     str(self.store.port), kind, str(ordinals[r]),
                     str(timeout_s)],
                    env=env, stdin=subprocess.DEVNULL,
                    stdout=subprocess.DEVNULL))
            deadline = time.monotonic() + _STARTUP_S
            by_rank: dict[int, Connection] = {}
            while len(by_rank) < size - 1:
                server.settimeout(max(deadline - time.monotonic(), 0.01))
                try:
                    sock, _addr = server.accept()
                except socket.timeout:
                    dead = [r for r, p in enumerate(self.procs, start=1)
                            if p.poll() is not None]
                    raise MeshError(
                        f"worker rank(s) {dead or 'unknown'} did not "
                        f"connect within {_STARTUP_S:.0f} s") from None
                sock.settimeout(None)
                conn = Connection(sock.detach())
                deliver_challenge(conn, key)
                answer_challenge(conn, key)
                _hello, r = conn.recv()
                by_rank[r] = conn
            self.conns = [by_rank[r] for r in range(1, size)]
            for r, c in enumerate(self.conns, start=1):
                self._recv(r, c, deadline, "start-up")
        except BaseException:
            self.close(force=True)
            raise
        finally:
            server.close()

    def _recv(self, rank: int, conn, deadline: float, what: str):
        left = deadline - time.monotonic()
        if not conn.poll(max(left, 0.0)):
            raise MeshError(f"rank {rank} did not answer the {what} within "
                            f"its deadline")
        try:
            return conn.recv()
        except (EOFError, OSError) as e:
            raise MeshError(f"rank {rank} died during the {what} "
                            f"(exit code {self.procs[rank - 1].poll()})"
                            ) from e

    def request(self, ranks: Sequence[int], msg: tuple, what: str) -> list:
        for r in ranks:
            self.conns[r - 1].send(msg)
        deadline = time.monotonic() + self.timeout_s + 30.0
        return [self._recv(r, self.conns[r - 1], deadline, what)
                for r in ranks]

    def close(self, force: bool = False) -> None:
        if self.closed:
            return
        self.closed = True
        for c in self.conns:
            if not force:
                try:
                    c.send(("stop",))
                except (OSError, BrokenPipeError):
                    pass
            c.close()
        for p in self.procs:
            try:
                p.wait(timeout=0.1 if force else 10.0)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10.0)
        self.procs = []
        self.conns = []

    def alive(self) -> list[int]:
        return [p.pid for p in self.procs if p.poll() is None]


class Mesh:
    """W ranks in a (parts,) or (parts, nodes) shape; see the module
    docstring.  ``axis_names`` and ``devices`` (an array of the ranks'
    device ordinals in mesh order) follow jax.sharding.Mesh, so
    ``dict(zip(mesh.axis_names, mesh.devices.shape))`` reads the axis
    sizes.  Close it (``close()`` or a ``with`` block) to stop its
    workers; a mesh built over another mesh's workers (``devices=``)
    leaves them to that mesh."""

    def __init__(self, shape: Sequence[int], *, device: Any = "cuda",
                 ordinals: Optional[Sequence[int]] = None,
                 share: Optional["Mesh"] = None,
                 timeout: Optional[float] = None):
        shape = tuple(int(s) for s in shape)
        if len(shape) not in (1, 2) or min(shape) < 1:
            raise ValueError(f"mesh shape must be (parts,) or (parts, "
                             f"nodes) with every size >= 1, got {shape}")
        self.axis_names = (PARTITION_AXIS,) if len(shape) == 1 else \
            (PARTITION_AXIS, NODE_AXIS)
        parts, nodes = shape[0], (shape[1] if len(shape) == 2 else 1)
        size = parts * nodes
        self._closed = False
        self._broken: Optional[str] = None
        self._lock = threading.Lock()  # one shard_map in flight at a time
        self.last_call: dict = {}
        t0 = time.perf_counter()
        if share is not None:
            share._check_open()
            pool = share._pool
            if size > pool.size:
                raise ValueError(f"need {size} ranks, the shared mesh has "
                                 f"{pool.size}")
            self._owner = False
            timeout = pool.timeout_s if timeout is None else float(timeout)
        else:
            kind = torch.device(device).type
            if kind == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("Mesh(device='cuda'): no CUDA card is "
                                   "available (pass device='cpu' to run "
                                   "the ranks on the CPU)")
            if kind not in ("cuda", "cpu"):
                raise ValueError(f"unsupported mesh device {device!r}")
            ords = list(range(size)) if ordinals is None else \
                [int(o) for o in ordinals]
            if len(ords) < size:
                raise ValueError(f"need {size} devices, have {len(ords)}")
            timeout = _default_timeout(kind) if timeout is None \
                else float(timeout)
            pool = _Pool(size, kind, ords[:size], timeout)
            self._owner = True
        self._pool = pool
        self.timeout = timeout
        ords = pool.ordinals[:size]
        self.devices = np.asarray(ords).reshape(
            shape if len(shape) == 2 else (parts,))
        self.kind = pool.kind
        self.size = size
        self._shape2 = (parts, nodes)
        self.backend = backend_for(self.kind, ords)
        if self.kind == "cuda":
            self.rank_devices = [torch.device(
                "cuda", o % torch.cuda.device_count()) for o in ords]
        else:
            self.rank_devices = [torch.device("cpu")] * size
        self.device = self.rank_devices[0]
        self._id = next(_mesh_ids)
        try:
            if size > 1:
                for r in range(1, size):
                    pool.conns[r - 1].send(("mesh", self._id, self._shape2,
                                            self.backend, timeout))
            self._rank0 = _RankMesh(pool.store, self._id, self._shape2, 0,
                                    self.backend, timeout, self.device)
            if size > 1:
                deadline = time.monotonic() + timeout + 30.0
                for r in range(1, size):
                    reply = pool._recv(r, pool.conns[r - 1], deadline,
                                       "group set-up")
                    if reply[0] != "ok":
                        raise MeshError(f"rank {r}: group set-up failed: "
                                        f"{reply[1]}")
        except BaseException:
            if self._owner:
                pool.close(force=True)
            raise
        self.startup_s = time.perf_counter() - t0

    # -- lifecycle ---------------------------------------------------------

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Stop the workers this mesh started (a mesh over another
        mesh's workers only releases its groups)."""
        if self._closed:
            return
        self._closed = True
        if self._owner:
            self._pool.close(force=self._broken is not None)
        elif not self._pool.closed and self._broken is None and \
                self.size > 1:
            self._pool.request(range(1, self.size), ("drop", self._id),
                               "group release")
        self._rank0.close()
        self._rank0 = None

    def worker_pids(self) -> list[int]:
        """The live worker processes of this mesh's pool."""
        return self._pool.alive()

    def _check_open(self) -> None:
        if self._closed or self._pool.closed:
            raise MeshError("the mesh is closed")
        if self._broken is not None:
            raise MeshError(f"the mesh is broken: {self._broken}")

    # -- shard_map ---------------------------------------------------------

    def _split(self, a, kind: str, name: str) -> list:
        """One operand's per-rank pieces (host arrays or, for rank 0's
        own, whatever was given)."""
        parts, nodes = self._shape2
        host = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)
        if kind == "replicated":
            return [host] * self.size
        if kind != "parts":
            raise ValueError(f"layout row {name!r}: unknown kind {kind!r}")
        if host.shape[0] % parts:
            raise ValueError(
                f"operand {name!r}: {host.shape[0]} rows do not divide "
                f"over {parts} partition shards (pad first)")
        rows = host.shape[0] // parts
        return [host[(r // nodes) * rows:(r // nodes + 1) * rows]
                for r in range(self.size)]

    def shard_map(self, body: str, args: Sequence[Any],
                  in_layout: Sequence[tuple[str, str]],
                  out_layout: Sequence[tuple[str, str]], *,
                  capture: Optional[int] = None, **statics):
        """Run the registered ``body`` on every rank; returns its outputs
        as ``out_layout`` lays them out (see the module docstring), the
        "parts" ones as tensors on rank 0's device.  ``statics`` reach
        every rank's body as keyword arguments.  ``capture``: that rank
        also records the inputs of its first call of each solver kernel
        wrapper (``last_call["captured"]``, host tensors).  Per-rank
        stats land in ``last_call``."""
        with self._lock:
            return self._shard_map(body, args, in_layout, out_layout,
                                   capture, statics)

    def _shard_map(self, body, args, in_layout, out_layout, capture,
                   statics):
        self._check_open()
        if len(args) != len(in_layout):
            raise ValueError(f"{body}: {len(args)} operands for "
                             f"{len(in_layout)} layout rows")
        t0 = time.perf_counter()
        pieces = [self._split(a, kind, name)
                  for a, (name, kind) in zip(args, in_layout)]
        parts, nodes = self._shape2
        want = [kind == "parts" for _name, kind in out_layout]
        for r in range(1, self.size):
            local = [p[r] for p in pieces]
            self._pool.conns[r - 1].send(
                ("call", self._id, body, statics, local,
                 want if r % nodes == 0 else [False] * len(want),
                 capture == r))
        outs0, err0, stats0, cap0 = _run_call(
            self._rank0, body, statics, [p[0] for p in pieces],
            capture == 0)
        replies = {0: ("ok" if err0 is None else "err",
                       outs0 if err0 is None else err0, stats0, cap0)}
        deadline = time.monotonic() + self.timeout + 30.0
        lost = []
        for r in range(1, self.size):
            try:
                replies[r] = self._pool._recv(r, self._pool.conns[r - 1],
                                              deadline, f"call {body!r}")
            except MeshError as e:
                lost.append((r, str(e)))
        errors = {r: rep[1] for r, rep in replies.items() if rep[0] == "err"}
        stats = {r: rep[2] for r, rep in replies.items()}
        self.last_call = dict(body=body, stats=stats,
                              wall_s=time.perf_counter() - t0,
                              captured={
                                  k: (_from_host(a), kw) for k, (a, kw) in
                                  (replies[capture][3] if capture in replies
                                   else {}).items()})
        if errors or lost:
            self._fail(body, errors, lost, stats)
        out = []
        for i, (name, kind) in enumerate(out_layout):
            mine = outs0[i]
            if kind == "replicated":
                out.append(mine)
                continue
            blocks = [mine] + [
                torch.from_numpy(replies[r][1][sum(want[:i])]).to(
                    mine.device)
                for r in range(nodes, self.size, nodes)]
            out.append(torch.cat(blocks) if len(blocks) > 1 else mine)
        self.last_call["wall_s"] = time.perf_counter() - t0
        return tuple(out)

    def _fail(self, body: str, errors: dict, lost: list, stats: dict):
        counts = {r: s["collectives"] for r, s in stats.items()}
        lines = []
        if lost:
            self._broken = f"rank(s) lost in {body!r}"
            lines += [msg for _r, msg in lost]
        if len(set(counts.values())) > 1:
            common = max(set(counts.values()),
                         key=lambda c: (list(counts.values()).count(c), c))
            odd = sorted(r for r, c in counts.items() if c != common)
            self._broken = f"collectives diverged in {body!r}"
            lines.append(
                "collective counts diverged: " + ", ".join(
                    f"rank {r} made {counts[r]}" for r in odd) +
                f" where the other ranks made {common} (a rank skipped or "
                f"added a collective)")
        for r in sorted(errors):
            first = errors[r].splitlines()[0] if errors[r] else ""
            lines.append(f"rank {r}: {first}")
        if lost and self._owner:
            self._pool.close(force=True)
        detail = next(iter(errors.values()), "") if errors else ""
        raise MeshError(f"mesh call {body!r} failed on rank(s) "
                        f"{sorted(set(errors) | {r for r, _ in lost})}: "
                        + "; ".join(lines) +
                        (f"\n--- first error ---\n{detail}" if detail
                         else ""))
