# Copied from blance_tpu/analysis/race_lint.py; the comments name the
# port's modules (the class names are the reference's).
"""Await-atomicity race lint: torn invariants in the asyncio control plane.

Single-threaded asyncio gives one guarantee: everything between two
``await``s is atomic.  The orchestrator's correctness (its retries,
quarantine and recovery all mutate shared ``Orchestrator`` /
``NodeHealth`` / ``Chan`` state from cooperating tasks) rests entirely
on code respecting that window — and nothing checked it.  This pass
models the control plane's shared mutable state declaratively (the
:data:`SHARED_STATE` table — one entry per class, one attribute set per
entry; ``docs/DESIGN.md`` §5 documents the intent behind each) and
flags the three ways the window gets torn:

- RACE001 — **read-modify-write across an await**: a local is bound
  from a shared attribute, an ``await`` intervenes, and the attribute
  is then written from an expression using that stale local.  Another
  task's write inside the window is silently lost (the classic lost
  update).
- RACE002 — **stale guard**: a local is bound from a shared attribute
  (a state flag / channel like ``_paused`` or breaker state), an
  ``await`` intervenes, and the local is then *used* without re-reading
  the attribute.  The guard may no longer hold — the pause/resume/pause
  cycle against the supplier's captured ``_pause_ch`` was exactly this
  bug.  Re-binding from the attribute after the await (e.g. a
  revalidation loop) clears the finding.
- RACE003 — **multi-root unserialized mutation**: the same shared
  attribute is mutated from two or more distinct task entry points
  (methods spawned via ``_spawn``/``ensure_future``/``create_task``,
  plus the externally-called sync surface) of a task-owning class.
  Interleaving order between the roots is scheduler-chosen; the finding
  demands either a serialization point or a baseline entry stating the
  discipline that makes the shared access safe (e.g. append-only lists,
  whose appends are single-window atomic — then the schedule explorer's
  append-only invariant enforces the discipline dynamically).

RACE001/002 analyze ``async def`` bodies only (a sync function cannot
be preempted mid-body); the analysis is linear over execution order —
within an ``await expr``, the inner expression's reads happen *before*
the suspension, so ``await (x := self._flag).get()`` style re-reads are
ordered correctly.  RACE003 is whole-class.  Both deliberately track
only locals bound from a *plain attribute load* — guards derived
through method calls are invisible, which keeps the pass quiet enough
to gate CI (the false-positive budget goes to the explorer, which
checks the dynamic invariants the lint cannot).

Scope: the lint runs over any file it is handed, but only classes named
in the shared-state model produce findings, which confines it to the
control plane (``orchestrate/``, ``rebalance.py``) by construction.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Iterator, Optional, Union

from . import Finding
from ._astutil import FindingEmitter, dotted as _dotted

__all__ = ["SHARED_STATE", "lint_file", "lint_source"]

# -- the shared-state model --------------------------------------------------
#
# class name -> attributes that are MUTABLE SHARED STATE: touched by more
# than one cooperating task (or by a task plus the app-facing sync control
# surface).  Immutable-after-init attributes (model, options, nodes_all,
# _rec, ...) are deliberately absent — a stale read of an immutable value
# cannot tear anything, and listing them would drown the signal.
# docs/DESIGN.md "Shared state & serialization points" is the prose twin
# of this table; keep them in sync.
SHARED_STATE: dict[str, frozenset[str]] = {
    "Orchestrator": frozenset({
        "_stop_ch", "_pause_ch", "_progress", "_tasks", "failures",
        "health", "_map_partition_to_next_moves", "_missing_mover_warned",
    }),
    "OrchestratorProgress": frozenset({"errors"}),
    "HealthTracker": frozenset({"_nodes"}),
    "NodeHealth": frozenset({
        "state", "consecutive_failures", "trips", "tripped_at",
        "probe_in_flight",
    }),
    "Chan": frozenset({"_getters", "_putters", "_closed"}),
    "NextMoves": frozenset({"next", "next_done_ch", "failed_at"}),
    # -- live telemetry plane ---------------------------------------------
    # SloTracker is mutated by every mover task (the on_batch observer
    # hook) and read by the exposition server's snapshot path;
    # CostModel's tables are updated from span-finish callbacks on the
    # same tasks and read by the scheduler-facing predict().  Both rely
    # on the single-atomic-window discipline: every mutator is a plain
    # sync method with no await inside, so updates cannot interleave on
    # the event loop.  The lint's RACE001/002 passes watch any future
    # async method that breaks that discipline.
    "SloTracker": frozenset({
        "_placements", "_primaries", "_available", "moves_executed",
        "moves_failed", "_min_moves", "_t_last_progress", "_health",
        "_incident_t0", "_incident_moves0", "_incident_fails0",
        "_t_last_fail", "_first_converged_lags",
    }),
    "CostModel": frozenset({"_est", "_op_est", "_global", "_errors",
                            "_n_scored"}),
    # -- fleet plan service -----------------------------------------------
    # PlanService's control state is touched by the app-facing surface
    # (submit/stop) and the dispatcher task; every mutation sits in one
    # no-await window, and the bounded queue is the only rendezvous.
    # The CarryCache is written ONLY from the dispatcher task (sessions
    # own private caches), a discipline this entry documents — any
    # future async method on either class puts it under RACE001/002.
    "PlanService": frozenset({"_queue", "_task", "_closed", "_executor",
                              "_deferred"}),
    "CarryCache": frozenset({"_entries", "_clock", "_bytes",
                             "evictions"}),
    # EncodeCache (plan/carry.py) is shared by N tenant
    # control-loop tasks.  Discipline: every method is synchronous (one
    # no-await window) and each KEY has a single writer — its tenant's
    # own task; cross-key interference is limited to LRU eviction,
    # which only ever costs the evicted key a cold re-encode.  A
    # planner holds its EncodedState object across its solve await, so
    # a concurrent eviction drops only the cache's reference; the
    # owner's next put re-inserts and re-enforces the budget.
    "EncodeCache": frozenset({"_entries", "_ticks", "_clock",
                              "evictions", "demotions"}),
    # -- converge-cycle engine + continuous-rebalance controller
    # (engine in blance_tpu_torch/control.py)
    # The CycleEngine's control state is touched by the app-facing
    # sync surface (submit/stop_soon) and the engine task.  The
    # discipline: every mutation sits in one no-await window (the sync
    # helpers _take_pending/_set_idle and the subclass hooks), the
    # pending list is taken atomically with the wake-event clear, and
    # the in-flight supersede decision re-reads _pending after every
    # wake.  The supersede explorer scenario (analysis/schedule.py
    # supersede_mid_rebalance) drives the windows dynamically.
    "CycleEngine": frozenset({
        "_pending", "_wake", "_idle", "_stopping", "_task",
    }),
    # RebalanceController adds the cluster-specific state; the engine
    # attrs it still touches from its own methods (_pending in the
    # supersede window, _stopping in the converge loop) are listed
    # again so the lint models them at this class too.
    "RebalanceController": frozenset({
        "_pending", "_idle", "_inflight", "_stopping",
        "current", "_nodes", "_removing", "_failed",
        "failures", "degraded_reports", "warnings",
    }),
    # -- fleet of control loops (blance_tpu_torch/fleetloop.py) ---------------
    # FleetController's tenant registry is mutated only from the
    # driving task (add_tenant/forget_tenant, sync windows); the rollup
    # registry is sync-window by the same discipline, read by the
    # exposition snapshot path.
    "FleetController": frozenset({"_tenants"}),
    "FleetSloRollup": frozenset({"_trackers"}),
    # -- critical-path move scheduler ----------------------------------------
    # The bound scheduler's state is read by the supplier task (select)
    # and mutated by mover tasks (on_batch marks progress,
    # on_quarantine rebuilds the whole schedule) plus the supplier's
    # wind-down (finish).  Discipline: every mutator is a plain sync
    # method — _build recomputes ranks/plan/last_remaining in ONE
    # no-await window, so select can never observe a half-rebuilt
    # schedule, and the (plan, last_remaining) pair is always a
    # consistent snapshot (the reschedule_on_quarantine explorer
    # scenario checks that dynamically).  SloTracker's incident fields
    # follow its existing single-window discipline.
    "_CriticalPathBound": frozenset({
        "_rank", "plan", "last_remaining", "_quarantined",
        "_t_last_exec", "_first_predicted", "_finished", "reschedules",
    }),
    # -- durability journal (blance_tpu_torch/durability) ---------------------
    # The Journal is written from the controller's cycle task (genesis/
    # delta/cycle/plan/strip/quiesce/snapshot) AND from every mover
    # task (the batch observer hook) — under the fleet tier, from N
    # tenant loops at once through their TenantViews.  Discipline:
    # append() is the single funnel and is plain sync code with no
    # awaits, so each record's seq/segment/snapshot-cadence update is
    # one atomic window on the event loop.  The EpochFence's counter is
    # read on every append and bumped only by recover() (sync, before
    # any successor task starts).
    "Journal": frozenset({
        "_seq", "_records_in_seg", "records_since_snapshot", "_f",
        "segment",
    }),
    "EpochFence": frozenset({"_epoch"}),
}

# Container mutators: a call to one of these on a shared attribute is a
# write for RACE003 purposes.
_MUTATING_METHODS = frozenset({
    "append", "extend", "add", "update", "clear", "pop", "remove",
    "insert", "discard", "setdefault", "popleft", "appendleft",
})

# Spawn spellings that make a method a task entry point.
_SPAWN_NAMES = frozenset({"_spawn", "ensure_future", "create_task"})

_EXTERNAL_ROOT = "<external>"

_FuncDef = Union[ast.FunctionDef, ast.AsyncFunctionDef]


def _attr_path(node: ast.AST) -> Optional[str]:
    """Dotted path of a ``self.a.b`` attribute chain ("a.b"), or None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name) and node.id == "self" and parts:
        return ".".join(reversed(parts))
    return None


# -- linear execution-order event stream (RACE001/002) -----------------------


@dataclass
class _Event:
    kind: str  # "bind" | "use" | "write" | "await"
    time: int
    local: Optional[str] = None  # bind/use
    attr: Optional[str] = None  # bind/write: the shared attribute path
    line: int = 0
    uses_locals: frozenset[str] = frozenset()  # write: locals in RHS


class _EventWalker:
    """Flatten one async function body into execution-ordered events.

    Ordering rules that matter here: an ``Assign``'s value is evaluated
    before its targets bind; an ``Await``'s inner expression is
    evaluated before the suspension point; nested function defs are
    opaque (they execute elsewhere).  Branches are concatenated — the
    analysis is path-insensitive by design, which can only merge a
    branch's events in source order; good enough for the guard/RMW
    patterns this pass exists to catch, and fixtures pin the behavior.
    """

    def __init__(self, shared: frozenset[str]) -> None:
        self.shared = shared
        self.events: list[_Event] = []
        self._t = 0

    def _tick(self) -> int:
        self._t += 1
        return self._t

    def walk_body(self, body: list[ast.stmt]) -> None:
        for stmt in body:
            self._stmt(stmt)

    # -- statements --------------------------------------------------------

    def _stmt(self, node: ast.stmt) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # analyzed as their own scopes
        if isinstance(node, ast.Assign):
            self._expr(node.value)
            for target in node.targets:
                self._bind_target(target, node.value, node.lineno)
            return
        if isinstance(node, ast.AugAssign):
            # self.x += <rhs>: CPython loads self.x BEFORE evaluating
            # the RHS, so `self.x += await f()` reads the attribute,
            # suspends, then writes it back — the torn RMW in one
            # statement.  Model the target read as a synthetic binding
            # so the write-after-await check sees the window.
            target: ast.expr = node.target
            while isinstance(target, ast.Subscript):
                target = target.value
            path = _attr_path(target)
            pseudo: Optional[str] = None
            if path is not None and path.split(".")[0] in self.shared:
                pseudo = f"<aug:{path}>"
                self.events.append(_Event(
                    kind="bind", time=self._tick(), local=pseudo,
                    attr=path, line=node.lineno))
            self._expr(node.value)
            if pseudo is not None and path is not None:
                used = frozenset(
                    n.id for n in ast.walk(node.value)
                    if isinstance(n, ast.Name)) | {pseudo}
                self.events.append(_Event(
                    kind="write", time=self._tick(), attr=path,
                    line=node.lineno, uses_locals=used))
            else:
                self._write_target(node.target, node.value, node.lineno)
            return
        if isinstance(node, ast.AnnAssign) and node.value is not None:
            self._expr(node.value)
            self._bind_target(node.target, node.value, node.lineno)
            return
        if isinstance(node, (ast.AsyncFor, ast.AsyncWith)):
            # Implicit suspension points: __anext__/__aenter__ awaits.
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.expr):
                    self._expr(child)
                elif isinstance(child, ast.withitem):
                    for sub in ast.iter_child_nodes(child):
                        if isinstance(sub, ast.expr):
                            self._expr(sub)
            self.events.append(_Event(kind="await", time=self._tick(),
                                      line=node.lineno))
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.stmt):
                    self._stmt(child)
            return
        # Compound statements: evaluate their tests/iterables, then walk
        # child statement lists in source order.
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.stmt):
                self._stmt(child)
            elif isinstance(child, ast.expr):
                self._expr(child)
            elif isinstance(child, (ast.ExceptHandler, ast.withitem)):
                for sub in ast.iter_child_nodes(child):
                    if isinstance(sub, ast.stmt):
                        self._stmt(sub)
                    elif isinstance(sub, ast.expr):
                        self._expr(sub)

    def _bind_target(self, target: ast.expr, value: ast.expr,
                     line: int) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind_target(elt, value, line)
            return
        if isinstance(target, ast.Name):
            attr = self._shared_attr(value)
            self.events.append(_Event(
                kind="bind", time=self._tick(), local=target.id,
                attr=attr, line=line))
            return
        self._write_target(target, value, line)

    def _write_target(self, target: ast.expr, value: ast.expr,
                      line: int) -> None:
        # self._shared[k] = v mutates the shared container just as
        # surely as self._shared = v replaces it.
        while isinstance(target, ast.Subscript):
            target = target.value
        path = _attr_path(target)
        if path is not None and path.split(".")[0] in self.shared:
            used = frozenset(
                n.id for n in ast.walk(value) if isinstance(n, ast.Name))
            self.events.append(_Event(
                kind="write", time=self._tick(), attr=path, line=line,
                uses_locals=used))

    def _shared_attr(self, value: ast.expr) -> Optional[str]:
        path = _attr_path(value)
        if path is not None and path.split(".")[0] in self.shared:
            return path
        return None

    # -- expressions (execution order: children first, await last) ---------

    def _expr(self, node: ast.expr) -> None:
        if isinstance(node, ast.Await):
            self._expr_children(node.value)
            self.events.append(_Event(kind="await", time=self._tick(),
                                      line=node.lineno))
            return
        self._expr_children(node)

    def _expr_children(self, node: ast.expr) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Await):
                # Nested awaits inside this expression: record in place.
                self.events.append(_Event(kind="await", time=self._tick(),
                                          line=sub.lineno))
            elif isinstance(sub, ast.Name) and \
                    isinstance(sub.ctx, ast.Load):
                self.events.append(_Event(
                    kind="use", time=self._tick(), local=sub.id,
                    line=sub.lineno))
            elif isinstance(sub, ast.NamedExpr) and \
                    isinstance(sub.target, ast.Name):
                attr = self._shared_attr(sub.value)
                self.events.append(_Event(
                    kind="bind", time=self._tick(), local=sub.target.id,
                    attr=attr, line=sub.lineno))


# -- per-class analysis ------------------------------------------------------


@dataclass
class _MutationSite:
    attr: str
    method: str  # enclosing method qualname (closures attributed up)
    line: int


@dataclass
class _ClassInfo:
    name: str
    shared: frozenset[str]
    methods: dict[str, _FuncDef] = field(default_factory=dict)
    calls: dict[str, set[str]] = field(default_factory=dict)  # m -> callees
    spawned: set[str] = field(default_factory=set)
    owns_spawns: bool = False
    mutations: list[_MutationSite] = field(default_factory=list)


def _iter_methods(cls: ast.ClassDef) -> Iterator[tuple[str, _FuncDef]]:
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.name, node


def _collect_class(cls: ast.ClassDef,
                   shared: frozenset[str]) -> _ClassInfo:
    info = _ClassInfo(name=cls.name, shared=shared)
    for name, fn in _iter_methods(cls):
        info.methods[name] = fn
        # First pass: spawn sites.  A coroutine constructed as a spawn
        # argument (self._spawn(self.m(...))) runs as its OWN task — it
        # is a task root, not a call edge from the spawning method.
        spawn_args: set[int] = set()
        for sub in ast.walk(fn):
            if not isinstance(sub, ast.Call):
                continue
            d = _dotted(sub.func)
            if d is None or d.split(".")[-1] not in _SPAWN_NAMES:
                continue
            info.owns_spawns = True
            for arg in sub.args:
                if isinstance(arg, ast.Call):
                    spawn_args.add(id(arg))
                    ad = _dotted(arg.func)
                    if ad is not None and ad.startswith("self.") and \
                            "." not in ad[5:]:
                        info.spawned.add(ad[5:])
        callees: set[str] = set()
        for sub in ast.walk(fn):
            if not isinstance(sub, ast.Call) or id(sub) in spawn_args:
                continue
            d = _dotted(sub.func)
            if d is not None and d.startswith("self.") and \
                    "." not in d[5:]:
                callees.add(d[5:])
        info.calls[name] = callees
        # Mutation sites (RACE003), closures attributed to the method.
        def unwrap(t: ast.expr) -> Optional[str]:
            # A subscript write/delete mutates the shared container.
            while isinstance(t, ast.Subscript):
                t = t.value
            return _attr_path(t)

        for sub in ast.walk(fn):
            path: Optional[str] = None
            if isinstance(sub, (ast.Assign, ast.AugAssign, ast.Delete)):
                if isinstance(sub, ast.Assign):
                    targets = sub.targets
                elif isinstance(sub, ast.Delete):
                    targets = [t for t in sub.targets
                               if isinstance(t, ast.Subscript)]
                else:
                    targets = [sub.target]
                for t in targets:
                    path = unwrap(t)
                    if path is not None and \
                            path.split(".")[0] in shared:
                        info.mutations.append(_MutationSite(
                            attr=path, method=name, line=sub.lineno))
            elif isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr in _MUTATING_METHODS:
                path = _attr_path(sub.func.value)
                if path is not None and path.split(".")[0] in shared:
                    info.mutations.append(_MutationSite(
                        attr=path, method=name, line=sub.lineno))
    return info


def _roots_per_method(info: _ClassInfo) -> dict[str, set[str]]:
    """Task roots (spawned methods + the external sync surface) that can
    reach each method through the intra-class call graph."""
    roots: dict[str, set[str]] = {m: set() for m in info.methods}

    def flood(root_label: str, start: str) -> None:
        seen: set[str] = set()
        frontier = [start]
        while frontier:
            m = frontier.pop()
            if m in seen or m not in roots:
                continue
            seen.add(m)
            roots[m].add(root_label)
            frontier.extend(info.calls.get(m, ()))

    for spawned in info.spawned:
        flood(spawned, spawned)
    # Everything is also callable from outside (the app's control
    # surface: stop/pause/resume and the constructor path) — but only
    # methods NOT exclusively internal matter; treating every method as
    # externally rooted would make every pair "two roots".  External
    # root = methods nobody in the class calls and nobody spawns
    # (entry-shaped), e.g. _start, stop, pause/resume.
    called_by_someone: set[str] = set()
    for callees in info.calls.values():
        called_by_someone |= callees
    for m in info.methods:
        if m not in called_by_someone and m not in info.spawned:
            flood(_EXTERNAL_ROOT, m)
    return roots


def _analyze_async_method(em: FindingEmitter, cls_name: str, qualname: str,
                          fn: ast.AsyncFunctionDef,
                          shared: frozenset[str]) -> None:
    """RACE001 + RACE002 over one async method, linear in events."""
    walker = _EventWalker(shared)
    walker.walk_body(fn.body)
    events = walker.events

    # Latest binding per local, in execution order.
    binding: dict[str, _Event] = {}
    await_times: list[int] = []
    race001: list[tuple[int, str]] = []  # (line, message)
    race002: list[tuple[int, str]] = []
    seen_002: set[tuple[str, int]] = set()
    seen_001: set[tuple[str, int]] = set()

    def awaits_between(t0: int, t1: int) -> bool:
        return any(t0 < t < t1 for t in await_times)

    for ev in events:
        if ev.kind == "await":
            await_times.append(ev.time)
        elif ev.kind == "bind":
            if ev.local is not None:
                if ev.attr is not None:
                    binding[ev.local] = ev
                else:
                    binding.pop(ev.local, None)  # rebound to non-shared
        elif ev.kind == "use":
            b = binding.get(ev.local or "")
            if b is None or b.attr is None:
                continue
            if awaits_between(b.time, ev.time):
                key = (b.local or "", b.line)
                if key not in seen_002:
                    seen_002.add(key)
                    race002.append((ev.line, (
                        f"stale guard: {b.local!r} was bound from shared "
                        f"{cls_name}.{b.attr} at line {b.line}, an await "
                        f"suspended the task in between, and the stale "
                        f"local is used here — another task (or the "
                        f"app's control surface) may have replaced the "
                        f"attribute inside the window; re-read "
                        f"self.{b.attr} after the await (revalidation "
                        f"loop) or serialize the writers")))
        elif ev.kind == "write":
            # RACE001: write derives from a local bound from the SAME
            # attribute before an intervening await.
            for local in ev.uses_locals:
                b = binding.get(local)
                if b is None or b.attr != ev.attr:
                    continue
                if awaits_between(b.time, ev.time):
                    key = (ev.attr or "", ev.line)
                    if key not in seen_001:
                        seen_001.add(key)
                        shown = ("its own pre-await value"
                                 if local.startswith("<aug:")
                                 else repr(local))
                        race001.append((ev.line, (
                            f"read-modify-write across an await: "
                            f"{cls_name}.{ev.attr} is written from "
                            f"{shown} (read at line {b.line}) with an "
                            f"await in between — a concurrent update "
                            f"inside the window is silently lost; "
                            f"re-read and write within one atomic "
                            f"window, or route through a single owner "
                            f"task")))

    # A torn RMW's stale read would also register as a stale-guard use
    # on the same line; report the sharper RACE001 alone there.
    rmw_lines = {line for line, _ in race001}
    for line, msg in race001:
        em.emit("RACE001", line, qualname, msg)
    for line, msg in race002:
        if line not in rmw_lines:
            em.emit("RACE002", line, qualname, msg)


def _analyze_race003(em: FindingEmitter, info: _ClassInfo) -> None:
    if not info.owns_spawns:
        # Only task-owning classes have task entry points; passive
        # shared structures (Chan, NodeHealth) are covered by RACE001/2
        # plus the explorer's dynamic invariants.
        return
    roots = _roots_per_method(info)
    by_attr: dict[str, list[_MutationSite]] = {}
    for site in info.mutations:
        by_attr.setdefault(site.attr, []).append(site)
    for attr, sites in sorted(by_attr.items()):
        attr_roots: set[str] = set()
        for site in sites:
            attr_roots |= roots.get(site.method, set())
        task_roots = attr_roots - {_EXTERNAL_ROOT}
        if len(attr_roots) < 2 or not task_roots:
            continue
        anchor = min(sites, key=lambda s: s.line)
        names = ", ".join(sorted(
            r if r != _EXTERNAL_ROOT else "the external sync surface"
            for r in attr_roots))
        em.emit(
            "RACE003", anchor.line, f"{info.name}.{anchor.method}",
            f"shared {info.name}.{attr} is mutated from "
            f"{len(attr_roots)} distinct task entry points ({names}) "
            f"with no serialization point the lint can see — the "
            f"interleaving of those mutations is scheduler-chosen; "
            f"either serialize them (single owner task / channel) or "
            f"baseline this with the discipline that makes it safe "
            f"(e.g. append-only, atomic single-window updates)")


# -- entry points ------------------------------------------------------------


def lint_source(
    src: str,
    path: str,
    repo_root: str,
    shared_state: Optional[dict[str, frozenset[str]]] = None,
) -> list[Finding]:
    model = SHARED_STATE if shared_state is None else shared_state
    em = FindingEmitter(path, repo_root)
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        em.emit("RACE000", e.lineno or 0, "",
                f"file does not parse: {e.msg}")
        return em.findings

    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        shared = model.get(node.name)
        if shared is None:
            continue
        info = _collect_class(node, shared)
        for name, fn in info.methods.items():
            if isinstance(fn, ast.AsyncFunctionDef):
                _analyze_async_method(
                    em, node.name, f"{node.name}.{name}", fn, shared)
        _analyze_race003(em, info)
    em.findings.sort(key=lambda f: (f.line, f.rule))
    return em.findings


def lint_file(
    path: str,
    repo_root: str,
    shared_state: Optional[dict[str, frozenset[str]]] = None,
) -> list[Finding]:
    with open(path) as f:
        return lint_source(f.read(), path, repo_root,
                           shared_state=shared_state)
