# Copied from blance_tpu/testing/sched.py.
"""Deterministic schedule exploration for the asyncio control plane.

The orchestrator's fault tests exercise only the interleavings asyncio
happens to pick; a torn invariant under an unlucky schedule would slip
through forever.  This module makes the schedule a *controlled input*:

- :class:`DeterministicLoop` — a minimal event loop that drives real
  ``asyncio.Task``s but owns every scheduling decision.  The ready queue
  is stepped one handle at a time; whenever more than one runnable
  *origin* (task or callback) is ready, a :class:`SchedulePolicy` picks
  which runs next.  Time is virtual: when nothing is runnable the loop
  jumps straight to the earliest timer, so retry backoffs, ``wait_for``
  deadlines and breaker dwell times cost zero wall-clock.
- Policies — :class:`FifoPolicy` (asyncio-like baseline),
  :class:`RandomWalkPolicy` (seeded random walk: same seed, same
  schedule), :class:`PrefixPolicy` (follow a recorded choice prefix,
  FIFO after — the replay/exploration primitive).
- :func:`explore` — bounded-exhaustive enumeration of the choice tree,
  CHESS-style delay bounding: deviating from the FIFO head at a choice
  point costs one unit of ``branch_budget``; with budget ``None`` the
  enumeration is truly exhaustive (small toys), with budget *b* it
  covers every schedule reachable with at most *b* preemptions — the
  empirically race-rich neighborhood — in polynomial schedules.
- DPOR-lite reduction: ready handles are grouped by origin (steps of
  one task are program-ordered; interleaving them with themselves is
  meaningless), so the branch factor is the number of *concurrently
  runnable tasks*, not the raw ready-queue length.
- :class:`Trace` + :func:`save_trace`/:func:`load_trace`/:func:`replay`
  — a violating schedule serializes to JSON and replays exactly, so any
  race the explorer finds becomes a deterministic regression test.

Determinism contract: given a scenario coroutine that is itself
deterministic apart from scheduling (no wall-clock control flow, no
unseeded randomness — the orchestrator's retry jitter is seeded and
``FaultPlan`` is SHA-256-scripted), the pair (scenario, choices) fully
determines execution.  Step *labels* use loop-local task numbering, so
signatures are stable across processes too.
"""

from __future__ import annotations

import asyncio
import hashlib
import heapq
import itertools
import json
import random
from dataclasses import asdict, dataclass
from typing import Any, Callable, Coroutine, Optional

__all__ = [
    "DeadlockError",
    "StepLimitExceeded",
    "ReplayDivergence",
    "InvariantViolation",
    "SchedulePolicy",
    "FifoPolicy",
    "RandomWalkPolicy",
    "PrefixPolicy",
    "DeterministicLoop",
    "ScheduleOutcome",
    "run_controlled",
    "ExploreReport",
    "Violation",
    "explore",
    "Trace",
    "save_trace",
    "load_trace",
    "replay",
]


class DeadlockError(RuntimeError):
    """The main coroutine is not done, but nothing is runnable and no
    timer is pending — a genuine wedge, surfaced instead of hanging."""


class StepLimitExceeded(RuntimeError):
    """The scenario ran more steps than ``max_steps`` — a livelock (or a
    scenario that needs a bigger limit)."""


class ReplayDivergence(RuntimeError):
    """A recorded choice no longer fits the live choice tree (the code
    under test structurally changed since the trace was recorded)."""


class InvariantViolation(AssertionError):
    """A declared scenario invariant failed under the explored schedule."""


# -- scheduling policies -----------------------------------------------------


class SchedulePolicy:
    """Base policy: always run the FIFO head."""

    def choose(self, n_candidates: int) -> int:
        """Pick the index of the next runnable origin among
        ``n_candidates`` (called only when ``n_candidates > 1``)."""
        return 0


class FifoPolicy(SchedulePolicy):
    """asyncio-like baseline: strictly FIFO."""


class RandomWalkPolicy(SchedulePolicy):
    """Seeded random walk over the choice tree: same seed, same walk."""

    def __init__(self, seed: int) -> None:
        self.seed = seed
        self._rng = random.Random(seed)

    def choose(self, n_candidates: int) -> int:
        return self._rng.randrange(n_candidates)


class PrefixPolicy(SchedulePolicy):
    """Follow a recorded choice prefix, then FIFO.  The primitive both
    :func:`explore` (extend a prefix by one deviation) and
    :func:`replay` (full recorded schedule) are built from."""

    def __init__(self, prefix: list[int]) -> None:
        self.prefix = list(prefix)
        self._i = 0

    def choose(self, n_candidates: int) -> int:
        if self._i < len(self.prefix):
            c = self.prefix[self._i]
            self._i += 1
            if not 0 <= c < n_candidates:
                raise ReplayDivergence(
                    f"recorded choice #{self._i} = {c} but only "
                    f"{n_candidates} origins are runnable — the code "
                    f"under test changed shape since this trace was "
                    f"recorded")
            return c
        return 0


# -- the controlled loop -----------------------------------------------------


def _handle_origin(handle: Any) -> tuple[object, str]:
    """(grouping key, stable label) for one ready handle.

    Steps of the same task share an origin (they are program-ordered —
    scheduling them against each other is not a real interleaving, the
    DPOR-lite reduction).  Labels avoid ids/addresses so schedule
    signatures are stable across processes.
    """
    cb = getattr(handle, "_callback", None)
    owner = getattr(cb, "__self__", None)
    if isinstance(owner, asyncio.Task):
        return owner, owner.get_name()
    if owner is not None:
        return owner, type(owner).__name__
    name = getattr(cb, "__qualname__", None)
    return (cb if cb is not None else handle), (name or "callback")


class DeterministicLoop(asyncio.AbstractEventLoop):
    """A minimal, fully deterministic event loop for real asyncio code.

    Implements exactly the surface the control plane (tasks, futures,
    ``asyncio.wait``/``wait_for``/``sleep``/``Event``, ``csp.Chan``)
    needs: ``call_soon``/``call_later``/``call_at`` feed a ready list +
    virtual-time timer heap, and :meth:`run_until_complete` steps one
    handle at a time, asking the policy whenever >1 origin is runnable.
    Everything AbstractEventLoop declares beyond that raises
    ``NotImplementedError``, which is the point: a scenario that needs
    threads, signals or sockets is not a scenario this explorer can make
    deterministic.
    """

    def __init__(self, policy: Optional[SchedulePolicy] = None,
                 max_steps: int = 200_000) -> None:
        self._policy = policy or FifoPolicy()
        self._ready: list[Any] = []
        self._timers: list[tuple[float, int, Any]] = []
        self._vtime = 0.0
        self._seq = itertools.count()
        self._task_seq = itertools.count()
        self._max_steps = max_steps
        self._running = False
        self.steps = 0
        # One entry per CHOICE POINT (>1 runnable origin):
        self.choices: list[int] = []
        self.candidate_counts: list[int] = []
        # One label per executed step, for schedule signatures:
        self.step_log: list[str] = []
        self.unhandled: list[dict[str, Any]] = []

    # -- asyncio loop API (the subset tasks/futures/timeouts use) ----------

    def get_debug(self) -> bool:
        return False

    def is_running(self) -> bool:
        return self._running

    def is_closed(self) -> bool:
        return False

    def close(self) -> None:  # nothing to release; tests reuse loops
        return None

    def time(self) -> float:
        return self._vtime

    def call_soon(self, callback: Callable[..., object], *args: Any,
                  context: Any = None) -> asyncio.Handle:
        h = asyncio.Handle(callback, args, self, context=context)
        self._ready.append(h)
        return h

    def call_later(self, delay: float, callback: Callable[..., object],
                   *args: Any, context: Any = None) -> asyncio.TimerHandle:
        return self.call_at(self._vtime + max(delay, 0.0), callback,
                            *args, context=context)

    def call_at(self, when: float, callback: Callable[..., object],
                *args: Any, context: Any = None) -> asyncio.TimerHandle:
        th = asyncio.TimerHandle(when, callback, args, self, context=context)
        heapq.heappush(self._timers, (when, next(self._seq), th))
        setattr(th, "_scheduled", True)
        return th

    def _timer_handle_cancelled(self, handle: asyncio.TimerHandle) -> None:
        # Cancelled timers stay heap-resident and are skipped when due.
        return None

    def create_future(self) -> "asyncio.Future[Any]":
        return asyncio.Future(loop=self)

    def create_task(self, coro: Coroutine[Any, Any, Any], *,
                    name: Optional[str] = None,
                    context: Any = None) -> "asyncio.Task[Any]":
        # Loop-local deterministic naming: asyncio's default Task-N
        # counter is process-global, which would make step labels (and
        # thus schedule signatures) depend on unrelated earlier tests.
        if name is None:
            name = f"task-{next(self._task_seq)}"
        return asyncio.Task(coro, loop=self, name=name)

    def call_exception_handler(self, context: dict[str, Any]) -> None:
        self.unhandled.append(context)

    # -- deterministic stepping --------------------------------------------

    def _runnable(self) -> list[Any]:
        if any(h.cancelled() for h in self._ready):
            self._ready = [h for h in self._ready if not h.cancelled()]
        return self._ready

    def _candidates(self) -> list[int]:
        """Indices into _ready: the FIRST handle of each distinct origin,
        in FIFO order (the DPOR-lite grouping)."""
        seen: set[int] = set()
        out: list[int] = []
        for i, h in enumerate(self._ready):
            key = id(_handle_origin(h)[0])
            if key in seen:
                continue
            seen.add(key)
            out.append(i)
        return out

    def run_until_complete(self, future: Coroutine[Any, Any, Any]) -> Any:
        main = self.create_task(future, name="main")
        asyncio.events._set_running_loop(self)
        self._running = True
        try:
            while not main.done():
                if not self._runnable():
                    if not self._timers:
                        # Surface the wedge with the frontier visible.
                        raise DeadlockError(
                            f"deadlock after {self.steps} steps at "
                            f"t={self._vtime:.6f}: main not done, no "
                            f"runnable callbacks, no pending timers")
                    when = self._timers[0][0]
                    self._vtime = max(self._vtime, when)
                    while self._timers and self._timers[0][0] <= self._vtime:
                        _, _, th = heapq.heappop(self._timers)
                        if not th.cancelled():
                            self._ready.append(th)
                    continue
                cands = self._candidates()
                if len(cands) > 1:
                    pick = self._policy.choose(len(cands))
                    self.choices.append(pick)
                    self.candidate_counts.append(len(cands))
                else:
                    pick = 0
                handle = self._ready.pop(cands[pick])
                self.steps += 1
                if self.steps > self._max_steps:
                    raise StepLimitExceeded(
                        f"exceeded {self._max_steps} steps — livelock, "
                        f"or raise max_steps for this scenario")
                self.step_log.append(_handle_origin(handle)[1])
                handle._run()
        finally:
            try:
                self._drain_pending()
            finally:
                self._running = False
                asyncio.events._set_running_loop(None)
        return main.result()

    def _drain_pending(self) -> None:
        """Cancel every task the run left behind (a violating or
        deadlocked schedule abandons its orchestration mid-flight) and
        step their cancellation unwinding to completion, FIFO and
        unlogged, so abandoned coroutines do not surface as
        'never awaited' GC warnings in the host process."""
        pending = [t for t in asyncio.all_tasks(self) if not t.done()]
        for t in pending:
            t.cancel()
        budget = 10_000
        while any(not t.done() for t in pending) and budget > 0:
            if not self._runnable():
                if not self._timers:
                    break
                when = self._timers[0][0]
                self._vtime = max(self._vtime, when)
                while self._timers and self._timers[0][0] <= self._vtime:
                    _, _, th = heapq.heappop(self._timers)
                    if not th.cancelled():
                        self._ready.append(th)
                continue
            budget -= 1
            self._ready.pop(0)._run()
        for t in pending:
            if t.done() and not t.cancelled():
                t.exception()  # mark retrieved


# -- one controlled run ------------------------------------------------------


@dataclass
class ScheduleOutcome:
    """Everything one controlled run produced."""

    ok: bool
    result: Any
    error: Optional[BaseException]
    deadlock: bool
    choices: list[int]
    candidate_counts: list[int]
    steps: int
    signature: str

    def describe(self) -> str:
        if self.ok:
            return f"ok ({self.steps} steps, {len(self.choices)} choices)"
        kind = "deadlock" if self.deadlock else type(self.error).__name__
        return f"{kind}: {self.error} (choices={self.choices})"


def _signature(step_log: list[str]) -> str:
    return hashlib.sha256("\n".join(step_log).encode()).hexdigest()[:16]


def run_controlled(
    factory: Callable[[], Coroutine[Any, Any, Any]],
    policy: Optional[SchedulePolicy] = None,
    max_steps: int = 200_000,
) -> ScheduleOutcome:
    """Run one scenario coroutine under one schedule.

    ``factory`` must build a FRESH coroutine (and fresh orchestrator /
    channels / state) per call — exploration runs it many times.
    Scenario failures (any exception out of the coroutine, including
    :class:`InvariantViolation`), deadlocks and step-limit breaches all
    land in the outcome instead of raising, so exploration drivers can
    keep going.  :class:`ReplayDivergence` propagates: a stale trace is
    a test-maintenance signal, not a race.
    """
    loop = DeterministicLoop(policy, max_steps=max_steps)
    result: Any = None
    error: Optional[BaseException] = None
    deadlock = False
    try:
        result = loop.run_until_complete(factory())
    except ReplayDivergence:
        raise
    except DeadlockError as e:
        error, deadlock = e, True
    except StepLimitExceeded as e:
        error = e
    except Exception as e:  # scenario invariant/assert failures
        # KeyboardInterrupt/SystemExit deliberately propagate: an
        # operator interrupting a long explore() must stop the whole
        # enumeration, not mint a bogus per-schedule violation.
        error = e
    return ScheduleOutcome(
        ok=error is None,
        result=result,
        error=error,
        deadlock=deadlock,
        choices=list(loop.choices),
        candidate_counts=list(loop.candidate_counts),
        steps=loop.steps,
        signature=_signature(loop.step_log),
    )


# -- bounded-exhaustive exploration ------------------------------------------


@dataclass
class Violation:
    """One schedule that broke the scenario, replayable via its choices."""

    choices: list[int]
    candidate_counts: list[int]
    error: str
    error_type: str
    deadlock: bool
    signature: str

    def to_trace(self, scenario: str, note: str = "") -> "Trace":
        return Trace(scenario=scenario, choices=list(self.choices),
                     candidate_counts=list(self.candidate_counts),
                     note=note or f"{self.error_type}: {self.error}")


@dataclass
class ExploreReport:
    """What :func:`explore` covered and what it found."""

    schedules: int
    violations: list[Violation]
    complete: bool  # the frontier drained (within the branch budget)
    capped: bool  # stopped early on max_schedules
    branch_budget: Optional[int]

    def summary(self) -> str:
        cov = ("exhaustive" if self.branch_budget is None
               else f"budget={self.branch_budget}")
        state = "complete" if self.complete else "CAPPED"
        return (f"{self.schedules} schedules ({cov}, {state}), "
                f"{len(self.violations)} violating")


def explore(
    factory: Callable[[], Coroutine[Any, Any, Any]],
    branch_budget: Optional[int] = 2,
    max_schedules: int = 5000,
    max_steps: int = 200_000,
    stop_on_first: bool = False,
) -> ExploreReport:
    """Enumerate schedules depth-first over the choice tree.

    Deviating from the FIFO head (choice != 0) at a choice point spends
    one unit of ``branch_budget`` (CHESS-style delay bounding); FIFO
    choices are free.  ``branch_budget=None`` removes the bound — a true
    exhaustive enumeration, feasible only for small toys.  Every run's
    un-deviated suffix seeds new prefixes, so the tree is covered
    without revisiting a schedule (each prefix is a distinct schedule).
    """
    stack: list[list[int]] = [[]]
    violations: list[Violation] = []
    runs = 0
    while stack:
        if runs >= max_schedules:
            return ExploreReport(schedules=runs, violations=violations,
                                 complete=False, capped=True,
                                 branch_budget=branch_budget)
        prefix = stack.pop()
        out = run_controlled(factory, PrefixPolicy(prefix),
                             max_steps=max_steps)
        runs += 1
        if not out.ok:
            err = out.error
            violations.append(Violation(
                choices=out.choices,
                candidate_counts=out.candidate_counts,
                error=str(err),
                error_type=type(err).__name__ if err else "",
                deadlock=out.deadlock,
                signature=out.signature,
            ))
            if stop_on_first:
                return ExploreReport(
                    schedules=runs, violations=violations, complete=False,
                    capped=False, branch_budget=branch_budget)
        spent = sum(1 for c in prefix if c != 0)
        if branch_budget is not None and spent >= branch_budget:
            continue
        # Each choice point past the prefix ran FIFO (0); branch into
        # every deviation.  LIFO order = depth-first.
        for j in range(len(prefix), len(out.candidate_counts)):
            for k in range(1, out.candidate_counts[j]):
                stack.append(out.choices[:j] + [k])
    return ExploreReport(schedules=runs, violations=violations,
                         complete=True, capped=False,
                         branch_budget=branch_budget)


# -- trace files -------------------------------------------------------------

TRACE_VERSION = 1


@dataclass
class Trace:
    """A serialized schedule: enough to replay one run exactly."""

    scenario: str
    choices: list[int]
    candidate_counts: list[int]
    note: str = ""
    seed: Optional[int] = None
    version: int = TRACE_VERSION


def save_trace(trace: Trace, path: str) -> None:
    with open(path, "w") as f:
        json.dump(asdict(trace), f, indent=2, sort_keys=True)
        f.write("\n")


def load_trace(path: str) -> Trace:
    with open(path) as f:
        data = json.load(f)
    known = {"scenario", "choices", "candidate_counts", "note", "seed",
             "version"}
    unknown = set(data) - known
    if unknown:
        raise ValueError(f"{path}: unknown trace keys {sorted(unknown)}")
    if data.get("version") != TRACE_VERSION:
        raise ValueError(
            f"{path}: trace version {data.get('version')!r} != "
            f"{TRACE_VERSION} (regenerate with the current explorer)")
    return Trace(
        scenario=str(data["scenario"]),
        choices=[int(c) for c in data["choices"]],
        candidate_counts=[int(c) for c in data["candidate_counts"]],
        note=str(data.get("note", "")),
        seed=data.get("seed"),
    )


def replay(
    factory: Callable[[], Coroutine[Any, Any, Any]],
    trace: Trace,
    max_steps: int = 200_000,
    strict: bool = True,
) -> ScheduleOutcome:
    """Re-run a scenario under a recorded schedule.

    With ``strict`` (the default for committed regression traces), the
    live choice tree must still match the recorded candidate counts for
    the replayed prefix — a mismatch means the control plane changed
    shape and the trace needs regenerating, which should be a loud
    signal, not a silently different schedule.
    """
    out = run_controlled(factory, PrefixPolicy(trace.choices),
                         max_steps=max_steps)
    if strict:
        n = len(trace.candidate_counts)
        live = out.candidate_counts[:n]
        if live != trace.candidate_counts:
            raise ReplayDivergence(
                f"trace for scenario {trace.scenario!r} no longer fits: "
                f"recorded candidate counts {trace.candidate_counts} vs "
                f"live {live} — regenerate the trace")
    return out
