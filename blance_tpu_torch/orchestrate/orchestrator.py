# Copied from blance_tpu/orchestrate/orchestrator.py; OrchestratorOptions
# gains ``device``, where the batched diff runs when ``device_diff`` is set.
"""Rebalance orchestrator: executes map-to-map transitions cluster-wide.

Reimplements the reference's control plane (reference:
orchestrate.go:80-763) on asyncio: one mover task per node, a supplier task
running broadcast rounds, per-node concurrency limits, app-controlled move
prioritization, pause/resume/stop, and a blocking progress stream.

Round structure (orchestrate.go:509-618): each round groups every
partition's *current* move by destination node, spawns one feeder per node
with that node's best k moves, and the FIRST successful feed interrupts all
other feeders so availability is recomputed — this keeps the whole cluster's
choices fresh as work completes.  A feeder that finds its batch already
in-flight waits on that move instead of double-feeding
(orchestrate.go:622-696).

The app's assign_partitions callback is the only data plane — the
orchestrator never moves bytes itself, so it is transport-agnostic by
construction (orchestrate.go:148-152).
"""

from __future__ import annotations

import asyncio
import inspect
import random
import warnings as _warnings
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Awaitable, Callable, Optional, Union

from ..core.types import Partition, PartitionMap, PartitionModel
from ..moves.calc import calc_partition_moves
from ..obs import get_recorder
from ..core.order import sort_state_names
from .csp import Chan, select, GET, PUT
from .health import HealthTracker
# The app-weight ordering lives in the sched package
# (LegacyWeightOrder behind the scheduler interface); re-exported here
# unchanged so every existing import site keeps working.
from .sched.policy import (
    MOVE_OP_WEIGHT,
    BoundScheduler,
    LegacyWeightOrder,
    SchedulerPolicy,
    lowest_weight_partition_move_for_node,
)

if TYPE_CHECKING:  # annotation-only; obs.slo must not import us back
    from ..obs.slo import MoveObserver

__all__ = [
    "ErrorStopped",
    "ErrorInterrupt",
    "MissingMoverError",
    "MoveFailure",
    "MoveTimeoutError",
    "NodeQuarantinedError",
    "Orchestrator",
    "OrchestratorOptions",
    "OrchestratorProgress",
    "PartitionMove",
    "NextMoves",
    "MOVE_OP_WEIGHT",
    "lowest_weight_partition_move_for_node",
    "orchestrate_moves",
]


class StoppedError(Exception):
    """The operation was stopped (reference orchestrate.go:18)."""


class InterruptError(Exception):
    """The operation was interrupted by a broadcast (orchestrate.go:21)."""


# Sentinel singletons, compared by identity like the reference's error vars.
ErrorStopped = StoppedError("stopped")
ErrorInterrupt = InterruptError("interrupt")


class MoveTimeoutError(Exception):
    """An assign callback exceeded OrchestratorOptions.move_timeout_s."""

    def __init__(self, node: str, timeout_s: float) -> None:
        super().__init__(f"assign_partitions for node {node!r} exceeded "
                         f"move deadline {timeout_s}s")
        self.node = node
        self.timeout_s = timeout_s


class NodeQuarantinedError(Exception):
    """A batch was released unexecuted: its node is quarantined."""

    def __init__(self, node: str) -> None:
        super().__init__(f"node {node!r} is quarantined")
        self.node = node


class MissingMoverError(Exception):
    """A move targets a node outside nodes_all — no mover will ever
    serve it (reference orchestrate.go:667 nil-channel semantics)."""

    def __init__(self, node: str) -> None:
        super().__init__(f"move targets node {node!r} which has no mover "
                         f"(not in nodes_all)")
        self.node = node


@dataclass(eq=False)  # exception identity semantics; stays hashable
class MoveFailure(Exception):
    """One partition move that fault-tolerant orchestration gave up on.

    Replaces the bare exception of the legacy path when the options
    enable deadlines/retries/quarantine: carries exactly which (node,
    partition, state, op) failed, how many attempts were burned, and the
    last underlying cause (app exception, MoveTimeoutError,
    NodeQuarantinedError, or MissingMoverError).  Flows through
    progress.errors and ``Orchestrator.move_failures()``; the recovery
    replan (rebalance_async) consumes it."""

    node: str
    partition: str
    state: str
    op: str
    attempts: int
    cause: object

    def __post_init__(self) -> None:
        Exception.__init__(
            self, f"move failed: partition={self.partition!r} "
            f"node={self.node!r} state={self.state!r} op={self.op!r} "
            f"attempts={self.attempts} cause={self.cause!r}")


@dataclass
class OrchestratorOptions:
    """Advanced config (orchestrate.go:110-115 + scale extensions)."""

    # <= 0 is treated as 1 (orchestrate.go:484-487).
    max_concurrent_partition_moves_per_node: int = 1
    favor_min_nodes: bool = False

    # -- fault-tolerance extensions (not in the reference; ALL unset =>
    #    the reference's exact failure semantics: an app error aborts the
    #    orchestration, a hung callback stalls its mover, a moverless
    #    target blocks until stop).  Setting any of them turns a
    #    timed-out or retry-exhausted move into a structured MoveFailure
    #    recorded in progress.errors, and the orchestration continues
    #    with the remaining partitions. --
    # Per-move deadline for ASYNC assign callbacks (a sync callback
    # blocks the loop and cannot be preempted); a breach counts as a
    # failed attempt with a MoveTimeoutError cause.
    move_timeout_s: Optional[float] = None
    # Failed attempts are retried up to this many times with exponential
    # backoff: base * 2^attempt * (1 + jitter * u), u drawn from a
    # Random(retry_seed) so schedules are reproducible.
    max_retries: int = 0
    backoff_base_s: float = 0.05
    backoff_jitter: float = 0.25
    retry_seed: int = 0
    # Circuit breaker: this many CONSECUTIVE failed attempts quarantine a
    # node (0 disables).  Queued batches for a quarantined node are
    # released immediately as MoveFailures; after probe_after_s one probe
    # batch at a time is admitted and a success re-opens the node
    # (orchestrate/health.py).
    quarantine_after: int = 0
    probe_after_s: float = 1.0
    # Externally-owned HealthTracker (e.g. carried across the recovery
    # rounds of one rebalance); when set, quarantine_after/probe_after_s
    # are ignored in favor of the tracker's own thresholds.
    health: Optional[HealthTracker] = None

    @property
    def fault_tolerant(self) -> bool:
        """True when any fault-tolerance option deviates from defaults."""
        return (self.move_timeout_s is not None or self.max_retries > 0
                or self.quarantine_after > 0 or self.health is not None)

    # -- scale extensions (not in the reference) --
    # True (reference semantics, orchestrate.go:566-580): the first
    # successful feed each round interrupts all other feeders, so
    # availability is recomputed after every accepted batch — freshest
    # choices, but rounds commit ~one batch each.  False: every node's
    # feeder completes its feed before the next round, so a round commits
    # up to len(nodes) batches — the throughput mode for 10k+ partition
    # rebalances, where per-batch recomputes would be quadratic.
    interrupt_on_first_feed: bool = True
    # Compute the up-front per-partition move plans with the batched
    # on-device diff (moves/batch.py) instead of the per-partition host
    # loop.  Identical op lists; worthwhile from ~10k partitions up.
    device_diff: bool = False
    # Where the batched diff runs (read only when device_diff is set):
    # the card unless the caller asks for the CPU.
    device: str = "cuda"
    # Move-ordering policy (orchestrate/sched, docs/SCHEDULER.md).
    # None = the reference's app-weight order (LegacyWeightOrder), the
    # pinned default.  CriticalPathScheduler turns the flat move list
    # into a critical-path-prioritized schedule minimizing rebalance
    # MAKESPAN on calibrated per-(node, op) costs — the final map and
    # move set stay bit-identical, only the order (and the clock)
    # changes.  Mutually exclusive with a custom find_move callback.
    scheduler: Optional[SchedulerPolicy] = None
    # -- durability extension (docs/DURABILITY.md) --
    # Fenced epoch for the journal directory this orchestration serves
    # (durability/epoch.py EpochFence; duck-typed `current`/`valid` so
    # this layer needs no durability import).  The orchestrator captures
    # the epoch ONCE at construction and re-checks it at every batch
    # completion: a callback resolving after a crash recovery bumped the
    # fence is a zombie — its outcome is rejected and counted
    # (durability.stale_epoch_rejections), never applied to the achieved
    # map or shown to observers.  None disables fencing (the default:
    # one-shot rebalances have no journal to protect).
    epoch_fence: Optional[Any] = None


@dataclass
class OrchestratorProgress:
    """Monotonic progress counters + errors, streamed as whole snapshots
    (orchestrate.go:119-141)."""

    errors: list[Exception] = field(default_factory=list)

    tot_stop: int = 0
    tot_pause_new_assignments: int = 0
    tot_resume_new_assignments: int = 0
    tot_run_mover: int = 0
    tot_run_mover_done: int = 0
    tot_run_mover_done_err: int = 0
    tot_mover_loop: int = 0
    tot_mover_assign_partition: int = 0
    tot_mover_assign_partition_ok: int = 0
    tot_mover_assign_partition_err: int = 0
    tot_run_supply_moves_loop: int = 0
    tot_run_supply_moves_loop_done: int = 0
    tot_run_supply_moves_feeding: int = 0
    tot_run_supply_moves_feeding_done: int = 0
    tot_run_supply_moves_done: int = 0
    tot_run_supply_moves_done_err: int = 0
    tot_run_supply_moves_pause: int = 0
    tot_run_supply_moves_resume: int = 0
    tot_progress_close: int = 0

    # -- fault-tolerance counters (always 0 in legacy mode) --
    tot_mover_assign_partition_retry: int = 0
    tot_mover_assign_partition_timeout: int = 0
    tot_mover_quarantine_reject: int = 0
    tot_quarantine_trips: int = 0
    tot_move_failures: int = 0
    # Supersede cancellations (Orchestrator.cancel): a newer cluster
    # delta invalidated this transition mid-flight and the control loop
    # resumed from achieved_map() instead of letting it finish.
    tot_cancel: int = 0

    def snapshot(self) -> "OrchestratorProgress":
        # One snapshot per progress event: a shallow __dict__ copy is
        # ~4x cheaper than dataclasses.replace (which re-runs __init__
        # over all 20 fields); only `errors` needs its own list.
        new = object.__new__(type(self))  # keep subclass snapshots typed
        new.__dict__.update(self.__dict__)
        new.errors = list(self.errors)
        return new


@dataclass(frozen=True)
class PartitionMove:
    """A state change/op for one partition on one node (orchestrate.go:162-172)."""

    partition: str
    node: str
    state: str  # "" means removal
    op: str  # "add" | "del" | "promote" | "demote"


class NextMoves:
    """Cursor over one partition's immutable move sequence
    (orchestrate.go:198-214)."""

    __slots__ = ("partition", "next", "moves", "next_done_ch", "failed_at")

    def __init__(self, partition: str, moves: list[PartitionMove]) -> None:
        self.partition = partition
        self.next = 0  # index of the next available move
        self.moves = moves
        # Non-None while the current move is in flight; == the feeding
        # request's done channel.
        self.next_done_ch: Optional[Chan] = None
        # Fault-tolerant mode: index of the move that failed when this
        # partition was abandoned (its remaining moves are skipped;
        # ``next`` jumps to len(moves) so availability drops it).  None
        # while healthy — and always None in legacy mode.
        self.failed_at: Optional[int] = None


class _PartitionMoveReq:
    """A batch of moves for one node + completion channel (orchestrate.go:220-223).

    ``t_created`` stamps the feeder's creation time (on the Recorder's
    clock, so virtual time under DeterministicLoop) so the mover that
    eventually dequeues the batch can attribute queue/concurrency wait
    separately from callback execution (the ``orchestrate.move`` span)."""

    __slots__ = ("partition_moves", "done_ch", "t_created")

    def __init__(self, partition_moves: list[PartitionMove], done_ch: Chan,
                 t_created: float) -> None:
        self.partition_moves = partition_moves
        self.done_ch = done_ch
        self.t_created = t_created


AssignPartitionsFunc = Callable[..., Union[Optional[Exception], Awaitable]]
FindMoveFunc = Callable[[str, list[PartitionMove]], int]


class Orchestrator:
    """Runtime state of one orchestrate_moves() run (orchestrate.go:80-106)."""

    def __init__(
        self,
        model: PartitionModel,
        options: OrchestratorOptions,
        nodes_all: list[str],
        beg_map: PartitionMap,
        end_map: PartitionMap,
        assign_partitions: AssignPartitionsFunc,
        find_move: Optional[FindMoveFunc],
        map_partition_to_next_moves: dict[str, NextMoves],
        move_observers: "tuple[MoveObserver, ...]" = (),
    ) -> None:
        self.model = model
        self.options = options
        self.nodes_all = nodes_all
        self.beg_map = beg_map
        self.end_map = end_map
        self._assign_partitions = assign_partitions
        self._find_move = find_move or lowest_weight_partition_move_for_node

        self._progress_ch = Chan()
        self._map_node_to_req_ch = {node: Chan() for node in nodes_all}

        self._stop_ch: Optional[Chan] = Chan()
        self._pause_ch: Optional[Chan] = None
        self._progress = OrchestratorProgress()
        self._map_partition_to_next_moves = map_partition_to_next_moves

        self._tasks: list["asyncio.Task[object]"] = []
        # Monotone spawn counter: gives every orchestration task a
        # stable, human-readable name (mover/supplier/feeder + ordinal).
        # The schedule explorer (testing/sched.py) keys its step labels
        # — and therefore schedule signatures — off task names, so this
        # is the hook that makes explorer traces legible.
        self._spawn_seq = 0
        # Every progress counter is mirrored into the obs Recorder
        # (orchestrate.tot_*) as it increments, so one sink sees the
        # progress stream, the planner spans, and the move lifecycle
        # together.  Bound once: a rebalance reports to the recorder that
        # was installed when it started.  The recorder's clock is also
        # the orchestrator's ONLY time source (queue waits, exec
        # timings), so an injected virtual clock covers the whole move
        # lifecycle deterministically.
        self._rec = get_recorder()
        # Move observers (obs.slo.MoveObserver): notified synchronously
        # after every batch outcome with (node, moves, ok, now) — the
        # SLO plane's incremental achieved-map delta feed.  Immutable
        # after init; callbacks must be plain sync code.
        self._observers: "tuple[MoveObserver, ...]" = tuple(move_observers)

        # Move-ordering policy (orchestrate/sched): every run binds one
        # — LegacyWeightOrder when options leave the default, which
        # selects byte-identically to the pre-extraction app-weight
        # code.  A custom find_move callback and a scheduler are
        # mutually exclusive: both claim the same decision.
        policy = options.scheduler
        if policy is not None and \
                self._find_move is not lowest_weight_partition_move_for_node:
            raise ValueError(
                "OrchestratorOptions.scheduler and a custom find_move "
                "callback are mutually exclusive — both decide which "
                "move a node runs next")
        if policy is None:
            policy = LegacyWeightOrder()
        self.sched: BoundScheduler = policy.bind(
            nodes_all, map_partition_to_next_moves,
            options.max_concurrent_partition_moves_per_node, self._rec)
        if self.sched.observes_batches:
            self._observers = self._observers + (self.sched,)

        # -- fault tolerance (all inert when options keep the defaults) --
        self._ft = options.fault_tolerant
        self.failures: list[MoveFailure] = []
        if options.health is not None:
            self.health: Optional[HealthTracker] = options.health
        elif options.quarantine_after > 0:
            # The breaker shares the recorder's clock so quarantine
            # dwell/exposure accounting and the SLO gauges agree (and
            # all follow virtual time when a test injects one);
            # perf_counter and monotonic have unrelated epochs, so
            # mixing them would corrupt exposure arithmetic.
            self.health = HealthTracker(
                threshold=options.quarantine_after,
                probe_after_s=options.probe_after_s,
                clock=self._rec.now)
        else:
            self.health = None
        self._retry_rng = random.Random(options.retry_seed)
        # Fenced epoch, captured ONCE: if a crash recovery bumps the
        # fence mid-flight, every later completion in this run reads as
        # stale and is rejected (see _mover_loop).
        self._epoch = (options.epoch_fence.current
                       if options.epoch_fence is not None else 0)
        self._missing_mover_warned: set[str] = set()
        # Set by the supplier AFTER the progress channel closes: the
        # whole wind-down (movers exited, feeders resolved) is complete.
        # The supersede path (RebalanceController) awaits it so a
        # cancelled transition leaves no orphan tasks behind.
        self._drained = asyncio.Event()

    # -- public control surface ---------------------------------------------

    def progress_ch(self) -> Chan:
        """Progress snapshot stream; MUST be drained until close or the
        orchestration wedges (documented requirement, orchestrate.go:230-232).
        Iterate with ``async for``."""
        return self._progress_ch

    def stop(self) -> None:
        """Idempotent async stop; the progress channel eventually closes
        (orchestrate.go:342-350)."""
        if self._stop_ch is not None:
            self._bump_sync("tot_stop")
            self._stop_ch.close()
            self._stop_ch = None

    def cancel(self) -> None:
        """Supersede: stop the transition because a newer cluster delta
        invalidated its end map.  Semantically a stop() — in-flight
        callbacks finish or fail like any stop — but counted separately
        (``tot_cancel``) so dashboards can tell an operator stop from a
        control-loop supersede.  Resume from ``achieved_map()`` once
        :meth:`wait_drained` returns.  Idempotent."""
        if self._stop_ch is not None:
            self._bump_sync("tot_cancel")
        self.stop()

    async def wait_drained(self) -> None:
        """Block until the orchestration has fully wound down — the
        supplier closed the progress stream after every mover exited.
        The progress channel must still be drained by its consumer (the
        documented requirement); this is the rendezvous for a SECOND
        party (the control loop's supersede path) that needs the
        wind-down without owning the drain."""
        await self._drained.wait()

    def pending_tasks(self) -> "list[asyncio.Task[object]]":
        """Orchestration tasks not yet finished — the no-orphan-tasks
        probe the supersede explorer scenario asserts empty after a
        cancel + wait_drained (a just-resolved mover may need one more
        loop tick to finalize)."""
        return [t for t in self._tasks if not t.done()]

    def pause_new_assignments(self) -> None:
        """Stop starting new assignments; in-flight moves finish.  Idempotent
        (orchestrate.go:367-375)."""
        if self._pause_ch is None:
            self._pause_ch = Chan()
            self._bump_sync("tot_pause_new_assignments")

    def resume_new_assignments(self) -> None:
        """Idempotent resume (orchestrate.go:379-388)."""
        if self._pause_ch is not None:
            self._bump_sync("tot_resume_new_assignments")
            self._pause_ch.close()
            self._pause_ch = None

    def visit_next_moves(
            self, cb: Callable[[dict[str, NextMoves]], None]) -> None:
        """Read access to the live move cursors, e.g. for UIs
        (orchestrate.go:395-399)."""
        cb(self._map_partition_to_next_moves)

    def move_failures(self) -> list[MoveFailure]:
        """Structured failures collected so far (fault-tolerant mode
        only; legacy mode aborts on the first error instead).  Complete
        once progress_ch() has closed."""
        return list(self.failures)

    def achieved_map(self) -> PartitionMap:
        """Reconstruct the map the cluster actually reached: beg_map with
        every SUCCESSFULLY executed move applied, per partition, up to
        its cursor (an abandoned partition counts its moves up to the
        one that failed — a failed batch is assumed not applied).

        This is the honest ``current_map`` for a failure-aware recovery
        replan; call after progress_ch() closes (mid-run it reflects the
        in-flight frontier, which is fine for dashboards but racy as a
        replan input)."""
        achieved: PartitionMap = {}
        for name, beg in self.beg_map.items():
            nbs = {s: list(ns) for s, ns in beg.nodes_by_state.items()}
            nm = self._map_partition_to_next_moves.get(name)
            upto = 0 if nm is None else (
                nm.failed_at if nm.failed_at is not None else nm.next)
            for mv in (nm.moves[:upto] if nm is not None else ()):
                for ns in nbs.values():
                    if mv.node in ns:
                        ns.remove(mv.node)
                if mv.state:  # "" = removal (the "del" op)
                    nbs.setdefault(mv.state, []).append(mv.node)
            achieved[name] = Partition(name, nbs)
        return achieved

    # -- internals -----------------------------------------------------------

    def _spawn(self, coro: Awaitable[object]) -> "asyncio.Task[object]":
        """Spawn an orchestration task with its exception OBSERVED.

        A bare ``ensure_future`` whose result nobody awaits is the
        asyncio bug class the static suite flags (analysis/asyncio_lint
        ASY101): the Task can be garbage-collected mid-run, and an
        escaped exception surfaces only as a destructor warning long
        after the orchestration wedged.  Every mover/supplier/feeder
        goes through here instead: the task is retained in
        ``self._tasks`` (pruned as tasks finish, so thousands of feeder
        rounds don't accumulate) and a done-callback retrieves its
        exception — escaped ones (loop bugs; app errors are converted to
        move errors before they can escape) are surfaced as a
        UserWarning plus an ``orchestrate.task_exceptions`` counter
        instead of vanishing."""
        task = asyncio.ensure_future(coro)
        if isinstance(task, asyncio.Task):
            self._spawn_seq += 1
            task.set_name(
                f"{getattr(coro, '__qualname__', 'orchestrate-task')}"
                f"-{self._spawn_seq}")
        self._tasks = [t for t in self._tasks if not t.done()]
        self._tasks.append(task)

        def _observe(t: "asyncio.Task[object]") -> None:
            if t.cancelled():
                return
            exc = t.exception()  # marks the exception retrieved
            if exc is not None:
                self._rec.count("orchestrate.task_exceptions")
                _warnings.warn(
                    f"blance_tpu_torch orchestrate: internal task died with "
                    f"{type(exc).__name__}: {exc}", UserWarning)

        task.add_done_callback(_observe)
        return task

    def _start(self, stop_ch: Chan) -> None:
        run_mover_done_ch = Chan()
        for node in self.nodes_all:
            self._spawn(self._run_mover(stop_ch, run_mover_done_ch, node))
        self._spawn(self._run_supply_moves(stop_ch, run_mover_done_ch))

    async def _update_progress(self, mutate: Callable[[], None]) -> None:
        """Apply a counter mutation and blocking-send a snapshot
        (orchestrate.go:735-745)."""
        mutate()
        await self._progress_ch.put(self._progress.snapshot())

    def _bump_sync(self, *names: str) -> None:
        """Increment progress counters, mirrored into the Recorder."""
        for name in names:
            setattr(self._progress, name, getattr(self._progress, name) + 1)
            self._rec.count("orchestrate." + name)

    async def _bump(self, *names: str) -> None:
        """_bump_sync + blocking progress snapshot — the one spelling every
        counter-only progress event goes through."""
        await self._update_progress(lambda: self._bump_sync(*names))

    async def _call_assign(
        self, stop_ch: Chan, node: str, partitions: list[str],
        states: list[str], ops: list[str],
    ) -> Optional[Exception]:
        """Invoke the app callback (sync or async); exceptions become the
        move's error.  With ``move_timeout_s`` set, an ASYNC callback
        that outlives the deadline is cancelled and the attempt fails
        with MoveTimeoutError (sync callbacks block the loop and cannot
        be preempted — use an async data plane for deadlines)."""
        timeout_s = self.options.move_timeout_s
        try:
            result = self._assign_partitions(stop_ch, node, partitions, states, ops)
            if inspect.isawaitable(result):
                if timeout_s is not None:
                    # The TimeoutError handler is scoped to wait_for ONLY,
                    # and a deadline breach is distinguished from the app
                    # RAISING TimeoutError itself (on 3.11+
                    # asyncio.TimeoutError IS builtin TimeoutError, e.g. a
                    # socket timeout) by whether wait_for cancelled the
                    # callback: only a breach does.  An app-raised timeout
                    # flows through as the app's error, never rebranded.
                    fut = asyncio.ensure_future(result)
                    try:
                        result = await asyncio.wait_for(fut, timeout_s)
                    except asyncio.TimeoutError as exc:
                        if not fut.cancelled():
                            return exc  # the app's own TimeoutError
                        self._rec.count("orchestrate.timeouts")
                        self._bump_sync("tot_mover_assign_partition_timeout")
                        return MoveTimeoutError(node, timeout_s)
                else:
                    result = await result
        except Exception as exc:  # app errors flow into progress.errors
            return exc
        return result if isinstance(result, Exception) else None

    async def _wait_or_stop(self, stop_ch: Chan, delay_s: float) -> bool:
        """Sleep ``delay_s``, aborting early when stop fires; True means
        the orchestration was stopped.  Backoff must never outlive
        stop(): a 30 s retry backoff on a dead node would otherwise hold
        the whole wind-down hostage."""
        if stop_ch.closed:
            return True
        getter = asyncio.ensure_future(stop_ch.get())
        done, _pending = await asyncio.wait({getter}, timeout=delay_s)
        if getter not in done:
            # csp.Chan tolerates cancelled waiters: close() skips
            # completed/cancelled futures instead of resolving them.
            getter.cancel()
            try:
                await getter
            except asyncio.CancelledError:
                pass
            # Eagerly drop the abandoned waiter: the stop channel is
            # shared by every mover, and one dead getter per expired
            # backoff would otherwise accumulate until close().
            stop_ch._gc()
        return stop_ch.closed

    async def _exec_with_retries(
        self, stop_ch: Chan, node: str, partitions: list[str],
        states: list[str], ops: list[str],
    ) -> tuple[Optional[Exception], int]:
        """One batch execution under the fault-tolerance policy: bounded
        retries with exponential backoff + deterministic jitter, per-
        attempt health reporting.  Returns (err, attempts); legacy mode
        (no FT options) is exactly one _call_assign."""
        opts = self.options
        max_attempts = 1 + (max(opts.max_retries, 0) if self._ft else 0)
        attempt = 0
        while True:
            attempt += 1
            err = await self._call_assign(stop_ch, node, partitions,
                                          states, ops)
            if err is None:
                if self.health is not None and \
                        self.health.record_success(node):
                    # The probe healed the node: its lanes rejoin the
                    # machine model (no-op for legacy order).
                    self.sched.on_heal(node)
                return None, attempt
            tripped = False
            if self.health is not None:
                tripped = self.health.record_failure(node)
                if tripped:
                    self._bump_sync("tot_quarantine_trips")
                    # Online reschedule: the node's lanes just left the
                    # machine model; the scheduler rebuilds priorities
                    # from the remaining DAG (no-op for legacy order).
                    self.sched.on_quarantine(node)
            if not self._ft or attempt >= max_attempts or tripped:
                return err, attempt
            delay = opts.backoff_base_s * (2.0 ** (attempt - 1))
            delay *= 1.0 + max(opts.backoff_jitter, 0.0) * \
                self._retry_rng.random()
            self._rec.count("orchestrate.retries")
            self._rec.observe("orchestrate.retry_backoff_s", delay)
            await self._bump("tot_mover_assign_partition_retry")
            if await self._wait_or_stop(stop_ch, delay):
                return err, attempt

    async def _run_mover(self, stop_ch: Chan, done_ch: Chan, node: str) -> None:
        await self._bump("tot_run_mover")
        err = await self._mover_loop(stop_ch, self._map_node_to_req_ch[node], node)
        await done_ch.put(err)

    async def _mover_loop(self, stop_ch: Chan, req_ch: Chan,
                          node: str) -> Optional[Exception]:
        """Receive batched move requests and run the assign callback
        synchronously per batch (orchestrate.go:426-480).

        Each dequeued batch becomes one ``orchestrate.move`` lifecycle span
        on the ``mover:<node>`` lane, starting at the feeder's request
        creation: an ``orchestrate.move.wait`` child (time spent queued
        behind this node's concurrency limit / rendezvous) and an
        ``orchestrate.move.exec`` child (the app callback), so per-node
        wait is attributable separately from mover execution.  Callback
        latency also lands in the ``orchestrate.move_latency_s`` histogram,
        once per partition move in the batch with the batch's exec time
        amortized across them (histogram sum = exec wall-clock)."""
        while True:
            await self._bump("tot_mover_loop")

            which, value = await select((GET, stop_ch), (GET, req_ch))
            if which == 0:
                return None
            req, ok = value
            if not ok:
                return None
            t_recv = self._rec.now()

            partitions = [pm.partition for pm in req.partition_moves]
            states = [pm.state for pm in req.partition_moves]
            ops = [pm.op for pm in req.partition_moves]

            # Circuit breaker: a quarantined node's queued batches are
            # released immediately as failures — no callback, no retry
            # budget — so a dead node's work drains instead of wedging.
            # A half-open probe admission executes normally; its outcome
            # heals or re-trips the node (orchestrate/health.py).
            admit = "ok"
            if self.health is not None:
                admit = self.health.admit(node)

            lane = f"mover:{node}"
            with self._rec.span(
                    "orchestrate.move", t_start=req.t_created, task=lane,
                    node=node, moves=len(req.partition_moves)) as mv:
                self._rec.record_span(
                    "orchestrate.move.wait", req.t_created, t_recv,
                    task=lane, node=node)

                if admit == "reject":
                    await self._bump("tot_mover_quarantine_reject")
                    err, attempts = NodeQuarantinedError(node), 0
                    mv.attrs["quarantined"] = True
                    mv.attrs["ok"] = False
                else:
                    await self._bump("tot_mover_assign_partition")

                    t_exec = self._rec.now()
                    with self._rec.span("orchestrate.move.exec", task=lane,
                                        node=node, ops=",".join(ops)):
                        err, attempts = await self._exec_with_retries(
                            stop_ch, node, partitions, states, ops)
                    exec_s = self._rec.now() - t_exec
                    mv.attrs["wait_s"] = t_recv - req.t_created
                    mv.attrs["exec_s"] = exec_s
                    mv.attrs["ok"] = err is None
                    if attempts > 1:
                        mv.attrs["attempts"] = attempts
                    # One observation per partition move, with the batch's
                    # callback time amortized across its moves — so the
                    # histogram's sum equals real exec wall-clock, not
                    # batch-size-weighted batch latency.
                    per_move_s = exec_s / max(len(req.partition_moves), 1)
                    for _ in req.partition_moves:
                        self._rec.observe("orchestrate.move_latency_s",
                                          per_move_s)

                    await self._bump(
                        "tot_mover_assign_partition_err" if err is not None
                        else "tot_mover_assign_partition_ok")

            # Epoch fencing (docs/DURABILITY.md): a completion observed
            # after a crash recovery bumped the journal's fence is a
            # ZOMBIE — this whole orchestrator predates the recovery.
            # The outcome is rejected and counted, never applied: no
            # observer sees it (the successor's journal/SLO view stays
            # the truth) and the error marks the cursor failed, so
            # achieved_map() never includes the move.
            fence = self.options.epoch_fence
            if fence is not None and not fence.valid(self._epoch):
                from ..durability.epoch import StaleEpochError
                self._rec.count("durability.stale_epoch_rejections")
                err = StaleEpochError(
                    f"move batch on node {node!r}", self._epoch,
                    fence.current)
            # SLO / cost-model hook: every batch outcome, success or
            # failure, with the recorder-clock timestamp.  Observers are
            # sync (no await): the placement-view update is atomic on
            # the loop, so concurrent movers cannot tear it.
            elif self._observers:
                t_done = self._rec.now()
                for observer in self._observers:
                    observer.on_batch(node, req.partition_moves,
                                      err is None, t_done)

            if err is not None and self._ft:
                # Structured failure per partition move in the batch; the
                # first one rides the done channel so waiting feeders can
                # abandon their cursors without aborting the round loop.
                err = await self._record_batch_failure(
                    node, req.partition_moves, attempts, err)

            if req.done_ch is not None:
                if err is not None:
                    await select((GET, stop_ch), (PUT, req.done_ch, err))
                req.done_ch.close()

    async def _record_batch_failure(
        self, node: str, partition_moves: list[PartitionMove],
        attempts: int, cause: object,
    ) -> MoveFailure:
        """Fold one failed batch into the structured failure history:
        one MoveFailure per partition move, appended to ``failures`` AND
        ``progress.errors`` (snapshot emitted once for the batch).
        Returns the first failure, the batch's representative error."""
        batch = [
            MoveFailure(node=node, partition=pm.partition, state=pm.state,
                        op=pm.op, attempts=attempts, cause=cause)
            for pm in partition_moves
        ]
        self.failures.extend(batch)

        def record():
            for f in batch:
                self._progress.errors.append(f)
                self._bump_sync("tot_move_failures")
                self._rec.count("orchestrate.move_failures")
        await self._update_progress(record)
        return batch[0]

    def _filter_next_plausible_moves_for_node(
        self, node: str, next_moves_arr: list[NextMoves]
    ) -> list[NextMoves]:
        """Pick up to max_concurrent best moves via the app's find_move
        (orchestrate.go:482-504)."""
        count = self.options.max_concurrent_partition_moves_per_node
        if count <= 0:
            count = 1
        count = min(count, len(next_moves_arr))

        arr = list(next_moves_arr)
        picked: list[NextMoves] = []
        while count > 0:
            i = self._find_next_moves(node, arr)
            picked.append(arr[i])
            count -= 1
            arr[i] = arr[-1]
            arr.pop()
        return picked

    def _find_next_moves(self, node: str, next_moves_arr: list[NextMoves]) -> int:
        """Ask the app which available move to do next (orchestrate.go:699-714)."""
        if self._find_move is lowest_weight_partition_move_for_node:
            # Scheduler path (default LegacyWeightOrder, or the policy
            # the options set): selection reads the live cursors
            # directly — the legacy bound hands each candidate's
            # op-bearing NodeStateOp straight to the weight rule, the
            # exact pre-extraction fast path (measured ~50% of
            # scheduler time at 8k partitions), and the critical-path
            # bound looks up (partition, cursor) upward ranks.
            return self.sched.select(node, next_moves_arr)
        moves = [
            PartitionMove(
                partition=nm.partition,
                node=nm.moves[nm.next].node,
                state=nm.moves[nm.next].state,
                op=nm.moves[nm.next].op,
            )
            for nm in next_moves_arr
        ]
        return self._find_move(node, moves)

    def _find_available_moves(self) -> dict[str, list[NextMoves]]:
        """Group each partition's current move by destination node
        (orchestrate.go:749-763)."""
        available: dict[str, list[NextMoves]] = {}
        for nm in self._map_partition_to_next_moves.values():
            if nm.next < len(nm.moves):
                available.setdefault(nm.moves[nm.next].node, []).append(nm)
        return available

    async def _wait_while_paused(self) -> None:
        """Block the supplier between rounds while paused, REVALIDATING
        ``self._pause_ch`` after every wake.

        The pre-fix spelling captured the channel once and waited on the
        capture: a pause→resume→pause cycle landing inside the
        pause-counter put (a blocking progress rendezvous) closed the
        captured channel and parked the NEW one — the wait returned
        immediately and the supplier fed a fresh round while the
        orchestrator was logically paused (RACE002, the stale-guard
        window analysis/race_lint.py flags; the committed schedule
        trace in tests/test_race_regressions.py replays the exact
        interleaving).  Re-reading the attribute after each wake closes
        the window.

        EVERY progress bump in here is itself a blocking rendezvous a
        consumer can act inside — including the resume bump — so the
        decisive ``_pause_ch is None`` check is the one made after the
        resume bump, with no suspension point between it and the
        return: a pause landing during any earlier await sends the
        supplier back around the outer loop (surfacing each cycle as a
        pause+resume counter pair — honest accounting, and the event
        traffic keeps a snapshot-driven consumer live while the
        supplier stays correctly parked)."""
        while True:
            await self._bump("tot_run_supply_moves_pause")
            while True:
                pause_ch = self._pause_ch
                if pause_ch is None:
                    break
                await pause_ch.get()
            await self._bump("tot_run_supply_moves_resume")
            if self._pause_ch is None:
                return

    async def _run_supply_moves(self, stop_ch: Chan, run_mover_done_ch: Chan) -> None:
        """The round loop (orchestrate.go:509-618)."""
        err_outer = None

        while err_outer is None:
            await self._bump("tot_run_supply_moves_loop")

            available = self._find_available_moves()
            pause_ch = self._pause_ch

            if not available:
                break

            # Pause blocks the whole supplier between rounds; Stop() while
            # paused requires a resume first (orchestrate.go:531-544).
            if pause_ch is not None:
                await self._wait_while_paused()

            broadcast_stop_ch = Chan()
            broadcast_done_ch = Chan()

            interrupt = self.options.interrupt_on_first_feed

            # A move can target a node with no mover (not in nodes_all); its
            # feeder blocks until stop/broadcast (reference orchestrate.go:667
            # nil-channel semantics).  In interrupt mode the first success
            # unblocks it every round.  In throughput mode broadcast closes
            # only after all feeders report, so a blocked feeder would
            # deadlock the round — skip moverless nodes instead, unless NO
            # node is feedable (then spawn the blocking feeders to reproduce
            # the reference's wedge-until-Stop rather than a busy spin).
            feed_nodes = available
            if not interrupt:
                feedable = {node: arr for node, arr in available.items()
                            if node in self._map_node_to_req_ch}
                if feedable:
                    feed_nodes = feedable

            for node, next_moves_arr in feed_nodes.items():
                picked = self._filter_next_plausible_moves_for_node(
                    node, next_moves_arr)
                self._spawn(self._run_supply_move(
                    stop_ch, node, picked, broadcast_stop_ch,
                    broadcast_done_ch))

            await self._bump("tot_run_supply_moves_feeding")

            # First successful feed interrupts the other feeders so the next
            # round recomputes availability (orchestrate.go:566-580); in
            # throughput mode every feeder finishes and a round commits up
            # to len(feed_nodes) batches.
            broadcast_stopped = False
            for _ in range(len(feed_nodes)):
                err, _ok = await broadcast_done_ch.get()
                if err is None and interrupt and not broadcast_stopped:
                    broadcast_stop_ch.close()
                    broadcast_stopped = True
                if isinstance(err, MoveFailure) and self._ft:
                    # Already recorded in progress.errors/failures; the
                    # partition was abandoned.  NOT fatal: the remaining
                    # partitions keep moving (legacy mode instead aborts
                    # on the first error, below).  A completed feed — even
                    # a failed one — still refreshes availability.
                    if interrupt and not broadcast_stopped:
                        broadcast_stop_ch.close()
                        broadcast_stopped = True
                    continue
                if err is not None and err is not ErrorInterrupt and err_outer is None:
                    err_outer = err

            await self._bump("tot_run_supply_moves_feeding_done")

            if not broadcast_stopped:
                broadcast_stop_ch.close()
            broadcast_done_ch.close()

        await self._bump("tot_run_supply_moves_loop_done")

        for req_ch in self._map_node_to_req_ch.values():
            req_ch.close()

        def count_done():
            self._bump_sync("tot_run_supply_moves_done")
            if err_outer is not None and err_outer is not ErrorStopped:
                self._progress.errors.append(err_outer)
                self._bump_sync("tot_run_supply_moves_done_err")
                self._rec.count("orchestrate.errors")
        await self._update_progress(count_done)

        await self._wait_for_all_movers_done(run_mover_done_ch)

        # Scheduler wind-down: scores predicted-vs-actual makespan
        # (sched.makespan_rel_err) now that the last move has landed.
        self.sched.finish(self._rec.now())

        await self._bump("tot_progress_close")

        self._progress_ch.close()
        self._drained.set()

    async def _run_supply_move(
        self,
        stop_ch: Chan,
        node: str,
        next_moves: list[NextMoves],
        broadcast_stop_ch: Chan,
        broadcast_done_ch: Chan,
    ) -> None:
        """Feed one node one batch, or wait on an in-flight move
        (orchestrate.go:622-696)."""
        next_done_ch = None
        for nm in next_moves:
            if nm.next_done_ch is not None:
                next_done_ch = nm.next_done_ch
                break

        if next_done_ch is None:
            next_done_ch = Chan()
            req = _PartitionMoveReq(
                partition_moves=[
                    PartitionMove(
                        partition=nm.partition,
                        node=nm.moves[nm.next].node,
                        state=nm.moves[nm.next].state,
                        op=nm.moves[nm.next].op,
                    )
                    for nm in next_moves
                ],
                done_ch=next_done_ch,
                t_created=self._rec.now(),
            )

            # A move can target a node with no mover (not in nodes_all).  The
            # reference sends on a nil channel there, which blocks until the
            # stop/broadcast branch fires (orchestrate.go:667 with a missing
            # map key) — the move simply stalls, it does not error.  A fresh
            # never-received Chan reproduces that.  Either way the stall is
            # SURFACED now: a counter bump plus a one-time warning naming
            # the node; with a move deadline set the move fails fast as a
            # MoveFailure instead of silently wedging.
            req_ch = self._map_node_to_req_ch.get(node)
            if req_ch is None:
                self._note_missing_mover(node)
                if self._ft and self.options.move_timeout_s is not None:
                    first = await self._record_batch_failure(
                        node, req.partition_moves, 0, MissingMoverError(node))
                    if self._observers:
                        t_done = self._rec.now()
                        for observer in self._observers:
                            observer.on_batch(node, req.partition_moves,
                                              False, t_done)
                    for nm in next_moves:
                        nm.failed_at = nm.next
                        nm.next = len(nm.moves)
                    await broadcast_done_ch.put(first)
                    return
                req_ch = Chan()
            which, _ = await select(
                (GET, stop_ch),
                (GET, broadcast_stop_ch),
                (PUT, req_ch, req),
            )
            if which == 0:
                await broadcast_done_ch.put(ErrorStopped)
                return
            if which == 1:
                await broadcast_done_ch.put(ErrorInterrupt)
                return
            for nm in next_moves:
                nm.next_done_ch = next_done_ch

        which, value = await select(
            (GET, stop_ch),
            (GET, broadcast_stop_ch),
            (GET, next_done_ch),
        )
        if which == 0:
            await broadcast_done_ch.put(ErrorStopped)
        elif which == 1:
            await broadcast_done_ch.put(ErrorInterrupt)
        else:
            err_val, ok = value
            err = err_val if ok else None
            for nm in next_moves:
                if nm.next_done_ch is next_done_ch:
                    nm.next_done_ch = None
                    if isinstance(err, MoveFailure):
                        # Fault-tolerant abandon: skip this partition's
                        # remaining moves (executing e.g. the "del" after
                        # a failed "add" would corrupt coverage); the
                        # recovery replan re-places it.
                        nm.failed_at = nm.next
                        nm.next = len(nm.moves)
                    else:
                        nm.next += 1
            await broadcast_done_ch.put(err)

    def _note_missing_mover(self, node: str) -> None:
        """Surface the reference's silent moverless-node stall: bump
        ``orchestrate.missing_mover`` every time, warn once per node."""
        self._rec.count("orchestrate.missing_mover")
        if node not in self._missing_mover_warned:
            self._missing_mover_warned.add(node)
            _warnings.warn(
                f"blance_tpu_torch orchestrate: move targets node {node!r} which "
                f"has no mover (not in nodes_all); the move "
                + ("fails fast (move deadline set)"
                   if self._ft and self.options.move_timeout_s is not None
                   else "stalls until stop (reference semantics)"),
                UserWarning, stacklevel=2)

    async def _wait_for_all_movers_done(self, run_mover_done_ch: Chan) -> None:
        """Collect every mover's exit, folding errors into progress
        (orchestrate.go:718-731)."""
        for _ in range(len(self.nodes_all)):
            err, _ok = await run_mover_done_ch.get()

            def count():
                self._bump_sync("tot_run_mover_done")
                if err is not None:
                    self._progress.errors.append(err)
                    self._bump_sync("tot_run_mover_done_err")
                    self._rec.count("orchestrate.errors")
            await self._update_progress(count)


def orchestrate_moves(
    model: PartitionModel,
    options: OrchestratorOptions,
    nodes_all: Optional[list[str]],
    beg_map: PartitionMap,
    end_map: PartitionMap,
    assign_partitions: AssignPartitionsFunc,
    find_move: Optional[FindMoveFunc] = None,
    move_observers: "tuple[MoveObserver, ...]" = (),
) -> Orchestrator:
    """Asynchronously begin reassigning partitions from beg_map to end_map
    (orchestrate.go:240-338).  Must be called with a running asyncio loop;
    the caller must drain ``progress_ch()`` until it closes.

    assign_partitions(stop_ch, node, partitions, states, ops) performs the
    actual data movement for a batch, blocking until done; it may be sync or
    async, and signals failure by raising or returning an Exception.

    find_move(node, moves) -> index picks each node's next move; defaults to
    lowest_weight_partition_move_for_node.

    move_observers: zero or more ``obs.slo.MoveObserver``s, notified
    synchronously after every batch outcome — the live-telemetry hook
    (SLO accounting) that sees each achieved-map delta as it lands.
    """
    if len(beg_map) != len(end_map):
        raise ValueError("mismatched begMap and endMap")
    if assign_partitions is None:
        raise ValueError(
            "callback implementation for AssignPartitionsFunc is expected")

    nodes_all = list(nodes_all or [])
    states = sort_state_names(model)

    # Per-partition flight plans, computed up front without regard to other
    # partitions (orchestrate.go:264-287) — on device when asked.
    map_partition_to_next_moves: dict[str, NextMoves] = {}
    with get_recorder().span(
            "orchestrate.plan_moves", partitions=len(beg_map),
            device_diff=options.device_diff):
        if options.device_diff:
            from ..moves.batch import calc_all_moves

            all_moves = calc_all_moves(
                beg_map, end_map, model, options.favor_min_nodes,
                device=options.device)
            for partition_name in beg_map:
                map_partition_to_next_moves[partition_name] = NextMoves(
                    partition_name, all_moves[partition_name])
        else:
            for partition_name, beg_partition in beg_map.items():
                end_partition = end_map[partition_name]
                moves = calc_partition_moves(
                    states,
                    beg_partition.nodes_by_state,
                    end_partition.nodes_by_state,
                    options.favor_min_nodes,
                )
                map_partition_to_next_moves[partition_name] = NextMoves(
                    partition_name, moves)

    o = Orchestrator(
        model, options, nodes_all, beg_map, end_map,
        assign_partitions, find_move, map_partition_to_next_moves,
        move_observers=move_observers,
    )
    o._start(o._stop_ch)
    return o
