# Port of blance_tpu/plan/service.py: the same service over the port's
# solve_fleet, solving on ``device``, or over a 1-D port Mesh's ranks.
"""Asyncio plan service: the fleet solver's coalescing front door.

plan/fleet.py turns B same-class tenant solves into one device dispatch;
this module supplies the B.  An asyncio service accepts per-tenant plan
requests, coalesces everything that arrives within a tunable admission
window into one fleet batch, solves it off-loop (a single-worker
executor serializes device access while the event loop keeps admitting),
and resolves each request's future with its tenant's result:

    service = PlanService(admission_window_s=0.002)
    await service.start()
    result = await service.submit(TenantProblem(...))   # FleetResult
    await service.stop()

Design points:

- **Admission window**: the dispatcher takes the first queued request,
  then keeps admitting until ``admission_window_s`` elapses (or
  ``max_batch`` fills).  A longer window buys bigger batches (fewer
  dispatches per solve) at the cost of per-request latency — the
  ``fleet.admission_latency_s`` histogram vs ``fleet.batch_tenants`` is
  the tuning signal (docs/FLEET.md).  While a batch is solving, the
  next window's requests queue up, so a saturated service pipelines
  admission against device compute.
- **Backpressure**: the request queue is bounded (``max_pending``);
  ``submit`` awaits queue space, so producers slow to the service's
  throughput instead of growing an unbounded backlog.
- **Per-tenant warm carries**: results are adopted into a keyed
  :class:`plan.carry.CarryCache` (shared or service-owned, LRU byte
  budget).  A request whose ``prev`` equals the tenant's cached
  assignment — and that states its delta via ``dirty`` — rides the
  one-sweep warm repair, bit-identically to a per-tenant
  ``PlannerSession`` doing the same (the cache consume/store lifecycle
  is the session's, value-matched because service callers rebuild
  arrays per request).
- **Admission fairness**: ``fair_share`` bounds one tenant's share of
  a coalescing window; over-quota requests roll to the next batch
  (oldest first) and count ``fleet.starved_admissions`` — a chatty
  tenant cannot starve its neighbors' converge cycles (docs/FLEET.md
  "Fleet of control loops").
- **Shared state** (analysis/race_lint.py SHARED_STATE): ``_closed``,
  ``_task``, the queue and the ``_deferred`` carry-over list are
  touched by ``submit``/``stop`` (the app-facing surface) and the
  dispatcher task; every mutation sits in a single no-await window,
  and the carry cache is written ONLY from the dispatcher task, so
  cache state cannot interleave mid-batch.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from functools import partial
from typing import TYPE_CHECKING, Any, Optional

import torch

from ..convert import resolve_device
from ..obs import get_recorder
from ..utils.hostclock import perf_now
from ..obs.tracectx import RequestTimeline, TraceContext, TraceIdSource
from .carry import CarryCache
from .fleet import FleetResult, TenantProblem, solve_fleet, validate_tenant

if TYPE_CHECKING:  # annotation-only
    from ..obs import Recorder

__all__ = ["PlanService", "PlanServiceClosed"]


class PlanServiceClosed(RuntimeError):
    """The service is stopped (or stopped while the request waited)."""


@dataclass
class _Request:
    problem: TenantProblem
    future: "asyncio.Future[FleetResult]"
    t_submit: float
    # End-to-end trace: minted at submit, marks appended as the request
    # crosses each stage, recorded (spans + segment histograms) at
    # resolution.  docs/OBSERVABILITY.md "Request decomposition".
    timeline: Optional[RequestTimeline] = None


_STOP = object()  # queue sentinel: drain and exit


class PlanService:
    """Coalescing asyncio front door over :func:`plan.fleet.solve_fleet`.

    Parameters
    ----------
    admission_window_s: how long the dispatcher keeps admitting after
        the first request of a batch (0 = batch only what is already
        queued — lowest latency, smallest batches).
    max_pending: bounded request queue length; ``submit`` awaiting
        space IS the backpressure.
    max_batch: hard cap on tenants per fleet batch.
    mesh: optional 1-D port Mesh (parallel/sharded.make_mesh): fleet
        batches shard their batch axis over its ranks, solving on their
        devices (``device`` is then the mesh's rank-0 device).
    device: where the batches solve ("cuda" unless the caller passes
        the CPU); the worker thread solves there, and the kernels launch
        on that card's current stream.
    carry_cache: shared per-tenant warm-carry store; by default the
        service owns one bounded to ``carry_bytes`` and
        ``carry_entries`` keys (churning tenant keys must not grow the
        entry table forever).
    fair_share: bounded per-tenant share of one coalescing window — at
        most this many requests per tenant key land in a batch; the
        excess rolls to the NEXT batch (admitted first there, oldest
        first, quota applied again).  Cross-tenant admission fairness
        for the fleet-of-loops tier: a chatty tenant churning deltas
        cannot fill a window and starve its neighbors' converge
        cycles.  Every deferral counts ``fleet.starved_admissions`` so
        starvation is observable, and deferral never changes a result —
        the deferred request solves in a later batch with the same
        inputs (docs/FLEET.md).  None (default) disables the quota.
    batch_floor: pad every dispatch's batch axis up to at least this
        many elements before bucketing.  Small coalesced batches wander
        ``B = 1..N`` where the batch buckets step by 1, so a fleet of
        control loops would compile one program per size; the floor
        trades a few inert pad elements for ONE compiled program per
        bucket class (the fleet controller defaults it to 16; 1 here =
        the exact pre-floor behavior).
    """

    def __init__(
        self,
        *,
        admission_window_s: float = 0.002,
        max_pending: int = 256,
        max_batch: int = 1024,
        mesh: Any = None,
        carry_cache: Optional[CarryCache] = None,
        carry_bytes: Optional[int] = 64 << 20,
        carry_entries: Optional[int] = 16384,
        max_iterations: int = 10,
        recorder: Optional["Recorder"] = None,
        inline_solve: bool = False,
        fair_share: Optional[int] = None,
        batch_floor: int = 1,
        device: Any = "cuda",
    ) -> None:
        if mesh is not None:
            from ..parallel.sharded import check_mesh

            check_mesh(mesh, "PlanService", one_d=True)
            self.device = mesh.device
        else:
            self.device = resolve_device(device, "PlanService")
        self.mesh = mesh
        if max_pending <= 0 or max_batch <= 0:
            raise ValueError("max_pending and max_batch must be positive")
        if fair_share is not None and fair_share < 1:
            raise ValueError(f"fair_share must be >= 1, got {fair_share}")
        self.admission_window_s = float(admission_window_s)
        self.max_batch = int(max_batch)
        self.fair_share = fair_share
        # Pad every dispatch's batch axis up to at least this many
        # elements before bucketing (plan/fleet.py _dispatch): a fleet
        # of control loops whose coalesced sizes wander 1..N trades a
        # few inert pad elements for ONE compiled program per class
        # instead of one per batch size (docs/FLEET.md).
        self.batch_floor = int(batch_floor)
        self.max_iterations = int(max_iterations)
        # inline_solve runs the fleet batch on the dispatcher coroutine
        # instead of a worker thread: admission no longer pipelines
        # against device compute (don't use it in production), but the
        # service becomes loop-only — which is what lets the PR-5
        # DeterministicLoop drive it, making the whole request-tracing
        # plane (segments, trace ids, histograms) a pure function of
        # the seeded schedule.
        self.inline_solve = bool(inline_solve)
        self._rec = recorder if recorder is not None else get_recorder()
        self._trace_ids = TraceIdSource()
        self.carry_cache = carry_cache if carry_cache is not None \
            else CarryCache(max_bytes=carry_bytes,
                            max_entries=carry_entries,
                            recorder=self._rec)
        # Cumulative HOST wall-clock seconds spent inside the fleet
        # solve (single writer: the solve runs on the dispatcher
        # coroutine or the one-thread executor).  perf_counter time,
        # not the recorder clock — the bench phase-split's "device"
        # share (fleet.dispatch_s is virtual under DeterministicLoop).
        self.host_solve_s = 0.0
        self._queue: "asyncio.Queue[object]" = \
            asyncio.Queue(maxsize=max_pending)
        # Over-quota requests rolled out of a coalescing window by the
        # fairness bound; dispatcher-task-owned (admitted, oldest
        # first, at the head of the next window).
        self._deferred: list[_Request] = []
        self._task: Optional["asyncio.Task[None]"] = None
        self._closed = False
        self._executor: Optional[ThreadPoolExecutor] = None

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        """Spawn the dispatcher task (idempotent)."""
        if self._closed:
            raise PlanServiceClosed("PlanService is stopped")
        if self._task is not None:
            return
        if not self.inline_solve:
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="plan-fleet")
        task = asyncio.get_running_loop().create_task(
            self._run(), name="PlanService._run")
        task.add_done_callback(self._on_run_done)
        self._task = task

    async def stop(self) -> None:
        """Stop admitting, finish the in-flight batch, fail the rest.

        Requests still queued (or arriving concurrently with the stop)
        get :class:`PlanServiceClosed`; the dispatcher exits after the
        sentinel drains.  Idempotent by construction — and still
        performs the cleanup half (drain, executor shutdown) when the
        dispatcher already died and its done-callback flipped
        ``_closed``, so a crashed service never leaks its worker
        thread."""
        self._closed = True
        if self._task is not None and not self._task.done():
            await self._queue.put(_STOP)
        task = self._task
        if task is not None:
            # A crashed dispatcher's exception was already surfaced by
            # _on_run_done; gather(return_exceptions=True) awaits the
            # exit without re-raising it out of cleanup.
            await asyncio.gather(task, return_exceptions=True)
        self._task = None
        self._drain_pending()
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None

    def _drain_pending(self) -> None:
        """Fail every request still queued (single no-await window).

        A drained stop sentinel is re-queued: submit()'s post-put
        closed-check may drain concurrently with stop(), and stealing
        the sentinel would strand stop() awaiting a dispatcher that
        never sees it."""
        deferred, self._deferred = self._deferred, []
        for req in deferred:
            if not req.future.done():
                req.future.set_exception(
                    PlanServiceClosed("PlanService stopped"))
        stops = 0
        while True:
            try:
                req = self._queue.get_nowait()
            except asyncio.QueueEmpty:
                break
            if req is _STOP:
                stops += 1
                continue
            assert isinstance(req, _Request)
            if not req.future.done():
                req.future.set_exception(
                    PlanServiceClosed("PlanService stopped"))
        if stops:
            try:
                self._queue.put_nowait(_STOP)
            except asyncio.QueueFull:
                # Unreachable today (the drain runs to QueueEmpty in one
                # no-await window), and even a lost sentinel cannot wedge
                # the dispatcher: _run's _closed check below is the
                # second exit.
                pass

    def _on_run_done(self, task: "asyncio.Task[None]") -> None:
        """Dispatcher exit observer: a crashed dispatcher must neither
        vanish silently (the ASY101 class) nor strand queued waiters."""
        if task.cancelled():
            exc: Optional[BaseException] = None
        else:
            exc = task.exception()
        if exc is None:
            return
        self._rec.count("fleet.dispatcher_crashes")
        warnings.warn(
            f"blance_tpu PlanService dispatcher died: "
            f"{type(exc).__name__}: {exc}", UserWarning)
        self._closed = True
        self._drain_pending()

    # -- the app-facing surface ----------------------------------------------

    async def submit(self, problem: TenantProblem,
                     ctx: Optional[TraceContext] = None) -> FleetResult:
        """Plan one tenant; resolves when its batch lands.

        Awaiting queue space is the backpressure contract; the result
        is bit-identical to solving the tenant alone on the single-
        problem path (plan/fleet.py's guarantee).

        A :class:`TraceContext` is minted here (or passed in by a
        caller propagating a wider trace) and rides the request end to
        end: at resolution the request's latency is recorded as one
        ``fleet.request`` span, one span per lifecycle segment, and
        ``fleet.request_segment_s{segment=...}`` histogram samples —
        the segments tile [submit, resolve] exactly, so their sum IS
        the end-to-end latency."""
        if self._closed or self._task is None:
            raise PlanServiceClosed(
                "PlanService is not running (call start(), not stopped)")
        rec = self._rec
        rec.count("fleet.requests")
        fut: "asyncio.Future[FleetResult]" = \
            asyncio.get_running_loop().create_future()
        t_submit = rec.now()
        timeline = RequestTimeline(
            ctx if ctx is not None else self._trace_ids.mint(), t_submit)
        await self._queue.put(_Request(problem, fut, t_submit, timeline))
        if self._closed:
            # The service stopped (or its dispatcher died) while this
            # submit was blocked on a full queue: the crash-path drain
            # may already have run, so our just-enqueued request could
            # otherwise sit in a queue nobody reads — drain it (and any
            # neighbors) into PlanServiceClosed instead of hanging.
            self._drain_pending()
        rec.set_gauge("fleet.queue_depth", float(self._queue.qsize()))
        return await fut

    # -- the dispatcher task -------------------------------------------------

    def _over_quota(self, key: str, counts: dict[str, int]) -> bool:
        return self.fair_share is not None and \
            counts.get(key, 0) >= self.fair_share

    def _defer(self, req: _Request) -> None:
        """Roll one over-quota request to the next window (sync window;
        the starved counter is the starvation observable — one count
        per deferral event, so a request stuck behind a chatty tenant
        for several windows counts several times)."""
        self._deferred.append(req)
        self._rec.count("fleet.starved_admissions")

    async def _admit_batch(self, first: _Request) -> tuple[
            list[_Request], bool]:
        """Coalesce requests for one fleet batch: deferred carry-overs
        from prior windows first (oldest first), then everything
        already queued plus whatever arrives within the admission
        window — each admission subject to the per-tenant
        ``fair_share`` quota.  Returns (batch, stop_seen)."""
        loop = asyncio.get_running_loop()
        batch = [first]
        counts = {first.problem.key: 1}
        carried, self._deferred = self._deferred, []
        for i, req in enumerate(carried):
            if len(batch) >= self.max_batch:
                # Plain capacity pressure, not starvation: the rest of
                # the carry-overs roll forward WITHOUT counting the
                # starved metric (it measures fair-share deferrals
                # only — docs/OBSERVABILITY.md).
                self._deferred.extend(carried[i:])
                break
            if self._over_quota(req.problem.key, counts):
                self._defer(req)
            else:
                counts[req.problem.key] = \
                    counts.get(req.problem.key, 0) + 1
                batch.append(req)
        deadline = loop.time() + self.admission_window_s
        while len(batch) < self.max_batch:
            timeout = deadline - loop.time()
            if timeout <= 0:
                try:
                    nxt = self._queue.get_nowait()
                except asyncio.QueueEmpty:
                    break
            else:
                try:
                    nxt = await asyncio.wait_for(
                        self._queue.get(), timeout)
                except asyncio.TimeoutError:
                    break
            if nxt is _STOP:
                return batch, True
            assert isinstance(nxt, _Request)
            if nxt.timeline is not None:
                nxt.timeline.mark("admission", self._rec.now())
            if self._over_quota(nxt.problem.key, counts):
                self._defer(nxt)
                continue
            counts[nxt.problem.key] = counts.get(nxt.problem.key, 0) + 1
            batch.append(nxt)
        return batch, False

    def _with_cached_carry(self, t: TenantProblem) -> TenantProblem:
        """Validate the request and attach the tenant's cached warm
        carry when it is warm-eligible: an explicit carry passes
        through untouched; otherwise a cached carry is consumed and
        used iff it matches the request's ``prev`` by value AND the
        request states its delta (``dirty``).  Cold requests count a
        carry miss, mirroring PlannerSession.replan's accounting.

        Validation runs HERE (per request, inside the dispatcher's
        fail-alone guard) rather than only inside solve_fleet, so one
        tenant's bad arrays fail that request alone — never its
        co-batched neighbors."""
        validate_tenant(t)
        if t.carry is not None:
            return t
        carry, cached_dirty = self.carry_cache.consume(
            t.key, t.prev, match="equal")
        if carry is None or t.dirty is None:
            self._rec.count("plan.solve.carry_miss")
            return t
        return dataclasses.replace(
            t, carry=carry, dirty=t.dirty | cached_dirty)

    def _solve_batch(self, problems: list[TenantProblem],
                     trace_ids: dict[str, str]) -> tuple[
                         float, float, list[FleetResult]]:
        """The executor-side (or inline) solve, stamped on the
        recorder's clock: (t_solve_start, t_solve_end, results).  The
        stamps are what split a request's ``executor_queue`` segment
        (batch closed → solver started) from its ``device`` segment."""
        rec = self._rec
        t_start = rec.now()
        w0 = perf_now()
        with (torch.cuda.device(self.device)
              if self.device.type == "cuda" else contextlib.nullcontext()):
            results = solve_fleet(
                problems, max_iterations=self.max_iterations,
                recorder=rec, trace_ids=trace_ids,
                batch_floor=self.batch_floor, device=self.device,
                mesh=self.mesh)
        self.host_solve_s += perf_now() - w0
        return t_start, rec.now(), results

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        rec = self._rec
        while True:
            if self._deferred:
                # Deferred carry-overs open the next window immediately
                # — a starved tenant must not additionally wait for
                # fresh traffic.  (Their "admission" mark was stamped
                # at the original dequeue.)
                first = self._deferred.pop(0)
            else:
                nxt = await self._queue.get()
                if nxt is _STOP:
                    return
                assert isinstance(nxt, _Request)
                first = nxt
                if first.timeline is not None:
                    first.timeline.mark("admission", rec.now())
            if self._closed:
                # Second exit (belt for a lost stop sentinel): a closed
                # service must never process new batches; stop()'s
                # drain owns whatever is still queued.
                if not first.future.done():
                    first.future.set_exception(
                        PlanServiceClosed("PlanService stopped"))
                return
            batch = [first]
            stop_seen = False
            # EVERY admitted request's future resolves inside this try:
            # a failure anywhere in the batch path fails the batch's
            # futures rather than stranding their submit() callers, and
            # the service stays up for the next batch.
            try:
                batch, stop_seen = await self._admit_batch(first)
                rec.set_gauge("fleet.queue_depth",
                              float(self._queue.qsize()))
                t_batched = rec.now()
                pairs = []
                for r in batch:
                    if r.timeline is not None:
                        r.timeline.mark("coalesce", t_batched)
                    try:
                        pairs.append(
                            (r, self._with_cached_carry(r.problem)))
                    except Exception as e:
                        # A malformed request fails alone; its
                        # co-batched neighbors still solve.
                        if not r.future.done():
                            r.future.set_exception(e)
                if pairs:
                    trace_ids = {
                        r.problem.key: r.timeline.ctx.trace_id
                        for r, _ in pairs if r.timeline is not None}
                    problems = [p for _, p in pairs]
                    if self.inline_solve:
                        t_start, t_end, results = self._solve_batch(
                            problems, trace_ids)
                    else:
                        t_start, t_end, results = \
                            await loop.run_in_executor(
                                self._executor,
                                partial(self._solve_batch, problems,
                                        trace_ids))
                    for (r, _), res in zip(pairs, results):
                        # Adopt each result as the tenant's new warm
                        # state; the dispatcher is the cache's only
                        # writer, so this cannot interleave with
                        # another batch's consume.
                        if res.carry is not None:
                            # Store a PRIVATE copy as the matched
                            # "current": the result array belongs to
                            # the caller, and an in-place mutation over
                            # there must read as a cache miss, never
                            # as a still-valid warm match against a
                            # carry built from the unmutated plan.
                            self.carry_cache.store(
                                res.key, res.carry, res.assign.copy())
                        t_res = rec.now()
                        rec.observe("fleet.admission_latency_s",
                                    t_res - r.t_submit)
                        if not r.future.done():
                            r.future.set_result(res)
                        if r.timeline is not None:
                            r.timeline.mark("executor_queue", t_start)
                            r.timeline.mark("device", t_end)
                            r.timeline.mark("resolve", t_res)
                            r.timeline.record(
                                rec, tenant=res.key, warm=res.warm)
            except Exception as e:
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)
            if stop_seen:
                return
