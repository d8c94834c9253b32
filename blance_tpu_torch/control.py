# Copied from blance_tpu/control.py.
"""The reusable converge-cycle engine behind every control loop.

``rebalance.RebalanceController`` once owned the whole
debounce/coalesce/converge state machine inline.  The fleet tier
(``blance_tpu/fleetloop.py``) needs that exact machine *per tenant* —
hundreds of independent control loops multiplexed on ONE event loop, no
thread per tenant — so the generic half lives here as
:class:`CycleEngine`: the pending-delta intake, the wake/idle events,
the debounce window, the take-pending/converge cycle, and the
stop/quiesce rendezvous.  ``RebalanceController`` subclasses it and
keeps everything cluster-specific (planning, orchestration, supersede,
SLO accounting) in the hook methods.

Single-task discipline (analysis/race_lint.py ``SHARED_STATE``): the
engine's control state is touched by the app-facing sync surface
(``submit``/``stop_soon``) and the engine task; every mutation sits in
one no-await window, and the bounded rendezvous between them is the
wake event plus the pending list, taken atomically
(:meth:`_take_pending` clears the event in the same sync window that
takes the list, so a set can never be lost between a take and its
pending snapshot).

Time comes exclusively from the injected ``clock`` (pass
``recorder.now``), so a fleet of engines — debounce windows included —
runs deterministically under ``testing.sched.DeterministicLoop``.

:class:`CyclePlanner` is the seam that makes converge cycles
*coalescible*: a controller constructed with one plans ASYNCHRONOUSLY,
so N tenants' overlapping debounce windows can land their plan requests
in one shared ``plan.service.PlanService`` admission window — one
bucketed ``[B, ...]`` fleet dispatch instead of N device dispatches
(docs/FLEET.md "Fleet of control loops").
"""

from __future__ import annotations

import asyncio
from typing import Any, Callable, Optional, Protocol

__all__ = ["CycleEngine", "CyclePlanner"]


class CyclePlanner(Protocol):
    """Async planning seam for a converge cycle.

    ``plan_cycle`` receives the loop's folded view — the current map,
    the full node list, the nodes to drain (graceful removals, abrupt
    failures and quarantined nodes alike), the model and the live
    options — and returns ``(next_map, warnings)`` exactly like
    ``plan.api.plan_next_map``.  Because it is awaited, N controllers
    sharing one :class:`~blance_tpu.plan.service.PlanService`-backed
    planner coalesce their cycles into shared fleet dispatches.

    **Optional residency hooks** (duck-typed — the controller calls
    them via ``getattr`` so plain planners need not define them): a
    planner that keeps *resident encoded state* between cycles
    (``fleetloop.ServicePlanner`` with encode residency,
    docs/DESIGN.md "Encode residency") can implement

    - ``notify_strip(nodes, before, after)`` — called in the same sync
      window an abrupt-fail delta replaced the controller's current
      map (``before`` → ``after``, dark placements stripped), so the
      planner can patch its resident encoding in O(delta) instead of
      re-encoding the whole map next cycle;
    - ``notify_pass(achieved, end_map, clean)`` — called when an
      orchestration pass adopted ``achieved`` as current; ``clean`` is
      the controller's hint that the pass fully landed ``end_map``
      (no supersede/cancel/failures/quarantine).  The planner owns the
      final verification and MUST demote to a full re-encode on
      anything it cannot prove — the conservative-protocol contract is
      that a missed hook or failed check only ever costs a cold
      encode, never a stale map."""

    async def plan_cycle(
        self,
        current: Any,
        nodes: list[str],
        removes: list[str],
        model: Any,
        opts: Any,
    ) -> tuple[Any, dict[str, list[str]]]: ...


class CycleEngine:
    """Debounced, coalescing converge-cycle loop (the generic half of
    ``rebalance.RebalanceController``; see the module doc).

    Subclasses implement :meth:`_apply_deltas` (fold a burst of deltas
    into their view, one sync window) and :meth:`_converge` (drive the
    view to a fixpoint), plus the optional hooks ``_on_submit``,
    ``_on_stop_soon``, ``_on_idle`` and ``_on_exit``."""

    #: asyncio task name for the engine task (subclasses override).
    TASK_NAME = "cycle-engine"

    def __init__(self, *, debounce_s: float,
                 clock: Callable[[], float]) -> None:
        self.debounce_s = debounce_s
        self._clock = clock
        self._pending: list[Any] = []
        self._wake = asyncio.Event()
        self._idle = asyncio.Event()
        self._idle.set()
        self._stopping = False
        self._task: "Optional[asyncio.Task[object]]" = None
        self.cycles = 0
        # Called with the clock time whenever the engine returns to idle
        # (no pending deltas, nothing in flight) — the simulator's
        # per-incident convergence-lag hook.
        self.on_quiesce: list[Callable[[float], None]] = []

    # -- app-facing control surface (sync: single atomic windows) ---------

    def submit(self, delta: Any) -> None:
        """Enqueue a delta; coalesces with everything else that arrives
        within the debounce window.  Sync and re-entrant from progress
        callbacks."""
        self._pending.append(delta)
        self._on_submit(delta)
        self._idle.clear()
        self._wake.set()

    def stop_soon(self) -> None:
        """Request wind-down: lets the engine task exit (subclass hooks
        cancel anything in flight).  Sync; pair with ``await stop()``
        (or await the start() task) for the rendezvous."""
        self._stopping = True
        self._wake.set()
        self._on_stop_soon()

    def start(self) -> "asyncio.Task[object]":
        """Spawn the engine task (requires a running loop)."""
        if self._task is None:
            self._task = asyncio.ensure_future(self._run())
            self._task.set_name(self.TASK_NAME)
        return self._task

    async def stop(self) -> None:
        """stop_soon + await the engine task's exit."""
        self.stop_soon()
        if self._task is not None:
            await self._task

    async def quiesce(self) -> Any:
        """Wait until the engine is idle (every submitted delta
        converged or structurally degraded).  Subclasses narrow the
        return to their converged view (the controller returns its
        current map)."""
        await self._idle.wait()
        return None

    def pending_tasks(self) -> "list[asyncio.Task[object]]":
        """Unfinished engine tasks — the no-orphan probe for explorer
        scenarios (subclasses extend with in-flight work)."""
        out: "list[asyncio.Task[object]]" = []
        if self._task is not None and not self._task.done():
            out.append(self._task)
        return out

    # -- the loop ----------------------------------------------------------

    async def _run(self) -> None:
        try:
            while not self._stopping:
                if not self._pending:
                    self._set_idle()
                    await self._wake.wait()
                    continue
                if self.debounce_s > 0:
                    # Coalesce the burst: everything that lands during
                    # this (virtual-time) window joins the cycle.
                    await asyncio.sleep(self.debounce_s)
                deltas = self._take_pending()
                if deltas:
                    self._apply_deltas(deltas)
                    self.cycles += 1
                    self._on_cycle(self.cycles, len(deltas))
                    await self._converge()
        finally:
            self._on_exit()
            self._set_idle()

    def _take_pending(self) -> list[Any]:
        taken, self._pending = self._pending, []
        self._wake.clear()
        return taken

    def _set_idle(self) -> None:
        if not self._idle.is_set():
            self._idle.set()
            t = self._clock()
            self._on_idle(t)
            for hook in self.on_quiesce:
                hook(t)

    async def _wake_wait(self) -> None:
        await self._wake.wait()

    # -- subclass surface --------------------------------------------------

    def _apply_deltas(self, deltas: list[Any]) -> None:
        """Fold a burst of deltas into the subclass view, IN ORDER, in
        one sync window."""
        raise NotImplementedError

    async def _converge(self) -> None:
        """Drive the view to a fixpoint (or a structural degradation /
        a supersede / the pass budget)."""
        raise NotImplementedError

    def _on_submit(self, delta: Any) -> None:
        """Sync hook inside :meth:`submit`'s atomic window (counters,
        SLO incident opening, WAL delta-intake records)."""

    def _on_cycle(self, n: int, deltas: int) -> None:
        """Sync hook at cycle begin — after the delta burst folded into
        the view, before convergence starts.  The explicit cycle-begin
        seam the durability journal records through."""

    def _on_stop_soon(self) -> None:
        """Sync hook inside :meth:`stop_soon` (cancel in-flight work)."""

    def _on_idle(self, t: float) -> None:
        """Sync hook inside :meth:`_set_idle`, before the quiesce
        callbacks run (SLO incident closing)."""

    def _on_exit(self) -> None:
        """Sync hook on engine-task exit, BEFORE the final idle edge (a
        crash / mid-episode stop is not a quiesce)."""
