"""The traced run: the program's spans and counters, the card's timeline.

``Tracer.start`` installs, for the window only, a fresh recorder of the
program (its spans reach a sink here with their start and end), a spy
that notes the operand shapes of each min2 kernel launch, and
``torch.profiler`` over the host and the card.  ``Tracer.stop`` turns
the profile into a ``Timeline``: the device's busy time (the union of
its kernels, copies and fills), its kernels by name, the idle gaps
labelled by the innermost program span open on the host, and each min2
launch's device time beside its operand shapes.
"""

from __future__ import annotations

import dataclasses
import time

OTHER = "harness"  # no program span open: the benchmark's own loop


class SpanSink:
    """Receives every finished span of the program's recorder."""

    def __init__(self) -> None:
        self.spans: list = []

    def span(self, sp) -> None:
        self.spans.append((sp.name, sp.t_start, sp.t_end))


@dataclasses.dataclass
class Timeline:
    window_s: float
    busy_s: float
    kernels: dict          # device op name (short) -> seconds
    idle_by_span: dict     # innermost open span -> idle seconds
    min2_s: list           # device seconds of each min2 launch
    min2_shapes: list      # (score shape, price shape) of each launch

    def breakdown(self) -> dict:
        def top(d):
            return [[k, v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:10]]

        return {"device_ops": top(self.kernels),
                "idle_gaps": top(self.idle_by_span)}


def short(kernel: str) -> str:
    """A device op's name without its return type and PyTorch's
    namespaces, cut to 160 characters."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::"):
        kernel = kernel.replace(noise, "")
    return kernel[:160]


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def innermost_segments(spans: list, t0: float, t1: float) -> list:
    """[t0, t1] cut into (start, end, name of the innermost open span)."""
    events = []
    for i, (name, a, b) in enumerate(spans):
        events.append((a, 1, i, name))
        events.append((b, 0, i, name))
    events.sort()
    stack, segs, last = [], [], t0
    for t, kind, i, name in events:
        t = min(max(t, t0), t1)
        if t > last:
            segs.append((last, t, stack[-1][1] if stack else OTHER))
            last = t
        if kind:
            stack.append((i, name))
        elif (i, name) in stack:
            stack.remove((i, name))
    if t1 > last:
        segs.append((last, t1, OTHER))
    return segs


def clip(intervals: list, windows: list) -> list:
    """Sorted disjoint ``intervals`` cut to the sorted disjoint
    ``windows``."""
    out, j = [], 0
    for a, b in intervals:
        while j < len(windows) and windows[j][1] <= a:
            j += 1
        k = j
        while k < len(windows) and windows[k][0] < b:
            lo, hi = max(a, windows[k][0]), min(b, windows[k][1])
            if hi > lo:
                out.append((lo, hi))
            k += 1
    return out


def gaps(busy: list, windows: list) -> list:
    """The parts of the sorted disjoint ``windows`` outside ``busy``."""
    out, j = [], 0
    for lo, hi in windows:
        last = lo
        while j < len(busy) and busy[j][1] <= lo:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < hi:
            if busy[k][0] > last:
                out.append((last, busy[k][0]))
            last = max(last, busy[k][1])
            k += 1
        if hi > last:
            out.append((last, hi))
    return out


def idle_by_span(idle: list, segs: list) -> dict:
    """Seconds of the sorted ``idle`` intervals by the label of the
    segment they fall in."""
    out: dict = {}
    j = 0
    for a, b in idle:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            s0, s1, name = segs[k]
            overlap = min(b, s1) - max(a, s0)
            if overlap > 0:
                out[name] = out.get(name, 0.0) + overlap
            k += 1
    return out


class Tracer:

    def __init__(self, device: str) -> None:
        self.device = device
        self.sink = SpanSink()
        self.shapes: list = []

    def start(self) -> None:
        import torch
        from blance_tpu_torch.obs import Recorder, use_recorder
        from blance_tpu_torch.ops import reduce2
        from torch.profiler import ProfilerActivity, profile

        self.rec = Recorder(sinks=(self.sink,))
        self._use = use_recorder(self.rec)
        self._use.__enter__()
        self._reduce2 = reduce2
        self._launch = reduce2._launch
        shapes = self.shapes
        launch = self._launch

        def spy(score, price, *args, **kw):
            shapes.append((tuple(score.shape), tuple(price.shape)))
            return launch(score, price, *args, **kw)

        reduce2._launch = spy
        acts = [ProfilerActivity.CPU]
        if self.device.startswith("cuda"):
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.anchor_perf = time.perf_counter()
        with torch.profiler.record_function("bench.anchor"):
            pass

    def stop(self, windows: list) -> Timeline:
        """The timeline of the requests' own time, ``windows`` the
        (start, end) of each request on the host clock."""
        self.prof.__exit__(None, None, None)
        self._reduce2._launch = self._launch
        self._use.__exit__(None, None, None)
        events = self.prof.profiler.kineto_results.events()
        anchor = next(e.start_ns() for e in events
                      if e.name() == "bench.anchor")

        def at(ns):
            return self.anchor_perf + (ns - anchor) * 1e-9

        dev, kernels, min2 = [], {}, []
        for e in events:
            if "CUDA" not in str(e.device_type()):
                continue
            a = at(e.start_ns())
            d = e.duration_ns() * 1e-9
            inside = clip([(a, a + d)], windows)
            if not inside:
                continue
            dev += inside
            name = short(e.name())
            kernels[name] = kernels.get(name, 0.0) + d
            if "priced_min2" in e.name():
                min2.append(d)
        busy = _union(dev)
        segs = innermost_segments(self.sink.spans, windows[0][0],
                                  windows[-1][1])
        return Timeline(
            window_s=sum(b - a for a, b in windows),
            busy_s=sum(b - a for a, b in busy), kernels=kernels,
            idle_by_span=idle_by_span(gaps(busy, windows), segs),
            min2_s=min2, min2_shapes=list(self.shapes))

    def recorded(self) -> tuple:
        return dict(self.rec.span_totals), dict(self.rec.counters)
