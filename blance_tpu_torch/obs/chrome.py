# Copied from blance_tpu/obs/chrome.py; trace() runs its body under the
# port's device_profile (torch.profiler).
"""Chrome trace-event export: open the pipeline in chrome://tracing / Perfetto.

``ChromeTraceSink`` collects finished spans and writes the trace-event JSON
object format (the stable subset both viewers load):

- one ``"X"`` (complete) event per live span — ``ts``/``dur`` in
  microseconds on the recorder's monotonic clock, ``pid`` the OS process,
  ``tid`` a dense integer per logical lane (asyncio task / thread / mover
  node), ``args`` the span attributes (plus span/parent ids for tooling);
- nestable async ``"b"``/``"e"`` pairs for overlappable spans (backdated
  lifecycles, queue waits recorded after the fact): they may partially
  overlap live slices on their lane, which ``"X"`` slices cannot express;
- ``"M"`` metadata events naming each lane, so Perfetto shows
  "mover:n0001" instead of a bare number;
- ``"C"`` counter events: one time-stamped sample per counter UPDATE
  (the sink implements the Recorder's live ``counter`` hook), so
  Perfetto renders counter tracks evolving on the same timeline as the
  spans — retries ramping during a flaky stretch, move totals climbing
  batch by batch — plus one final sample per counter at the trace end
  so the track closes at its end-of-run value.

``trace(...)`` is the one-call wrapper (``obs.device_check --trace-out``
uses it): it attaches the sink, runs the body under ``device_profile``
when a log dir is given, and writes the JSON on exit.  With the log dir
it also writes a merged file (``x.json`` -> ``x.merged.json``): the
profiler's trace with the recorder's spans and counter samples moved
onto the profiler's clock by the anchor taken as the profiler started,
so one file in Perfetto shows the spans above the card's kernels.  The
spans are never ``record_function`` ranges: the profiler would put
those on the card's timeline too.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
from typing import Iterator, Optional

from .recorder import Recorder, Span, get_recorder

__all__ = ["ChromeTraceSink", "write_chrome_trace", "trace"]


class ChromeTraceSink:
    """Collects spans and serializes them as trace-event JSON."""

    def __init__(self, recorder: Optional[Recorder] = None) -> None:
        self._t0 = (recorder or get_recorder()).t0
        # Set by trace() once it has merged a device profile.
        self.merged_path: Optional[str] = None
        self.clock_drift_s: Optional[float] = None
        self._spans: list[Span] = []
        self._counter_samples: list[tuple[float, str, float]] = []
        self._lock = threading.Lock()

    def span(self, sp: Span) -> None:
        with self._lock:
            self._spans.append(sp)

    def counter(self, name: str, value: float, t: float) -> None:
        """Live counter sample (the Recorder calls this on every
        ``count``): becomes one time-stamped "C" event, so the counter
        renders as a track over time, not just a final value."""
        with self._lock:
            self._counter_samples.append((t, name, value))

    def close(self) -> None:
        pass

    def events(self, counters: Optional[dict] = None) -> list[dict]:
        """The traceEvents list (see module docstring for the shapes)."""
        with self._lock:
            spans = list(self._spans)
            samples = list(self._counter_samples)
        pid = os.getpid()
        tids: dict[str, int] = {}
        events: list[dict] = []
        for lane in sorted({sp.task for sp in spans}):
            tids[lane] = len(tids) + 1
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid,
                "tid": tids[lane], "args": {"name": lane},
            })
        t_last = 0.0
        for sp in spans:
            ts = max(sp.t_start - self._t0, 0.0) * 1e6
            dur = max(sp.duration_s, 0.0) * 1e6
            t_last = max(t_last, ts + dur)
            args = {str(k): v for k, v in sp.attrs.items()}
            args["span_id"] = sp.span_id
            if sp.parent_id is not None:
                args["parent_id"] = sp.parent_id
            if sp.overlappable:
                # Backdated spans (queue waits, move lifecycles) may
                # partially overlap live slices on their lane, which the
                # "X" format forbids (slices on one track must nest) —
                # emit them as nestable async begin/end pairs instead,
                # which both viewers render on overlap-tolerant tracks.
                ident = f"0x{sp.span_id:x}"
                common = {"name": sp.name, "cat": "obs", "pid": pid,
                          "tid": tids[sp.task], "id": ident}
                events.append({**common, "ph": "b", "ts": ts,
                               "args": args})
                events.append({**common, "ph": "e", "ts": ts + dur})
            else:
                events.append({
                    "name": sp.name, "ph": "X", "ts": ts, "dur": dur,
                    "pid": pid, "tid": tids[sp.task], "args": args,
                })
        # Live counter samples, time-ordered: the evolving track.
        for t, name, value in sorted(samples):
            ts = max(t - self._t0, 0.0) * 1e6
            t_last = max(t_last, ts)
            events.append({
                "name": name, "ph": "C", "ts": ts, "pid": pid,
                "args": {"value": value},
            })
        # Final values close every track at the trace end (and cover
        # counters bumped before the sink was attached).
        for name, value in sorted((counters or {}).items()):
            events.append({
                "name": name, "ph": "C", "ts": t_last, "pid": pid,
                "args": {"value": value},
            })
        return events

    def write(self, path: str, counters: Optional[dict] = None) -> None:
        payload = {
            "traceEvents": self.events(counters),
            "displayTimeUnit": "ms",
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, default=str)
        os.replace(tmp, path)


def write_chrome_trace(path: str, sink: ChromeTraceSink,
                       recorder: Optional[Recorder] = None) -> None:
    """Write ``sink``'s collected spans (plus ``recorder``'s final counter
    values) as a Chrome trace file.  The sink is required because the
    Recorder retains no spans itself — only sinks do."""
    rec = recorder or get_recorder()
    sink.write(path, counters=dict(rec.counters))


def _merged_path(path: str) -> str:
    """Where ``trace(path, device_log_dir=...)`` writes the merged file:
    ``x.json`` -> ``x.merged.json``."""
    root, ext = os.path.splitext(path)
    return f"{root}.merged{ext or '.json'}"


def _write_merged(path: str, profile, sink: ChromeTraceSink,
                       counters: Optional[dict] = None) -> float:
    """Write the profiler's trace (``profile``, a finished
    ``utils.trace.DeviceProfile``) with ``sink``'s events added, each
    time moved from the recorder's clock onto the profiler's by the
    start anchor: a recorder time t lands at the anchor's ``ts`` plus
    (t - the anchor's recorder time).  Returns the clocks' drift over
    the profile, the profiler's time between its two anchors less the
    recorder's, in seconds; the file keeps it as ``hostClockDrift_s``."""
    from ..utils.trace import ANCHOR_END, ANCHOR_START

    with open(profile.path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    at = {e["name"]: e["ts"] for e in events
          if e.get("ph") == "X" and e.get("name") in profile.anchors}
    t_start = profile.anchors[ANCHOR_START]
    shift = at[ANCHOR_START] - (t_start - sink._t0) * 1e6
    for ev in sink.events(counters):
        if "ts" in ev:
            ev["ts"] += shift
        events.append(ev)
    drift = (at[ANCHOR_END] - at[ANCHOR_START]) * 1e-6 \
        - (profile.anchors[ANCHOR_END] - t_start)
    doc["hostClockDrift_s"] = drift
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, default=str)
    os.replace(tmp, path)
    return drift


@contextlib.contextmanager
def trace(path: str, recorder: Optional[Recorder] = None,
          device_log_dir: Optional[str] = None) -> Iterator[ChromeTraceSink]:
    """Capture every span finished inside the body into a Chrome trace at
    ``path``.  With ``device_log_dir``, the body also runs under
    ``utils.trace.device_profile`` (torch.profiler), whose trace goes to
    that directory, and the spans and the profile are merged onto the
    profiler's clock in ``path``'s ``.merged.json`` twin
    (``_write_merged``; the sink's ``merged_path`` and ``clock_drift_s``
    hold the file and the drift).  The files are written even when the body raises — a
    crashed run's trace is exactly the one worth reading."""
    from ..utils.trace import device_profile

    rec = recorder or get_recorder()
    sink = ChromeTraceSink(rec)
    # Write an empty-but-valid trace up front: a bad path fails HERE,
    # before hours of instrumented work, never in the finally below
    # (where it would also mask the body's own exception).
    sink.write(path)
    rec.add_sink(sink)
    profile = None
    try:
        with device_profile(device_log_dir, clock=rec.now) as profile:
            yield sink
    finally:
        rec.remove_sink(sink)
        counters = dict(rec.counters)
        sink.write(path, counters=counters)
        if profile is not None and profile.path is not None:
            sink.merged_path = _merged_path(path)
            sink.clock_drift_s = _write_merged(
                sink.merged_path, profile, sink, counters)
