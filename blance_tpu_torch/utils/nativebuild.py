# Copied from blance_tpu/utils/nativebuild.py; a successful call is also a
# build event for the port's device observatory (obs/device.py), timed
# through utils/hostclock.perf_now.
"""Shared compile-and-cache helper for the repo's native components.

The native loaders — here the CPython marshalling extension
(core/marshal.py) — need the same shape:
compile the source once, cache the .so next to the package, rebuild when
the source is newer, and never hard-fail when the toolchain is missing.
"""

from __future__ import annotations

import os
import subprocess

from ..obs import device as _obs_device
from .hostclock import perf_now

__all__ = ["compile_cached"]


def compile_cached(source: str, out_path: str, command: list[str]) -> bool:
    """Ensure ``out_path`` exists and is newer than ``source``.

    ``command`` is the full compiler invocation (it should reference
    ``source`` and ``out_path``).  Returns True when a fresh-enough binary
    is in place; False when the source is missing or the build failed —
    callers fall back to their pure-Python paths.

    The compiler writes to a process-unique temp path in the same
    directory, published with an atomic os.replace(): concurrent importers
    only ever dlopen a fully-written shared object (a plain in-place write
    passes the existence/mtime check the moment the file is created).

    The callers load what this returns once per process, so each
    successful call is one build-or-first-load event for the device
    observatory's build accounting (``obs/device.note_compile``).
    """
    if not os.path.exists(source):
        return False
    tmp_path = f"{out_path}.{os.getpid()}.tmp"
    t0 = perf_now()
    try:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        if (not os.path.exists(out_path)
                or os.path.getmtime(out_path) < os.path.getmtime(source)):
            subprocess.run(
                [tmp_path if c == out_path else c for c in command],
                check=True, capture_output=True)
            os.replace(tmp_path, out_path)
        _obs_device.note_compile(os.path.basename(out_path),
                                 perf_now() - t0)
        return True
    except (OSError, subprocess.CalledProcessError):
        return False
    finally:
        if os.path.exists(tmp_path):
            try:
                os.remove(tmp_path)
            except OSError:
                pass
