"""Build the port's CUDA kernels on first use and bind them with ctypes.

Each ``ops/csrc/<name>.cu`` compiles on its own, with one ``nvcc`` call,
into a shared library with a plain C interface under ``ops/_build/``
(listed in ``.gitignore``)::

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -fmad=false
         -shared -Xcompiler -fPIC -o ops/_build/lib<name>_<hash>.so <name>.cu

The library name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited kernel is never served from
a stale build.  ``-fmad=false`` keeps nvcc
from contracting any multiply-add the plain PyTorch version rounds
twice; the kernels spell the one fused multiply-add they need (the
tie-break jitter, which XLA contracts in the reference) as ``fmaf``.

A build failure raises; nothing here falls back to the plain version.
``build_all`` starts every ``nvcc`` at once, so a cold start costs the
slowest kernel's build, not the sum; ``load(name, beside=...)`` builds
the libraries its caller needs next in the same wave.

Each build, and each first load of a library no build of this process
made, is one event for the device observatory's build accounting
(``obs/device.note_compile``), attributed to the entry scope open at
that moment.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

from ..obs import device as _obs_device

__all__ = ["load", "build_all", "kernel_sources", "NVCC_FLAGS"]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_HERE, "csrc")
_BUILD_DIR = os.path.join(_HERE, "_build")
_LIBS: dict[str, ctypes.CDLL] = {}
_BUILT: set[str] = set()  # libraries this process built (already counted)
_LOCK = threading.Lock()


def kernel_sources() -> dict[str, str]:
    """name -> path of every kernel source under ops/csrc/."""
    return {f[:-3]: os.path.join(_SRC_DIR, f)
            for f in sorted(os.listdir(_SRC_DIR)) if f.endswith(".cu")}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or put the CUDA toolkit "
                       "on PATH); the port's kernels build from source")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(_SRC_DIR) if f.endswith(".cuh"))
    for path in [kernel_sources()[name]] + [
            os.path.join(_SRC_DIR, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"lib{name}_{digest}.so")


def _tmp(out: str) -> str:
    return f"{out}.{os.getpid()}.tmp"


def _compile(name: str, out: str) -> tuple[subprocess.Popen, float]:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", _tmp(out),
           kernel_sources()[name]]
    return (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            time.perf_counter())


def _finish(name: str, out: str,
            started: tuple[subprocess.Popen, float]) -> str:
    proc, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(_tmp(out), out)  # atomic for concurrent loaders
    _BUILT.add(name)
    _obs_device.note_compile(f"lib{name}", time.perf_counter() - t0)
    return log


def _build_missing(names) -> dict[str, str]:
    """Compile each of ``names`` whose library is missing, all nvcc
    processes in parallel; returns name -> ptxas log ("" for a cached
    build)."""
    logs: dict[str, str] = {}
    procs = {}
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            logs[name] = ""
        else:
            procs[name] = (out, _compile(name, out))
    for name, (out, proc) in procs.items():
        logs[name] = _finish(name, out, proc)
    return logs


def build_all() -> dict[str, str]:
    """Compile every kernel whose library is missing, all nvcc processes
    in parallel; returns name -> ptxas log ("" for a cached build)."""
    return _build_missing(kernel_sources())


def load(name: str, beside: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed; a
    build of it also builds, in parallel, those of the libraries
    ``beside`` that are missing (loaded later, by their own callers)."""
    lib: Optional[ctypes.CDLL] = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            out = _lib_path(name)
            if not os.path.exists(out):
                _build_missing((name,) + tuple(beside))
            t0 = time.perf_counter()
            _LIBS[name] = ctypes.CDLL(out)
            if name not in _BUILT:
                _obs_device.note_compile(f"lib{name}",
                                         time.perf_counter() - t0)
        return _LIBS[name]
