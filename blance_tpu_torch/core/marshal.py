# Copied from blance_tpu/core/marshal.py, loading the port's own copy of the
# extension (blance_tpu_torch/native/marshal.c, module _blance_torch_marshal).
"""Loader for the native marshalling extension (native/marshal.c).

Compiles the CPython extension on first use with the session's own
interpreter headers and the host's ``gcc`` (no pip, no setuptools build
step) into ``core/_native_build/`` and imports it as a real module.  All
users go through :func:`get` and fall back to pure Python when the
toolchain or headers are unavailable, so the framework never
hard-depends on a compiler.
"""

from __future__ import annotations

import importlib.util
import os
import sysconfig

from ..utils.nativebuild import compile_cached

__all__ = ["get", "available"]

_NAME = "_blance_torch_marshal"
_MOD = None
_FAILED = False


def _build_dir() -> str:
    return os.path.join(os.path.dirname(__file__), "_native_build")


def _source_path() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "native", "marshal.c")


def get() -> object:
    """The extension module, or None when unavailable."""
    global _MOD, _FAILED
    if _MOD is not None or _FAILED:
        return _MOD
    src = _source_path()
    ext = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    so = os.path.join(_build_dir(), _NAME + ext)
    include = sysconfig.get_paths()["include"]
    if not compile_cached(src, so, ["gcc", "-O2", "-shared", "-fPIC",
                                    f"-I{include}", "-o", so, src]):
        _FAILED = True
        return None
    try:
        spec = importlib.util.spec_from_file_location(_NAME, so)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    except (OSError, ImportError):
        _FAILED = True
        return None
    _MOD = mod
    return _MOD


def available() -> bool:
    return get() is not None
