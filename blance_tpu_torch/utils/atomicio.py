# Copied from blance_tpu/utils/atomicio.py.
"""Crash-atomic filesystem writes — the ONE copy of the recipe.

Three persistence paths grew the same temp+fsync+rename idiom
independently (``rebalance.save_partition_map``, ``CostModel.save``,
and the durability journal's segment rotation), and all three shared
the same latent hole: the FILE is fsync'd, but the containing
DIRECTORY is not, so on power failure the rename itself — the step
that makes the new bytes visible under the real name — can be lost
and the checkpoint silently reverts.  POSIX only guarantees the
directory entry is durable after an fsync on the *directory* fd.

This module is that recipe, once, with the hole fixed:

1. temp file IN THE SAME DIRECTORY (``os.replace`` is only atomic
   within a filesystem),
2. optional mode preservation (mkstemp creates 0600, which would break
   unprivileged readers of a world-readable checkpoint),
3. write + flush + ``os.fsync`` on the file,
4. ``os.replace`` into place,
5. ``os.fsync`` on the directory fd so the rename is durable too,
6. unlink-the-temp + re-raise on any failure — the previous file
   survives untouched.

fsync (steps 3 and 5) is gated by the ``BLANCE_WAL_FSYNC`` env var
(default ON; set ``0`` to skip) so CI and tests that hammer the
journal do not pay thousands of real disk barriers.  Atomicity (temp +
rename) is NOT gated — only durability-across-power-loss is.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Optional

__all__ = [
    "fsync_enabled",
    "fsync_dir",
    "atomic_write_text",
    "atomic_write_json",
]

_FSYNC_ENV = "BLANCE_WAL_FSYNC"


def fsync_enabled() -> bool:
    """True unless ``BLANCE_WAL_FSYNC=0`` — the CI speed valve."""
    return os.environ.get(_FSYNC_ENV, "1") != "0"


def fsync_dir(directory: str) -> None:
    """Make a completed rename in ``directory`` durable.

    No-op when fsync is gated off, or on platforms where a directory
    cannot be opened/fsync'd (Windows raises; some network filesystems
    return EINVAL) — there the rename is still atomic, just not
    guaranteed to survive power loss, which matches the old behavior.
    """
    if not fsync_enabled():
        return
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _target_mode(path: str) -> int:
    """Mode to stamp on the temp file: the existing target's, or the
    umask default for a fresh file (never mkstemp's 0600)."""
    try:
        return os.stat(path).st_mode & 0o777
    except FileNotFoundError:
        umask = os.umask(0)
        os.umask(umask)
        return 0o666 & ~umask


def atomic_write_text(path: str, text: str, *,
                      preserve_mode: bool = True) -> None:
    """Atomically (and, fsync permitting, durably) replace ``path``
    with ``text``.  See the module docstring for the exact recipe."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(
        prefix=os.path.basename(path) + ".", suffix=".tmp", dir=directory)
    try:
        if preserve_mode:
            os.fchmod(fd, _target_mode(path))
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            if fsync_enabled():
                os.fsync(f.fileno())
        os.replace(tmp, path)
        fsync_dir(directory)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path: str, obj: Any, *,
                      indent: Optional[int] = None,
                      sort_keys: bool = False,
                      preserve_mode: bool = True) -> None:
    """``atomic_write_text`` with JSON encoding (same output bytes as a
    direct ``json.dump`` with the same knobs)."""
    atomic_write_text(
        path, json.dumps(obj, indent=indent, sort_keys=sort_keys),
        preserve_mode=preserve_mode)
