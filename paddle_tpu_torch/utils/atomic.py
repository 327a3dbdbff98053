"""Atomic file writes (counterpart of paddle_tpu/utils/atomic.py, kept
as the port's own copy): stage to a same-directory temp file, publish
with ``os.replace``. A reader, or a successor process after a crash,
sees the old content or all of the new, never a torn middle; a failed
write unlinks the temp file and leaves the target untouched."""

from __future__ import annotations

import os
import tempfile


def _atomic_write(path: str, payload, mode: str, prefix: str) -> str:
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=prefix, suffix=".tmp")
    try:
        with os.fdopen(fd, mode) as f:
            f.write(payload)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def atomic_write_text(path: str, text: str,
                      prefix: str = ".pt_atomic_") -> str:
    """Write ``text`` to ``path`` atomically. Returns ``path``."""
    return _atomic_write(path, text, "w", prefix)


def atomic_write_bytes(path: str, data, prefix: str = ".pt_atomic_") -> str:
    """Write any bytes-like ``data`` to ``path`` atomically (checkpoint
    leaves). Returns ``path``."""
    return _atomic_write(path, data, "wb", prefix)
