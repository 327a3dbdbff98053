"""Checkpoint payload checksums (counterpart of
paddle_tpu/resilience/integrity.py, the port's own copy).

Every checkpoint file's checksum is recorded at write time and verified
at restore time: a torn or bit-flipped file raises :class:`ChecksumError`
instead of restoring corrupt weights. The algorithm is crc32c when a
native module (``google_crc32c`` or ``crc32c``) is importable, else
zlib's crc32, and its name travels with the value (``"crc32c:9a7f..."``,
``"crc32:..."``), so a restore verifies with the writer's algorithm. A
crc32c-tagged file written where a native module existed still verifies
where none does, through the pure-Python crc32c (slow, but restorable).
Inputs may be any bytes-like object; memoryviews are checksummed in
chunks, so a large leaf is never copied whole."""

from __future__ import annotations

import sys
import zlib

_CHUNK = 1 << 20

# (kind, fns...): "google" has value() + extend(); the "crc32c"
# package's crc32c(data, crc) is incremental itself
_IMPL = None
try:
    import google_crc32c as _g

    _IMPL = ("google", _g.value, _g.extend)
except ImportError:
    try:
        import crc32c as _c

        _IMPL = ("crc32c", _c.crc32c)
    except ImportError:
        _IMPL = None


class ChecksumError(RuntimeError):
    """A checkpoint file's bytes do not match its recorded checksum."""


_PP_TABLE = None
_pp_warned = False


def _crc32c_pure(data) -> int:
    """Table-driven pure-Python crc32c (~MB/s), to verify crc32c-tagged
    files where no native module exists. New saves never take it."""
    global _PP_TABLE, _pp_warned
    if not _pp_warned:
        _pp_warned = True
        print("[resilience] no native crc32c module: verifying a "
              "crc32c-tagged checkpoint with the pure-python fallback "
              "(slow)", file=sys.stderr)
    if _PP_TABLE is None:
        table = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            table.append(c)
        _PP_TABLE = table
    crc = 0xFFFFFFFF
    for b in memoryview(data).cast("B"):
        crc = _PP_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _crc32c_value(data) -> int:
    """Native crc32c over any bytes-like, chunked for memoryviews."""
    if isinstance(data, bytes):
        return _IMPL[1](data)
    mv = memoryview(data).cast("B")
    crc = 0
    for i in range(0, len(mv), _CHUNK):
        chunk = bytes(mv[i:i + _CHUNK])
        crc = (_IMPL[2](crc, chunk) if _IMPL[0] == "google"
               else _IMPL[1](chunk, crc))
    return crc


def checksum_bytes(data) -> str:
    """``"<algo>:<hex>"`` tag for ``data`` (crc32c when a native module
    exists, else crc32)."""
    if _IMPL is not None:
        return f"crc32c:{_crc32c_value(data) & 0xffffffff:08x}"
    return f"crc32:{zlib.crc32(data) & 0xffffffff:08x}"


def verify_bytes(data, tag: str, *, name: str = "<data>") -> None:
    """Raise :class:`ChecksumError` unless ``data`` matches ``tag``,
    computed with the algorithm the tag names; an unknown algorithm
    raises too."""
    algo, _, want = tag.partition(":")
    if algo == "crc32c" and _IMPL is not None:
        got = f"{_crc32c_value(data) & 0xffffffff:08x}"
    elif algo == "crc32":
        got = f"{zlib.crc32(data) & 0xffffffff:08x}"
    elif algo == "crc32c":
        got = f"{_crc32c_pure(data) & 0xffffffff:08x}"
    else:
        raise ChecksumError(f"{name}: unknown checksum algorithm {algo!r}")
    if got != want:
        raise ChecksumError(
            f"{name}: checksum mismatch — recorded {tag}, computed "
            f"{algo}:{got} (torn or bit-flipped file)")
