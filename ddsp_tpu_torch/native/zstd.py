"""zstd decompression through the system's ``libzstd.so.1``, bound with ctypes.

Orbax checkpoints (``models/orbax.py``) compress their OCDBT manifests,
B-tree nodes and zarr chunks with zstd.  ``libzstd1`` is part of the base
system of Debian and Ubuntu (``dpkg`` depends on it), so the port binds it
and needs no Python package.  Nothing falls back quietly: a missing library
raises an error that names it.

:func:`decompress` takes one or more frames end to end.  Each frame is
found by its own compressed size (``ZSTD_findFrameCompressedSize`` walks its
block headers; nothing scans for a magic number).  A frame that records its
content size is decoded in one ``ZSTD_decompressDCtx`` call; one that does
not (zarr chunks are written by a streaming compressor) goes through
``ZSTD_decompressStream``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading

LIBRARY = "libzstd.so.1"
# ZSTD_getFrameContentSize's two markers (zstd.h)
CONTENTSIZE_UNKNOWN = 2**64 - 1
CONTENTSIZE_ERROR = 2**64 - 2

_lib = None
_lock = threading.Lock()


class ZstdError(ValueError):
    """A zstd frame that does not decode; the message names what it was."""


class _Buffer(ctypes.Structure):  # ZSTD_inBuffer and ZSTD_outBuffer
    _fields_ = [("data", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def library() -> ctypes.CDLL:
    """Load (once) and bind the system's zstd library."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(LIBRARY)
            except OSError:
                found = ctypes.util.find_library("zstd")
                if found is None:
                    raise OSError(
                        f"{LIBRARY} not found: reading zstd-compressed Orbax checkpoints "
                        "needs the system's zstd library (Debian/Ubuntu package libzstd1)"
                    ) from None
                lib = ctypes.CDLL(found)
            sz, vp, cp = ctypes.c_size_t, ctypes.c_void_p, ctypes.c_char_p
            bp = ctypes.POINTER(_Buffer)
            for name, res, args in (
                ("ZSTD_versionNumber", ctypes.c_uint, []),
                ("ZSTD_isError", ctypes.c_uint, [sz]),
                ("ZSTD_getErrorName", cp, [sz]),
                ("ZSTD_getFrameContentSize", ctypes.c_ulonglong, [vp, sz]),
                ("ZSTD_findFrameCompressedSize", sz, [vp, sz]),
                ("ZSTD_createDCtx", vp, []),
                ("ZSTD_freeDCtx", sz, [vp]),
                ("ZSTD_DCtx_reset", sz, [vp, ctypes.c_int]),
                ("ZSTD_decompressDCtx", sz, [vp, vp, sz, vp, sz]),
                ("ZSTD_decompressStream", sz, [vp, bp, bp]),
                ("ZSTD_DStreamOutSize", sz, []),
            ):
                getattr(lib, name).restype = res
                getattr(lib, name).argtypes = args
            _lib = lib
        return _lib


def version() -> str:
    """The bound library's version, as ``major.minor.release``."""
    v = library().ZSTD_versionNumber()
    return f"{v // 10000}.{v // 100 % 100}.{v % 100}"


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ZstdError(f"{what}: zstd error: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def _stream_frame(lib, dctx, src, start: int, length: int, what: str) -> bytes:
    """One frame without a recorded content size, through the streaming API."""
    _check(lib, lib.ZSTD_DCtx_reset(dctx, 1), what)  # ZSTD_reset_session_only
    step = lib.ZSTD_DStreamOutSize()
    out = ctypes.create_string_buffer(step)
    inb = _Buffer(ctypes.addressof(src) + start, length, 0)
    parts = []
    while True:
        outb = _Buffer(ctypes.addressof(out), step, 0)
        left = _check(lib, lib.ZSTD_decompressStream(dctx, ctypes.byref(outb), ctypes.byref(inb)),
                      what)
        parts.append(out.raw[: outb.pos])
        if left == 0:  # the frame is complete and flushed
            return b"".join(parts)
        if inb.pos == inb.size and outb.pos < step:
            raise ZstdError(f"{what}: zstd frame truncated after {length} bytes")


def decompress(data, what: str = "zstd input") -> bytes:
    """The concatenated content of the zstd frames in ``data`` (bytes-like),
    each frame located by its own compressed size.  ``what`` names the input
    in a :class:`ZstdError`.  Empty input holds no frame and gives b''."""
    lib = library()
    data = bytes(data)
    if not data:
        return b""
    src = ctypes.create_string_buffer(data, len(data))
    base = ctypes.addressof(src)
    dctx = lib.ZSTD_createDCtx()
    if not dctx:
        raise MemoryError("ZSTD_createDCtx failed")
    try:
        parts, pos = [], 0
        while pos < len(data):
            left = len(data) - pos
            size = lib.ZSTD_getFrameContentSize(base + pos, left)
            if size == CONTENTSIZE_ERROR:
                raise ZstdError(f"{what}: no zstd frame at byte {pos} of {len(data)}")
            frame = _check(lib, lib.ZSTD_findFrameCompressedSize(base + pos, left),
                           f"{what} (frame at byte {pos})")
            if size == CONTENTSIZE_UNKNOWN:
                parts.append(_stream_frame(lib, dctx, src, pos, frame, what))
            else:
                out = ctypes.create_string_buffer(max(size, 1))
                got = _check(lib, lib.ZSTD_decompressDCtx(dctx, out, size, base + pos, frame),
                             f"{what} (frame at byte {pos})")
                if got != size:
                    raise ZstdError(f"{what}: frame at byte {pos} gave {got} of {size} bytes")
                parts.append(out.raw[:size])
            pos += frame
        return b"".join(parts)
    finally:
        lib.ZSTD_freeDCtx(dctx)
