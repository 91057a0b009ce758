"""Native (C++) host runtime of the real-time path: an SPSC ring buffer and
PCM16 <-> float32 conversion, bound with ``ctypes``.

The port's own copy of ``ddsp_tpu/native/__init__.py:RingBuffer``,
``pcm16_to_f32`` and ``f32_to_pcm16`` over ``ringbuffer.cpp`` (a copy of
the JAX package's source).  The library is built with ``g++`` at the first
call that needs it, never at import, into the git-ignored
``ddsp_tpu_torch/_build/`` (the file name carries a hash of the source and
the flags).  Nothing falls back quietly: a missing compiler or a failed
build raises an error that names ``g++`` and carries its output;
``RingBuffer(..., force_python=True)`` is the only way to the Python ring.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("ringbuffer.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib = None
_lock = threading.Lock()


def _build() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    lib = BUILD_DIR / f"libringbuffer_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(
            "g++ not found: the native ring buffer is built with g++ at first "
            "use; install it, or pass force_python=True for the Python ring")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent process never loads a torn file
    return lib


def library() -> ctypes.CDLL:
    """Build (once per source) and load the native library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            u64, vp = ctypes.c_uint64, ctypes.c_void_p
            fp = ctypes.POINTER(ctypes.c_float)
            i16p = ctypes.POINTER(ctypes.c_int16)
            for name, res, args in (
                ("rb_create", vp, [u64]), ("rb_destroy", None, [vp]),
                ("rb_capacity", u64, [vp]), ("rb_readable", u64, [vp]),
                ("rb_writable", u64, [vp]), ("rb_write", u64, [vp, fp, u64]),
                ("rb_read", u64, [vp, fp, u64]), ("rb_peek", u64, [vp, fp, u64]),
                ("pcm16_to_f32", None, [i16p, fp, u64]),
                ("f32_to_pcm16", None, [fp, i16p, u64]),
            ):
                getattr(lib, name).restype = res
                getattr(lib, name).argtypes = args
            _lib = lib
        return _lib


def _fptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class RingBuffer:
    """Lock-free single-producer single-consumer float ring buffer.

    One producer thread calls :meth:`write`, one consumer thread
    :meth:`read` / :meth:`peek`.  The capacity is rounded up to a power of
    two.  ``force_python=True`` runs a locked numpy ring instead of the
    native one.
    """

    def __init__(self, capacity: int, force_python: bool = False):
        self._lib = None if force_python else library()
        if self._lib is not None:
            self._handle = self._lib.rb_create(capacity)
            if not self._handle:
                raise MemoryError("rb_create failed")
            self.capacity = int(self._lib.rb_capacity(self._handle))
        else:
            cap = 1
            while cap < max(capacity, 2):
                cap *= 2
            self.capacity = cap
            self._data = np.zeros(cap, np.float32)
            self._head = 0
            self._tail = 0
            self._plock = threading.Lock()

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if getattr(self, "_lib", None) is not None and handle:
            self._lib.rb_destroy(handle)
            self._handle = None

    def write(self, samples: np.ndarray) -> int:
        """Copy up to len(samples) in; returns the number written."""
        samples = np.ascontiguousarray(samples, np.float32)
        if self._lib is not None:
            return int(self._lib.rb_write(self._handle, _fptr(samples), len(samples)))
        with self._plock:
            n = min(len(samples), self.capacity - (self._head - self._tail))
            self._data[(self._head + np.arange(n)) & (self.capacity - 1)] = samples[:n]
            self._head += n
            return n

    def _take(self, n: int, consume: bool) -> np.ndarray:
        out = np.empty(n, np.float32)
        if self._lib is not None:
            fn = self._lib.rb_read if consume else self._lib.rb_peek
            return out[: int(fn(self._handle, _fptr(out), n))]
        with self._plock:
            got = min(n, self._head - self._tail)
            out[:got] = self._data[(self._tail + np.arange(got)) & (self.capacity - 1)]
            if consume:
                self._tail += got
            return out[:got]

    def read(self, n: int) -> np.ndarray:
        """Copy up to n samples out, consuming them."""
        return self._take(n, consume=True)

    def peek(self, n: int) -> np.ndarray:
        """Copy up to n samples out without consuming them."""
        return self._take(n, consume=False)

    def readable(self) -> int:
        if self._lib is not None:
            return int(self._lib.rb_readable(self._handle))
        return self._head - self._tail

    def writable(self) -> int:
        return self.capacity - self.readable()


def pcm16_to_f32(pcm: np.ndarray) -> np.ndarray:
    """int16 -> float32 in [-1, 1) (x / 32768), any shape."""
    pcm = np.ascontiguousarray(pcm, np.int16)
    out = np.empty(pcm.shape, np.float32)
    library().pcm16_to_f32(pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                           _fptr(out), pcm.size)
    return out


def f32_to_pcm16(audio: np.ndarray) -> np.ndarray:
    """float32 -> int16: x * 32767 clipped to [-32768, 32767], truncated
    toward zero, any shape."""
    audio = np.ascontiguousarray(audio, np.float32)
    out = np.empty(audio.shape, np.int16)
    library().f32_to_pcm16(_fptr(audio), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                           audio.size)
    return out
