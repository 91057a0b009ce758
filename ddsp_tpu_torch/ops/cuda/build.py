"""Build and load the port's CUDA kernels: ``nvcc`` by hand, ``ctypes``.

Every kernel source in ``ddsp_tpu_torch/csrc/`` has a plain C entry point
that launches on a caller-given stream and returns ``cudaGetLastError()``.
``library(name)`` compiles ``csrc/<name>.cu`` for ``sm_90a`` into
``ddsp_tpu_torch/_build/`` on first use (never at import) and loads it;
the library's file name carries a hash of the source, the shared headers
and the flags, so an edited source is rebuilt.  The compiler's report
(registers, spills) is kept beside the library in a ``.log`` file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
# No --use_fast_math: the split-precision phase needs the accurate sinf.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (once per source, headers and flags) and
    return the path of the shared library."""
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(source)],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name}:\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent process never loads a torn file
    return lib


def library(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` once per process, with
    ``argtypes`` set from ``signatures`` ({function: argtypes}) and an
    ``int`` (CUDA error code) result for each."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build(name)))
            for fn_name, argtypes in signatures.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]
