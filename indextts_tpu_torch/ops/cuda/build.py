"""Build a kernel source of csrc/ with nvcc into a shared library and load it
with ctypes.

Each source has a plain C interface (no PyTorch headers), so nvcc builds it in
seconds. The library goes to build/kernels/ beside the package, named by a
hash of the source, the headers of csrc/ and the flags, so an edited source
builds anew and an unchanged one loads the existing library. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_locks_lock = threading.Lock()
_locks: Dict[str, threading.Lock] = {}  # one per source: sources build in parallel
_loaded: Dict[str, ctypes.CDLL] = {}
# seconds each library took to build in this process (0.0 when it was found
# already built); read by chip_smoke.py
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin, default /usr/local/cuda/bin)")


def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<source>; returns the ctypes library.
    Threads may build different sources at once."""
    with _locks_lock:
        lock = _locks.setdefault(source, threading.Lock())
    with lock:
        if source in _loaded:
            return _loaded[source]
        src = CSRC_DIR / source
        headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
        digest = hashlib.sha1(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
        lib_path = BUILD_DIR / f"{src.stem}-{digest}.so"
        start = time.perf_counter()
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.tmp.so")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True,
            )
            # ptxas -v reports registers, shared memory and spills per kernel
            lib_path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, lib_path)
        build_seconds[source] = time.perf_counter() - start
        lib = ctypes.CDLL(str(lib_path))
        _loaded[source] = lib
        return lib


def build_log(source: str) -> str:
    """The compiler output of the library built from csrc/<source>, if any."""
    src = CSRC_DIR / source
    logs = sorted(BUILD_DIR.glob(f"{src.stem}-*.log"), key=lambda p: p.stat().st_mtime)
    return logs[-1].read_text() if logs else ""
