"""Build and bind the port's CUDA kernels (``tpuclip_torch/csrc``).

``nvcc`` compiles the sources into a plain-C shared library at first use;
ctypes loads it. The library lands in ``build/tpuclip_torch/`` at the
checkout root beside a stamp of the source hash and flags, and is rebuilt
when either changes. Without ``nvcc`` the build raises: a CUDA tensor is
never served by anything but the kernel.
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
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "int8_scan.cu"
BUILD_DIR = _PKG.parent / "build" / "tpuclip_torch"
LIBRARY = BUILD_DIR / "libint8_scan.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# Seconds the last nvcc run took in this process (None: no build ran).
last_build_seconds: Optional[float] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the int8 "
        "scan kernels cannot be built, and CUDA tensors have no other path."
    )


def _stamp() -> str:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()


def build(force: bool = False) -> Path:
    """Compile the library if it is missing or stale (or ``force``)."""
    global last_build_seconds
    stamp_file = LIBRARY.with_suffix(".so.sha256")
    stamp = _stamp()
    if (
        not force
        and LIBRARY.exists()
        and stamp_file.exists()
        and stamp_file.read_text().strip() == stamp
    ):
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f".{LIBRARY.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    last_build_seconds = time.perf_counter() - t0
    os.replace(tmp, LIBRARY)  # atomic: concurrent builders never see a partial file
    stamp_file.write_text(stamp)
    return LIBRARY


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.tpuclip_int8_scores.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
            lib.tpuclip_int8_scores.restype = i32
            lib.tpuclip_int8_candidates_packed.argtypes = [
                ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr,
            ]
            lib.tpuclip_int8_candidates_packed.restype = i32
            _lib = lib
        return _lib
