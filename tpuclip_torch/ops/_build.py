"""Build and bind the port's CUDA kernels (``tpuclip_torch/csrc/*.cu``).

``nvcc`` compiles each source into its own plain-C shared library at first
use, all sources at once in parallel; ctypes loads them. The libraries land
in ``build/tpuclip_torch/`` at the checkout root beside one stamp of every
source's and header's (``csrc/*.cuh``) hash and the flags, and are all
rebuilt when any of those changes.
Without ``nvcc`` the build raises: a CUDA tensor is never served by anything
but the kernel.
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
from types import SimpleNamespace
from typing import List, Optional

_PKG = Path(__file__).resolve().parents[1]
SOURCES = sorted((_PKG / "csrc").glob("*.cu"))
HEADERS = sorted((_PKG / "csrc").glob("*.cuh"))
BUILD_DIR = _PKG.parent / "build" / "tpuclip_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Every entry point of the libraries: argtypes (pointers and the stream as
# void*, ints as int, floats as float); each returns a cudaError_t as int.
SIGNATURES = {
    "tpuclip_int8_scores": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "tpuclip_int8_candidates_packed": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "tpuclip_int8_candidates": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "tpuclip_patch_embed": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "tpuclip_topk_tiles": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "tpuclip_binary_scores": [_P, _P, _P, _I, _I, _I, _P],
    "tpuclip_binary_topk_q1": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "tpuclip_binary_topk": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "tpuclip_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "tpuclip_attention_sm90": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "tpuclip_add_layernorm": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P],
    "tpuclip_silu_mul": [_P, _P, _I, _I, _P],
    "tpuclip_rope2d": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[SimpleNamespace] = None
# Wall seconds of the last build in this process (None: no build ran).
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
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the port's "
        "CUDA kernels cannot be built, and CUDA tensors have no other path."
    )


def library_path(source: Path) -> Path:
    return BUILD_DIR / f"lib{source.stem}.so"


def _stamp() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for source in SOURCES + HEADERS:
        digest.update(source.name.encode())
        digest.update(source.read_bytes())
    return digest.hexdigest()


def build(force: bool = False) -> List[Path]:
    """Compile every library if one is missing or the stamp is stale (or
    ``force``); one nvcc per source, all running together."""
    global last_build_seconds
    libs = [library_path(s) for s in SOURCES]
    stamp_file = BUILD_DIR / "kernels.sha256"
    stamp = _stamp()
    if (
        not force
        and all(lib.exists() for lib in libs)
        and stamp_file.exists()
        and stamp_file.read_text().strip() == stamp
    ):
        return libs
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for source, lib in zip(SOURCES, libs):
        tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((cmd, proc, tmp, lib))
    failures = []
    for cmd, proc, tmp, lib in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
        else:
            os.replace(tmp, lib)  # atomic: concurrent builders never see a partial file
    if failures:
        raise RuntimeError("\n".join(failures))
    last_build_seconds = time.perf_counter() - t0
    stamp_file.write_text(stamp)
    return libs


def library() -> SimpleNamespace:
    """Every entry point of the kernel libraries, built on first call, as
    attributes (``library().tpuclip_int8_scores(...)``)."""
    global _lib
    with _lock:
        if _lib is None:
            bound = {}
            for path in build():
                lib = ctypes.CDLL(str(path))
                for name, argtypes in SIGNATURES.items():
                    fn = getattr(lib, name, None)
                    if fn is not None:
                        fn.argtypes = argtypes
                        fn.restype = _I
                        bound[name] = fn
            missing = sorted(set(SIGNATURES) - set(bound))
            if missing:
                raise RuntimeError(f"kernel entry points missing from the libraries: {missing}")
            _lib = SimpleNamespace(**bound)
        return _lib
