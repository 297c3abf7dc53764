"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

On first use every source is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a`` into a shared library with a plain C
interface under ``build/repro_torch/`` at the checkout's root. A library's
file name carries a hash of its source, the shared headers and the flags,
so an edited source is rebuilt and an unchanged one is reused. Libraries
are loaded with ``ctypes``; every C entry point returns
``cudaGetLastError()`` after its launch, and :func:`check` raises on a
non-zero code.

Nothing here runs at import time: the CPU tests import every module, and
``nvcc`` is needed only when a kernel is first launched.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Sequence

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
#: per source: {"seconds": nvcc wall time or 0.0 when reused, "log": path}
BUILD_INFO: Dict[str, dict] = {}

C_PTR = ctypes.c_void_p
C_INT = ctypes.c_int
C_FLOAT = ctypes.c_float


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return path


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256()
    for f in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` that has no library yet, one ``nvcc``
    per source, in parallel. Returns {source stem: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, jobs = {}, []
    for src in sorted(CSRC.glob("*.cu")):
        lib = _lib_path(src)
        out[src.stem] = lib
        if lib.exists():
            BUILD_INFO.setdefault(src.stem, {"seconds": 0.0, "log": None})
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        log = lib.with_suffix(".log")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(src)]
        logf = open(log, "w")
        jobs.append((src, lib, tmp, log, logf, time.monotonic(),
                     subprocess.Popen(cmd, stdout=logf,
                                      stderr=subprocess.STDOUT)))
    failed = []
    for src, lib, tmp, log, logf, t0, proc in jobs:
        rc = proc.wait()
        logf.close()
        BUILD_INFO[src.stem] = {"seconds": time.monotonic() - t0,
                                "log": str(log)}
        if rc != 0:
            os.unlink(tmp)
            failed.append(f"{src.name} (rc {rc}):\n{log.read_text()}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def function(lib_name: str, fn: str, argtypes: Sequence):
    """The C entry point ``fn`` of library ``lib_name``, with its argument
    types set (``c_void_p`` for pointers and the stream, ``c_int`` for
    ints) and an ``int`` result (the CUDA error code)."""
    lib = _LIBS.get(lib_name)
    if lib is None:
        lib = _LIBS[lib_name] = ctypes.CDLL(str(build_all()[lib_name]))
        lib.cuda_error_string.argtypes = [C_INT]
        lib.cuda_error_string.restype = ctypes.c_char_p
    f = getattr(lib, fn)
    f.argtypes = list(argtypes)
    f.restype = C_INT
    return f


def check(lib_name: str, rc: int, what: str) -> None:
    if rc != 0:
        msg = _LIBS[lib_name].cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
