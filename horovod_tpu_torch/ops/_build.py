"""Build the CUDA sources under ``ops/csrc`` and load them with ctypes.

The kernels have a plain C interface, so ``nvcc`` compiles them in
seconds without PyTorch's headers::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o <build dir>/libhvd_kernels_<hash>.so csrc/*.cu

The build runs at first use, into ``ops/_kernels/`` beside this file (or
``HOROVOD_TPU_TORCH_BUILD_DIR``), and is named by a hash of the sources
and flags, so it reruns only when a source changes. Concurrent builders
(several ranks on one host) each write a private temporary file and
rename it into place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

from ..utils import env as _env

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of this process's build


def sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the port's "
        "CUDA kernels are built from source at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return Path(_env.torch_build_dir() or
                Path(__file__).resolve().parent / "_kernels")


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hvd_flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, f, i, p]
    lib.hvd_flash_dkv.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, f, i,
                                  p]
    lib.hvd_flash_dq.argtypes = [p, p, p, p, p, p, p, i, i, i, i, f, f, i, p]
    for fn in (lib.hvd_flash_fwd, lib.hvd_flash_dkv, lib.hvd_flash_dq):
        fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        target = out_dir / f"libhvd_kernels_{_digest()}.so"
        if not target.exists():
            t0 = time.perf_counter()
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   *[str(s) for s in sources()]]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, target)
            build_seconds = time.perf_counter() - t0
        _lib = _declare(ctypes.CDLL(str(target)))
        return _lib
