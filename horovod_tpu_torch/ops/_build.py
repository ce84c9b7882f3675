"""Build the CUDA sources under ``ops/csrc`` and load them with ctypes.

The kernels have a plain C interface, so ``nvcc`` compiles them in
seconds without PyTorch's headers. Every source compiles in its own
``nvcc`` process, all started together, and one more links them::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c -o <name>.o csrc/<name>.cu      # one per source
    nvcc -shared -o <build dir>/libhvd_kernels_<hash>.so *.o

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

import torch

from ..utils import env as _env

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# The flash kernels' forms, the suffixes of their entry points: bf16
# operands with bf16 and fp32 outputs, fp16 with fp16 and fp32, and fp32
# operands (every product on the tensor cores in three TF32 passes),
# each with the same arguments.
FLASH_FORMS = ("", "_f32", "_f16", "_f16_f32", "_fp32")

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


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    """A tensor's device pointer as a kernel argument; NULL for None."""
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device: kernels launch there."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raise_on(err: int, name: str) -> None:
    """Raise when a C entry point returns a CUDA error: a refused launch
    never runs, and no later synchronize reports it."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def build_dir() -> Path:
    return Path(_env.torch_build_dir() or
                Path(__file__).resolve().parent / "_kernels")


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for form in FLASH_FORMS:
        getattr(lib, "hvd_flash_fwd" + form).argtypes = [
            p, p, p, p, p, i, i, i, i, f, i, p]
        getattr(lib, "hvd_flash_dkv" + form).argtypes = [
            p, p, p, p, p, p, p, p, i, i, i, i, f, i, p]
        getattr(lib, "hvd_flash_dq" + form).argtypes = [
            p, p, p, p, p, p, p, i, i, i, i, f, f, i, p]
    lib.hvd_bn_stats.argtypes = [p, p, p, i, i, i, i, p]
    lib.hvd_bn_norm.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.hvd_bn_bwd_reduce.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i,
                                      i, p]
    lib.hvd_bn_bwd_dx.argtypes = [p, p, p, p, p, p, p, p, p, f, p, p, i, i,
                                  i, i, i, p]
    lib.hvd_flash_ablate.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.hvd_probe_map.argtypes = [p, p, i, i, i, i, p]
    lib.hvd_probe_stats_like.argtypes = [p, p, p, i, i, i, p]
    lib.hvd_wgmma_rate.argtypes = [i, p, i, i, p]
    flash = [getattr(lib, f"hvd_flash_{k}{form}")
             for form in FLASH_FORMS for k in ("fwd", "dkv", "dq")]
    for fn in (*flash, lib.hvd_bn_stats, lib.hvd_bn_norm,
               lib.hvd_bn_bwd_reduce, lib.hvd_bn_bwd_dx, lib.hvd_flash_ablate,
               lib.hvd_probe_map, lib.hvd_probe_stats_like,
               lib.hvd_wgmma_rate):
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
            with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
                _compile(Path(tmp), target)
            build_seconds = time.perf_counter() - t0
        _lib = _declare(ctypes.CDLL(str(target)))
        return _lib


def _run_all(cmds) -> None:
    """Run the commands concurrently; raise with the output of the first
    that fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outs = [proc.communicate() for proc in procs]
    for cmd, proc, (out, err) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{out}\n{err}")


def _compile(tmp: Path, target: Path) -> None:
    """One nvcc per source, all at once, then the link; the library is
    renamed into place only when complete."""
    nvcc = _nvcc()
    objs = [tmp / f"{src.stem}.o" for src in sources()]
    _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
              for src, o in zip(sources(), objs)])
    lib = tmp / target.name
    _run_all([[nvcc, "-shared", "-o", str(lib), *map(str, objs)]])
    os.replace(lib, target)
