"""Process topology over ``torch.distributed``.

Counterpart of ``horovod_tpu/topology.py``. One process drives one
device: NCCL on CUDA, gloo on the CPU. ``init`` reads the usual
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` /
``MASTER_ADDR`` / ``MASTER_PORT`` when a launcher sets them; a single
process needs no launcher and gets an in-process store at world size 1.
It runs on CUDA unless the caller passes ``device="cpu"`` and never
falls back to the CPU on its own.

At world size > 1 ``init`` also creates a gloo control group for the
collective engine's negotiation (``ops/collective.py``); data stays on
the default group. ``init`` starts the engine and ``shutdown`` stops it
before destroying the groups.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, Optional, Union

import torch
import torch.distributed as dist

from .utils import env as _env


class NotInitializedError(RuntimeError):
    """Raised when rank/size accessors are used before ``init()``."""


_NOT_INITIALIZED_MSG = (
    "Horovod has not been initialized; please call horovod_tpu_torch.init().")


@dataclasses.dataclass(frozen=True)
class Topology:
    rank: int
    size: int
    local_rank: int
    local_size: int
    backend: str
    device: torch.device
    owns_group: bool      # init() created the process group
    # The collective engine's negotiation group (gloo); None at size 1.
    control_group: Optional[object] = dataclasses.field(default=None,
                                                        compare=False)
    # HOROVOD_TPU_NUMERICS at init: the buckets count nonfinite gradients.
    numerics: bool = False
    # Elastic generation: 0 for the first launch (and every non-elastic
    # job), bumped by an elastic driver on every recovery relaunch
    # (HOROVOD_TPU_ELASTIC_GENERATION).
    generation: int = 0


_lock = threading.Lock()
_topology: Optional[Topology] = None
_meshes: Dict[str, object] = {}


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """``device`` as a torch.device, CUDA by default; raises when CUDA is
    asked for (or defaulted to) and absent."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def init(*, device: Union[str, torch.device, None] = None,
         init_method: Optional[str] = None, rank: Optional[int] = None,
         world_size: Optional[int] = None) -> Topology:
    """Initialize the process group and snapshot the topology.

    Safe to call more than once; an existing default process group (set
    up by the caller) is adopted rather than replaced."""
    global _topology
    with _lock:
        if _topology is not None:
            return _topology
        dev = resolve_device(device)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        r = rank if rank is not None else (_env_int("RANK") or 0)
        n = world_size if world_size is not None else (
            _env_int("WORLD_SIZE") or 1)
        local_size = _env_int("LOCAL_WORLD_SIZE") or n
        local_rank = _env_int("LOCAL_RANK")
        if local_rank is None:
            local_rank = r % local_size
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", local_rank)
            torch.cuda.set_device(dev)

        owns = not dist.is_initialized()
        if owns:
            if init_method is None and os.environ.get("MASTER_ADDR"):
                init_method = "env://"
            if init_method is not None:
                dist.init_process_group(backend, init_method=init_method,
                                        rank=r, world_size=n)
            elif n == 1:
                dist.init_process_group(backend, store=dist.HashStore(),
                                        rank=0, world_size=1)
            else:
                raise ValueError(
                    f"world size {n} needs a rendezvous: set MASTER_ADDR/"
                    "MASTER_PORT or pass init_method (e.g. "
                    "'tcp://localhost:29500')")
        else:
            backend = dist.get_backend()
        ctrl = (dist.new_group(backend="gloo")
                if dist.get_world_size() > 1 else None)
        _topology = topo = Topology(
            rank=dist.get_rank(), size=dist.get_world_size(),
            local_rank=local_rank, local_size=local_size, backend=backend,
            device=dev, owns_group=owns, control_group=ctrl,
            numerics=_env.numerics_enabled(),
            generation=_env_int("HOROVOD_TPU_ELASTIC_GENERATION") or 0)
    # Outside the lock: the engine builds the hierarchical mesh's groups.
    from .ops import collective
    collective.start_engine(topo)
    return topo


def shutdown() -> None:
    """Stop the collective engine (every rank's pending ops fail with
    ``SHUT_DOWN_ERROR``), then destroy the groups ``init`` created."""
    global _topology
    from .ops import collective
    collective.stop_engine()
    with _lock:
        if _topology is not None and dist.is_initialized():
            if _topology.control_group is not None:
                dist.destroy_process_group(_topology.control_group)
            if _topology.owns_group:
                dist.destroy_process_group()
        _topology = None
        _meshes.clear()


def is_initialized() -> bool:
    return _topology is not None


def _get() -> Topology:
    if _topology is None:
        raise NotInitializedError(_NOT_INITIALIZED_MSG)
    return _topology


def topology() -> Topology:
    return _get()


def rank() -> int:
    return _get().rank


def local_rank() -> int:
    return _get().local_rank


def size() -> int:
    return _get().size


def local_size() -> int:
    return _get().local_size


def process_rank() -> int:
    """One process per rank: the same as :func:`rank`."""
    return _get().rank


def process_count() -> int:
    return _get().size


def generation() -> int:
    """Elastic generation of this job: 0 on the first launch, one more
    on every recovery relaunch. A worker tells a cold start from a
    rejoin by it."""
    return _get().generation


def mpi_threads_supported() -> bool:
    """``hvd.mpi_threads_supported()`` of Horovod's API
    (operations.cc:2462-2468): there is no MPI here, and the engine and
    ``torch.distributed`` take ops from any thread, so True once
    initialized."""
    _get()
    return True


def device() -> torch.device:
    """The device this process drives."""
    return _get().device


def _mesh(kind: str):
    topo = _get()
    with _lock:
        if kind not in _meshes:
            from .parallel import mesh as _mesh_mod
            if kind == "flat":
                m = _mesh_mod.create_mesh(dp=-1)
            else:
                m = _mesh_mod.create_mesh(dcn=topo.size // topo.local_size,
                                          ici=topo.local_size)
            _meshes[kind] = m
        return _meshes[kind]


def mesh():
    """The flat world mesh, axis name ``'dp'`` (the "world communicator").
    Built on first call, which every rank makes."""
    return _mesh("flat")


def hierarchical_mesh():
    """The ``('dcn', 'ici')`` mesh, ``(size // local_size, local_size)``
    (the local/cross communicator split). Built on first call, which
    every rank makes."""
    return _mesh("hier")
