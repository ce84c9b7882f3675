"""MXNet-style collectives over the port's engine.

The port's counterpart of ``horovod_tpu/mxnet/mpi_ops.py`` (after
Horovod's mxnet/mpi_ops.py): ``allreduce``/``allreduce_``,
``allreduce_multi_``, ``allgather``, ``broadcast``/``broadcast_`` on
NDArrays, and the process topology. Where the reference pushes an async
op into MXNet's engine and lets ``wait_to_read()`` block, each op here
enqueues the NDArray's tensor into the port's collective engine (on the
card under NCCL) and returns once its result is in place; the engine
fuses the ops of one ``allreduce_multi_``.

64-bit values travel as they are: torch carries int64 and float64 on
gloo and NCCL, so the int32 bit pairs the JAX shim sends them as (its
engine narrows 64-bit values without ``jax_enable_x64``) have no
counterpart here.
"""

from __future__ import annotations

from typing import List, Optional

from .. import ops as _ops
from ..ops import collective as _coll
from ..topology import (init, shutdown, is_initialized, rank, local_rank,
                        size, local_size, mpi_threads_supported)
from . import ndarray as _nd

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "local_rank", "size",
    "local_size", "mpi_threads_supported",
    "allreduce", "allreduce_", "allreduce_multi_", "allgather",
    "broadcast", "broadcast_",
]


def allreduce(tensor, average: bool = True, name: Optional[str] = None):
    """Sum/average over all processes; input unmodified
    (horovod/mxnet/mpi_ops.py:45-80)."""
    return _nd.NDArray._wrap(
        _ops.allreduce_async(tensor.data, average=average, name=name).wait())


def allreduce_(tensor, average: bool = True, name: Optional[str] = None):
    """In-place allreduce (horovod/mxnet/mpi_ops.py:83-111)."""
    _ops.allreduce_async_(tensor.data, average=average, name=name).wait()
    return tensor


def allreduce_multi_(tensors: List, average: bool = True,
                     name_prefix: str = "allreduce") -> List:
    """Submit many in-place allreduces at once and then wait: the engine
    drains them together and fuses them, as the reference's cycle loop
    fuses the grad list an optimizer submits
    (horovod/mxnet/__init__.py:46-51)."""
    _coll.fused_allreduce_async_(
        [t.data for t in tensors], average=average,
        names=[f"{name_prefix}.{i}" for i in range(len(tensors))]).wait()
    return tensors


def allgather(tensor, name: Optional[str] = None):
    """Concatenate over ranks along dim 0; first dims may differ
    (horovod/mxnet/mpi_ops.py:114-148)."""
    return _nd.NDArray._wrap(_ops.allgather_async(tensor.data,
                                                  name=name).wait())


def broadcast(tensor, root_rank: int, name: Optional[str] = None):
    """Out-of-place broadcast from ``root_rank``
    (horovod/mxnet/mpi_ops.py:151-184)."""
    return _nd.NDArray._wrap(
        _ops.broadcast_async(tensor.data, root_rank, name=name).wait())


def broadcast_(tensor, root_rank: int, name: Optional[str] = None):
    """In-place broadcast (horovod/mxnet/mpi_ops.py:187-214)."""
    _ops.broadcast_async_(tensor.data, root_rank, name=name).wait()
    return tensor
