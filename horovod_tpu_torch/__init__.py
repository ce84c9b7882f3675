"""horovod_tpu_torch — the PyTorch/CUDA port of horovod_tpu.

The same public names as ``horovod_tpu`` for the part ported so far:
topology and meshes over ``torch.distributed`` (NCCL on CUDA, gloo on
the CPU), eager collectives through a negotiated engine with tensor
fusion, cast compression, ``DistributedOptimizer`` and the
broadcasts, and the flagship transformer's data-parallel train step,
whose attention runs on hand-written CUDA flash kernels for Hopper.

    import torch, horovod_tpu_torch as hvd
    hvd.init()                                   # CUDA; device="cpu" for gloo
    model = ...                                  # an nn.Module on hvd.device()
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(model.parameters()),
                                   named_parameters=model.named_parameters())

This package imports neither ``jax`` nor ``horovod_tpu``.
"""

from .topology import (NotInitializedError, device, hierarchical_mesh, init,
                       is_initialized, local_rank, local_size, mesh,
                       process_count, process_rank, rank, shutdown, size)
from .topology import topology as get_topology
from .ops import (Handle, HorovodInternalError, allgather, allgather_async,
                  allreduce, allreduce_async, broadcast, broadcast_async,
                  grouped_allreduce, poll, synchronize)
from .compression import Compression
from .optimizer import (DistributedOptimizer, allreduce_gradients,
                        broadcast_object, broadcast_optimizer_state,
                        broadcast_parameters)

__version__ = "0.1.0"

__all__ = [
    "__version__",
    "init", "shutdown", "is_initialized", "rank", "local_rank", "size",
    "local_size", "process_rank", "process_count", "device", "get_topology",
    "mesh", "hierarchical_mesh",
    "NotInitializedError",
    "allreduce", "allreduce_async", "allgather", "allgather_async",
    "broadcast", "broadcast_async", "grouped_allreduce", "poll",
    "synchronize", "Handle", "HorovodInternalError",
    "Compression", "DistributedOptimizer", "broadcast_parameters",
    "broadcast_optimizer_state", "broadcast_object", "allreduce_gradients",
]
