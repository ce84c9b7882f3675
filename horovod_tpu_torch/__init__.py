"""horovod_tpu_torch — the PyTorch/CUDA port of horovod_tpu.

The same public names as ``horovod_tpu`` for the part ported so far:
topology and meshes over ``torch.distributed`` (NCCL on CUDA, gloo on
the CPU), eager collectives through a negotiated engine with tensor
fusion, cast and block-quantized compression, the hook-fired bucketed
``DistributedOptimizer`` and the broadcasts, the data-parallel train
steps of the flagship transformer, whose attention runs on hand-written
CUDA flash kernels for Hopper, and of ResNet-50, whose batch norms run
on hand-written CUDA kernels, and the transformer's tensor- and
sequence-parallel train step over a mesh (``parallel/``: Megatron tp,
ring and Ulysses attention), and the conv zoo (``models``: VGG,
Inception V3, the MNIST net, word2vec; ResNet with distributed batch
norm) fed by the input pipeline (``data``: sources, the sharded loader,
prefetch to the card), and checkpoint and elastic state
(``checkpoint``: the sharded engine on the JAX package's format;
``elastic``: ``ElasticState``, ``WorkerFailure`` and the elastic driver
``run_elastic``), the launcher (``runner``: ``run``, ``launch`` and
``python -m horovod_tpu_torch.runner``), and serving
(``serving``: the continuous-batching engine over a paged KV pool, its
HTTP server and ``python -m horovod_tpu_torch.serving``), and the
telemetry and adaptation planes: the engine's, the optimizer's and the
loaders' metric families in ``metrics_registry()`` (``metrics_snapshot()``,
``prometheus_text``), per-step telemetry with MFU and device memory
(``StepMetrics``), and rank 0's adaptation policy
(``HOROVOD_TPU_ADAPTATION=1``, ``adaptation``); the offline tools over
their files (``python -m horovod_tpu_torch.tools.<name>``: postmortem,
trace, health, slo) and the framework shims over the engine
(``horovod_tpu_torch.mxnet``, ``.tensorflow``, ``.keras``, each imported
on its own: this package imports neither keras nor tensorflow).

    import torch, horovod_tpu_torch as hvd
    hvd.init()                                   # CUDA; device="cpu" for gloo
    model = ...                                  # an nn.Module on hvd.device()
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(model.parameters()),
                                   named_parameters=model.named_parameters())

This package imports neither ``jax`` nor ``horovod_tpu``.
"""

from .topology import (NotInitializedError, device, generation,
                       hierarchical_mesh, init, is_initialized, local_rank,
                       local_size, mesh, mpi_threads_supported,
                       process_count, process_rank, rank, shutdown, size)
from .topology import topology as get_topology
from .ops import (Handle, HorovodInternalError, allgather, allgather_async,
                  allreduce, allreduce_, allreduce_async, allreduce_async_,
                  broadcast, broadcast_, broadcast_async, broadcast_async_,
                  grouped_allreduce, poll, synchronize, synchronize_many)
from .compression import Compression
from .optimizer import (DistributedOptimizer, allreduce_gradients,
                        broadcast_object, broadcast_optimizer_state,
                        broadcast_parameters)
from .checkpoint import CheckpointEngine, CorruptShardError, checkpoint_hook
from .elastic import (ElasticState, SlowRankFailure, WorkerFailure,
                      run_elastic)
from .utils.checkpoint import restore_checkpoint, save_checkpoint
from .observability import get_registry, metrics_snapshot, prometheus_text
from .observability.step_metrics import StepMetrics


def metrics_registry():
    """The process-global metrics registry, for registering an
    application's counters beside the framework's."""
    return get_registry()


__version__ = "0.1.0"

__all__ = [
    "__version__",
    "init", "shutdown", "is_initialized", "rank", "local_rank", "size",
    "local_size", "process_rank", "process_count", "device", "get_topology",
    "mesh", "hierarchical_mesh", "mpi_threads_supported",
    "NotInitializedError",
    "allreduce", "allreduce_", "allreduce_async", "allreduce_async_",
    "allgather", "allgather_async", "broadcast", "broadcast_",
    "broadcast_async", "broadcast_async_", "grouped_allreduce", "poll",
    "synchronize", "synchronize_many", "Handle", "HorovodInternalError",
    "Compression", "DistributedOptimizer", "broadcast_parameters",
    "broadcast_optimizer_state", "broadcast_object", "allreduce_gradients",
    "generation", "CheckpointEngine", "CorruptShardError", "checkpoint_hook",
    "save_checkpoint", "restore_checkpoint", "ElasticState",
    "WorkerFailure", "SlowRankFailure", "run_elastic", "metrics_snapshot",
    "metrics_registry", "prometheus_text", "StepMetrics",
]
