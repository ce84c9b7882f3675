"""horovod_tpu_torch.mxnet — the MXNet framework shim of the port.

The counterpart of ``horovod_tpu/mxnet`` (after Horovod's
mxnet/__init__.py): a ``DistributedOptimizer`` that allreduces gradients
inside ``update()`` / ``update_multi_precision()`` before delegating to
the wrapped optimizer, and ``broadcast_parameters`` for dicts and gluon
``ParameterDict``s with the deferred-initialization skip.

It works on the torch-backed NDArray protocol in :mod:`.ndarray`, whose
tensors live on the rank's card; real ``mx.nd.NDArray`` objects are not
accepted (the collectives hand the engine ``NDArray.data``, a torch
tensor). The wrapped optimizer only needs the
``mx.optimizer.Optimizer`` method surface the reference touches.
"""

from __future__ import annotations

from .mpi_ops import (init, shutdown, is_initialized, rank, local_rank,
                      size, local_size, mpi_threads_supported,
                      allreduce, allreduce_, allreduce_multi_, allgather,
                      broadcast, broadcast_)
from . import ndarray as nd
from .ndarray import NDArray, DeferredInitializationError

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "local_rank", "size",
    "local_size", "mpi_threads_supported",
    "allreduce", "allreduce_", "allreduce_multi_", "allgather",
    "broadcast", "broadcast_",
    "DistributedOptimizer", "broadcast_parameters", "nd", "NDArray",
    "DeferredInitializationError",
]


class DistributedOptimizer:
    """Wraps an MXNet-style optimizer: every ``update`` first averages the
    gradient(s) over all processes (horovod/mxnet/__init__.py:36-59).

    The index-list form submits all allreduces before waiting, so the
    engine fuses them.
    """

    def __init__(self, optimizer):
        self._optimizer = optimizer

    def __getattr__(self, item):
        return getattr(self._optimizer, item)

    def create_state(self, index, weight):
        return self._optimizer.create_state(index, weight)

    def create_state_multi_precision(self, index, weight):
        return self._optimizer.create_state_multi_precision(index, weight)

    def _do_allreduce(self, index, grad):
        if isinstance(index, (tuple, list)):
            from ..ops import collective as _coll
            _coll.fused_allreduce_async_(
                [g.data for g in grad], average=True,
                names=[str(i) for i in index]).wait()
        else:
            allreduce_(grad, average=True, name=str(index))

    def update(self, index, weight, grad, state):
        self._do_allreduce(index, grad)
        self._optimizer.update(index, weight, grad, state)

    def update_multi_precision(self, index, weight, grad, state):
        self._do_allreduce(index, grad)
        self._optimizer.update_multi_precision(index, weight, grad, state)

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def set_lr_mult(self, args_lr_mult):
        self._optimizer.set_lr_mult(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self._optimizer.set_wd_mult(args_wd_mult)


def _is_parameter_dict(params) -> bool:
    """True for gluon ``ParameterDict``-likes: items() yields Parameters
    exposing ``.data()`` (horovod/mxnet/__init__.py:87-93)."""
    try:
        items = list(params.items())
    except AttributeError:
        return False
    return bool(items) and all(hasattr(p, "data") and callable(p.data)
                               for _, p in items)


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Broadcast parameters from ``root_rank`` in place. Accepts a dict of
    NDArrays (``Module.get_params()``) or a ParameterDict
    (``Block.collect_params()``); deferred-init parameters are skipped
    (horovod/mxnet/__init__.py:71-104)."""
    if isinstance(params, dict):
        tensors = [p for _, p in sorted(params.items())]
    elif _is_parameter_dict(params):
        tensors = []
        for _, p in sorted(params.items()):
            try:
                tensors.append(p.data())
            except Exception as e:  # DeferredInitializationError duck-match
                if type(e).__name__ != "DeferredInitializationError":
                    raise
    else:
        raise ValueError("invalid params of type: %s" % type(params))

    from .. import ops as _ops
    handles = [_ops.broadcast_async_(t.data, root_rank, name=str(i))
               for i, t in enumerate(tensors)]
    _ops.synchronize_many(handles)
    for tensor in tensors:
        tensor.wait_to_read()
