"""horovod_tpu_torch.keras — the Keras framework shim of the port.

The counterpart of ``horovod_tpu/keras`` (after Horovod's keras and
_keras packages): a ``DistributedOptimizer`` built as a dynamic subclass
of the wrapped optimizer's class, with its class name (a saved model
restores without the framework), host-value ``allreduce`` /
``allgather`` / ``broadcast``, ``broadcast_variables`` /
``broadcast_global_variables``, and ``load_model``, which re-wraps every
stock optimizer class.

Keras 3 routes every gradient application through ``Optimizer.apply``;
that is the hook. The gradients reach the port's collective engine from
the backend Keras runs on:

- ``torch``: the gradient tensors go straight to the engine, all of a
  step's in one submission that the engine fuses (no bridge module);
- ``tensorflow``: through the port's TF shim (``grouped_allreduce``: one
  ``tf.py_function`` crossing for the group, eager or inside a traced
  ``tf.function``).

The ``jax`` backend is refused: its jitted train step holds JAX values
that only a JAX collective can reduce, and the port has none
(``DistributedOptimizer`` raises a ``RuntimeError`` saying so). Keras's
``numpy`` backend does not train.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

import keras

from .. import ops as _ops
from .. import topology as _topo
from ..compression import Compression
from ..ops import collective as _coll
from ..topology import (init, shutdown, is_initialized, rank, local_rank,
                        size, local_size, mpi_threads_supported)
from . import callbacks

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "local_rank", "size",
    "local_size", "mpi_threads_supported", "Compression",
    "DistributedOptimizer", "broadcast_global_variables",
    "broadcast_variables", "allreduce", "allgather", "broadcast",
    "load_model", "callbacks",
]

_JAX_REFUSED = (
    "horovod_tpu_torch.keras.DistributedOptimizer cannot serve Keras's jax "
    "backend: its jitted train step holds JAX values, which only a JAX "
    "collective (lax.psum in the SPMD program) can reduce, and this "
    "package has none. Use the torch or tensorflow backend "
    "(KERAS_BACKEND), or horovod_tpu.keras under jax.")


def _backend() -> str:
    return keras.backend.backend()


def _check_backend() -> str:
    kb = _backend()
    if kb == "jax":
        raise RuntimeError(_JAX_REFUSED)
    if kb not in ("torch", "tensorflow"):
        raise RuntimeError(f"horovod_tpu_torch.keras serves Keras's torch "
                           f"and tensorflow backends, not {kb!r}")
    return kb


# ---------------------------------------------------------------------------
# Gradient reduction per backend
# ---------------------------------------------------------------------------

def _torch_allreduce_batch(ts, names, compression):
    """Average a list of torch tensors in one engine submission: cast
    compressors cast before and restore after, a blockwise one selects
    the engine's quantized wire. Results return to each input's device."""
    comp = compression if compression is not None else Compression.none
    blockwise = comp if getattr(comp, "wire_spec", None) is not None \
        else None
    dev = _topo.device()
    wires, ctxs = [], []
    for t in ts:
        w, ctx = comp.compress(t.detach())
        wires.append(w.to(dev).contiguous())
        ctxs.append(ctx)
    outs = _coll.fused_allreduce_async(wires, average=True, names=names,
                                       compression=blockwise).wait()
    return [comp.decompress(o, ctx).to(t.device)
            for o, ctx, t in zip(outs, ctxs, ts)]


def _reduce(grads, prefix, compression):
    """Average the non-None backend gradients across ranks, named
    ``{prefix}.grad.{i}``."""
    kb = _check_backend()
    idx = [i for i, g in enumerate(grads) if g is not None]
    names = [f"{prefix}.grad.{i}" for i in range(len(grads))]
    out = list(grads)
    if not idx:
        return out
    if kb == "torch":
        red = _torch_allreduce_batch([grads[i] for i in idx],
                                     [names[i] for i in idx], compression)
    else:
        from .. import tensorflow as _hvd_tf
        red = _hvd_tf.grouped_allreduce(
            [grads[i] for i in idx], average=True,
            name=f"{prefix}.grads", compression=compression)
    for i, r in zip(idx, red):
        out[i] = r
    return out


# ---------------------------------------------------------------------------
# DistributedOptimizer
# ---------------------------------------------------------------------------

class _DistributedOptimizer:
    """Mixin copied onto a dynamic subclass of the wrapped optimizer's
    class so ``isinstance`` checks, LR schedules and model saving keep
    working."""

    _hvd_wrapped = True
    # Class-level defaults: instances deserialized by load_model() never
    # pass through DistributedOptimizer(), which sets instance attrs.
    _hvd_name = None
    _hvd_compression = Compression.none

    def apply(self, grads, trainable_variables=None):
        if not _topo.is_initialized():
            init()
        if _topo.size() > 1:
            prefix = self._hvd_name or f"Distributed{type(self).__name__}"
            grads = _reduce(list(grads), prefix, self._hvd_compression)
        return super(self.__class__, self).apply(grads, trainable_variables)


def _make_wrapped_class(cls):
    ns = {k: v for k, v in _DistributedOptimizer.__dict__.items()
          if k not in ("__dict__", "__weakref__")}
    return type(cls.__name__, (cls,), ns)


def DistributedOptimizer(optimizer, name: Optional[str] = None,
                         compression=Compression.none):
    """Wrap a ``keras.optimizers.Optimizer`` so every gradient is
    allreduce-averaged across ranks before the update rule runs. The
    returned object is an instance of a dynamic subclass with the SAME
    class name, so a model saved with it loads without this package.
    Raises ``RuntimeError`` under Keras's jax backend."""
    _check_backend()
    cls = _make_wrapped_class(optimizer.__class__)
    new = cls.from_config(optimizer.get_config())
    new._hvd_name = name or f"Distributed{optimizer.__class__.__name__}"
    new._hvd_compression = compression
    return new


# ---------------------------------------------------------------------------
# Host-value collectives (horovod/_keras/__init__.py:78-90)
# ---------------------------------------------------------------------------

def _host_tensor(value) -> torch.Tensor:
    """A host value as a tensor on the engine's device. Python scalars
    and lists default to 32-bit, as ``tf.constant`` does in the
    reference's helpers; arrays keep their dtype (64-bit included)."""
    if isinstance(value, torch.Tensor):
        return value.detach().to(_topo.device())
    if isinstance(value, (np.ndarray, np.generic)):
        arr = np.asarray(value)
    else:
        arr = np.asarray(keras.ops.convert_to_numpy(value)
                         if hasattr(value, "shape") else value)
        if isinstance(value, (int, float, list, tuple)):
            if arr.dtype == np.float64:
                arr = arr.astype(np.float32)
            elif arr.dtype == np.int64:
                arr = arr.astype(np.int32)
    return torch.from_numpy(np.array(arr)).to(_topo.device())


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def allreduce(value, name: Optional[str] = None, average: bool = True):
    """Allreduce a host value (scalar / array); returns numpy."""
    return _host(_ops.allreduce_async(_host_tensor(value), average=average,
                                      name=name).wait())


def allgather(value, name: Optional[str] = None):
    t = _host_tensor(value)
    return _host(_ops.allgather_async(t.reshape(-1) if t.dim() == 0 else t,
                                      name=name).wait())


def broadcast(value, root_rank: int = 0, name: Optional[str] = None):
    return _host(_ops.broadcast_async(_host_tensor(value), root_rank,
                                      name=name).wait())


# ---------------------------------------------------------------------------
# Variable broadcast + model loading
# ---------------------------------------------------------------------------

def broadcast_variables(variables, root_rank: int = 0) -> None:
    """Broadcast ``keras.Variable``s from ``root_rank`` in place — the
    rank-0 state sync at (re)start: every broadcast submitted, then
    every result assigned."""
    variables = list(variables)
    handles = [_ops.broadcast_async(
        torch.from_numpy(np.array(keras.ops.convert_to_numpy(v))).to(
            _topo.device()), root_rank,
        name=f"keras.bcast.{i}.{getattr(v, 'path', i)}")
        for i, v in enumerate(variables)]
    for v, out in zip(variables, _ops.synchronize_many(handles)):
        v.assign(_host(out))


def broadcast_global_variables(root_rank: int = 0, model=None) -> None:
    """Broadcast all of a model's variables (weights + optimizer slots).
    Keras 3 has no global-variables collection; pass the model (the
    callback does this automatically)."""
    if model is None:
        raise ValueError(
            "Keras 3 has no global variable collection; pass model= or "
            "use callbacks.BroadcastGlobalVariablesCallback")
    broadcast_variables(model.variables, root_rank)
    if getattr(model, "optimizer", None) is not None:
        broadcast_variables(model.optimizer.variables, root_rank)


def load_model(filepath, custom_optimizers=None, custom_objects=None,
               compile=True):
    """Load a model, re-wrapping every stock optimizer class in
    ``DistributedOptimizer`` so restored training resumes distributed
    (horovod/_keras/__init__.py:93-109)."""
    import inspect

    horovod_objects = {}
    for attr in dir(keras.optimizers):
        obj = getattr(keras.optimizers, attr)
        if (inspect.isclass(obj)
                and issubclass(obj, keras.optimizers.Optimizer)
                and obj is not keras.optimizers.Optimizer):
            wrapped = _make_wrapped_class(obj)
            horovod_objects[obj.__name__] = wrapped
            horovod_objects[obj.__name__.lower()] = wrapped
    if custom_optimizers is not None:
        horovod_objects.update(
            {cls.__name__: _make_wrapped_class(cls)
             for cls in custom_optimizers})
    if custom_objects is not None:
        horovod_objects.update(custom_objects)
    return keras.models.load_model(filepath, custom_objects=horovod_objects,
                                   compile=compile)
