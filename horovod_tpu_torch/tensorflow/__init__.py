"""horovod_tpu_torch.tensorflow — the TensorFlow framework shim of the port.

The counterpart of ``horovod_tpu/tensorflow`` (after Horovod's
tensorflow/__init__.py and mpi_ops.py): differentiable ``allreduce`` /
``grouped_allreduce`` / ``allgather`` / ``broadcast`` on ``tf.Tensor``s
with the reference's registered gradients, ``DistributedOptimizer`` (the
v1 ``compute_gradients`` wrapper and the Keras-style ``apply_gradients``
one), ``DistributedGradientTape``, ``broadcast_variables``,
``BroadcastGlobalVariablesHook`` (graph mode),
``BroadcastGlobalVariablesCallback`` and ``StepMetrics``.

Where the reference registers an ``AsyncOpKernel`` that enqueues into
its coordinator, this shim crosses into the port's collective engine
with ``tf.py_function`` (eager and inside a traced ``tf.function``): the
host bridge turns the TF tensor into a torch tensor by DLPack where TF
exports one (numpy otherwise), moves it to the engine's device (the card
under NCCL) and brings the result back the same way. A group of tensors
is one crossing: the bridge submits every tensor and then waits on all
of them, and the engine's cycle fuses them. TF stays the autograd
engine. 64-bit values are carried exactly (the JAX shim narrows them to
32 bits unless ``jax_enable_x64``).

Gradient registrations, as reference Horovod's:
- grad(allreduce(x))  = allreduce(grad)
- grad(allgather(x))  = this rank's slice of the summed gathered grad
- grad(broadcast(x))  = allreduce(grad), zeroed on non-root ranks
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import tensorflow as tf
import torch

from .. import ops as _ops
from .. import topology as _topo
from ..compression import Compression
from ..observability.step_metrics import StepTimer as _StepTimer
from ..topology import (init, shutdown, is_initialized, rank, local_rank,
                        size, local_size, mpi_threads_supported)

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "local_rank", "size",
    "local_size", "mpi_threads_supported", "Compression",
    "allreduce", "grouped_allreduce", "allgather", "broadcast",
    "broadcast_variables", "broadcast_global_variables",
    "DistributedOptimizer", "DistributedGradientTape",
    "BroadcastGlobalVariablesCallback", "BroadcastGlobalVariablesHook",
    "StepMetrics",
]


class StepMetrics(_StepTimer):
    """Per-step telemetry for TF training loops (docs/metrics.md), the
    port's ``StepTimer`` labeled ``framework=tensorflow``. Use as a
    context manager around each train step; the collective share comes
    from the engine's execute seconds, so it covers the collectives of
    DistributedGradientTape/Optimizer."""

    def __init__(self, batch_size: Optional[int] = None,
                 flops_per_step: Optional[float] = None, device=None):
        super().__init__("tensorflow", batch_size=batch_size,
                         flops_per_step=flops_per_step, device=device)


# Host-bridge crossings that carried a GROUP of tensors: a tape with 50
# gradients costs one, not 50.
_bridge_calls = [0]

# What crosses by its bits when DLPack is refused: TF dtype -> (numpy
# and torch integer dtypes of its bits, torch dtype). TF's own numpy
# dtype for it (``as_numpy_dtype``) reads the bits back.
_BITS = {tf.bfloat16: (np.int16, torch.int16, torch.bfloat16)}
# The alignment TF's CPU kernels assume of a tensor's buffer
# (EIGEN_MAX_ALIGN_BYTES); torch allocates at this alignment too.
_TF_ALIGN = 64
_F8 = getattr(tf.dtypes.experimental, "float8_e4m3fn", None)
if _F8 is not None:
    _BITS[_F8] = (np.uint8, torch.uint8, torch.float8_e4m3fn)


# ---------------------------------------------------------------------------
# Host bridge — the AsyncOpKernel analogue
# ---------------------------------------------------------------------------

def _to_torch(x: tf.Tensor) -> torch.Tensor:
    """An eager TF tensor as a torch tensor on the engine's device."""
    try:
        t = torch.utils.dlpack.from_dlpack(tf.experimental.dlpack.to_dlpack(x))
    except Exception:
        arr = np.array(x.numpy())
        bits = _BITS.get(x.dtype)
        t = (torch.from_numpy(arr) if bits is None
             else torch.from_numpy(arr.view(bits[0])).view(bits[2]))
    return t.to(_topo.device())


def _to_tf(t: torch.Tensor, dtype) -> tf.Tensor:
    """A result as a TF tensor of ``dtype`` (py_function does not cast
    eager returns to ``Tout``)."""
    t = t.detach().cpu().contiguous()
    if t.data_ptr() % _TF_ALIGN:
        # A view into a fused buffer: TF's kernels assume their inputs'
        # alignment and abort on an imported buffer that lacks it.
        t = t.clone()
    try:
        out = tf.experimental.dlpack.from_dlpack(
            torch.utils.dlpack.to_dlpack(t))
    except Exception:
        bits = _BITS.get(dtype)
        out = tf.convert_to_tensor(
            t.view(bits[1]).numpy().view(dtype.as_numpy_dtype)
            if bits is not None and t.dtype == bits[2] else t.numpy())
    return out if out.dtype == dtype else tf.cast(out, dtype)


def _py_collective(host_fn, inputs: tf.Tensor, out_dtype, out_shape):
    out = tf.py_function(host_fn, [inputs], Tout=out_dtype)
    if out_shape is not None:
        out.set_shape(out_shape)
    return out


def _grouped_bridge(submit_async, tensors):
    """ONE py_function crossing for a whole tensor group: submit every
    tensor to the engine, wait on all the handles, return the outputs
    with their shapes. ``submit_async(i, tensor)`` returns an engine
    Handle. Shared by grouped_allreduce and the broadcast hook."""

    def host(*vs):
        _bridge_calls[0] += 1
        handles = [submit_async(i, _to_torch(v)) for i, v in enumerate(vs)]
        outs = _ops.synchronize_many(handles)
        return [_to_tf(o, v.dtype) for o, v in zip(outs, vs)]

    outs = tf.py_function(host, list(tensors),
                          Tout=[t.dtype.base_dtype for t in tensors])
    if len(tensors) == 1 and not isinstance(outs, (list, tuple)):
        outs = [outs]
    for t, o in zip(tensors, outs):
        o.set_shape(t.shape)
    return list(outs)


def _blockwise(compression):
    """``compression`` when it selects a blockwise wire (the engine
    quantizes on the wire), else None."""
    return (compression if getattr(compression, "wire_spec", None)
            is not None else None)


def _wire_tf_dtype(compression):
    """tf.DType the compression transmits on the wire, or None for
    pass-through. A blockwise format has none (it travels by spec); a
    custom compressor that is not Compression.none but declares no
    wire_dtype keeps the fp16 wire."""
    if _blockwise(compression) is not None:
        return None
    wire = getattr(compression, "wire_dtype", None)
    if wire is None:
        if compression is not Compression.none:
            return tf.float16
        return None
    return tf.as_dtype(str(wire).replace("torch.", ""))


_name_counter = [0]


def _auto_name(prefix: str, name: Optional[str]) -> str:
    if name:
        return name
    _name_counter[0] += 1
    return f"tf.{prefix}.{_name_counter[0]}"


# ---------------------------------------------------------------------------
# Differentiable collectives
# ---------------------------------------------------------------------------

def allreduce(tensor, average: bool = True, name: Optional[str] = None,
              compression=Compression.none):
    """Differentiable allreduce. ``tf.IndexedSlices`` inputs are handled
    as allgather(values)+allgather(indices) — the sparse data-parallel
    path (horovod/tensorflow/__init__.py:72-83)."""
    if isinstance(tensor, tf.IndexedSlices):
        values = allgather(tensor.values, name=_auto_name("ar.sv", name))
        indices = allgather(tensor.indices, name=_auto_name("ar.si", name))
        if average:
            values = values / float(_topo.size())
        return tf.IndexedSlices(values, indices,
                                dense_shape=tensor.dense_shape)

    nm = _auto_name("allreduce", name)

    @tf.custom_gradient
    def _op(x):
        wire, ctx = x, None
        wire_dt = _wire_tf_dtype(compression)
        if wire_dt is not None and x.dtype.is_floating:
            wire, ctx = tf.cast(x, wire_dt), x.dtype
        blockwise = _blockwise(compression)

        def host(v):
            out = _ops.allreduce_async(_to_torch(v), average=average,
                                       name=nm, compression=blockwise)
            return _to_tf(out.wait(), v.dtype)

        out = _py_collective(host, wire, wire.dtype, wire.shape)
        if ctx is not None:
            out = tf.cast(out, ctx)

        def grad(dy):
            return allreduce(dy, average=average,
                             name=_auto_name("allreduce", None),
                             compression=compression)

        return out, grad

    return _op(tf.convert_to_tensor(tensor))


def grouped_allreduce(tensors, average: bool = True,
                      name: Optional[str] = None,
                      compression=Compression.none):
    """Allreduce a LIST of tensors through ONE host bridge.

    The reference's AsyncOpKernels all enqueue into the coordinator and
    its cycle fuses them; a ``tf.py_function`` per tensor would pay one
    host round trip per gradient. One crossing submits the whole group
    and waits on it; the engine fuses it into as few collectives as the
    fusion threshold allows. Differentiable: the gradient is a grouped
    allreduce of the incoming gradients.
    """
    tensors = [tf.convert_to_tensor(t) for t in tensors]
    if not tensors:
        return []
    nm = _auto_name("grouped", name)

    @tf.custom_gradient
    def _op(*xs):
        wires, ctxs = [], []
        wire_dt = _wire_tf_dtype(compression)
        for x in xs:
            if wire_dt is not None and x.dtype.is_floating:
                wires.append(tf.cast(x, wire_dt))
                ctxs.append(x.dtype)
            else:
                wires.append(x)
                ctxs.append(None)
        blockwise = _blockwise(compression)
        outs = _grouped_bridge(
            lambda i, t: _ops.allreduce_async(t, average=average,
                                              name=f"{nm}.{i}",
                                              compression=blockwise),
            wires)
        res = [tf.cast(o, ctx) if ctx is not None else o
               for o, ctx in zip(outs, ctxs)]

        def grad(*dys):
            return grouped_allreduce(
                list(dys), average=average,
                name=_auto_name("grouped", None), compression=compression)

        return res, grad

    out = _op(*tensors)
    return list(out) if isinstance(out, (list, tuple)) else [out]


def allgather(tensor, name: Optional[str] = None):
    """Differentiable allgather along dim 0. Backward: sum-allreduce the
    gathered gradient, slice this rank's segment."""
    nm = _auto_name("allgather", name)

    @tf.custom_gradient
    def _op(x):
        dim0 = x.shape[0]

        def host(v):
            return _to_tf(_ops.allgather_async(_to_torch(v), name=nm).wait(),
                          v.dtype)

        out_shape = tf.TensorShape(
            [None if dim0 is None else dim0 * _topo.size()]
            + list(x.shape[1:]))
        out = _py_collective(host, x, x.dtype, out_shape)

        def grad(dy):
            summed = allreduce(dy, average=False,
                               name=_auto_name("allgather.grad", None))
            r = _topo.rank()
            n = tf.shape(summed)[0] // _topo.size()
            return summed[r * n:(r + 1) * n]

        return out, grad

    return _op(tf.convert_to_tensor(tensor))


def broadcast(tensor, root_rank: int = 0, name: Optional[str] = None):
    """Differentiable broadcast. Backward: allreduce the gradient;
    non-root ranks contribute zeros."""
    nm = _auto_name("broadcast", name)

    @tf.custom_gradient
    def _op(x):
        def host(v):
            return _to_tf(_ops.broadcast_async(_to_torch(v), root_rank,
                                               name=nm).wait(), v.dtype)

        out = _py_collective(host, x, x.dtype, x.shape)

        def grad(dy):
            g = allreduce(dy, average=False,
                          name=_auto_name("broadcast.grad", None))
            if _topo.rank() != root_rank:
                g = tf.zeros_like(g)
            return g

        return out, grad

    return _op(tf.convert_to_tensor(tensor))


# ---------------------------------------------------------------------------
# Variable sync
# ---------------------------------------------------------------------------

def broadcast_variables(variables, root_rank: int = 0) -> None:
    """Assign every variable the root rank's value
    (horovod/tensorflow/__init__.py:95-114): every broadcast submitted,
    then every result assigned."""
    variables = list(variables)
    handles = [_ops.broadcast_async(_to_torch(tf.convert_to_tensor(v)),
                                    root_rank, name=f"tf.bcast.{i}.{v.name}")
               for i, v in enumerate(variables)]
    for v, out in zip(variables, _ops.synchronize_many(handles)):
        v.assign(_to_tf(out, v.dtype))


def broadcast_global_variables(root_rank: int = 0, variables=None) -> None:
    """TF2 has no global-variables collection; pass the variables (e.g.
    ``model.variables``) explicitly."""
    if variables is None:
        raise ValueError(
            "TF2 has no global variable collection; pass variables= "
            "(e.g. model.variables + optimizer.variables)")
    broadcast_variables(variables, root_rank)


try:  # SessionRunHook base: v1 compat surface (removed in some builds)
    _SessionRunHook = tf.compat.v1.train.SessionRunHook
except AttributeError:  # pragma: no cover - minimal TF builds
    _SessionRunHook = object


class BroadcastGlobalVariablesHook(_SessionRunHook):
    """SessionRunHook that broadcasts all global variables from
    ``root_rank`` once the session is created — the reference's
    estimator/MonitoredTrainingSession integration.

    Graph mode: ``begin()`` builds one grouped assign op over
    ``tf.compat.v1.global_variables()``; ``after_create_session()`` runs
    it. Eager code uses :class:`BroadcastGlobalVariablesCallback`.
    """

    def __init__(self, root_rank: int = 0, device: str = ""):
        self.root_rank = root_rank
        self.device = device  # accepted for API parity; the engine places
        self.bcast_op = None

    def begin(self):
        gvars = tf.compat.v1.global_variables()
        if not gvars:
            self.bcast_op = tf.no_op()
            return
        # ONE bridged group for all variables (like grouped_allreduce).
        nm = _auto_name("hook.bcast", None)
        root = self.root_rank
        outs = _grouped_bridge(
            lambda i, t: _ops.broadcast_async(t, root, name=f"{nm}.{i}"),
            list(gvars))
        self.bcast_op = tf.group(*[
            tf.compat.v1.assign(v, o) for v, o in zip(gvars, outs)])

    def after_create_session(self, session, coord):
        if self.bcast_op is not None:
            session.run(self.bcast_op)


class BroadcastGlobalVariablesCallback:
    """Callable hook: invoke once after the first step (when optimizer
    slots exist) to sync all state from ``root_rank`` — the TF2 analogue
    of the reference's SessionRunHook."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank
        self._done = False

    def __call__(self, model=None, optimizer=None) -> None:
        if self._done:
            return
        vs = []
        if model is not None:
            vs += list(model.variables)
        if optimizer is not None:
            vs += list(optimizer.variables)
        broadcast_variables(vs, self.root_rank)
        self._done = True


# ---------------------------------------------------------------------------
# DistributedOptimizer / DistributedGradientTape
# ---------------------------------------------------------------------------

def _reduce_grad_list(grads, prefix: str, compression,
                      sparse_as_dense: bool):
    """Average a list of gradients: dense ones in ONE bridged group
    (engine-fused), IndexedSlices through the sparse allgather path."""
    grads = list(grads)
    if sparse_as_dense:
        grads = [tf.convert_to_tensor(g)
                 if isinstance(g, tf.IndexedSlices) else g for g in grads]
    dense_idx = [i for i, g in enumerate(grads)
                 if g is not None and not isinstance(g, tf.IndexedSlices)]
    reduced = grouped_allreduce([grads[i] for i in dense_idx],
                                average=True, name=f"{prefix}.grads",
                                compression=compression)
    for i, rg in zip(dense_idx, reduced):
        grads[i] = rg
    for i, g in enumerate(grads):
        if isinstance(g, tf.IndexedSlices):
            grads[i] = allreduce(g, average=True, name=f"{prefix}.grad.{i}",
                                 compression=compression)
    return grads


def _make_v1_distributed_optimizer(optimizer, name, compression,
                                   sparse_as_dense):
    """The reference's shape: a ``tf.compat.v1.train.Optimizer`` subclass
    delegating to the wrapped optimizer, with ``compute_gradients``
    allreduce-averaging every gradient."""
    v1 = tf.compat.v1.train

    class _DistributedOptimizerV1(v1.Optimizer):
        def __init__(self):
            self._optimizer = optimizer
            self._hvd_prefix = (name or
                                f"Distributed{type(optimizer).__name__}")
            super().__init__(name=self._hvd_prefix, use_locking=False)

        def compute_gradients(self, *args, **kwargs):
            gvs = self._optimizer.compute_gradients(*args, **kwargs)
            grads = _reduce_grad_list([g for g, _ in gvs],
                                      self._hvd_prefix, compression,
                                      sparse_as_dense)
            return [(g, v) for g, (_, v) in zip(grads, gvs)]

        def apply_gradients(self, *args, **kwargs):
            return self._optimizer.apply_gradients(*args, **kwargs)

        def get_slot(self, *args, **kwargs):
            return self._optimizer.get_slot(*args, **kwargs)

        def get_slot_names(self, *args, **kwargs):
            return self._optimizer.get_slot_names(*args, **kwargs)

        def variables(self, *args, **kwargs):
            return self._optimizer.variables(*args, **kwargs)

    return _DistributedOptimizerV1()


def DistributedOptimizer(optimizer, name: Optional[str] = None,
                         compression=Compression.none,
                         sparse_as_dense: bool = False):
    """Wrap an optimizer so gradients are allreduce-averaged before the
    update. A ``tf.compat.v1.train.Optimizer`` gets the reference's
    delegation wrapper overriding ``compute_gradients`` (graph /
    MonitoredSession loops); a Keras-style optimizer gets a dynamic
    subclass whose ``apply_gradients`` reduces first."""
    try:
        if isinstance(optimizer, tf.compat.v1.train.Optimizer):
            return _make_v1_distributed_optimizer(
                optimizer, name, compression, sparse_as_dense)
    except AttributeError:  # pragma: no cover - minimal TF builds
        pass
    prefix = name or f"Distributed{optimizer.__class__.__name__}"

    class _Wrapped(optimizer.__class__):
        _hvd_wrapped = True

        def apply_gradients(self, grads_and_vars, *args, **kwargs):
            gv = list(grads_and_vars)
            reduced = _reduce_grad_list([g for g, _ in gv], prefix,
                                        compression, sparse_as_dense)
            return super().apply_gradients(
                [(g, v) for g, (_, v) in zip(reduced, gv)],
                *args, **kwargs)

    return _Wrapped.from_config(optimizer.get_config())


class DistributedGradientTape(tf.GradientTape):
    """``tf.GradientTape`` whose ``gradient()`` returns allreduce-averaged
    gradients (horovod/tensorflow/__init__.py:252-326)."""

    def __init__(self, *args, compression=Compression.none,
                 sparse_as_dense: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self._hvd_compression = compression
        self._hvd_sparse_as_dense = sparse_as_dense

    def gradient(self, target, sources, *args, **kwargs):
        grads = super().gradient(target, sources, *args, **kwargs)
        # One bridged group for all dense gradients (the reference's
        # fused AsyncOpKernel behavior); sparse stays per-tensor.
        flat = _reduce_grad_list(
            tf.nest.flatten(grads), _auto_name("tape", None),
            self._hvd_compression, self._hvd_sparse_as_dense)
        return tf.nest.pack_sequence_as(grads, flat)
