"""The NDArray protocol of the port's MXNet shim.

The port's counterpart of ``horovod_tpu/mxnet/ndarray.py``. MXNet is not
installed, so the shim is written against the small *NDArray protocol*
the Horovod MXNet API touches: ``asnumpy()``, ``shape``, ``dtype``,
``context``, ``wait_to_read()`` and slice assignment. Where JAX's
stand-in holds a numpy buffer, this one holds a torch tensor on its
``context``: the rank's CUDA device unless the caller passes ``"cpu"``
(as the tests do), so the collectives hand the engine the tensor itself
and the optimizer's arithmetic runs on the card. It is the shim's only
array type: real ``mx.nd.NDArray`` objects are not bridged.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import topology as _topo

# torch dtype -> numpy scalar type (``NDArray.dtype`` is numpy's, as
# MXNet's is); bfloat16 has no numpy type and keeps torch's.
_NP_OF = {torch.bool: np.bool_, torch.uint8: np.uint8, torch.int8: np.int8,
          torch.int16: np.int16, torch.int32: np.int32,
          torch.int64: np.int64, torch.float16: np.float16,
          torch.float32: np.float32, torch.float64: np.float64}


class DeferredInitializationError(RuntimeError):
    """Raised by ``Parameter.data()`` before shape inference — mirrors
    ``mx.gluon.parameter.DeferredInitializationError``."""


def _device(ctx) -> torch.device:
    """The torch device of an MXNet-style context: ``"cpu"``,
    ``"cpu(0)"``, ``"gpu(N)"`` (CUDA card N), a ``torch.device``, or
    None: this process's device once ``init`` ran, else CUDA."""
    if ctx is None:
        if _topo.is_initialized():
            return _topo.device()
        return _topo.resolve_device(None)
    if isinstance(ctx, torch.device):
        return _topo.resolve_device(ctx)
    s = str(ctx)
    if s.startswith("gpu"):
        s = "cuda" + (f":{s[4:-1]}" if s.endswith(")") else "")
    elif s.startswith("cpu"):
        s = "cpu"
    return _topo.resolve_device(s)


def _tensor(data, dtype=None, device=None) -> torch.Tensor:
    if isinstance(data, NDArray):
        data = data._data
    if isinstance(data, torch.Tensor):
        t = data if dtype is None else data.to(_torch_dtype(dtype))
    else:
        t = torch.from_numpy(np.array(data, dtype=dtype))
    return t.to(device) if device is not None else t


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


class NDArray:
    """Torch-backed stand-in for ``mx.nd.NDArray`` (dense).

    Implements the surface the Horovod MXNet API touches; writes through
    ``arr[:] = value`` mutate the underlying tensor, matching MXNet's
    in-place collective semantics.
    """

    __slots__ = ("_data", "context")

    def __init__(self, data, dtype=None, ctx=None):
        dev = _device(ctx if ctx is not None else (
            data.device if isinstance(data, torch.Tensor) else None))
        self._data = _tensor(data, dtype, dev).contiguous()
        self.context = dev

    @classmethod
    def _wrap(cls, tensor: torch.Tensor) -> "NDArray":
        out = cls.__new__(cls)
        out._data = tensor
        out.context = tensor.device
        return out

    # -- protocol ----------------------------------------------------------
    @property
    def data(self) -> torch.Tensor:
        """The tensor itself (no copy)."""
        return self._data

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return _NP_OF.get(self._data.dtype, self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    def asnumpy(self) -> np.ndarray:
        return self._data.detach().cpu().numpy().copy()

    def wait_to_read(self):
        """MXNet's sync point: the shim's ops return finished results, so
        only the card's queue is left to wait on."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    def astype(self, dtype):
        return NDArray._wrap(self._data.to(_torch_dtype(dtype)))

    def copy(self):
        return NDArray._wrap(self._data.clone())

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return NDArray._wrap(self._data.reshape(shape))

    # -- mutation ----------------------------------------------------------
    def __setitem__(self, key, value):
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, torch.Tensor) and not np.isscalar(value):
            value = torch.from_numpy(np.asarray(value))
        self._data[key] = value

    def __getitem__(self, key):
        out = self._data[key]
        if out.dim() == 0:
            return out.item()
        return NDArray._wrap(out)

    # -- arithmetic (what examples/tests use), on the tensor's device ------
    def _coerce(self, other):
        return other._data if isinstance(other, NDArray) else other

    def __add__(self, other):
        return NDArray._wrap(self._data + self._coerce(other))

    def __sub__(self, other):
        return NDArray._wrap(self._data - self._coerce(other))

    def __mul__(self, other):
        return NDArray._wrap(self._data * self._coerce(other))

    __rmul__ = __mul__

    def __truediv__(self, other):
        return NDArray._wrap(self._data / self._coerce(other))

    def __isub__(self, other):
        self._data -= self._coerce(other)
        return self

    def __repr__(self):
        return f"NDArray({self._data!r})"


def zeros(shape, ctx=None, dtype=None):
    """``mx.nd.zeros`` equivalent for output allocation
    (horovod/mxnet/mpi_ops.py:69-70)."""
    return NDArray._wrap(torch.zeros(
        tuple(shape), dtype=_torch_dtype(dtype or np.float32),
        device=_device(ctx)))


def array(data, ctx=None, dtype=None):
    return NDArray(data, dtype=dtype, ctx=ctx)
