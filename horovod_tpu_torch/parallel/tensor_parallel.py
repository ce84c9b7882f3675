"""Tensor parallelism: Megatron-style column- and row-parallel layers.

Counterpart of ``horovod_tpu/parallel/tensor_parallel.py``. The pairing
keeps activations local between the two halves of a block:

    ColumnParallelDense: Y_k = X @ W_k          (W split on its output
                                                 dim; no communication)
    RowParallelDense:    Y = psum_k(X_k @ W_k)  (W split on its input
                                                 dim; one psum out)

so an MLP (column, activation, row) costs one psum over the axis. Each
rank holds its own slice of the weights (``kernel`` ``[in, out]`` in
the JAX ``x @ W`` layout, fp32, cast to ``dtype`` at use; ``bias``
zeros). The kernel's initial values are ``lecun_normal`` (a normal
truncated at two standard deviations, variance 1 / fan_in of the
rank's kernel) drawn from ``generator``, as flax's initializer is.
The flagship transformer inlines the same split (``models/
transformer.py``); these are the library's public layers.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from .collectives import axis_size, psum

# flax's truncated_normal variance scaling divides by the standard
# deviation of a unit normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def lecun_normal(shape, generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32)
    std = (1.0 / shape[0]) ** 0.5 / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


class _Dense(nn.Module):

    def __init__(self, in_features: int, out_features: int, use_bias: bool,
                 dtype, generator):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(lecun_normal((in_features, out_features),
                                                generator))
        self.bias = (nn.Parameter(torch.zeros(out_features)) if use_bias
                     else None)

    def _product(self, x):
        return x.to(self.dtype) @ self.kernel.to(self.dtype)


class ColumnParallelDense(_Dense):
    """Dense with its ``features`` output columns split over ``axis``:
    this rank holds ``features / axis size`` of them."""

    def __init__(self, in_features: int, features: int, mesh: DeviceMesh,
                 axis: str = "tp", use_bias: bool = True,
                 dtype=torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        n = axis_size(mesh, axis)
        if features % n:
            raise ValueError(f"features {features} not divisible by "
                             f"{axis} size {n}")
        super().__init__(in_features, features // n, use_bias, dtype,
                         generator)

    def forward(self, x):
        y = self._product(x)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class RowParallelDense(_Dense):
    """Dense whose input is this rank's slice of the hidden
    (``local_in`` features, from a :class:`ColumnParallelDense`); the
    output, ``features`` wide, is summed over ``axis``."""

    def __init__(self, local_in: int, features: int, mesh: DeviceMesh,
                 axis: str = "tp", use_bias: bool = True,
                 dtype=torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__(local_in, features, use_bias, dtype, generator)
        self.mesh, self.axis = mesh, axis

    def forward(self, x):
        # The block's one communication.
        y = psum(self._product(x), self.mesh, self.axis)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


def _gelu(x):
    return F.gelu(x, approximate="tanh")


class ParallelMLP(nn.Module):
    """Column, activation, row: one psum per MLP (Megatron fig. 3).
    ``hidden`` is the global intermediate width, ``features`` the model
    width; the activation defaults to flax's ``nn.gelu`` (tanh)."""

    def __init__(self, hidden: int, features: int, mesh: DeviceMesh,
                 axis: str = "tp", act: Callable = _gelu,
                 dtype=torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = act
        self.wi = ColumnParallelDense(features, hidden, mesh, axis,
                                      dtype=dtype, generator=generator)
        self.wo = RowParallelDense(hidden // axis_size(mesh, axis),
                                   features, mesh, axis, dtype=dtype,
                                   generator=generator)

    def forward(self, x):
        return self.wo(self.act(self.wi(x)))
