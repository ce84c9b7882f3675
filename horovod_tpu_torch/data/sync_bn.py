"""Distributed (cross-replica) batch normalization.

Counterpart of ``horovod_tpu/data/sync_bn.py``. :func:`sync_batch_norm`
computes the batch moments over the whole axis with one collective: the
local sum and sum of squares (fp32, ``[C]`` each) are concatenated into
one ``[2C]`` buffer and summed over the axis's process group by
``parallel.collectives.psum``, whose backward is the psum of the
cotangents, as JAX's transpose of ``lax.psum``. The count is static
(the local element count per channel times the axis size), so nothing
else crosses the wire.

The arithmetic is JAX's: ``var = s2 / n - mean^2`` with no clamp (the
port's local ``BatchNorm`` clamps at 0, as flax's ``nn.BatchNorm``
does), and ``y = (x32 - mean) * rsqrt(var + eps) * scale + bias`` in
that order, cast to ``dtype`` (default ``x``'s).

:class:`SyncBatchNorm` has ``nn.BatchNorm``'s layout: parameters
``scale``/``bias`` and buffers ``mean``/``var`` (fp32 ``[C]``), biased
moments, ``ra = momentum * ra + (1 - momentum) * batch``. In eval mode it
normalizes with the running statistics and makes no collective. With
``axis_name=None`` it is local batch norm. The module takes its mesh
(deviation 16); ``mesh=None`` is the world mesh ``init()`` set up
(axis 'dp').

The functions take JAX's layout, channels last (``channel_dim=-1``);
the port's models pass ``channel_dim=1`` for their NCHW activations.
Every call that sums over an axis adds one to :func:`allreduce_count`,
also on an axis of size 1, where the psum is the identity.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from ..parallel import collectives as _coll
from ..topology import resolve_device

_allreduces = 0


def allreduce_count() -> int:
    """The ``[2C]`` statistics all-reduces issued since the last reset."""
    return _allreduces


def reset_allreduce_count() -> None:
    global _allreduces
    _allreduces = 0


def _mesh_of(mesh):
    if mesh is not None:
        return mesh
    from .. import topology as _topo
    return _topo.mesh()


def _axes(x: torch.Tensor, channel_dim: int):
    c = channel_dim % x.dim()
    return c, tuple(d for d in range(x.dim()) if d != c)


def batch_moments(x: torch.Tensor, axis_name: Optional[str] = "dp", *,
                  mesh=None, channel_dim: int = -1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Biased fp32 ``(mean, var)`` of shape ``[C]`` over every dim but
    ``channel_dim``, across ``axis_name`` of ``mesh`` when given: one
    psum of the concatenated ``[sum, sum_sq]`` buffer."""
    global _allreduces
    x32 = x.float()
    c_dim, axes = _axes(x, channel_dim)
    s1 = x32.sum(axes)
    s2 = (x32 * x32).sum(axes)
    count = x.numel() // x.shape[c_dim]
    if axis_name is not None:
        m = _mesh_of(mesh)
        c = x.shape[c_dim]
        fused = _coll.psum(torch.cat([s1, s2]), m, axis_name)
        _allreduces += 1
        s1, s2 = fused[:c], fused[c:]
        count *= _coll.axis_size(m, axis_name)
    mean = s1 / count
    var = s2 / count - mean * mean
    return mean, var


def _normalize(x, mean, var, scale, bias, eps, dtype, channel_dim):
    c_dim, _ = _axes(x, channel_dim)
    shape = [1] * x.dim()
    shape[c_dim] = -1
    x32 = x.float()
    inv = torch.reciprocal(torch.sqrt(var + eps))
    y = (x32 - mean.view(shape)) * inv.view(shape) * scale.view(shape) \
        + bias.view(shape)
    return y.to(dtype if dtype is not None else x.dtype)


def sync_batch_norm(x: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, *, axis_name: Optional[str] = "dp",
                    mesh=None, epsilon: float = 1e-5,
                    dtype: Optional[torch.dtype] = None,
                    channel_dim: int = -1
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Normalize ``x`` by the cross-replica batch moments. Returns ``(y,
    mean, var)``; the moments are what the module folds into its running
    statistics."""
    mean, var = batch_moments(x, axis_name, mesh=mesh,
                              channel_dim=channel_dim)
    y = _normalize(x, mean, var, scale, bias, epsilon, dtype, channel_dim)
    return y, mean, var


class SyncBatchNorm(nn.Module):
    """``nn.BatchNorm`` with cross-replica statistics (see the module
    docstring); ``zero_scale`` starts ``scale`` at 0 (a residual
    branch's last norm). Its parameters and buffers live on ``device``:
    CUDA unless ``device="cpu"`` is passed."""

    def __init__(self, c: int, *, axis_name: Optional[str] = "dp",
                 mesh=None, momentum: float = 0.9, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None, channel_dim: int = -1,
                 zero_scale: bool = False,
                 device: Union[str, torch.device, None] = None):
        super().__init__()
        dev = resolve_device(device)
        self.scale = nn.Parameter(torch.zeros(c, device=dev) if zero_scale
                                  else torch.ones(c, device=dev))
        self.bias = nn.Parameter(torch.zeros(c, device=dev))
        self.register_buffer("mean", torch.zeros(c, device=dev))
        self.register_buffer("var", torch.ones(c, device=dev))
        self.axis_name, self.mesh = axis_name, mesh
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.channel_dim = channel_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            # The running statistics are the same on every replica: no
            # collective.
            return _normalize(x, self.mean, self.var, self.scale, self.bias,
                              self.eps, self.dtype, self.channel_dim)
        y, mean, var = sync_batch_norm(
            x, self.scale, self.bias, axis_name=self.axis_name,
            mesh=self.mesh, epsilon=self.eps, dtype=self.dtype,
            channel_dim=self.channel_dim)
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1.0 - m) * mean)
            self.var.copy_(m * self.var + (1.0 - m) * var)
        return y
