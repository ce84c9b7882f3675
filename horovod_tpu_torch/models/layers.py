"""Layers the image models share: flax's ``Conv``, ``BatchNorm`` and
``Dense`` in PyTorch layouts.

Activations are NCHW tensors in ``torch.channels_last`` memory; the
models' public ``forward`` takes NHWC images as the JAX models do.
Parameters are fp32 and drawn with flax's default initialisers; a layer
casts them to its ``dtype`` at each use, as flax does. Weights keep
PyTorch's layouts (conv ``[O, I, kh, kw]``, dense ``[out, in]``);
``interop`` carries them from the JAX trees.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

MOMENTUM = 0.9
EPSILON = 1e-5

Padding = Union[str, Tuple[int, int], Sequence[Tuple[int, int]]]


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of flax/XLA ``"SAME"`` along one dimension."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """flax's default kernel init: a normal truncated at +-2 std, the std
    corrected for the truncation."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv(nn.Module):
    """flax ``nn.Conv``: fp32 weight ``[O, I, kh, kw]`` (and bias ``[O]``
    when ``bias``), cast to ``dtype`` (channels last) at each use, as is
    the input; the bias joins inside the convolution.
    ``k`` and ``stride`` are an int or ``(h, w)``; ``padding`` is
    ``"SAME"``, ``"VALID"``, one ``(low, high)`` for both spatial
    dimensions, or one per dimension."""

    def __init__(self, cin: int, cout: int, k, stride=1,
                 padding: Padding = "SAME",
                 dtype: torch.dtype = torch.bfloat16, bias: bool = False):
        super().__init__()
        self.kh, self.kw = _pair(k)
        self.weight = nn.Parameter(torch.empty(cout, cin, self.kh, self.kw))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.padding, self.dtype = _pair(stride), padding, dtype

    def _pads(self, h: int, w: int):
        if self.padding == "SAME":
            return (same_pads(h, self.kh, self.stride[0]),
                    same_pads(w, self.kw, self.stride[1]))
        if self.padding == "VALID":
            return (0, 0), (0, 0)
        if isinstance(self.padding[0], int):
            return tuple(self.padding), tuple(self.padding)
        return tuple(map(tuple, self.padding))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        ph, pw = self._pads(x.shape[2], x.shape[3])
        if ph[0] == ph[1] and pw[0] == pw[1]:
            pad = (ph[0], pw[0])
        else:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            pad = (0, 0)
        w = self.weight.to(self.dtype, memory_format=torch.channels_last)
        b = self.bias.to(self.dtype) if self.bias is not None else None
        return F.conv2d(x, w, b, stride=self.stride, padding=pad)


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype
          ) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)`` with the weights of ``layer``: input,
    kernel and bias cast to ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """An NCHW activation flattened in flax's NHWC order (rows of fc1
    are (h, w, c)-ordered)."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def init_dense_(layer: nn.Linear, generator: torch.Generator) -> None:
    lecun_normal_(layer.weight, layer.in_features, generator)
    with torch.no_grad():
        layer.bias.zero_()


def init_convs_(model: nn.Module, generator: torch.Generator) -> None:
    """flax's kernel init on every :class:`Conv` of ``model`` (biases
    stay zero)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Conv):
                w = mod.weight
                lecun_normal_(w, w.shape[1] * w.shape[2] * w.shape[3],
                              generator)


class _Norm(nn.Module):
    """Parameters ``scale``/``bias`` and buffers ``mean``/``var``, all fp32
    ``[C]``, as flax's ``BatchNorm`` lays them out."""

    def __init__(self, c: int, zero_scale: bool = False):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(c) if zero_scale
                                  else torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    @torch.no_grad()
    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = MOMENTUM
        self.mean.copy_(m * self.mean + (1.0 - m) * mean)
        self.var.copy_(m * self.var + (1.0 - m) * var)


class BatchNorm(_Norm):
    """flax ``nn.BatchNorm`` (0.12) over the channels of an NCHW tensor:
    fp32 ``mean(x)`` and ``mean(x^2)``, ``var = max(0, mean(x^2) -
    mean^2)``, ``y = (x - mean) * (rsqrt(var + eps) * scale) + bias`` in
    fp32, cast to ``dtype``. Gradients flow through the statistics."""

    def __init__(self, c: int, zero_scale: bool = False,
                 dtype: torch.dtype = torch.bfloat16, eps: float = EPSILON):
        super().__init__(c, zero_scale)
        self.dtype, self.eps = dtype, eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            mean = xf.mean((0, 2, 3))
            var = torch.clamp_min((xf * xf).mean((0, 2, 3)) - mean * mean,
                                  0.0)
            self._update(mean, var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(self.dtype)


class Dropout(nn.Module):
    """flax ``nn.Dropout(rate)``: in train mode each element is kept with
    probability ``1 - rate`` and the kept ones divided by it (in ``x``'s
    dtype); eval mode is the identity. The keep mask is drawn from
    ``generator`` (a ``torch.Generator`` on ``x``'s device, which the
    train step reseeds each step; None: the default one), in
    :meth:`keep_mask`."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator = None

    def keep_mask(self, x: torch.Tensor) -> torch.Tensor:
        return torch.empty(x.shape, device=x.device).bernoulli_(
            1.0 - self.rate, generator=self.generator).bool()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = self.keep_mask(x)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


def set_dropout_generator(model: nn.Module, generator) -> None:
    """Point every :class:`Dropout` of ``model`` at ``generator``."""
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.generator = generator
