"""ResNet v1.5 family, the image workload.

Counterpart of ``horovod_tpu/models/resnet.py``: the same blocks, names,
parameter tree and numerics. The public API takes NHWC images
``[N, H, W, 3]`` as the JAX model does; inside, activations are NCHW
tensors in ``torch.channels_last`` memory, so the ``[M, C]`` view the
batch-norm kernels take (``M = N*H*W``) is a free permute. Parameters
are fp32; convolutions run in ``dtype`` with the weight cast at each use,
as flax does; the mean-pool accumulates in fp32 and returns ``dtype``;
the head runs in fp32.

Weights keep PyTorch's layouts (conv ``[O, I, kh, kw]``, head
``[out, in]``); ``interop.resnet_variables_from_jax`` carries them from
the JAX tree. Convolutions pad as flax's ``"SAME"`` does, which is
asymmetric for a 3x3 stride-2 conv on an even input (``(0, 1)``).

``bn_impl``: ``"flax"`` is the JAX default path (flax ``BatchNorm``
numerics, then ReLU and the residual add in ``dtype``); any other string
routes every BN(+residual)(+ReLU) through ``ops.fused_bn.bn_act`` with
that impl (``"pallas"`` runs the CUDA kernels). Running statistics use
flax's convention: ``ra = 0.9 * ra + 0.1 * batch``, biased variance.
Distributed batch norm (``bn_axis_name``) is a later slice and raises.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_bn import IMPLS, bn_act, bn_act_inference
from ..topology import resolve_device

MOMENTUM = 0.9
EPSILON = 1e-5


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of flax/XLA ``"SAME"`` along one dimension."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _lecun_normal_(t: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    # flax's default kernel init: truncated normal at +-2 std, the std
    # corrected for the truncation.
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


class Conv(nn.Module):
    """flax ``nn.Conv`` without bias: fp32 weight ``[O, I, k, k]``, cast
    to ``dtype`` (channels last) at each use. ``padding`` is ``"SAME"``
    or an explicit ``(low, high)`` for both spatial dimensions."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: Union[str, Tuple[int, int]] = "SAME",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.k, self.stride, self.padding, self.dtype = k, stride, padding, \
            dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == "SAME":
            ph = same_pads(x.shape[2], self.k, self.stride)
            pw = same_pads(x.shape[3], self.k, self.stride)
        else:
            ph = pw = self.padding
        if ph[0] == ph[1] and pw[0] == pw[1]:
            pad = (ph[0], pw[0])
        else:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            pad = (0, 0)
        w = self.weight.to(self.dtype, memory_format=torch.channels_last)
        return F.conv2d(x, w, stride=self.stride, padding=pad)


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
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(c, zero_scale)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            mean = xf.mean((0, 2, 3))
            var = torch.clamp_min((xf * xf).mean((0, 2, 3)) - mean * mean,
                                  0.0)
            self._update(mean, var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + EPSILON) * self.scale
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(self.dtype)


class FusedBNAct(_Norm):
    """BN with the residual add and ReLU fused into ``ops.fused_bn.bn_act``
    (train) or ``bn_act_inference`` (eval). Same layout as
    :class:`BatchNorm`; the batch variance is not clamped."""

    def __init__(self, c: int, zero_scale: bool = False, relu: bool = True,
                 impl: str = "auto"):
        super().__init__(c, zero_scale)
        self.relu, self.impl = relu, impl

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        # NCHW channels_last -> the NHWC view whose rows are [M, C].
        xh = x.permute(0, 2, 3, 1)
        rh = residual.permute(0, 2, 3, 1) if residual is not None else None
        if self.training:
            y, mean, var = bn_act(xh, self.scale, self.bias, residual=rh,
                                  eps=EPSILON, relu=self.relu,
                                  impl=self.impl)
            self._update(mean, var)
        else:
            y = bn_act_inference(xh, self.scale, self.bias, self.mean,
                                 self.var, residual=rh, eps=EPSILON,
                                 relu=self.relu)
        return y.permute(0, 3, 1, 2)


class BottleneckBlock(nn.Module):
    """ResNet v1.5 bottleneck (stride in the 3x3). With the fused norm,
    bn1/bn2 carry the ReLU and bn3 the residual join (bn3 + add + ReLU);
    the flax path applies ReLU and the add after its BN, in ``dtype``."""

    def __init__(self, cin: int, filters: int, stride: int, dtype,
                 bn_impl: str):
        super().__init__()
        self.fused = bn_impl != "flax"
        cout = filters * 4
        conv = partial(Conv, dtype=dtype)

        def norm(c, zero_scale=False, relu=True):
            if self.fused:
                return FusedBNAct(c, zero_scale, relu, bn_impl)
            return BatchNorm(c, zero_scale, dtype)

        self.conv1 = conv(cin, filters, 1)
        self.bn1 = norm(filters)
        self.conv2 = conv(filters, filters, 3, stride)
        self.bn2 = norm(filters)
        self.conv3 = conv(filters, cout, 1)
        self.bn3 = norm(cout, zero_scale=True)
        self.has_downsample = cin != cout or stride != 1
        if self.has_downsample:
            self.downsample_conv = conv(cin, cout, 1, stride)
            self.downsample_bn = norm(cout, relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        if self.fused:
            y = self.bn2(self.conv2(self.bn1(self.conv1(x))))
            y = self.conv3(y)
            if self.has_downsample:
                residual = self.downsample_bn(self.downsample_conv(x))
            return self.bn3(y, residual=residual)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.has_downsample:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet v1.5 with ``dtype`` compute and fp32 parameters.

    ``model(images)`` takes NHWC ``[N, H, W, 3]`` images and returns fp32
    logits ``[N, num_classes]``; in train mode (the default) every BN
    normalises with the batch statistics and updates its running ones.
    It runs on CUDA unless ``device="cpu"`` is passed; parameters are
    drawn from ``generator`` with flax's default initialisers."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.bfloat16,
                 bn_impl: str = "flax", bn_axis_name: Optional[str] = None,
                 *, generator: Optional[torch.Generator] = None,
                 device: Union[str, torch.device, None] = None):
        super().__init__()
        if bn_axis_name is not None:
            raise NotImplementedError(
                "bn_axis_name (distributed batch norm) is not ported yet")
        if bn_impl != "flax" and bn_impl not in IMPLS:
            raise ValueError(f"unknown bn_impl {bn_impl!r}; expected 'flax' "
                             f"or one of {IMPLS}")
        dev = resolve_device(device)
        self.stage_sizes = list(stage_sizes)
        self.dtype, self.bn_impl = dtype, bn_impl
        self.fused = bn_impl != "flax"
        self.conv_init = Conv(3, num_filters, 7, 2, padding=(3, 3),
                              dtype=dtype)
        self.bn_init = (FusedBNAct(num_filters, impl=bn_impl) if self.fused
                        else BatchNorm(num_filters, dtype=dtype))
        self.block_names = []
        cin = num_filters
        for i, count in enumerate(self.stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                filters = num_filters * 2 ** i
                name = f"stage{i + 1}_block{j + 1}"
                self.add_module(name, BottleneckBlock(cin, filters, stride,
                                                      dtype, bn_impl))
                self.block_names.append(name)
                cin = filters * 4
        self.head = nn.Linear(cin, num_classes)
        self._init_weights(generator or torch.Generator().manual_seed(0))
        self.to(dev)

    @torch.no_grad()
    def _init_weights(self, generator: torch.Generator) -> None:
        for mod in self.modules():
            if isinstance(mod, Conv):
                w = mod.weight
                _lecun_normal_(w, w.shape[1] * w.shape[2] * w.shape[3],
                               generator)
        _lecun_normal_(self.head.weight, self.head.in_features, generator)
        self.head.bias.zero_()

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        # NHWC -> an NCHW view in channels_last memory.
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        x = self.conv_init(x)
        x = self.bn_init(x) if self.fused else F.relu(self.bn_init(x))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.mean((2, 3), dtype=torch.float32).to(self.dtype)
        return F.linear(x.float(), self.head.weight, self.head.bias)


ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3])
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3])
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3])
