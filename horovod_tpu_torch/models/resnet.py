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
``[out, in]``); ``interop.image_variables_from_jax`` carries them from
the JAX tree. Convolutions pad as flax's ``"SAME"`` does, which is
asymmetric for a 3x3 stride-2 conv on an even input (``(0, 1)``).

``bn_impl``: ``"flax"`` is the JAX default path (flax ``BatchNorm``
numerics, then ReLU and the residual add in ``dtype``); any other string
routes every BN(+residual)(+ReLU) through ``ops.fused_bn.bn_act`` with
that impl (``"pallas"`` runs the CUDA kernels). Running statistics use
flax's convention: ``ra = 0.9 * ra + 0.1 * batch``, biased variance.

``bn_axis_name`` makes every BN a ``data.sync_bn.SyncBatchNorm`` over
that axis of ``mesh`` (None: the world mesh ``init()`` set up, axis
'dp'), as the JAX model swaps in its ``SyncBatchNorm``; it needs
``bn_impl="flax"`` and raises JAX's ``ValueError`` otherwise. Parameter
and buffer names stay those of the local BN.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_bn import IMPLS, bn_act, bn_act_inference
from ..topology import resolve_device
from .layers import EPSILON, BatchNorm, Conv, _Norm, init_convs_, \
    lecun_normal_, same_pads

__all__ = ["BatchNorm", "BottleneckBlock", "Conv", "FusedBNAct", "ResNet",
           "ResNet50", "ResNet101", "ResNet152", "same_pads"]


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
                 bn_impl: str, sync_norm=None):
        super().__init__()
        self.fused = bn_impl != "flax"
        cout = filters * 4
        conv = partial(Conv, dtype=dtype)

        def norm(c, zero_scale=False, relu=True):
            if self.fused:
                return FusedBNAct(c, zero_scale, relu, bn_impl)
            if sync_norm is not None:
                return sync_norm(c, zero_scale=zero_scale)
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
                 *, mesh=None, generator: Optional[torch.Generator] = None,
                 device: Union[str, torch.device, None] = None):
        super().__init__()
        if bn_impl != "flax" and bn_impl not in IMPLS:
            raise ValueError(f"unknown bn_impl {bn_impl!r}; expected 'flax' "
                             f"or one of {IMPLS}")
        if bn_axis_name is not None and bn_impl != "flax":
            raise ValueError(
                "bn_axis_name (distributed batch norm) requires "
                "bn_impl='flax': the fused bn op computes its "
                "statistics inside its custom VJP and cannot psum "
                "them (docs/data.md#sync-bn)")
        dev = resolve_device(device)
        sync_norm = None
        if bn_axis_name is not None:
            from ..data.sync_bn import SyncBatchNorm
            sync_norm = partial(SyncBatchNorm, axis_name=bn_axis_name,
                                mesh=mesh, eps=EPSILON, dtype=dtype,
                                channel_dim=1, device=dev)
        self.stage_sizes = list(stage_sizes)
        self.dtype, self.bn_impl = dtype, bn_impl
        self.fused = bn_impl != "flax"
        self.conv_init = Conv(3, num_filters, 7, 2, padding=(3, 3),
                              dtype=dtype)
        if self.fused:
            self.bn_init = FusedBNAct(num_filters, impl=bn_impl)
        elif sync_norm is not None:
            self.bn_init = sync_norm(num_filters)
        else:
            self.bn_init = BatchNorm(num_filters, dtype=dtype)
        self.block_names = []
        cin = num_filters
        for i, count in enumerate(self.stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                filters = num_filters * 2 ** i
                name = f"stage{i + 1}_block{j + 1}"
                self.add_module(name, BottleneckBlock(cin, filters, stride,
                                                      dtype, bn_impl,
                                                      sync_norm))
                self.block_names.append(name)
                cin = filters * 4
        self.head = nn.Linear(cin, num_classes)
        self._init_weights(generator or torch.Generator().manual_seed(0))
        self.to(dev)

    @torch.no_grad()
    def _init_weights(self, generator: torch.Generator) -> None:
        init_convs_(self, generator)
        lecun_normal_(self.head.weight, self.head.in_features, generator)
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
