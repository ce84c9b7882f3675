"""Inception V3, a benchmark workload.

Counterpart of ``horovod_tpu/models/inception.py``: the same graph
(stem, 3x InceptionA, InceptionB, 4x InceptionC, InceptionD, 2x
InceptionE, global pool and fc; no aux classifier), parameter tree and
numerics. Inception V3 is the reference's best-scaling benchmark:
compute-heavy with few parameters.

Module names are flax's auto-generated ones (``ConvBN_0``,
``InceptionA_1.ConvBN_3.Conv_0``, ``...BatchNorm_0``), numbered in call
order, so ``interop`` carries the JAX tree by name. Each ConvBN is a
bias-free conv in ``dtype`` followed by batch norm in fp32 with eps
1e-3 and ReLU, so the activations between convolutions are fp32, as in
the JAX model; ``bn_axis_name`` makes each BN a
``data.sync_bn.SyncBatchNorm`` over that axis of ``mesh`` (None: the
world mesh). Padding follows flax: ``"SAME"`` by default (1x7 pads (0,
3), 7x1 pads (3, 0)), ``"VALID"`` where the JAX model says so (every
stride-2 conv, so no stride-2 ``"SAME"`` conv and its asymmetric pad
exists); the branch pool is a 3x3 stride-1 average over a zero-padded
window that counts the padding (flax's ``avg_pool(..., "SAME")``). The
head takes the fp32 spatial mean, dropout 0.5 (``layers.Dropout``) and
an fp32 dense layer. Any input of at least 75x75 works; 299x299 is the
benchmark size.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..topology import resolve_device
from .layers import (BatchNorm, Conv, Dropout, Padding, init_convs_,
                     init_dense_)


class ConvBN(nn.Module):
    """flax ``Conv(use_bias=False)``, then BN (fp32, eps 1e-3), then
    ReLU. ``norm(c)`` builds the BN."""

    def __init__(self, cin: int, filters: int, kernel, strides=1,
                 padding: Padding = "SAME",
                 dtype: torch.dtype = torch.bfloat16, norm=None):
        super().__init__()
        self.Conv_0 = Conv(cin, filters, kernel, strides, padding, dtype)
        self.BatchNorm_0 = (norm or partial(BatchNorm, dtype=torch.float32,
                                            eps=1e-3))(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


def _avgpool_same(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


class _Block(nn.Module):
    """A module whose ConvBNs are named ``ConvBN_<i>`` in call order."""

    def __init__(self, dtype, norm):
        super().__init__()
        self._cbn = partial(ConvBN, dtype=dtype, norm=norm)
        self._n = 0

    def cbn(self, *args, **kwargs) -> ConvBN:
        mod = self._cbn(*args, **kwargs)
        self.add_module(f"ConvBN_{self._n}", mod)
        self._n += 1
        return mod


class InceptionA(_Block):
    def __init__(self, cin: int, pool_features: int, dtype, norm=None):
        super().__init__(dtype, norm)
        self.b1 = [self.cbn(cin, 64, 1)]
        self.b2 = [self.cbn(cin, 48, 1), self.cbn(48, 64, 5)]
        self.b3 = [self.cbn(cin, 64, 1), self.cbn(64, 96, 3),
                   self.cbn(96, 96, 3)]
        self.b4 = [self.cbn(cin, pool_features, 1)]
        self.cout = 64 + 64 + 96 + pool_features

    def forward(self, x):
        return torch.cat([_seq(self.b1, x), _seq(self.b2, x),
                          _seq(self.b3, x), _seq(self.b4, _avgpool_same(x))],
                         1)


class InceptionB(_Block):
    """Grid reduction 35x35 -> 17x17."""

    def __init__(self, cin: int, dtype, norm=None):
        super().__init__(dtype, norm)
        self.b1 = [self.cbn(cin, 384, 3, 2, "VALID")]
        self.b2 = [self.cbn(cin, 64, 1), self.cbn(64, 96, 3),
                   self.cbn(96, 96, 3, 2, "VALID")]
        self.cout = 384 + 96 + cin

    def forward(self, x):
        return torch.cat([_seq(self.b1, x), _seq(self.b2, x),
                          F.max_pool2d(x, 3, 2)], 1)


class InceptionC(_Block):
    """Factorized 7x7 branches."""

    def __init__(self, cin: int, channels_7x7: int, dtype, norm=None):
        super().__init__(dtype, norm)
        c7 = channels_7x7
        self.b1 = [self.cbn(cin, 192, 1)]
        self.b2 = [self.cbn(cin, c7, 1), self.cbn(c7, c7, (1, 7)),
                   self.cbn(c7, 192, (7, 1))]
        self.b3 = [self.cbn(cin, c7, 1), self.cbn(c7, c7, (7, 1)),
                   self.cbn(c7, c7, (1, 7)), self.cbn(c7, c7, (7, 1)),
                   self.cbn(c7, 192, (1, 7))]
        self.b4 = [self.cbn(cin, 192, 1)]
        self.cout = 4 * 192

    def forward(self, x):
        return torch.cat([_seq(self.b1, x), _seq(self.b2, x),
                          _seq(self.b3, x), _seq(self.b4, _avgpool_same(x))],
                         1)


class InceptionD(_Block):
    """Grid reduction 17x17 -> 8x8."""

    def __init__(self, cin: int, dtype, norm=None):
        super().__init__(dtype, norm)
        self.b1 = [self.cbn(cin, 192, 1), self.cbn(192, 320, 3, 2, "VALID")]
        self.b2 = [self.cbn(cin, 192, 1), self.cbn(192, 192, (1, 7)),
                   self.cbn(192, 192, (7, 1)),
                   self.cbn(192, 192, 3, 2, "VALID")]
        self.cout = 320 + 192 + cin

    def forward(self, x):
        return torch.cat([_seq(self.b1, x), _seq(self.b2, x),
                          F.max_pool2d(x, 3, 2)], 1)


class InceptionE(_Block):
    """Expanded-filter-bank output blocks."""

    def __init__(self, cin: int, dtype, norm=None):
        super().__init__(dtype, norm)
        # Plain lists: the ConvBNs are registered once, as ConvBN_<i>.
        self.b1 = [self.cbn(cin, 320, 1)]
        self.b2 = [self.cbn(cin, 384, 1)]
        self.b2ab = [self.cbn(384, 384, (1, 3)), self.cbn(384, 384, (3, 1))]
        self.b3 = [self.cbn(cin, 448, 1), self.cbn(448, 384, 3)]
        self.b3ab = [self.cbn(384, 384, (1, 3)), self.cbn(384, 384, (3, 1))]
        self.b4 = [self.cbn(cin, 192, 1)]
        self.cout = 320 + 768 + 768 + 192

    def forward(self, x):
        b2 = _seq(self.b2, x)
        b3 = _seq(self.b3, x)
        return torch.cat([_seq(self.b1, x), *(m(b2) for m in self.b2ab),
                          *(m(b3) for m in self.b3ab),
                          _seq(self.b4, _avgpool_same(x))], 1)


def _seq(mods, x):
    for m in mods:
        x = m(x)
    return x


class InceptionV3(nn.Module):
    """Inception V3 for 299x299 inputs (any >= 75x75). Runs on CUDA
    unless ``device="cpu"`` is passed; parameters are drawn from
    ``generator`` with flax's default initialisers."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16,
                 bn_axis_name: Optional[str] = None, *, mesh=None,
                 generator: Optional[torch.Generator] = None,
                 device: Union[str, torch.device, None] = None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        norm = None
        if bn_axis_name is not None:
            from ..data.sync_bn import SyncBatchNorm
            norm = partial(SyncBatchNorm, axis_name=bn_axis_name, mesh=mesh,
                           eps=1e-3, dtype=torch.float32, channel_dim=1,
                           device=dev)
        stem = _Block(dtype, norm)
        self.stem = [stem.cbn(3, 32, 3, 2, "VALID"),
                     stem.cbn(32, 32, 3, 1, "VALID"), stem.cbn(32, 64, 3),
                     "pool", stem.cbn(64, 80, 1, 1, "VALID"),
                     stem.cbn(80, 192, 3, 1, "VALID"), "pool"]
        for name, mod in stem.named_children():
            self.add_module(name, mod)
        self.blocks = []
        cin, counts = 192, {}

        def block(cls, *args):
            nonlocal cin
            mod = cls(cin, *args, dtype=dtype, norm=norm)
            name = f"{cls.__name__}_{counts.get(cls.__name__, 0)}"
            counts[cls.__name__] = counts.get(cls.__name__, 0) + 1
            self.add_module(name, mod)
            self.blocks.append(mod)
            cin = mod.cout

        block(InceptionA, 32)
        block(InceptionA, 64)
        block(InceptionA, 64)
        block(InceptionB)
        for c7 in (128, 160, 160, 192):
            block(InceptionC, c7)
        block(InceptionD)
        block(InceptionE)
        block(InceptionE)
        self.dropout = Dropout(0.5)
        self.head = nn.Linear(cin, num_classes)
        gen = generator or torch.Generator().manual_seed(0)
        init_convs_(self, gen)
        init_dense_(self.head, gen)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        # NHWC -> an NCHW view in channels_last memory.
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        for mod in self.stem:
            x = F.max_pool2d(x, 3, 2) if mod == "pool" else mod(x)
        for mod in self.blocks:
            x = mod(x)
        x = self.dropout(x.float().mean((2, 3)))
        return F.linear(x, self.head.weight, self.head.bias)
