"""The VGG family, a benchmark workload.

Counterpart of ``horovod_tpu/models/vgg.py``: the same blocks, names,
parameter tree and numerics. VGG-16 is the reference's hardest scaling
benchmark (~138M parameters, most of them in the fc layers, so the
gradient allreduce's bandwidth bounds it): the zoo's
communication-bound stress test.

``model(images)`` takes NHWC ``[N, H, W, 3]`` images and returns fp32
logits. Convolutions (3x3, padding 1, with bias) and fc1/fc2 run in
``dtype``; batch norm (``use_bn``) runs in fp32 with eps 1e-5, as the
JAX model's ``dtype=jnp.float32`` BN; the head is fp32. fc1's rows are
(h, w, c)-ordered as flax flattens NHWC, so the NCHW activation is
permuted before it is flattened; ``image_size`` sizes fc1 as flax's
shape inference does at init. ``bn_axis_name`` (with ``use_bn``) makes
each BN a ``data.sync_bn.SyncBatchNorm`` over that axis of ``mesh``
(None: the world mesh). Dropout (0.5 after fc1 and fc2) draws from each
``layers.Dropout``'s generator, which the train step sets.
"""

from __future__ import annotations

from contextlib import nullcontext
from functools import partial
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..topology import resolve_device
from .layers import (BatchNorm, Conv, Dropout, dense, flatten_nhwc,
                     init_convs_, init_dense_)

# Block specs: number of conv layers x output channels per stage.
_VGG16 = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
_VGG19 = ((2, 64), (2, 128), (4, 256), (4, 512), (4, 512))


class VGG(nn.Module):
    """Configurable VGG (Simonyan & Zisserman 2014), batch norm off by
    default as in the classic benchmark. Runs on CUDA unless
    ``device="cpu"`` (or ``"meta"``, which allocates and initialises
    nothing) is passed; parameters are drawn from ``generator`` with
    flax's default initialisers."""

    def __init__(self, cfg: Sequence = _VGG16, num_classes: int = 1000,
                 use_bn: bool = False, dtype: torch.dtype = torch.bfloat16,
                 bn_axis_name: Optional[str] = None, *, image_size: int = 224,
                 mesh=None, generator: Optional[torch.Generator] = None,
                 device: Union[str, torch.device, None] = None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype, self.use_bn = dtype, use_bn
        if bn_axis_name is not None:
            from ..data.sync_bn import SyncBatchNorm
            bn = partial(SyncBatchNorm, axis_name=bn_axis_name, mesh=mesh,
                         eps=1e-5, dtype=torch.float32, channel_dim=1,
                         device=dev)
        else:
            bn = partial(BatchNorm, dtype=torch.float32, eps=1e-5)
        self.layer_names = []
        with torch.device("meta") if dev.type == "meta" else nullcontext():
            cin, size = 3, image_size
            for i, (n_layers, ch) in enumerate(cfg):
                for j in range(n_layers):
                    name = f"{i + 1}_{j + 1}"
                    self.add_module(f"conv{name}",
                                    Conv(cin, ch, 3, 1, (1, 1), dtype, True))
                    if use_bn:
                        self.add_module(f"bn{name}", bn(ch))
                    self.layer_names.append(name)
                    cin = ch
                self.layer_names.append("pool")
                size //= 2
            self.fc1 = nn.Linear(cin * size * size, 4096)
            self.fc2 = nn.Linear(4096, 4096)
            self.head = nn.Linear(4096, num_classes)
            self.dropout1, self.dropout2 = Dropout(0.5), Dropout(0.5)
        if dev.type != "meta":
            gen = generator or torch.Generator().manual_seed(0)
            init_convs_(self, gen)
            for fc in (self.fc1, self.fc2, self.head):
                init_dense_(fc, gen)
            self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        # NHWC -> an NCHW view in channels_last memory.
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        for name in self.layer_names:
            if name == "pool":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = getattr(self, f"conv{name}")(x)
            if self.use_bn:
                x = getattr(self, f"bn{name}")(x)
            x = F.relu(x)
        x = flatten_nhwc(x)
        x = self.dropout1(F.relu(dense(x, self.fc1, self.dtype)))
        x = self.dropout2(F.relu(dense(x, self.fc2, self.dtype)))
        return F.linear(x.float(), self.head.weight, self.head.bias)


VGG16 = partial(VGG, cfg=_VGG16)
VGG19 = partial(VGG, cfg=_VGG19)
