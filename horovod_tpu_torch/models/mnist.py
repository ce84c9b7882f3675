"""The MNIST ConvNet, the examples' model.

Counterpart of ``horovod_tpu/models/mnist.py``: conv32(5x5) -> pool ->
conv64(5x5) -> pool -> fc1024 -> dropout 0.5 -> fc10, the reference's
MNIST net. ``model(images)`` takes NHWC ``[N, 28, 28, 1]`` images and
returns fp32 logits. The input is cast to ``dtype`` (fp32 by default);
every layer then runs in fp32, as the JAX model's layers, which name no
dtype, promote to their fp32 parameters. Convolutions pad as flax's
``"SAME"`` (2 on each side), and fc1's rows are (h, w, c)-ordered as
flax flattens NHWC.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..topology import resolve_device
from .layers import Conv, Dropout, flatten_nhwc, init_convs_, init_dense_


class MnistConvNet(nn.Module):
    """Runs on CUDA unless ``device="cpu"`` is passed; parameters are
    drawn from ``generator`` with flax's default initialisers."""

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, *,
                 generator: Optional[torch.Generator] = None,
                 device: Union[str, torch.device, None] = None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        f32 = torch.float32
        self.conv1 = Conv(1, 32, 5, dtype=f32, bias=True)
        self.conv2 = Conv(32, 64, 5, dtype=f32, bias=True)
        self.fc1 = nn.Linear(7 * 7 * 64, 1024)
        self.dropout = Dropout(0.5)
        self.fc2 = nn.Linear(1024, num_classes)
        gen = generator or torch.Generator().manual_seed(0)
        init_convs_(self, gen)
        init_dense_(self.fc1, gen)
        init_dense_(self.fc2, gen)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.fc2.weight.device

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.conv1(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2, 2)
        x = self.dropout(F.relu(self.fc1(flatten_nhwc(x))))
        return self.fc2(x)
