"""The input pipeline: deterministic per-rank sharded loaders, prefetch
to the device, and distributed batch norm for the conv zoo.

Counterpart of ``horovod_tpu/data``::

    from horovod_tpu_torch import data

    src = data.synthetic("image", n=50_000, image_size=224,
                         num_classes=1000, seed=0)
    loader = data.build_loader(src, batch_size=32, seed=0)
    for batch in data.prefetch_to_device(loader, depth=2):
        images, labels = batch.data          # tensors on the card
        ...

``data.sync_bn`` (``SyncBatchNorm``) is loaded on first touch, as in
the JAX package, so the loader and prefetch layers import without the
model stack.
"""

import importlib

from .loader import Batch, ShardedDataset, ShardedLoader, build_loader
from .prefetch import DevicePrefetcher, prefetch_to_device, stage
from .sharding import epoch_permutation, total_microbatches, \
    usable_samples
from .sources import (ArraySource, CallableSource, FileListSource,
                      SyntheticSource, as_source, synthetic)

__all__ = [
    "ArraySource", "Batch", "CallableSource", "DevicePrefetcher",
    "FileListSource", "ShardedDataset", "ShardedLoader",
    "SyncBatchNorm", "SyntheticSource", "as_source", "build_loader",
    "epoch_permutation", "prefetch_to_device", "stage", "sync_bn",
    "synthetic", "sync_batch_norm", "total_microbatches",
    "usable_samples",
]


def __getattr__(name):
    if name in ("SyncBatchNorm", "sync_batch_norm", "batch_moments",
                "sync_bn"):
        # import_module, not "from . import": that form looks the name
        # up on this package first, which lands here again.
        _sbn = importlib.import_module(f"{__name__}.sync_bn")
        if name == "sync_bn":
            return _sbn
        return getattr(_sbn, name)
    raise AttributeError(name)
