"""Data parallelism over a mesh axis: the batch split, the gradients
summed.

Counterpart of ``horovod_tpu/parallel/data_parallel.py``: where JAX
places a host batch with its leading dimension sharded over an axis and
sums a gradient tree over it with in-program psums, each rank here takes
its block of the batch and sums its gradients with the axis collectives
(``parallel/collectives.py``). The train steps over a mesh
(``parallel/train.py``) reduce by each parameter's spec instead; these
are the building blocks for a hand-written step.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.utils import _pytree as pytree

from .collectives import axis_size, psum
from .mesh import place, shard_tensor


def shard_batch(batch, mesh: DeviceMesh, axis: str = "dp"):
    """This rank's block of each tensor of ``batch`` (a tree), its
    leading dimension split over ``axis``, as JAX's ``shard_batch``
    places it."""
    sizes, coords = place(mesh)
    return pytree.tree_map(
        lambda x: shard_tensor(x, (axis,), sizes, coords), batch)


def allreduce_gradients(grads, mesh: DeviceMesh, axis: str = "dp",
                        average: bool = True):
    """Each gradient of the tree ``grads`` summed over ``axis`` (the mean
    with ``average``), as JAX's ``allreduce_gradients_in_jit``'s
    psum/pmean."""
    n = axis_size(mesh, axis)

    def reduce(g: torch.Tensor) -> torch.Tensor:
        s = psum(g, mesh, axis)
        # A division by a device tensor: CUDA turns a division by a
        # Python number into a multiply by its reciprocal.
        return s / s.new_full((), n) if average else s
    return pytree.tree_map(reduce, grads)
