"""Ulysses attention: sequence parallelism by two all-to-alls.

Counterpart of ``horovod_tpu/parallel/ulysses.py`` (DeepSpeed-Ulysses,
Jacobs et al. 2023). The inputs arrive sequence-sharded over the axis,
``[B, S/n, H, D]`` with every head; one tiled all-to-all reshards them
to ``[B, S, H/n, D]``, the whole sequence for a subset of heads, where
attention runs with no communication (the flash kernels or the plain
attention); a second all-to-all reshards the output back. The
head count must divide by the axis size.
"""

from __future__ import annotations

from typing import Optional

from torch.distributed.device_mesh import DeviceMesh

from ..ops.flash_attention import flash_attention
from .collectives import all_to_all, axis_size
from .ring_attention import full_attention


def ulysses_attention(q, k, v, *, mesh: DeviceMesh, axis: str = "sp",
                      causal: bool = True, scale: Optional[float] = None,
                      use_flash: bool = False):
    """Attention over a sequence sharded on ``axis``; q, k, v are this
    rank's ``[batch, seq_shard, heads, head_dim]``, heads % axis size ==
    0, and so is the result."""
    n = axis_size(mesh, axis)
    h = q.shape[2]
    if h % n != 0:
        raise ValueError(
            f"Ulysses needs n_heads ({h}) divisible by the '{axis}' "
            f"axis size ({n}); use ring_attention for fewer heads than "
            "shards")
    # Full sequence, a subset of heads.
    q, k, v = (all_to_all(x, mesh, axis, split_axis=2, concat_axis=1)
               for x in (q, k, v))
    if use_flash:
        out = flash_attention(q, k, v, causal, scale)
    else:
        out = full_attention(q, k, v, causal=causal, scale=scale)
    # Full heads, the sequence shard.
    return all_to_all(out, mesh, axis, split_axis=1, concat_axis=2)
