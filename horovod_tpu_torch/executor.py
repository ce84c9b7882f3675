"""The arithmetic of one fused group, on flat torch buffers.

Counterpart of ``horovod_tpu/executor.py``'s fusion-buffer body
(``_fused_reduce``, ``_accum_dtype``) and of its fused broadcast and
ragged allgather. The collective itself is a function the caller
passes, so the same arithmetic runs over ``torch.distributed`` in the
engine and with the identity in place of the collective in a check.

Allreduce, per dtype of the group: flatten and concatenate, cast to the
accumulation dtype (fp32 for fp16, bf16 and fp8; int32 for bool),
multiply by ``prescale``, sum over the ranks, multiply by ``postscale``
(which carries ``1 / size`` when averaging), and cast back. Integers are
scaled in floating point as JAX promotes them (float64 for int64,
float32 otherwise) and cast back as XLA does: toward zero, saturating at
the dtype's range. Unscaled integer sums wrap in their dtype, as MPI's
sum does.

Hierarchically (``HOROVOD_HIERARCHICAL_ALLREDUCE``/``_ALLGATHER``) the
sum is :func:`hier_reduce` and the gather :func:`hier_gather`, the
counterparts of the JAX executor's ``_hier_reduce`` and ``_hier_gather``
over the ``('dcn', 'ici')`` layout: ranks ``d * ici + i``, ``ici`` of them
to a node. A wire skips them, as JAX's does.

With a wire (``quantization.WireSpec``), a floating dtype's buffer takes
the dual block-quantized allreduce of ``_fused_reduce_quantized``
instead: each tensor cast to fp32 and prescaled, its span padded to
whole blocks (blocks never mix tensors, so a per-tensor or per-bucket
error-feedback residual matches the wire exactly), the buffer padded to
``world * block_size``, ``quantization.allreduce_blocks``, postscale,
and each tensor cast back.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from . import quantization as _quant

_ACCUM = {torch.float16: torch.float32, torch.bfloat16: torch.float32,
          torch.float8_e4m3fn: torch.float32, torch.float8_e5m2: torch.float32,
          torch.bool: torch.int32}


def accum_dtype(dtype: torch.dtype) -> Optional[torch.dtype]:
    """Accumulation dtype of exact small-float and bool reductions."""
    return _ACCUM.get(dtype)


def _scale_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype ``x * python_float`` computes in, as JAX promotes it."""
    if dtype.is_floating_point or dtype.is_complex:
        return dtype
    return torch.float64 if dtype == torch.int64 else torch.float32


def _scaled(buf: torch.Tensor, factor: float) -> torch.Tensor:
    return buf.to(_scale_dtype(buf.dtype)) * factor


def _cast_back(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if x.dtype == dtype:
        return x
    if dtype == torch.float8_e4m3fn:
        return _quant.to_e4m3fn(x)
    if dtype.is_floating_point or dtype == torch.bool \
            or not x.is_floating_point():
        return x.to(dtype)
    # XLA's float-to-integer convert: truncate, saturate, NaN to 0.
    info = torch.iinfo(dtype)
    y = x.trunc()
    hi, lo = y >= info.max, y <= info.min
    y = torch.where(hi | lo | y.isnan(), 0, y).to(dtype)
    return y.masked_fill_(hi, info.max).masked_fill_(lo, info.min)


Collective = Callable[[torch.Tensor], torch.Tensor]


def fused_allreduce(tensors: Sequence[torch.Tensor],
                    reduce_fn: Collective,
                    prescale: float = 1.0,
                    postscale: float = 1.0,
                    wire: Optional[_quant.WireSpec] = None,
                    world: int = 1,
                    all_to_all_fn: Optional[Collective] = None,
                    all_gather_fn: Optional[Collective] = None
                    ) -> List[torch.Tensor]:
    """Sum ``tensors`` over the ranks with ``reduce_fn`` (flat buffer in,
    its sum over the ranks out): one call per dtype. With ``wire``, a
    floating dtype goes through :func:`quantization.allreduce_blocks`
    over ``world`` ranks with the two collectives instead. Returns new
    tensors in input order, each of its input's shape and dtype."""
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for dt, idx in by_dtype.items():
        group = [tensors[i] for i in idx]
        if (wire is not None and dt.is_floating_point
                and sum(t.numel() for t in group) > 0):
            reds = _fused_reduce_quantized(group, wire, world, prescale,
                                           postscale, all_to_all_fn,
                                           all_gather_fn)
            for i, o in zip(idx, reds):
                out[i] = o
            continue
        # A new buffer (the reduction may work in place; flattening one
        # tensor would return a view of it).
        buf = (_flatten_dense_tensors(group) if len(group) > 1
               else group[0].reshape(-1).clone())
        acc = accum_dtype(dt)
        if acc is not None:
            buf = buf.to(acc)
        if prescale != 1.0:
            buf = _scaled(buf, prescale)
        red = reduce_fn(buf)
        if postscale != 1.0:
            red = _scaled(red, postscale)
        # Elementwise, so cast back once; the results are views of it.
        red = _cast_back(red, dt)
        for i, o in zip(idx, _unflatten_dense_tensors(red, group)):
            out[i] = o
    return out


def _fused_reduce_quantized(group: Sequence[torch.Tensor],
                            wire: _quant.WireSpec, world: int,
                            prescale: float, postscale: float,
                            all_to_all_fn: Collective,
                            all_gather_fn: Collective) -> List[torch.Tensor]:
    """The quantized wire's fusion buffer for one dtype: per-tensor block
    padding, the dual-quantized allreduce, the split back out."""
    bs = wire.block_size
    pieces, spans, off = [], [], 0
    for t in group:
        f = t.reshape(-1).to(torch.float32)
        if prescale != 1.0:
            f = f * prescale
        n = f.numel()
        m = _quant.padded_size(max(n, 1), bs)
        pieces.append(f)
        if m != n:
            pieces.append(f.new_zeros(m - n))
        spans.append((off, n))
        off += m
    extra = (-off) % (world * bs)
    if extra:
        pieces.append(pieces[0].new_zeros(extra))
    red = _quant.allreduce_blocks(torch.cat(pieces), wire, world,
                                  all_to_all_fn, all_gather_fn)
    if postscale != 1.0:
        red = red * postscale
    # Elementwise, so cast back once; the results are views of it.
    red = _cast_back(red, group[0].dtype)
    return [red[o:o + n].view(t.shape) for t, (o, n) in zip(group, spans)]


def hier_reduce(buf: torch.Tensor, ici: int, scatter_fn: Collective,
                dcn_sum_fn: Collective, gather_fn: Collective
                ) -> torch.Tensor:
    """The sum over every rank of flat ``buf`` in two stages: padded with
    zeros to a multiple of ``ici``, reduce-scattered within the node
    (``scatter_fn``: this rank's 1/ici span of the node's sum), the span
    summed across nodes (``dcn_sum_fn``), the spans gathered within the
    node again (``gather_fn``: every in-node rank's span, in order) and
    the padding cut."""
    n = buf.numel()
    pad = (-n) % ici
    if pad:
        buf = torch.cat([buf, buf.new_zeros(pad)])
    out = gather_fn(dcn_sum_fn(scatter_fn(buf)))
    return out[:n] if pad else out


def hier_gather(buf: torch.Tensor, ici_gather_fn: Collective,
                dcn_gather_fn: Collective) -> torch.Tensor:
    """Every rank's flat ``buf`` as ``[size, n]`` in two stages: within
    the node (``ici_gather_fn``: ``[ici, n]``), then across nodes
    (``dcn_gather_fn`` of the node's flattened gather). The result is
    node-major, rank ``d * ici + i`` at row ``d * ici + i``: the flat
    gather's order."""
    g = ici_gather_fn(buf)
    return dcn_gather_fn(g.reshape(-1)).reshape(-1, buf.numel())


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(b: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    return b.view(dtype).view(shape)


def fused_broadcast(tensors: Sequence[torch.Tensor],
                    broadcast_fn: Callable[[torch.Tensor], torch.Tensor]
                    ) -> List[torch.Tensor]:
    """Copy the root's ``tensors`` to every rank through one byte buffer;
    ``broadcast_fn`` broadcasts it in place and returns it."""
    buf = broadcast_fn(torch.cat([_as_bytes(t) for t in tensors]))
    out, off = [], 0
    for t in tensors:
        nb = t.numel() * t.element_size()
        out.append(_from_bytes(buf[off:off + nb], t.dtype, t.shape))
        off += nb
    return out


def fused_allgather(tensors: Sequence[torch.Tensor],
                    rows: Sequence[Sequence[int]],
                    gather_fn: Callable[[torch.Tensor], torch.Tensor]
                    ) -> List[torch.Tensor]:
    """Concatenate every rank's ``tensors`` along dim 0. ``rows[i][r]`` is
    tensor i's first dim on rank r (they may differ: the MPI_Allgatherv
    case). Each tensor is padded to its largest first dim in one byte
    buffer per rank; ``gather_fn`` gathers the buffers into ``[size,
    bytes]``; each rank's rows are trimmed back out."""
    pieces, spans = [], []
    off = 0
    for t, r in zip(tensors, rows):
        row_bytes = math.prod(t.shape[1:]) * t.element_size()
        slot = max(r) * row_bytes
        b = _as_bytes(t)
        pieces.append(b)
        if slot > b.numel():
            pieces.append(b.new_zeros(slot - b.numel()))
        spans.append((off, row_bytes))
        off += slot
    parts = gather_fn(torch.cat(pieces))
    out = []
    for t, r, (o, row_bytes) in zip(tensors, rows, spans):
        b = torch.cat([parts[k, o:o + n * row_bytes] for k, n in enumerate(r)])
        out.append(_from_bytes(b, t.dtype, (sum(r),) + tuple(t.shape[1:])))
    return out
