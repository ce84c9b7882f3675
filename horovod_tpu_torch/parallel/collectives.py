"""Collectives over one axis of a mesh, with JAX's transposes.

Counterparts of the ``jax.lax`` collectives that the JAX package calls
inside ``shard_map`` (``psum``, ``ppermute``, ``all_to_all``,
``all_gather``, ``psum_scatter``, ``axis_index``, ``axis_size``), over
the process group of one axis of a ``DeviceMesh``
(``mesh.get_group(axis)``). Each differentiable collective is a
``torch.autograd.Function`` whose backward is the transpose JAX uses
under ``shard_map(check_vma=False)``:

- ``psum``'s backward is a ``psum`` of the cotangents. The train step's
  masked-loss rule (``parallel/train.py``) depends on it. Megatron's
  identity/all-reduce f/g pair gives other gradients here.
- ``ppermute`` by a ring shift (and :func:`ring_shift`, one tensor by
  an offset): its backward is the inverse shift.
- tiled ``all_to_all(split_axis, concat_axis)``: its backward is the
  reverse ``all_to_all``.
- tiled ``all_gather``: its backward is a ``psum_scatter``, and the
  reverse.

On an axis of size 1 every collective is the identity, as in JAX: that
is the semantics, not a fallback. Every rank of an axis's group must
call the same collectives in the same order, as under ``shard_map``.
On NCCL ``psum_scatter`` is one ``reduce_scatter_tensor`` and
``all_gather`` one ``all_gather_into_tensor``.

The hierarchical reduction of JAX's ``parallel/collectives.py``
(:func:`hierarchical_psum`, :func:`cross_slice_bytes`) sums over an
in-node ('ici') and a cross-node ('dcn') axis in two stages, so that
only 1/ici_size of the bytes cross nodes. Several tensors go through
it together in a chunk-major buffer (:func:`chunk_major`) whose values
are each tensor's own: every collective of the stages works
element by element or on the chunk of each tensor that the tensor's
own reduction would give the rank.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

Axes = Union[str, Sequence[str], None]


def axis_size(mesh: DeviceMesh, axis: Axes) -> int:
    """The size of ``axis`` (the product over a tuple of axes; 1 for
    None), as ``lax.axis_size``."""
    size = 1
    for a in _names(axis):
        size *= mesh.size(mesh.mesh_dim_names.index(a))
    return size


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``, as ``lax.axis_index``."""
    return mesh.get_local_rank(axis)


def _names(axis: Axes) -> Tuple[str, ...]:
    if axis is None:
        return ()
    if isinstance(axis, str):
        return (axis,)
    return tuple(axis)


def _groups(mesh: DeviceMesh, axis: Axes):
    """The process groups of the named axes of size > 1."""
    return tuple(mesh.get_group(a) for a in _names(axis)
                 if axis_size(mesh, a) > 1)


def _all_reduce(x: torch.Tensor, groups) -> torch.Tensor:
    y = x.contiguous().clone()
    for g in groups:
        dist.all_reduce(y, group=g)
    return y


class _Psum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _all_reduce(x, groups)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.groups), None


def psum(x: torch.Tensor, mesh: DeviceMesh, axis: Axes) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` (a name or a tuple of names); its
    backward is a psum of the cotangents."""
    groups = _groups(mesh, axis)
    if not groups:
        return x
    return _Psum.apply(x, groups)


def _shift(tensors, group, shift: int):
    """Send each tensor to group rank ``i + shift`` and receive the one
    from ``i - shift``, as one batch of sends and receives."""
    return _shifts([(t, shift) for t in tensors], group)


def _shifts(sends, group):
    """For each ``(tensor, shift)``: send the tensor to group rank ``i +
    shift`` and receive, in its place, the one rank ``i - shift`` sent;
    all in one batch of sends and receives. Every rank passes the same
    shifts in the same order, so that the k-th message between two ranks
    lands in the k-th receive posted for it, also where two shifts reach
    the same neighbour (n = 2)."""
    ranks = dist.get_process_group_ranks(group)
    n, i = len(ranks), dist.get_group_rank(group, dist.get_rank())
    sends = [(t.contiguous(), s) for t, s in sends]
    recvs = [torch.empty_like(t) for t, _ in sends]
    ops = ([dist.P2POp(dist.isend, t, ranks[(i + s) % n], group)
            for t, s in sends]
           + [dist.P2POp(dist.irecv, r, ranks[(i - s) % n], group)
              for r, (_, s) in zip(recvs, sends)])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recvs


class _Ppermute(torch.autograd.Function):

    @staticmethod
    def forward(ctx, group, shift, *tensors):
        ctx.group, ctx.shift = group, shift
        return tuple(_shift(tensors, group, shift))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *_shift(grads, ctx.group, -ctx.shift))


def ppermute(tensors: Sequence[torch.Tensor], mesh: DeviceMesh, axis: str,
             shift: int = 1) -> Tuple[torch.Tensor, ...]:
    """Ring shift along ``axis``: rank ``i`` sends each tensor to rank
    ``(i + shift) % n`` and receives rank ``(i - shift) % n``'s, as
    ``lax.ppermute(x, axis, [(i, (i + shift) % n) for i in range(n)])``.
    The tensors travel together in one batch; the backward shifts the
    cotangents back."""
    tensors = tuple(tensors)
    if axis_size(mesh, axis) == 1:
        return tensors
    return _Ppermute.apply(mesh.get_group(axis), shift, *tensors)


def ring_shift(x: torch.Tensor, mesh: DeviceMesh, axis: str,
               offset: int = 1) -> torch.Tensor:
    """Each rank's ``x`` to the next rank around the ring of ``axis``
    (rank i -> rank (i + offset) % n), as JAX's ``ring_shift``: the
    building block of ring attention and the pipeline's hand-off."""
    return ppermute([x], mesh, axis, shift=offset)[0]


def _a2a(x, group, n, split_axis, concat_axis):
    send = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, n, split_axis, concat_axis):
        ctx.args = (group, n, concat_axis, split_axis)
        return _a2a(x, group, n, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return (_a2a(g, *ctx.args), None, None, None, None)


def all_to_all(x: torch.Tensor, mesh: DeviceMesh, axis: str,
               split_axis: int, concat_axis: int) -> torch.Tensor:
    """Tiled all-to-all along ``axis``: ``x`` splits along
    ``split_axis`` into n chunks, chunk j goes to rank j, and the chunks
    received concatenate along ``concat_axis`` in rank order, as
    ``lax.all_to_all(..., tiled=True)``. The backward is the reverse
    all-to-all."""
    n = axis_size(mesh, axis)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dimension {split_axis} of size "
                         f"{x.shape[split_axis]} does not split over "
                         f"{axis!r} of size {n}")
    if n == 1:
        return x
    return _AllToAll.apply(x, mesh.get_group(axis), n, split_axis,
                           concat_axis)


def _nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


def _gather(x, group, n, dim):
    if _nccl(group):
        # Chunk-major: ``dim`` to the front, every rank's block gathered
        # into one buffer in rank order, ``dim`` moved back.
        front = x.movedim(dim, 0).contiguous()
        out = front.new_empty((n * front.shape[0],) + front.shape[1:])
        dist.all_gather_into_tensor(out, front, group=group)
        return out.movedim(0, dim).contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _scatter_sum(x, group, n, dim):
    if _nccl(group):
        front = x.movedim(dim, 0).contiguous()
        out = front.new_empty((front.shape[0] // n,) + front.shape[1:])
        dist.reduce_scatter_tensor(out, front, group=group)
        return out.movedim(0, dim).contiguous()
    # gloo: the sum, then this rank's chunk. The values of a
    # reduce-scatter at n times its bytes. torch 2.13's gloo runs
    # reduce_scatter_tensor too (checked on the CPU build), but the CPU
    # tests were first held to this all_reduce's sums, and on the CPU
    # the bytes do not matter.
    total = _all_reduce(x, (group,))
    i = dist.get_group_rank(group, dist.get_rank())
    return total.chunk(n, dim=dim)[i].contiguous()


class _AllGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.args = (group, n, dim)
        return _gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, *ctx.args), None, None, None


class _PsumScatter(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.args = (group, n, dim)
        return _scatter_sum(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None, None


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str,
               dim: int = 0) -> torch.Tensor:
    """Tiled all-gather along ``axis``: every rank's ``x`` concatenated
    along ``dim`` in rank order, as ``lax.all_gather(..., tiled=True)``.
    The backward is a psum_scatter."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    return _AllGather.apply(x, mesh.get_group(axis), n, dim)


def psum_scatter(x: torch.Tensor, mesh: DeviceMesh, axis: str,
                 dim: int = 0) -> torch.Tensor:
    """Tiled psum_scatter along ``axis``: the sum over the axis, of
    which rank i keeps chunk i along ``dim``, as
    ``lax.psum_scatter(..., scatter_dimension=dim, tiled=True)``. The
    backward is an all_gather."""
    n = axis_size(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"psum_scatter: dimension {dim} of size "
                         f"{x.shape[dim]} does not split over {axis!r} of "
                         f"size {n}")
    if n == 1:
        return x
    return _PsumScatter.apply(x, mesh.get_group(axis), n, dim)


def chunk_major(flats: Sequence[torch.Tensor], n: int) -> torch.Tensor:
    """``[n, W]``: row k holds the k-th of n equal chunks of every flat
    tensor (each of a length divisible by n), side by side. A
    reduce-scatter or all-to-all over dimension 0 then moves to rank k
    what each tensor's own would."""
    return torch.cat([f.reshape(n, -1) for f in flats], dim=1)


def split_chunk_major(buf: torch.Tensor, sizes: Sequence[int],
                      n: int) -> List[torch.Tensor]:
    """The inverse of :func:`chunk_major`: the flat tensors of lengths
    ``sizes`` from a ``[n, W]`` buffer (or its flattening)."""
    parts = buf.reshape(n, -1).split([s // n for s in sizes], dim=1)
    return [p.reshape(-1) for p in parts]


def _padded(n: int, multiple: int) -> int:
    return -(-int(n) // multiple) * multiple


def _flat_fp32(t: torch.Tensor, multiple: int) -> torch.Tensor:
    flat = t.reshape(-1).float()
    return F.pad(flat, (0, _padded(flat.numel(), multiple) - flat.numel()))


def hierarchical_psum_tree(tensors: Sequence[torch.Tensor],
                           mesh: DeviceMesh, ici_axis: str, dcn_axis: str,
                           *, wire=None, average: bool = False
                           ) -> List[torch.Tensor]:
    """:func:`hierarchical_psum` of each tensor, the values of one call
    per tensor, in one collective per stage: each tensor flattened to
    fp32 and padded to a multiple of the ici size, the flats laid out
    chunk-major, ``psum_scatter`` over ``ici_axis``, the span summed over
    ``dcn_axis`` (block-quantized by ``quantization.quantized_psum_many``
    when ``wire`` names a spec such as ``"int8x256"``, whose blocks then
    stay each tensor's own), ``all_gather`` over ``ici_axis``, and each
    tensor cut, averaged if asked and cast back."""
    tensors = list(tensors)
    live = [i for i, t in enumerate(tensors) if t.numel()]
    if not live:
        return tensors
    n_ici = axis_size(mesh, ici_axis)
    flats = [_flat_fp32(tensors[i], n_ici) for i in live]
    sizes = [f.numel() for f in flats]
    span = psum_scatter(chunk_major(flats, n_ici), mesh, ici_axis, dim=0)
    if wire is not None:
        from .. import quantization as _quant
        spans = span.reshape(-1).split([s // n_ici for s in sizes])
        span = torch.cat(_quant.quantized_psum_many(spans, mesh, dcn_axis,
                                                    wire)).reshape(1, -1)
    else:
        span = psum(span, mesh, dcn_axis)
    full = all_gather(span, mesh, ici_axis, dim=0)
    outs = split_chunk_major(full, sizes, n_ici)
    if average:
        # A division by a device tensor: CUDA turns a division by a
        # Python number into a multiply by its reciprocal.
        n = full.new_full((), n_ici * axis_size(mesh, dcn_axis))
        outs = [o / n for o in outs]
    out = list(tensors)
    for i, o in zip(live, outs):
        t = tensors[i]
        out[i] = o[:t.numel()].reshape(t.shape).to(t.dtype)
    return out


def hierarchical_psum(x: torch.Tensor, mesh: DeviceMesh, ici_axis: str,
                      dcn_axis: str, *, wire=None,
                      average: bool = False) -> torch.Tensor:
    """The sum (or mean) of ``x`` over both axes in two stages:
    ``psum_scatter`` over ``ici_axis`` (each in-node rank holds the
    in-node sum of a 1/ici_size span), the span's ``psum`` over
    ``dcn_axis`` (the only cross-node traffic; with ``wire`` it crosses
    block-quantized), then ``all_gather`` over ``ici_axis``. The value of
    ``psum(x, mesh, (ici_axis, dcn_axis))`` up to the order of the fp32
    sums (and, with ``wire``, the quantization of the cross-node leg)."""
    return hierarchical_psum_tree([x], mesh, ici_axis, dcn_axis, wire=wire,
                                  average=average)[0]


def cross_slice_bytes(n_elements: int, ici_size: int, *,
                      hierarchical: bool = True, wire=None,
                      dtype_bytes: int = 4) -> int:
    """Bytes one rank sends over the cross-node leg per reduction of
    ``n_elements``: all of them for the flat psum, the 1/ici_size span
    for the hierarchical one, counted in wire bytes when ``wire`` is
    set."""
    if not hierarchical:
        return int(n_elements) * dtype_bytes
    span = -(-int(n_elements) // int(ici_size))
    if wire is not None:
        from .. import quantization as _quant
        return _quant.wire_nbytes(wire, span)
    return span * dtype_bytes
