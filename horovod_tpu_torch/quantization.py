"""Block-scaled quantization for the collective wire.

Counterpart of ``horovod_tpu/quantization.py``. A flat fp32 buffer is
cut into fixed-size blocks (default 256 elements); each block is scaled
by its absmax so the quantizer's whole range is used whatever the
block's magnitude, and the fp32 per-block scales travel beside the
payload.

The allreduce runs in the quantized domain (:func:`allreduce_blocks`):

  phase 1  quantize the local buffer; all-to-all the payload and scales
           so every rank receives each peer's contribution to its own
           shard; dequantize and accumulate in fp32, in rank order.
  phase 2  requantize the reduced shard; all-gather payload and scales;
           dequantize.

fp8 payloads cross the collectives as ``uint8`` (the same bytes). The
collectives are functions the caller passes, so the same arithmetic
runs over ``torch.distributed`` in the engine, over one axis of a mesh
in :func:`quantized_psum` (the hierarchical reduction's cross-node
leg), and with the identity in a check.

Every function computes what the JAX function of the same name does,
bit for bit: true fp32 divides by the scale, round half to even, and
the e4m3 cast of :func:`to_e4m3fn`. :func:`allreduce_blocks` computes
what JAX's compiled collective program does on XLA's CPU backend, whose
compiler changes two things there: it folds the scale's ``absmax /
qmax`` into ``absmax * (1 / qmax)`` (the reciprocal rounded to fp32),
and it fuses each product of phase 1 into its add (one rounding). So
its quantizer is not :func:`quantize_blocks`: :func:`local_roundtrip`,
like the JAX function run eagerly, divides, and an error-feedback
residual can differ from what the wire dropped by a unit in the last
place of a block's scale.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from .parallel.collectives import chunk_major, split_chunk_major

DEFAULT_BLOCK = 256

# fp32 per-block scale travelling beside the payload.
SCALE_BYTES = 4

# e4m3fn's largest finite value is 448; the next step up would be 480,
# so a value rounds past 448 exactly when its magnitude exceeds 464.
_E4M3_ROUNDS_PAST_MAX = 464.0


class WireSpec(NamedTuple):
    """Wire format of a block-scaled quantized collective."""
    kind: str          # "int8_blockwise" | "fp8_blockwise"
    wire_dtype: str    # "int8" | "float8_e4m3fn"
    block_size: int

    @property
    def qmax(self) -> float:
        # int8 uses the symmetric [-127, 127] range; e4m3's largest
        # finite value is 448.
        return 127.0 if self.wire_dtype == "int8" else 448.0

    def encoded(self) -> str:
        tag = "int8" if self.wire_dtype == "int8" else "fp8"
        return f"{tag}x{self.block_size}"


INT8_BLOCKWISE = WireSpec("int8_blockwise", "int8", DEFAULT_BLOCK)
FP8_BLOCKWISE = WireSpec("fp8_blockwise", "float8_e4m3fn", DEFAULT_BLOCK)


def parse(spec: Union[str, WireSpec, None]) -> Optional[WireSpec]:
    """Parse a wire spec string ("int8x256" / "fp8x256") or pass a
    WireSpec through. None stays None (no wire compression)."""
    if spec is None or isinstance(spec, WireSpec):
        return spec
    s = str(spec)
    tag, _, block = s.partition("x")
    try:
        bs = int(block) if block else DEFAULT_BLOCK
    except ValueError:
        raise ValueError(f"malformed wire spec {spec!r}") from None
    if tag == "int8":
        return WireSpec("int8_blockwise", "int8", bs)
    if tag == "fp8":
        return WireSpec("fp8_blockwise", "float8_e4m3fn", bs)
    raise ValueError(
        f"unknown wire spec {spec!r} (expected 'int8xN' or 'fp8xN')")


def padded_size(n: int, multiple: int) -> int:
    return -(-int(n) // multiple) * multiple


def wire_nbytes(spec: Union[str, WireSpec], n_elements: int) -> int:
    """Bytes a tensor of ``n_elements`` occupies on the wire: the payload
    padded to whole blocks (1 byte an element for both wire dtypes) and
    one fp32 scale a block. The fusion planner counts these against its
    threshold."""
    spec = parse(spec)
    blocks = -(-int(n_elements) // spec.block_size)
    return blocks * spec.block_size + blocks * SCALE_BYTES


def to_e4m3fn(x: torch.Tensor) -> torch.Tensor:
    """Cast a floating tensor to ``float8_e4m3fn`` as JAX does: round to
    nearest even, and NaN (of the input's sign) for whatever rounds past
    448, infinities included. ``Tensor.to`` saturates those to ±448."""
    q = x.to(torch.float8_e4m3fn)
    over = x.abs() > _E4M3_ROUNDS_PAST_MAX
    bits = q.view(torch.uint8)
    return torch.where(over, bits | 0x7F, bits).view(torch.float8_e4m3fn)


# The quiet NaN JAX writes when it widens an e4m3 NaN, by target dtype:
# (integer view, bits). Tensor.to keeps other payload bits, and drops
# the sign on the way to bfloat16.
_QUIET_NAN = {torch.float32: (torch.int32, 0x7FC00000),
              torch.bfloat16: (torch.int16, 0x7FC0),
              torch.float16: (torch.int16, 0x7E00),
              torch.float64: (torch.int64, 0x7FF8000000000000)}


def from_e4m3fn(q: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Widen ``float8_e4m3fn`` to ``dtype`` as JAX does: exact for
    numbers, a quiet NaN of the same sign for NaN."""
    out = q.to(dtype)
    ivt, nan_bits = _QUIET_NAN[dtype]
    sign_bit = -(1 << (8 * torch.empty((), dtype=ivt).element_size() - 1))
    bits = q.view(torch.uint8)
    nan = torch.where(bits >= 0x80, nan_bits | sign_bit, nan_bits).to(ivt)
    return torch.where((bits & 0x7F) == 0x7F, nan,
                       out.view(ivt)).view(dtype)


def _quantize(y: torch.Tensor, spec: WireSpec) -> torch.Tensor:
    if spec.wire_dtype == "int8":
        return torch.clamp(torch.round(y), -spec.qmax, spec.qmax).to(
            torch.int8)
    return to_e4m3fn(y)


def _absmax_scale(xb: torch.Tensor, spec: WireSpec,
                  folded: bool = False) -> torch.Tensor:
    """absmax / qmax of each block; ``folded``: times the fp32
    reciprocal of qmax, as the compiled program computes it."""
    absmax = xb.abs().amax(dim=-1, keepdim=True)
    # Divided by a tensor on absmax's device: CUDA turns a division by a
    # Python number into a multiply by its reciprocal.
    scale = (absmax * float(torch.tensor(1.0) / spec.qmax) if folded
             else absmax / absmax.new_full((), spec.qmax))
    # All-zero blocks (padding, dead gradients) keep scale 1, so the
    # dequantized block is exactly zero instead of 0/0.
    return torch.where(absmax > 0, scale, torch.ones_like(absmax))


def quantize_blocks(x: torch.Tensor, spec: WireSpec, folded: bool = False):
    """Flat fp32 ``x`` (length a multiple of block_size) -> (payload in
    the wire dtype, fp32 per-block scales). ``folded`` computes the
    scales as :func:`allreduce_blocks` does (see the module's note)."""
    xb = x.reshape(-1, spec.block_size)
    scale = _absmax_scale(xb, spec, folded)
    return _quantize(xb / scale, spec).reshape(-1), scale[:, 0]


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor,
                      spec: WireSpec) -> torch.Tensor:
    y = q.to(torch.float32).reshape(-1, spec.block_size) * scales[:, None]
    return y.reshape(-1)


def _to_transport(q: torch.Tensor, spec: WireSpec) -> torch.Tensor:
    """fp8 payloads cross the collectives as uint8; int8 crosses as it
    is. The same bytes either way."""
    return q if spec.wire_dtype == "int8" else q.view(torch.uint8)


def _from_transport(w: torch.Tensor, spec: WireSpec) -> torch.Tensor:
    return w if spec.wire_dtype == "int8" else w.view(torch.float8_e4m3fn)


def local_roundtrip(x: torch.Tensor, spec: Union[str, WireSpec]
                    ) -> torch.Tensor:
    """Quantize-dequantize ``x`` exactly as this rank's phase-1 wire
    contribution would be (flat, blocks from its first element). The
    error-feedback residual is ``x - local_roundtrip(x)``: what the wire
    dropped this step, for the next step to carry."""
    spec = parse(spec)
    n = x.numel()
    if n == 0:
        return x
    flat = x.reshape(-1).to(torch.float32)
    m = padded_size(n, spec.block_size)
    if m != n:
        flat = torch.cat([flat, flat.new_zeros(m - n)])
    q, s = quantize_blocks(flat, spec)
    out = dequantize_blocks(q, s, spec)[:n]
    return out.reshape(x.shape).to(x.dtype)


def channel_block(n: int, block: int) -> int:
    """Largest quantization chunk that divides ``n`` without exceeding
    ``block``: the wire's blocks clamped to a channel dimension (a KV
    head's head_dim is usually smaller than the default block)."""
    qb = min(int(block), int(n))
    while n % qb:
        qb -= 1
    return qb


def quantize_channels(x: torch.Tensor, spec: Union[str, WireSpec]):
    """Blockwise absmax quantization along the last axis of ``x``, in
    chunks of ``channel_block(x.shape[-1], spec.block_size)`` elements
    with one fp32 scale each, so blocks never straddle heads. Returns
    ``(payload, scales)``: the payload in the wire dtype and shaped like
    ``x``, the scales shaped ``x.shape[:-1] + (n_chunks,)``."""
    spec = parse(spec)
    n = x.shape[-1]
    qb = channel_block(n, spec.block_size)
    xb = x.to(torch.float32).reshape(*x.shape[:-1], n // qb, qb)
    scale = _absmax_scale(xb, spec)
    return _quantize(xb / scale, spec).reshape(x.shape), scale[..., 0]


def dequantize_channels(q: torch.Tensor, scales: torch.Tensor,
                        spec: Union[str, WireSpec]) -> torch.Tensor:
    """Inverse of :func:`quantize_channels`: fp32, shaped like ``q``."""
    parse(spec)   # validates; the arithmetic needs only the shapes
    qb = q.shape[-1] // scales.shape[-1]
    y = q.to(torch.float32).reshape(*scales.shape, qb) * scales[..., None]
    return y.reshape(q.shape)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 ``a * b + c`` rounded once. The fp64 product of two fp32
    values is exact; the fp64 sum is rounded to odd (its error from
    Knuth's two-sum says which way), so the rounding to fp32 is the only
    one that counts."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    v = s - p
    err = (p - (s - v)) + (c - v)
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0) \
        & torch.isfinite(s)
    toward = torch.copysign(torch.full_like(s, float("inf")), err)
    return torch.where(inexact_even, torch.nextafter(s, toward), s).float()


def allreduce_blocks(buf: torch.Tensor, spec: WireSpec, world: int,
                     all_to_all_fn: Callable[[torch.Tensor], torch.Tensor],
                     all_gather_fn: Callable[[torch.Tensor], torch.Tensor]
                     ) -> torch.Tensor:
    """Dual block-quantized sum of a flat fp32 buffer over ``world``
    ranks. ``buf``'s length must be a multiple of ``world *
    block_size`` (see :func:`padded_size`). ``all_to_all_fn`` sends the
    k-th of ``world`` equal chunks of a flat tensor to rank k and returns
    the chunks received, in rank order; ``all_gather_fn`` returns every
    rank's flat tensor concatenated in rank order. The result is the fp32
    sum over the ranks, carrying one quantization per phase."""
    bs = spec.block_size
    shard = buf.numel() // world
    # Phase 1: quantize locally, reduce-scatter in the wire domain.
    q, scales = quantize_blocks(buf, spec, folded=True)
    qr = all_to_all_fn(_to_transport(q, spec))
    sr = all_to_all_fn(scales)
    contrib = _from_transport(qr, spec).to(torch.float32).reshape(
        world, shard // bs, bs)
    sr = sr.reshape(world, shard // bs, 1)
    # fp32 dequantize-accumulate of every rank's contribution to this
    # shard: in rank order from zero, each product fused into its add.
    red = torch.zeros_like(contrib[0])
    for part, scale in zip(contrib, sr):
        red = _fma(part, scale, red)
    # Phase 2: requantize the reduced shard, all-gather in the wire domain.
    q2, s2 = quantize_blocks(red.reshape(shard), spec, folded=True)
    qg = all_gather_fn(_to_transport(q2, spec))
    sg = all_gather_fn(s2)
    return dequantize_blocks(_from_transport(qg, spec), sg, spec)


def axis_world(mesh: DeviceMesh, axis: str) -> int:
    """The size of ``mesh``'s axis ``axis``. NameError, as JAX raises
    for an axis that is not bound, when the mesh has no such axis."""
    if axis not in mesh.mesh_dim_names:
        raise NameError(f"unbound axis name: {axis}")
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _axis_collectives(mesh: DeviceMesh, axis: str, world: int):
    """:func:`allreduce_blocks`' all-to-all and all-gather over the
    axis's process group (the identity at one rank)."""
    if world == 1:
        return (lambda buf: buf), (lambda buf: buf)
    group = mesh.get_group(axis)
    nccl = dist.get_backend(group) == "nccl"

    def all_to_all(buf):
        out = torch.empty_like(buf)
        dist.all_to_all_single(out, buf, group=group)
        return out

    def all_gather(buf):
        if nccl:
            out = buf.new_empty(world * buf.numel())
            dist.all_gather_into_tensor(out, buf, group=group)
            return out
        parts = buf.new_empty((world,) + tuple(buf.shape))
        dist.all_gather(list(parts), buf, group=group)
        return parts.reshape(-1)

    return all_to_all, all_gather


def quantized_psum_many(tensors: Sequence[torch.Tensor], mesh: DeviceMesh,
                        axis: str, spec: Union[str, WireSpec]
                        ) -> List[torch.Tensor]:
    """:func:`quantized_psum` of each tensor in one dual quantized
    allreduce: each flat fp32 tensor padded to a multiple of ``world *
    block_size`` and the flats laid out chunk-major
    (``parallel.collectives.chunk_major``), so that every block and
    every rank's shard holds what the tensor's own call would."""
    spec = parse(spec)
    world = axis_world(mesh, axis)
    tensors = list(tensors)
    live = [i for i, t in enumerate(tensors) if t.numel()]
    if not live:
        return tensors
    flats = []
    for i in live:
        flat = tensors[i].reshape(-1).to(torch.float32)
        m = padded_size(flat.numel(), world * spec.block_size)
        flats.append(F.pad(flat, (0, m - flat.numel())))
    sizes = [f.numel() for f in flats]
    buf = chunk_major(flats, world).reshape(-1)
    out = allreduce_blocks(buf, spec, world,
                           *_axis_collectives(mesh, axis, world))
    result = list(tensors)
    for i, o in zip(live, split_chunk_major(out, sizes, world)):
        t = tensors[i]
        result[i] = o[:t.numel()].reshape(t.shape).to(t.dtype)
    return result


def quantized_psum(x: torch.Tensor, mesh: DeviceMesh, axis: str,
                   spec: Union[str, WireSpec]) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` through the dual block-quantized
    wire (:func:`allreduce_blocks` over the axis's group): the
    counterpart of JAX's ``quantized_psum`` inside ``shard_map``. NameError
    when the mesh has no such axis."""
    return quantized_psum_many([x], mesh, axis, spec)[0]
