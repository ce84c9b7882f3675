"""Gradient compression on the wire.

Counterpart of ``horovod_tpu/compression.py``. ``Compression.none``
passes tensors through; ``fp16``, ``bf16`` and ``fp8`` cast floating
tensors to the wire dtype and back after the collective.

``Compression.int8_blockwise`` and ``fp8_blockwise`` select the
block-scaled quantized wire (``quantization.py``). They do not transform
the tensor: the engine quantizes inside the fused collective, keyed off
``wire_spec``, so these compressors pass the tensor through, restore
its dtype, and give :meth:`local_roundtrip` for error-feedback
residuals.
"""

from __future__ import annotations

import torch

from . import quantization as _quant


class Compressor:
    """Interface for compressing/decompressing around a collective."""

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    wire_dtype: torch.dtype = None

    @classmethod
    def compress(cls, tensor):
        ctx = tensor.dtype
        if tensor.is_floating_point():
            tensor = cls._cast(tensor)
        return tensor, ctx

    @classmethod
    def _cast(cls, tensor):
        return tensor.to(cls.wire_dtype)

    @classmethod
    def decompress(cls, tensor, ctx):
        if ctx is not None and tensor.dtype != ctx and ctx.is_floating_point:
            tensor = tensor.to(ctx)
        return tensor


class FP16Compressor(_CastCompressor):
    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    wire_dtype = torch.bfloat16


class FP8Compressor(_CastCompressor):
    """float8_e4m3fn wire, unscaled: what rounds past ±448 (and ±inf)
    becomes NaN, as JAX's cast gives, where ``Tensor.to`` would
    saturate."""
    wire_dtype = torch.float8_e4m3fn

    @classmethod
    def _cast(cls, tensor):
        return _quant.to_e4m3fn(tensor)

    @classmethod
    def decompress(cls, tensor, ctx):
        if ctx is not None and tensor.dtype != ctx and ctx.is_floating_point:
            tensor = _quant.from_e4m3fn(tensor, ctx)
        return tensor


class _BlockwiseCompressor(Compressor):
    """Block-scaled quantized wire (``quantization.py``), executed by the
    engine inside the fused collective."""

    wire_spec: str = None   # "int8x256" / "fp8x256"

    @classmethod
    def compress(cls, tensor):
        return tensor, tensor.dtype

    @classmethod
    def decompress(cls, tensor, ctx):
        if ctx is not None and tensor.dtype != ctx and ctx.is_floating_point:
            tensor = tensor.to(ctx)
        return tensor

    @classmethod
    def local_roundtrip(cls, tensor):
        """This rank's phase-1 wire contribution of ``tensor``."""
        return _quant.local_roundtrip(tensor, cls.wire_spec)


class Int8BlockwiseCompressor(_BlockwiseCompressor):
    """Absmax-scaled int8 blocks of 256 elements."""
    wire_spec = "int8x256"


class FP8BlockwiseCompressor(_BlockwiseCompressor):
    """Absmax-scaled e4m3 blocks of 256 elements."""
    wire_spec = "fp8x256"


class Compression:
    """The compressors the port provides."""
    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    fp8 = FP8Compressor
    int8_blockwise = Int8BlockwiseCompressor
    fp8_blockwise = FP8BlockwiseCompressor
