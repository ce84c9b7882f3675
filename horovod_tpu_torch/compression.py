"""Gradient compression on the wire: the cast compressors.

Counterpart of the cast half of ``horovod_tpu/compression.py``.
``Compression.none`` passes tensors through; ``fp16`` and ``bf16`` cast
floating tensors to the wire dtype and back after the collective.
"""

from __future__ import annotations

import torch


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
            tensor = tensor.to(cls.wire_dtype)
        return tensor, ctx

    @classmethod
    def decompress(cls, tensor, ctx):
        if ctx is not None and tensor.dtype != ctx and ctx.is_floating_point:
            tensor = tensor.to(ctx)
        return tensor


class FP16Compressor(_CastCompressor):
    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    wire_dtype = torch.bfloat16


class Compression:
    """The compressors the port provides."""
    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
