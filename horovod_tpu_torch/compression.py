"""Gradient compression for the wire.

Port of ``horovod_tpu/jax/compression.py``: ``compress`` returns
``(tensor, ctx)`` and ``decompress`` restores the original dtype after the
collective. ``fp16`` and ``bf16`` cast floating tensors for the wire.
"""

from __future__ import annotations

import torch


class Compressor:
    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    """Identity."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    wire_dtype: torch.dtype

    @classmethod
    def compress(cls, tensor):
        dtype = tensor.dtype
        if dtype.is_floating_point and dtype != cls.wire_dtype:
            return tensor.to(cls.wire_dtype), dtype
        return tensor, None

    @classmethod
    def decompress(cls, tensor, ctx):
        if ctx is not None:
            return tensor.to(ctx)
        return tensor


class FP16Compressor(_CastCompressor):
    """Cast float tensors to fp16 for the wire."""

    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    """Cast float tensors to bfloat16 for the wire."""

    wire_dtype = torch.bfloat16


class Compression:
    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
