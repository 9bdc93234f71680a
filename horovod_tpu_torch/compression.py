"""Gradient compression for the wire, and the wire codecs' registry.

Port of ``horovod_tpu/jax/compression.py``: ``compress`` returns
``(tensor, ctx)`` and ``decompress`` restores the original dtype after the
collective. ``fp16`` and ``bf16`` cast floating tensors for the wire.

The wire codecs are the native core's lossy encodings of fp32 ring steps
(``core/src/codec.h``), which ``HVD_WIRE_CODEC`` and
``CoreSession.stage_wire_codec`` select: the port's copy of the table of
``horovod_tpu/common/compression.py:25-60``, which the device plane's
compressed ring (``ops/codec.py``) and the tests read.
"""

from __future__ import annotations

from typing import Optional

import torch

# WireCodecId values of core/src/codec.h.
CODEC_IDS = {"none": 0, "bf16": 1, "fp16": 2, "int8": 3}
CODEC_NAMES = {v: k for k, v in CODEC_IDS.items()}

# Worst-case allreduce tolerance per codec for fp32 payloads (every other
# dtype stays bit-exact under every codec): the encode error per ring hop
# is 2^-9 (bf16), 2^-11 (fp16) or maxabs/254 (int8), re-encoded at each
# of the n - 1 reduce-scatter hops, with headroom for np <= 8. ``rtol`` is
# relative to the reduced value; ``atol`` absorbs cancellation near zero.
WIRE_TOLERANCE = {
    "none": {"atol": 0.0, "rtol": 0.0},
    "bf16": {"atol": 1e-2, "rtol": 4e-2},
    "fp16": {"atol": 1e-3, "rtol": 5e-3},
    "int8": {"atol": 2e-1, "rtol": 6e-2},
}


def codec_id(codec) -> Optional[int]:
    """The codec id of a name or id (``"bf16"``, ``2``, ``"3"``); None for
    anything unknown, as the core's HVD_WIRE_CODEC parser
    (``core/src/codec.cc`` CodecFromName)."""
    if codec is None or isinstance(codec, bool):
        return None
    if isinstance(codec, int):
        return codec if codec in CODEC_NAMES else None
    name = str(codec).strip().lower()
    if name in CODEC_IDS:
        return CODEC_IDS[name]
    try:
        as_int = int(name, 10)
    except ValueError:
        return None
    return as_int if as_int in CODEC_NAMES else None


def codec_name(codec) -> Optional[str]:
    """Canonical name for a codec id or name; None when unknown."""
    cid = codec_id(codec)
    return CODEC_NAMES[cid] if cid is not None else None


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
