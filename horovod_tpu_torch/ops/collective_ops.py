"""Collectives over the ``torch.distributed`` process group.

Port of ``horovod_tpu/ops/collective_ops.py``: the same op enum (values
follow the reference's order), pre- and postscale around the reduction,
and Average as a Sum followed by a division by the set's size (the
reference's ``psum`` then ``/ n``). On the card the group is NCCL; on the
CPU it is gloo. Adasum and process sets other than the global one are
not ported yet (ROADMAP, Queue A items 1 and 9).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.common.process_sets import global_process_set
from horovod_tpu_torch.common.process_sets import is_global
from horovod_tpu_torch.parallel import bucketing

Average = 0
Sum = 1
Adasum = 2
Min = 3
Max = 4
Product = 5

_OP_NAMES = {Average: "Average", Sum: "Sum", Adasum: "Adasum",
             Min: "Min", Max: "Max", Product: "Product"}
_TORCH_OPS = {Average: dist.ReduceOp.SUM, Sum: dist.ReduceOp.SUM,
              Min: dist.ReduceOp.MIN, Max: dist.ReduceOp.MAX,
              Product: dist.ReduceOp.PRODUCT}


def _check(op, process_set):
    if op == Adasum:
        raise NotImplementedError(
            "Adasum is not ported yet (ROADMAP, Queue A item 9)")
    if op not in _TORCH_OPS:
        raise ValueError("Unknown reduction op %r" % (op,))
    if not is_global(process_set):
        raise NotImplementedError(
            "only the global process set is ported (ROADMAP, Queue A "
            "item 1)")


def scale(x: torch.Tensor, factor: float) -> torch.Tensor:
    return x if factor == 1.0 else x * factor


def finish(x: torch.Tensor, op: int, postscale_factor: float
           ) -> torch.Tensor:
    """What follows the wire reduction: Average's ``/ n``, then postscale."""
    if op == Average:
        x = x / basics.size()
    return scale(x, postscale_factor)


def allreduce(tensor: torch.Tensor, op: int = Average, *,
              process_set=global_process_set,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0) -> torch.Tensor:
    """Allreduce ``tensor`` over every rank; returns a new tensor."""
    _check(op, process_set)
    out = tensor * prescale_factor if prescale_factor != 1.0 \
        else tensor.clone()
    dist.all_reduce(out, op=_TORCH_OPS[op])
    return finish(out, op, postscale_factor)


class BucketFlight:
    """One fused bucket on the wire: pack, compress, prescale and launch an
    async ``all_reduce``; ``finish()`` waits, then Average's ``/ n``,
    postscale, decompress and unpack. Every fused collective goes through
    here."""

    def __init__(self, leaves: Sequence[torch.Tensor], op: int,
                 compression=Compression.none,
                 prescale_factor: float = 1.0):
        self.leaves = list(leaves)
        wire, self.ctx = compression.compress(
            bucketing.pack_bucket(self.leaves))
        self.wire = scale(wire, prescale_factor)
        self.handle = dist.all_reduce(self.wire, op=_TORCH_OPS[op],
                                      async_op=True)

    def finish(self, op: int, compression=Compression.none,
               postscale_factor: float = 1.0) -> List[torch.Tensor]:
        self.handle.wait()
        out = finish(self.wire, op, postscale_factor)
        return bucketing.unpack_bucket(
            compression.decompress(out, self.ctx), self.leaves)


def bucketed_allreduce(tensors: Sequence[torch.Tensor], op: int,
                       bucket_bytes: int, *, reverse: bool = True,
                       compression=Compression.none,
                       prescale_factor: float = 1.0,
                       postscale_factor: float = 1.0) -> List[torch.Tensor]:
    """Allreduce a list in per-dtype buckets capped at ``bucket_bytes``
    (``0`` = one bucket per dtype). Every bucket is launched before the
    first is waited on. Returns new tensors in the input order."""
    tensors = list(tensors)
    buckets = bucketing.assign_buckets(
        [t.numel() * t.element_size() for t in tensors],
        [t.dtype for t in tensors], bucket_bytes, reverse=reverse)
    flights = [(b, BucketFlight([tensors[i] for i in b.indices], op,
                                compression, prescale_factor))
               for b in buckets]
    outs = [None] * len(tensors)
    for b, flight in flights:
        for i, out in zip(b.indices, flight.finish(op, compression,
                                                   postscale_factor)):
            outs[i] = out
    return outs


def grouped_allreduce(tensors: Sequence[torch.Tensor], op: int = Average,
                      *, process_set=global_process_set,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0) -> List[torch.Tensor]:
    """Allreduce a list as one group: one fused buffer per dtype."""
    _check(op, process_set)
    return bucketed_allreduce(tensors, op, 0, reverse=False,
                              prescale_factor=prescale_factor,
                              postscale_factor=postscale_factor)
