"""Collectives over the ``torch.distributed`` process group.

Port of ``horovod_tpu/ops/collective_ops.py`` and of the eager API's
``broadcast``/``allgather``/``alltoall``/``reducescatter``
(``horovod_tpu/ops/eager.py``): the same op enum (values follow the
reference's order), pre- and postscale around the reduction, and Average
as a Sum followed by a division by the set's size (the reference's
``psum`` then ``/ n``). On the card the group is NCCL; on the CPU it is
gloo. A tensor that is not on the group's device (a host tensor under
NCCL, which cannot move one) crosses the wire through a copy there, and
the result comes back to the caller's device. Adasum and process sets
other than the global one are not ported yet (ROADMAP, Queue A items 1
and 9).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

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


def _check_set(process_set):
    if not is_global(process_set):
        raise NotImplementedError(
            "only the global process set is ported (ROADMAP, Queue A "
            "item 1)")


def _check(op, process_set):
    if op == Adasum:
        raise NotImplementedError(
            "Adasum is not ported yet (ROADMAP, Queue A item 9)")
    if op not in _TORCH_OPS:
        raise ValueError("Unknown reduction op %r" % (op,))
    _check_set(process_set)


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


# ------------------------------------------- broadcast, gather, scatter ---


def group_device() -> torch.device:
    """Where the group's wire tensors live: the current card under NCCL,
    the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _wire(tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` as the backend can send it: contiguous, on the group's
    device, bool as uint8. The tensor itself when it already is."""
    wire = tensor.to(group_device(), torch.uint8
                     if tensor.dtype == torch.bool else tensor.dtype)
    return wire.contiguous()


def _like(out: torch.Tensor, tensor: torch.Tensor) -> torch.Tensor:
    return out.to(tensor.device, tensor.dtype)


def _check_root(root_rank: int) -> None:
    if not 0 <= root_rank < basics.size():
        raise ValueError("broadcast root %d is not a rank of a world of %d"
                         % (root_rank, basics.size()))


class BroadcastFlight:
    """One in-place broadcast on the wire: ``finish()`` waits and writes
    the root's value into the caller's tensor."""

    def __init__(self, tensor: torch.Tensor, root_rank: int):
        _check_root(root_rank)
        self.tensor = tensor
        self.wire = _wire(tensor)
        self.handle = dist.broadcast(self.wire, root_rank, async_op=True)

    def finish(self) -> torch.Tensor:
        self.handle.wait()
        if self.wire is not self.tensor:
            self.tensor.copy_(self.wire)
        return self.tensor


def broadcast_(tensor: torch.Tensor, root_rank: int, *,
               process_set=global_process_set) -> torch.Tensor:
    """Overwrite ``tensor`` with ``root_rank``'s value, in place; returns
    it."""
    _check_set(process_set)
    return BroadcastFlight(tensor, root_rank).finish()


def broadcast(tensor: torch.Tensor, root_rank: int, *,
              process_set=global_process_set) -> torch.Tensor:
    """``root_rank``'s value of ``tensor``, as a new tensor."""
    return broadcast_(tensor.clone(), root_rank, process_set=process_set)


def allgather(tensor: torch.Tensor, *,
              process_set=global_process_set) -> torch.Tensor:
    """Every rank's ``tensor``, concatenated along dim 0 in rank order.

    Dim 0 may differ between ranks, as in the reference's eager path: the
    shapes are exchanged first, then each rank sends its rows padded to
    the longest and the padding is cut out of the result. The other dims
    must agree."""
    _check_set(process_set)
    if tensor.dim() == 0:
        raise ValueError("allgather needs a tensor with a dim 0")
    n = basics.size()
    wire = _wire(tensor)
    shape = torch.tensor(wire.shape, dtype=torch.int64, device=wire.device)
    shapes = [torch.empty_like(shape) for _ in range(n)]
    dist.all_gather(shapes, shape)
    shapes = [s.tolist() for s in shapes]
    if any(s[1:] != shapes[0][1:] for s in shapes):
        raise ValueError("allgather: tensors differ beyond dim 0: %s"
                         % shapes)
    rows = [s[0] for s in shapes]
    most = max(rows)
    if wire.shape[0] < most:
        wire = torch.cat([wire, wire.new_zeros(
            (most - wire.shape[0],) + wire.shape[1:])])
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire)
    return _like(torch.cat([part[:r] for part, r in zip(parts, rows)]),
                 tensor)


def alltoall(tensor: torch.Tensor, splits=None, *,
             process_set=global_process_set
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Send rows of dim 0 to every rank and concatenate what arrives, in
    rank order. Returns ``(output, received_splits)``, as the reference's
    eager ``alltoall`` does.

    ``splits`` (one count per rank, summing to dim 0) says how many rows
    go to each rank; ``None`` sends equal shares, and then dim 0 must be a
    multiple of the world size."""
    _check_set(process_set)
    n = basics.size()
    if tensor.dim() == 0:
        raise ValueError("alltoall needs a tensor with a dim 0")
    rows = tensor.shape[0]
    if splits is None:
        if rows % n:
            raise ValueError(
                "alltoall split dim 0 (size %d) not divisible by group size "
                "%d" % (rows, n))
        splits = [rows // n] * n
    else:
        splits = [int(s) for s in (splits.tolist()
                                   if isinstance(splits, torch.Tensor)
                                   else splits)]
        if len(splits) != n or min(splits) < 0 or sum(splits) != rows:
            raise ValueError(
                "alltoall splits %s must be %d counts >= 0 summing to dim 0 "
                "(%d)" % (splits, n, rows))
    wire = _wire(tensor)
    sent = torch.tensor(splits, dtype=torch.int64, device=wire.device)
    got = torch.empty_like(sent)
    dist.all_to_all_single(got, sent)
    received = got.tolist()
    out = wire.new_empty((sum(received),) + wire.shape[1:])
    dist.all_to_all_single(out, wire, output_split_sizes=received,
                           input_split_sizes=splits)
    return _like(out, tensor), torch.tensor(received, dtype=torch.int64)


def reducescatter(tensor: torch.Tensor, op: int = Sum, *,
                  process_set=global_process_set) -> torch.Tensor:
    """Reduce over every rank, then keep this rank's share of dim 0: rank
    r gets rows ``[r m, (r + 1) m)`` with ``m = dim 0 / size``. Sum or
    Average only."""
    _check_set(process_set)
    if op not in (Average, Sum):
        raise ValueError("reducescatter supports Sum/Average, got %s"
                         % _OP_NAMES.get(op, op))
    n = basics.size()
    if tensor.dim() == 0 or tensor.shape[0] % n:
        raise ValueError(
            "reducescatter dim 0 (shape %s) not divisible by group size %d"
            % (tuple(tensor.shape), n))
    wire = _wire(tensor)
    out = wire.new_empty((wire.shape[0] // n,) + wire.shape[1:])
    dist.reduce_scatter(out, list(wire.chunk(n)), op=dist.ReduceOp.SUM)
    return _like(finish(out, op, 1.0), tensor)


def barrier(*, process_set=global_process_set) -> None:
    """Return once every rank has called ``barrier``."""
    _check_set(process_set)
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
