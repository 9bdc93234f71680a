"""Collectives over the ``torch.distributed`` process group.

Port of ``horovod_tpu/ops/collective_ops.py`` and of the eager API's
``broadcast``/``allgather``/``alltoall``/``reducescatter``
(``horovod_tpu/ops/eager.py``): the same op enum (values follow the
reference's order), pre- and postscale around the reduction, and Average
as a Sum followed by a division by the set's size (the reference's
``psum`` then ``/ n``). On the card the group is NCCL; on the CPU it is
gloo. A tensor that is not on the group's device (a host tensor under
NCCL, which cannot move one) crosses the wire through a copy there, and
the result comes back to the caller's device. Every collective takes a
registered process set and runs on its group over the set's ranks
(``common/process_sets.py``); Average divides by the set's size and
roots are global ranks.

Adasum (``parallel/adasum.py``) gathers the set's tensors and merges them
through the binary tree on every rank; its coefficients are per tensor,
so it never runs on a fused buffer: a group or a bucket under Adasum is
one collective per tensor.

The two-level ladder (``parallel/hierarchical.py``) is chosen by one
predicate, ``_route_hierarchical``, for ``allreduce``,
``grouped_allreduce``, ``bucketed_allreduce`` (and with it the
optimizer's buckets) and ``allgather``. It routes when all of these
hold, and otherwise the collective runs flat on the set's group:

* the op is Average or Sum (allgather counts as Sum);
* the set is the global set;
* HOROVOD_HIERARCHICAL_ALLREDUCE (HOROVOD_HIERARCHICAL_ALLGATHER for
  allgather) is set and not ``0``, read at each call;
* the ranks' layout has two levels, ``local_size() > 1`` and
  ``cross_size() > 1`` (``hierarchical.ladder()`` exists).

Under the ladder a tensor or a fused buffer of any length is padded to a
multiple of the node's size.

Every call into ``torch.distributed`` and every wait runs inside
``common/failure.py``'s ``mapped()``: when a peer is gone it raises
``HorovodInternalError``, which elastic recovery catches. Every
collective is issued async and waited through ``failure.wait``, so that
on gloo none blocks past the watch (ROADMAP C10); a count the host reads
(allgather's shapes, alltoall's splits) is ``settle``d and read through
``failure.host_read`` (C11). The calls stay synchronous to their
callers.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.common.failure import host_read, mapped, settle
from horovod_tpu_torch.common.failure import to_wire, wait
from horovod_tpu_torch.common.process_sets import global_process_set
from horovod_tpu_torch.common.process_sets import is_global
from horovod_tpu_torch.common.process_sets import member_group
from horovod_tpu_torch.common.process_sets import registered
from horovod_tpu_torch.parallel import bucketing
from horovod_tpu_torch.parallel import hierarchical
from horovod_tpu_torch.parallel import mesh
from horovod_tpu_torch.parallel.adasum import adasum_allreduce

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
    if op not in _OP_NAMES:
        raise ValueError("Unknown reduction op %r" % (op,))
    return member_group(process_set)


def _route_hierarchical(op, process_set, env_var) -> bool:
    """Whether a collective rides the two-level ladder (see the module's
    docstring): one predicate, so that no two paths can disagree."""
    return (op in (Average, Sum) and is_global(process_set)
            and os.environ.get(env_var, "") not in ("", "0")
            and hierarchical.ladder() is not None)


def plan_buckets(op, nbytes: Sequence[int], dtype_keys, bucket_bytes: int,
                 *, reverse: bool = True) -> List[bucketing.Bucket]:
    """``bucketing.assign_buckets``, except under Adasum, whose
    coefficients are per tensor: then every tensor is a bucket of its
    own, in the same (reverse) order."""
    if op != Adasum:
        return bucketing.assign_buckets(nbytes, dtype_keys, bucket_bytes,
                                        reverse=reverse)
    order = range(len(dtype_keys))
    return [bucketing.Bucket(dtype_keys[i], (i,), int(nbytes[i]))
            for i in (reversed(order) if reverse else order)]


def scale(x: torch.Tensor, factor: float) -> torch.Tensor:
    return x if factor == 1.0 else x * factor


def finish(x: torch.Tensor, op: int, postscale_factor: float, n: int
           ) -> torch.Tensor:
    """What follows the wire reduction: Average's ``/ n``, then postscale."""
    if op == Average:
        x = x / n
    return scale(x, postscale_factor)


def allreduce(tensor: torch.Tensor, op: int = Average, *,
              process_set=global_process_set,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0) -> torch.Tensor:
    """Allreduce ``tensor`` over the set's ranks; returns a new tensor."""
    group, n = _check(op, process_set)
    if op == Adasum:
        with mapped():
            out = adasum_allreduce(scale(tensor, prescale_factor),
                                   process_set)
        return scale(out, postscale_factor)
    out = tensor * prescale_factor if prescale_factor != 1.0 \
        else tensor.clone()
    with mapped():
        if _route_hierarchical(op, process_set,
                               "HOROVOD_HIERARCHICAL_ALLREDUCE"):
            out = hierarchical.ladder_sum(out.reshape(-1)).view(out.shape)
        else:
            wait(dist.all_reduce(out, op=_TORCH_OPS[op], group=group,
                                 async_op=True))
    return finish(out, op, postscale_factor, n)


class BucketFlight:
    """One fused bucket on the wire: pack, compress, prescale and launch an
    async ``all_reduce`` (or run the ladder, or Adasum on the bucket's one
    tensor); ``finish()`` waits, then Average's ``/ n``, postscale,
    decompress and unpack. Every fused collective goes through here."""

    def __init__(self, leaves: Sequence[torch.Tensor], op: int,
                 compression=Compression.none,
                 prescale_factor: float = 1.0,
                 process_set=global_process_set):
        self.leaves = list(leaves)
        group, self.n = member_group(process_set)
        if op == Adasum and len(self.leaves) != 1:
            raise ValueError("Adasum's coefficients are per tensor: a "
                             "bucket holds one tensor, not %d"
                             % len(self.leaves))
        wire, self.ctx = compression.compress(
            bucketing.pack_bucket(self.leaves))
        self.wire = scale(wire, prescale_factor)
        self.handle = None
        with mapped():
            if op == Adasum:
                self.wire = adasum_allreduce(self.wire, process_set)
            elif _route_hierarchical(op, process_set,
                                     "HOROVOD_HIERARCHICAL_ALLREDUCE"):
                self.wire = hierarchical.ladder_sum(self.wire)
            else:
                self.handle = dist.all_reduce(self.wire, op=_TORCH_OPS[op],
                                              group=group, async_op=True)

    def finish(self, op: int, compression=Compression.none,
               postscale_factor: float = 1.0) -> List[torch.Tensor]:
        with mapped():
            if self.handle is not None:
                wait(self.handle)
        out = finish(self.wire, op, postscale_factor, self.n)
        return bucketing.unpack_bucket(
            compression.decompress(out, self.ctx), self.leaves)


def bucketed_allreduce(tensors: Sequence[torch.Tensor], op: int,
                       bucket_bytes: int, *, reverse: bool = True,
                       compression=Compression.none,
                       prescale_factor: float = 1.0,
                       postscale_factor: float = 1.0,
                       process_set=global_process_set) -> List[torch.Tensor]:
    """Allreduce a list in per-dtype buckets capped at ``bucket_bytes``
    (``0`` = one bucket per dtype; under Adasum one per tensor). Every
    bucket is launched before the first is waited on. Returns new tensors
    in the input order."""
    tensors = list(tensors)
    buckets = plan_buckets(
        op, [t.numel() * t.element_size() for t in tensors],
        [t.dtype for t in tensors], bucket_bytes, reverse=reverse)
    flights = [(b, BucketFlight([tensors[i] for i in b.indices], op,
                                compression, prescale_factor, process_set))
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
    """Allreduce a list as one group: one fused buffer per dtype (under
    Adasum, one collective per tensor)."""
    _check(op, process_set)
    return bucketed_allreduce(tensors, op, 0, reverse=False,
                              prescale_factor=prescale_factor,
                              postscale_factor=postscale_factor,
                              process_set=process_set)


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
    device = group_device()
    dtype = torch.uint8 if tensor.dtype == torch.bool else tensor.dtype
    if tensor.device.type == "cpu" and device.type == "cuda":
        return to_wire(tensor.contiguous(), dtype, device)
    return tensor.to(device, dtype).contiguous()


def _like(out: torch.Tensor, tensor: torch.Tensor) -> torch.Tensor:
    """``out`` on the caller's device and dtype; a host tensor's result
    comes back from the card through a polled copy (C11)."""
    if out.device.type == "cuda" and tensor.device.type == "cpu":
        out = host_read(out)
    return out.to(tensor.device, tensor.dtype)


class BroadcastFlight:
    """One in-place broadcast on the wire: ``finish()`` waits and writes
    the root's value into the caller's tensor. ``root_rank`` is a global
    rank, a member of the set."""

    def __init__(self, tensor: torch.Tensor, root_rank: int,
                 process_set=global_process_set):
        group, _ = member_group(process_set)
        if root_rank not in registered(process_set).ranks:
            raise ValueError("broadcast root %d is not a rank of %r"
                             % (root_rank, registered(process_set)))
        self.tensor = tensor
        self.wire = _wire(tensor)
        with mapped():
            self.handle = dist.broadcast(self.wire, root_rank, group=group,
                                         async_op=True)

    def finish(self, host: bool = False) -> torch.Tensor:
        """Wait for the broadcast; with ``host``, until it has run on the
        card too (``failure.settle``), for a value the host reads next."""
        with mapped():
            (settle if host else wait)(self.handle)
        if self.wire is not self.tensor:
            self.tensor.copy_(self.wire)
        return self.tensor


def broadcast_(tensor: torch.Tensor, root_rank: int, *,
               process_set=global_process_set) -> torch.Tensor:
    """Overwrite ``tensor`` with ``root_rank``'s value, in place; returns
    it."""
    return BroadcastFlight(tensor, root_rank, process_set).finish()


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
    group, n = member_group(process_set)
    if tensor.dim() == 0:
        raise ValueError("allgather needs a tensor with a dim 0")
    wire = _wire(tensor)
    shape = to_wire(list(wire.shape), torch.int64, wire.device)
    shapes = [torch.empty_like(shape) for _ in range(n)]
    # The host reads the shapes: settle, then a polled copy (C11).
    with mapped():
        settle(dist.all_gather(shapes, shape, group=group, async_op=True))
        shapes = host_read(torch.stack(shapes)).tolist()
    if any(s[1:] != shapes[0][1:] for s in shapes):
        raise ValueError("allgather: tensors differ beyond dim 0: %s"
                         % shapes)
    rows = [s[0] for s in shapes]
    most = max(rows)
    if wire.shape[0] < most:
        wire = torch.cat([wire, wire.new_zeros(
            (most - wire.shape[0],) + wire.shape[1:])])
    with mapped():
        if _route_hierarchical(Sum, process_set,
                               "HOROVOD_HIERARCHICAL_ALLGATHER"):
            every = hierarchical.hierarchical_allgather(wire)
            parts = [every[k * most:(k + 1) * most] for k in range(n)]
        else:
            parts = [torch.empty_like(wire) for _ in range(n)]
            wait(dist.all_gather(parts, wire, group=group, async_op=True))
    return _like(torch.cat([part[:r] for part, r in zip(parts, rows)]),
                 tensor)


def alltoall(tensor: torch.Tensor, splits=None, *,
             process_set=global_process_set, split_axis=None,
             concat_axis=None):
    """Send rows of dim 0 to every rank and concatenate what arrives, in
    rank order. Returns ``(output, received_splits)``, as the reference's
    eager ``alltoall`` does.

    ``splits`` (one count per rank, summing to dim 0) says how many rows
    go to each rank; ``None`` sends equal shares, and then dim 0 must be a
    multiple of the set's size.

    With ``split_axis`` or ``concat_axis`` (each default 0 then) it is the
    reference's in-graph form instead: equal slices of ``split_axis`` to
    every rank, the slices received concatenated along ``concat_axis``;
    it returns the tensor alone and is differentiable
    (``parallel/mesh.py``'s ``all_to_all``)."""
    if split_axis is not None or concat_axis is not None:
        if splits is not None:
            raise ValueError("alltoall: splits are for the eager form; "
                             "the split_axis/concat_axis form is uniform")
        return mesh.all_to_all(tensor, split_axis or 0, concat_axis or 0,
                               process_set)
    group, n = member_group(process_set)
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
    sent = to_wire(splits, torch.int64, wire.device)
    got = torch.empty_like(sent)
    # The host reads the splits: settle, then a polled copy (C11).
    with mapped():
        settle(dist.all_to_all_single(got, sent, group=group,
                                      async_op=True))
        received = host_read(got).tolist()
    out = wire.new_empty((sum(received),) + wire.shape[1:])
    with mapped():
        wait(dist.all_to_all_single(out, wire, output_split_sizes=received,
                                    input_split_sizes=splits, group=group,
                                    async_op=True))
    return _like(out, tensor), torch.tensor(received, dtype=torch.int64)


def reducescatter(tensor: torch.Tensor, op: int = Sum, *,
                  process_set=global_process_set) -> torch.Tensor:
    """Reduce over every rank, then keep this rank's share of dim 0: rank
    r gets rows ``[r m, (r + 1) m)`` with ``m = dim 0 / size``. Sum or
    Average only."""
    group, n = member_group(process_set)
    if op not in (Average, Sum):
        raise ValueError("reducescatter supports Sum/Average, got %s"
                         % _OP_NAMES.get(op, op))
    if tensor.dim() == 0 or tensor.shape[0] % n:
        raise ValueError(
            "reducescatter dim 0 (shape %s) not divisible by group size %d"
            % (tuple(tensor.shape), n))
    wire = _wire(tensor)
    out = wire.new_empty((wire.shape[0] // n,) + wire.shape[1:])
    with mapped():
        wait(dist.reduce_scatter(out, list(wire.chunk(n)),
                                 op=dist.ReduceOp.SUM, group=group,
                                 async_op=True), polled=False)
    return _like(finish(out, op, 1.0, n), tensor)


def barrier(*, process_set=global_process_set) -> None:
    """Return once every rank of the set has called ``barrier``."""
    group, _ = member_group(process_set)
    with mapped():
        if dist.get_backend() == "nccl":
            wait(dist.barrier(group=group, async_op=True,
                              device_ids=[torch.cuda.current_device()]))
        else:
            wait(dist.barrier(group=group, async_op=True))
