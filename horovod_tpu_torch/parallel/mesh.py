"""Axis primitives of the port's sequence, MoE and pipeline modules.

Port of the parts of ``horovod_tpu/parallel/mesh.py`` that those modules
use. In the JAX package an axis is a named mesh axis: inside
``shard_map`` its size and this device's index along it are traced
values, and ``lax.ppermute`` / ``lax.all_to_all`` move data along it. In
the port an axis is a registered process set (``None`` is the global
set): its size and this rank's place in it, and the two exchanges
written over ``torch.distributed`` on the set's group as autograd
Functions. Their backward is the exchange JAX's transpose gives: the
inverse permutation, and the all_to_all with its two axes swapped.

Each rank runs its own backward, so every member must run the same
exchanges in the same order, forward and backward: an exchange whose
output a rank never uses must still be reachable from that rank's loss
(``parallel/pipeline.py`` ties such outputs to its result).

``make_mesh`` (a ``DeviceMesh``) comes with the planner (ROADMAP, Queue A
item 11).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch.common.process_sets import member_group
from horovod_tpu_torch.common.process_sets import registered

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"


def axis_size(process_set=None) -> int:
    """Members of ``process_set`` (default the global set): the port's
    ``traced_axis_size``. Raises unless the set is registered and holds
    this rank."""
    return member_group(process_set)[1]


def axis_index(process_set=None) -> int:
    """This rank's place in ``process_set``: the port's
    ``lax.axis_index``."""
    member_group(process_set)
    return registered(process_set).rank()


def _group_of(process_set):
    """``(group, global ranks, this rank's index)`` of a set that holds
    this rank."""
    group, _ = member_group(process_set)
    ps = registered(process_set)
    return group, list(ps.ranks), ps.rank()


def _ready_for_p2p(process_set, group) -> None:
    """Before the first send/recv on a set's group, a collective of all
    its members: NCCL requires it, so that no member's first use of the
    group is a send/recv the others do not join. The group the check was
    made for is kept on the set: a new ``init`` brings new groups."""
    ps = registered(process_set)
    key = group if group is not None else dist.group.WORLD
    if getattr(ps, "_p2p_group", None) is key:
        return
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    dist.all_reduce(torch.zeros(1, device=dev), group=group)
    ps._p2p_group = key


def _check_perm(perm, n) -> Tuple[Tuple[int, int], ...]:
    perm = tuple((int(s), int(d)) for s, d in perm)
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if any(not 0 <= i < n for i in srcs + dsts) or \
            len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError("ppermute: %r is not a partial permutation of "
                         "%d members" % (perm, n))
    return perm


def _permute(x, perm, process_set):
    """What ``lax.ppermute`` returns on this member: the tensor of the
    member that sends to it, zeros when none does."""
    group, ranks, me = _group_of(process_set)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    out = torch.zeros_like(x) if not src else torch.empty_like(x)
    x = x.contiguous()
    ops = []
    if dst and dst[0] != me:
        ops.append(dist.P2POp(dist.isend, x, ranks[dst[0]], group))
    if src and src[0] != me:
        ops.append(dist.P2POp(dist.irecv, out, ranks[src[0]], group))
    elif src:
        out.copy_(x)
    # Every member, with exchanges of its own or none.
    _ready_for_p2p(process_set, group)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, process_set):
        ctx.perm, ctx.process_set = perm, process_set
        return _permute(x, perm, process_set)

    @staticmethod
    def backward(ctx, grad):
        inverse = tuple((d, s) for s, d in ctx.perm)
        return _permute(grad, inverse, ctx.process_set), None, None


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]],
             process_set=None) -> torch.Tensor:
    """``lax.ppermute`` over a set: ``perm`` holds ``(source,
    destination)`` pairs of set ranks, each source and each destination
    at most once. Returns what this member receives, zeros if it
    receives from nobody. Every member calls it with the same ``perm``.
    Differentiable: the gradient travels the inverse permutation."""
    perm = _check_perm(perm, axis_size(process_set))
    return _PPermute.apply(x, perm, process_set)


def _exchange(x, split_axis, concat_axis, process_set):
    """``lax.all_to_all(x, split_axis, concat_axis, tiled=True)``: chunk
    j of ``split_axis`` goes to member j; the chunks received are
    concatenated along ``concat_axis`` in member order."""
    group, n = member_group(process_set)
    if x.shape[split_axis] % n:
        raise ValueError(
            "all_to_all: dim %d (size %d) is not divisible by the set's "
            "size %d" % (split_axis, x.shape[split_axis], n))
    if n == 1:
        return x.clone()
    send = x.movedim(split_axis, 0)
    send = send.reshape((n, send.shape[0] // n) + send.shape[1:])
    recv = torch.empty_like(send, memory_format=torch.contiguous_format)
    dist.all_to_all_single(recv, send.contiguous(), group=group)
    # recv[j] is member j's chunk, laid out as ``send[j]``: put its split
    # axis back, then member j's chunk in front of the concat axis.
    recv = recv.movedim(1, split_axis + 1).movedim(0, concat_axis)
    return recv.flatten(concat_axis, concat_axis + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, process_set):
        ctx.axes = (split_axis, concat_axis)
        ctx.process_set = process_set
        return _exchange(x, split_axis, concat_axis, process_set)

    @staticmethod
    def backward(ctx, grad):
        split_axis, concat_axis = ctx.axes
        return (_exchange(grad, concat_axis, split_axis, ctx.process_set),
                None, None, None)


def all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int,
               process_set=None) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)`` over a set: ``x.shape[
    split_axis]`` must divide by the set's size. Differentiable: the
    gradient takes the exchange with the two axes swapped."""
    split_axis %= x.dim()
    concat_axis %= x.dim()
    return _AllToAll.apply(x, split_axis, concat_axis, process_set)
