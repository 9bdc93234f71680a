"""Hierarchical (two-level) collectives: within a node, then across nodes.

Port of ``horovod_tpu/parallel/hierarchical.py`` (reference:
horovod/common/ops/nccl_operations.cc:233-440, NCCLHierarchicalAllreduce:
a reduce-scatter inside the node, an allreduce across nodes, an
all-gather inside the node; toggled by HOROVOD_HIERARCHICAL_ALLREDUCE).
Only ``1 / local_size`` of the bytes cross the slow links between nodes.

The JAX package's two mesh axes ``(dcn, ici)`` become two families of
process groups, built once by ``build`` at ``init`` from every rank's
allgathered ``(local_rank, cross_rank)``: one local group per node (its
ranks in ascending order) and one cross group per position in a node
(the ranks at that position of every node). Every rank creates every
group, in the same order. The ladder exists when there are at least two
nodes, each with the same number (at least two) of ranks; otherwise
``ladder()`` is None and every collective runs flat.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch.common.failure import wait
from horovod_tpu_torch.parallel import bucketing

_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


class Ladder(NamedTuple):
    """This rank's groups of the two-level layout.

    ``local_size`` ranks per node, ``cross_size`` nodes; ``order`` is the
    global rank of each block that ``hierarchical_allgather`` returns on
    this rank, in the order it returns them."""

    local_group: object
    cross_group: object
    local_size: int
    cross_size: int
    order: List[int]


_ladder: Optional[Ladder] = None

# The reference's names of the two levels as mesh axes.
ICI_AXIS = "data_ici"
DCN_AXIS = "data_dcn"


def make_hierarchical_axes(ici_size: int, dcn_size: int) -> Dict[str, int]:
    """Axis spec for ``make_mesh``: the data dimension factored into
    ``data_dcn`` (across nodes) outside ``data_ici`` (within a node), so
    that a ``data_ici`` group is one node's neighbouring ranks."""
    return {DCN_AXIS: dcn_size, ICI_AXIS: ici_size}


def ladder() -> Optional[Ladder]:
    """The groups built at ``init``, or None when the layout has no two
    levels (one node, or one rank per node, or unequal nodes)."""
    return _ladder


def build(coords: Sequence[Sequence[int]], my_rank: int) -> None:
    """Build the ladder from every rank's ``(local_rank, cross_rank)``,
    indexed by global rank. Every rank calls it with the same
    ``coords``, after the default process group exists."""
    global _ladder
    _ladder = None
    nodes = sorted({c for _, c in coords})
    members = {c: sorted(r for r, (_, cc) in enumerate(coords) if cc == c)
               for c in nodes}
    width = len(members[nodes[0]])
    if len(nodes) < 2 or width < 2 or any(
            len(m) != width for m in members.values()):
        return
    pos = local = cross = None
    for c in nodes:
        group = dist.new_group(members[c])
        if my_rank in members[c]:
            pos, local = members[c].index(my_rank), group
    for p in range(width):
        group = dist.new_group([members[c][p] for c in nodes])
        if p == pos:
            cross = group
    # The cross group orders the nodes by the rank of their member at
    # this position (groups order their ranks ascending).
    heads = sorted(members[c][pos] for c in nodes)
    node_of = {members[c][pos]: c for c in nodes}
    order = [r for h in heads for r in members[node_of[h]]]
    _ladder = Ladder(local, cross, width, len(nodes), order)


def reset() -> None:
    global _ladder
    _ladder = None


def _need() -> Ladder:
    if _ladder is None:
        raise RuntimeError("no two-level layout: the hierarchical "
                           "collectives need at least two nodes of equal "
                           "size, each with two ranks or more")
    return _ladder


def hierarchical_allreduce(x: torch.Tensor, *, average: bool = True
                           ) -> torch.Tensor:
    """Two-level allreduce: reduce-scatter of dim 0 in the node,
    allreduce of the shard across nodes, all-gather in the node; then
    Average's ``/ n``. ``x.shape[0]`` must be a multiple of the node's
    size. Returns a new tensor."""
    lad = _need()
    x = x.contiguous()
    if x.dim() == 0 or x.shape[0] % lad.local_size:
        raise ValueError("hierarchical_allreduce: dim 0 (shape %s) is not a "
                         "multiple of the node's %d ranks"
                         % (tuple(x.shape), lad.local_size))
    shard = x.new_empty((x.shape[0] // lad.local_size,) + x.shape[1:])
    wait(_reduce_scatter(shard, x, group=lad.local_group, async_op=True),
         polled=False)
    wait(dist.all_reduce(shard, group=lad.cross_group, async_op=True))
    out = torch.empty_like(x)
    wait(_all_gather(out, shard, group=lad.local_group, async_op=True))
    if average:
        out = out / (lad.local_size * lad.cross_size)
    return out


def ladder_sum(flat: torch.Tensor) -> torch.Tensor:
    """The ladder's sum of a 1-D buffer of any length: padded with zeros
    to a multiple of the node's size, then cut back."""
    n = flat.numel()
    pad = -n % _need().local_size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return hierarchical_allreduce(flat, average=False)[:n]


def grouped_hierarchical_allreduce(xs: Sequence[torch.Tensor], *,
                                   average: bool = True
                                   ) -> List[torch.Tensor]:
    """Two-level allreduce of a tensor group: one buffer per dtype
    (``bucketing.assign_buckets`` with no cap, in order), padded to a
    multiple of the node's size, through the ladder once per buffer.
    Returns new tensors in the input order."""
    xs = list(xs)
    out: List[Optional[torch.Tensor]] = [None] * len(xs)
    buckets = bucketing.assign_buckets(
        [x.numel() * x.element_size() for x in xs], [x.dtype for x in xs],
        0, reverse=False)
    n = _need().local_size * _need().cross_size
    for bucket in buckets:
        leaves = [xs[i] for i in bucket.indices]
        reduced = ladder_sum(bucketing.pack_bucket(leaves))
        if average:
            reduced = reduced / n
        for i, o in zip(bucket.indices,
                        bucketing.unpack_bucket(reduced, leaves)):
            out[i] = o
    return out


def hierarchical_allgather(x: torch.Tensor) -> torch.Tensor:
    """Two-level allgather of equal-shaped tensors along dim 0: gather in
    the node, then across nodes; the blocks come back in global rank
    order."""
    lad = _need()
    x = x.contiguous()
    intra = x.new_empty((x.shape[0] * lad.local_size,) + x.shape[1:])
    wait(_all_gather(intra, x, group=lad.local_group, async_op=True))
    every = x.new_empty((intra.shape[0] * lad.cross_size,) + x.shape[1:])
    wait(_all_gather(every, intra, group=lad.cross_group, async_op=True))
    if lad.order == sorted(lad.order):
        return every
    m = x.shape[0]
    at = {r: k for k, r in enumerate(lad.order)}
    return torch.cat([every[at[r] * m:(at[r] + 1) * m]
                      for r in sorted(lad.order)])
