"""The device mesh, and the axis primitives of the port's sequence, MoE
and pipeline modules.

Port of ``horovod_tpu/parallel/mesh.py``. In the JAX package an axis is a
named mesh axis: inside ``shard_map`` its size and this device's index
along it are traced values, and ``lax.ppermute`` / ``lax.all_to_all``
move data along it. In the port an axis is a registered process set
(``None`` is the global set): its size and this rank's place in it, and
the two exchanges written over ``torch.distributed`` on the set's group
as autograd Functions. Their backward is the exchange JAX's transpose
gives: the inverse permutation, and the all_to_all with its two axes
swapped.

``make_mesh`` lays the world's ranks out as a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
order, and gives each axis the port's process sets for its rank groups
(``axis_set``), so that the collectives, ``all_to_all``, ``ppermute`` and
the bucketed optimizer run over an axis; an axis name is accepted
wherever a process set is, in this module. Torch has no
``NamedSharding``: ``data_sharding`` and ``replicated`` return the
DTensor placements of the mesh's dims.

Each rank runs its own backward, so every member must run the same
exchanges in the same order, forward and backward: an exchange whose
output a rank never uses must still be reachable from that rank's loss
(``parallel/pipeline.py`` ties such outputs to its result).
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common import process_sets
from horovod_tpu_torch.common.failure import mapped, wait
from horovod_tpu_torch.common.process_sets import member_group
from horovod_tpu_torch.common.process_sets import registered

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"

# Outer-to-inner mesh order, the reference's (``_STANDARD_ORDER``): the
# hierarchical factorization of the data axis (``data_dcn`` x
# ``data_ici``) sits in the data slot, dcn outermost, so that the inner,
# most communication-intensive axes land on neighbouring ranks (one
# node's NVLink) and a node boundary falls between ``data_dcn`` groups.
_STANDARD_ORDER = (PIPE_AXIS, "data_dcn", "data_ici", DATA_AXIS,
                   EXPERT_AXIS, SEQ_AXIS, MODEL_AXIS)

_lock = threading.Lock()
_global_mesh = None


def _axis_groups(ranks, names, shape, axis: str):
    """The rank groups along ``axis``: the ranks that share every other
    coordinate, each group in ascending coordinate order, the groups in
    order of their first rank's position."""
    grid = torch.as_tensor(ranks).reshape(shape)
    dim = names.index(axis)
    rows = grid.movedim(dim, -1).reshape(-1, shape[dim])
    return [[int(r) for r in row] for row in rows]


def _set_of(ranks):
    """The registered process set over ``ranks``: the global set for the
    whole world, a set already registered over the same ranks, or a new
    one (every rank calls this for every group, in the same order)."""
    ranks = sorted(ranks)
    if ranks == list(range(basics.size())):
        return process_sets.global_process_set
    for ps_id in process_sets.get_process_set_ids():
        ps = process_sets.get_process_set(ps_id)
        if ps_id and list(ps.ranks) == ranks:
            return ps
    return process_sets.add_process_set(ranks)


def make_mesh(axis_sizes: Optional[Dict[str, int]] = None, *,
              ranks: Optional[Sequence[int]] = None):
    """Build a ``DeviceMesh`` over ``ranks`` (default: every rank of the
    world, one card each), after ``init``.

    ``axis_sizes`` maps axis name -> size; a single ``-1`` entry is
    inferred from the rank count. With no argument, a 1-D ``data`` mesh:
    the plain data-parallel layout. Axes are laid out pipe, data_dcn,
    data_ici, data, expert, seq, model (outer to inner); axes not named
    are omitted, custom axes come last. The same ``ValueError``s as the
    reference's. Every rank calls it, in the same order: each axis's
    rank groups become registered process sets (``axis_set``)."""
    basics._require()
    devs = list(ranks) if ranks is not None else list(range(basics.size()))
    n = len(devs)
    if not axis_sizes:
        axis_sizes = {DATA_AXIS: n}
    axis_sizes = dict(axis_sizes)

    infer = [k for k, v in axis_sizes.items() if v == -1]
    if len(infer) > 1:
        raise ValueError("At most one axis size may be -1, got %r"
                         % (axis_sizes,))
    known = math.prod(v for v in axis_sizes.values() if v != -1)
    if infer:
        if n % known:
            raise ValueError(
                "Cannot infer axis %r: %d devices not divisible by %d"
                % (infer[0], n, known)
            )
        axis_sizes[infer[0]] = n // known
    if math.prod(axis_sizes.values()) != n:
        raise ValueError(
            "Mesh axes %r multiply to %d but %d devices are available"
            % (axis_sizes, math.prod(axis_sizes.values()), n)
        )

    names = [a for a in _STANDARD_ORDER if a in axis_sizes]
    names += [a for a in axis_sizes if a not in names]  # custom axes last
    shape = [axis_sizes[a] for a in names]
    from torch.distributed.device_mesh import DeviceMesh

    device_type = "cuda" if basics.init_device().startswith("cuda") \
        else "cpu"
    mesh = DeviceMesh(device_type, torch.as_tensor(devs).reshape(shape),
                      mesh_dim_names=tuple(names))
    sets = {}
    for axis in names:
        for group in _axis_groups(devs, names, shape, axis):
            ps = _set_of(group)
            if basics.rank() in group:
                sets[axis] = ps
    mesh._hvd_axis_sets = sets
    return mesh


def set_global_mesh(mesh) -> None:
    """Install the process-wide default mesh, which ``axis_size`` and
    ``axis_set`` read when no mesh is passed (``None`` clears it)."""
    global _global_mesh
    with _lock:
        _global_mesh = mesh


def global_mesh():
    """The installed global mesh, creating a default 1-D data mesh on
    first use."""
    global _global_mesh
    with _lock:
        if _global_mesh is None:
            _global_mesh = make_mesh()
        return _global_mesh


def installed_mesh():
    """The installed global mesh, or None: unlike ``global_mesh`` it
    creates none."""
    with _lock:
        return _global_mesh


def reset_global_mesh() -> None:
    set_global_mesh(None)


def mesh_shape(mesh=None) -> Dict[str, int]:
    """``{axis: size}`` in the mesh's order: jax's ``Mesh.shape``."""
    mesh = mesh or global_mesh()
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def data_sharding(mesh=None, *ranked_axes):
    """The DTensor placements of a batch sharded on its leading dim over
    ``data``: one per mesh dim, ``Shard(0)`` on ``data``, ``Shard(1 + i)``
    on the i-th of ``ranked_axes``, ``Replicate()`` elsewhere (the
    reference's ``NamedSharding(mesh, P("data", *ranked_axes))``)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = mesh or global_mesh()
    dims = (DATA_AXIS,) + tuple(ranked_axes)
    return tuple(Shard(dims.index(a)) if a in dims else Replicate()
                 for a in mesh.mesh_dim_names)


def replicated(mesh=None):
    """``Replicate()`` on every mesh dim (the reference's ``P()``)."""
    from torch.distributed.tensor import Replicate

    mesh = mesh or global_mesh()
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def axis_set(axis: str, mesh=None):
    """This rank's process set along ``axis`` of ``mesh`` (default the
    global mesh): the ranks that share its other coordinates."""
    mesh = mesh or global_mesh()
    sets = getattr(mesh, "_hvd_axis_sets", {})
    if axis not in sets:
        raise ValueError("the mesh %r has no axis %r (made by make_mesh?)"
                         % (mesh, axis))
    return sets[axis]


def _as_set(axis, mesh=None):
    """A process set, or the set of an axis named by a string."""
    return axis_set(axis, mesh) if isinstance(axis, str) else axis


def axis_size(process_set=None, mesh=None) -> int:
    """Members of ``process_set`` (default the global set): the port's
    ``traced_axis_size``. Raises unless the set is registered and holds
    this rank. An axis name gives the reference's ``axis_size(axis,
    mesh)`` instead: its size on ``mesh`` (default the global mesh), 1
    for an axis the mesh lacks."""
    if isinstance(process_set, str):
        return mesh_shape(mesh).get(process_set, 1)
    return member_group(process_set)[1]


def axis_index(process_set=None, mesh=None) -> int:
    """This rank's place in ``process_set`` (or along the named axis of
    ``mesh``): the port's ``lax.axis_index``."""
    process_set = _as_set(process_set, mesh)
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
    with mapped():
        wait(dist.all_reduce(torch.zeros(1, device=dev), group=group,
                             async_op=True))
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
        with mapped():
            for work in dist.batch_isend_irecv(ops):
                wait(work, polled=False)
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
    process_set = _as_set(process_set)
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
    with mapped():
        wait(dist.all_to_all_single(recv, send.contiguous(), group=group,
                                    async_op=True))
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
    return _AllToAll.apply(x, split_axis, concat_axis, _as_set(process_set))
