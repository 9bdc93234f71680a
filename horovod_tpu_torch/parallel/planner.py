"""One cost-model-driven sharding planner over the port's parallel stack.

Port of ``horovod_tpu/parallel/planner.py``. ``plan()`` takes a workload
description (an ``nn.Module`` or a dict of tensors, or a byte count, with
the batch/seq/model dims and optional MoE/pipeline counts) and a device
topology (the device count with its NVLink x InfiniBand factorization,
``costmodel.Topology``) and returns a :class:`Plan`: the mesh axes, each
parameter's spec, and the gradient-sync strategy (flat allreduce, or the
two-level ladder of ``parallel/hierarchical.py``). Every legal
factorization is scored by ``parallel/costmodel.py``; the choice, the
costs, the reasons and the report are the reference's, text for text.

Against the reference:

- ``Plan.apply()`` builds the mesh as a ``DeviceMesh`` over the world's
  ranks (``parallel/mesh.make_mesh``) and installs it; it sets or clears
  HOROVOD_HIERARCHICAL_ALLREDUCE, which arms the port's ladder;
- ``Plan.optimizer(inner)`` wraps a ``torch.optim`` optimizer in the
  port's bucketed ``DistributedOptimizer`` over the process set of the
  plan's gradient axes;
- ``batch_spec``, ``leaf_spec`` and ``leaf_specs`` return the reference's
  ``PartitionSpec`` entries as plain tuples (``tuple(PartitionSpec)``
  element for element); ``placements`` turns one into the DTensor
  placements of the mesh's dims;
- ``Plan.shard_map`` is dropped: torch has no ``shard_map``. Each rank
  runs its own program over its process sets; ``MoeMlp`` reads the
  installed mesh's ``expert`` axis itself (``parallel/moe.py``).
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

from horovod_tpu_torch.parallel import costmodel
from horovod_tpu_torch.parallel.costmodel import (  # noqa: F401
    Candidate,
    PlanError,
    Topology,
    Workload,
)
from horovod_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
)

# The two-level factorization of the data axis (the reference's
# parallel/hierarchical.py DCN_AXIS, ICI_AXIS).
DCN_AXIS = "data_dcn"
ICI_AXIS = "data_ici"

__all__ = [
    "Plan", "PlanError", "Topology", "Workload", "plan",
    "workload_from_params",
]


def _leaves(params):
    """The tensors of an ``nn.Module`` (its parameters: the flax
    ``params`` collection, without buffers such as batch statistics), or
    of a dict (nested dicts, lists and tuples too), in order."""
    if hasattr(params, "named_parameters"):
        return [p for _, p in params.named_parameters()]
    if isinstance(params, dict):
        return [t for v in params.values() for t in _leaves(v)]
    if isinstance(params, (list, tuple)):
        return [t for v in params for t in _leaves(v)]
    return [params]


def workload_from_params(params, *, batch: int, seq_len: int = 1,
                         d_model: Optional[int] = None,
                         n_layers: int = 1,
                         num_experts: int = 0,
                         pipeline_stages: int = 0,
                         dtype_bytes: Optional[int] = None) -> Workload:
    """Build a :class:`Workload` from an ``nn.Module`` (its parameters)
    or a dict of tensors.

    ``param_bytes`` sums every tensor; tensors whose leading dim equals
    ``num_experts`` are counted as expert weights. ``d_model`` defaults
    to the most common trailing dim of the >=2-D tensors, and
    ``dtype_bytes`` to the bytes-weighted dominant element size, as in
    the reference."""
    total = 0
    expert_bytes = 0
    trailing: Dict[int, int] = {}
    bytes_by_itemsize: Dict[int, int] = {}
    for leaf in _leaves(params):
        shape = tuple(getattr(leaf, "shape", ()))
        itemsize = int(leaf.element_size())
        nbytes = int(math.prod(shape)) * itemsize
        total += nbytes
        bytes_by_itemsize[itemsize] = \
            bytes_by_itemsize.get(itemsize, 0) + nbytes
        if num_experts and shape and shape[0] == num_experts:
            expert_bytes += nbytes
        if len(shape) >= 2:
            trailing[shape[-1]] = trailing.get(shape[-1], 0) + 1
    if d_model is None:
        d_model = max(trailing, key=lambda k: (trailing[k], k)) \
            if trailing else 1
    if dtype_bytes is None:
        dtype_bytes = max(bytes_by_itemsize,
                          key=lambda k: (bytes_by_itemsize[k], k)) \
            if bytes_by_itemsize else 4
    return Workload(
        param_bytes=total, batch=batch, seq_len=seq_len, d_model=d_model,
        n_layers=n_layers, dtype_bytes=int(dtype_bytes),
        num_experts=num_experts, expert_param_bytes=expert_bytes,
        pipeline_stages=pipeline_stages)


def placements(spec: Sequence, mesh=None):
    """The DTensor placements of a spec (``Plan.leaf_spec`` or
    ``batch_spec``) on ``mesh`` (default the global mesh): one per mesh
    dim, ``Shard(i)`` where entry i names that dim (alone or in a tuple),
    ``Replicate()`` elsewhere. Raises when two entries name one dim."""
    from torch.distributed.tensor import Replicate, Shard

    from horovod_tpu_torch.parallel import mesh as mesh_mod

    mesh = mesh or mesh_mod.global_mesh()
    on: Dict[str, int] = {}
    for i, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is None:
                continue
            if axis in on:
                raise ValueError("spec %r names axis %r twice"
                                 % (tuple(spec), axis))
            on[axis] = i
    return tuple(Shard(on[a]) if a in on else Replicate()
                 for a in mesh.mesh_dim_names)


class Plan:
    """A composed layout: mesh axes + per-leaf specs + sync strategy.

    Built by :func:`plan`; ``apply()`` is the only method with side
    effects (installs the global mesh and the hierarchical routing
    flag)."""

    def __init__(self, *, mesh_axes: Dict[str, int],
                 data_axes: Tuple[str, ...],
                 grad_axes: Tuple[str, ...], sync: str,
                 bucket_bytes: int, workload: Workload,
                 topology: Topology, chosen: Candidate,
                 rejected: Sequence[Candidate]):
        self.mesh_axes = dict(mesh_axes)
        # Axes the batch dim is sharded over (data, or its dcn x ici
        # factorization across nodes).
        self.data_axes = tuple(data_axes)
        # Axes gradients are averaged over: every token-sharding axis,
        # data plus seq when present, never expert: expert weights are
        # distinct per expert, and their replicas live on the data x seq
        # grid only.
        self.grad_axes = tuple(grad_axes)
        self.sync = sync          # "none" | "psum" | "hierarchical"
        self.bucket_bytes = int(bucket_bytes)
        self.workload = workload
        self.topology = topology
        self.chosen = chosen
        self.rejected = list(rejected)

    # -- install ----------------------------------------------------------

    def apply(self, ranks=None):
        """Build the mesh (``make_mesh`` over ``ranks``, default the
        world), install it process-wide, and arm the routing the plan's
        sync strategy needs. Returns the mesh. Every rank calls it.

        ``apply()`` owns the routing flag in both directions, as the
        reference's does: a hierarchical plan sets
        HOROVOD_HIERARCHICAL_ALLREDUCE, any other clears it, so that a
        re-plan (after an elastic resize, say) never leaves gradients on
        the ladder against the current plan."""
        from horovod_tpu_torch.parallel.mesh import make_mesh
        from horovod_tpu_torch.parallel.mesh import set_global_mesh

        mesh = make_mesh(self.mesh_axes, ranks=ranks)
        set_global_mesh(mesh)
        if self.sync == "hierarchical":
            os.environ["HOROVOD_HIERARCHICAL_ALLREDUCE"] = "1"
        else:
            os.environ.pop("HOROVOD_HIERARCHICAL_ALLREDUCE", None)
        return mesh

    def grad_process_set(self, mesh=None):
        """The process set of this rank's gradient replicas: the ranks
        that share its coordinates on every axis but the gradient axes
        (the global set when those span the world)."""
        from horovod_tpu_torch.common import basics
        from horovod_tpu_torch.parallel import mesh as mesh_mod

        mesh = mesh or mesh_mod.global_mesh()
        shape = mesh_mod.mesh_shape(mesh)
        names = list(shape)
        grid = mesh.mesh
        coords = [int(c) for c in (grid == basics.rank()).nonzero()[0]]
        index = tuple(slice(None) if a in self.grad_axes else coords[i]
                      for i, a in enumerate(names))
        ranks = sorted(int(r) for r in grid[index].reshape(-1))
        return mesh_mod._set_of(ranks)

    def optimizer(self, inner, **kwargs):
        """Wrap a ``torch.optim`` optimizer in the port's bucketed
        ``DistributedOptimizer`` over the plan's gradient axes, after
        ``apply()``. Every rank calls it."""
        from horovod_tpu_torch.optimizer import DistributedOptimizer

        kwargs.setdefault("process_set", self.grad_process_set())
        return DistributedOptimizer(inner, **kwargs)

    # -- specs ------------------------------------------------------------

    def batch_spec(self, ndim: int = 2, seq_dim: Optional[int] = 1
                   ) -> Tuple:
        """The spec of a batch-leading input: data axes on dim 0, the
        ``seq`` axis on ``seq_dim`` when the plan has one."""
        entries: List[object] = [None] * ndim
        if self.data_axes:
            entries[0] = self.data_axes if len(self.data_axes) > 1 \
                else self.data_axes[0]
        if seq_dim is not None and ndim > seq_dim \
                and self.mesh_axes.get(SEQ_AXIS, 1) > 1:
            entries[seq_dim] = SEQ_AXIS
        return tuple(entries)

    def leaf_spec(self, shape: Sequence[int]) -> Tuple:
        """Deterministic per-leaf spec, the reference's rules in
        precedence order: a leading expert dim shards dim 0 over
        ``expert``; with model parallelism, the last dim divisible by
        the model size is sharded over ``model``; everything else is
        replicated, and trailing ``None``s are dropped."""
        shape = tuple(int(x) for x in shape)
        entries: List[object] = [None] * len(shape)
        e = self.mesh_axes.get(EXPERT_AXIS, 1)
        m = self.mesh_axes.get(MODEL_AXIS, 1)
        if e > 1 and shape and shape[0] == self.workload.num_experts:
            entries[0] = EXPERT_AXIS
        if m > 1:
            for i in range(len(shape) - 1, -1, -1):
                if entries[i] is None and shape[i] % m == 0 \
                        and shape[i] >= m:
                    entries[i] = MODEL_AXIS
                    break
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)

    def leaf_specs(self, tree):
        """:meth:`leaf_spec` of every parameter of a module (by its
        name) or of every tensor of a dict (nested, by key)."""
        if hasattr(tree, "named_parameters"):
            tree = dict(tree.named_parameters())
        if isinstance(tree, dict):
            return {k: self.leaf_specs(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.leaf_specs(v) for v in tree)
        return self.leaf_spec(getattr(tree, "shape", ()))

    # -- reporting (pure Python over the cost table) ----------------------

    def summary(self) -> str:
        """One-line plan record for logs."""
        top = next((c for c in self.rejected), None)
        rej = " top-rejected=%s (%s)" % (
            costmodel._compact(top.axes), top.reason) if top else ""
        return ("mesh=%r sync=%s bucket_bytes=%d step_comm=%.3f ms "
                "mem/chip=%.2f GB%s"
                % (self.mesh_axes, self.sync, self.bucket_bytes,
                   self.chosen.cost.seconds * 1e3,
                   self.chosen.cost.mem_bytes / 1e9, rej))

    def report(self) -> str:
        """Human-readable debug report: chosen mesh, per-axis
        rationale, and the scored cost table of rejected candidates."""
        w, t = self.workload, self.topology
        lines = [
            "hvd.plan report",
            "  workload: params=%.2f MB (expert %.2f MB) batch=%d "
            "seq=%d d_model=%d layers=%d experts=%d pipe_stages=%d"
            % (w.param_bytes / 1e6, w.expert_param_bytes / 1e6, w.batch,
               w.seq_len, w.d_model, w.n_layers, w.num_experts,
               w.pipeline_stages),
            "  topology: %d chips = %d ici x %d dcn | ici %.1f GB/s, "
            "dcn %.1f GB/s, %.1f GB/chip"
            % (t.chips, t.ici, t.dcn, t.ici_bw_gbps, t.dcn_bw_gbps,
               t.mem_per_chip_gb),
            "  chosen: %s" % self.summary(),
            "  per-axis rationale:",
        ]
        if self.chosen.cost.terms:
            for text, _ in self.chosen.cost.terms:
                lines.append("    - %s" % text)
        else:
            lines.append("    - no inter-chip communication needed "
                         "(single chip or no parallel axis > 1)")
        lines.append("  candidates (ranked; %d total):"
                     % (1 + len(self.rejected)))
        lines.append("    %-28s %12s %10s %10s %9s  %s"
                     % ("mesh", "step-comm", "ici MB", "dcn MB",
                        "mem GB", "verdict"))
        table = [(self.chosen, "CHOSEN")] + \
            [(c, "rejected: " + c.reason) for c in self.rejected]
        for cand, verdict in table:
            c = cand.cost
            lines.append(
                "    %-28s %9.3f ms %10.2f %10.2f %9.2f  %s"
                % (costmodel._compact(cand.axes), c.seconds * 1e3,
                   c.ici_bytes / 1e6, c.dcn_bytes / 1e6,
                   c.mem_bytes / 1e9, verdict))
        return "\n".join(lines)

    def to_json(self) -> Dict:
        """JSON-serializable plan record."""
        return {
            "mesh_axes": dict(self.mesh_axes),
            "data_axes": list(self.data_axes),
            "grad_axes": list(self.grad_axes),
            "sync": self.sync,
            "bucket_bytes": self.bucket_bytes,
            "step_comm_ms": round(self.chosen.cost.seconds * 1e3, 6),
            "mem_per_chip_gb": round(self.chosen.cost.mem_bytes / 1e9, 4),
            "chips": self.topology.chips,
            "ici": self.topology.ici,
            "dcn": self.topology.dcn,
            "rejected": [
                {"axes": {k: v for k, v in c.axes.items() if v > 1},
                 "reason": c.reason} for c in self.rejected[:4]],
        }

    def __repr__(self) -> str:
        return "Plan(%s)" % self.summary()


def _grad_bucket_bytes() -> int:
    from horovod_tpu_torch.optimizer import grad_bucket_bytes

    return grad_bucket_bytes()


def _device_count() -> int:
    """The world's size after ``init``; else the visible cards (one at
    least)."""
    from horovod_tpu_torch.common import basics

    if basics.is_initialized():
        return basics.size()
    import torch

    return max(torch.cuda.device_count(), 1)


def plan(params=None, *, batch: Optional[int] = None, seq_len: int = 1,
         d_model: Optional[int] = None, n_layers: int = 1,
         num_experts: int = 0, pipeline_stages: int = 0,
         param_bytes: Optional[int] = None,
         expert_param_bytes: int = 0,
         dtype_bytes: Optional[int] = None,
         workload: Optional[Workload] = None,
         topology: Optional[Topology] = None,
         chips: Optional[int] = None, dcn: int = 1,
         require_axes: Optional[Dict[str, int]] = None,
         bucket_bytes: Optional[int] = None) -> Plan:
    """Choose a composed parallel layout for a workload on a topology.

    Workload: pass ``params`` (an ``nn.Module`` or a dict of tensors), or
    ``param_bytes`` plus the shape dims, or a prebuilt
    :class:`Workload`. Topology: a :class:`Topology`, or ``chips=`` (+
    ``dcn=`` for several nodes); with neither, the world's ranks (or the
    visible cards before ``init``), on the H100 fabric defaults.
    ``require_axes`` pins axes to exact sizes while the cost model
    assigns the rest.

    Returns a :class:`Plan`; raises :class:`PlanError` when no legal
    feasible layout exists.
    """
    if workload is None:
        if batch is None:
            raise ValueError("plan() needs batch= (or a prebuilt "
                             "workload=)")
        if params is not None:
            workload = workload_from_params(
                params, batch=batch, seq_len=seq_len, d_model=d_model,
                n_layers=n_layers, num_experts=num_experts,
                pipeline_stages=pipeline_stages,
                dtype_bytes=dtype_bytes)
        else:
            workload = Workload(
                param_bytes=int(param_bytes or 0), batch=batch,
                seq_len=seq_len, d_model=d_model or 1,
                n_layers=n_layers, num_experts=num_experts,
                expert_param_bytes=int(expert_param_bytes),
                dtype_bytes=int(dtype_bytes) if dtype_bytes else 4,
                pipeline_stages=pipeline_stages)
    if topology is None:
        if chips is None:
            chips = _device_count()
        topology = Topology.make(chips, dcn=dcn)

    candidates = costmodel.enumerate_candidates(
        workload, topology, require_axes)
    chosen, rejected = costmodel.choose(candidates)
    return _plan_from_candidate(chosen, rejected, workload, topology,
                                bucket_bytes)


def _plan_from_candidate(chosen: Candidate, rejected: List[Candidate],
                         workload: Workload, topology: Topology,
                         bucket_bytes: Optional[int]) -> Plan:
    axes = chosen.axes
    d = axes[costmodel.DATA]
    s = axes[costmodel.SEQ]
    mesh_axes: Dict[str, int] = {}
    if topology.dcn > 1 and d > 1:
        # DCN outer, ICI inner, so that ici neighbours stay adjacent.
        mesh_axes[DCN_AXIS] = topology.dcn
        mesh_axes[ICI_AXIS] = d // topology.dcn
        data_axes: Tuple[str, ...] = (DCN_AXIS, ICI_AXIS)
    else:
        mesh_axes[DATA_AXIS] = d
        data_axes = (DATA_AXIS,)
    for name, logical in ((EXPERT_AXIS, costmodel.EXPERT),
                          (SEQ_AXIS, costmodel.SEQ),
                          (MODEL_AXIS, costmodel.MODEL),
                          (PIPE_AXIS, costmodel.PIPE)):
        if axes[logical] > 1:
            mesh_axes[name] = axes[logical]
    assert math.prod(mesh_axes.values()) == topology.chips
    # Gradients sum over every token-sharding axis: data (or its
    # dcn x ici pair) plus seq. The ladder handles exactly a (dcn, ici)
    # pair, so a seq axis beside a multi-node data axis falls back to
    # the flat allreduce, which the cost model scores as such.
    grad_axes = data_axes + ((SEQ_AXIS,) if s > 1 else ())
    if d * s <= 1:
        sync = "none"
    elif topology.dcn > 1 and d > 1 and s == 1:
        sync = "hierarchical"
    else:
        sync = "psum"
    return Plan(
        mesh_axes=mesh_axes, data_axes=data_axes, grad_axes=grad_axes,
        sync=sync,
        bucket_bytes=bucket_bytes if bucket_bytes is not None
        else _grad_bucket_bytes(),
        workload=workload, topology=topology, chosen=chosen,
        rejected=rejected)
