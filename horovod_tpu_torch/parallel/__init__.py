"""Parallel strategies of the port: bucketing, the two-level ladder,
Adasum, and sequence, MoE and pipeline parallelism over process sets
(``parallel/mesh.py``), the mesh, and the planner. The names below are
exported flat, as ``horovod_tpu.parallel`` exports them; the planner's
names and the strategy modules resolve on first touch (PEP 562), as the
reference's ``_LAZY_ATTRS`` and ``_LAZY_FUNCS`` do."""

import importlib

from horovod_tpu_torch.parallel.hierarchical import (  # noqa: F401
    grouped_hierarchical_allreduce,
    hierarchical_allreduce,
    make_hierarchical_axes,
)
from horovod_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    axis_size,
    data_sharding,
    global_mesh,
    make_mesh,
    replicated,
    reset_global_mesh,
    set_global_mesh,
)
from horovod_tpu_torch.parallel.moe import (  # noqa: F401
    expert_parallel_moe,
    moe_ffn,
)
from horovod_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_apply,
    pipeline_loss,
)
from horovod_tpu_torch.parallel.sequence import (  # noqa: F401
    ring_attention,
    ulysses_attention,
)

_LAZY_ATTRS = {name: "horovod_tpu_torch.parallel." + name
               for name in ("adasum", "bucketing", "costmodel",
                            "hierarchical", "moe", "pipeline", "planner",
                            "sequence")}
_PLANNER = ("plan", "Plan", "PlanError", "Topology", "Workload",
            "workload_from_params")


def __getattr__(name):
    if name in _LAZY_ATTRS:
        return importlib.import_module(_LAZY_ATTRS[name])
    if name in _PLANNER:
        return getattr(importlib.import_module(_LAZY_ATTRS["planner"]),
                       name)
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))


def __dir__():
    return sorted(set(globals()) | set(_LAZY_ATTRS) | set(_PLANNER))
