"""Parallel strategies of the port: bucketing, the two-level ladder,
Adasum, and sequence, MoE and pipeline parallelism over process sets
(``parallel/mesh.py``), the mesh, and the planner. The functions below
are re-exported flat, as ``horovod_tpu.parallel`` exports them; the
planner's names resolve on first touch."""

from horovod_tpu_torch.parallel.mesh import (  # noqa: F401
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

_PLANNER = ("plan", "Plan", "PlanError", "Topology", "Workload",
            "workload_from_params")


def __getattr__(name):
    if name in _PLANNER:
        from horovod_tpu_torch.parallel import planner

        return getattr(planner, name)
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))
