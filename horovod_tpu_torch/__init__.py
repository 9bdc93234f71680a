"""horovod_tpu_torch: the PyTorch / CUDA port of horovod_tpu.

The same Horovod API as ``horovod_tpu`` (topology, the allreduce family,
broadcast/allgather/alltoall/reducescatter, object and state broadcast,
the bucketed ``DistributedOptimizer``, compression, sync batch-norm),
written in PyTorch for an NVIDIA H100: the data plane is NCCL through
``torch.distributed``, and the TPU's Pallas kernels are hand-written CUDA
kernels (``csrc/``), built with ``nvcc`` at first use. This package
imports neither JAX nor ``horovod_tpu``.

The root namespace is the reference's (``horovod_tpu/__init__.py:39-122``):
the bare collective names are the negotiated eager ops of ``ops/eager.py``
(named, handle-based, ``*_async`` with ``poll``/``synchronize``), and the
collectives over the process group, which the bucketed optimizer runs, are
the ``*_ingraph`` names. Entry points run on the card unless the caller
asks for the CPU::

    import horovod_tpu_torch as hvd
    hvd.init()                      # device="cpu" for gloo on the CPU
    avg = hvd.allreduce(grad, name="g")
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-3, weight_decay=1e-4))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
"""

from horovod_tpu_torch.common.basics import (  # noqa: F401
    ccl_built,
    cross_rank,
    cross_size,
    cuda_built,
    ddl_built,
    dump_flight_record,
    gloo_built,
    gloo_enabled,
    init,
    is_homogeneous,
    is_initialized,
    local_rank,
    local_size,
    metrics_snapshot,
    mpi_built,
    mpi_enabled,
    mpi_threads_supported,
    nccl_built,
    rank,
    rocm_built,
    shutdown,
    size,
    start_metrics_server,
    start_timeline,
    stop_metrics_server,
    stop_timeline,
    tpu_built,
)
from horovod_tpu_torch.common.exceptions import (  # noqa: F401
    HorovodAbortedError,
    HorovodInternalError,
    HostsUpdatedInterrupt,
)
from horovod_tpu_torch.common.process_sets import (  # noqa: F401
    ProcessSet,
    add_process_set,
    get_process_set,
    get_process_set_ids,
    global_process_set,
    remove_process_set,
)
from horovod_tpu_torch.common.objects import (  # noqa: F401
    allgather_object,
    broadcast_object,
)
from horovod_tpu_torch.compression import Compression  # noqa: F401
from horovod_tpu_torch.functions import (  # noqa: F401
    broadcast_optimizer_state,
    broadcast_parameters,
)
from horovod_tpu_torch.ops.collective_ops import (  # noqa: F401
    Adasum,
    Average,
    Max,
    Min,
    Product,
    Sum,
    allgather as allgather_ingraph,
    allreduce as allreduce_ingraph,
    alltoall as alltoall_ingraph,
    broadcast as broadcast_ingraph,
    grouped_allreduce as grouped_allreduce_ingraph,
    reducescatter as reducescatter_ingraph,
)
from horovod_tpu_torch.ops.eager import (  # noqa: F401
    allgather,
    allgather_async,
    allreduce,
    allreduce_async,
    alltoall,
    alltoall_async,
    barrier,
    broadcast,
    broadcast_async,
    grouped_allreduce,
    grouped_allreduce_async,
    join,
    poll,
    reducescatter,
    reducescatter_async,
    synchronize,
)
from horovod_tpu_torch.optimizer import (  # noqa: F401
    DistributedOptimizer,
    allreduce_gradients,
)
from horovod_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    global_mesh,
    make_mesh,
    set_global_mesh,
)
from horovod_tpu_torch.sync_batch_norm import (  # noqa: F401
    SyncBatchNorm,
    sync_batch_stats,
)


def __getattr__(name):
    """Lazy subsystems (PEP 562), as the reference's root resolves them
    (``horovod_tpu/__init__.py:135-152``): ``hvd.serve`` loads the serving
    package on first touch, and ``hvd.plan`` with the ``Plan``,
    ``PlanError``, ``Topology`` and ``Workload`` types the planner."""
    if name == "serve":
        import horovod_tpu_torch.serve as _serve

        return _serve
    if name in ("plan", "Plan", "PlanError", "Topology", "Workload"):
        from horovod_tpu_torch import parallel as _parallel

        return getattr(_parallel, name)
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))
