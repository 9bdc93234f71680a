"""``import horovod_tpu_torch.torch as hvd``: the reference's
``horovod.torch`` surface over the negotiated eager path, a drop-in for
``import horovod_tpu.torch as hvd`` (port of ``horovod_tpu/torch``).

Named tensors are negotiated by the native core, so the ranks may submit
them in any order. Host tensors take the core's CPU TCP ring; card
tensors stay on the card, packed and reduced by the device plane over
NCCL. The top-level ``horovod_tpu_torch`` package keeps the in-graph API
of the port's first slices (the bucketed ``DistributedOptimizer``).
"""

from horovod_tpu_torch.common.basics import (  # noqa: F401
    ccl_built, check_extension, core_session, cross_rank, cross_size,
    cuda_built, ddl_built, gloo_built, gloo_enabled, init, is_homogeneous,
    is_initialized, local_rank, local_size, mpi_built, mpi_enabled,
    mpi_threads_supported, nccl_built, rank, rocm_built, shutdown, size,
    start_timeline, stop_timeline, tpu_built,
)
from horovod_tpu_torch.common.exceptions import (  # noqa: F401
    HorovodAbortedError, HorovodInternalError, HostsUpdatedInterrupt,
)
from horovod_tpu_torch.common.process_sets import (  # noqa: F401
    ProcessSet, add_process_set, get_process_set, get_process_set_ids,
    global_process_set, remove_process_set,
)
from horovod_tpu_torch.torch.compression import Compression  # noqa: F401
from horovod_tpu_torch.torch.functions import (  # noqa: F401
    allgather_object,
    broadcast_object,
    broadcast_optimizer_state,
    broadcast_parameters,
)
from horovod_tpu_torch.torch.mpi_ops import (  # noqa: F401
    Adasum, Average, Max, Min, Product, Sum,
    allgather, allgather_async,
    allreduce, allreduce_, allreduce_async, allreduce_async_,
    alltoall, alltoall_async,
    barrier,
    broadcast, broadcast_, broadcast_async, broadcast_async_,
    grouped_allreduce, grouped_allreduce_, grouped_allreduce_async,
    grouped_allreduce_async_,
    join, poll, reducescatter, sparse_allreduce_async, synchronize,
)
from horovod_tpu_torch.torch.optimizer import (  # noqa: F401
    DistributedOptimizer,
)
from horovod_tpu_torch.torch.sync_batch_norm import (  # noqa: F401
    SyncBatchNorm,
)

# ``hvd.elastic.TorchState`` etc. after ``import horovod_tpu_torch.torch as
# hvd``, as ``horovod_tpu/torch/__init__.py:39`` has it.
from horovod_tpu_torch.torch import elastic  # noqa: E402,F401
