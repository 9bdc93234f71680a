"""horovod_tpu_torch: the PyTorch / CUDA port of horovod_tpu.

The same Horovod API as ``horovod_tpu`` (topology, the allreduce family,
broadcast/allgather/alltoall/reducescatter, object and state broadcast,
the bucketed ``DistributedOptimizer``, compression, sync batch-norm),
written in PyTorch for an NVIDIA H100: the data plane is NCCL through
``torch.distributed``, and the TPU's Pallas kernels are hand-written CUDA
kernels (``csrc/``), built with ``nvcc`` at first use. This package
imports neither JAX nor ``horovod_tpu``.

Entry points run on the card unless the caller asks for the CPU::

    import horovod_tpu_torch as hvd
    hvd.init()                      # device="cpu" for gloo on the CPU
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-3, weight_decay=1e-4))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
"""

from horovod_tpu_torch.common.basics import (  # noqa: F401
    cross_rank,
    cross_size,
    init,
    is_initialized,
    local_rank,
    local_size,
    rank,
    shutdown,
    size,
)
from horovod_tpu_torch.common.process_sets import (  # noqa: F401
    global_process_set,
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
    allgather,
    allreduce,
    alltoall,
    barrier,
    broadcast,
    broadcast_,
    grouped_allreduce,
    reducescatter,
)
from horovod_tpu_torch.optimizer import (  # noqa: F401
    DistributedOptimizer,
    allreduce_gradients,
)
from horovod_tpu_torch.sync_batch_norm import (  # noqa: F401
    SyncBatchNorm,
    sync_batch_stats,
)
