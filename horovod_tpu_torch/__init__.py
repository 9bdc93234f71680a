"""horovod_tpu_torch: the PyTorch / CUDA port of horovod_tpu.

The same Horovod API as ``horovod_tpu`` (topology, the allreduce family,
the bucketed ``DistributedOptimizer``, compression), written in PyTorch for
an NVIDIA H100: the data plane is NCCL through ``torch.distributed``, and
the TPU's Pallas kernels are hand-written CUDA kernels (``csrc/``), built
with ``nvcc`` at first use. This package imports neither JAX nor
``horovod_tpu``.

Entry points run on the card unless the caller asks for the CPU::

    import horovod_tpu_torch as hvd
    hvd.init()                      # device="cpu" for gloo on the CPU
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-3, weight_decay=1e-4))
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
from horovod_tpu_torch.compression import Compression  # noqa: F401
from horovod_tpu_torch.ops.collective_ops import (  # noqa: F401
    Adasum,
    Average,
    Max,
    Min,
    Product,
    Sum,
    allreduce,
    grouped_allreduce,
)
from horovod_tpu_torch.optimizer import (  # noqa: F401
    DistributedOptimizer,
    allreduce_gradients,
)
