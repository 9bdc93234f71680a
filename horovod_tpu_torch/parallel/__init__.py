"""Parallel strategies of the port: bucketing, the two-level ladder,
Adasum, and sequence, MoE and pipeline parallelism over process sets
(``parallel/mesh.py``). The functions below are re-exported flat, as
``horovod_tpu.parallel`` exports them."""

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
