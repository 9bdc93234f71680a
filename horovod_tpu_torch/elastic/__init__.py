"""Elastic (fault-tolerant, auto-scaling) training, port of
``horovod_tpu.elastic`` (reference: horovod/common/elastic.py,
``hvd.elastic.run``)::

    import horovod_tpu_torch.elastic as elastic

    state = elastic.TorchState(model, optimizer, sampler=sampler, step=0)

    @elastic.run
    def train(state):
        while state.step < steps:
            ...train step...
            state.step += 1
            state.commit()

    train(state)
"""

from horovod_tpu_torch.elastic.state import (  # noqa: F401
    CudaState,
    ObjectState,
    State,
    TorchState,
    current_rendezvous_version,
)
from horovod_tpu_torch.elastic.worker import (  # noqa: F401
    reinit_for_version,
    run,
)
