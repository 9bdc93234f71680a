"""Torch elastic API: ``hvd.elastic`` after ``import horovod_tpu_torch.torch
as hvd`` (port of ``horovod_tpu/torch/elastic.py``; reference:
horovod/torch/elastic/__init__.py, sampler.py:24-140): ``TorchState``,
``ObjectState``, ``State``, ``ElasticSampler`` as a
``torch.utils.data.Sampler``, and the ``run`` decorator.
"""

from __future__ import annotations

import torch.utils.data

from horovod_tpu_torch.data.sampler import (
    ElasticSampler as _BaseElasticSampler,
)
from horovod_tpu_torch.elastic.state import (  # noqa: F401
    ObjectState, State, TorchState,
)
from horovod_tpu_torch.elastic.worker import run  # noqa: F401


class ElasticSampler(_BaseElasticSampler, torch.utils.data.Sampler):
    """Elastic sampler usable as a DataLoader sampler
    (reference: horovod/torch/elastic/sampler.py:24-140)."""

    def __init__(self, dataset, shuffle=True, seed=0):
        _BaseElasticSampler.__init__(self, dataset, shuffle=shuffle,
                                     seed=seed)
