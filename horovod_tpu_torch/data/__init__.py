"""Data loading of the port: the elastic sampler and the async loader
(port of ``horovod_tpu.data``)."""

from horovod_tpu_torch.data.data_loader import (  # noqa: F401
    AsyncDataLoaderMixin,
    BaseDataLoader,
)
from horovod_tpu_torch.data.sampler import ElasticSampler  # noqa: F401
