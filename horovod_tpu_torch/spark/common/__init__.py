from horovod_tpu_torch.spark.common.store import (  # noqa: F401
    FilesystemStore, HDFSStore, LocalStore, Store,
)
from horovod_tpu_torch.spark.common.params import EstimatorParams  # noqa: F401
from horovod_tpu_torch.spark.common.backend import (  # noqa: F401
    Backend, LocalBackend, SparkBackend,
)
