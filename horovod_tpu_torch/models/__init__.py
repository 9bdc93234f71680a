from horovod_tpu_torch.models.convert import from_jax_params  # noqa: F401
from horovod_tpu_torch.models.transformer import (  # noqa: F401
    Transformer,
    TransformerConfig,
    lm_loss,
)
