from horovod_tpu_torch.models.convert import (  # noqa: F401
    from_jax_params,
    mnist_from_jax_params,
    resnet_from_jax_variables,
)
from horovod_tpu_torch.models.mnist import MnistCNN, MnistMLP  # noqa: F401
from horovod_tpu_torch.models.resnet import (  # noqa: F401
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
)
from horovod_tpu_torch.models.transformer import (  # noqa: F401
    Transformer,
    TransformerConfig,
    lm_loss,
)
