"""MNIST models: the port of ``horovod_tpu/models/mnist.py``.

``MnistCNN`` is the reference's ``examples/pytorch/pytorch_mnist.py``
``Net`` as the flax model has it, ``MnistMLP`` the Keras example's dense
512-512-10. Both take NCHW images (N, 1, 28, 28) and return fp32 logits.
The flax CNN flattens NHWC features, so its 320 features come in
(H, W, C) order: the port permutes to NHWC before it flattens, and the
dense weights carry over unpermuted. Weights follow flax's initialisers
(``lecun_normal`` kernels, zero biases). Dropout draws its masks from the
``generator`` the model was built with (the global one when it is
None), and is off in eval mode.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.resnet import lecun_normal


def _flax_init(module: nn.Module, generator, device) -> None:
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(lecun_normal(m.weight.shape, fan_in,
                                            generator, device))
                m.bias.zero_()


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with its mask drawn from ``generator``."""
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep / (1.0 - p)


class MnistCNN(nn.Module):
    """Conv(10, 5x5) -> pool -> Conv(20, 5x5) -> pool -> FC 50 -> FC 10."""

    def __init__(self, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.generator = generator
        self.conv0 = nn.Conv2d(1, 10, 5, device=device)
        self.conv1 = nn.Conv2d(10, 20, 5, device=device)
        self.dense0 = nn.Linear(320, 50, device=device)
        self.dense1 = nn.Linear(50, 10, device=device)
        _flax_init(self, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(F.max_pool2d(self.conv0(x), 2, 2))
        x = dropout(self.conv1(x), 0.5, self.training, self.generator)
        x = F.relu(F.max_pool2d(x, 2, 2))
        # The reference flattens NHWC: features in (H, W, C) order.
        x = x.permute(0, 2, 3, 1).flatten(1)
        x = F.relu(self.dense0(x))
        x = dropout(x, 0.5, self.training, self.generator)
        return self.dense1(x)


class MnistMLP(nn.Module):
    """Dense 512 -> 512 -> 10 with dropout 0.2."""

    def __init__(self, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.generator = generator
        self.dense0 = nn.Linear(784, 512, device=device)
        self.dense1 = nn.Linear(512, 512, device=device)
        self.dense2 = nn.Linear(512, 10, device=device)
        _flax_init(self, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.flatten(1)
        x = dropout(F.relu(self.dense0(x)), 0.2, self.training,
                    self.generator)
        x = dropout(F.relu(self.dense1(x)), 0.2, self.training,
                    self.generator)
        return self.dense2(x)
