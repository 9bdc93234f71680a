"""ResNet v1.5: the port of ``horovod_tpu/models/resnet.py``.

The reference's headline benchmark is synthetic ResNet-50 throughput. As
in the flax model, parameters and batch statistics are fp32 and the
compute is in ``dtype`` (bf16 by default): each conv casts its weight to
``dtype``, each batch norm computes its statistics in fp32 and returns
``dtype``, and the dense layer runs in fp32 on the pooled features, so
the logits are fp32. NHWC becomes ``torch.channels_last``: the forward
takes NCHW tensors, and the model keeps its activations and conv weights
in channels_last memory.

The parity details of the reference are kept:

- flax's ``SAME`` padding: a 3x3 stride-2 conv or the 3x3 stride-2 max
  pool on an even input pads (0, 1), not torch's (1, 1), the pool with
  -inf; each pads explicitly before a ``padding=0`` op. The 7x7 stem pads
  (3, 3) as the reference says;
- flax's batch norm (``sync_batch_norm.BatchNorm``: biased running
  variance, momentum 0.9, fp32 statistics, eps 1e-5), the last one of
  each block zero-initialised;
- flax's initialisers: convs and the dense kernel are ``lecun_normal``
  (a normal truncated at two standard deviations, variance 1 / fan_in),
  the dense bias 0.

``sync_bn=True`` is the reference's ``axis_name``: batch statistics over
every rank. ``act`` (default ``F.relu``) is the reference's activation,
applied in the stem and the blocks as flax's ``act`` is. ``remat=True`` recomputes each block in the backward
(``torch.utils.checkpoint``, the reference's ``nn.remat``). Parameter
names follow the flax tree (``models.convert.resnet_from_jax_variables``).
"""

from __future__ import annotations

import contextlib
from functools import partial
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from horovod_tpu_torch.sync_batch_norm import BatchNorm

# The standard deviation of a unit normal truncated to [-2, 2]
# (flax's variance_scaling divides by it).
_TRUNC_STD = 0.87962566103423978


def lecun_normal(shape, fan_in: int, generator=None, device=None
                 ) -> torch.Tensor:
    """flax ``lecun_normal()``: truncated normal, variance 1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    w = torch.empty(shape, device=device)
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of XLA's ``SAME`` along one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0
              ) -> torch.Tensor:
    (top, bottom), (left, right) = (same_pads(s, kernel, stride)
                                    for s in x.shape[2:])
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=value)
    return x


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides, use_bias=False,
    dtype=dtype)``: ``SAME`` padding unless ``padding`` is given."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: Optional[int] = None, *, dtype: torch.dtype,
                 generator=None, device=None):
        super().__init__()
        self.kernel, self.stride, self.padding, self.dtype = (
            kernel, stride, padding, dtype)
        self.weight = nn.Parameter(lecun_normal(
            (cout, cin, kernel, kernel), cin * kernel * kernel, generator,
            device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding is None:
            x = _pad_same(x, self.kernel, self.stride)
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride,
                        padding=self.padding or 0)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int,
                 act: Callable = F.relu, **kw):
        super().__init__()
        conv, norm = _layers(**kw)
        self.act = act
        self.conv0 = conv(cin, features, 3, stride)
        self.bn0 = norm(features)
        self.conv1 = conv(features, features, 3)
        self.bn1 = norm(features, zero_scale=True)
        self.conv_proj = self.norm_proj = None
        if stride != 1 or cin != features:
            self.conv_proj = conv(cin, features, 1, stride)
            self.norm_proj = norm(features)

    def forward(self, x):
        y = self.act(self.bn0(self.conv0(x)))
        y = self.bn1(self.conv1(y))
        return self.act(_residual(self, x) + y)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int,
                 act: Callable = F.relu, **kw):
        super().__init__()
        conv, norm = _layers(**kw)
        self.act = act
        self.conv0 = conv(cin, features, 1)
        self.bn0 = norm(features)
        self.conv1 = conv(features, features, 3, stride)
        self.bn1 = norm(features)
        self.conv2 = conv(features, 4 * features, 1)
        # v1.5: zero-init the last BN scale so blocks start as identity.
        self.bn2 = norm(4 * features, zero_scale=True)
        self.conv_proj = self.norm_proj = None
        if stride != 1 or cin != 4 * features:
            self.conv_proj = conv(cin, 4 * features, 1, stride)
            self.norm_proj = norm(4 * features)

    def forward(self, x):
        y = self.act(self.bn0(self.conv0(x)))
        y = self.act(self.bn1(self.conv1(y)))
        y = self.bn2(self.conv2(y))
        return self.act(_residual(self, x) + y)


def _layers(*, dtype, sync_bn, generator, device):
    return (partial(Conv, dtype=dtype, generator=generator, device=device),
            partial(BatchNorm, dtype=dtype, sync=sync_bn, device=device))


def _residual(block, x):
    """The block's input, projected where the block changes its shape
    (the reference's ``residual.shape != y.shape``)."""
    if block.conv_proj is None:
        return x
    return block.norm_proj(block.conv_proj(x))


@contextlib.contextmanager
def _running_stats_frozen(module: nn.Module):
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True


class ResNet(nn.Module):
    """Images (N, 3, H, W) -> logits (N, num_classes) fp32.

    ``model.train()`` computes batch statistics and updates the running
    ones (the reference's ``train=True``); ``model.eval()`` normalises
    with the running ones (``use_running_average``). Weights are drawn
    with ``generator`` on ``device``, which defaults to the card.
    """

    def __init__(self, stage_sizes: Sequence[int], block_cls=None, *,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16,
                 act: Callable = F.relu, sync_bn: bool = False,
                 remat: bool = False, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        block_cls = block_cls or BottleneckBlock
        self.dtype, self.remat, self.act = dtype, remat, act
        kw = dict(dtype=dtype, sync_bn=sync_bn, generator=generator,
                  device=device)
        conv, norm = _layers(**kw)
        self.conv_init = conv(3, num_filters, 7, 2, padding=3)
        self.bn_init = norm(num_filters)
        blocks, cin = [], num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                features = num_filters * 2 ** i
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(cin, features, stride, act, **kw))
                cin = features * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.dense = nn.Linear(cin, num_classes, device=device)
        with torch.no_grad():
            self.dense.weight.copy_(lecun_normal(
                (num_classes, cin), cin, generator, device))
            self.dense.bias.zero_()
        self.to(memory_format=torch.channels_last)

    def _block(self, block, x):
        if not (self.remat and torch.is_grad_enabled()):
            return block(x)
        return checkpoint(block, x, use_reentrant=False, context_fn=lambda: (
            contextlib.nullcontext(), _running_stats_frozen(block)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(dtype=self.dtype, memory_format=torch.channels_last)
        x = self.act(self.bn_init(self.conv_init(x)))
        x = F.max_pool2d(_pad_same(x, 3, 2, float("-inf")), 3, 2)
        for block in self.blocks:
            x = self._block(block, x)
        x = x.mean(dim=(2, 3))
        return self.dense(x.float())


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3])
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3])
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3])
