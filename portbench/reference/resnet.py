"""ResNet v1.5 (He et al. 2016; the stride on each bottleneck's 3x3
convolution) in plain PyTorch: XLA's SAME padding, batch norm over the
batch with flax's running statistics (momentum 0.9, biased variance,
eps 1e-5), a mean pool and a dense layer. Each block is recomputed in the
backward pass (``torch.utils.checkpoint``), so that float32 activations
of a whole batch fit; batch statistics are recorded by name, so the
recomputation writes the same values again."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.common import Ops

EPS = 1e-5


def same_pads(size: int, kernel: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad(x, kernel, stride, value=0.0):
    (t, b), (l, r) = (same_pads(s, kernel, stride) for s in x.shape[2:])
    return F.pad(x, (l, r, t, b), value=value) if t or b or l or r else x


class Net:
    def __init__(self, W: Dict[str, torch.Tensor], config: dict, ops: Ops):
        self.W, self.config, self.ops = W, config, ops
        self.stats: Dict[str, tuple] = {}

    def conv(self, x, name, stride=1, pad=None):
        w = self.W[name + ".weight"]
        k = w.shape[-1]
        x = F.pad(x, (pad,) * 4) if pad is not None else _pad(x, k, stride)
        return self.ops.conv(x, w, stride)

    def bn(self, x, name):
        with torch.no_grad():
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
        self.stats[name] = (mean, var)
        return F.batch_norm(x, None, None, self.W[name + ".scale"],
                            self.W[name + ".bias"], True, 0.0, EPS)

    def block(self, x, p, stride, project):
        y = F.relu(self.bn(self.conv(x, p + "conv0"), p + "bn0"))
        y = F.relu(self.bn(self.conv(y, p + "conv1", stride), p + "bn1"))
        y = self.bn(self.conv(y, p + "conv2"), p + "bn2")
        res = x
        if project:
            res = self.bn(self.conv(x, p + "conv_proj", stride),
                          p + "norm_proj")
        return F.relu(res + y)

    def __call__(self, images):
        x = F.relu(self.bn(self.conv(images, "conv_init", 2, pad=3),
                           "bn_init"))
        x = F.max_pool2d(_pad(x, 3, 2, float("-inf")), 3, 2)
        filters = self.config["num_filters"]
        cin, b = filters, 0
        for i, count in enumerate(self.config["stage_sizes"]):
            feat = filters * 2 ** i
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                project = stride != 1 or cin != 4 * feat
                x = checkpoint(self.block, x, "blocks.%d." % b, stride,
                               project, use_reentrant=False)
                cin, b = 4 * feat, b + 1
        return F.linear(x.mean(dim=(2, 3)), self.W["dense.weight"],
                        self.W["dense.bias"])


def accumulate(W, config, images, labels, ops: Ops):
    """Add the gradient of the summed cross entropy of the whole batch
    into ``W``'s ``.grad`` (batch norm needs the whole batch at once);
    return the summed loss and the batch statistics by batch norm."""
    net = Net(W, config, ops)
    loss = F.cross_entropy(net(images.float()), labels, reduction="sum")
    loss.backward()
    return loss.detach(), net.stats


def update_running(W, stats, momentum: float = 0.9) -> None:
    """flax's running statistics: r = m r + (1 - m) batch."""
    with torch.no_grad():
        for name, (mean, var) in stats.items():
            W[name + ".mean"].mul_(momentum).add_(mean, alpha=1 - momentum)
            W[name + ".var"].mul_(momentum).add_(var, alpha=1 - momentum)
