"""Batch normalisation as flax computes it, and its synchronised form.

Port of ``horovod_tpu/jax/sync_batch_norm.py`` and of the
``flax.linen.BatchNorm`` that the reference's ResNet uses
(``momentum=0.9, epsilon=1e-5``). flax's batch norm is not
``torch.nn.BatchNorm2d``:

- its running variance takes the *biased* batch variance, where torch's
  takes the unbiased one;
- its ``momentum`` weighs the old running value (0.9 is torch's 0.1);
- statistics are fp32 whatever the activations' dtype, and the output is
  cast to ``dtype`` (bf16 activations, fp32 statistics and affine).

``BatchNorm`` normalises over every dim but dim 1 (NCHW, any memory
format). With ``sync=True`` (``SyncBatchNorm``) the count, sum and sum of
squares are summed over every rank in one fp32 allreduce, whose backward
allreduces their cotangents (the transpose of ``psum``, which is what
JAX's autodiff gives the reference), so every rank normalises with the
global batch's statistics and gets the global batch's gradients.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


class _SumOverRanks(torch.autograd.Function):
    """Allreduce-sum; the backward allreduce-sums the cotangent."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def _global_moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 mean and biased variance of ``x`` per channel (dim 1) over
    every rank's batch, each element weighted equally: var = max(E[x²] -
    mean², 0), as the reference computes it."""
    dims = [0] + list(range(2, x.dim()))
    xf = x.float()
    count = torch.full((1,), x.numel() // x.shape[1], dtype=torch.float32,
                       device=x.device)
    sums = _SumOverRanks.apply(torch.cat([xf.sum(dims), xf.square().sum(dims),
                                          count]))
    c = x.shape[1]
    mean = sums[:c] / sums[2 * c]
    var = torch.clamp(sums[c:2 * c] / sums[2 * c] - mean.square(), min=0.0)
    return mean, var


def sync_batch_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and variance of ``x`` per channel (dim 1) over every rank,
    in ``x``'s dtype; the gradient flows to every rank's ``x``."""
    mean, var = _global_moments(x)
    return mean.to(x.dtype), var.to(x.dtype)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum, epsilon, dtype)`` over dim 1.

    ``scale`` and ``bias`` are fp32 parameters; ``mean`` and ``var`` are
    the fp32 running statistics (0 and 1 at first). In training the batch
    statistics normalise ``x`` and update the running ones,
    ``r = momentum r + (1 - momentum) batch``; in eval mode the running
    ones normalise it. The output is in ``dtype``. ``zero_scale`` starts
    ``scale`` at 0 (the last batch norm of a ResNet v1.5 block).
    """

    def __init__(self, features: int, *, dtype: torch.dtype = torch.float32,
                 momentum: float = 0.9, eps: float = 1e-5,
                 sync: bool = False, zero_scale: bool = False,
                 device=None):
        super().__init__()
        self.dtype, self.momentum, self.eps, self.sync = (dtype, momentum,
                                                          eps, sync)
        # Off while torch.utils.checkpoint recomputes a block: the
        # recomputation must not move the running statistics again.
        self.update_stats = True
        init = torch.zeros if zero_scale else torch.ones
        self.scale = nn.Parameter(init(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.mean, self.var, self.scale,
                                self.bias, False, 0.0, self.eps
                                ).to(self.dtype)
        if self.sync:
            mean, var = _global_moments(x)
            shape = (1, -1) + (1,) * (x.dim() - 2)
            mul = torch.rsqrt(var + self.eps) * self.scale
            y = (x.float() - mean.view(shape)) * mul.view(shape) \
                + self.bias.view(shape)
        else:
            # torch writes the batch mean and the *unbiased* variance into
            # running buffers updated with momentum 1: scratch ones here.
            mean = torch.zeros_like(self.mean)
            var = torch.ones_like(self.var)
            y = F.batch_norm(x, mean, var, self.scale, self.bias, True, 1.0,
                             self.eps)
            n = x.numel() // x.shape[1]
            var = var * ((n - 1) / n)
        if self.update_stats:
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                self.var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        return y.to(self.dtype)


class SyncBatchNorm(BatchNorm):
    """``BatchNorm`` with statistics over every rank's batch."""

    def __init__(self, features: int, **kwargs):
        super().__init__(features, sync=True, **kwargs)
