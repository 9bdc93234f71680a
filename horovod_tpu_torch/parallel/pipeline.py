"""Pipeline parallelism: GPipe-style microbatch streaming over a set.

Port of ``horovod_tpu/parallel/pipeline.py``. Member i of the pipe set
owns stage i; microbatches stream through M + n - 1 steps, and after
each step every stage hands its activation to the next with
``mesh.ppermute``. Autograd reverses the exchanges, which gives the
fill-and-drain schedule backward.

In the JAX package the whole schedule is one program, transposed as
one. Here each member runs its own backward, which reaches only what
its own scalar depends on: stage 0 never reads what it receives, and no
stage reads the last step's carry, yet the backward of those exchanges
is where a stage receives its activations' gradients. So
``pipeline_apply`` ties every such output to its result with a zero
gradient: every member then runs every exchange, forward and backward,
in the same order.
"""

from __future__ import annotations

from typing import Callable

import torch

from horovod_tpu_torch.parallel.mesh import axis_index
from horovod_tpu_torch.parallel.mesh import axis_size
from horovod_tpu_torch.parallel.mesh import ppermute


class _Tie(torch.autograd.Function):
    """``out``, unchanged, with ``rest`` in its graph: the backward hands
    each of ``rest`` a zero gradient."""

    @staticmethod
    def forward(ctx, out, *rest):
        ctx.rest = [(r.shape, r.dtype, r.device) for r in rest]
        return out.clone()

    @staticmethod
    def backward(ctx, grad):
        return (grad,) + tuple(
            torch.zeros(shape, dtype=dtype, device=device) if need else None
            for (shape, dtype, device), need in zip(
                ctx.rest, ctx.needs_input_grad[1:]))


def pipeline_apply(stage_fn: Callable, stage_params, microbatches,
                   *, axis=None):
    """Run this member's stage over a stream of microbatches.

    Args:
        stage_fn: ``(stage_params, x) -> y``, this member's stage; the
            activation's shape is the same at every stage.
        stage_params: this member's stage parameters (or anything
            ``stage_fn`` takes).
        microbatches: (M, mb, ...), the same on every member; stage 0
            consumes them in order.
        axis: the pipe process set (default the global set).

    Returns (M, mb, ...): the last stage's outputs on the last stage,
    zeros on the others. Every member must differentiate a scalar of its
    own result (``pipeline_loss`` does), so that every exchange runs
    backward everywhere."""
    n = axis_size(axis)
    idx = axis_index(axis)
    m = microbatches.shape[0]
    shift = [(i, i + 1) for i in range(n - 1)]
    incoming = torch.zeros_like(microbatches[0])
    emitted, unread = [], []
    for t in range(m + n - 1):
        # Stage 0 injects microbatch t (the last one again while the
        # pipe drains); later stages take what came in from the left.
        if idx == 0:
            unread.append(incoming)
            x = microbatches[min(t, m - 1)]
        else:
            x = incoming
        y = stage_fn(stage_params, x)
        incoming = ppermute(y, shift, axis)
        # The last stage emits microbatch j at step j + n - 1.
        if idx == n - 1 and t >= n - 1:
            emitted.append(y)
    unread.append(incoming)
    if emitted:
        out = torch.stack(emitted)
    else:
        out = y.new_zeros((m,) + tuple(y.shape))
    return _Tie.apply(out, *(u for u in unread if u.requires_grad))


def pipeline_loss(stage_fn: Callable, stage_params, microbatches,
                  loss_fn: Callable, *, axis=None):
    """Pipeline forward and loss as a per-stage local scalar: the true
    loss on the last stage, 0.0 elsewhere (a 0.0 that carries the
    stage's exchanges, so that ``backward()`` on it runs them).

    Call ``backward()`` on this value on every member: the last stage
    seeds the one cotangent and the reversed exchanges deliver gradients
    to every stage. To read the loss, sum it over the set outside the
    differentiated region (stages other than the last add zero)."""
    outs = pipeline_apply(stage_fn, stage_params, microbatches, axis=axis)
    if axis_index(axis) == axis_size(axis) - 1:
        return loss_fn(outs)
    return outs.sum() * 0.0
