"""DistributedOptimizer for PyTorch: bucketed gradient allreduce.

Port of ``horovod_tpu/jax/optimizer.py``. Gradients are split into
per-dtype fused buckets of ``HVD_GRAD_BUCKET_BYTES`` each (default 4 MiB,
``0`` = no cap: one bucket per dtype), assigned in reverse-gradient order
by ``parallel.bucketing.assign_buckets`` exactly as the reference does.
Where the reference hands XLA several independent ``psum``s to overlap
with the rest of backprop, the port launches each bucket as an async
``torch.distributed.all_reduce`` from a post-accumulate-grad hook as soon
as every gradient in it is ready (NCCL then runs it on its own stream
while autograd computes the earlier layers). ``step()`` waits on the
handles, writes the reduced gradients back and runs the inner update.
Gradients never leave the device.

Buckets are launched strictly in bucket order, whatever order the hooks
fire in, so every rank issues the same sequence of collectives.

``backward_passes_per_step=k`` is the reference's gradient accumulation
(``optax.MultiSteps`` around the allreduce and the update): gradients
accumulate locally in ``.grad`` over k backward passes, the buckets
launch from the hooks of the k-th pass, scaled by 1 / k so that the
allreduce and the inner update see the mean of the k gradients, and
``step()`` and ``zero_grad()`` on the passes in between leave the
parameters and the gradients as they are.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch

from horovod_tpu_torch.common.process_sets import global_process_set
from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.ops import collective_ops as C
from horovod_tpu_torch.parallel import bucketing

# Same knob and default as the reference (horovod_tpu/jax/optimizer.py).
DEFAULT_GRAD_BUCKET_BYTES = 4 * 1024 * 1024


def grad_bucket_bytes() -> int:
    """Resolved ``HVD_GRAD_BUCKET_BYTES`` (0 = one bucket per dtype)."""
    return int(os.environ.get("HVD_GRAD_BUCKET_BYTES",
                              str(DEFAULT_GRAD_BUCKET_BYTES)))


def allreduce_gradients(grads: Sequence[torch.Tensor], *, op: int = C.Average,
                        process_set=global_process_set,
                        compression=Compression.none,
                        prescale_factor: float = 1.0,
                        postscale_factor: float = 1.0) -> List[torch.Tensor]:
    """Allreduce a gradient list in per-dtype buckets of
    ``HVD_GRAD_BUCKET_BYTES``, launched in reverse-gradient order.
    Returns new tensors in the input order."""
    C._check(op, process_set)
    return C.bucketed_allreduce(grads, op, grad_bucket_bytes(),
                                compression=compression,
                                prescale_factor=prescale_factor,
                                postscale_factor=postscale_factor)


class DistributedOptimizer:
    """Wrap a ``torch.optim`` optimizer with bucketed gradient averaging.

    Usage::

        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-3,
                              weight_decay=1e-4))
        loss.backward()   # buckets launch from the gradient hooks
        opt.step()        # waits on them, then the inner update
        opt.zero_grad()

    ``buckets`` is the assignment of the optimizer's parameters (in
    ``param_groups`` order) to buckets; ``buckets_launched`` counts the
    bucket allreduces issued since construction. With
    ``backward_passes_per_step=k``, ``step()`` updates the parameters
    once every k backward passes (see the module's docstring).
    """

    def __init__(self, optimizer: torch.optim.Optimizer, *,
                 op: int = C.Average, process_set=global_process_set,
                 compression=Compression.none,
                 prescale_factor: float = 1.0,
                 postscale_factor: float = 1.0,
                 backward_passes_per_step: int = 1):
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        C._check(op, process_set)
        self.optimizer = optimizer
        self.op = op
        self.compression = compression
        self.backward_passes_per_step = backward_passes_per_step
        self.prescale_factor = prescale_factor / backward_passes_per_step
        self.postscale_factor = postscale_factor
        self._params: List[torch.nn.Parameter] = []
        seen = set()
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.requires_grad and id(p) not in seen:
                    seen.add(id(p))
                    self._params.append(p)
        self.buckets = bucketing.assign_buckets(
            [p.numel() * p.element_size() for p in self._params],
            [p.dtype for p in self._params], grad_bucket_bytes())
        self._bucket_of = {}
        for bi, b in enumerate(self.buckets):
            for i in b.indices:
                self._bucket_of[id(self._params[i])] = bi
        self.buckets_launched = 0
        self._reset()
        self._hooks = [p.register_post_accumulate_grad_hook(self._on_grad)
                       for p in self._params]

    def _reset(self):
        self._pending = [len(b.indices) for b in self.buckets]
        self._flights: List[Optional[C.BucketFlight]] = \
            [None] * len(self.buckets)
        self._next = 0
        self._passes = {}  # id(param) -> backward passes since the update

    def _on_grad(self, p):
        k = self.backward_passes_per_step
        passes = self._passes.get(id(p), 0) + 1
        if passes > k:
            raise RuntimeError(
                "a gradient was accumulated %s before step(), with "
                "backward_passes_per_step=%d"
                % ("twice" if passes == 2 else "%d times" % passes, k))
        self._passes[id(p)] = passes
        if passes == k:
            self._pending[self._bucket_of[id(p)]] -= 1
            self._launch_ready()

    def _accumulating(self) -> bool:
        """Whether a backward pass has run since the last update and the
        passes so far fall short of the k an update needs."""
        return 0 < max(self._passes.values(), default=0) \
            < self.backward_passes_per_step

    def _launch_ready(self):
        while (self._next < len(self.buckets)
               and self._pending[self._next] == 0):
            params = [self._params[i]
                      for i in self.buckets[self._next].indices]
            for p in params:
                if p.grad is None:  # unused on this rank: reduce zeros
                    p.grad = torch.zeros_like(p)
            self._flights[self._next] = C.BucketFlight(
                [p.grad for p in params], self.op, self.compression,
                self.prescale_factor)
            self.buckets_launched += 1
            self._next += 1

    def synchronize(self) -> None:
        """Launch what the hooks have not, wait on every bucket and write
        the reduced gradients back into ``.grad``."""
        self._pending = [0] * len(self.buckets)
        self._launch_ready()
        for flight in self._flights:
            for g, out in zip(flight.leaves, flight.finish(
                    self.op, self.compression, self.postscale_factor)):
                g.copy_(out)
        self._reset()

    def step(self, closure=None):
        if self._accumulating():
            return None
        self.synchronize()
        return self.optimizer.step(closure)

    def zero_grad(self, set_to_none: bool = True) -> None:
        if not self._accumulating():
            self.optimizer.zero_grad(set_to_none=set_to_none)

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    def state_dict(self):
        return self.optimizer.state_dict()

    def load_state_dict(self, state_dict) -> None:
        self.optimizer.load_state_dict(state_dict)
