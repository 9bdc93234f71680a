"""The torch binding's DistributedOptimizer: one named allreduce per
gradient through the negotiated eager path.

Port of ``horovod_tpu/torch/optimizer.py`` (reference:
horovod/torch/optimizer.py:35-332 _DistributedOptimizer): a hook on each
parameter fires an async named ``allreduce_async_`` as soon as its
gradient has accumulated; the ranks may fire them in any order, since the
core negotiates the order of execution and fuses what is ready together.
``step()`` synchronizes every handle before the update. Card gradients are
reduced in place on the card by the device plane. It keeps
``gradient_predivide_factor``, ``backward_passes_per_step``, the sparse
path and ``skip_synchronize``. Hooks are registered only when there is
someone to reduce with: above size 1, or on a process set other than the
global one (which is how a size-1 run sends every gradient through the
core). The top-level package's ``DistributedOptimizer``
(``horovod_tpu_torch/optimizer.py``) is the bucketed in-graph one.

Adasum (the delta optimizer) runs through the core on host and card
tensors alike: card deltas are merged by the device plane's fp64 tree
(``core/device_plane.py``). Unlike the reference, it also takes a
``process_set``, whose ranks merge their deltas.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.process_sets import global_process_set
from horovod_tpu_torch.torch import mpi_ops
from horovod_tpu_torch.torch.compression import Compression


class _DistributedOptimizer(torch.optim.Optimizer):
    def __init__(self, params, named_parameters, compression, op,
                 gradient_predivide_factor, backward_passes_per_step,
                 process_set, sparse_as_dense=False):
        super(self.__class__, self).__init__(params)
        # Contract validation lives in the DistributedOptimizer
        # factory, shared with the Adasum class.
        self._compression = compression
        self._op = op
        self.sparse_as_dense = sparse_as_dense
        self._process_set = process_set
        self.backward_passes_per_step = backward_passes_per_step
        self._gradient_predivide_factor = gradient_predivide_factor

        if named_parameters is not None:
            named_parameters = list(named_parameters)
        else:
            named_parameters = [
                ("allreduce.noname.%s.%s" % (i, j), v)
                for i, pg in enumerate(self.param_groups)
                for j, v in enumerate(pg["params"])]
        # Names must agree across ranks (dict order is deterministic).
        self._parameter_names = {v: k for k, v in named_parameters}
        self._handles = {}
        self._grad_accs = []
        self._requires_update = set()
        self._synchronized = False
        self._should_synchronize = True
        self._passes_done = {}
        if basics.size() > 1 or process_set is not global_process_set:
            self._register_hooks()

    def _register_hooks(self):
        for param_group in self.param_groups:
            for p in param_group["params"]:
                if p.requires_grad:
                    self._requires_update.add(p)
                    self._passes_done[p] = 0
                    p.register_post_accumulate_grad_hook(self._make_hook(p))

    def _make_hook(self, p):
        def hook(param):
            self._passes_done[p] += 1
            if self._passes_done[p] == self.backward_passes_per_step:
                handle, ctx = self._allreduce_grad_async(p)
                self._handles[p] = (handle, ctx)

        return hook

    def _allreduce_grad_async(self, p):
        name = self._parameter_names.get(p)
        grad = p.grad
        if grad.is_sparse:
            # Sparse gradients (e.g. sparse embedding layers):
            # densify when asked, else allgather-based sparse allreduce
            # (reference: optimizer.py:186-190, :215-217).
            if self.sparse_as_dense:
                grad = grad.to_dense()
                p.grad = grad
            else:
                if self.backward_passes_per_step > 1:
                    grad = grad / self.backward_passes_per_step
                handle = mpi_ops.sparse_allreduce_async(
                    grad, name=name, op=self._op,
                    process_set=self._process_set)
                return handle, (None, None, p)
        if self.backward_passes_per_step > 1:
            grad = grad / self.backward_passes_per_step
        if self._gradient_predivide_factor != 1.0:
            # Split the averaging around the reduction; pre x post
            # cancel so the final scale is unchanged (reference:
            # optimizer.py:196-200 — prescale 1/f, postscale f). The
            # sparse path above ignores the factor for the same
            # reason: it is scale-neutral by construction.
            prescale = 1.0 / self._gradient_predivide_factor
            postscale = self._gradient_predivide_factor
        else:
            prescale = postscale = 1.0
        tensor_compressed, ctx = self._compression.compress(grad)
        handle = mpi_ops.allreduce_async_(
            tensor_compressed, name=name, op=self._op,
            prescale_factor=prescale, postscale_factor=postscale,
            process_set=self._process_set)
        return handle, (ctx, tensor_compressed, p)

    def synchronize(self):
        """Complete all outstanding gradient allreduces
        (reference: optimizer.py:249-292)."""
        for p in self._requires_update:
            if p not in self._handles and self._passes_done.get(p, 0) >= \
                    self.backward_passes_per_step:
                # Hook may have been missed (e.g. unused param): allreduce
                # the existing grad so ranks stay in lockstep.
                self._handles[p] = self._allreduce_grad_async(p)
        for p, (handle, (ctx, compressed, _)) in list(self._handles.items()):
            if callable(handle):  # sparse: handle() builds the tensor
                p.grad = handle()
            else:
                output = mpi_ops.synchronize(handle)
                p.grad.copy_(self._compression.decompress(output, ctx))
            self._passes_done[p] = 0
        self._handles.clear()
        self._synchronized = True

    @contextlib.contextmanager
    def skip_synchronize(self):
        """(reference: optimizer.py:294-311)"""
        self._should_synchronize = False
        try:
            yield
        finally:
            self._should_synchronize = True

    def step(self, closure=None):
        if self._should_synchronize:
            self.synchronize()
        self._synchronized = False
        return super(self.__class__, self).step(closure)

    def _reset(self):
        """Drop the handles of a failed world, whose collectives will not
        complete, and the failed step's passes. The elastic restore
        (``elastic/state.py``) calls it before it zeroes the gradients."""
        self._handles.clear()
        for p in self._passes_done:
            self._passes_done[p] = 0

    def zero_grad(self, *args, **kwargs):
        if self._handles:
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() "
                "but before optimizer.step() or optimizer.synchronize(); "
                "this is prohibited as it can cause a race condition "
                "(reference: horovod/torch/optimizer.py:327-332).")
        return super(self.__class__, self).zero_grad(*args, **kwargs)


class _DistributedAdasumOptimizer(torch.optim.Optimizer):
    """Delta-Adasum: run the local optimizer step per parameter inside
    the backward hook, allreduce the resulting parameter *delta* with
    op=Adasum (orthogonality-weighted merge), and apply the combined
    delta to the synchronized start point (reference:
    horovod/torch/optimizer.py:335-503 _DistributedAdasumOptimizer —
    same stash-groups/step-one-param/delta trick)."""

    def __init__(self, params, named_parameters, compression,
                 backward_passes_per_step=1, process_set=global_process_set):
        super(self.__class__, self).__init__(params)
        self._compression = compression
        self._process_set = process_set
        if named_parameters is not None:
            named_parameters = list(named_parameters)
        else:
            named_parameters = [
                ("allreduce.noname.%s.%s" % (i, j), v)
                for i, pg in enumerate(self.param_groups)
                for j, v in enumerate(pg["params"])]
        self._parameter_names = {v: k for k, v in named_parameters}
        self.backward_passes_per_step = backward_passes_per_step
        self._passes_done = {}
        self._handles = {}
        self._requires_update = set()
        # The agreed model state deltas apply to; updated by step().
        self._starting_models = {
            p: torch.zeros_like(p, requires_grad=False)
            for _, p in named_parameters}
        for param_group in self.param_groups:
            for p in param_group["params"]:
                if p.requires_grad:
                    self._requires_update.add(p)
                    self._passes_done[p] = 0
                    p.register_post_accumulate_grad_hook(
                        self._make_hook(p))

    def _make_hook(self, p):
        def hook(param):
            self._passes_done[p] += 1
            if self._passes_done[p] == self.backward_passes_per_step:
                self._handles[p] = self._allreduce_delta_async(p)

        return hook

    def _allreduce_delta_async(self, p):
        name = self._parameter_names.get(p)
        start = self._starting_models[p]
        # Step ONLY p through the underlying optimizer, then turn the
        # result into a delta from the agreed start point.
        stashed = []
        for group in self.param_groups:
            stashed.append(group["params"])
            group["params"] = ([p] if any(p is v
                                          for v in group["params"])
                               else [])
        start.data.copy_(p)
        super(self.__class__, self).step()
        p.data.sub_(start)
        compressed, ctx = self._compression.compress(p)
        # .data: the in-place reduce writes through detached storage,
        # not the autograd leaf (reference: optimizer.py:438-439).
        handle = mpi_ops.allreduce_async_(
            compressed.data, name=name, op=mpi_ops.Adasum,
            process_set=self._process_set)
        for st, group in zip(stashed, self.param_groups):
            group["params"] = st
        return handle, ctx

    def synchronize(self):  # parity: reference's is a no-op too
        pass

    @contextlib.contextmanager
    def skip_synchronize(self):
        raise AssertionError(
            "Skipping synchronization is not supported when using "
            "Adasum optimizer.")

    def step(self, closure=None):
        loss = closure() if closure is not None else None
        for p in self._requires_update - set(self._handles):
            self._handles[p] = self._allreduce_delta_async(p)
        for p, (handle, ctx) in list(self._handles.items()):
            delta = self._compression.decompress(
                mpi_ops.synchronize(handle), ctx)
            start = self._starting_models[p]
            start.data.add_(delta.data)
            p.data.copy_(start)
            self._passes_done[p] = 0
        self._handles.clear()
        return loss

    _reset = _DistributedOptimizer._reset

    def zero_grad(self, *args, **kwargs):
        if self._handles:
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() "
                "but before optimizer.step(); this is prohibited with "
                "the Adasum optimizer.")
        return super(self.__class__, self).zero_grad(*args, **kwargs)


def DistributedOptimizer(optimizer, named_parameters=None,
                         compression=Compression.none,
                         op=mpi_ops.Average,
                         gradient_predivide_factor=1.0,
                         backward_passes_per_step=1,
                         sparse_as_dense=False,
                         process_set=global_process_set):
    """Wrap a torch optimizer so gradients are allreduced during backward
    (reference: horovod/torch/optimizer.py:528-590; sparse gradients
    via allgather or densified with ``sparse_as_dense``; op=Adasum uses
    the delta algorithm, reference :335-503)."""
    # Validate here so BOTH optimizer classes (average and Adasum)
    # share the contract.
    if backward_passes_per_step < 1:
        raise ValueError(
            "backward_passes_per_step must be >= 1, got %r"
            % (backward_passes_per_step,))
    if named_parameters is not None:
        named_parameters = list(named_parameters)
        names = [k for k, _ in named_parameters]
        if len(set(names)) != len(names):
            # Duplicate names would collide in the core's tensor table
            # (reference: optimizer.py duplicate-name check).
            dupes = sorted({k for k in names if names.count(k) > 1})
            raise ValueError(
                "named_parameters contains duplicate names: %r"
                % (dupes,))
    if op == mpi_ops.Adasum:
        if gradient_predivide_factor != 1.0:
            # Reference: gradient_predivide_factor is Average-only
            # (optimizer.py:567-570 raises the same way).
            raise ValueError(
                "gradient_predivide_factor not supported with "
                "op=Adasum")
        if sparse_as_dense:
            raise ValueError(
                "sparse_as_dense not supported with op=Adasum")
        cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
                   dict(_DistributedAdasumOptimizer.__dict__))
        return cls(optimizer.param_groups, named_parameters, compression,
                   backward_passes_per_step, process_set)
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    return cls(optimizer.param_groups, named_parameters, compression, op,
               gradient_predivide_factor, backward_passes_per_step,
               process_set, sparse_as_dense=sparse_as_dense)
