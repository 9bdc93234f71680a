"""Bringing every rank to the root's model and optimizer state.

Port of ``horovod_tpu/jax/functions.py`` in the surface Horovod's torch
users call (``horovod_tpu/torch/functions.py``): before the first step a
script broadcasts rank 0's weights and optimizer state, in place::

    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)

``state_dict()`` carries the buffers too (batch-norm running statistics),
which ``named_parameters()`` does not.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Tuple, Union

import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.objects import broadcast_object
from horovod_tpu_torch.common.process_sets import global_process_set
from horovod_tpu_torch.ops import collective_ops as C


def broadcast_parameters(
        params: Union[Mapping[str, torch.Tensor],
                      Iterable[Tuple[str, torch.Tensor]]],
        root_rank: int = 0, process_set=global_process_set) -> None:
    """Overwrite each tensor of a ``state_dict()`` or of
    ``named_parameters()`` with ``root_rank``'s, in place. Every rank
    sends them sorted by name, so their order on each rank need not be
    the same; all broadcasts are launched before the first is waited
    on."""
    named = params.items() if isinstance(params, Mapping) else params
    flights = [C.BroadcastFlight(t.detach(), root_rank, process_set)
               for _, t in sorted(named, key=lambda kv: kv[0])
               if isinstance(t, torch.Tensor)]
    for flight in flights:
        flight.finish()


def broadcast_optimizer_state(optimizer, root_rank: int = 0,
                              process_set=global_process_set) -> None:
    """Give every rank ``root_rank``'s optimizer state.

    The hyperparameters and the layout of the state (which parameter
    holds which tensor, of what shape and dtype, and the non-tensor
    values) travel through ``broadcast_object``; the other ranks load
    that layout with zero tensors, and then every state tensor is
    broadcast in place. A fresh optimizer whose state is still empty (SGD
    before its first step) sends its hyperparameters and an empty state.
    Takes a ``torch.optim.Optimizer`` or a ``DistributedOptimizer``."""
    optimizer = getattr(optimizer, "optimizer", optimizer)
    state = optimizer.state_dict()
    tensors, values = {}, {}
    for pid, entries in state["state"].items():
        for key, v in entries.items():
            if isinstance(v, torch.Tensor):
                tensors.setdefault(pid, {})[key] = (tuple(v.shape), v.dtype)
            else:
                values.setdefault(pid, {})[key] = v
    groups, tensors, values = broadcast_object(
        (state["param_groups"], tensors, values), root_rank,
        process_set=process_set)
    if basics.rank() != root_rank:
        new = {pid: dict(values.get(pid, {}))
               for pid in set(tensors) | set(values)}
        for pid, entries in tensors.items():
            for key, (shape, dtype) in entries.items():
                new[pid][key] = torch.zeros(shape, dtype=dtype)
        optimizer.load_state_dict({"state": new, "param_groups": groups})
    params = [p for g in optimizer.param_groups for p in g["params"]]
    flights = [C.BroadcastFlight(optimizer.state[params[pid]][key],
                                 root_rank, process_set)
               for pid, entries in sorted(tensors.items())
               for key in sorted(entries)]
    for flight in flights:
        flight.finish()
