"""Adasum in-graph: adaptive summation over a process set's ranks.

Port of ``horovod_tpu/parallel/adasum.py`` (reference:
horovod/common/ops/adasum/adasum.h:101-412). A pair merges as

    a' = (1 - dot(a,b) / (2 |a|^2)) a + (1 - dot(a,b) / (2 |b|^2)) b

over a binary tree, so the result moves between averaging (parallel
gradients) and summing (orthogonal ones). ``adasum_allreduce`` gathers
the set's tensors with one ``all_gather`` on the set's group and runs the
tree on every rank, which therefore computes the same result; dots and
norms are fp32, as in the reference's in-graph path. The negotiated eager
path runs the core's fp64 tree instead (``ops/adasum.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch.common.failure import wait
from horovod_tpu_torch.common.process_sets import global_process_set
from horovod_tpu_torch.common.process_sets import member_group


def adasum_pair(a: torch.Tensor, b: torch.Tensor,
                eps: float = 1e-30) -> torch.Tensor:
    """Merge one pair, with fp32 dot and norms (reference math,
    adasum.h:124-193); the result has ``a``'s dtype."""
    af, bf = a.float(), b.float()
    dot = torch.sum(af * bf)
    asq = torch.sum(af * af)
    bsq = torch.sum(bf * bf)
    one = torch.ones((), dtype=torch.float32, device=a.device)
    ca = torch.where(asq > eps, 1.0 - dot / (2.0 * asq), one)
    cb = torch.where(bsq > eps, 1.0 - dot / (2.0 * bsq), one)
    return (ca * af + cb * bf).to(a.dtype)


def _tree_reduce(values: Sequence[torch.Tensor]) -> torch.Tensor:
    """The binary Adasum tree over a list; an odd last value carries up."""
    vals = list(values)
    while len(vals) > 1:
        nxt = [adasum_pair(vals[i], vals[i + 1])
               for i in range(0, len(vals) - 1, 2)]
        if len(vals) % 2:
            nxt.append(vals[-1])
        vals = nxt
    return vals[0]


def adasum_allreduce(x: torch.Tensor, process_set=global_process_set
                     ) -> torch.Tensor:
    """Adasum of ``x`` over the ranks of ``process_set``, in rank order:
    one ``all_gather`` on the set's group, then the tree on every rank.
    Returns a new tensor."""
    group, n = member_group(process_set)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    wait(dist.all_gather(parts, x, group=group, async_op=True))
    return _tree_reduce(parts)


def adasum_reference(tensors):
    """Plain numpy float64 model of the same tree, for the tests."""
    import numpy as np

    def pair(a, b):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        dot = float((a * b).sum())
        asq = float((a * a).sum())
        bsq = float((b * b).sum())
        ca = 1.0 - dot / (2 * asq) if asq > 1e-30 else 1.0
        cb = 1.0 - dot / (2 * bsq) if bsq > 1e-30 else 1.0
        return ca * a + cb * b

    vals = [np.asarray(t, np.float64) for t in tensors]
    while len(vals) > 1:
        nxt = [pair(vals[i], vals[i + 1])
               for i in range(0, len(vals) - 1, 2)]
        if len(vals) % 2:
            nxt.append(vals[-1])
        vals = nxt
    return vals[0]
