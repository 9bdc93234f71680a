"""Collectives of picklable objects.

Port of ``horovod_tpu/common/objects.py``: pickle to a uint8 wire tensor,
exchange the sizes, then the payload. The wire tensor is made on the
group's device (the card under NCCL, which cannot move host tensors).
On a set of one rank both are the identity, as in the reference.
"""

from __future__ import annotations

import pickle
from typing import Any, List

import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.process_sets import global_process_set
from horovod_tpu_torch.common.process_sets import member_group
from horovod_tpu_torch.ops import collective_ops as C


def _to_wire(obj: Any) -> torch.Tensor:
    payload = bytearray(pickle.dumps(obj))
    return torch.frombuffer(payload, dtype=torch.uint8).to(C.group_device())


def _from_wire(buf: torch.Tensor) -> Any:
    return pickle.loads(buf.cpu().numpy().tobytes())


def broadcast_object(obj: Any, root_rank: int = 0,
                     process_set=global_process_set) -> Any:
    """``root_rank``'s ``obj`` on every rank: its pickled length is
    broadcast, then the payload."""
    _, n = member_group(process_set)
    if n == 1:
        return obj
    device = C.group_device()
    if basics.rank() == root_rank:
        buf = _to_wire(obj)
        size = torch.tensor([buf.numel()], dtype=torch.int64, device=device)
    else:
        size = torch.zeros(1, dtype=torch.int64, device=device)
    # The host reads both: each wait settles on the card as well, so that
    # a failed world raises here instead of blocking in the read.
    C.BroadcastFlight(size, root_rank, process_set).finish(host=True)
    if basics.rank() != root_rank:
        buf = torch.empty(int(size.item()), dtype=torch.uint8, device=device)
    return _from_wire(C.BroadcastFlight(buf, root_rank,
                                        process_set).finish(host=True))


def allgather_object(obj: Any, process_set=global_process_set) -> List[Any]:
    """One ``obj`` per rank, in rank order."""
    _, n = member_group(process_set)
    if n == 1:
        return [obj]
    buf = _to_wire(obj)
    sizes = C.allgather(torch.tensor([buf.numel()], dtype=torch.int64,
                                     device=buf.device),
                        process_set=process_set).tolist()
    data = C.allgather(buf, process_set=process_set)
    out, offset = [], 0
    for size in sizes:
        out.append(_from_wire(data[offset:offset + size]))
        offset += size
    return out
