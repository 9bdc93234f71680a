"""Collectives of picklable objects.

Port of ``horovod_tpu/common/objects.py``: pickle to a uint8 wire tensor,
exchange the sizes, then the payload. The wire tensor is made on the
group's device (the card under NCCL, which cannot move host tensors).
On a set of one rank both are the identity, as in the reference. The
host reads sizes and payloads through ``failure.host_read`` and writes
them through ``failure.to_wire``, so that no blocking CUDA call holds the
host while the failure watch aborts NCCL (ROADMAP C11).
"""

from __future__ import annotations

import pickle
from typing import Any, List, Optional

import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.failure import host_read, mapped, to_wire
from horovod_tpu_torch.common.process_sets import global_process_set
from horovod_tpu_torch.common.process_sets import member_group
from horovod_tpu_torch.ops import collective_ops as C


def _to_wire(obj: Any) -> torch.Tensor:
    payload = bytearray(pickle.dumps(obj))
    return to_wire(torch.frombuffer(payload, dtype=torch.uint8), torch.uint8,
                   C.group_device())


def _read(buf: torch.Tensor) -> torch.Tensor:
    with mapped():
        return host_read(buf)


def _from_wire(buf: torch.Tensor) -> Any:
    return pickle.loads(buf.numpy().tobytes())


def broadcast_object(obj: Any, root_rank: int = 0,
                     name: Optional[str] = None,
                     process_set=global_process_set) -> Any:
    """``root_rank``'s ``obj`` on every rank: its pickled length is
    broadcast, then the payload. ``name`` is the reference's; the process
    group matches collectives by their order, so it names nothing here."""
    _, n = member_group(process_set)
    if n == 1:
        return obj
    device = C.group_device()
    if basics.rank() == root_rank:
        buf = _to_wire(obj)
        size = to_wire([buf.numel()], torch.int64, device)
    else:
        size = torch.zeros(1, dtype=torch.int64, device=device)
    # The host reads both: each wait settles on the card as well, so that
    # a failed world raises here instead of blocking in the read.
    C.BroadcastFlight(size, root_rank, process_set).finish(host=True)
    if basics.rank() != root_rank:
        buf = torch.empty(int(_read(size)[0]), dtype=torch.uint8,
                          device=device)
    return _from_wire(_read(C.BroadcastFlight(buf, root_rank,
                                              process_set).finish(host=True)))


def allgather_object(obj: Any, name: Optional[str] = None,
                     process_set=global_process_set) -> List[Any]:
    """One ``obj`` per rank, in rank order (``name`` as in
    ``broadcast_object``)."""
    _, n = member_group(process_set)
    if n == 1:
        return [obj]
    buf = _to_wire(obj)
    sizes = _read(C.allgather(to_wire([buf.numel()], torch.int64, buf.device),
                              process_set=process_set)).tolist()
    data = _read(C.allgather(buf, process_set=process_set))
    out, offset = [], 0
    for size in sizes:
        out.append(_from_wire(data[offset:offset + size]))
        offset += size
    return out
