"""The device data plane: runs the native core's responses of card tensors.

The JAX package moves every eager collective through the core's CPU TCP
ring and stages device arrays through host memory
(``horovod_tpu/ops/eager.py:13-17``). Here a tensor on the card stays
there. The core negotiates it like any other tensor, and then, instead of
its TCP ring and fusion memcpy, calls ``DevicePlane._run`` (through the
hook in ``core/src/device_plane.cc``) on its background thread with the
negotiated response. The executor:

* makes its side stream wait on each entry's readiness event, recorded on
  the caller's stream at submission, so no host sync is needed;
* runs the response as one ``torch.distributed`` call on a process group
  of its own (one per process set, made at init or by
  ``add_process_set``): the main thread's in-graph collectives never
  share those communicators, since two threads issuing on one
  communicator can order their calls differently on different ranks;
* packs a fused allreduce into one persistent fusion buffer and unpacks
  it with the hand-written kernels of ``ops/fusion.py``, scaling as the
  core's ScaleBuffer does; a one-tensor response is reduced in place;
* runs an Adasum response as the core's AdasumAllreduce does, on the
  whole fused response at once (``ops/adasum.py``): pack with prescale,
  to fp64 in a persistent scratch, the binary tree over the set's members
  with one NCCL send/recv of the fp64 buffer per level and per-tensor
  coefficients from the ``adasum_dots``/``adasum_combine`` kernels, a
  broadcast from the first member, back to the dtype, unpack with
  postscale. A joined rank adds zeros, as in the core;
* runs the flat allreduce under HOROVOD_HIERARCHICAL_ALLREDUCE, as the
  core does (the flag only rides its response broadcast, and its native
  plane has no hierarchical algorithm);
* records a done event, which ``synchronize`` makes the caller's stream
  wait on, and marks every tensor it touched as used by its stream, so
  the caching allocator does not hand the memory out while NCCL still
  reads it.

Nothing here may raise into C: an error is returned through the core's
status and completes the response's entries with it, as
``HorovodInternalError``; the core then stops, and the failure watch
(``common/failure.py``) aborts the plane's groups with the others. The
executor never blocks its thread on the card, so that the core's loop
goes on seeing its peers. The executor runs on the CPU too (gloo, plain
pack/unpack) when a test attaches it there.
"""

from __future__ import annotations

import contextlib
import ctypes
import traceback
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch.core import session as S
from horovod_tpu_torch.ops import adasum
from horovod_tpu_torch.ops import fusion

_EXECUTOR_TYPE = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_int,
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
    ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_int)

# ReduceOp values of core/src/common.h.
_AVERAGE, _SUM, _ADASUM, _MIN, _MAX, _PRODUCT = range(6)
_TORCH_OPS = {_AVERAGE: dist.ReduceOp.SUM, _SUM: dist.ReduceOp.SUM,
              _MIN: dist.ReduceOp.MIN, _MAX: dist.ReduceOp.MAX,
              _PRODUCT: dist.ReduceOp.PRODUCT}

_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor as the backend moves it: bool as its bytes, because the
    core reduces bool as uint8 (1 + 1 = 2) where NCCL would take a
    logical or."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _prod(dims) -> int:
    n = 1
    for d in dims:
        n *= int(d)
    return n


class DevicePlane:
    """The executor of one process's card responses."""

    def __init__(self, session, device: torch.device):
        self.session = session
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.groups: Dict[int, object] = {}
        self.fusion_bytes = S.fusion_threshold()
        self._buffer: Optional[torch.Tensor] = None
        # Adasum's two fp64 buffers (mine, theirs), grown as needed.
        self._adasum_scratch: Optional[torch.Tensor] = None
        # Process sets whose plane group has run a collective: the first
        # call on an NCCL group must involve every member, and a tree
        # level's send/recv does not.
        self._warm = set()
        # Responses run, for the record of a step.
        self.responses = 0
        self._fn = _EXECUTOR_TYPE(self._run)
        session._lib.hvd_core_set_device_executor.argtypes = [_EXECUTOR_TYPE]
        session._lib.hvd_core_set_device_executor.restype = None
        session._lib.hvd_core_set_device_executor(self._fn)
        session.plane = self

    def close(self):
        self.session._lib.hvd_core_set_device_executor(
            ctypes.cast(None, _EXECUTOR_TYPE))

    def ready_event(self):
        """A readiness event on the caller's stream, or None on the CPU."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    # --- the callback ------------------------------------------------------

    def _run(self, ps_id, op_type, reduce_op, dtype, root_rank, prescale,
             postscale, n_tensors, tags, n_sizes, sizes, n_members, members,
             wire_codec, hierarchical, err, err_cap):
        # ``hierarchical`` (the negotiated flag) changes nothing: the
        # plane runs flat under it, as the core does.
        try:
            self._execute(ps_id, op_type, reduce_op, S.CODE_DTYPES[dtype],
                          root_rank, prescale, postscale,
                          [tags[i] for i in range(n_tensors)],
                          [sizes[i] for i in range(n_sizes)],
                          [members[i] for i in range(n_members)],
                          wire_codec)
            return 0
        except BaseException as e:  # noqa: B036 — never raise into C
            msg = ("%s: %s\n%s" % (type(e).__name__, e,
                                   traceback.format_exc(limit=4))).encode()
            msg = msg[:max(err_cap - 1, 0)]
            ctypes.memmove(err, msg + b"\0", len(msg) + 1)
            return 1

    def _execute(self, ps_id, op_type, reduce_op, dtype, root_rank,
                 prescale, postscale, tags, sizes, members, wire_codec):
        if op_type in (S.OP_ALLREDUCE, S.OP_REDUCESCATTER) and \
                wire_codec not in (0, -1):
            raise NotImplementedError(
                "wire codec %d on card tensors (ROADMAP, Queue A item 7)"
                % wire_codec)
        if self.cuda:
            # The current device is per thread: this is the core's.
            torch.cuda.set_device(self.device)
        pendings = [self.session.pending(t) if t else None for t in tags]
        group = self.groups[ps_id]
        me = members.index(dist.get_rank())
        ctx = (torch.cuda.stream(self.stream) if self.cuda
               else contextlib.nullcontext())
        with ctx:
            for p in pendings:
                if p is not None and p.ready is not None:
                    self.stream.wait_event(p.ready)
            if op_type == S.OP_ALLREDUCE and reduce_op == _ADASUM:
                self._adasum(ps_id, group, pendings, sizes, dtype, prescale,
                             postscale, members, me)
            elif op_type == S.OP_ALLREDUCE:
                self._allreduce(group, pendings, sizes, dtype, reduce_op,
                                prescale, postscale, len(members))
            elif op_type == S.OP_ALLGATHER:
                self._allgather(group, pendings[0], sizes, dtype, me)
            elif op_type == S.OP_BROADCAST:
                self._broadcast(group, pendings[0], sizes, dtype, root_rank)
            elif op_type == S.OP_ALLTOALL:
                self._alltoall(group, pendings[0], sizes, dtype, me,
                               len(members))
            elif op_type == S.OP_REDUCESCATTER:
                self._reducescatter(group, pendings[0], sizes, dtype,
                                    reduce_op, me, len(members))
            elif op_type == S.OP_BARRIER:
                self._barrier(group)
            else:
                raise ValueError("op %d has no device path" % op_type)
            if self.cuda:
                self._finish(pendings)
        self._warm.add(ps_id)
        self.responses += 1

    def _finish(self, pendings):
        done = torch.cuda.Event()
        done.record(self.stream)
        for p in pendings:
            if p is None:
                continue
            events = p.group.future.card_events
            if not events or events[-1] is not done:
                events.append(done)
            if p.buf.device.type == "cuda":
                p.buf.record_stream(self.stream)
            results = (p.result if isinstance(p.result, tuple)
                       else (p.result,))
            for r in results:
                if (isinstance(r, torch.Tensor) and r.device.type == "cuda"
                        and p.stream is not None):
                    r.record_stream(p.stream)

    # --- the ops -------------------------------------------------------------

    def _fusion(self, count: int, dtype: torch.dtype) -> torch.Tensor:
        """The persistent fusion buffer as ``count`` elements of ``dtype``:
        allocated once at HOROVOD_FUSION_THRESHOLD (on the card) and grown
        only when a response needs more."""
        nbytes = count * torch.empty((), dtype=dtype).element_size()
        if self._buffer is None or self._buffer.numel() < nbytes:
            size = max(nbytes, self.fusion_bytes) if self.cuda else nbytes
            self._buffer = torch.empty(size, dtype=torch.uint8,
                                       device=self.device)
        return self._buffer[:nbytes].view(dtype)

    def _entries(self, pendings):
        """The response's flat tensors on the plane's device (None where
        this rank joined and adds zeros), and the host tensors staged
        through the card, as (host, card) pairs."""
        entries: List[Optional[torch.Tensor]] = []
        staged = []
        for p in pendings:
            if p is None:
                entries.append(None)
                continue
            t = p.buf.view(-1)
            if t.device != self.device:
                # A host tensor fused with card ones: through the card.
                staged.append((t, t.to(self.device)))
                t = staged[-1][1]
            entries.append(t)
        return entries, staged

    @staticmethod
    def _results(pendings, staged):
        for host, card in staged:
            host.copy_(card)
        for p in pendings:
            if p is not None and p.card:
                p.result = p.buf.reshape(p.shape)

    def _allreduce(self, group, pendings, sizes, dtype, reduce_op, prescale,
                   postscale, n_members):
        # operations.cc:240-405: Average is a Sum and then one scale by
        # avg * postscale, a single product taken in double.
        post = (1.0 / n_members if reduce_op == _AVERAGE else 1.0) \
            * postscale
        entries, staged = self._entries(pendings)
        op = _TORCH_OPS[reduce_op]
        if len(entries) == 1 and entries[0] is not None:
            # One tensor: reduced in place, no pack (operations.cc:319).
            t = entries[0]
            fusion.scale_(t, prescale)
            dist.all_reduce(_wire(t), op=op, group=group)
            fusion.scale_(t, post)
        else:
            offsets = fusion.offsets_of(sizes)
            buf = self._fusion(sum(sizes), dtype)
            fusion.pack(buf, entries, sizes, offsets, prescale)
            dist.all_reduce(_wire(buf), op=op, group=group)
            fusion.unpack(buf, entries, sizes, offsets, post)
        self._results(pendings, staged)

    def _adasum(self, ps_id, group, pendings, sizes, dtype, prescale,
                postscale, members, me):
        # operations.cc:298-317 and collectives.cc:197-245, on the whole
        # response: the core scales, converts and merges tensor by
        # tensor, the arithmetic is the same per tensor.
        adasum.check_floating(dtype)
        entries, staged = self._entries(pendings)
        offsets = fusion.offsets_of(sizes)
        total = sum(sizes)
        buf = self._fusion(total, dtype)
        fusion.pack(buf, entries, sizes, offsets, prescale)
        mine, theirs = self._scratch(total)
        if dtype == torch.float64:
            mine = buf
        else:
            adasum.to_double(buf, mine)
        n = len(members)
        if n > 1:
            if ps_id not in self._warm:
                dist.all_reduce(torch.zeros(1, device=self.device),
                                group=group)
            segs = adasum.Segments(sizes, self.device)

            def exchange(send_to, recv_from, mine, theirs):
                op = (dist.P2POp(dist.isend, mine, members[send_to], group)
                      if send_to is not None else
                      dist.P2POp(dist.irecv, theirs, members[recv_from],
                                 group))
                for work in dist.batch_isend_irecv([op]):
                    work.wait()

            adasum.tree(mine, theirs, segs, me, n, exchange)
            dist.broadcast(mine, src=members[0], group=group)
        if dtype != torch.float64:
            adasum.from_double(mine, buf)
        fusion.unpack(buf, entries, sizes, offsets, postscale)
        self._results(pendings, staged)

    def _scratch(self, count: int):
        """Adasum's persistent fp64 buffers, ``count`` elements each."""
        if self._adasum_scratch is None or \
                self._adasum_scratch.numel() < 2 * count:
            self._adasum_scratch = torch.empty(
                2 * count, dtype=torch.float64, device=self.device)
        half = self._adasum_scratch.numel() // 2
        return (self._adasum_scratch[:count],
                self._adasum_scratch[half:half + count])

    def _allgather(self, group, p, sizes, dtype, me):
        # Ragged: every rank sends its rows padded to the longest, and
        # the padding is cut out with the unpack kernel.
        most = max(sizes)
        if p is not None and all(c == most for c in sizes):
            src = p.buf.view(-1)
        else:
            src = torch.empty(most, dtype=dtype, device=self.device)
            if p is not None:
                fusion.pack(src, [p.buf.view(-1)], [sizes[me]], [0])
        gathered = torch.empty(most * len(sizes), dtype=dtype,
                               device=self.device)
        _all_gather(_wire(gathered), _wire(src), group=group)
        if p is None:
            return
        if all(c == most for c in sizes):
            flat = gathered
        else:
            flat = torch.empty(sum(sizes), dtype=dtype, device=self.device)
            offsets = fusion.offsets_of(sizes)
            fusion.unpack(gathered,
                          [flat[o:o + c] for o, c in zip(offsets, sizes)],
                          sizes, [k * most for k in range(len(sizes))])
        tail = tuple(p.shape[1:])
        p.result = flat.reshape((flat.numel() // max(_prod(tail), 1),)
                                + tail)

    def _broadcast(self, group, p, sizes, dtype, root_rank):
        t = (p.buf.view(-1) if p is not None
             else torch.empty(sizes[0], dtype=dtype, device=self.device))
        dist.broadcast(_wire(t), src=root_rank, group=group)
        if p is not None:
            p.result = p.buf.reshape(p.shape)

    def _alltoall(self, group, p, sizes, dtype, me, n):
        send = [sizes[me * n + j] for j in range(n)]
        recv = [sizes[j * n + me] for j in range(n)]
        src = (p.buf.view(-1) if p is not None
               else torch.empty(0, dtype=dtype, device=self.device))
        out = torch.empty(sum(recv), dtype=dtype, device=self.device)
        dist.all_to_all_single(_wire(out), _wire(src),
                               output_split_sizes=recv,
                               input_split_sizes=send, group=group)
        if p is not None:
            tail = tuple(p.shape[1:])
            slice_elems = max(_prod(tail), 1)
            p.result = (out.reshape((out.numel() // slice_elems,) + tail),
                        torch.tensor([c // slice_elems for c in recv],
                                     dtype=torch.int32))

    def _reducescatter(self, group, p, sizes, dtype, reduce_op, me, n):
        # operations.cc:490-528: reduce the whole tensor, then keep this
        # member's dim-0-balanced rows (the first rows % n members get one
        # more), scaled by 1/n for Average.
        count = sizes[0]
        t = (p.buf.view(-1) if p is not None
             else torch.zeros(count, dtype=dtype, device=self.device))
        dist.all_reduce(_wire(t), op=_TORCH_OPS[reduce_op], group=group)
        if p is None:
            return
        rows = S.wire_shape(p.buf)[0]
        slice_elems = count // (rows or 1)
        base, extra = divmod(rows, n)
        my_rows = base + (1 if me < extra else 0)
        start = me * base + min(me, extra)
        out = torch.empty(my_rows * slice_elems, dtype=dtype,
                          device=self.device)
        fusion.unpack(t, [out], [out.numel()], [start * slice_elems],
                      1.0 / n if reduce_op == _AVERAGE else 1.0)
        tail = tuple(p.shape[1:])
        p.result = out.reshape((out.numel() // max(_prod(tail), 1),) + tail)

    def _barrier(self, group):
        # One allreduce on the plane's own group: once its done event has
        # fired, every rank's earlier card collectives have run. The
        # caller waits on that event (``NativeBackend.barrier``), not this
        # thread: the core's loop must stay free to see a peer's death.
        token = torch.zeros(1, dtype=torch.int32, device=self.device)
        dist.all_reduce(token, group=group)


def attach(session, device: torch.device, world_size: int) -> DevicePlane:
    """Give ``session`` a device plane on ``device`` with its own process
    group over the whole world (process set 0). Every rank calls it, after
    the default process group exists."""
    plane = DevicePlane(session, device)
    plane.groups[0] = dist.new_group(list(range(world_size)))
    return plane
