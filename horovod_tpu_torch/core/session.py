"""ctypes session over the port's native coordination core.

Port of ``horovod_tpu/core/session.py``: Python submits named tensors to
the C++ background loop and learns of their completion through one
callback trampoline keyed by integer tags. The core negotiates the order
of execution across ranks, so ranks may submit in any order.

Two data planes sit under the one negotiation:

* a host tensor is passed by pointer and moved by the core's own CPU TCP
  ring, exactly as in the JAX package;
* a tensor on the card is submitted under the device prefix with its tag
  in place of a pointer, after a readiness event is recorded on the
  caller's stream. The core hands its negotiated response to the device
  plane's executor (``core/device_plane.py``), which packs, reduces over
  NCCL and unpacks on a side stream and records a done event;
  ``synchronize`` makes the caller's stream wait on it.

The Python-side metrics bridge, flight recorder and timeline of the JAX
package's session wait for ROADMAP A14; the core keeps its own timeline
and flight recorder.
"""

from __future__ import annotations

import ctypes
import itertools
import os
import threading
import time
import zlib
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import torch

from horovod_tpu_torch.common.exceptions import (
    HorovodAbortedError,
    HorovodInternalError,
)
from horovod_tpu_torch.core.build import library_path

# StatusType values that mean a peer is dead or wedged (core/src/common.h).
STATUS_ABORTED = 3
STATUS_TIMED_OUT = 6

# OpType values must match core/src/common.h.
OP_ALLREDUCE = 0
OP_ALLGATHER = 1
OP_BROADCAST = 2
OP_ALLTOALL = 3
OP_JOIN = 4
OP_BARRIER = 5
OP_REDUCESCATTER = 6

# The name prefix that routes a tensor to the device plane
# (core/src/device_plane.cc kDevicePrefix).
DEVICE_PREFIX = "@dev/"

# DataType values of core/src/common.h.
DTYPE_CODES = {
    torch.uint8: 0, torch.int8: 1, torch.int32: 2, torch.int64: 3,
    torch.float16: 4, torch.float32: 5, torch.float64: 6, torch.bool: 7,
    torch.bfloat16: 8,
}
CODE_DTYPES = {code: dt for dt, code in DTYPE_CODES.items()}

# Wire codec ids of core/src/codec.h (0 = none).
_CODEC_NONE = 0

_CALLBACK_TYPE = ctypes.CFUNCTYPE(
    None, ctypes.c_longlong, ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int)


def dtype_code(dtype: torch.dtype) -> int:
    code = DTYPE_CODES.get(dtype)
    if code is None:
        raise TypeError("Unsupported dtype for native collectives: %r"
                        % (dtype,))
    return code


def wire_shape(t: torch.Tensor) -> tuple:
    """The shape the core negotiates: a 0-dim tensor travels as 1-D, as
    ``np.ascontiguousarray`` makes it in the JAX package."""
    return tuple(t.shape) or (1,)


class _Pending:
    """One in-flight op: owns its buffer until completion. ``result`` and
    ``error`` are set by the device plane's executor for card ops."""

    __slots__ = ("kind", "buf", "group", "index", "shape", "dtype", "card",
                 "stream", "ready", "result", "error")

    def __init__(self, kind, buf, group, index, shape, dtype, card=False,
                 stream=None, ready=None):
        self.kind = kind
        self.buf = buf
        self.group = group
        self.index = index
        self.shape = shape
        self.dtype = dtype
        self.card = card
        self.stream = stream
        self.ready = ready
        self.result = None
        self.error = None


class _Group:
    """Aggregates per-tensor completions into one Future over a list.

    ``future.card_events`` collects the device plane's done events of the
    group's card tensors, for ``synchronize`` to wait on."""

    def __init__(self, n):
        self.results: List = [None] * n
        self.remaining = n
        self.future: Future = Future()
        self.future.card_events = []
        self.error = None

    def complete(self, index, result, error=None):
        if error is not None and self.error is None:
            self.error = error
        self.results[index] = result
        self.remaining -= 1
        if self.remaining == 0:
            if self.error is not None:
                self.future.set_exception(self.error)
            else:
                self.future.set_result(self.results)


def _signature(lib):
    P, I, L, D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_double)
    LP = ctypes.POINTER(ctypes.c_longlong)
    for name, argtypes, restype in (
            ("hvd_core_init", [I, I, ctypes.c_char_p, I, D, L, I], I),
            ("hvd_core_enqueue", [L, I, ctypes.c_char_p, I, P, LP, I, I, D,
                                  D, I, I, LP, I, L], I),
            ("hvd_core_join", [L, I], I),
            ("hvd_core_counters", [LP, I], None),
            ("hvd_core_timeline_start", [ctypes.c_char_p, I], I),
            ("hvd_core_timeline_stop", [], None),
            ("hvd_core_set_callback", [_CALLBACK_TYPE], None),
            ("hvd_core_wire_codec", [], I),
            ("hvd_core_hierarchical", [], I),
            ("hvd_core_running", [], I),
            ("hvd_core_shutdown", [], None)):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


class CoreSession:
    """Owns the native core's lifecycle for this process."""

    def __init__(self, lib, topology):
        self._lib = lib
        self._topology = topology
        self._lock = threading.Lock()
        self._pending: Dict[int, _Pending] = {}
        self._tags = itertools.count(1)
        self.backend = NativeBackend(self)
        # The device plane (core/device_plane.py) that card tensors go
        # to; None routes every tensor through the TCP ring.
        self.plane = None
        # Kept alive for the library's lifetime; installed after init.
        self._trampoline = _CALLBACK_TYPE(self._on_done)

    # --- lifecycle ---------------------------------------------------------

    @classmethod
    def start(cls, topology, addr: str, port: int) -> "CoreSession":
        """Start the core: rank 0 listens on ``addr:port`` for the others.
        The knobs keep their JAX-package meaning: HOROVOD_CYCLE_TIME (ms),
        HOROVOD_FUSION_THRESHOLD (bytes), HOROVOD_CACHE_CAPACITY."""
        lib = ctypes.CDLL(library_path())
        _signature(lib)
        cycle_ms = float(os.environ.get("HOROVOD_CYCLE_TIME", "1.0"))
        session = cls(lib, topology)
        rc = lib.hvd_core_init(
            topology.rank, topology.size, addr.encode(), port, cycle_ms,
            fusion_threshold(), int(os.environ.get("HOROVOD_CACHE_CAPACITY",
                                                   "1024")))
        if rc != 0:
            raise RuntimeError(
                "Native core initialization failed (rc=%d); check that all "
                "ranks are running and the controller address %s:%d is "
                "reachable." % (rc, addr, port))
        lib.hvd_core_set_callback(session._trampoline)
        return session

    def shutdown(self):
        self._lib.hvd_core_shutdown()
        if self.plane is not None:
            self.plane.close()
            self.plane = None

    def running(self) -> bool:
        """Whether the background loop still coordinates: False once a
        peer closed its connection, a failure cascaded, or after
        ``shutdown``."""
        return self._lib.hvd_core_running() == 1

    def start_core_timeline(self, path: str,
                            mark_cycles: bool = False) -> bool:
        """Chrome-trace spans of the background loop (negotiation and
        each response's execution)."""
        return self._lib.hvd_core_timeline_start(
            path.encode(), 1 if mark_cycles else 0) == 0

    def stop_core_timeline(self):
        self._lib.hvd_core_timeline_stop()

    # --- completion trampoline --------------------------------------------

    def pending(self, tag: int) -> Optional[_Pending]:
        with self._lock:
            return self._pending.get(tag)

    def _on_done(self, tag, status, err, out_ptr, out_bytes, splits_ptr,
                 n_splits):
        with self._lock:
            pending = self._pending.pop(tag, None)
        if pending is None:
            return
        if status != 0:
            msg = err.decode() if err else "collective failed"
            exc_cls = (HorovodAbortedError
                       if status in (STATUS_ABORTED, STATUS_TIMED_OUT)
                       else HorovodInternalError)
            pending.group.complete(pending.index, None,
                                   pending.error or exc_cls(msg))
            return
        try:
            if pending.card:
                result = pending.result  # set by the device plane
            else:
                result = self._materialize(pending, out_ptr, out_bytes,
                                           splits_ptr, n_splits)
        except Exception as e:  # never throw into C
            pending.group.complete(pending.index, None, e)
            return
        pending.group.complete(pending.index, result)

    def _materialize(self, pending, out_ptr, out_bytes, splits_ptr,
                     n_splits):
        kind = pending.kind
        if kind in (OP_ALLREDUCE, OP_BROADCAST):
            return pending.buf.reshape(pending.shape)
        if kind == OP_JOIN:
            return int(ctypes.cast(
                out_ptr, ctypes.POINTER(ctypes.c_longlong)).contents.value)
        if kind == OP_BARRIER:
            return None
        # Ops with core-owned output buffers: copy out under the callback.
        itemsize = torch.empty((), dtype=pending.dtype).element_size()
        n_elems = int(out_bytes) // itemsize
        flat = torch.empty(n_elems, dtype=pending.dtype)
        if out_bytes:
            ctypes.memmove(flat.data_ptr(), out_ptr, int(out_bytes))
        tail = tuple(pending.shape[1:])
        slice_elems = 1
        for d in tail:
            slice_elems *= int(d)
        rows = n_elems // slice_elems if slice_elems else 0
        out = flat.reshape((rows,) + tail)
        if kind == OP_ALLTOALL:
            counts = [splits_ptr[i] // slice_elems for i in range(n_splits)]
            return out, torch.tensor(counts, dtype=torch.int32)
        if kind in (OP_ALLGATHER, OP_REDUCESCATTER):
            return out
        raise ValueError("unknown op kind %r" % kind)

    # --- submission --------------------------------------------------------

    def on_plane(self, tensor: torch.Tensor) -> bool:
        """Whether ``tensor`` goes to the device plane."""
        return (self.plane is not None
                and tensor.device.type == self.plane.device.type)

    def check_card_op(self, kind: int):
        """What the device plane does not run raises at submission, on
        every rank alike, never sending at full width silently. The
        executor checks the codec again at execution, since it is
        negotiated. Under HOROVOD_HIERARCHICAL_ALLREDUCE the plane runs
        the flat NCCL allreduce, as the core does: the flag only rides
        the response broadcast."""
        if kind not in (OP_ALLREDUCE, OP_REDUCESCATTER):
            return
        if self._lib.hvd_core_wire_codec() not in (_CODEC_NONE, -1):
            raise NotImplementedError(
                "a wire codec (HVD_WIRE_CODEC) on card tensors needs device "
                "quantize/dequantize kernels (ROADMAP, Queue A item 7)")

    def submit(self, kind, name, tensor, *, group, index, op=1, root_rank=0,
               prescale=1.0, postscale=1.0, ps_id=0, splits=None,
               group_id=-1, inplace=False, card=None):
        """Enqueue one named tensor. Allreduce, broadcast and reducescatter
        work in place on the buffer handed to the core: a private copy,
        unless ``inplace`` asks for the caller's own contiguous tensor.
        ``card`` (default: whether the tensor is on the plane's device)
        sends it to the device plane."""
        in_shape = tuple(tensor.shape)
        if card is None:
            card = self.on_plane(tensor)
        buf = tensor.detach()
        if kind in (OP_ALLREDUCE, OP_BROADCAST, OP_REDUCESCATTER):
            if not (inplace and buf.is_contiguous()):
                buf = buf.clone(memory_format=torch.contiguous_format)
        else:
            buf = buf.contiguous()
        shape = wire_shape(buf)
        shape_c = (ctypes.c_longlong * len(shape))(*shape)
        if splits is not None:
            splits = [int(s) for s in splits]
            splits_c = (ctypes.c_longlong * len(splits))(*splits)
        else:
            splits_c = None
        tag = next(self._tags)
        stream = ready = None
        if card:
            if self.plane.cuda:
                stream = torch.cuda.current_stream(self.plane.device)
            ready = self.plane.ready_event()
            name = DEVICE_PREFIX + name
            data = ctypes.c_void_p(tag)
        else:
            data = ctypes.c_void_p(buf.data_ptr())
        pending = _Pending(kind, buf, group, index, in_shape, buf.dtype,
                           card, stream, ready)
        with self._lock:
            self._pending[tag] = pending
        rc = self._lib.hvd_core_enqueue(
            tag, kind, name.encode(), dtype_code(buf.dtype), data, shape_c,
            len(shape), root_rank, prescale, postscale, ps_id, op, splits_c,
            len(splits) if splits is not None else 0, group_id)
        if rc != 0:
            with self._lock:
                self._pending.pop(tag, None)
            if rc == -5:
                group.complete(index, None, HorovodAbortedError(
                    "coordination core is shut down (%s)" % name))
            elif rc != -4:  # -4: the core already failed it (duplicate)
                group.complete(index, None, RuntimeError(
                    "enqueue failed rc=%d (%s)" % (rc, name)))

    def submit_join(self, ps_id=0) -> Future:
        group = _Group(1)
        tag = next(self._tags)
        with self._lock:
            self._pending[tag] = _Pending(OP_JOIN, None, group, 0, (),
                                          torch.int64)
        if self._lib.hvd_core_join(tag, ps_id) != 0:
            with self._lock:
                self._pending.pop(tag, None)
            group.complete(0, None, RuntimeError("join enqueue failed"))
        return _first(group.future)

    def counters(self) -> Dict[str, int]:
        """The core's counters: responses, cached responses, fused and
        allreduced tensors, allreduce bytes, comm timeouts and aborts."""
        buf = (ctypes.c_longlong * 7)()
        self._lib.hvd_core_counters(buf, 7)
        return dict(zip(("responses", "cached_responses", "fused_tensors",
                         "allreduced_tensors", "allreduce_bytes",
                         "comm_timeouts", "aborts"), buf))

    def add_process_set(self, ps_id: int, ranks: Sequence[int]):
        """Collective: every rank calls it, in the same order."""
        group = _Group(1)
        self.submit(OP_BARRIER, "__ps_add__%d" % ps_id,
                    torch.zeros(0, dtype=torch.uint8), group=group, index=0,
                    root_rank=ps_id, ps_id=0, splits=list(ranks), card=False)
        group.future.result(timeout=120)

    def remove_process_set(self, ps_id: int):
        group = _Group(1)
        self.submit(OP_BARRIER, "__ps_remove__%d" % ps_id,
                    torch.zeros(0, dtype=torch.uint8), group=group, index=0,
                    root_rank=ps_id, ps_id=0, card=False)
        group.future.result(timeout=120)


def fusion_threshold() -> int:
    """HOROVOD_FUSION_THRESHOLD, 128 MiB by default as in the reference
    (horovod/common/operations.cc:488)."""
    return int(os.environ.get("HOROVOD_FUSION_THRESHOLD",
                              str(128 * 1024 * 1024)))


def wait_event(event, poll_sec: float = 1e-4) -> None:
    """Wait on the host for a card event, raising
    ``HorovodInternalError`` if the world fails meanwhile (an event behind
    a collective that a dead peer hangs would never fire)."""
    from horovod_tpu_torch.common import failure

    while not event.query():
        failure.check()
        time.sleep(poll_sec)


def _first(src: Future) -> Future:
    """A future of ``src``'s first result."""
    dst = Future()
    dst.card_events = src.card_events

    def _done(f):
        try:
            dst.set_result(f.result()[0])
        except Exception as e:
            dst.set_exception(e)

    src.add_done_callback(_done)
    return dst


class NativeBackend:
    """Backend of ``horovod_tpu_torch.ops.eager`` over the native core."""

    def __init__(self, session: CoreSession):
        self._s = session

    @staticmethod
    def _ps_id(process_set) -> int:
        ps_id = getattr(process_set, "process_set_id", 0)
        if ps_id is None:
            raise RuntimeError("Process set is not registered")
        return ps_id

    def _submit_all(self, kind, tensors, names, process_set, **kw):
        group = _Group(len(tensors))
        ps_id = self._ps_id(process_set)
        for t in tensors:
            if self._s.on_plane(t):
                self._s.check_card_op(kind)
        for i, (t, name) in enumerate(zip(tensors, names)):
            self._s.submit(kind, name, t, group=group, index=i, ps_id=ps_id,
                           **kw)
        return group.future

    def allreduce_async(self, tensors, names, op, prescale, postscale,
                        process_set, inplace=False) -> Future:
        # Explicit groups co-schedule all-or-nothing through the core's
        # group table; the id is derived from the (rank-agreed) names.
        group_id = (zlib.crc32("|".join(names).encode())
                    if len(tensors) > 1 else -1)
        return self._submit_all(OP_ALLREDUCE, tensors, names, process_set,
                                op=op, prescale=prescale,
                                postscale=postscale, group_id=group_id,
                                inplace=inplace)

    def allgather_async(self, tensors, names, process_set) -> Future:
        return self._submit_all(OP_ALLGATHER, tensors, names, process_set)

    def broadcast_async(self, tensors, names, root_rank, process_set,
                        inplace=False) -> Future:
        return self._submit_all(OP_BROADCAST, tensors, names, process_set,
                                root_rank=root_rank, inplace=inplace)

    def alltoall_async(self, tensor, splits, process_set, name) -> Future:
        return _first(self._submit_all(OP_ALLTOALL, [tensor], [name],
                                       process_set, splits=splits))

    def reducescatter_async(self, tensors, names, op, process_set) -> Future:
        return self._submit_all(OP_REDUCESCATTER, tensors, names,
                                process_set, op=op)

    def barrier(self, process_set, name):
        """On a session with a device plane the barrier is the plane's:
        it returns once every rank's earlier card collectives are done."""
        like = (torch.zeros(0, dtype=torch.uint8,
                            device=self._s.plane.device)
                if self._s.plane is not None
                else torch.zeros(0, dtype=torch.uint8))
        future = self._submit_all(OP_BARRIER, [like], [name], process_set)
        result = future.result(timeout=300)
        for event in future.card_events:
            wait_event(event)
        return result

    def join(self) -> int:
        return self._s.submit_join(0).result(timeout=300)
