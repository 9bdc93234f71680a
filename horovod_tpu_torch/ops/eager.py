"""Eager (op-by-op) collectives with async handles.

Port of ``horovod_tpu/ops/eager.py``: named tensors are submitted
asynchronously, negotiated across processes by the native core's
background loop, executed in the order the coordinator decides, and
completed through handles (``poll``/``synchronize``). Ranks may submit
their tensors in any order.

Dispatch: the native core (``horovod_tpu_torch.core.session``), which
``basics.init`` starts at every world size. Host tensors take the core's
CPU TCP ring; card tensors take the device plane
(``core/device_plane.py``), and ``synchronize`` makes the caller's stream
wait on the plane's done event before it returns them. ``LocalBackend`` is
the plain size-1 semantics, which the tests and ``chip_smoke.py`` hold
the core's results to.

Every op is observed as in the JAX package (``_next_seq`` :77,
``_record_timeline`` :157, ``_record_flight`` :164, ``_observe_metrics``
:209, ``_observed_sync`` :457): a span on the timeline, ``submit`` and
``complete`` (or ``error``) flight records stamped with the set's
sequence number, and the ``hvd_collective*`` families. For a tensor on the
card the latency runs from submission to the device plane's done event:
``_CardLatency`` observes it from a daemon thread once the event's
``query()`` is true, so neither the submission nor ``synchronize`` waits
on the card for it.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from concurrent.futures import Future
from typing import Dict, Optional, Sequence

import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.exceptions import HorovodInternalError
from horovod_tpu_torch.common.process_sets import global_process_set
from horovod_tpu_torch.ops import fusion
from horovod_tpu_torch.ops.collective_ops import Average, Sum
from horovod_tpu_torch.utils import flightrec
from horovod_tpu_torch.utils import metrics as _metrics

# Per-collective telemetry (docs/metrics.md), by op kind.
_M_COLLECTIVES = _metrics.counter(
    "hvd_collectives_total",
    "Completed eager collectives on this process.", ("op",))
_M_ERRORS = _metrics.counter(
    "hvd_collective_errors_total",
    "Eager collectives that completed with an error.", ("op",))
_M_LATENCY = _metrics.histogram(
    "hvd_collective_latency_seconds",
    "Submit-to-completion latency of eager collectives.", ("op",),
    buckets=_metrics.DEFAULT_LATENCY_BUCKETS)
_M_BYTES = _metrics.histogram(
    "hvd_collective_bytes",
    "Input payload bytes per eager collective submission.", ("op",),
    buckets=_metrics.DEFAULT_BYTES_BUCKETS)

# The labelled children, each made at its first use (as the reference
# makes them, so that the exports list the same children) and kept: the
# eager step is host-bound, and the families' own label lookup (a lock
# and a tuple of strings) stays off its path.
_children: Dict[tuple, object] = {}


def _child(family, op_label: str):
    key = (family.name, op_label)
    got = _children.get(key)
    if got is None:
        got = _children[key] = family.labels(op_label)
    return got


_handle_lock = threading.Lock()
_handles: Dict[int, Future] = {}
_next_handle = itertools.count(1)
_name_counters: Dict[tuple, int] = {}
_seq_counters: Dict[int, int] = {}


def _reset_name_counters():
    """Auto-names and sequence numbers are per world: ``basics.init``
    resets them, so that the ranks of a new world agree on the next
    unnamed op's name and on its collective sequence number."""
    with _handle_lock:
        _name_counters.clear()
        _seq_counters.clear()


def _next_seq(process_set) -> int:
    """The set's next collective sequence number, stamped on the flight
    records and timeline spans at submission. The ranks of one world
    running one program agree on it, which is what lets ``tools/trace``
    find the first divergent collective after a failure."""
    ps_id = getattr(process_set, "process_set_id", 0) or 0
    with _handle_lock:
        n = _seq_counters.get(ps_id, 0)
        _seq_counters[ps_id] = n + 1
    return n


def _auto_name(kind: str, process_set=None) -> str:
    # The reference's 'allreduce.noname.<n>', counted per process set: a
    # single counter would run ahead on the members of a set, and the next
    # unnamed global op would then carry different names on different
    # ranks and never negotiate.
    ps_id = getattr(process_set, "process_set_id", 0) or 0
    key = (kind, ps_id)
    with _handle_lock:
        n = _name_counters.get(key, 0)
        _name_counters[key] = n + 1
    if ps_id == 0:
        return "%s.noname.%d" % (kind, n + 1)
    return "%s.noname.ps%d.%d" % (kind, ps_id, n + 1)


def _register(future: Future) -> int:
    with _handle_lock:
        h = next(_next_handle)
        _handles[h] = future
    return h


def poll(handle: int) -> bool:
    """True when the operation behind ``handle`` has completed on the host.
    A card result may still be in flight on the device plane's stream;
    ``synchronize`` orders the caller's stream after it."""
    with _handle_lock:
        fut = _handles.get(handle)
    if fut is None:
        raise ValueError("Unknown handle %r" % (handle,))
    return fut.done()


def synchronize(handle: int):
    """Wait for completion and return the result. For card tensors the
    caller's current stream is made to wait on the device plane's done
    event, so work queued after this call sees the result."""
    with _handle_lock:
        fut = _handles.get(handle)
    if fut is None:
        raise ValueError("Unknown handle %r" % (handle,))
    try:
        result = fut.result()
    except HorovodInternalError:
        raise
    except Exception as e:
        raise HorovodInternalError(str(e)) from e
    finally:
        with _handle_lock:
            _handles.pop(handle, None)
    for ev in getattr(fut, "card_events", ()):
        torch.cuda.current_stream().wait_event(ev)
    return result


def _backend():
    core = basics.core_session()
    if core is not None:
        return core.backend
    return _LOCAL


def _record_timeline(name: str, category: str, fut: Future, seq: int):
    tl = basics.timeline()
    if tl is not None:
        tl.record_future(name, category, fut, seq=seq)


def _record_flight(op_label: str, name: str, process_set, seq: int,
                   fut: Future) -> None:
    """``submit`` now, ``complete`` or ``error`` when the future resolves
    (no-op under HVD_FLIGHTREC=0)."""
    if not flightrec.enabled():
        return
    ps_id = getattr(process_set, "process_set_id", 0) or 0
    flightrec.record("submit", name=name, op=op_label, ps=ps_id, seq=seq)

    def _done(f: Future):
        err = f.exception()
        if err is not None:
            flightrec.record("error", name=name, op=op_label, ps=ps_id,
                             seq=seq, detail=str(err)[:200])
        else:
            flightrec.record("complete", name=name, op=op_label,
                             ps=ps_id, seq=seq)

    fut.add_done_callback(_done)


def _payload_bytes(tensors) -> int:
    """The input payload, from shape and dtype only."""
    return sum(t.numel() * t.element_size() for t in tensors)


class _CardLatency:
    """Observes the latency of card collectives off the hot path: a
    daemon thread takes them in submission order (the device plane's done
    events fire in the order it recorded them, on one stream) and, once
    an op's last done event's ``query()`` is true, observes the time from
    its submission to then. The thread sleeps while nothing is pending."""

    POLL_SEC = 1e-3

    def __init__(self):
        self._cond = threading.Condition()
        self._queue = collections.deque()
        self._thread = None

    def add(self, event, start: float, child) -> None:
        with self._cond:
            self._queue.append((event, start, child))
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name="hvd-card-latency")
                self._thread.start()
            self._cond.notify()

    def pending(self) -> int:
        with self._cond:
            return len(self._queue)

    def _loop(self):
        while True:
            with self._cond:
                while not self._queue:
                    self._cond.wait()
                event, start, child = self._queue[0]
            try:
                done = event.query()
            except RuntimeError:  # a card error: the op is not timed
                done, child = True, None
            if not done:
                time.sleep(self.POLL_SEC)
                continue
            if child is not None:
                child.observe(time.monotonic() - start)
            with self._cond:
                self._queue.popleft()


_card_latency = _CardLatency()


def card_latency_pending() -> int:
    """Card collectives whose latency is not observed yet."""
    return _card_latency.pending()


def _observe_metrics(op_label: str, tensors, fut: Future,
                     start: float) -> None:
    size = _payload_bytes(tensors)

    def _done(f: Future):
        latency = _child(_M_LATENCY, op_label)
        if f.exception() is not None:
            _child(_M_ERRORS, op_label).inc()
            latency.observe(time.monotonic() - start)
        else:
            # Liveness is stamped on success only: a loop of failing
            # collectives must let hvd_seconds_since_last_collective grow.
            _child(_M_COLLECTIVES, op_label).inc()
            _metrics.mark_collective()
            events = getattr(f, "card_events", None)
            if events:
                _card_latency.add(events[-1], start, latency)
            else:
                latency.observe(time.monotonic() - start)
        _child(_M_BYTES, op_label).observe(size)

    fut.add_done_callback(_done)


def _observed(op_label: str, name: str, process_set, tensors, submit):
    """Submit through ``submit()``, which returns the op's future, and
    observe it; returns that future."""
    seq = _next_seq(process_set)
    start = time.monotonic()
    fut = submit()
    _record_timeline(name, _CATEGORY.get(op_label, op_label), fut, seq)
    _record_flight(op_label, name, process_set, seq, fut)
    _observe_metrics(op_label, tensors, fut, start)
    return fut


# The timeline category of an op: a grouped allreduce is an allreduce.
_CATEGORY = {"grouped_allreduce": "allreduce"}


class LocalBackend:
    """World-size-1 semantics without communication: what the core returns
    at size 1. Scaling is the core's ScaleBuffer (``ops/fusion.py``)."""

    @staticmethod
    def _done(result) -> Future:
        fut = Future()
        fut.set_result(result)
        return fut

    def allreduce_async(self, tensors, names, op, prescale, postscale,
                        process_set, inplace=False) -> Future:
        # n == 1: Average == Sum == Min == Max == Product == identity.
        return self._done([fusion.scaled(fusion.scaled(t, prescale),
                                         postscale) for t in tensors])

    def allgather_async(self, tensors, names, process_set) -> Future:
        return self._done([t.clone() for t in tensors])

    def broadcast_async(self, tensors, names, root_rank, process_set,
                        inplace=False) -> Future:
        if root_rank != 0:
            fut = Future()
            fut.set_exception(ValueError(
                "root_rank %d out of range for size 1" % root_rank))
            return fut
        return self._done([t.clone() for t in tensors])

    def alltoall_async(self, tensor, splits, process_set, name) -> Future:
        if splits is not None and int(sum(splits)) != tensor.shape[0]:
            fut = Future()
            fut.set_exception(ValueError("splits must sum to dim-0 size"))
            return fut
        return self._done((tensor.clone(), torch.tensor(
            [tensor.shape[0]], dtype=torch.int32)))

    def reducescatter_async(self, tensors, names, op, process_set) -> Future:
        return self._done([t.clone() for t in tensors])

    def barrier(self, process_set, name):
        return None

    def join(self) -> int:
        return 0


_LOCAL = LocalBackend()


def _effective_op(op: Optional[int], average: Optional[bool]) -> int:
    # The reference's average= deprecation shim
    # (horovod/torch/mpi_ops.py:203-232).
    if op is not None and average is not None:
        raise ValueError("Specify either op or average, not both")
    if op is None:
        return Average if average is None or average else Sum
    return op


def _chain(src: Future, transform) -> Future:
    dst = Future()
    dst.card_events = getattr(src, "card_events", [])
    dst.card_ready = getattr(src, "card_ready", None)

    def _done(f: Future):
        try:
            dst.set_result(transform(f.result()))
        except Exception as e:  # propagate as-is; synchronize wraps
            dst.set_exception(e)

    src.add_done_callback(_done)
    return dst


# --- public eager API -------------------------------------------------------

def allreduce_async(tensor: torch.Tensor, *, name: Optional[str] = None,
                    op: Optional[int] = None,
                    average: Optional[bool] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    process_set=global_process_set,
                    inplace: bool = False) -> int:
    """``inplace`` lets the core reduce ``tensor``'s own memory (when it
    is contiguous) instead of a copy."""
    basics._require()
    op = _effective_op(op, average)
    name = name or _auto_name("allreduce", process_set)
    return _register(_observed(
        "allreduce", name, process_set, [tensor],
        lambda: _chain(_backend().allreduce_async(
            [tensor], [name], op, prescale_factor, postscale_factor,
            process_set, inplace=inplace), lambda r: r[0])))


def allreduce(tensor, **kwargs):
    return synchronize(allreduce_async(tensor, **kwargs))


def grouped_allreduce_async(tensors: Sequence[torch.Tensor], *,
                            name: Optional[str] = None,
                            op: Optional[int] = None,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0,
                            process_set=global_process_set,
                            inplace: bool = False) -> int:
    basics._require()
    op = _effective_op(op, None)
    base = name or _auto_name("grouped_allreduce", process_set)
    names = ["%s.%d" % (base, i) for i in range(len(tensors))]
    return _register(_observed(
        "grouped_allreduce", base, process_set, tensors,
        lambda: _chain(_backend().allreduce_async(
            list(tensors), names, op, prescale_factor, postscale_factor,
            process_set, inplace=inplace), list)))


def grouped_allreduce(tensors, **kwargs):
    return synchronize(grouped_allreduce_async(tensors, **kwargs))


def allgather_async(tensor: torch.Tensor, *, name: Optional[str] = None,
                    process_set=global_process_set) -> int:
    basics._require()
    name = name or _auto_name("allgather", process_set)
    return _register(_observed(
        "allgather", name, process_set, [tensor],
        lambda: _chain(_backend().allgather_async(
            [tensor], [name], process_set), lambda r: r[0])))


def allgather(tensor, **kwargs):
    return synchronize(allgather_async(tensor, **kwargs))


def broadcast_async(tensor: torch.Tensor, root_rank: int, *,
                    name: Optional[str] = None,
                    process_set=global_process_set,
                    inplace: bool = False) -> int:
    basics._require()
    name = name or _auto_name("broadcast", process_set)
    return _register(_observed(
        "broadcast", name, process_set, [tensor],
        lambda: _chain(_backend().broadcast_async(
            [tensor], [name], root_rank, process_set, inplace=inplace),
            lambda r: r[0])))


def broadcast(tensor, root_rank: int, **kwargs):
    return synchronize(broadcast_async(tensor, root_rank, **kwargs))


def alltoall_async(tensor: torch.Tensor, splits=None, *,
                   name: Optional[str] = None,
                   process_set=global_process_set) -> int:
    basics._require()
    name = name or _auto_name("alltoall", process_set)
    return _register(_observed(
        "alltoall", name, process_set, [tensor],
        lambda: _chain(_backend().alltoall_async(
            tensor, splits, process_set, name), tuple)))


def alltoall(tensor, splits=None, **kwargs):
    """Returns (output, received_splits)."""
    return synchronize(alltoall_async(tensor, splits, **kwargs))


def reducescatter_async(tensor: torch.Tensor, *, name: Optional[str] = None,
                        op: int = Sum,
                        process_set=global_process_set) -> int:
    basics._require()
    if op not in (Sum, Average):
        # The same contract on every backend, the size-1 path included.
        raise ValueError(
            "reducescatter supports Sum/Average, got op=%r" % (op,))
    name = name or _auto_name("reducescatter", process_set)
    return _register(_observed(
        "reducescatter", name, process_set, [tensor],
        lambda: _chain(_backend().reducescatter_async(
            [tensor], [name], op, process_set), lambda r: r[0])))


def reducescatter(tensor, **kwargs):
    return synchronize(reducescatter_async(tensor, **kwargs))


def _observed_sync(op_label: str, fn):
    """The blocking ops (barrier, join): count the completion or the
    error, observe the latency, stamp liveness."""
    start = time.monotonic()
    try:
        result = fn()
    except Exception:
        _child(_M_ERRORS, op_label).inc()
        raise
    _child(_M_COLLECTIVES, op_label).inc()
    _child(_M_LATENCY, op_label).observe(time.monotonic() - start)
    _metrics.mark_collective()
    return result


def barrier(process_set=global_process_set):
    """Block until all ranks in the set reach the barrier."""
    basics._require()
    # Per-set sequence numbers through the auto-name counters: a per-rank
    # counter would desynchronize members from non-members after a subset
    # barrier, and the next global barrier would never negotiate.
    name = _auto_name("__barrier__", process_set)
    return _observed_sync("barrier",
                          lambda: _backend().barrier(process_set, name))


def join() -> int:
    """Signal that this rank is out of data; blocks until all ranks join.
    Returns the highest-indexed joined rank at the completion cycle. Until
    then this rank adds zeros to the others' allreduces."""
    basics._require()
    return _observed_sync("join", lambda: _backend().join())
