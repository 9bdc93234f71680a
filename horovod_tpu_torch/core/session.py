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
  ``synchronize`` makes the caller's stream wait on it. Under a wire codec
  (``stage_wire_codec``, HVD_WIRE_CODEC) the executor runs the core's
  compressed ring and int8 error feedback on the card
  (``ops/codec.py``), where the core runs them on the host.

The session also carries the JAX package's observability and tuning
(``horovod_tpu/core/session.py:23-118``, :212-358, :439-442): a collector
publishes the core's counters into the metrics registry as deltas under
the reference's names, with the pending and stalled tensor gauges; an
aborted collective dumps both flight-recorder rings before its error
surfaces; and ``HOROVOD_AUTOTUNE`` runs the reference's tuner: ``native``
the core's own, any other truthy value ``utils/autotune.py``'s
``ParameterManager`` through ``hvd_core_set_params``, scored on the
allreduces that complete (``HOROVOD_AUTOTUNE_LOG`` logs the samples).
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
from horovod_tpu_torch.compression import codec_id
from horovod_tpu_torch.core.build import library_path
from horovod_tpu_torch.utils import metrics as _metrics


# The port's addition to the two wire-byte families' help.
_PLANE_BYTES_NOTE = (
    " Card tensors add the bytes the device plane's NCCL calls move for "
    "this rank: 2(n-1)/n of an allreduce's payload over n members, the "
    "bytes the compressed ring passes to send and recv; 0 at size 1.")

# Bridge of the native perf counters (core/src/perf.cc via
# hvd_core_counters) into the process-wide metrics registry
# (docs/metrics.md). The native side reports running totals; the
# bridge publishes deltas so registry counters stay monotonic across
# elastic resets (each reset starts a fresh core at zero).
_M_CORE = {
    "responses": _metrics.counter(
        "hvd_core_responses_total",
        "Negotiated responses executed by the native background loop."),
    "cached_responses": _metrics.counter(
        "hvd_core_cached_responses_total",
        "Responses served from the coordinator's response cache."),
    "fused_tensors": _metrics.counter(
        "hvd_core_fused_tensors_total",
        "Tensors batched into fusion-buffer executions."),
    "allreduced_tensors": _metrics.counter(
        "hvd_core_allreduced_tensors_total",
        "Tensors allreduced by the native core."),
    "allreduce_bytes": _metrics.counter(
        "hvd_core_allreduce_bytes_total",
        "Payload bytes allreduced by the native core."),
    "comm_timeouts": _metrics.counter(
        "hvd_comm_timeouts_total",
        "Blocking socket operations that hit the HOROVOD_COMM_TIMEOUT_SEC "
        "progress deadline (wedged peer / network blackhole)."),
    "aborts": _metrics.counter(
        "hvd_aborts_total",
        "Connection-abort cascades triggered by the native core after a "
        "coordination or data-plane failure."),
    "bootstrap_retries": _metrics.counter(
        "hvd_bootstrap_retries_total",
        "Jittered-backoff connect retries during bootstrap rendezvous and "
        "mesh setup."),
    # The device plane adds what its NCCL calls move for card tensors
    # (core/device_plane.py), which never touch the TCP ring.
    "tx_bytes": _metrics.counter(
        "hvd_comm_tx_bytes_total",
        "Bytes the native TCP data plane wrote to the wire (payload + "
        "frame headers, docs/wire.md)." + _PLANE_BYTES_NOTE),
    "rx_bytes": _metrics.counter(
        "hvd_comm_rx_bytes_total",
        "Bytes the native TCP data plane read from the wire (payload + "
        "frame headers)." + _PLANE_BYTES_NOTE),
    "ring_subchunk_steps": _metrics.counter(
        "hvd_ring_subchunk_steps_total",
        "Pipelined ring sub-chunk reduction steps (HVD_RING_CHUNK_BYTES "
        "schedule; 0 means the serial legacy path is in use)."),
    # The three flight-recorder families are shared with the Python
    # ring (utils/flightrec.py registers the same names); this bridge
    # folds the NATIVE ring's totals into them as deltas.
    "flightrec_events": _metrics.counter(
        "hvd_flightrec_events_total",
        "Events recorded into the flight-recorder rings (native + "
        "python; docs/flightrec.md)."),
    "flightrec_dropped": _metrics.counter(
        "hvd_flightrec_dropped_total",
        "Flight-recorder events overwritten by ring wraparound before "
        "any dump captured them."),
    "flightrec_dumps": _metrics.counter(
        "hvd_flightrec_dumps_total",
        "Flight-record dump files written (abort auto-dumps, signal "
        "dumps, on-demand dumps)."),
    # Self-healing wire (docs/wire.md#reconnect).
    "reconnects": _metrics.counter(
        "hvd_comm_reconnects_total",
        "Peer links healed in place by the self-healing wire (epoch "
        "handshake + retransmit, no world teardown)."),
    "frames_retransmitted": _metrics.counter(
        "hvd_comm_frames_retransmitted_total",
        "Frames / raw ring segments whose in-flight bytes were "
        "retransmitted across a reconnect handshake."),
    "reconnect_failures": _metrics.counter(
        "hvd_comm_reconnect_failures_total",
        "In-place reconnect attempts that exhausted "
        "HVD_WIRE_RECONNECT_SEC (or an oversize in-flight gap) and "
        "escalated to the legacy typed abort."),
    # Wire compression (docs/wire.md#compression).
    "codec_saved_bytes": _metrics.counter(
        "hvd_core_codec_saved_bytes_total",
        "Payload bytes the negotiated wire codec kept OFF the wire "
        "(raw minus encoded, summed over compressed ring sends)."),
    # Metric names are digit-free by the hvd_[a-z_]+ convention, so
    # the codec spellings are bfloat/half/qint for bf16/fp16/int8.
    "codec_bf16_sends": _metrics.counter(
        "hvd_core_codec_bfloat_sends_total",
        "Ring block sends encoded as bf16 (bfloat16) on the wire."),
    "codec_fp16_sends": _metrics.counter(
        "hvd_core_codec_half_sends_total",
        "Ring block sends encoded as fp16 (IEEE half) on the wire."),
    "codec_int8_sends": _metrics.counter(
        "hvd_core_codec_qint_sends_total",
        "Ring block sends encoded as scaled int8 on the wire "
        "(error-feedback residuals applied at submission)."),
    "retx_rings_clamped": _metrics.counter(
        "hvd_wire_retx_rings_clamped_total",
        "Per-peer retransmit rings sized below HVD_WIRE_RETRANSMIT_"
        "BUF_BYTES because the aggregate HVD_WIRE_RETRANSMIT_TOTAL_"
        "BYTES budget divided across peers was smaller (docs/"
        "fleet.md)."),
}
# The bridge's keys are the slots of hvd_core_counters, in their order
# (core/src/operations.cc).
_COUNTER_KEYS = tuple(_M_CORE)

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
    """One in-flight op: owns its buffer until completion. ``name`` is the
    name the core negotiates (int8 error feedback keys its residuals by
    it). ``result`` and ``error`` are set by the device plane's executor
    for card ops."""

    __slots__ = ("kind", "name", "buf", "group", "index", "shape", "dtype",
                 "card", "stream", "ready", "result", "error",
                 "submitted_at")

    def __init__(self, kind, buf, group, index, shape, dtype, card=False,
                 stream=None, ready=None, name=None):
        self.kind = kind
        self.name = name
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
        # For the hvd_stalled_tensors gauge: an op this old with no
        # completion is wedged in negotiation or behind a dead peer.
        self.submitted_at = time.monotonic()


class _Group:
    """Aggregates per-tensor completions into one Future over a list.

    ``future.card_events`` collects the device plane's done events of the
    group's card tensors, for ``synchronize`` to wait on;
    ``future.card_ready`` is the readiness event of its first card tensor,
    where the timeline's card span starts."""

    def __init__(self, n):
        self.results: List = [None] * n
        self.remaining = n
        self.future: Future = Future()
        self.future.card_events = []
        self.future.card_ready = None
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
            ("hvd_core_set_params", [D, L], None),
            ("hvd_core_set_wire_params", [L, L], None),
            ("hvd_core_autotune_start", [ctypes.c_char_p], I),
            ("hvd_core_autotune_state", [ctypes.POINTER(D), I], None),
            ("hvd_core_fusion_bytes", [], L),
            ("hvd_core_flightrec_dump", [ctypes.c_char_p], I),
            ("hvd_core_timeline_start", [ctypes.c_char_p, I], I),
            ("hvd_core_timeline_stop", [], None),
            ("hvd_core_set_callback", [_CALLBACK_TYPE], None),
            ("hvd_core_wire_codec", [], I),
            ("hvd_core_stage_codec", [I], I),
            ("hvd_core_codec_ring", [I, L, LP, I], None),
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
        # The Python timeline (utils/timeline.py) while one is open: the
        # device plane times its events only then.
        self.timeline = None
        self._autotune = None
        self._autotune_mode = os.environ.get("HOROVOD_AUTOTUNE", "")
        if self._autotune_mode not in ("", "0", "native"):
            from horovod_tpu_torch.utils.autotune import ParameterManager

            self._autotune = ParameterManager(
                self.set_params,
                log_file=os.environ.get("HOROVOD_AUTOTUNE_LOG") or None)
        # Kept alive for the library's lifetime; installed after init.
        self._trampoline = _CALLBACK_TYPE(self._on_done)
        # The metrics bridge: the last native totals published, so that
        # the collector publishes deltas. The lock and the closed flag
        # order a scrape's counters() before shutdown frees the core.
        self._metrics_last: Dict[str, int] = {}
        self._metrics_lock = threading.Lock()
        self._metrics_closed = False
        # The hvd_stalled_tensors threshold; a malformed or non-positive
        # value (the core's "disabled") keeps the 60 s default, so the
        # gauge stays useful when stall enforcement is off.
        try:
            self._stall_warn_seconds = float(
                os.environ.get("HOROVOD_STALL_CHECK_TIME_SECONDS", "60")
                or 60)
        except ValueError:
            self._stall_warn_seconds = 60.0
        if self._stall_warn_seconds <= 0:
            self._stall_warn_seconds = 60.0

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
        if session._autotune_mode == "native":
            log = os.environ.get("HOROVOD_AUTOTUNE_LOG")
            lib.hvd_core_autotune_start(log.encode() if log else None)
        # Keyed: an elastic reset's new session replaces the old one's.
        _metrics.register_collector("core_session", session._publish_metrics)
        return session

    def shutdown(self):
        _metrics.unregister_collector("core_session")
        try:
            self._publish_metrics()  # the last deltas
        except Exception:  # noqa: BLE001 — never blocks the shutdown
            pass
        # A scrape inside counters() holds the lock: the native teardown
        # comes strictly after it.
        with self._metrics_lock:
            self._metrics_closed = True
        _metrics.set_pending_tensors(0, 0)
        self._lib.hvd_core_shutdown()
        if self.plane is not None:
            self.plane.close()
            self.plane = None

    def _publish_metrics(self):
        """The collector: the core's counter deltas and the pending and
        stalled tensors."""
        with self._metrics_lock:
            if self._metrics_closed:
                return
            for key, total in self.counters().items():
                delta = total - self._metrics_last.get(key, 0)
                if delta > 0:
                    _M_CORE[key].inc(delta)
                    self._metrics_last[key] = total
            # Under the closed guard too: a scrape racing shutdown must
            # not overwrite its final set_pending_tensors(0, 0).
            now = time.monotonic()
            with self._lock:
                ages = [now - p.submitted_at for p in self._pending.values()]
            stalled = sum(1 for a in ages if a > self._stall_warn_seconds)
            _metrics.set_pending_tensors(len(ages), stalled)

    def attach_timeline(self, timeline):
        """The Python timeline of ``basics.start_timeline``, or None."""
        self.timeline = timeline

    def set_params(self, cycle_ms: float = -1.0, fusion_bytes: int = -1):
        """Retune the live core: the cycle time applies at once, a fusion
        threshold at the coordinator's next broadcast; a value <= 0 leaves
        its knob as it is."""
        self._lib.hvd_core_set_params(cycle_ms, fusion_bytes)

    def set_wire_params(self, ring_chunk_bytes: int = -1,
                        socket_buf_bytes: int = -1):
        """Retune the TCP ring's wire knobs on the live core
        (``horovod_tpu/core/session.py:600-610``): the ring's sub-chunk
        size applies from the next ring step, and the socket-buffer size
        resizes every live peer socket and pins an override for future
        connects. -1 leaves a knob as it is; 0 means something for both
        (the serial ring schedule, the kernel's own buffer sizes). Card
        tensors never take the TCP ring, so neither moves them."""
        self._lib.hvd_core_set_wire_params(int(ring_chunk_bytes),
                                           int(socket_buf_bytes))

    def fusion_bytes(self) -> int:
        """The fusion threshold this core runs with now."""
        return self._lib.hvd_core_fusion_bytes()

    def autotune_state(self):
        """The core's own tuner (``HOROVOD_AUTOTUNE=native``): its point,
        whether it froze, its samples and the categorical chain; None
        when it is not running."""
        if self._autotune_mode != "native":
            return None
        buf = (ctypes.c_double * 7)()
        self._lib.hvd_core_autotune_state(buf, 7)
        return {"fusion_mb": buf[0], "cycle_ms": buf[1],
                "done": bool(buf[2]), "samples": int(buf[3]),
                "cache_enabled": bool(buf[4]),
                "hierarchical": bool(buf[5]),
                "categorical_samples": int(buf[6])}

    @property
    def autotune(self):
        """The Python ``ParameterManager`` (``HOROVOD_AUTOTUNE`` truthy,
        not ``native``), or None."""
        return self._autotune

    def dump_flight_record(self, path: str) -> bool:
        """Write the native flight-recorder ring to ``path`` as JSONL;
        False when the recorder is off (HVD_FLIGHTREC=0) or the write
        failed. ``utils/flightrec.dump`` writes both rings."""
        return self._lib.hvd_core_flightrec_dump(path.encode()) >= 0

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
            if exc_cls is HorovodAbortedError:
                # Evidence before the error: both rings, while the events
                # that explain the abort are still in them (rate-limited).
                from horovod_tpu_torch.utils import flightrec

                flightrec.dump_on_abort(msg)
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
        if self._autotune is not None and pending.kind == OP_ALLREDUCE:
            self._autotune.record(pending.buf.numel()
                                  * pending.buf.element_size(),
                                  time.monotonic())
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
            if group.future.card_ready is None:
                group.future.card_ready = ready
            name = DEVICE_PREFIX + name
            data = ctypes.c_void_p(tag)
        else:
            data = ctypes.c_void_p(buf.data_ptr())
        pending = _Pending(kind, buf, group, index, in_shape, buf.dtype,
                           card, stream, ready, name)
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
        """The core's 22 counters (``hvd_core_counters``), under the keys
        of the metrics bridge's ``_M_CORE``: responses, cached responses,
        fused and allreduced tensors, allreduce bytes, comm timeouts,
        aborts, bootstrap retries, wire bytes, ring sub-chunk steps, the
        native flight recorder's events, drops and dumps, the wire's
        reconnects, the codecs' saved bytes and sends (which the device
        plane's compressed ring adds to as the TCP ring does) and the
        clamped retransmit rings."""
        buf = (ctypes.c_longlong * len(_COUNTER_KEYS))()
        self._lib.hvd_core_counters(buf, len(_COUNTER_KEYS))
        return dict(zip(_COUNTER_KEYS, buf))

    def stage_wire_codec(self, codec) -> bool:
        """Stage a wire codec (id or name: none/bf16/fp16/int8) for the
        coordinator to adopt and broadcast at its next negotiation round,
        so every rank flips codecs in the same cycle (as
        ``horovod_tpu/core/session.py:612-626``). Lossy codecs trade
        gradient precision for wire bytes; stage before or between
        training phases. False when the core is down or the codec is
        unknown."""
        cid = codec_id(codec)
        if cid is None:
            return False
        return self._lib.hvd_core_stage_codec(cid) == 0

    def wire_codec(self) -> int:
        """The adopted wire codec id (0 none, 1 bf16, 2 fp16, 3 int8; -1
        when the core is down). A staged codec shows only after the
        coordinator's broadcast."""
        return self._lib.hvd_core_wire_codec()

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
    dst.card_ready = src.card_ready

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
