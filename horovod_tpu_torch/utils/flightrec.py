"""Python-side flight recorder: event ring, crash dumps, failure log.

Port of ``horovod_tpu/utils/flightrec.py``, with its JSONL schema, so that
``python -m tools.trace`` reads the port's dumps. The native core keeps its
own ring of coordination and wire events (``core/src/flightrec.cc``); this
module is the mirror for the Python planes (eager submit/complete, elastic
commit/reset/recovery) and holds the dump triggers that fire both rings:

- ``dump_on_abort(reason)``: when a collective surfaces a
  ``HorovodAbortedError`` (``core/session.py``), or the failure watch
  aborts the world's process groups (``common/failure.py``);
- SIGTERM (``install_signal_handler``): the elastic driver's wedge-cull
  grace window;
- ``hvd.dump_flight_record()`` and ``GET /debug/flightrec`` on the
  metrics server: on-demand dumps of a live job.

Dumps are JSONL: one header line with the wall/monotonic clock pair that
``tools/trace`` aligns ranks with, then one event per line, oldest first.

Knobs, as in the reference: ``HVD_FLIGHTREC`` (default on; ``0`` disables
both rings), ``HVD_FLIGHTREC_EVENTS`` (ring capacity, default 2048 here,
4096 native), ``HVD_FLIGHTREC_DIR`` (dump directory, default the cwd),
``HVD_FLIGHTREC_SIGNAL`` (``0`` disables the SIGTERM dump).
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Dict, List, Optional

from horovod_tpu_torch.utils import metrics as _metrics

_M_EVENTS = _metrics.counter(
    "hvd_flightrec_events_total",
    "Events recorded into the flight-recorder rings (native + python; "
    "bounded ring, overwrites count in hvd_flightrec_dropped_total).")
_M_DROPPED = _metrics.counter(
    "hvd_flightrec_dropped_total",
    "Flight-recorder events overwritten by ring wraparound before any "
    "dump captured them (nonzero = raise HVD_FLIGHTREC_EVENTS if the "
    "lost window matters).")
_M_DUMPS = _metrics.counter(
    "hvd_flightrec_dumps_total",
    "Flight-record dump files written (abort auto-dumps, SIGTERM "
    "dumps, hvd.dump_flight_record() and /debug/flightrec calls).")

_DEFAULT_EVENTS = 2048


def enabled() -> bool:
    """Recorder gate: HVD_FLIGHTREC=0 disables (default on — the ring
    is bounded and recording is an in-memory append)."""
    return os.environ.get("HVD_FLIGHTREC", "1") != "0"


def _capacity() -> int:
    try:
        n = int(os.environ.get("HVD_FLIGHTREC_EVENTS",
                               str(_DEFAULT_EVENTS)))
    except ValueError:
        return _DEFAULT_EVENTS
    return max(64, min(n, 1 << 20))


def dump_dir() -> str:
    return os.environ.get("HVD_FLIGHTREC_DIR") or "."


class FlightRecorder:
    """Bounded in-memory event ring for one process's Python planes.

    All state mutates under one lock; recording is an in-memory list
    store (no I/O), so the lock is held for microseconds and the
    recorder stays cheap enough to be always on.
    """

    def __init__(self, capacity: Optional[int] = None):
        # RLock, deliberately: the SIGTERM dump handler runs on the
        # main thread and may interrupt a record() that already holds
        # this lock — a non-reentrant lock would deadlock the dump
        # (and suppress the chained graceful handler) in exactly the
        # wedge-cull window the recorder exists for.
        self._lock = threading.RLock()
        self._capacity = int(capacity) if capacity else _capacity()
        self._slots: List[Optional[dict]] = [None] * self._capacity
        self._head = 0
        self._dropped = 0
        self._t0 = time.monotonic()

    def _now_us(self) -> int:
        return int((time.monotonic() - self._t0) * 1e6)

    def record(self, kind: str, name: str = "", **fields) -> bool:
        """Append one event; True when it overwrote an older one
        (ring wraparound — the module-level ``record`` folds that into
        ``hvd_flightrec_dropped_total``)."""
        ev = {"ts_us": self._now_us(), "kind": kind, "name": name}
        ev.update(fields)
        with self._lock:
            dropped = self._head >= self._capacity
            if dropped:
                self._dropped += 1
            self._slots[self._head % self._capacity] = ev
            self._head += 1
        return dropped

    def snapshot(self) -> Dict[str, object]:
        """Consistent (head, dropped, events-oldest-first) view."""
        with self._lock:
            head = self._head
            dropped = self._dropped
            if head <= self._capacity:
                events = [e for e in self._slots[:head]]
            else:
                cut = head % self._capacity
                events = self._slots[cut:] + self._slots[:cut]
        return {"head": head, "dropped": dropped,
                "events": [e for e in events if e is not None]}

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"events_total": self._head, "dropped": self._dropped,
                    "capacity": self._capacity}

    def dump(self, path: str, rank: int = -1,
             reason: str = "") -> int:
        """Write the ring to ``path`` as JSONL (header + events, oldest
        first). Returns the number of events written."""
        snap = self.snapshot()
        header = {
            "flightrec": 1,
            "source": "python",
            "rank": rank,
            "pid": os.getpid(),
            "wall_ts": time.time(),
            "mono_us": self._now_us(),
            "events_total": snap["head"],
            "dropped": snap["dropped"],
        }
        if reason:
            header["reason"] = reason
        events = snap["events"]
        with open(path, "w") as f:
            f.write(json.dumps(header) + "\n")
            for ev in events:
                f.write(json.dumps(ev) + "\n")
        return len(events)


_recorder_lock = threading.Lock()
_recorder: Optional[FlightRecorder] = None


def recorder() -> FlightRecorder:
    """The process-wide recorder (created on first use)."""
    global _recorder
    with _recorder_lock:
        if _recorder is None:
            _recorder = FlightRecorder()
        return _recorder


def record(kind: str, name: str = "", **fields) -> None:
    """Record one event (no-op when HVD_FLIGHTREC=0). The hot-path
    entry every instrumented plane calls."""
    if not enabled():
        return
    if recorder().record(kind, name, **fields):
        _M_DROPPED.inc()
    _M_EVENTS.inc()


# --- recent failure reasons --------------------------------------------------
# The last N abort/wedge/cull reasons this process saw, surfaced in
# /healthz and hvd.metrics_snapshot() so an operator sees WHY the job
# degraded without opening a dump (satellite of docs/flightrec.md).

_RECENT_MAX = 16
# RLock for the same signal-reentrancy reason as FlightRecorder._lock:
# the SIGTERM handler calls record_failure() and may interrupt a
# record_failure() already holding this lock on the main thread.
_failures_lock = threading.RLock()
_recent_failures: List[dict] = []


def record_failure(kind: str, detail: str, **fields) -> None:
    """Remember an abort/wedge/cull reason (bounded, newest last) and
    mirror it into the event ring."""
    entry = {"ts": time.time(), "kind": kind, "detail": detail}
    entry.update(fields)
    with _failures_lock:
        _recent_failures.append(entry)
        del _recent_failures[:-_RECENT_MAX]
    record("failure", name=kind, detail=detail)


def recent_failures() -> List[dict]:
    """The last N failure reasons, oldest first (copies)."""
    with _failures_lock:
        return [dict(e) for e in _recent_failures]


# --- dump triggers -----------------------------------------------------------

def _rank() -> int:
    try:
        return int(os.environ.get("HOROVOD_RANK", "0") or 0)
    except ValueError:
        return 0


def dump_paths(directory: Optional[str] = None) -> Dict[str, str]:
    """The (python, native) dump file paths for this rank."""
    d = directory or dump_dir()
    r = _rank()
    return {
        "python": os.path.join(d, "flightrec.rank%d.python.jsonl" % r),
        "native": os.path.join(d, "flightrec.rank%d.native.jsonl" % r),
    }


def dump(directory: Optional[str] = None,
         reason: str = "on demand") -> Dict[str, str]:
    """Dump both rings (python here; native via the live CoreSession)
    into ``directory`` (default HVD_FLIGHTREC_DIR). Returns the paths
    actually written. Never raises: a failed dump is a logged no-op —
    evidence collection must not take down the process it describes."""
    out: Dict[str, str] = {}
    if not enabled():
        return out
    paths = dump_paths(directory)
    d = os.path.dirname(paths["python"])
    try:
        if d:
            os.makedirs(d, exist_ok=True)
        recorder().dump(paths["python"], rank=_rank(), reason=reason)
        out["python"] = paths["python"]
        _M_DUMPS.inc()
    except OSError:
        pass
    try:
        from horovod_tpu_torch.common import basics

        core = basics.core_session()
        if core is not None and core.dump_flight_record(paths["native"]):
            out["native"] = paths["native"]
    except Exception:  # noqa: BLE001 — a dead or
        # half-shut-down core must not turn the dump path into a
        # second failure; the python-side dump above already landed.
        pass
    return out


_abort_dump_lock = threading.Lock()
_last_abort_dump = [0.0]


def dump_on_abort(reason: str) -> Dict[str, str]:
    """Abort-path dump trigger (core/session.py): rate-limited to one
    dump per 5 s so an abort storm (every pending op failing at once)
    writes one coherent pair of files, not hundreds of rewrites."""
    if not enabled():
        return {}
    now = time.monotonic()
    with _abort_dump_lock:
        if now - _last_abort_dump[0] < 5.0:
            return {}
        _last_abort_dump[0] = now
    record_failure("abort", reason)
    return dump(reason=reason)


_signal_installed = [False]


def install_signal_handler() -> bool:
    """Chain a SIGTERM handler that dumps both rings before the
    previous disposition runs — the elastic driver's wedge-cull grace
    window (SIGTERM -> SIGKILL) is exactly this dump's budget.
    HVD_FLIGHTREC_SIGNAL=0 disables. Main-thread only (signal module
    restriction); returns True when installed."""
    if not enabled() or os.environ.get("HVD_FLIGHTREC_SIGNAL", "1") == "0":
        return False
    if _signal_installed[0]:
        return True
    if threading.current_thread() is not threading.main_thread():
        return False
    try:
        previous = signal.getsignal(signal.SIGTERM)

        def _on_sigterm(signum, frame):
            record_failure("sigterm", "SIGTERM received")
            dump(reason="SIGTERM")
            if callable(previous):
                previous(signum, frame)
            elif previous == signal.SIG_DFL:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, _on_sigterm)
    except (ValueError, OSError):
        return False
    _signal_installed[0] = True
    return True
