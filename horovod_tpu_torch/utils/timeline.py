"""Chrome-tracing timeline for collective operations.

Port of ``horovod_tpu/utils/timeline.py`` (reference: horovod/common/
timeline.cc:496-678): the eager layer records a span per submitted tensor
from enqueue to completion, written as a chrome://tracing JSON event array
left open for streaming. The native core writes its own timeline beside
it (``<path>.core.json``, ``basics.start_timeline``).

For a tensor on the card the span's duration is the card's own: the device
plane records a readiness event on the caller's stream at submission and a
done event on its side stream after the collective
(``core/device_plane.py``), both timing-enabled while a timeline is open.
When the host learns of the completion the span is parked; the flush
thread resolves it once the done event's ``query()`` is true, and writes
its end at the begin plus the card's milliseconds, which also go into the
end event's ``args`` as ``card_ms``. Nothing here synchronizes with the
card on the hot path: only ``close`` waits for the spans still parked.
"""

from __future__ import annotations

import json
import threading
import time
from typing import List, Optional


class Timeline:
    def __init__(self, file_path: str, mark_cycles: bool = False):
        # mark_cycles is acted on by the native writer (the op-level
        # writer has no background cycle to mark); basics.start_timeline
        # passes it to the core.
        del mark_cycles
        self._lock = threading.Lock()
        self._f = open(file_path, "w")
        self._f.write("[\n")
        self._t0 = time.perf_counter()
        self._closed = False
        self._buf = []
        # Card spans whose done event has not been seen done yet:
        # [begin_us, name, category, args, ready, done].
        self._card: List[list] = []
        self._stop_flusher = threading.Event()
        # Drains the buffer on a period independent of the producers
        # (reference: timeline.cc TimelineWriter thread), so that the
        # begin of a wedged op still reaches disk.
        self._flusher = threading.Thread(
            target=self._flush_loop, daemon=True, name="hvd-timeline")
        self._flusher.start()
        from horovod_tpu_torch.common import basics

        self._pid = basics.rank() if basics.is_initialized() else 0
        self._write({"name": "process_name", "ph": "M", "pid": self._pid,
                     "args": {"name": "horovod_tpu rank %d" % self._pid}})

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    # Producers only append under the lock; disk IO happens on the
    # flusher thread (every _FLUSH_SECONDS) or inline past _FLUSH_EVERY
    # pending events.
    _FLUSH_EVERY = 64
    _FLUSH_SECONDS = 1.0

    def _flush_locked(self):
        # The caller holds self._lock.
        if self._buf:
            self._f.write("".join(self._buf))
            self._buf.clear()
            self._f.flush()

    def _flush_loop(self):
        while not self._stop_flusher.wait(self._FLUSH_SECONDS):
            self._resolve_card()
            with self._lock:
                if self._closed:
                    return
                self._flush_locked()

    def _write(self, event: dict):
        line = json.dumps(event) + ",\n"
        with self._lock:
            if self._closed:
                return
            self._buf.append(line)
            if len(self._buf) >= self._FLUSH_EVERY:
                self._flush_locked()

    # ``pid`` overrides the event's process row (tools/trace's merged
    # multi-rank writer); in-process callers leave it None.

    def begin(self, name: str, category: str,
              args: Optional[dict] = None, pid: Optional[int] = None,
              ts: Optional[float] = None):
        ev = {"name": name, "cat": category, "ph": "B",
              "ts": self._now_us() if ts is None else ts,
              "pid": self._pid if pid is None else pid, "tid": category}
        if args:
            ev["args"] = args
        self._write(ev)

    def end(self, name: str, category: str, args: Optional[dict] = None,
            pid: Optional[int] = None, ts: Optional[float] = None):
        ev = {"name": name, "cat": category, "ph": "E",
              "ts": self._now_us() if ts is None else ts,
              "pid": self._pid if pid is None else pid, "tid": category}
        if args:
            ev["args"] = args
        self._write(ev)

    def instant(self, name: str, pid: Optional[int] = None):
        self._write({"name": name, "ph": "i", "ts": self._now_us(),
                     "pid": self._pid if pid is None else pid, "s": "p"})

    def write_raw(self, event: dict):
        """Append one pre-built Chrome-trace event."""
        self._write(event)

    def record_future(self, name: str, category: str, future,
                      seq: Optional[int] = None):
        """Span from now until the future resolves; for a future of card
        tensors (``card_ready`` and ``card_events`` set by the core's
        session), until its last done event on the card's clock. ``seq``
        is the per-process-set collective sequence number (ops/eager.py
        ``_next_seq``), stamped on both edges."""
        begin_us = self._now_us()
        self.begin(name, category,
                   args=None if seq is None else {"seq": seq}, ts=begin_us)

        def _done(f):
            err = f.exception()
            args = {"status": "error" if err else "ok"}
            if seq is not None:
                args["seq"] = seq
            ready = getattr(f, "card_ready", None)
            events = getattr(f, "card_events", None)
            if err is None and ready is not None and events:
                with self._lock:
                    if not self._closed:
                        self._card.append([begin_us, name, category, args,
                                           ready, events[-1]])
                        return
            self.end(name, category, args=args)

        future.add_done_callback(_done)

    # How long ``close`` waits for the card spans still parked: a done
    # event behind a collective that a dead peer hangs never fires.
    _CLOSE_WAIT_SECONDS = 30.0

    def _resolve_card(self, deadline: Optional[float] = None):
        """Write the end of every parked card span whose done event has
        fired, in order (the plane's done events fire in the order they
        were recorded, on one stream). With a ``deadline`` (monotonic),
        wait for each until then; a span still unresolved at the deadline
        ends without ``card_ms``."""
        while True:
            with self._lock:
                if not self._card:
                    return
                begin_us, name, category, args, ready, done = self._card[0]
            card_ms = None
            try:
                fired = done.query()
            except RuntimeError:  # a card error: the span ends untimed
                fired, ready = True, None
            if fired and ready is not None:
                try:
                    card_ms = ready.elapsed_time(done)
                except RuntimeError:
                    # An event made before the timeline opened is untimed.
                    pass
            elif deadline is None:
                return
            elif time.monotonic() < deadline:
                time.sleep(1e-3)
                continue
            if card_ms is None:
                self.end(name, category, args=args)
            else:
                args = dict(args, card_ms=card_ms)
                self.end(name, category, args=args,
                         ts=begin_us + card_ms * 1e3)
            with self._lock:
                self._card.pop(0)

    def close(self):
        self._stop_flusher.set()
        self._flusher.join(timeout=5)
        self._resolve_card(time.monotonic() + self._CLOSE_WAIT_SECONDS)
        with self._lock:
            if not self._closed:
                self._closed = True
                self._flush_locked()
                self._f.close()
