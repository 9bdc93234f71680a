"""Replica pool autoscaling: heartbeat liveness + SLO gauges.

Port of ``horovod_tpu/serve/autoscale.py``: the reference's jax-free module,
copied with the port's imports; its behaviour is the reference's.


The elastic driver's liveness discipline, re-aimed at serving:
replicas PUT ``heartbeat/<replica_id>`` every ``HVD_HEARTBEAT_SEC``;
the monitor culls any replica silent past
``HOROVOD_WORKER_LIVENESS_SEC`` (journaled, so the cull survives a
router restart) and the router re-admits it the moment beats reappear
— scale-down on failure, scale-back-up on rediscovery, no operator in
the loop.

The monitor also owns the windowed SLO gauges: ``hvd_serve_qps``
(completed predicts per second over the last window) and
``hvd_serve_replicas_live``. Latency p50/p99 derive from the
``hvd_serve_latency_seconds`` histogram in every export
(docs/metrics.md#histogram-quantiles).
"""

from __future__ import annotations

import logging
import threading
import time

from horovod_tpu_torch.utils import metrics as _metrics

logger = logging.getLogger("horovod_tpu_torch")

_G_REPLICAS = _metrics.gauge(
    "hvd_serve_replicas_live",
    "Replicas currently in the serving router's rotation.")
_C_CULLED = _metrics.counter(
    "hvd_serve_culled_total",
    "Replicas removed from rotation after heartbeat silence exceeded "
    "HOROVOD_WORKER_LIVENESS_SEC.")


class ReplicaMonitor:
    """Background liveness + SLO-gauge thread for one ``Router``.

    The tick interval tracks the liveness deadline (a quarter of it,
    bounded to [0.2s, 5s]) so a wedged replica is culled within one
    deadline plus one tick — comfortably inside the 2x-liveness
    detection bound the chaos test asserts.
    """

    def __init__(self, router, interval: float = None):
        self.router = router
        if interval is None:
            live = router.liveness_sec
            interval = min(5.0, max(0.2, live / 4.0)) if live > 0 else 1.0
        self.interval = float(interval)
        self._stop = threading.Event()
        self._thread = None
        self._last_requests = 0
        self._last_ts = None

    def start(self):
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="hvd-serve-monitor")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def tick(self):
        """One monitoring pass (exposed for tests): cull the silent,
        refresh the gauges."""
        router = self.router
        if router.liveness_sec > 0:
            # Heap-driven sweep (the fleet-cardinality fix): only
            # replicas whose deadline actually passed are surfaced —
            # O(expired · log N) per tick, not a full-table scan with
            # a lock hop per replica.
            for rid, age in router.liveness_sweep():
                logger.warning(
                    "serve: replica %s wedged — no heartbeat for "
                    "%.1fs (> HOROVOD_WORKER_LIVENESS_SEC=%.1fs); "
                    "culling from rotation", rid, age,
                    router.liveness_sec)
                router.cull(rid, reason="no heartbeat %.1fs" % age,
                            silence_sec=age,
                            dump=self._dump_path(rid))
                _C_CULLED.inc()
        stats = router.stats()
        _G_REPLICAS.set(stats["replicas"])
        # Refresh the lifecycle gauge from stats too (one lock hop for
        # the whole tick): the mutation sites keep it live, but a
        # restarted router's journal-REPLAYED drains never passed
        # through drain() in this process.
        from horovod_tpu_torch.serve.router import _G_DRAINING

        _G_DRAINING.set(stats["draining"])
        now = time.monotonic()
        done = router.requests_done()
        if self._last_ts is not None and now > self._last_ts:
            from horovod_tpu_torch.serve.router import _G_QPS

            _G_QPS.set((done - self._last_requests)
                       / (now - self._last_ts))
        self._last_requests = done
        self._last_ts = now

    def _dump_path(self, replica_id: str):
        """The culled replica's flight-record dump, if it left one
        behind under the journal dir's flightrec root (the server
        spawns replicas with HVD_FLIGHTREC_DIR there; a replica that
        died on an abort auto-dumped, one that merely wedged may not
        have — the cull record then simply carries no dump path)."""
        import os

        root = getattr(self.router, "flightrec_root", None)
        if not root:
            return None
        for source in ("python", "native"):
            path = os.path.join(root, replica_id,
                                "flightrec.rank0.%s.jsonl" % source)
            if os.path.exists(path):
                return path
        return None

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception as e:  # analysis: allow-broad-except — a
                # transient bookkeeping error must not kill liveness
                # monitoring for the rest of the serving job.
                logger.warning("serve: monitor tick failed: %s", e)
