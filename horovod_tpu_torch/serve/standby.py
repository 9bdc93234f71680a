"""Hot-standby router failover: automatic, journaled takeover.

Port of ``horovod_tpu/serve/standby.py``: the reference's jax-free module,
copied with the port's imports; its behaviour is the reference's.


The active router refreshes a **lease file** next to the serve journal
(``write_lease``, atomic tmp + ``os.replace``) every
``HVD_SERVE_LEASE_SEC``. A ``Standby`` polls the lease and keeps a
warm fold of the membership journal (snapshot + tail via
``replay_routing`` — bounded by the journal's compaction); when the lease
goes silent for ``HVD_SERVE_TAKEOVER_SEC`` (leader dead) or vanishes
(leader retired gracefully), the standby constructs a ``Router`` on
the SAME service port — replaying the journal the leader was writing
— journals a ``takeover`` record, and resumes any rolling upgrade the
leader left unfinished (``Router.resume_roll_if_pending``). Clients
never change address: the port is the contract, the journal is the
state, the lease is the liveness signal.

The port bind doubles as the split-brain fence: a leader that is
silent-but-alive still holds the listen socket, so the standby's bind
fails (EADDRINUSE) and it keeps waiting instead of double-serving.

Replaces the manual ``--role router`` restart runbook step; see
docs/serving.md#fleet-operations-runbook.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Optional

from horovod_tpu_torch.common.util import float_env
from horovod_tpu_torch.utils import metrics as _metrics

LEASE_FILENAME = "router_lease.json"

_C_FAILOVERS = _metrics.counter(
    "hvd_serve_router_failovers_total",
    "Standby routers that took over the service port after leader "
    "lease silence (a takeover record marks it in the serve journal).")


def lease_path(journal_dir: str) -> str:
    return os.path.join(journal_dir, LEASE_FILENAME)


def write_lease(journal_dir: str, port: int) -> None:
    """Refresh the leader lease atomically (tmp + replace): a reader
    sees the previous complete lease or this one, never a torn mix.
    Not fsync'd on purpose — the lease is a liveness signal with a
    sub-second refresh, not a WAL; losing the newest refresh in a host
    crash only makes the takeover marginally earlier."""
    path = lease_path(journal_dir)
    tmp = "%s.%d.tmp" % (path, os.getpid())
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(json.dumps({"pid": os.getpid(), "port": int(port),
                             "ts": time.time()}))
    os.replace(tmp, path)


def read_lease(journal_dir: str) -> Optional[dict]:
    try:
        with open(lease_path(journal_dir), "r", encoding="utf-8") as fh:
            doc = json.loads(fh.read())
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


def clear_lease(journal_dir: str) -> None:
    """Graceful leader retirement: no lease means no leader, so the
    standby takes over immediately instead of waiting out the silence
    window."""
    try:
        os.remove(lease_path(journal_dir))
    except OSError:
        pass


class Standby:
    """Tail the lease + journal; become the router on leader silence.

    ``liveness_sec``/``monitor`` are forwarded to the Router the
    takeover constructs, so a test standby can run with the same knobs
    as its leader.
    """

    def __init__(self, journal_dir: str, port: int,
                 takeover_sec: Optional[float] = None,
                 poll_sec: Optional[float] = None,
                 liveness_sec: Optional[float] = None,
                 monitor: bool = True):
        self.journal_dir = journal_dir
        self.service_port = int(port)
        if takeover_sec is None:
            takeover_sec = float_env("HVD_SERVE_TAKEOVER_SEC", 3.0)
        self.takeover_sec = max(0.1, float(takeover_sec))
        if poll_sec is None:
            poll_sec = max(0.05, self.takeover_sec / 4.0)
        self.poll_sec = float(poll_sec)
        self.liveness_sec = liveness_sec
        self.monitor = monitor
        # The Router this standby became, once it took over.
        self.router = None
        self.took_over = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Warm-fold observability (bench/tests): how many journal
        # folds the standby ran while waiting.
        self.folds = 0
        self.table = {}

    # --- lifecycle ----------------------------------------------------------

    def start(self):
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="hvd-serve-standby")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        router, self.router = self.router, None
        if router is not None:
            router.stop()

    def wait_takeover(self, timeout: float) -> bool:
        return self.took_over.wait(timeout)

    # --- the watch loop -----------------------------------------------------

    def _leader_alive(self) -> bool:
        lease = read_lease(self.journal_dir)
        if lease is None:
            return False
        try:
            age = time.time() - float(lease.get("ts", 0.0))
        except (TypeError, ValueError):
            return False
        return age <= self.takeover_sec

    def _refold(self):
        """Keep the routing fold warm while waiting: snapshot + tail,
        bounded by the leader's compaction cadence — takeover replays
        a file this process has mostly already paged in."""
        from horovod_tpu_torch.serve.router import (
            replay_routing,
            serve_journal_path,
        )

        try:
            self.table = replay_routing(
                serve_journal_path(self.journal_dir))
            self.folds += 1
        except OSError:
            pass

    def _run(self):
        while not self._stop.wait(self.poll_sec):
            if self._leader_alive():
                self._refold()
                continue
            if self._try_takeover():
                return

    def _try_takeover(self) -> bool:
        from horovod_tpu_torch.serve.router import Router
        from horovod_tpu_torch.utils import flightrec

        # Re-check right before binding: the leader may have refreshed
        # between the poll and now.
        if self._leader_alive():
            return False
        # Probe-bind BEFORE constructing the Router: Router.__init__
        # attaches the journal (torn-tail truncation included) before
        # it binds, and that attach must never touch a file a silent-
        # but-alive leader is still appending to. SO_REUSEADDR matches
        # the HTTP server's own bind semantics (TIME_WAIT remnants of
        # the dead leader don't block takeover; a live listener does).
        probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            probe.bind(("0.0.0.0", self.service_port))
        except OSError:
            return False
        finally:
            probe.close()
        try:
            router = Router(port=self.service_port,
                            journal_dir=self.journal_dir,
                            liveness_sec=self.liveness_sec,
                            monitor=self.monitor)
        except OSError:
            # Port still bound: the leader is silent but alive (wedged
            # or just not leasing) — binding is the split-brain fence,
            # so keep waiting rather than double-serve.
            return False
        router.start()
        router._journal_append({"type": "takeover", "pid": os.getpid(),
                                "port": self.service_port,
                                "ts": time.time()})
        _C_FAILOVERS.inc()
        flightrec.record_failure(
            "router_failover", "standby pid %d took over port %d "
            "(%d replicas replayed)"
            % (os.getpid(), self.service_port, len(router.replicas())))
        self.router = router
        self.took_over.set()
        # An upgrade interrupted by the leader's death resumes from
        # its journal records — completed waves skipped.
        router.resume_roll_if_pending()
        return True
