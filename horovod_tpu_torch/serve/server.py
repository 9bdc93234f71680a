"""``hvd.serve.Server``: one object from checkpoint to serving fleet.

Port of ``horovod_tpu/serve/server.py``: the reference's jax-free module,
copied with the port's imports; its behaviour is the reference's.


Composes the subsystem: a ``Router`` in this process (front door,
journal, liveness monitor) plus ``num_replicas`` replica worker
subprocesses (each ``python -m horovod_tpu_torch.serve --role replica``),
every replica loading the newest committed checkpoint and registering
back through the router's KV.

Replicas are deliberately independent OS processes, not threads: a
SIGKILLed router leaves them serving and heartbeating, which is what
makes the router restart (``--role router`` over the same
``--journal-dir`` and port) a non-event for in-flight capacity — the
chaos test (tests/test_chaos_serve.py) kills both sides to prove it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

from horovod_tpu_torch.common.util import float_env
from horovod_tpu_torch.serve.router import Router


def http_get_json(addr: str, port: int, path: str,
                  timeout: float = 5.0) -> Optional[dict]:
    """GET a JSON document, None on any transport/parse failure (the
    polling-friendly client bench_serve.py and wait_ready share)."""
    import http.client

    conn = http.client.HTTPConnection(addr, port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        if resp.status != 200:
            return None
        return json.loads(body.decode())
    except (OSError, ValueError):
        return None
    finally:
        conn.close()


class Server:
    """Library API over the CLI's default topology.

    ::

        server = hvd.serve.Server(ckpt_dir=d, model="mnist_mlp",
                                  num_replicas=2, journal_dir=j)
        port = server.start()          # router bound, replicas spawning
        server.wait_ready(timeout=60)  # all replicas admitted
        ...                            # POST /v1/predict on `port`
        server.stop()
    """

    def __init__(self, ckpt_dir: Optional[str] = None,
                 model: str = "mnist_mlp",
                 num_replicas: int = 1,
                 port: int = 0,
                 journal_dir: Optional[str] = None,
                 liveness_sec: Optional[float] = None,
                 replica_env: Optional[dict] = None,
                 device: Optional[str] = None):
        self.ckpt_dir = ckpt_dir
        # Where the replicas run ("cuda" by default, "cpu" on request).
        self.device = device
        self.model = model
        self.num_replicas = int(num_replicas)
        self.journal_dir = journal_dir
        self.replica_env = dict(replica_env or {})
        self.router = Router(port=port, journal_dir=journal_dir,
                             liveness_sec=liveness_sec)
        self._procs: List[subprocess.Popen] = []
        self._flightrec_tmp: Optional[str] = None

    @property
    def port(self) -> int:
        return self.router.port

    def _spawn_replica(self, index: int) -> subprocess.Popen:
        cmd = [sys.executable, "-m", "horovod_tpu_torch.serve",
               "--role", "replica",
               "--model", self.model,
               "--replica-id", "r%d" % index,
               "--router", "127.0.0.1:%d" % self.port,
               "--port", "0"]
        if self.ckpt_dir:
            cmd += ["--ckpt-dir", self.ckpt_dir]
        if self.device:
            cmd += ["--device", self.device]
        env = dict(os.environ)
        env.update(self.replica_env)
        # Flight-record dumps outlive the replica: with a journal dir
        # (and no operator-chosen dump dir) each replica dumps into its
        # own <journal_dir>/flightrec/<replica-id>/ so evidence
        # survives the process and the monitor's cull record can name
        # it (serve/autoscale.py, docs/flightrec.md).
        if self.journal_dir:
            fr_dir = os.path.join(self.journal_dir, "flightrec",
                                  "r%d" % index)
        else:
            # Journal-less fleet (tests, benches): dumps land in a
            # shared temp dir instead of littering the launching
            # process's cwd with flightrec.rank*.jsonl files.
            fr_dir = os.path.join(self._flightrec_fallback(),
                                  "r%d" % index)
        try:
            # The replica's native abort auto-dump may be the
            # first writer; fopen does not mkdir.
            os.makedirs(fr_dir, exist_ok=True)
        except OSError:
            fr_dir = None
        if fr_dir:
            env.setdefault("HVD_FLIGHTREC_DIR", fr_dir)
        return subprocess.Popen(cmd, env=env)

    def _flightrec_fallback(self) -> str:
        if self._flightrec_tmp is None:
            self._flightrec_tmp = tempfile.mkdtemp(
                prefix="hvd_serve_flightrec_")
        return self._flightrec_tmp

    def start(self) -> int:
        port = self.router.start()
        for i in range(self.num_replicas):
            self._procs.append(self._spawn_replica(i))
        return port

    def wait_ready(self, timeout: float = 120.0,
                   min_replicas: Optional[int] = None) -> dict:
        """Block until the router reports at least ``min_replicas``
        (default: every spawned replica) CONFIRMED — i.e. heard from
        in this router incarnation, not merely journal-replayed
        (replayed entries may be dead; counting them would declare a
        restarted fleet ready before any new replica loaded). Returns
        the healthz document; raises ``TimeoutError`` with the last
        view otherwise."""
        want = self.num_replicas if min_replicas is None else min_replicas
        deadline = time.monotonic() + timeout
        doc = None
        while time.monotonic() < deadline:
            doc = http_get_json("127.0.0.1", self.port, "/healthz")
            if doc and sum(
                    1 for info in doc.get("replicas", {}).values()
                    if info.get("confirmed")) >= want:
                return doc
            for p in self._procs:
                if p.poll() not in (None, 0):
                    raise RuntimeError(
                        "serve replica exited rc=%s before becoming "
                        "ready" % p.returncode)
            time.sleep(0.2)
        raise TimeoutError(
            "serve fleet not ready after %.0fs (last healthz: %s)"
            % (timeout, doc))

    def stop(self, replica_grace: Optional[float] = None):
        """Graceful fleet stop: SIGTERM asks each replica to DRAIN —
        finish queued micro-batches, goodbye-beat the router (an
        immediate journaled cull), exit 0 (serve/replica.py). The
        grace window caps a wedged drain (HVD_SERVE_DRAIN_GRACE_SEC
        plus slack, not a sleep — an idle fleet exits in well under a
        second); stragglers are killed. The router stops LAST so the
        goodbye beats land in its journal."""
        if replica_grace is None:
            replica_grace = max(
                5.0, float_env("HVD_SERVE_DRAIN_GRACE_SEC", 30.0) + 5.0)
        for p in self._procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + replica_grace
        for p in self._procs:
            remaining = max(0.1, deadline - time.monotonic())
            try:
                p.wait(timeout=remaining)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=5)
        self._procs = []
        self.router.stop()
