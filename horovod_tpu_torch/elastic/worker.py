"""Worker-side elastic machinery: re-rendezvous and the run wrapper.

Port of ``horovod_tpu/elastic/worker.py`` (reference: horovod/common/
elastic.py:151-175, horovod/runner/elastic/rendezvous.py:37-42). A port
worker speaks the JAX package's elastic driver contract
(``python -m horovod_tpu.runner --min-np ... --host-discovery-script``):

- **Version fencing.** Rendezvous versions only move forward: a worker
  that has adopted version N ignores any published meta below N.
- **A negotiated port.** The driver publishes ``controller_port: 0``;
  rank 0 binds a port on its own host and reports it through the KV
  under ``control/controller_port.<version>``.
- **Heartbeats.** A daemon thread PUTs ``heartbeat/<slot_key>`` every
  ``HVD_HEARTBEAT_SEC``, so the driver can tell a wedged worker from a
  healthy one.
- **Recovery.** ``run`` catches ``HorovodInternalError`` (restore the last
  commit, shut down, adopt the next version, re-init) and
  ``HostsUpdatedInterrupt`` (a graceful reset at a commit), within a
  failure budget with backoff; on its first entry a state with a
  checkpointer auto-resumes from the newest committed step.

The reference's ``hvd_elastic_*`` counters of this module (resets,
failures, heartbeats and deferred heartbeats, ``horovod_tpu/elastic/
worker.py:51-66``) and its ``elastic_reset``, ``heartbeat_deferred`` and
``elastic_recovery`` flight records are kept, and so are the online
tuner's two hooks (JAX :375-414): ``run`` starts the tuner on entry, and
after each reinit it restores the tuner's live-unsafe knobs before
``state.on_reset()``. The TF pre-flight of the reinit is dropped, since
the port has no TF binding.
"""

from __future__ import annotations

import functools
import json
import os
import random
import sys
import threading
import time
from typing import Optional, Tuple

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.exceptions import (
    HorovodInternalError,
    HostsUpdatedInterrupt,
)
from horovod_tpu_torch.common.util import (
    failure_backoff_seconds,
    float_env,
)
from horovod_tpu_torch.runner.http_server import put_kv, read_kv, write_kv
from horovod_tpu_torch.utils import flightrec
from horovod_tpu_torch.utils import metrics as _metrics

_M_RESETS = _metrics.counter(
    "hvd_elastic_resets_total",
    "Completed elastic re-initializations (new world adopted).")
_M_FAILURES = _metrics.counter(
    "hvd_elastic_failures_total",
    "HorovodInternalError recoveries in the elastic run wrapper "
    "(rank death / coordination failure rolled back to last commit).")
_M_HEARTBEATS = _metrics.counter(
    "hvd_elastic_heartbeats_total",
    "Liveness heartbeats this worker PUT to the rendezvous KV "
    "(heartbeat/<slot_key>, every HVD_HEARTBEAT_SEC).")
_M_HEARTBEATS_DEFERRED = _metrics.counter(
    "hvd_elastic_heartbeats_deferred_total",
    "Heartbeats the rendezvous KV shed with a typed 503 + Retry-After "
    "(HVD_KV_MAX_INFLIGHT admission control): the worker deferred the "
    "beat instead of treating the shed as a driver failure.")


def _rendezvous() -> Tuple[str, int]:
    return (os.environ["HOROVOD_RENDEZVOUS_ADDR"],
            int(os.environ["HOROVOD_RENDEZVOUS_PORT"]))


def _rendezvous_or_none() -> Optional[Tuple[str, int]]:
    addr = os.environ.get("HOROVOD_RENDEZVOUS_ADDR")
    port = os.environ.get("HOROVOD_RENDEZVOUS_PORT")
    if not addr or not port:
        return None
    return addr, int(port)


def _poll_meta(min_version: int, timeout: Optional[float] = None) -> dict:
    """Wait for the driver to publish rendezvous meta at version >=
    ``min_version``; anything older is a stale driver's and is never
    adopted. The wait is ``HOROVOD_ELASTIC_TIMEOUT`` (default 600 s)."""
    if timeout is None:
        timeout = float_env("HOROVOD_ELASTIC_TIMEOUT", 600.0)
    addr, port = _rendezvous()
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            raw = read_kv(addr, port, "control", "meta", timeout=5)
        except OSError:
            raw = None
        if raw:
            meta = json.loads(raw.decode())
            if meta.get("version", 0) >= min_version:
                return meta
        time.sleep(0.5)
    raise HorovodInternalError(
        "Timed out waiting for rendezvous version >= %d" % min_version)


def negotiate_controller_port(rank: int,
                              timeout: Optional[float] = None) -> int:
    """Resolve the rendezvous port of this world when the driver
    published 0 (negotiated): rank 0 binds a free port on its own host
    and reports it through the KV under a version-scoped key; every other
    rank polls that key, and gives up early when the version it waits for
    is superseded (rank 0 died before reporting). Sets
    ``HOROVOD_CONTROLLER_PORT`` and returns the port."""
    addr, port = _rendezvous()
    version = os.environ.get("HOROVOD_RENDEZVOUS_VERSION", "0")
    key = "controller_port.%s" % version
    if timeout is None:
        timeout = float_env("HOROVOD_ELASTIC_TIMEOUT", 600.0)
    if rank == 0:
        try:
            with basics._reserve_port() as probe:
                chosen = probe.getsockname()[1]
        except OSError as e:
            raise HorovodInternalError(
                "rank 0 could not bind a controller port on this host: %s"
                % e)
        write_kv(addr, port, "control", key, str(chosen).encode())
        os.environ["HOROVOD_CONTROLLER_PORT"] = str(chosen)
        return chosen
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            raw = read_kv(addr, port, "control", key, timeout=5)
        except OSError:
            raw = None
        if raw:
            os.environ["HOROVOD_CONTROLLER_PORT"] = raw.decode()
            return int(raw)
        # Dying here lets the driver respawn this slot into the new
        # version, instead of burning the whole timeout on a key that
        # will never arrive.
        try:
            meta_raw = read_kv(addr, port, "control", "meta", timeout=5)
        except OSError:
            meta_raw = None
        if meta_raw:
            meta = json.loads(meta_raw.decode())
            if meta.get("version", 0) > int(version):
                raise HorovodInternalError(
                    "rendezvous version %s superseded while waiting for "
                    "its controller port" % version)
        time.sleep(0.2)
    raise HorovodInternalError(
        "Timed out waiting for the rank-0 controller port (rendezvous "
        "version %s)" % version)


# --- heartbeats --------------------------------------------------------------

_heartbeat_lock = threading.Lock()
_heartbeat_thread: Optional[threading.Thread] = None


def heartbeat_payload() -> dict:
    """What a heartbeat carries. The driver keys liveness off its own
    arrival clock; the payload says which process, at which rendezvous
    version, how far it has committed."""
    from horovod_tpu_torch.elastic import state as _state

    return {
        "ts": time.time(),
        "pid": os.getpid(),
        "version": int(os.environ.get("HOROVOD_RENDEZVOUS_VERSION", "0")),
        "commits": _state.commit_count(),
    }


def send_heartbeat() -> bool:
    """One best-effort heartbeat PUT; False when it could not be sent."""
    return send_heartbeat_ex()[0]


def send_heartbeat_ex() -> Tuple[bool, float]:
    """Like ``send_heartbeat`` but returns ``(sent, retry_after_sec)``;
    ``retry_after_sec`` > 0 means the bounded KV shed the beat with a
    typed 503: the driver is alive, and the loop should retry after the
    server's deferral, not a whole interval later."""
    ep = _rendezvous_or_none()
    slot_key = os.environ.get("HOROVOD_SLOT_KEY")
    if ep is None or not slot_key:
        return False, 0.0
    try:
        status, retry_after = put_kv(
            ep[0], ep[1], "heartbeat", slot_key,
            json.dumps(heartbeat_payload()).encode(), timeout=5)
    except OSError:
        return False, 0.0
    if status == 503:
        _M_HEARTBEATS_DEFERRED.inc()
        flightrec.record("heartbeat_deferred", name=slot_key,
                         retry_after=retry_after)
        return False, max(retry_after, 0.05)
    _M_HEARTBEATS.inc()
    return True, 0.0


def start_heartbeats() -> Optional[threading.Thread]:
    """Start the daemon heartbeat thread (idempotent). The interval is
    ``HVD_HEARTBEAT_SEC`` (default 10 s; <= 0 disables). Returns the
    thread, or None when heartbeats are off or there is no elastic
    driver. The thread reads the interval and the env at every beat, so
    it survives elastic resets."""
    global _heartbeat_thread
    if float_env("HVD_HEARTBEAT_SEC", 10.0) <= 0:
        return None
    if (_rendezvous_or_none() is None
            or not os.environ.get("HOROVOD_SLOT_KEY")):
        return None
    with _heartbeat_lock:
        if _heartbeat_thread is not None and _heartbeat_thread.is_alive():
            return _heartbeat_thread

        def _loop():
            # A random phase per worker: a wave of workers spawned by one
            # reset would otherwise beat in lockstep forever.
            time.sleep(random.uniform(
                0.0, max(0.05, float_env("HVD_HEARTBEAT_SEC", 10.0))))
            while True:
                retry_after = 0.0
                try:
                    _, retry_after = send_heartbeat_ex()
                except Exception as e:  # noqa: BLE001 — best effort: one
                    # garbled KV response must not kill this thread, or
                    # the driver would replace a healthy worker as wedged.
                    sys.stderr.write("elastic: heartbeat attempt failed: "
                                     "%s\n" % e)
                interval = max(0.05, float_env("HVD_HEARTBEAT_SEC", 10.0))
                if retry_after > 0:
                    # A shed beat comes back after the server's deferral,
                    # jittered so that the shed herd does not return as
                    # a herd.
                    interval = min(interval,
                                   retry_after * random.uniform(1.0, 2.0))
                time.sleep(interval)

        _heartbeat_thread = threading.Thread(
            target=_loop, daemon=True, name="hvd-heartbeat")
        _heartbeat_thread.start()
        return _heartbeat_thread


def reinit_for_version(min_version: int) -> int:
    """Shut down, take this slot's assignment in the next published
    world, re-init on the same device. Exits(0) when the slot is not part
    of the new world. Returns the adopted version."""
    device = basics.init_device()
    basics.shutdown()
    meta = _poll_meta(min_version)
    addr, port = _rendezvous()
    slot_key = os.environ["HOROVOD_SLOT_KEY"]
    # The driver publishes slot assignments (and deletes removed slots)
    # before it bumps the meta version, so one read after the version is
    # adopted is race-free.
    raw = read_kv(addr, port, "rendezvous", slot_key, timeout=5)
    if raw is None:
        sys.exit(0)
    rank, size, local_rank, local_size, cross_rank, cross_size = (
        int(x) for x in raw.decode().split(","))
    os.environ.update({
        "HOROVOD_RANK": str(rank),
        "HOROVOD_SIZE": str(size),
        "HOROVOD_LOCAL_RANK": str(local_rank),
        "HOROVOD_LOCAL_SIZE": str(local_size),
        "HOROVOD_CROSS_RANK": str(cross_rank),
        "HOROVOD_CROSS_SIZE": str(cross_size),
        "HOROVOD_CONTROLLER_ADDR": meta["controller_addr"],
        "HOROVOD_CONTROLLER_PORT": str(meta["controller_port"]),
        "HOROVOD_RENDEZVOUS_VERSION": str(meta["version"]),
    })
    basics.init(device=device)
    # Completed resets count, once the new world is adopted.
    _M_RESETS.inc()
    flightrec.record("elastic_reset", version=meta["version"], rank=rank,
                     size=size)
    return meta["version"]


def run(func):
    """Elastic run wrapper (reference: common/elastic.py:151-175)::

        @hvd.elastic.run
        def train(state, ...):
            ...
        train(state)

    Consecutive ``HorovodInternalError`` recoveries are counted; a world
    that survives ``HOROVOD_ELASTIC_STABLE_SEC`` (default 60) before
    failing resets the count. From the second consecutive failure on,
    recovery waits a jittered exponential backoff
    (``HOROVOD_ELASTIC_BACKOFF_BASE`` doubling up to
    ``HOROVOD_ELASTIC_BACKOFF_MAX``); past
    ``HOROVOD_ELASTIC_MAX_FAILURES`` (default 0 = unlimited) the error is
    re-raised. On entry the wrapper starts the heartbeat thread (under
    the elastic driver) and, under ``HVD_TUNE``, the online tuner
    (``utils/online_tuner.py``), and gives a state with a checkpointer one
    chance to auto-resume from its newest committed step.
    """

    @functools.wraps(func)
    def wrapper(state, *args, **kwargs):
        max_failures = int(float_env("HOROVOD_ELASTIC_MAX_FAILURES", 0))
        backoff_base = float_env("HOROVOD_ELASTIC_BACKOFF_BASE", 1.0)
        backoff_max = float_env("HOROVOD_ELASTIC_BACKOFF_MAX", 30.0)
        stable_sec = float_env("HOROVOD_ELASTIC_STABLE_SEC", 60.0)
        start_heartbeats()
        # HVD_TUNE: the online knob search, journaled per rank, so that a
        # respawned worker replays to its tuned state. Native applies go
        # through the live CoreSession; the env mirror makes every reinit
        # start with the tuned values too.
        from horovod_tpu_torch.utils.online_tuner import start_online_tuner

        start_online_tuner(role="training")
        # Duck-typed, so that user State subclasses without the
        # checkpointer integration keep working.
        maybe_resume = getattr(state, "_maybe_auto_resume", None)
        if maybe_resume is not None:
            maybe_resume()
        reset_version = None
        skip_sync = False
        consecutive_failures = 0
        while True:
            if reset_version is not None:
                state._known_version = reinit_for_version(reset_version)
                # The world just formed again, and may have grown: a tuner
                # that searched or froze a live-unsafe knob while alone
                # restores it before state.on_reset(), whose callbacks
                # rebuild optimizers and must see uniform values.
                from horovod_tpu_torch.utils.online_tuner import (
                    on_world_change,
                )

                try:
                    on_world_change()
                except Exception as e:  # noqa: BLE001 — the tuner is an
                    # optimizer, not a dependency: a journal fsync or an
                    # apply failure must not kill a survivor.
                    sys.stderr.write("elastic: tuner world-change hook "
                                     "failed (%s); continuing reset\n" % e)
                state.on_reset()
                reset_version = None
            entered = time.monotonic()
            try:
                if not skip_sync:
                    state.sync()
                skip_sync = False
                return func(state, *args, **kwargs)
            except HorovodInternalError as e:
                # A rank died mid-collective: roll back to the last
                # commit, rejoin at the next published rendezvous.
                _M_FAILURES.inc()
                flightrec.record_failure("elastic_recovery", str(e)[:200])
                if time.monotonic() - entered > stable_sec:
                    consecutive_failures = 0
                consecutive_failures += 1
                if max_failures and consecutive_failures > max_failures:
                    sys.stderr.write(
                        "elastic: failure budget exhausted (%d consecutive "
                        "recoveries, HOROVOD_ELASTIC_MAX_FAILURES=%d); "
                        "giving up\n" % (consecutive_failures, max_failures))
                    raise
                delay = failure_backoff_seconds(
                    consecutive_failures, backoff_base, backoff_max)
                if delay > 0:
                    time.sleep(delay)
                state.restore()
                reset_version = state._known_version + 1
            except HostsUpdatedInterrupt as e:
                # A graceful reset at a commit boundary.
                skip_sync = e.skip_sync
                reset_version = state._known_version

    return wrapper
