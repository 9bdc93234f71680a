"""Serving front door: journaled round-robin routing over replicas.

Port of ``horovod_tpu/serve/router.py``: the reference's jax-free module,
copied with the port's imports; its behaviour is the reference's.


The router is the one address clients know. It owns:

- ``POST /v1/predict``: forwarded to a live replica, round-robin; a
  failed forward (connect refused, timeout, 5xx) is retried against
  the other replicas, and each failure charges the replica's
  per-replica failure budget — ``HVD_SERVE_BREAKER_THRESHOLD``
  consecutive failures trip its breaker and park it in a jittered
  cooling window (exponential per consecutive trip) instead of
  leaving it in round-robin rotation to eat live traffic. A
  successful forward resets the budget; heartbeat re-admission of a
  culled/unknown replica closes the breaker outright;
- ``GET /healthz``: routing-table view (live replicas, heartbeat ages);
- ``GET /metrics`` / ``/metrics.json``: the process-wide registry
  (free — the router rides ``runner/http_server.KVStoreServer``);
- the replica KV: replicas PUT ``replica/<id>`` (registration) and
  ``heartbeat/<id>`` (liveness) exactly like elastic workers do.

Crash-safety (the elastic driver's journal pattern, reused verbatim): every
membership transition (admit, cull) is appended to an fsync'd JSONL
journal (``runner/journal.DriverJournal`` — same torn-tail-tolerant
attach/replay) BEFORE it takes effect, so a SIGKILLed router restarts
into the same routing table. Replayed replicas get a fresh liveness
clock; the ones that died with the old router are culled after
``HOROVOD_WORKER_LIVENESS_SEC`` of silence, while live ones keep
heartbeating and never notice the restart.

Re-admission: heartbeat payloads carry the replica's endpoint, so a
culled (or never-journaled) replica is re-admitted from its next beat
alone — no re-registration round-trip needed.

Zero-downtime operations (docs/serving.md#fleet-operations-runbook):

- **drain**: a replica leaving on purpose (SIGTERM, ``POST
  /v1/drain``, a rolling upgrade) is journaled out of the pick
  rotation immediately — in-flight forwards complete, new picks skip
  it — and its final *goodbye* beat culls it without waiting out the
  liveness window;
- **rolling upgrade**: ``start_roll`` drives the fleet to a target
  checkpoint step in drained waves (serve/rollout.py), every wave
  transition journaled so a router crash mid-roll resumes instead of
  stranding a mixed-step fleet;
- **failover**: the active router renews a lease file next to the
  journal; a hot standby (serve/standby.py) tails both and takes over
  the service port on leader silence.
"""

from __future__ import annotations

import heapq
import http.client
import json
import os
import random
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from horovod_tpu_torch.common.util import float_env, int_env
from horovod_tpu_torch.runner.http_server import (
    KVStoreServer,
    json_route_result,
)
from horovod_tpu_torch.runner.journal import DriverJournal
from horovod_tpu_torch.utils import metrics as _metrics

SERVE_JOURNAL_FILENAME = "serve_journal.jsonl"

_C_REQUESTS = _metrics.counter(
    "hvd_serve_requests_total",
    "Predict requests the serving router answered, by outcome "
    "(ok / error).", labelnames=("outcome",))
_C_RETRIES = _metrics.counter(
    "hvd_serve_retries_total",
    "Predict forwards retried against another replica after the first "
    "choice failed.")
_H_LATENCY = _metrics.histogram(
    "hvd_serve_latency_seconds",
    "End-to-end predict latency through the router (queueing, "
    "micro-batching and inference included).")
_G_QPS = _metrics.gauge(
    "hvd_serve_qps",
    "Predict requests per second over the autoscaler's last "
    "monitoring window.")
_C_BREAKER_TRIPS = _metrics.counter(
    "hvd_serve_breaker_trips_total",
    "Replica breakers tripped: consecutive forward failures exceeded "
    "HVD_SERVE_BREAKER_THRESHOLD and the replica was parked in a "
    "jittered cooling window.")
_G_COOLING = _metrics.gauge(
    "hvd_serve_replicas_cooling",
    "Replicas currently parked by a tripped breaker (out of the "
    "round-robin rotation until their cooldown expires).")
_G_DRAINING = _metrics.gauge(
    "hvd_serve_draining_replicas",
    "Replicas currently draining (journaled out of the pick rotation "
    "by a SIGTERM/operator/rolling-upgrade drain while their queued "
    "work finishes).")
_C_UPGRADES = _metrics.counter(
    "hvd_serve_upgrades_total",
    "Rolling checkpoint upgrades driven by the roll controller, by "
    "outcome (ok / abort — an abort rolled every touched wave back "
    "to its prior step).", labelnames=("outcome",))


def serve_journal_path(journal_dir: str) -> str:
    return os.path.join(journal_dir, SERVE_JOURNAL_FILENAME)


def replay_routing(path: str) -> Dict[str, dict]:
    """Fold a serve journal into the routing table it described:
    ``replica`` records admit (last endpoint wins), ``cull`` records
    remove, ``drain``/``undrain`` toggle the entry's ``draining``
    marker (the drain source string) — a fresh ``replica`` record
    clears it, matching live re-admission. Roll/takeover records (and
    any future kind) are skipped (forward compatibility); a torn
    trailing line ends the replay (the DriverJournal attach truncates
    it before this incarnation appends)."""
    table: Dict[str, dict] = {}
    if not os.path.exists(path):
        return table
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                break  # torn tail
            rtype = rec.get("type")
            if rtype == "snapshot":
                # Compaction point (DriverJournal.compact): the full
                # table at that moment replaces everything folded so
                # far; later records are the tail.
                table = {}
                for rid, info in (rec.get("table") or {}).items():
                    if not isinstance(info, dict):
                        continue
                    entry = {k: info.get(k)
                             for k in ("addr", "port", "pid", "model")}
                    if info.get("draining"):
                        entry["draining"] = info.get("draining")
                    table[str(rid)] = entry
                continue
            rid = rec.get("id")
            if rid is None:
                continue
            if rtype == "replica":
                table[rid] = {k: rec.get(k)
                              for k in ("addr", "port", "pid", "model")}
            elif rtype == "cull":
                table.pop(rid, None)
            elif rtype == "drain":
                if rid in table:
                    table[rid]["draining"] = \
                        rec.get("source") or "operator"
            elif rtype == "undrain":
                if rid in table:
                    table[rid].pop("draining", None)
    return table


class Router:
    """Journaled, heartbeat-monitored round-robin router."""

    def __init__(self, port: int = 0,
                 journal_dir: Optional[str] = None,
                 liveness_sec: Optional[float] = None,
                 monitor: bool = True):
        from horovod_tpu_torch.serve.autoscale import ReplicaMonitor

        if liveness_sec is None:
            liveness_sec = float_env("HOROVOD_WORKER_LIVENESS_SEC", 30.0)
        self.liveness_sec = float(liveness_sec)
        self._lock = threading.RLock()
        # Membership-transition lock: admit()/cull()/stop() serialize
        # here for the journal append -> table effect -> compaction
        # sequence, so the fsync'd journal writes happen OUTSIDE _lock
        # and the request/heartbeat paths (which take only _lock) keep
        # flowing while a record hits disk. Always acquired BEFORE
        # _lock, never inside it:
        # analysis: lock-order(_journal_lock before _lock)
        self._journal_lock = threading.Lock()
        self._table: Dict[str, dict] = {}
        self._order: List[str] = []
        self._rr = 0
        self._hb_seen: Dict[str, float] = {}
        # O(1) pick bookkeeping (the fleet-cardinality fix): _rotation
        # is _order minus the cooling set, maintained incrementally on
        # admit/cull/trip/expiry so _pick indexes into it instead of
        # rebuilding an O(N) candidate list per request. _cool_heap and
        # _hb_heap are lazy-invalidation expiry heaps (deadline, rid):
        # stale entries are discarded when popped, so expiry checks are
        # amortized O(events) instead of O(N) scans per request/tick.
        self._rotation: List[str] = []
        self._rotation_set: Set[str] = set()
        self._cool_heap: List[Tuple[float, str]] = []
        self._hb_heap: List[Tuple[float, str]] = []
        # Draining replicas (rid -> drain source: "heartbeat" when the
        # replica asked, "operator"/"roll" when the router was told).
        # Out of the rotation but still admitted: in-flight forwards
        # complete, new picks skip them. The source gates auto-undrain
        # — a heartbeat without the flag lifts only a heartbeat-
        # sourced drain, so a roll-drained replica cannot beat itself
        # back into rotation mid-reload.
        self._draining: Dict[str, str] = {}
        # Last serving checkpoint step each replica reported in its
        # beats (observability + the roll controller's prior-step map;
        # deliberately NOT journaled — beats refresh it within one
        # heartbeat period of any restart).
        self._steps: Dict[str, object] = {}
        # Active rolling-upgrade controller (serve/rollout.py), if any.
        self._roll = None
        # Set by abrupt_stop(): the chaos rigs' in-process stand-in
        # for kill -9. Journal/lease writers check it so a "dead"
        # router can never append after a standby adopted the file.
        self._dead = False
        self._journal_dir = journal_dir
        self._lease_stop = threading.Event()
        self._lease_thread: Optional[threading.Thread] = None
        # Monotonic count of rotation slots examined by _pick — the
        # O(N)-guard tests (tests/test_fleet.py) assert this grows
        # ~O(1) per request as the table grows.
        self.pick_scan_steps = 0
        # Serve-journal compaction cadence (shared knob with the
        # elastic driver; docs/fleet.md): fold the journal down to one
        # snapshot record once the tail exceeds this. 0 disables.
        self.snapshot_every = int_env("HVD_JOURNAL_SNAPSHOT_EVERY", 512)
        # Replicas THIS incarnation has heard from (registration or
        # heartbeat). Journal-replayed entries stay unconfirmed until
        # their first live beat — readiness checks must not count a
        # possibly-dead replayed entry as serving capacity.
        self._confirmed: Set[str] = set()
        # Per-replica failure budget (the breaker): consecutive forward
        # failures, the monotonic deadline a tripped replica cools
        # until, and the consecutive-trip streak driving the
        # exponential cooldown. All guarded by _lock.
        self._fail_count: Dict[str, int] = {}
        self._cooling_until: Dict[str, float] = {}
        self._trip_streak: Dict[str, int] = {}
        self.breaker_threshold = int(float_env(
            "HVD_SERVE_BREAKER_THRESHOLD", 3))
        self.breaker_cooldown_sec = float_env(
            "HVD_SERVE_BREAKER_COOLDOWN_SEC", 5.0)
        self._requests_done = 0
        self._journal: Optional[DriverJournal] = None
        self._replayed = 0
        # Where culled replicas' flight-record dumps land (the server
        # spawns each replica with HVD_FLIGHTREC_DIR under this root);
        # the monitor's cull record names the evidence.
        self.flightrec_root = (os.path.join(journal_dir, "flightrec")
                               if journal_dir else None)
        if journal_dir:
            path = serve_journal_path(journal_dir)
            replayed = replay_routing(path)
            # Attach AFTER replay: attach truncates a torn tail, then
            # appends this incarnation's records to the same file.
            self._journal = DriverJournal(path)
            now = time.monotonic()
            for rid, info in replayed.items():
                drain_src = info.pop("draining", None)
                self._table[rid] = {k: info.get(k)
                                    for k in ("addr", "port", "pid",
                                              "model")}
                self._order.append(rid)
                if drain_src:
                    # Mid-drain at the old router's death: stay out of
                    # rotation — the goodbye beat (or liveness cull)
                    # finishes the job, an undrain re-admits.
                    self._draining[rid] = str(drain_src)
                else:
                    self._rotation.append(rid)
                    self._rotation_set.add(rid)
                # Fresh liveness clock: a replica that died with the
                # old router is culled liveness_sec from NOW; a live
                # one re-beats long before that.
                self._hb_seen[rid] = now
                if self.liveness_sec > 0:
                    heapq.heappush(self._hb_heap,
                                   (now + self.liveness_sec, rid))
            _G_DRAINING.set(len(self._draining))
            self._replayed = len(replayed)
            # Seed the compaction counter with the existing tail so a
            # restarted router inherits the cadence instead of letting
            # an uncompacted history grow for another full budget.
            self._journal.records_since_snapshot = \
                DriverJournal.count_records(path)
        self._kv = KVStoreServer(port=port, put_callback=self._on_put)
        self._kv.register_post_route("/v1/predict", self._handle_predict)
        self._kv.register_get_route("/healthz", self._handle_healthz)
        self._kv.register_post_route("/v1/drain", self._handle_drain)
        self._kv.register_post_route("/v1/roll", self._handle_roll)
        self._kv.register_get_route("/v1/roll", self._handle_roll_status)
        self._monitor = ReplicaMonitor(self) if monitor else None

    # --- membership ---------------------------------------------------------

    def _on_put(self, scope: str, key: str, value: bytes):
        """KV write callback (serialized by the server's callback
        lock): replica registrations and heartbeats feed the routing
        table and the liveness clock."""
        if scope == "heartbeat":
            try:
                info = json.loads(value.decode())
            except ValueError:
                info = None
            with self._lock:
                known = key in self._table
                if known:
                    self._hb_seen[key] = time.monotonic()
                    self._confirmed.add(key)
                    if info is not None and "step" in info:
                        self._steps[key] = info.get("step")
            if info is None or not (info.get("addr") and info.get("port")):
                # No usable endpoint: a known replica's beat already
                # stamped above; an unknown key is dropped without
                # bookkeeping — the KV is an open PUT endpoint (the
                # journal hazard), and stamping arbitrary keys into
                # _hb_seen would grow it unboundedly since cull only
                # ever pops admitted keys.
                return
            if info.get("goodbye"):
                # The drain farewell: the replica finished its queued
                # micro-batches and is about to exit — cull it NOW
                # (journaled) instead of letting it eat forwards until
                # the liveness window expires. An unknown goodbye has
                # nothing to cull (and must not admit-then-cull).
                if known:
                    self.cull(key, reason="drained (goodbye beat)")
                return
            # admit() is a no-op for an unchanged endpoint; for an
            # unknown key it is the re-admission path (rediscovery of
            # a culled replica), and for a KNOWN key whose beat
            # carries a NEW endpoint it journals the move — a replica
            # respawned on a fresh port while the router was down
            # would otherwise be routed to its dead old port forever,
            # kept "live" by the very beats that name the right one.
            self.admit(key, info)
            with self._lock:
                if key in self._table:
                    self._confirmed.add(key)
                    if "step" in info:
                        self._steps[key] = info.get("step")
            if info.get("draining"):
                self.drain(key, source="heartbeat")
            else:
                # A flag-less beat lifts only the replica's OWN drain:
                # operator/roll drains stay until explicitly undrained
                # (the replica doesn't know the router benched it).
                self.undrain(key, source="heartbeat",
                             expect_source="heartbeat")
        elif scope == "replica":
            try:
                info = json.loads(value.decode())
            except ValueError:
                return
            self.admit(key, info)
            with self._lock:
                self._confirmed.add(key)
                if key in self._table and "step" in info:
                    self._steps[key] = info.get("step")

    def _rotation_add(self, rid: str):
        """(lock held) Restore the rotation invariant for ``rid``: in
        rotation iff admitted, not cooling, and not draining."""
        # analysis: holds-lock(_lock) — every caller (admit, expire,
        # _note_success, undrain) already holds _lock.
        if (rid in self._table and rid not in self._cooling_until
                and rid not in self._draining
                and rid not in self._rotation_set):
            self._rotation.append(rid)
            self._rotation_set.add(rid)

    def _rotation_remove(self, rid: str):
        """(lock held) Drop ``rid`` from rotation (trip or cull). The
        list remove is O(N) but runs only on membership/breaker
        events, never per request."""
        # analysis: holds-lock(_lock) — every caller (cull, trip)
        # already holds _lock.
        if rid in self._rotation_set:
            self._rotation_set.discard(rid)
            self._rotation.remove(rid)

    def _hb_stamp_new(self, rid: str):
        """(lock held) First liveness stamp for ``rid``: set the clock
        and arm its expiry-heap entry."""
        # analysis: holds-lock(_lock) — only admit() calls this, under
        # its lock.
        if rid not in self._hb_seen:
            now = time.monotonic()
            self._hb_seen[rid] = now
            if self.liveness_sec > 0:
                heapq.heappush(self._hb_heap,
                               (now + self.liveness_sec, rid))

    def _maybe_compact(self):
        """(journal lock held, _lock NOT held) Fold the serve journal
        down to one snapshot of the current table once the tail
        exceeds the cadence. Called only AFTER an append's effect is
        applied, and membership cannot move while _journal_lock is
        held, so the _lock-scoped snapshot can never miss an event it
        just erased (append-before-effect is preserved: the snapshot
        IS the effect)."""
        # analysis: holds-lock(_journal_lock) — only admit()/cull()/
        # drain()/undrain()/_journal_append() call this, after their
        # effect commits.
        journal = self._journal
        if (journal is None or self.snapshot_every <= 0
                or journal.records_since_snapshot
                < self.snapshot_every):
            return
        with self._lock:
            table = {}
            for rid, e in self._table.items():
                row = dict(e)
                src = self._draining.get(rid)
                if src:
                    row["draining"] = src
                table[rid] = row
            roll = self._roll
        snapshot = {"table": table, "ts": time.time()}
        if roll is not None:
            # An active roll's progress must survive the fold: its
            # begin/wave records are about to be erased, and the
            # post-failover resume reads them (rollout.replay_roll
            # reads this field back out of snapshot records).
            view = roll.snapshot_view()
            if view is not None:
                snapshot["roll"] = view
        # analysis: blocking-ok(fsync'd fold under the dedicated
        # journal lock; the hot paths take only _lock and keep
        # flowing while the snapshot hits disk)
        journal.compact(snapshot)

    def admit(self, replica_id: str, info: dict):
        """Add (or update) a replica; journaled before it takes effect
        so a router restart cannot forget a member it already routed
        to. The fsync'd append runs under _journal_lock but OUTSIDE
        _lock — the no-op heartbeat fast path below never even takes
        the journal lock, and the request paths never wait on a disk
        write (the blocking-under-lock fix,
        docs/static_analysis.md#blocking)."""
        entry = {k: info.get(k) for k in ("addr", "port", "pid", "model")}
        with self._lock:
            # Fast path: an unchanged endpoint (every steady-state
            # heartbeat) is a liveness stamp, nothing more.
            if self._table.get(replica_id) == entry:
                self._hb_stamp_new(replica_id)
                return
        with self._journal_lock:
            with self._lock:
                # Re-check: another admit/cull may have won the race
                # for the journal lock and already applied this entry.
                if self._table.get(replica_id) == entry:
                    self._hb_stamp_new(replica_id)
                    return
                journal = self._journal
            if journal is not None:
                rec = dict(entry)
                rec.update({"type": "replica", "id": replica_id,
                            "ts": time.time()})
                # analysis: blocking-ok(fsync under the dedicated
                # membership lock: admit/cull serialize here so
                # append-before-effect holds, while _lock — the lock
                # the request and heartbeat paths contend on — stays
                # free during the disk write)
                journal.append(rec)
            with self._lock:
                self._table[replica_id] = entry
                if replica_id not in self._order:
                    self._order.append(replica_id)
                self._hb_stamp_new(replica_id)
                # (Re-)admission closes the breaker: a culled-then-
                # rediscovered replica, or one respawned on a new
                # endpoint, starts with a clean failure budget (the
                # heartbeat re-admission path lands here). It
                # also clears a stale drain — a respawned replica is
                # a new lifecycle, matching the replay fold.
                self._fail_count.pop(replica_id, None)
                self._cooling_until.pop(replica_id, None)
                self._trip_streak.pop(replica_id, None)
                self._draining.pop(replica_id, None)
                self._rotation_add(replica_id)
                _G_COOLING.set(len(self._cooling_until))
                _G_DRAINING.set(len(self._draining))
            self._maybe_compact()

    def cull(self, replica_id: str, reason: str = "silent",
             silence_sec: Optional[float] = None,
             dump: Optional[str] = None):
        """Remove a replica from rotation (journaled first). The cull
        record is structured evidence, not just a reason string: the
        silence that triggered it, the pid the replica last reported,
        and the flight-record dump path when one was collected
        (docs/flightrec.md)."""
        from horovod_tpu_torch.utils import flightrec

        with self._journal_lock:
            with self._lock:
                if replica_id not in self._table:
                    return
                pid = self._table[replica_id].get("pid")
                journal = self._journal
            if journal is not None:
                rec = {"type": "cull", "id": replica_id,
                       "reason": reason,
                       "pid": pid,
                       "ts": time.time()}
                if silence_sec is not None:
                    rec["silence_sec"] = round(silence_sec, 3)
                if dump:
                    rec["dump"] = dump
                # analysis: blocking-ok(fsync under the dedicated
                # membership lock, outside _lock — see admit())
                journal.append(rec)
            with self._lock:
                self._table.pop(replica_id, None)
                if replica_id in self._order:
                    self._order.remove(replica_id)
                self._rotation_remove(replica_id)
                self._hb_seen.pop(replica_id, None)
                self._confirmed.discard(replica_id)
                self._fail_count.pop(replica_id, None)
                self._cooling_until.pop(replica_id, None)
                self._trip_streak.pop(replica_id, None)
                self._draining.pop(replica_id, None)
                self._steps.pop(replica_id, None)
                _G_COOLING.set(len(self._cooling_until))
                _G_DRAINING.set(len(self._draining))
            self._maybe_compact()
        flightrec.record_failure("cull", "replica %s: %s"
                                 % (replica_id, reason))

    def drain(self, replica_id: str, source: str = "operator") -> bool:
        """Take ``replica_id`` out of the pick rotation NOW, journaled
        first (the admit/cull append-before-effect discipline): new
        picks skip it immediately while in-flight forwards complete,
        and a router restart replays it still benched. ``source``
        records who asked — ``heartbeat`` (the replica flagged its own
        beat), ``operator`` (/v1/drain or the CLI), or ``roll`` (the
        upgrade controller) — and gates who may auto-undrain it.
        Returns False for an unknown replica; True otherwise
        (idempotent — a steady stream of draining beats journals
        once)."""
        with self._lock:
            # Fast path: already draining (every subsequent draining
            # beat) or unknown — no journal-lock hop, no fsync.
            if replica_id in self._draining:
                return True
            if replica_id not in self._table:
                return False
        with self._journal_lock:
            with self._lock:
                if replica_id in self._draining:
                    return True
                if replica_id not in self._table:
                    return False
                journal = None if self._dead else self._journal
            if journal is not None:
                # analysis: blocking-ok(fsync under the dedicated
                # membership lock, outside _lock — see admit())
                journal.append({"type": "drain", "id": replica_id,
                                "source": source, "ts": time.time()})
            with self._lock:
                self._draining[replica_id] = source
                self._rotation_remove(replica_id)
                _G_DRAINING.set(len(self._draining))
            self._maybe_compact()
        return True

    def undrain(self, replica_id: str, source: str = "operator",
                expect_source: Optional[str] = None) -> bool:
        """Lift a drain and restore ``replica_id`` to rotation
        (journaled first). With ``expect_source`` set, only a drain of
        that source is lifted — the heartbeat auto-undrain passes
        ``"heartbeat"`` so it can never resurrect a replica the roll
        controller or an operator benched on purpose."""
        with self._lock:
            src = self._draining.get(replica_id)
            if src is None or (expect_source is not None
                               and src != expect_source):
                return False
        with self._journal_lock:
            with self._lock:
                src = self._draining.get(replica_id)
                if src is None or (expect_source is not None
                                   and src != expect_source):
                    return False
                journal = None if self._dead else self._journal
            if journal is not None:
                # analysis: blocking-ok(fsync under the dedicated
                # membership lock, outside _lock — see admit())
                journal.append({"type": "undrain", "id": replica_id,
                                "source": source, "ts": time.time()})
            with self._lock:
                self._draining.pop(replica_id, None)
                self._rotation_add(replica_id)
                _G_DRAINING.set(len(self._draining))
            self._maybe_compact()
        return True

    def replica_steps(self) -> Dict[str, object]:
        """Last serving checkpoint step each replica reported (None
        for a replica that never reported one)."""
        with self._lock:
            return {rid: self._steps.get(rid) for rid in self._table}

    def breaker_view(self, rids) -> Dict[str, Tuple[int, bool]]:
        """``rid -> (consecutive_failures, cooling)`` for the given
        replicas, one lock hop — the roll controller's per-wave health
        gate reads this instead of poking router internals."""
        with self._lock:
            now = time.monotonic()
            return {
                rid: (self._fail_count.get(rid, 0),
                      self._cooling_until.get(rid, 0.0) > now)
                for rid in rids}

    def _journal_append(self, record: dict):
        """Append a non-membership record (roll progress, takeover)
        under the same journal discipline as admit/cull: fsync'd under
        _journal_lock, never under _lock, dropped once abrupt_stop()
        declared this incarnation dead."""
        with self._journal_lock:
            with self._lock:
                journal = None if self._dead else self._journal
            if journal is not None:
                # analysis: blocking-ok(fsync under the dedicated
                # membership lock, outside _lock — see admit())
                journal.append(record)
            self._maybe_compact()

    def replicas(self) -> Dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._table.items()}

    def heartbeat_age(self, replica_id: str) -> Optional[float]:
        with self._lock:
            last = self._hb_seen.get(replica_id)
        return None if last is None else time.monotonic() - last

    def liveness_sweep(self, now: Optional[float] = None) \
            -> List[Tuple[str, float]]:
        """Pop replicas whose heartbeat deadline passed off the expiry
        heap and return them as ``(replica_id, silence_sec)`` pairs for
        the monitor to cull. Replaces the monitor's per-tick full-table
        scan: cost is O(expired · log N) per tick, not O(N). Lazy
        invalidation as for cooldowns — a fresh beat just re-arms the
        entry at its real deadline."""
        if self.liveness_sec <= 0:
            return []
        if now is None:
            now = time.monotonic()
        overdue: List[Tuple[str, float]] = []
        with self._lock:
            while self._hb_heap and self._hb_heap[0][0] <= now:
                _, rid = heapq.heappop(self._hb_heap)
                last = self._hb_seen.get(rid)
                if last is None:
                    continue  # stale: culled since this entry was armed
                deadline = last + self.liveness_sec
                if deadline > now:
                    # Beat since the entry was armed — re-arm at the
                    # real deadline.
                    heapq.heappush(self._hb_heap, (deadline, rid))
                    continue
                overdue.append((rid, now - last))
                # Re-arm so a replica the monitor declines to cull
                # (or one that beats again before the cull lands) is
                # re-checked next window instead of falling off the
                # heap forever.
                heapq.heappush(self._hb_heap,
                               (now + self.liveness_sec, rid))
        return overdue

    def stats(self) -> Dict[str, int]:
        """O(1) size counters in one lock hop — what the monitor and
        the fleet gauges need without copying the whole table."""
        with self._lock:
            return {
                "replicas": len(self._table),
                "confirmed": len(self._confirmed),
                "cooling": len(self._cooling_until),
                "draining": len(self._draining),
                "rotation": len(self._rotation),
            }

    def _expire_cooldowns(self, now: float):
        """(lock held) Pop every cooldown whose deadline has passed.
        Heap entries are lazily invalidated: an entry whose rid is no
        longer cooling (success/cull/re-admit cleared it) or whose
        actual deadline moved later (re-trip) is discarded/re-pushed
        instead of scanned for. Amortized O(log N) per breaker event —
        never an O(N) sweep per request."""
        # analysis: holds-lock(_lock) — only _pick/_pick_legacy call
        # this, under their lock.
        expired = False
        while self._cool_heap and self._cool_heap[0][0] <= now:
            _, rid = heapq.heappop(self._cool_heap)
            until = self._cooling_until.get(rid)
            if until is None:
                continue  # stale: breaker already closed
            if until > now:
                # Re-tripped with a later deadline; this entry is the
                # old one. Re-arm at the real deadline.
                heapq.heappush(self._cool_heap, (until, rid))
                continue
            # Expired cooldown re-enters rotation (half-open: the fail
            # count is still at/over the threshold, so one more failure
            # re-trips immediately with a doubled cooldown).
            self._cooling_until.pop(rid, None)
            self._rotation_add(rid)
            expired = True
        if expired:
            _G_COOLING.set(len(self._cooling_until))

    def _pick(self, exclude: Set[str]) -> Optional[Tuple[str, dict]]:
        """O(1)-per-request pick: index round-robin into the
        incrementally-maintained rotation list instead of rebuilding a
        candidate list from the full table (the pre-fleet
        implementation, kept as ``_pick_legacy`` for the equivalence
        tests and the before/after scaling curve in BENCH_fleet.json).
        The loop advances past excluded entries; a request excludes
        only replicas it already tried, so the expected cost stays O(1
        + retries), not O(N)."""
        with self._lock:
            self._expire_cooldowns(time.monotonic())
            n = len(self._rotation)
            for _ in range(n):
                rid = self._rotation[self._rr % n]
                self._rr += 1
                self.pick_scan_steps += 1
                if rid not in exclude:
                    return rid, dict(self._table[rid])
            # Rotation empty or fully excluded. Every live replica is
            # cooling (or already tried): serving nothing is strictly
            # worse than trying a suspect — fall back to an O(N) scan
            # of the full order rather than 502 a healthy fleet. Rare:
            # only under whole-fleet breaker trips. Draining replicas
            # stay excluded even here: they are LEAVING (mid-exit or
            # mid-reload), not suspects worth one more try.
            candidates = [rid for rid in self._order
                          if rid not in exclude
                          and rid not in self._draining]
            if not candidates:
                return None
            rid = candidates[self._rr % len(candidates)]
            self._rr += 1
            self.pick_scan_steps += len(candidates)
            return rid, dict(self._table[rid])

    def _pick_legacy(self, exclude: Set[str]) -> Optional[Tuple[str, dict]]:
        """The pre-fleet O(N)-per-request pick, kept verbatim (modulo
        popping expired cooldowns, which _expire_cooldowns now owns) as
        the reference implementation: the equivalence tests check _pick
        agrees with it, and bench_fleet graphs both to show the
        scaling fix."""
        with self._lock:
            now = time.monotonic()
            self._expire_cooldowns(now)
            candidates = [rid for rid in self._order
                          if rid not in exclude
                          and rid not in self._cooling_until
                          and rid not in self._draining]
            if not candidates:
                candidates = [rid for rid in self._order
                              if rid not in exclude
                              and rid not in self._draining]
            if not candidates:
                return None
            rid = candidates[self._rr % len(candidates)]
            self._rr += 1
            self.pick_scan_steps += len(candidates)
            return rid, dict(self._table[rid])

    def _note_failure(self, rid: str):
        """Charge one forward failure to ``rid``'s budget; trip the
        breaker past HVD_SERVE_BREAKER_THRESHOLD consecutive ones."""
        from horovod_tpu_torch.utils import flightrec

        tripped = None
        with self._lock:
            if rid not in self._table:
                return
            self._fail_count[rid] = self._fail_count.get(rid, 0) + 1
            if (self.breaker_threshold > 0
                    and self._fail_count[rid] >= self.breaker_threshold
                    and rid not in self._cooling_until):
                streak = self._trip_streak.get(rid, 0) + 1
                self._trip_streak[rid] = streak
                base = self.breaker_cooldown_sec * min(2 ** (streak - 1), 8)
                cooldown = base * random.uniform(0.5, 1.5)  # jittered
                until = time.monotonic() + cooldown
                self._cooling_until[rid] = until
                self._rotation_remove(rid)
                heapq.heappush(self._cool_heap, (until, rid))
                _G_COOLING.set(len(self._cooling_until))
                tripped = (self._fail_count[rid], cooldown)
        if tripped is not None:
            _C_BREAKER_TRIPS.inc()
            flightrec.record_failure(
                "breaker", "replica %s: %d consecutive forward failures; "
                "cooling %.1fs" % (rid, tripped[0], tripped[1]))

    def _note_success(self, rid: str):
        with self._lock:
            self._fail_count.pop(rid, None)
            self._trip_streak.pop(rid, None)
            if self._cooling_until.pop(rid, None) is not None:
                _G_COOLING.set(len(self._cooling_until))
            self._rotation_add(rid)

    # --- predict proxy ------------------------------------------------------

    @staticmethod
    def _forward(info: dict, body: bytes,
                 timeout: float) -> Tuple[int, bytes]:
        conn = http.client.HTTPConnection(info["addr"], int(info["port"]),
                                          timeout=timeout)
        try:
            conn.request("POST", "/v1/predict", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    _json = staticmethod(json_route_result)

    def _handle_predict(self, body: bytes):
        t0 = time.monotonic()
        timeout = float_env("HVD_SERVE_PROXY_TIMEOUT_SEC", 30.0)
        tried: Set[str] = set()
        last_err = "no live replicas"
        attempt = 0
        # Try each non-cooling replica at most once. Every forward
        # failure charges that replica's breaker budget; the client
        # only sees a 502 once every candidate failed this request.
        while True:
            picked = self._pick(tried)
            if picked is None:
                break
            rid, info = picked
            tried.add(rid)
            if attempt >= 1:
                _C_RETRIES.inc()
            attempt += 1
            try:
                status, payload = self._forward(info, body, timeout)
            except (OSError, http.client.HTTPException) as e:
                # HTTPException covers the half-dead cases OSError
                # misses: a replica killed AFTER sending headers but
                # mid-body raises IncompleteRead/BadStatusLine — that
                # forward failed just as hard and earns the same
                # budget-charge-and-retry treatment.
                last_err = "replica %s unreachable: %s" % (rid, e)
                self._note_failure(rid)
                continue
            if status >= 500:
                last_err = "replica %s returned %d" % (rid, status)
                self._note_failure(rid)
                continue
            # 2xx and client errors (4xx) both end the retry loop: a
            # malformed request fails identically everywhere. Either
            # way the REPLICA worked — its failure budget resets.
            self._note_success(rid)
            _H_LATENCY.observe(time.monotonic() - t0)
            with self._lock:
                self._requests_done += 1
            _C_REQUESTS.labels(
                outcome="ok" if status < 400 else "error").inc()
            return (status, "application/json", payload)
        _H_LATENCY.observe(time.monotonic() - t0)
        _C_REQUESTS.labels(outcome="error").inc()
        return self._json(502, {"error": last_err, "tried": sorted(tried)})

    def _handle_healthz(self):
        # One lock hop, one pass: heartbeat ages are computed from the
        # _hb_seen snapshot inside the same critical section instead of
        # N heartbeat_age() calls each taking the lock again (at fleet
        # cardinality the old shape made /healthz an O(N) lock storm
        # that starved the predict path).
        with self._lock:
            now = time.monotonic()
            table = {}
            for rid, entry in self._table.items():
                info = dict(entry)
                last = self._hb_seen.get(rid)
                info["heartbeat_age_sec"] = None if last is None \
                    else round(now - last, 3)
                info["confirmed"] = rid in self._confirmed
                info["consecutive_failures"] = self._fail_count.get(rid, 0)
                until = self._cooling_until.get(rid)
                cooling = until is not None and until > now
                if cooling:
                    info["cooling_sec_left"] = round(until - now, 3)
                # Serving step + lifecycle state: a mixed-step fleet
                # mid-roll is visible per row (drain wins over cooling
                # — a draining replica is leaving regardless of its
                # breaker).
                info["step"] = self._steps.get(rid)
                info["state"] = ("draining" if rid in self._draining
                                 else "cooling" if cooling
                                 else "serving")
                table[rid] = info
            draining = len(self._draining)
            roll = self._roll
        from horovod_tpu_torch.utils import flightrec

        return self._json(200, {
            "ok": bool(table),
            "role": "router",
            "replicas": table,
            "replayed": self._replayed,
            "draining": draining,
            "roll": roll.status() if roll is not None else None,
            "liveness_sec": self.liveness_sec,
            "pid": os.getpid(),
            "port": self.port,
            # Last N abort/wedge/cull reasons (docs/flightrec.md):
            # "why did capacity drop" answered from the same endpoint
            # that reports capacity.
            "recent_failures": flightrec.recent_failures(),
        })

    # --- fleet operations ---------------------------------------------------

    def _handle_drain(self, body: bytes):
        """``POST /v1/drain {"replica": rid}``: operator drain. The
        router benches the replica immediately (journaled) and
        best-effort forwards the drain to the replica itself so it
        finishes its queue, goodbye-beats, and exits. With
        ``"undrain": true`` it instead lifts a previous OPERATOR drain
        (roll/heartbeat drains keep their own lifecycles)."""
        try:
            doc = json.loads(body.decode() or "{}")
        except ValueError:
            return self._json(400, {"error": "body must be JSON"})
        rid = doc.get("replica")
        if not rid:
            return self._json(400, {"error": "missing 'replica'"})
        with self._lock:
            info = dict(self._table[rid]) if rid in self._table else None
        if info is None:
            return self._json(404, {"error": "unknown replica %s" % rid})
        if doc.get("undrain"):
            lifted = self.undrain(rid, source="operator",
                                  expect_source="operator")
            with self._lock:
                still_draining = rid in self._draining
            return self._json(200, {"ok": lifted, "replica": rid,
                                    "draining": still_draining})
        self.drain(rid, source="operator")
        forwarded = False
        if info.get("addr") and info.get("port"):
            try:
                conn = http.client.HTTPConnection(
                    info["addr"], int(info["port"]),
                    timeout=float_env("HVD_SERVE_PROXY_TIMEOUT_SEC", 30.0))
                try:
                    conn.request("POST", "/v1/drain", body=b"{}",
                                 headers={"Content-Type":
                                          "application/json"})
                    forwarded = conn.getresponse().status == 200
                finally:
                    conn.close()
            except (OSError, http.client.HTTPException):
                # Unreachable replica: it is benched either way, and
                # the liveness sweep will finish the cull.
                forwarded = False
        return self._json(200, {"ok": True, "replica": rid,
                                "draining": True,
                                "replica_notified": forwarded})

    def _handle_roll(self, body: bytes):
        """``POST /v1/roll {"step": N[, "wave_size", "settle_sec"]}``:
        start a rolling checkpoint upgrade in THIS router process (the
        journal owner), so every wave transition lands in the journal
        a failed-over standby replays."""
        try:
            doc = json.loads(body.decode() or "{}")
            step = int(doc["step"])
        except (ValueError, TypeError, KeyError):
            return self._json(400, {"error":
                                    "body must be JSON with int 'step'"})
        wave_size = doc.get("wave_size")
        settle_sec = doc.get("settle_sec")
        result = self.start_roll(step, wave_size=wave_size,
                                 settle_sec=settle_sec)
        return self._json(202 if result.get("ok") else 409, result)

    def _handle_roll_status(self):
        return self._json(200, self.roll_status())

    def start_roll(self, target_step: int, wave_size=None,
                   settle_sec=None, resume_state=None) -> dict:
        """Start (or resume) a rolling upgrade to ``target_step``.
        Refuses while one is active — two controllers interleaving
        drain/undrain on the same fleet would thrash it."""
        from horovod_tpu_torch.serve.rollout import RollController

        if self._dead:
            return {"ok": False, "error": "router stopped"}
        ctl = RollController(self, target_step, wave_size=wave_size,
                             settle_sec=settle_sec,
                             resume_state=resume_state)
        with self._lock:
            if self._roll is not None and self._roll.active:
                return {"ok": False,
                        "error": "upgrade already in progress",
                        "status": self._roll.status()}
            self._roll = ctl
        ctl.start()
        return {"ok": True, "status": ctl.status()}

    def roll_status(self) -> dict:
        with self._lock:
            ctl = self._roll
        if ctl is None:
            return {"active": False}
        return ctl.status()

    def resume_roll_if_pending(self) -> Optional[dict]:
        """Resume an upgrade the previous router incarnation left
        unfinished in the journal (crash or failover mid-roll):
        completed waves are skipped, the interrupted wave re-runs
        idempotently. Returns the start_roll result, or None when the
        journal holds no pending roll."""
        from horovod_tpu_torch.serve import rollout

        with self._lock:
            journal = self._journal
        if journal is None:
            return None
        state = rollout.replay_roll(journal.path)
        if state is None or state.outcome is not None:
            return None
        return self.start_roll(state.target_step,
                               wave_size=state.wave_size,
                               resume_state=state)

    def _lease_loop(self, period: float):
        from horovod_tpu_torch.serve import standby as _standby

        while True:
            if not self._dead:
                try:
                    _standby.write_lease(self._journal_dir, self.port)
                except OSError:
                    pass  # full disk etc.: standby takeover is the net
            if self._lease_stop.wait(period):
                return

    # --- lifecycle ----------------------------------------------------------

    @property
    def port(self) -> int:
        return self._kv.port

    @property
    def kv(self) -> KVStoreServer:
        return self._kv

    def requests_done(self) -> int:
        with self._lock:
            return self._requests_done

    def start(self) -> int:
        port = self._kv.start()
        if self._monitor is not None:
            self._monitor.start()
        # Leader lease for hot-standby failover: refreshed next to the
        # journal so a standby tailing the same directory can tell
        # "leader alive" from "leader silent" (serve/standby.py).
        # HVD_SERVE_LEASE_SEC=0 disables (journal-less routers never
        # lease — there is nothing for a standby to adopt).
        lease_sec = float_env("HVD_SERVE_LEASE_SEC", 1.0)
        if self._journal_dir and lease_sec > 0:
            self._lease_thread = threading.Thread(
                target=self._lease_loop, args=(lease_sec,),
                daemon=True, name="hvd-serve-lease")
            self._lease_thread.start()
        return port

    def stop(self):
        if self._monitor is not None:
            self._monitor.stop()
        self._lease_stop.set()
        if self._lease_thread is not None:
            self._lease_thread.join(timeout=5)
            self._lease_thread = None
        self._kv.stop()
        # Detach under the journal lock: an admit/cull mid-append when
        # stop() was called must finish against the open handle before
        # the detach — never append to a closed file. The _lock hop
        # keeps the attribute write visible to the fast-path readers.
        with self._journal_lock:
            with self._lock:
                journal, self._journal = self._journal, None
        if journal is not None:
            journal.close()
        # Graceful retirement clears the lease so a standby takes over
        # immediately instead of waiting out the silence window. After
        # the journal detach: the standby's Router() attach must find
        # the file quiescent.
        if self._journal_dir and not self._dead:
            from horovod_tpu_torch.serve import standby as _standby

            _standby.clear_lease(self._journal_dir)

    def abrupt_stop(self):
        """kill -9, in process form (the chaos rigs' stand-in for a
        dead router box): stop answering the port and freeze every
        writer WITHOUT closing the journal handle, clearing the lease
        file, or finishing the roll controller — exactly the on-disk
        state a SIGKILLed router leaves for the standby to adopt. The
        _dead flag fences the threads that cannot be killed in
        process (lease refresher, roll controller, late admits) from
        writing after the standby owns the journal."""
        self._dead = True
        self._lease_stop.set()
        if self._monitor is not None:
            self._monitor.stop()
        self._kv.stop()
