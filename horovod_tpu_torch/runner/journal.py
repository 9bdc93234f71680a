"""Crash-safe append-only journal: the elastic driver's record, and the
online tuner's decision log.

Port of ``horovod_tpu/runner/journal.py``, against the port's metrics
registry; records, replay rules and the ``hvd_journal_snapshots_total``
family are the reference's, so a journal written by either package reads
in the other. ``DriverJournal`` appends one JSON record per line and
fsyncs it before ``append`` returns; opening a journal first drops a torn
final line (a crash mid-append), and ``compact`` replaces the whole file
atomically with one ``snapshot`` record.

The elastic driver's record types (its port waits for ROADMAP A15, which
reuses this module):

- ``rendezvous``: full snapshot at each published version: version,
  keyed assignments, blacklist, fail counts, done slots, controller
  address.
- ``exit``: a worker left (rc 0 = done slot, nonzero = failure).
- ``wedged``: the liveness monitor replaced a silent worker.
- ``forgive``: slots un-blacklisted because their host left and
  re-entered discovery; their fail history is wiped.
- ``decay``: slots whose fail counts the stable-period decay forgot.
- ``snapshot``: a compaction point (the fields of ``rendezvous``).

Replay is snapshot + event fold: the last ``rendezvous``/``snapshot``
seeds the state and later ``exit``/``wedged`` events update it. The
online tuner (``utils/online_tuner.py``) appends its ``tune_*`` records
through the same class and folds them itself; each replayer skips the
kinds it does not know.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Set

from horovod_tpu_torch.utils import metrics as _metrics

logger = logging.getLogger("horovod_tpu_torch")

_M_SNAPSHOTS = _metrics.counter(
    "hvd_journal_snapshots_total",
    "Journal compactions: the whole file was atomically replaced by "
    "one snapshot record, bounding replay time to the tail appended "
    "since (HVD_JOURNAL_SNAPSHOT_EVERY).")

# Default blacklist threshold for standalone replay() calls; the
# driver passes its own ElasticDriver.MAX_SLOT_FAILURES so the two
# can never drift.
MAX_SLOT_FAILURES = 3

JOURNAL_FILENAME = "driver_journal.jsonl"


@dataclass
class ReplayState:
    """Driver bookkeeping reconstructed from a journal."""

    version: int = 0
    done: Set[str] = field(default_factory=set)
    fail_counts: Dict[str, int] = field(default_factory=dict)
    blacklist: Set[str] = field(default_factory=set)
    records: int = 0


def journal_path(journal_dir: str) -> str:
    return os.path.join(journal_dir, JOURNAL_FILENAME)


class DriverJournal:
    """Append-only fsync'd JSONL journal.

    Every ``append`` is flushed AND fsync'd before returning: the
    driver publishes a rendezvous version to workers only after the
    journal holds it, so a post-crash replay can never resume at a
    version some worker already saw exceeded.
    """

    def __init__(self, path: str, drop_after_close: bool = False):
        self.path = path
        # drop_after_close: the online tuner's journal opts in — its
        # elastic on_world_change restore legitimately races
        # stop_online_tuner, and a dropped tune record is a lost
        # optimization, not a lost WAL entry. The driver/router
        # journals keep the default: there an append-after-close IS a
        # WAL-ordering bug, and it must keep failing loudly (the
        # closed-file ValueError) instead of silently losing the
        # record replay/forensics depend on.
        self._drop_after_close = drop_after_close
        # Serializes appends: the online tuner journals from both its
        # search thread and the elastic worker's on_world_change
        # restore — interleaved fh.write calls would merge two records
        # into one unparsable MID-file line, and replay stops at the
        # first bad line.
        self._append_lock = threading.Lock()
        # Appends since the last compaction (seeded by the owner from
        # the replayed record count at attach): when it crosses the
        # owner's HVD_JOURNAL_SNAPSHOT_EVERY budget, the owner calls
        # compact() with a full-state snapshot record.
        self.records_since_snapshot = 0
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._truncate_torn_tail(path)
        self._fh = open(path, "a", encoding="utf-8")
        # Persist the directory entry too: append() fsyncs only the
        # file's data, but a freshly created file whose directory
        # entry never reached disk vanishes entirely in a host crash —
        # and a missing journal makes the restarted driver resume at
        # version 1, below versions live workers already fenced past.
        try:
            dfd = os.open(parent, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass  # platform without directory fsync: best effort

    @staticmethod
    def _truncate_torn_tail(path: str) -> None:
        """Drop a partial trailing line left by a crash mid-append.
        Opening in append mode would otherwise concatenate the next
        record onto the torn fragment, producing one unparsable merged
        line MID-file — and since replay stops at the first bad line,
        every record this incarnation writes would be silently lost to
        the next replay."""
        try:
            with open(path, "rb+") as fh:
                fh.seek(0, os.SEEK_END)
                if fh.tell() == 0:
                    return
                fh.seek(-1, os.SEEK_END)
                if fh.read(1) == b"\n":
                    return
                fh.seek(0)
                keep = fh.read().rfind(b"\n") + 1
                fh.truncate(keep)
        except FileNotFoundError:
            return

    def append(self, record: dict) -> None:
        with self._append_lock:
            if self._fh.closed and self._drop_after_close:
                # A writer racing teardown (the elastic worker's
                # on_world_change vs stop_online_tuner): drop the
                # record rather than raise out of the reset path —
                # but LOUDLY. Default-mode journals fall through to
                # the write below and raise the closed-file
                # ValueError: for them this is a WAL-ordering bug.
                logger.warning(
                    "journal %s: dropping %r record appended after "
                    "close", self.path, record.get("type"))
                return
            self._fh.write(json.dumps(record, sort_keys=True) + "\n")
            self._fh.flush()
            # analysis: blocking-ok(_append_lock EXISTS to serialize
            # this fsync'd write — record ordering on disk is the
            # journal's whole contract. Owners must not call append
            # while holding their own hot-path locks; the blocking
            # checker holds them to that at their call sites)
            os.fsync(self._fh.fileno())
            self.records_since_snapshot += 1

    def compact(self, snapshot_record: dict) -> None:
        """Atomically replace the whole journal with one ``snapshot``
        record carrying the owner's full current state, so replay folds
        snapshot + tail instead of the job's entire churn history.

        Crash-safe at every point: the snapshot is written to a
        sidecar file, fsync'd, then ``os.replace``d over the journal
        (atomic on POSIX) and the directory entry fsync'd — a crash
        leaves either the complete old history or the complete new
        snapshot, never a torn mix. The owner must call this only at a
        consistent point (the state in ``snapshot_record`` must
        already include every effect of previously appended records —
        the same append-before-effect discipline as ``append``)."""
        with self._append_lock:
            if self._fh.closed:
                if self._drop_after_close:
                    logger.warning(
                        "journal %s: dropping compaction after close",
                        self.path)
                    return
                raise ValueError("compact() on a closed journal")
            rec = dict(snapshot_record)
            rec["type"] = "snapshot"
            tmp = self.path + ".compact"
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.write(json.dumps(rec, sort_keys=True) + "\n")
                fh.flush()
                # analysis: blocking-ok(the atomic-replace fold must
                # be serialized against appends — _append_lock is the
                # journal's own serialization lock, see append())
                os.fsync(fh.fileno())
            os.replace(tmp, self.path)
            parent = os.path.dirname(os.path.abspath(self.path))
            try:
                dfd = os.open(parent, os.O_RDONLY)
                try:
                    # analysis: blocking-ok(directory-entry durability
                    # for the rename, under the journal's own
                    # serialization lock — see append())
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            except OSError:
                pass  # platform without directory fsync: best effort
            self._fh.close()
            self._fh = open(self.path, "a", encoding="utf-8")
            self.records_since_snapshot = 1
        _M_SNAPSHOTS.inc()

    def close(self) -> None:
        with self._append_lock:
            try:
                self._fh.close()
            except OSError:
                pass

    @staticmethod
    def count_records(path: str) -> int:
        """Line count of an existing journal — what a re-attaching
        owner seeds ``records_since_snapshot`` with so the compaction
        cadence survives restarts (every line is one record; a torn
        tail overcounts by at most one, which only compacts a record
        early)."""
        try:
            with open(path, "r", encoding="utf-8") as fh:
                return sum(1 for _ in fh)
        except OSError:
            return 0

    @staticmethod
    def replay(path: str,
               max_failures: int = MAX_SLOT_FAILURES
               ) -> Optional[ReplayState]:
        """Reconstruct driver state from ``path``; None when the file
        does not exist. A torn trailing line (crash mid-append) ends
        the replay at the last complete record. ``max_failures`` is
        the caller's blacklist threshold (the driver passes its
        authoritative constant)."""
        if not os.path.exists(path):
            return None
        state = ReplayState()
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    break  # torn tail: the crash landed mid-append
                state.records += 1
                rtype = rec.get("type")
                if rtype in ("rendezvous", "snapshot"):
                    state.version = max(state.version,
                                        int(rec.get("version", 0)))
                    state.done = set(rec.get("done", []))
                    state.fail_counts = {
                        str(k): int(v)
                        for k, v in rec.get("fail_counts", {}).items()}
                    state.blacklist = set(rec.get("blacklist", []))
                elif rtype == "exit":
                    slot = rec.get("slot")
                    if slot is None:
                        continue
                    if rec.get("rc", 1) == 0:
                        state.done.add(slot)
                    else:
                        state.fail_counts[slot] = \
                            state.fail_counts.get(slot, 0) + 1
                elif rtype == "wedged":
                    slot = rec.get("slot")
                    if slot is not None:
                        state.fail_counts[slot] = \
                            state.fail_counts.get(slot, 0) + 1
                elif rtype == "forgive":
                    for slot in rec.get("slots", []):
                        state.fail_counts.pop(slot, None)
                        state.blacklist.discard(slot)
                elif rtype == "decay":
                    # Stable-period decay: counts are forgotten but the
                    # blacklist is untouched (live decay never clears a
                    # blacklisted slot's counts, so these slots are
                    # never blacklisted ones).
                    for slot in rec.get("slots", []):
                        state.fail_counts.pop(slot, None)
        for slot, count in state.fail_counts.items():
            if count >= max_failures:
                state.blacklist.add(slot)
        return state
