"""Coordinated rolling checkpoint upgrade: the fleet moves to a new

Port of ``horovod_tpu/serve/rollout.py``: the reference's jax-free module,
copied with the port's imports; its behaviour is the reference's.

committed step in drained waves, journaled so a crash mid-roll resumes
instead of stranding a mixed-step fleet.

The controller runs INSIDE the active router process (``POST
/v1/roll`` or ``Router.start_roll``) because the router owns the
serve journal: every roll transition is appended there with the same
append-before-effect discipline as membership records, and a standby
that takes over the journal after a router death replays the roll
state (``replay_roll``) and resumes it (``Router.
resume_roll_if_pending``).

Per wave (``HVD_SERVE_ROLL_WAVE`` replicas at a time):

1. **drain** the wave (journaled; picks skip it immediately while
   in-flight forwards complete — the rest of the fleet keeps serving);
2. **hot-reload** each member to the target step (``POST /v1/reload``
   → ``Replica._restore_step``, the directed reload path: resolve, swap
   under the apply lock, re-run the bucket bit-exactness check — which
   doubles as compile warmup, so the replica re-enters rotation with
   warm buckets);
3. **re-admit** (undrain) and hold a settle window
   (``HVD_SERVE_ROLL_SETTLE_SEC``) watching the wave's breaker
   budgets;
4. a failed reload or a settle-window trip **aborts**: the abort is
   journaled, every replica already moved is rolled BACK to its prior
   step, and the fleet converges on the old checkpoint — a bad
   checkpoint can't take down more than one wave.

Journal record shapes (``type: "roll"``, folded by ``replay_roll``;
``runner/journal.py`` lists them with the driver kinds)::

    {"type": "roll", "event": "begin", "roll_id", "target_step",
     "wave_size", "waves": [[rid, ...], ...], "prior_steps": {rid: s}}
    {"type": "roll", "event": "wave",      "roll_id", "wave": i}
    {"type": "roll", "event": "wave_done", "roll_id", "wave": i}
    {"type": "roll", "event": "done",      "roll_id"}
    {"type": "roll", "event": "abort",     "roll_id", "wave", "reason"}

A roll with a ``begin`` but no ``done``/``abort`` is pending: resume
skips ``wave_done`` waves and re-runs the interrupted one —
idempotent, since draining an already-drained replica and reloading an
already-reloaded step are both no-ops.
"""

from __future__ import annotations

import http.client
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from horovod_tpu_torch.common.util import float_env, int_env

from horovod_tpu_torch.serve.router import _C_UPGRADES


@dataclass
class RollState:
    """A roll's journal-visible progress, as ``replay_roll`` folds it
    (and as ``snapshot_view`` preserves it across compaction)."""

    roll_id: str = ""
    target_step: int = 0
    wave_size: int = 1
    waves: List[List[str]] = field(default_factory=list)
    prior_steps: Dict[str, Optional[int]] = field(default_factory=dict)
    waves_done: Set[int] = field(default_factory=set)
    last_wave: Optional[int] = None
    outcome: Optional[str] = None
    reason: Optional[str] = None

    def view(self) -> dict:
        return {"roll_id": self.roll_id,
                "target_step": self.target_step,
                "wave_size": self.wave_size,
                "waves": [list(w) for w in self.waves],
                "prior_steps": dict(self.prior_steps),
                "waves_done": sorted(self.waves_done),
                "last_wave": self.last_wave}

    @staticmethod
    def from_view(view: Optional[dict]) -> Optional["RollState"]:
        if not isinstance(view, dict) or not view.get("roll_id"):
            return None
        return RollState(
            roll_id=str(view.get("roll_id")),
            target_step=int(view.get("target_step", 0)),
            wave_size=max(1, int(view.get("wave_size", 1))),
            waves=[list(w) for w in view.get("waves") or []],
            prior_steps=dict(view.get("prior_steps") or {}),
            waves_done={int(i) for i in view.get("waves_done") or []},
            last_wave=view.get("last_wave"))


def replay_roll(path: str) -> Optional[RollState]:
    """Fold the serve journal's roll records into the LAST roll's
    state (None when the journal never saw one). A compaction snapshot
    re-seeds from its embedded ``roll`` view — or clears the state
    when the snapshot carries none, since a finished roll is folded
    away on purpose. Torn trailing line ends the replay, as for
    routing."""
    if not os.path.exists(path):
        return None
    state: Optional[RollState] = None
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
                state = RollState.from_view(rec.get("roll"))
                continue
            if rtype != "roll":
                continue
            event = rec.get("event")
            if event == "begin":
                state = RollState.from_view({
                    "roll_id": rec.get("roll_id"),
                    "target_step": rec.get("target_step", 0),
                    "wave_size": rec.get("wave_size", 1),
                    "waves": rec.get("waves") or [],
                    "prior_steps": rec.get("prior_steps") or {},
                })
                continue
            if state is None or rec.get("roll_id") != state.roll_id:
                continue  # stray tail from an erased roll
            if event == "wave":
                state.last_wave = int(rec.get("wave", 0))
            elif event == "wave_done":
                state.waves_done.add(int(rec.get("wave", 0)))
            elif event == "done":
                state.outcome = "ok"
            elif event == "abort":
                state.outcome = "abort"
                state.reason = rec.get("reason")
    return state


class RollController:
    """One rolling upgrade, driven on a background thread of the
    journal-owning router. Construct via ``Router.start_roll`` (which
    enforces one-at-a-time), not directly."""

    def __init__(self, router, target_step: int,
                 wave_size: Optional[int] = None,
                 settle_sec: Optional[float] = None,
                 resume_state: Optional[RollState] = None):
        self.router = router
        self.target_step = int(target_step)
        if wave_size is None:
            wave_size = int_env("HVD_SERVE_ROLL_WAVE", 1)
        self.wave_size = max(1, int(wave_size))
        if settle_sec is None:
            settle_sec = float_env("HVD_SERVE_ROLL_SETTLE_SEC", 1.0)
        self.settle_sec = max(0.0, float(settle_sec))
        self._resume = resume_state
        self._lock = threading.Lock()
        self._state: Optional[RollState] = None
        self._status = {"active": True, "target_step": self.target_step,
                        "roll_id": None, "wave": None, "waves": None,
                        "outcome": None, "reason": None,
                        "resumed": resume_state is not None}
        self._thread: Optional[threading.Thread] = None

    # --- introspection ------------------------------------------------------

    @property
    def active(self) -> bool:
        with self._lock:
            return self._status["outcome"] is None

    def status(self) -> dict:
        with self._lock:
            return dict(self._status)

    def snapshot_view(self) -> Optional[dict]:
        """The journal-shape progress a compaction snapshot must carry
        so the roll survives its own records being folded away; None
        once finished (a finished roll needs no resume)."""
        with self._lock:
            if self._state is None or self._status["outcome"] is not None:
                return None
            return self._state.view()

    def _set(self, **kw):
        with self._lock:
            self._status.update(kw)

    # --- lifecycle ----------------------------------------------------------

    def start(self):
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="hvd-serve-roll")
        self._thread.start()

    def join(self, timeout: Optional[float] = None) -> bool:
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
            return not t.is_alive()
        return True

    def _run(self):
        try:
            self._drive()
        except Exception as e:  # analysis: allow-broad-except — an
            # unexpected controller error must land as a journaled,
            # rolled-back abort, never a silently dead upgrade thread
            # with half the fleet drained.
            if not self.router._dead:
                self._abort("controller error: %s" % e)

    # --- the roll ------------------------------------------------------------

    def _drive(self):
        from horovod_tpu_torch.utils import flightrec

        r = self.router
        if self._resume is not None:
            state = self._resume
            self.wave_size = state.wave_size
            self.target_step = state.target_step
            self._set(target_step=self.target_step)
        else:
            snap = r.replicas()
            rids = sorted(snap)
            if not rids:
                self._finish("abort", "no replicas to roll")
                return
            steps = r.replica_steps()
            state = RollState(
                roll_id="roll-%d-%d" % (os.getpid(),
                                        int(time.time() * 1000)),
                target_step=self.target_step,
                wave_size=self.wave_size,
                waves=[rids[i:i + self.wave_size]
                       for i in range(0, len(rids), self.wave_size)],
                prior_steps={rid: steps.get(rid) for rid in rids})
        with self._lock:
            self._state = state
        if self._resume is None:
            r._journal_append({"type": "roll", "event": "begin",
                               "roll_id": state.roll_id,
                               "target_step": state.target_step,
                               "wave_size": state.wave_size,
                               "waves": state.waves,
                               "prior_steps": state.prior_steps,
                               "ts": time.time()})
        self._set(roll_id=state.roll_id, waves=len(state.waves))
        flightrec.record("serve_roll_begin", roll_id=state.roll_id,
                         target_step=state.target_step,
                         waves=len(state.waves),
                         resumed=self._resume is not None)
        # Replicas already moved to the target (done waves on resume):
        # an abort later must roll these back too — fleet uniformity
        # is the whole point.
        touched: List[str] = [rid for i in sorted(state.waves_done)
                              for rid in state.waves[i]]
        for i, wave in enumerate(state.waves):
            if i in state.waves_done:
                continue
            if r._dead:
                return  # kill -9 shape: the journal has the truth
            self._set(wave=i)
            with self._lock:
                self._state.last_wave = i
            r._journal_append({"type": "roll", "event": "wave",
                               "roll_id": state.roll_id, "wave": i,
                               "replicas": wave, "ts": time.time()})
            for rid in wave:
                r.drain(rid, source="roll")
            failure: Optional[str] = None
            for rid in wave:
                if r._dead:
                    return
                if rid not in r.replicas():
                    continue  # culled mid-roll: nothing to reload
                if self._reload(rid, state.target_step):
                    touched.append(rid)
                else:
                    failure = ("replica %s failed reload to step %d"
                               % (rid, state.target_step))
                    break
            if failure is None:
                for rid in wave:
                    r.undrain(rid, source="roll", expect_source="roll")
                failure = self._settle(wave)
            if failure is not None:
                self._rollback(state, i, touched, failure)
                return
            with self._lock:
                self._state.waves_done.add(i)
            r._journal_append({"type": "roll", "event": "wave_done",
                               "roll_id": state.roll_id, "wave": i,
                               "ts": time.time()})
        if r._dead:
            return
        r._journal_append({"type": "roll", "event": "done",
                           "roll_id": state.roll_id, "ts": time.time()})
        self._finish("ok", None)

    def _reload(self, rid: str, step: Optional[int]) -> bool:
        """POST /v1/reload to one replica; True only when it confirms
        serving exactly ``step``."""
        if step is None:
            return True  # no prior step recorded: nothing to restore
        info = self.router.replicas().get(rid)
        if info is None or not (info.get("addr") and info.get("port")):
            return False
        timeout = float_env("HVD_SERVE_PROXY_TIMEOUT_SEC", 30.0)
        body = json.dumps({"step": int(step), "replica": rid}).encode()
        try:
            conn = http.client.HTTPConnection(
                info["addr"], int(info["port"]), timeout=timeout)
            try:
                conn.request("POST", "/v1/reload", body=body,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                payload = resp.read()
            finally:
                conn.close()
        except (OSError, http.client.HTTPException):
            return False
        if resp.status != 200:
            return False
        try:
            doc = json.loads(payload.decode())
        except ValueError:
            return False
        return doc.get("ok") is True and doc.get("step") == int(step)

    def _settle(self, wave: List[str]) -> Optional[str]:
        """Hold the wave in rotation for the settle window; any NEW
        breaker charge against a member fails the wave (the error-
        budget gate). Baselined at re-admission so a sub-threshold
        failure streak from BEFORE the roll cannot fail a healthy
        wave."""
        baseline = {rid: fails for rid, (fails, _)
                    in self.router.breaker_view(wave).items()}
        deadline = time.monotonic() + self.settle_sec
        while True:
            if self.router._dead:
                return None  # outer loop exits on the dead check
            for rid, (fails, cooling) in \
                    self.router.breaker_view(wave).items():
                if cooling or fails > baseline.get(rid, 0):
                    return ("replica %s unhealthy after reload "
                            "(%d consecutive forward failures%s)"
                            % (rid, fails,
                               ", breaker tripped" if cooling else ""))
                # Ratchet down: a success reset the streak, so any
                # LATER failure must gate even though the pre-roll
                # baseline was higher.
                baseline[rid] = min(baseline.get(rid, 0), fails)
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.05)

    def _rollback(self, state: RollState, wave_idx: int,
                  touched: List[str], reason: str):
        from horovod_tpu_torch.utils import flightrec

        r = self.router
        r._journal_append({"type": "roll", "event": "abort",
                           "roll_id": state.roll_id, "wave": wave_idx,
                           "reason": reason, "ts": time.time()})
        flightrec.record_failure(
            "roll_abort", "roll %s wave %d: %s"
            % (state.roll_id, wave_idx, reason))
        # Best-effort convergence back to the prior fleet: every
        # replica already moved reloads its prior step, every replica
        # this roll drained re-enters rotation.
        for rid in touched:
            if r._dead:
                return
            self._reload(rid, state.prior_steps.get(rid))
        for wave in state.waves[:wave_idx + 1]:
            for rid in wave:
                r.undrain(rid, source="roll", expect_source="roll")
        self._finish("abort", reason)

    def _abort(self, reason: str):
        """Terminal error path for _run: journal the abort even when
        _drive died before/while journaling its own progress."""
        with self._lock:
            state = self._state
        if state is not None:
            self._rollback(state, state.last_wave or 0,
                           [], reason)
        else:
            self._finish("abort", reason)

    def _finish(self, outcome: str, reason: Optional[str]):
        from horovod_tpu_torch.utils import flightrec

        self._set(active=False, outcome=outcome, reason=reason)
        _C_UPGRADES.labels(outcome=outcome).inc()
        flightrec.record("serve_roll_end", outcome=outcome,
                         reason=reason)
