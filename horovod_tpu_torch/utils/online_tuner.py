"""Online, metrics-driven, journaled knob tuner with a regression
guardrail.

Port of ``horovod_tpu/utils/online_tuner.py``: the same search, guardrail,
journal records and ``hvd_tune_*`` families, on the port's metrics
registry, ``BayesianOptimizer`` (``utils/autotune.py``), journal
(``runner/journal.py``) and knob schema (``common/knobs.py``), so that the
same objective and clock give the same decisions in both packages and a
journal written by either replays in the other.

- **Schema.** ``common/knobs.TUNABLE`` declares every tunable knob:
  bounds, step granularity, and apply path (native ``set_params`` /
  ``set_wire_params`` through the live core, env read at next use, or a
  callable setter that the owning subsystem registers).
- **Objective.** Read from the process-wide metrics registry: a monotone
  "goodness" counter sampled over fixed-length observation windows; the
  window's rate is the score. Training's is the bytes the data planes
  move (``wire_bytes_total``): the core's TCP ring, and the device
  plane's NCCL calls for card tensors. At size 1 NCCL moves nothing, so
  it reads 0 and the tuner rightly never searches; a caller may pass its
  own ``objective`` to ``start_online_tuner``.
- **Search.** ``BayesianOptimizer`` proposes joint moves over the
  non-frozen knobs, snapped to each knob's step grid.
- **Guardrail.** Every applied move must survive an A/B window: the
  post-apply rate may not fall below the pre-apply rate by more than a
  noise band estimated from the pre-apply window's sub-window variance.
  A regressing move is reverted and recorded as a loss.
- **Journal.** Every propose/apply/accept/revert/freeze decision goes
  through ``runner/journal.DriverJournal`` (fsync'd append, torn-tail
  tolerant). A restarted process replays the journal and resumes at its
  tuned state instead of searching again; a journal written by another
  tuner version or knob schema is fenced off and ignored.

On the card the fusion threshold and the cycle time reach card tensors
(the device plane sizes its fusion buffer by the core's live threshold);
``ring_chunk_bytes`` and ``socket_buf_bytes`` shape only the TCP ring,
and the guardrail absorbs their moves. ``grad_bucket_bytes`` stays
``live_safe=False``: ranks that build their bucketed optimizers with
different buckets issue NCCL allreduces of different sizes.

Enable with ``HVD_TUNE=1`` (search online), ``HVD_TUNE=cache`` (replay
the journaled tuned state, never search), ``0``/unset = off. The
elastic run wrapper (``elastic/worker.py``) starts the tuner thread;
``start_online_tuner()`` is the library entry point. The serving role's
setters come with ROADMAP A13.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from horovod_tpu_torch.common.knobs import TUNABLE, TunableKnob, tunable_snap
from horovod_tpu_torch.runner.journal import DriverJournal
from horovod_tpu_torch.utils import flightrec
from horovod_tpu_torch.utils import metrics as _metrics
from horovod_tpu_torch.utils.autotune import BayesianOptimizer

logger = logging.getLogger("horovod_tpu_torch")

# Bumped when the journal record semantics change; a journal stamped
# with a different version is fenced off at replay (re-searching beats
# replaying a state whose meaning drifted).
TUNER_VERSION = 1

# Sampling constants mirroring the reference's parameter_manager.cc
# shape: enough samples for the GP to localize a 2-4 dim box, then
# freeze so a long job stops paying measurement noise.
DEFAULT_MAX_SAMPLES = 20
DEFAULT_SUBWINDOWS = 4

_M_WINDOWS = _metrics.counter(
    "hvd_tune_windows_total",
    "Observation windows the online tuner measured (baseline and "
    "guard windows both count; docs/autotune.md).")
_M_MOVES = _metrics.counter(
    "hvd_tune_moves_total",
    "Knob moves the online tuner applied, by guardrail outcome "
    "(accept = kept, revert = regressed past the noise band and was "
    "rolled back).", ("outcome",))
_M_REPLAYS = _metrics.counter(
    "hvd_tune_replays_total",
    "Journal replays that restored a tuned state into a restarted "
    "process (elastic reset / serve respawn) instead of a cold "
    "re-search.")
_G_OBJECTIVE = _metrics.gauge(
    "hvd_tune_objective",
    "Last baseline objective rate the online tuner measured "
    "(units/sec of the configured objective counter).")
_G_FROZEN = _metrics.gauge(
    "hvd_tune_frozen",
    "1 once the online tuner froze its best point (search done), else "
    "0.")


def tune_mode() -> str:
    """Resolved ``HVD_TUNE``: '' (off), '1' (search online) or
    'cache' (replay journaled state only)."""
    mode = os.environ.get("HVD_TUNE", "").strip().lower()
    if mode in ("", "0", "off", "false"):
        return ""
    if mode == "cache":
        return "cache"
    return "1"


def frozen_knob_names() -> List[str]:
    """``HVD_TUNE_FREEZE`` as a set of schema names (unknown names are
    logged and ignored rather than failing the job)."""
    raw = os.environ.get("HVD_TUNE_FREEZE", "")
    out = []
    for name in raw.split(","):
        name = name.strip()
        if not name:
            continue
        if name not in TUNABLE:
            logger.warning("HVD_TUNE_FREEZE names unknown knob %r "
                           "(schema: %s)", name, ", ".join(sorted(TUNABLE)))
            continue
        out.append(name)
    return out


# --- objectives --------------------------------------------------------------


def wire_bytes_total() -> float:
    """Training objective source: cumulative data-plane bytes moved. The
    two families hold the core's TCP ring bytes (its counters, bridged
    into the registry) and, for card tensors, the bytes the device
    plane's NCCL calls move for this rank (``core/device_plane.py``): 0
    at size 1, where NCCL moves nothing. Collectors run on every read,
    so this is fresh."""
    total = 0.0
    for fam in ("hvd_comm_tx_bytes_total", "hvd_comm_rx_bytes_total"):
        v = _metrics.value(fam)
        if v is not None:
            total += float(v)
    return total


def serve_rows_total() -> float:
    """Serving objective source: cumulative rows served through THIS
    replica's micro-batcher (the hvd_serve_batch_size histogram's sum
    — observed once per batch with that batch's row count, so the sum
    is a monotone rows-served counter). Deliberately NOT
    hvd_serve_requests_total: that counter lives in the ROUTER
    process; in a replica it is permanently zero and the tuner would
    idle forever."""
    v = _metrics.value("hvd_serve_batch_size")
    if isinstance(v, dict):
        return float(v.get("sum") or 0.0)
    return 0.0


# --- knob application --------------------------------------------------------


def _shared_world() -> bool:
    """Lazy-import delegate (this module must stay importable without
    basics' init-time machinery); checked at every live-unsafe apply,
    not just at tuner start, because elastic worlds grow after the
    tuner thread is already running."""
    from horovod_tpu_torch.common import basics

    return basics.is_shared_world()


# Serializes every KnobBinding.apply — gate check AND write as one
# atomic unit. Closes the TOCTOU between the live_safe gate and the
# env/native write: a search thread that passed the gate at size 1
# could otherwise be descheduled, the world grow via elastic reinit,
# on_world_change restore the launch value, and the stale write then
# land on top — leaving this rank's next optimizer build divergent. With the
# lock, a stale apply either completes BEFORE the restore (which then
# overwrites it, uniform) or acquires after, re-reads _shared_world()
# — already True by the time on_world_change runs, program order in
# the worker thread — and refuses. Leaf lock: apply never takes
# another tuner lock inside it.
_apply_lock = threading.Lock()


class KnobBinding:
    """One schema knob wired to its apply path. ``setter`` overrides
    the schema path (the serve batcher registers one); otherwise
    "native" routes through the live CoreSession and "env" (and every
    native knob too, as a mirror) writes the backing env var so an
    elastic re-bootstrap reconstructs the tuned state."""

    def __init__(self, knob: TunableKnob,
                 setter: Optional[Callable[[float], None]] = None):
        self.knob = knob
        self._setter = setter
        # Launch anchor, captured RAW at binding construction (before
        # any tuner mutation): the one rank-uniform restore target in
        # a shared world — freshly joined peers inherit the same job
        # env this process launched with. _apply_locked clamps
        # shared-world restores of live-unsafe knobs to it UNDER the
        # lock, so a revert whose target was computed before an
        # elastic reinit cannot land a stale per-rank incumbent.
        # Presence matters as much as the value: when the env mirror
        # was UNSET at launch, the uniform restore must DELETE it —
        # a peer may gate on the mere presence of a variable (the
        # reference's flash tile view does on HVD_FLASH_BLOCK_Q/K,
        # ROADMAP B.4), so a left-behind mirror would set this rank
        # apart from its peers.
        self._launch = float(self.current())
        self._launch_env_set = bool(knob.env) and knob.env in os.environ

    @property
    def name(self) -> str:
        return self.knob.name

    def current(self) -> float:
        """Best-effort current value: env mirror, else schema default."""
        if self.knob.env and self.knob.env in os.environ:
            try:
                raw = float(os.environ[self.knob.env])
            except ValueError:
                return self.knob.default
            if self.knob.name == "fusion_threshold_mb":
                return raw / (1024.0 * 1024.0)
            return raw
        return self.knob.default

    def apply(self, value: float, *, restore: bool = False) -> float:
        """Snap ``value`` to the knob's grid, push it through the apply
        path, mirror it to the env knob; returns the snapped value.

        live_safe gate: a ``live_safe=False`` knob is never mutated
        while this process shares a world — the start-time filter in
        ``start_online_tuner`` drops such knobs from the searched set,
        but an ELASTIC world can grow after the tuner started (size 1
        at start, peers join via reinit), and per-rank mutation of a
        build-time knob then makes NCCL allreduces of different sizes
        across ranks. Refusing
        at the apply path closes that window no matter how the
        binding was composed; the refusal returns the live value so
        the tuner's bookkeeping stays coherent. ``restore=True``
        (the guardrail's revert) is exempt: blocking a revert would
        strand the knob at the mid-search value the guard just
        rejected — restoring the incumbent moves TOWARD uniformity,
        never away from it.

        The whole check-then-write runs under the module ``_apply_lock``
        (see its comment): the gate re-reads ``_shared_world()``
        atomically with the write, so a stale search-thread apply can
        never land AFTER on_world_change's uniform restore."""
        with _apply_lock:
            return self._apply_locked(value, restore)

    def _apply_locked(self, value: float, restore: bool) -> float:
        # analysis: holds-lock(_apply_lock) — only apply() calls this,
        # with the lock held.
        unset_env = False
        if restore:
            # Restores bypass the grid snap: the launch anchor must be
            # re-applied BYTE-uniform with peers that inherit the raw
            # job env — snapping an off-grid HVD_GRAD_BUCKET_BYTES
            # onto the box would itself diverge from them.
            value = float(value)
            if not self.knob.live_safe and _shared_world():
                # Re-derived UNDER the lock: restore targets are
                # computed before the lock, so a revert racing an
                # elastic reinit could carry a stale per-rank
                # incumbent chosen at size 1 and land it after
                # on_world_change's uniform restore. In a shared
                # world the only uniform target for a live-unsafe
                # knob is the launch anchor — including its ABSENCE:
                # a mirror the job never set must be deleted, not
                # written back as the default (peers gate on the
                # var's mere presence).
                value = self._launch
                unset_env = not self._launch_env_set
        else:
            value = tunable_snap(self.knob, value)
            if not self.knob.live_safe and _shared_world():
                logger.warning(
                    "online tuner: refusing to apply live-unsafe knob "
                    "%s in a multi-rank world (ranks would issue "
                    "collectives of different sizes)", self.knob.name)
                return tunable_snap(self.knob, self.current())
        if self._setter is not None:
            self._setter(value)
        elif self.knob.apply_path == "native":
            self._apply_native(value)
        # env mirror (and the whole story for "env" knobs): next
        # use/trace/bootstrap reads the tuned value.
        if self.knob.env and unset_env:
            # Restore-to-absent: the launch state had no mirror.
            os.environ.pop(self.knob.env, None)
        elif self.knob.env:
            if self.knob.name == "fusion_threshold_mb":
                # The box's 0 MB endpoint means "unfused"; <=0 is "no
                # update" downstream, so spell it as a 1-byte threshold
                # (same convention as utils/autotune._apply).
                os.environ[self.knob.env] = str(
                    max(int(value * 1024 * 1024), 1))
            elif float(value) == int(value):
                os.environ[self.knob.env] = str(int(value))
            else:
                os.environ[self.knob.env] = repr(float(value))
        return value

    def _apply_native(self, value: float):
        from horovod_tpu_torch.common import basics

        sess = basics.core_session()
        if sess is None:
            return  # before init (or between a reset's shutdown and init):
            # the env mirror is the apply
        if self.knob.name == "fusion_threshold_mb":
            sess.set_params(-1.0, max(int(value * 1024 * 1024), 1))
        elif self.knob.name == "cycle_time_ms":
            sess.set_params(float(value), -1)
        elif self.knob.name == "ring_chunk_bytes":
            sess.set_wire_params(ring_chunk_bytes=int(value))
        elif self.knob.name == "socket_buf_bytes":
            sess.set_wire_params(socket_buf_bytes=int(value))
        elif self.knob.name == "wire_codec":
            # Staged, not applied: the coordinator broadcasts the codec
            # at its next slow-path round so every rank flips together
            # (the knob is live_safe=False — only a single-process
            # world, or an explicit operator stage, reaches here).
            sess.stage_wire_codec(int(value))
        else:
            raise ValueError("no native apply for knob %r" % self.knob.name)


def schema_fence(knobs: Sequence[TunableKnob]) -> str:
    """Stable hash of the searched schema (names + boxes + steps): a
    journal written against a different schema replays as garbage
    coordinates, so it is fenced off instead."""
    blob = "|".join("%s:%g:%g:%g" % (k.name, k.lo, k.hi, k.step)
                    for k in sorted(knobs, key=lambda k: k.name))
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


# --- journal replay ----------------------------------------------------------


class TuneReplay:
    """Folded journal state: the values to adopt, the round-counting
    ``samples``, every ``measured`` (x, y) point (baselines included —
    the freeze pool), and whether the search had frozen."""

    def __init__(self):
        self.values: Optional[Dict[str, float]] = None
        self.samples: List[Tuple[Dict[str, float], float]] = []
        self.measured: List[Tuple[Dict[str, float], float]] = []
        self.frozen = False
        self.records = 0


def replay_journal(path: str, fence: str) -> Optional[TuneReplay]:
    """Fold a tuner journal. Version fencing: only records following a
    ``tune_meta`` whose (tuner_version, fence) matches count; a
    mismatched meta resets the fold, so a journal from an older tuner
    or a different knob schema yields None (cold start) instead of
    poisoning the new search. Torn tails end the fold at the last
    complete record (same rule as DriverJournal.replay)."""
    if not os.path.exists(path):
        return None
    state: Optional[TuneReplay] = None
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                break  # torn tail: the crash landed mid-append
            rtype = rec.get("type")
            if rtype == "tune_meta":
                if (rec.get("tuner_version") == TUNER_VERSION
                        and rec.get("fence") == fence):
                    # Matching meta: every restarted incarnation
                    # appends one, so keep folding across it — only
                    # open fresh state when everything before was
                    # fenced off.
                    state = state if state is not None else TuneReplay()
                else:
                    state = None  # fenced: stale version or schema
                continue
            if state is None:
                continue
            state.records += 1
            if rtype in ("tune_accept", "tune_freeze", "tune_replay"):
                state.values = dict(rec.get("values", {}))
            elif rtype == "tune_revert":
                state.values = dict(rec.get("values", {}))
            if rtype == "tune_accept" and "objective" in rec:
                point = (dict(rec.get("values", {})),
                         float(rec["objective"]))
                state.samples.append(point)
                state.measured.append(point)
            elif rtype == "tune_revert" and "objective" in rec \
                    and rec.get("applied"):
                point = (dict(rec["applied"]), float(rec["objective"]))
                state.samples.append(point)
                state.measured.append(point)
            elif rtype == "tune_apply" and "baseline" in rec \
                    and rec.get("from"):
                # The incumbent's baseline measurement: part of the
                # freeze pool (the best point seen may well BE the
                # incumbent when every move regressed).
                state.measured.append((dict(rec["from"]),
                                       float(rec["baseline"])))
            if rtype == "tune_freeze":
                state.frozen = True
            elif rtype == "tune_replay" and rec.get("frozen"):
                state.frozen = True  # a replayed freeze stays frozen
    if state is not None and state.values is None and not state.samples:
        return None  # meta only: nothing to resume
    return state


# --- the tuner ---------------------------------------------------------------


class OnlineTuner:
    """Background knob search over live objective windows.

    The loop (one *round* per iteration):

    1. measure a **baseline** window: ``subwindows`` rate samples give
       a mean rate o0 and a standard error sem0 — the noise estimate;
    2. **propose** the next joint point from the Bayesian optimizer
       (warmed with every sample so far) and **apply** it through each
       knob's apply path; the decision is journaled BEFORE the move is
       live, so a crash can never leave an unexplained knob state;
    3. measure the **guard** window: its rate o1 must not fall below
       ``o0 * (1 - guard)`` where ``guard = max(guard_pct/100,
       2 * sem0 / o0)`` — regressions beyond the noise band revert the
       move (journaled as a loss); survivors are accepted (journaled);
    4. after ``max_samples`` rounds the best measured point is applied
       and frozen (journaled) — the search is done for this process
       lifetime, replay restores it after a restart.

    Deterministic and test-injectable: ``clock``/``wait`` default to
    real time but tests drive the loop with a fake clock and a
    synthetic objective, calling ``step()`` directly — no thread, no
    sleeping, seconds per test.
    """

    def __init__(self, bindings: Sequence[KnobBinding],
                 objective: Callable[[], float], *,
                 window_sec: Optional[float] = None,
                 guard_pct: Optional[float] = None,
                 journal_path: Optional[str] = None,
                 max_samples: int = DEFAULT_MAX_SAMPLES,
                 subwindows: int = DEFAULT_SUBWINDOWS,
                 seed: int = 1234,
                 clock: Callable[[], float] = time.monotonic,
                 wait: Optional[Callable[[float], bool]] = None,
                 fence_knobs: Optional[Sequence[TunableKnob]] = None):
        if not bindings:
            raise ValueError("OnlineTuner needs at least one knob")
        if window_sec is None:
            try:
                window_sec = float(os.environ.get(
                    "HVD_TUNE_WINDOW_SEC", "30"))
            except ValueError:
                window_sec = 30.0
        if guard_pct is None:
            try:
                guard_pct = float(os.environ.get("HVD_TUNE_GUARD_PCT", "5"))
            except ValueError:
                guard_pct = 5.0
        self.bindings = list(bindings)
        self.objective = objective
        self.window_sec = max(float(window_sec), 1e-6)
        self.guard_pct = max(float(guard_pct), 0.0)
        self.max_samples = int(max_samples)
        self.subwindows = max(int(subwindows), 2)
        self._clock = clock
        self._stop = threading.Event()
        # wait(seconds) -> True when the tuner should stop; the default
        # sleeps on the stop event so stop() interrupts a window.
        self._wait = wait if wait is not None else self._stop.wait
        self._seed = seed
        # The journal fence hashes the COMPOSED schema, captured once
        # at init: the searched set may shrink (start-time live_safe
        # drop in a multi-rank world, mid-run prune when the world
        # grows), and a journal written by the full composition must
        # keep replaying across those recompositions — values for
        # knobs no longer bound are simply filtered at adoption.
        self._fence_knobs = (list(fence_knobs) if fence_knobs is not None
                             else [b.knob for b in self.bindings])
        self._bo = BayesianOptimizer(
            [(b.knob.lo, b.knob.hi) for b in self.bindings], seed=seed)
        self._journal: Optional[DriverJournal] = None
        self._journal_path = journal_path
        self._thread: Optional[threading.Thread] = None
        # _lock guards the search state shared between the tuner
        # thread and state()/trajectory() readers. _prune_lock
        # serializes _prune_live_unsafe between the search loop and
        # on_world_change (the second entrant sees no live-unsafe
        # bindings and no-ops).
        self._lock = threading.Lock()
        self._prune_lock = threading.Lock()
        self._values: Dict[str, float] = {
            b.name: tunable_snap(b.knob, b.current())
            for b in self.bindings}
        # _samples counts search rounds (the freeze trigger);
        # _measured is every (x, y) measurement including incumbent
        # baselines — the pool _freeze picks the best point from.
        self._samples: List[Tuple[Dict[str, float], float]] = []
        self._measured: List[Tuple[Dict[str, float], float]] = []
        self._trajectory: List[dict] = []
        self._frozen = False
        self._replayed = False

    # --- journal ------------------------------------------------------------

    @property
    def fence(self) -> str:
        return schema_fence(self._fence_knobs)

    def _attach_journal(self):
        if self._journal_path is None or self._journal is not None:
            return
        self._journal = DriverJournal(self._journal_path,
                                      drop_after_close=True)
        self._journal.append({
            "type": "tune_meta",
            "tuner_version": TUNER_VERSION,
            "fence": self.fence,
            # The fence schema, not the (possibly narrower) searched
            # set — the fence string above hashes exactly these.
            "knobs": {k.name: {"lo": k.lo, "hi": k.hi, "step": k.step}
                      for k in self._fence_knobs},
        })

    def _record(self, rec: dict):
        with self._lock:
            self._trajectory.append(rec)
        if self._journal is not None:
            self._journal.append(rec)

    # --- replay -------------------------------------------------------------

    def replay(self) -> bool:
        """Fold an existing journal (if any) and adopt its state:
        tuned values are re-applied, samples warm the optimizer, a
        frozen search stays frozen. Returns True when a tuned state
        was adopted. Must run before ``_attach_journal`` appends the
        new incarnation's meta record."""
        if self._journal_path is None:
            return False
        rep = replay_journal(self._journal_path, self.fence)
        if rep is None:
            return False
        with self._lock:
            self._samples = list(rep.samples)
            self._measured = list(rep.measured)
            self._frozen = rep.frozen
            adopted = dict(rep.values) if rep.values else None
        for values, score in rep.measured:
            self._bo.add_sample(self._as_vector(values), score)
        if adopted:
            applied = self._apply_values(adopted)
            with self._lock:
                self._values.update(applied)
            self._record({"type": "tune_replay", "values": applied,
                          "resumed_samples": len(rep.samples),
                          "frozen": rep.frozen})
            _M_REPLAYS.inc()
        _G_FROZEN.set(1.0 if rep.frozen else 0.0)
        return adopted is not None

    # --- measurement --------------------------------------------------------

    def _measure_window(self) -> Tuple[float, float]:
        """(mean rate, standard error) over ``subwindows`` sub-window
        rates of one observation window. The sem is the noise estimate
        the guardrail's band is built from."""
        sub = self.window_sec / self.subwindows
        rates = []
        last_total = self.objective()
        last_t = self._clock()
        for _ in range(self.subwindows):
            if self._wait(sub):
                break
            total, now = self.objective(), self._clock()
            dt = max(now - last_t, 1e-9)
            rates.append(max(total - last_total, 0.0) / dt)
            last_total, last_t = total, now
        _M_WINDOWS.inc()
        if not rates:
            return 0.0, 0.0
        mean = sum(rates) / len(rates)
        var = sum((r - mean) ** 2 for r in rates) / max(len(rates) - 1, 1)
        sem = (var ** 0.5) / (len(rates) ** 0.5)
        return mean, sem

    # --- the search round ---------------------------------------------------

    def _as_vector(self, values: Dict[str, float]) -> List[float]:
        return [float(values.get(b.name, b.knob.default))
                for b in self.bindings]

    def _apply_values(self, values: Dict[str, float],
                      restore: bool = False) -> Dict[str, float]:
        return {b.name: b.apply(values[b.name], restore=restore)
                for b in self.bindings if b.name in values}

    def _prune_live_unsafe(self) -> None:
        """Elastic worlds grow mid-search: the start-time filter in
        ``start_online_tuner`` cannot see a size-1 world that later
        gains peers, and leaning on ``KnobBinding.apply``'s per-apply
        refusal alone would leave a permanently dead search dimension
        (every window proposing a value that can never land, with a
        warning each time). Drop live-unsafe bindings ONCE when the
        shared world is first observed, rebuild the optimizer box over
        the survivors, and re-feed the measured samples projected onto
        the remaining dims. With nothing left to search, freeze.

        Only the search thread calls this on a LIVE search (step's
        round top); on_world_change calls it only once that thread is
        no longer running — so ``self.bindings`` is never swapped
        under a concurrently built proposal. The lock just serializes
        the two callers at that hand-off."""
        with self._prune_lock:
            # analysis: blocking-ok(_prune_lock is a cold hand-off
            # serializer — two callers, at most once per world change;
            # no hot path ever takes it, and the journaled freeze/
            # prune record must stay atomic with the binding swap it
            # describes)
            self._prune_live_unsafe_locked()

    def _prune_live_unsafe_locked(self) -> None:
        # analysis: holds-lock(_prune_lock) — only _prune_live_unsafe
        # calls this, with the lock held.
        if not any(not b.knob.live_safe for b in self.bindings):
            return
        if not _shared_world():
            return
        dropped = sorted(b.name for b in self.bindings
                         if not b.knob.live_safe)
        logger.warning(
            "online tuner: world grew mid-search — dropping "
            "live-unsafe knob(s) %s and restoring their launch values "
            "(ranks would issue collectives of different sizes)",
            ", ".join(dropped))
        restored = self._restore_unsafe_to_launch()
        keep = [b for b in self.bindings if b.knob.live_safe]
        self.bindings = keep
        if not keep:
            # Nothing left to search: freeze AT the restored values,
            # journaled — state() must report what is
            # actually live, and post-mortem forensics (and a
            # replaying restart) must see why the search ended. When
            # the search had ALREADY frozen (the on_world_change
            # path), record the restore as a prune instead of a
            # second freeze.
            with self._lock:
                was_frozen = self._frozen
                self._values = dict(restored)
                self._frozen = True
            if was_frozen:
                self._record({"type": "tune_prune", "dropped": dropped,
                              "restored": restored})
            else:
                self._record({"type": "tune_freeze",
                              "values": dict(restored),
                              "pruned": dropped,
                              "reason": "live-unsafe knobs in a "
                                        "shared world"})
            _G_FROZEN.set(1.0)
            return
        self._bo = BayesianOptimizer(
            [(b.knob.lo, b.knob.hi) for b in keep], seed=self._seed)
        with self._lock:
            measured = list(self._measured)
            # The restored launch values STAY in _values: state() and
            # must keep reporting what is live for the
            # pruned knobs, not silently forget them.
            self._values.update(restored)
            for b in keep:
                self._values.setdefault(
                    b.name, tunable_snap(b.knob, b.current()))
        self._record({"type": "tune_prune", "dropped": dropped,
                      "restored": restored})
        for values, score in measured:
            self._bo.add_sample(self._as_vector(values), score)

    def _restore_unsafe_to_launch(self) -> Dict[str, float]:
        """Apply the launch anchor to every live-unsafe binding;
        returns {name: restored value}. The anchor lives ON the
        binding (KnobBinding._launch, captured raw at construction)
        and _apply_locked clamps every shared-world live-unsafe
        restore to it under the apply lock — one store, one clamp,
        so the restore target cannot drift and a racing stale revert
        cannot bypass it."""
        restored: Dict[str, float] = {}
        for b in list(self.bindings):
            if not b.knob.live_safe:
                restored[b.name] = b.apply(b._launch, restore=True)
        return restored

    def _restore_live_unsafe_values(self) -> None:
        """Inline launch-value restore for live-unsafe bindings,
        WITHOUT touching ``bindings``/``_bo`` — safe to call from
        another thread while the search loop runs (a values-only
        restore cannot misalign a concurrently built proposal; the
        loop's own round-top prune does the structural drop). Called
        by ``on_world_change`` so that the worker's reset callbacks see
        uniform values instead of waiting up to a measurement window
        for the round top. Shared-world gated like the structural
        prune: a reset that lands on (or stays at) size 1 must not
        yank values the tuner legitimately searches alone."""
        if not _shared_world():
            return
        restored = self._restore_unsafe_to_launch()
        if restored:
            with self._lock:
                self._values.update(restored)
            self._record({"type": "tune_restore", "restored": restored})

    def step(self) -> Optional[dict]:
        """One search round (see class docstring); returns the round's
        outcome record, or None once frozen/stopped."""
        self._prune_live_unsafe()
        with self._lock:
            if self._frozen:
                return None
            current = dict(self._values)
            n_samples = len(self._samples)
        if n_samples >= self.max_samples:
            return self._freeze()
        baseline, sem = self._measure_window()
        if self._stop.is_set():
            return None
        _G_OBJECTIVE.set(baseline)
        if baseline <= 0.0:
            # No signal: the job is idle (serve replica before first
            # traffic, training between phases) or the objective
            # counter is not wired. With o0 = 0 every move would pass
            # the guard trivially — a random walk teaching the
            # optimizer nothing — so don't search: keep measuring
            # until there is something to optimize. Not journaled
            # (idle windows would bloat the journal), not counted
            # toward freeze.
            with self._lock:
                # Coalesce consecutive idle windows into one record:
                # a replica idling for weeks at the 30 s window would
                # otherwise grow the trajectory without bound (idle
                # rounds never count toward freeze, so the loop never
                # terminates on its own).
                if (self._trajectory
                        and self._trajectory[-1]["type"] == "tune_idle"):
                    rec = self._trajectory[-1]
                    rec["windows"] = rec.get("windows", 1) + 1
                else:
                    rec = {"type": "tune_idle", "baseline": baseline,
                           "windows": 1}
                    self._trajectory.append(rec)
            return rec
        # Feed the optimizer the CURRENT point's fresh measurement too:
        # the GP needs an anchor at the incumbent or EI has nothing to
        # improve on. It also joins the freeze pool — when every move
        # regresses, the best point seen IS the incumbent.
        self._bo.add_sample(self._as_vector(current), baseline)
        with self._lock:
            self._measured.append((current, baseline))
        proposal_vec = self._bo.suggest()
        proposal = {b.name: tunable_snap(b.knob, v)
                    for b, v in zip(self.bindings, proposal_vec)}
        # Compare over the SEARCHED dims only: after a mid-search
        # live-unsafe prune, _values deliberately retains the pruned
        # knobs' restored entries for state() reporting, and a
        # whole-dict comparison would never match — the converged
        # search would burn a second measurement window every round.
        if proposal == {b.name: current.get(b.name, b.knob.default)
                        for b in self.bindings}:
            # Snapped onto the incumbent: nothing to A/B. Record the
            # sample and move on (counts toward freeze, so a converged
            # search terminates instead of spinning).
            with self._lock:
                self._samples.append((current, baseline))
                self._measured.append((current, baseline))
            rec = {"type": "tune_accept", "values": current,
                   "objective": baseline, "noise": sem,
                   "sample": n_samples + 1, "noop": True}
            self._record(rec)
            return rec
        guard = max(self.guard_pct / 100.0,
                    (2.0 * sem / baseline) if baseline > 0 else 0.0)
        threshold = baseline * (1.0 - guard)
        # Journal BEFORE the move is live (the PR 5 append-before-
        # publish discipline): a crash mid-guard-window leaves a
        # journal explaining exactly which knob state the process died
        # in. proposal is already snapped, so the record matches what
        # _apply_values pushes.
        self._record({"type": "tune_apply", "values": proposal,
                      "from": current, "baseline": baseline,
                      "noise": sem, "threshold": threshold,
                      "sample": n_samples + 1})
        flightrec.record("tune_apply", values=dict(proposal))
        applied = self._apply_values(proposal)
        post, _post_sem = self._measure_window()
        if self._stop.is_set():
            return None
        self._bo.add_sample(self._as_vector(applied), post)
        with self._lock:
            self._samples.append((applied, post))
            self._measured.append((applied, post))
        if post < threshold:
            # Guardrail: regression beyond the noise band — revert.
            # restore=True: a revert must land even for a live-unsafe
            # knob in a world that grew mid-search (see KnobBinding
            # .apply). For such a knob _apply_locked redirects the
            # restore to the binding's LAUNCH anchor, under the apply
            # lock: the incumbent passed here may itself be a
            # mid-search per-rank value adopted before the world
            # grew, and re-applying it would undo on_world_change's
            # uniform restore.
            restored = self._apply_values(current, restore=True)
            with self._lock:
                self._values.update(restored)
            rec = {"type": "tune_revert", "values": restored,
                   "applied": applied, "objective": post,
                   "threshold": threshold, "sample": n_samples + 1}
            self._record(rec)
            flightrec.record("tune_revert", values=dict(restored),
                             objective=post, threshold=threshold)
            _M_MOVES.labels(outcome="revert").inc()
        else:
            with self._lock:
                self._values.update(applied)
            rec = {"type": "tune_accept", "values": applied,
                   "objective": post, "noise": sem,
                   "sample": n_samples + 1}
            self._record(rec)
            _M_MOVES.labels(outcome="accept").inc()
        return rec

    def _freeze(self) -> dict:
        with self._lock:
            pool = list(self._measured) or list(self._samples)
            n_samples = len(self._samples)
        best_values, best_score = max(pool, key=lambda s: s[1])
        applied = self._apply_values(best_values)
        with self._lock:
            # Merge, not replace: values restored by a mid-search
            # live-unsafe prune must stay visible in state().
            self._values.update(applied)
            self._frozen = True
        rec = {"type": "tune_freeze", "values": applied,
               "objective": best_score, "samples": n_samples}
        self._record(rec)
        _G_FROZEN.set(1.0)
        return rec

    # --- lifecycle ----------------------------------------------------------

    def start(self, replay_only: bool = False):
        """Replay any journaled state, then (unless ``replay_only`` —
        the ``HVD_TUNE=cache`` mode) start the background search
        thread. Idempotent. The journal is attached FIRST so the
        replay's ``tune_replay`` record reaches disk — post-mortem
        forensics must be able to tell how many incarnations resumed
        tuned, not just the in-memory counter. The fold tolerates the
        freshly appended meta (a matching meta folds through; a
        fenced journal yields no state either way)."""
        if self._thread is not None:
            return
        self._attach_journal()
        self.replay()
        if replay_only:
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="hvd-online-tuner")
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                if self.step() is None:
                    return
            except Exception as e:  # analysis: allow-broad-except —
                # the tuner is an optimizer, not a dependency: a
                # transient metrics/apply failure must degrade to "no
                # move this round", never take the job down.
                logger.warning("online tuner round failed: %s", e)
                if self._wait(self.window_sec):
                    return

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self._journal is not None:
            self._journal.close()
            self._journal = None

    # --- introspection ------------------------------------------------------

    def state(self) -> dict:
        with self._lock:
            return {"values": dict(self._values),
                    "samples": len(self._samples),
                    "frozen": self._frozen,
                    "max_samples": self.max_samples}

    def trajectory(self) -> List[dict]:
        """Every decision record this incarnation produced (the same
        records the journal holds)."""
        with self._lock:
            return list(self._trajectory)


# --- process-global convenience ----------------------------------------------

_global_lock = threading.Lock()
_global_tuner: Optional[OnlineTuner] = None

# Default knob sets per role. Training searches the wire + negotiation
# surface (all live-safe, rank-divergence-free); non-live_safe knobs
# (grad buckets, flash tiles) are schema-declared but never searched
# live in a multi-rank world.
TRAINING_KNOBS = ("fusion_threshold_mb", "cycle_time_ms",
                  "ring_chunk_bytes", "socket_buf_bytes")
SERVE_KNOBS = ("serve_max_batch", "serve_deadline_ms")


def _journal_path_for(name: str) -> Optional[str]:
    d = os.environ.get("HVD_TUNE_JOURNAL_DIR", "")
    if not d:
        return None
    return os.path.join(d, "tuner_journal.%s.jsonl" % name)


def start_online_tuner(role: str = "training",
                       name: Optional[str] = None,
                       setters: Optional[Dict[str, Callable]] = None,
                       objective: Optional[Callable[[], float]] = None,
                       **kwargs) -> Optional[OnlineTuner]:
    """Start (or return) the process-wide tuner when ``HVD_TUNE`` asks
    for one; None when tuning is off. ``role`` picks the default knob
    set + objective ("training": wire bytes/sec over
    fusion/cycle/ring/socket knobs; "serve": requests/sec over the
    micro-batch knobs, whose ``setters`` the replica passes).
    ``HVD_TUNE_FREEZE`` names are dropped from the searched set.
    ``HVD_TUNE=cache`` replays the journal without searching."""
    global _global_tuner
    mode = tune_mode()
    if not mode:
        return None
    with _global_lock:
        if _global_tuner is not None:
            return _global_tuner
        names = TRAINING_KNOBS if role == "training" else SERVE_KNOBS
        frozen = set(frozen_knob_names())
        setters = setters or {}
        bindings = [KnobBinding(TUNABLE[n], setter=setters.get(n))
                    for n in names if n not in frozen]
        # The journal fence is pinned to this COMPOSED set, before any
        # live_safe drop: a journal written at size 1 (full set) must
        # still replay after a restart into a multi-rank world (and
        # vice versa) — only a real schema/freeze change re-fences.
        fence_knobs = [b.knob for b in bindings]
        # live_safe contract, runtime half: knobs whose per-rank
        # mutation makes ranks issue collectives of different sizes
        # (live_safe=False: grad buckets, flash tiles, planner
        # weights) must never be searched while this process shares a
        # world. This guards whatever was actually composed at
        # runtime, and degrades by dropping the knob, not the tuner.
        # (KnobBinding.apply refuses live-unsafe mutations too, covering
        # elastic worlds that GROW after start.)
        dropped_unsafe: List[str] = []
        if _shared_world():
            dropped_unsafe = sorted(
                b.name for b in bindings if not b.knob.live_safe)
            if dropped_unsafe:
                logger.warning(
                    "online tuner: dropping live-unsafe knob(s) %s in "
                    "a multi-rank world — per-rank search of "
                    "build-time knobs desyncs the collective sequence",
                    ", ".join(dropped_unsafe))
                bindings = [b for b in bindings if b.knob.live_safe]
        if not bindings:
            if dropped_unsafe:
                logger.warning(
                    "HVD_TUNE set but every remaining %s knob is "
                    "live-unsafe in this multi-rank world (%s) — "
                    "tuner not started", role,
                    ", ".join(dropped_unsafe))
            else:
                logger.warning(
                    "HVD_TUNE set but every %s knob is frozen "
                    "(HVD_TUNE_FREEZE) — tuner not started", role)
            return None
        if objective is None:
            objective = (wire_bytes_total if role == "training"
                         else serve_rows_total)
        if name is None:
            # Per-process journal files: concurrent ranks appending to
            # one file would interleave their decision streams.
            name = ("rank%s" % os.environ.get("HOROVOD_RANK", "0")
                    if role == "training" else role)
        tuner = OnlineTuner(bindings, objective,
                            journal_path=_journal_path_for(name),
                            fence_knobs=fence_knobs, **kwargs)
        tuner.start(replay_only=(mode == "cache"))
        _global_tuner = tuner
        return tuner


def online_tuner() -> Optional[OnlineTuner]:
    with _global_lock:
        return _global_tuner


def on_world_change() -> None:
    """Called by the elastic worker after a reinit changed the world
    (the only in-tree mechanism by which a process's world size moves
    mid-lifetime). A tuner that searched — or already FROZE at — a
    live-unsafe value while alone must restore it the moment the
    world is shared: the search thread exits at freeze, so the
    in-loop prune can never fire for the frozen case.

    Thread discipline: a LIVE search loop prunes itself at its next
    round top (within one round; KnobBinding.apply's refusal covers
    the gap), so this never swaps ``bindings`` under a concurrently
    built proposal — it only prunes inline once the search thread is
    no longer running. A frozen thread does no further waits, so the
    short join below is bounded. No-op without a tuner or live-unsafe
    bindings."""
    tuner = online_tuner()
    if tuner is None:
        return
    # Values restore FIRST, unconditionally (thread-safe by design):
    # whatever the search thread's state — live, frozen-and-exiting,
    # or wedged in an error backoff — the worker's reset callbacks run
    # after this reset and must see uniform values.
    tuner._restore_live_unsafe_values()
    t = tuner._thread
    if t is not None and t.is_alive():
        if not tuner.state()["frozen"]:
            return  # live search: its round-top prune drops bindings
        t.join(timeout=5)  # frozen: the loop is exiting, no sleeps left
        if t.is_alive():
            return  # did not exit in time; retry on the next reset
    tuner._prune_live_unsafe()


def stop_online_tuner():
    global _global_tuner
    with _global_lock:
        tuner, _global_tuner = _global_tuner, None
    if tuner is not None:
        tuner.stop()
