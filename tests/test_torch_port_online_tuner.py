"""The port's online tuner (``horovod_tpu_torch/utils/online_tuner.py``)
against the reference's (``horovod_tpu/utils/online_tuner.py``).

* The reference's tier-1 units (tests/test_online_tuner.py), on the
  port's module: the injected clock and synthetic objective (``Sim``), no
  thread and no sleep. Its batcher and replica cases wait for the port's
  serving replica (ROADMAP A13); its np=2 ``tier2`` case stays the
  reference's.
* Parity: the same ``Sim`` through both packages' tuners gives the same
  decision records and the same final state (convergence, the guardrail's
  reverts, the idle objective); a journal written by either package
  replays in the other; ``schema_fence`` is the reference's for both
  roles' knob sets.
* The port's own wiring: ``set_wire_params`` reaches the core at np=2
  (``hvd_ring_subchunk_steps_total`` follows ``ring_chunk_bytes``); the
  device plane adds 2(n-1)/n B to the wire families for an allreduce of B
  bytes at np=2 (and its figures for an allgather, a broadcast and an
  alltoall) and nothing at size 1 (tests/torch_port_tuner_worker.py, the
  plane attached on the CPU); ``elastic.run`` starts the tuner on entry
  and calls ``on_world_change`` after a failure's reinit.
"""

import json
import os
import threading

import pytest
import torch

from horovod_tpu.common.knobs import TUNABLE as REF_TUNABLE
from horovod_tpu.utils import online_tuner as ref_ot

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.exceptions import HorovodInternalError
from horovod_tpu_torch.common.knobs import TUNABLE, tunable_snap
from horovod_tpu_torch.runner.journal import DriverJournal
from horovod_tpu_torch.utils import metrics as _metrics
from horovod_tpu_torch.utils import online_tuner as ot
from torch_port_runs import start_runs

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_port_tuner_worker.py")

# Every apply() mirrors the value into the backing env knob, which a later
# test would read back as its starting point. Scrub the mirrors and the
# tuner's own knobs around every test.
_TUNER_ENVS = sorted({k.env for k in TUNABLE.values() if k.env} | {
    "HVD_TUNE", "HVD_TUNE_FREEZE", "HVD_TUNE_JOURNAL_DIR",
    "HVD_TUNE_WINDOW_SEC", "HVD_TUNE_GUARD_PCT"})


def _scrub():
    for n in _TUNER_ENVS:
        os.environ.pop(n, None)


@pytest.fixture(autouse=True)
def _clean_tuner_env():
    saved = {n: os.environ.pop(n) for n in _TUNER_ENVS if n in os.environ}
    yield
    ot.stop_online_tuner()
    _scrub()
    os.environ.update(saved)


class Sim:
    """Fake clock + synthetic objective: a monotone counter whose rate is
    a function of the current knob values, integrated over fake time by
    ``wait``: the tuner's injected clock/wait/objective triple. ``mod``
    is the tuner module whose bindings it makes."""

    def __init__(self, rate_fn, mod=ot):
        self.t = 0.0
        self.total = 0.0
        self.values = {}
        self._rate_fn = rate_fn
        self.mod = mod

    def rate(self):
        return self._rate_fn(self.values)

    def wait(self, seconds):
        self.total += self.rate() * seconds
        self.t += seconds
        return False

    def clock(self):
        return self.t

    def objective(self):
        return self.total

    def binding(self, name):
        self.values.setdefault(name, TUNABLE[name].default)
        return self.mod.KnobBinding(
            self.mod.TUNABLE[name],
            setter=lambda v, _n=name: self.values.__setitem__(_n, v))


def _peaked_rate(values):
    """Planted optimum: ring_chunk=4 MiB, socket_buf=2 MiB."""
    rc = values.get("ring_chunk_bytes", 0.0)
    sb = values.get("socket_buf_bytes", 0.0)
    return 1e6 * (1.0
                  - ((rc - (4 << 20)) / float(16 << 20)) ** 2
                  - ((sb - (2 << 20)) / float(16 << 20)) ** 2)


def _make_tuner(sim, names, journal_path=None, **kw):
    kw.setdefault("window_sec", 1.0)
    kw.setdefault("guard_pct", 5.0)
    kw.setdefault("max_samples", 12)
    return sim.mod.OnlineTuner([sim.binding(n) for n in names],
                               sim.objective, journal_path=journal_path,
                               clock=sim.clock, wait=sim.wait, **kw)


def _drive(tuner):
    records = []
    while True:
        rec = tuner.step()
        if rec is None:
            return records
        records.append(rec)


@pytest.fixture
def world(monkeypatch):
    """``is_shared_world`` of the port's basics as a settable size."""
    size = {"v": 1}
    monkeypatch.setattr(basics, "is_shared_world", lambda: size["v"] > 1)
    return size


# --- schema -----------------------------------------------------------------


def test_schema_covers_required_surface():
    required = {"fusion_threshold_mb", "cycle_time_ms",
                "ring_chunk_bytes", "socket_buf_bytes",
                "grad_bucket_bytes", "serve_max_batch",
                "serve_deadline_ms"}
    assert required <= set(TUNABLE)
    for knob in TUNABLE.values():
        assert knob.lo <= knob.hi
        assert knob.apply_path in ("native", "env", "setter")


def test_schema_rows_are_the_references():
    assert list(TUNABLE) == list(REF_TUNABLE)
    for name, knob in TUNABLE.items():
        assert tuple(knob) == tuple(REF_TUNABLE[name]), name


def test_schema_build_time_knobs_are_not_live_safe():
    """The bucket size is read when the bucketed optimizer is built: the
    schema must say so, and the default training set must exclude it."""
    assert not TUNABLE["grad_bucket_bytes"].live_safe
    assert not TUNABLE["flash_block_q"].live_safe
    for name in ot.TRAINING_KNOBS:
        assert TUNABLE[name].live_safe


def test_tunable_snap_clamps_and_grids():
    k = TUNABLE["ring_chunk_bytes"]
    assert tunable_snap(k, -5.0) == k.lo
    assert tunable_snap(k, 1e12) == k.hi
    v = tunable_snap(k, (1 << 20) + 1000.0)
    assert (v - k.lo) % k.step == 0


def test_env_mirror_and_fusion_byte_convention(monkeypatch):
    monkeypatch.delenv("HVD_RING_CHUNK_BYTES", raising=False)
    b = ot.KnobBinding(TUNABLE["ring_chunk_bytes"], setter=lambda v: None)
    b.apply(2 << 20)
    assert os.environ["HVD_RING_CHUNK_BYTES"] == str(2 << 20)
    # The 0-MB fusion endpoint means "unfused", spelled as a 1-byte
    # threshold downstream (<= 0 is "no update").
    fb = ot.KnobBinding(TUNABLE["fusion_threshold_mb"],
                        setter=lambda v: None)
    fb.apply(0.0)
    assert os.environ["HOROVOD_FUSION_THRESHOLD"] == "1"


def test_frozen_knob_names_ignores_unknown(monkeypatch):
    monkeypatch.setenv("HVD_TUNE_FREEZE", "ring_chunk_bytes, no_such_knob ,")
    assert ot.frozen_knob_names() == ["ring_chunk_bytes"]


def test_tune_mode_parsing(monkeypatch):
    for raw, want in [("", ""), ("0", ""), ("off", ""), ("false", ""),
                      ("1", "1"), ("yes", "1"), ("cache", "cache"),
                      ("CACHE", "cache")]:
        monkeypatch.setenv("HVD_TUNE", raw)
        assert ot.tune_mode() == want, raw


# --- the loop ---------------------------------------------------------------


def test_convergence_on_planted_optimum(tmp_path):
    """With a smooth objective peaked inside the box, the search lands
    within one grid neighbourhood of the planted optimum within
    max_samples windows and freezes there."""
    sim = Sim(_peaked_rate)
    tuner = _make_tuner(sim, ["ring_chunk_bytes", "socket_buf_bytes"],
                        journal_path=str(tmp_path / "j.jsonl"))
    tuner._attach_journal()
    tuner.replay()
    records = _drive(tuner)
    state = tuner.state()
    assert state["frozen"]
    assert state["samples"] == 12
    assert abs(state["values"]["ring_chunk_bytes"] - (4 << 20)) <= (1 << 20)
    assert abs(state["values"]["socket_buf_bytes"] - (2 << 20)) <= (1 << 20)
    assert any(r["type"] == "tune_freeze" for r in records)
    assert sim.values["ring_chunk_bytes"] == \
        state["values"]["ring_chunk_bytes"]


def test_guardrail_reverts_injected_regression(tmp_path):
    """An objective that collapses whenever the knob leaves its default
    makes every move regress: each is reverted and the knob ends where it
    started."""
    default = TUNABLE["ring_chunk_bytes"].default

    def cliff(values):
        return 1e6 if values.get("ring_chunk_bytes") == default else 1e3

    sim = Sim(cliff)
    tuner = _make_tuner(sim, ["ring_chunk_bytes"],
                        journal_path=str(tmp_path / "j.jsonl"),
                        max_samples=6)
    tuner._attach_journal()
    tuner.replay()
    records = _drive(tuner)
    reverts = [r for r in records if r["type"] == "tune_revert"]
    assert reverts, "no move was ever reverted"
    for r in reverts:
        assert r["values"]["ring_chunk_bytes"] == default
        assert r["applied"]["ring_chunk_bytes"] != default
        assert r["objective"] < r["threshold"]
    assert tuner.state()["values"]["ring_chunk_bytes"] == default
    assert sim.values["ring_chunk_bytes"] == default


def test_idle_objective_never_searches(tmp_path):
    """A zero objective (no traffic, as training at size 1 on the card)
    triggers no move; idle windows coalesce and are not journaled."""
    sim = Sim(lambda values: 0.0)
    jp = str(tmp_path / "j.jsonl")
    tuner = _make_tuner(sim, ["ring_chunk_bytes"], journal_path=jp,
                        max_samples=4)
    tuner._attach_journal()
    tuner.replay()
    for _ in range(3):
        rec = tuner.step()
        assert rec["type"] == "tune_idle"
    idles = [r for r in tuner.trajectory() if r["type"] == "tune_idle"]
    assert len(idles) == 1 and idles[0]["windows"] == 3
    assert tuner.state()["samples"] == 0
    assert not tuner.state()["frozen"]
    assert sim.values["ring_chunk_bytes"] == \
        TUNABLE["ring_chunk_bytes"].default
    types = {json.loads(line)["type"] for line in open(jp)}
    assert types == {"tune_meta"}


def test_guard_band_absorbs_noise_within_pct():
    """A post-apply rate inside the guard band is not a revert."""
    def wobble(values):
        return 1e6 * (0.98 if values.get("ring_chunk_bytes")
                      != TUNABLE["ring_chunk_bytes"].default else 1.0)

    sim = Sim(wobble)
    tuner = _make_tuner(sim, ["ring_chunk_bytes"], max_samples=4,
                        guard_pct=5.0)
    records = _drive(tuner)
    assert not any(r["type"] == "tune_revert" for r in records), records


# --- journal + replay -------------------------------------------------------


def test_journal_records_go_through_driver_journal(tmp_path):
    sim = Sim(_peaked_rate)
    jp = str(tmp_path / "tuner_journal.test.jsonl")
    tuner = _make_tuner(sim, ["ring_chunk_bytes"], journal_path=jp,
                        max_samples=4)
    tuner._attach_journal()
    tuner.replay()
    _drive(tuner)
    lines = [json.loads(line) for line in open(jp)]
    assert lines[0]["type"] == "tune_meta"
    assert lines[0]["tuner_version"] == ot.TUNER_VERSION
    types = {line["type"] for line in lines}
    assert "tune_apply" in types
    assert "tune_freeze" in types
    for i, rec in enumerate(lines):
        if rec["type"] in ("tune_accept", "tune_revert") \
                and not rec.get("noop"):
            assert "tune_apply" in [line["type"] for line in lines[:i]]


def test_replay_resumes_tuned_state_without_research(tmp_path):
    sim = Sim(_peaked_rate)
    jp = str(tmp_path / "j.jsonl")
    first = _make_tuner(sim, ["ring_chunk_bytes", "socket_buf_bytes"],
                        journal_path=jp)
    first._attach_journal()
    first.replay()
    _drive(first)
    tuned = first.state()["values"]
    before = _metrics.value("hvd_tune_replays_total") or 0.0

    sim2 = Sim(_peaked_rate)
    second = _make_tuner(sim2, ["ring_chunk_bytes", "socket_buf_bytes"],
                         journal_path=jp)
    assert second.replay() is True
    st = second.state()
    assert st["values"] == tuned
    assert st["frozen"]
    assert st["samples"] == 12
    assert sim2.values["ring_chunk_bytes"] == tuned["ring_chunk_bytes"]
    assert (_metrics.value("hvd_tune_replays_total") or 0.0) > before
    assert second.step() is None


def test_replay_survives_restart_meta_and_torn_tail(tmp_path):
    sim = Sim(_peaked_rate)
    jp = str(tmp_path / "j.jsonl")
    t1 = _make_tuner(sim, ["ring_chunk_bytes"], journal_path=jp,
                     max_samples=4)
    t1._attach_journal()
    t1.replay()
    _drive(t1)
    tuned = t1.state()["values"]
    fence = t1.fence
    j = DriverJournal(jp)
    j.append({"type": "tune_meta", "tuner_version": ot.TUNER_VERSION,
              "fence": fence})
    j.close()
    with open(jp, "a") as fh:  # analysis: allow-append — a torn tail
        fh.write('{"type": "tune_accept", "values": {"ring_chunk_')
    rep = ot.replay_journal(jp, fence)
    assert rep is not None
    assert rep.values == tuned
    assert rep.frozen


def test_stale_version_journal_is_fenced(tmp_path):
    sim = Sim(_peaked_rate)
    jp = str(tmp_path / "j.jsonl")
    t1 = _make_tuner(sim, ["ring_chunk_bytes"], journal_path=jp,
                     max_samples=4)
    t1._attach_journal()
    t1.replay()
    _drive(t1)
    t1.stop()

    raw = open(jp).read().splitlines()
    meta = json.loads(raw[0])
    meta["tuner_version"] = ot.TUNER_VERSION + 1
    with open(jp, "w") as fh:
        fh.write("\n".join([json.dumps(meta)] + raw[1:]) + "\n")
    sim2 = Sim(_peaked_rate)
    t2 = _make_tuner(sim2, ["ring_chunk_bytes"], journal_path=jp,
                     max_samples=4)
    assert t2.replay() is False
    assert t2.state()["samples"] == 0
    assert not t2.state()["frozen"]

    meta["tuner_version"] = ot.TUNER_VERSION
    with open(jp, "w") as fh:
        fh.write("\n".join([json.dumps(meta)] + raw[1:]) + "\n")
    t3 = _make_tuner(sim2, ["ring_chunk_bytes", "socket_buf_bytes"],
                     journal_path=jp, max_samples=4)
    assert t3.replay() is False


def test_cache_mode_replays_without_searching(tmp_path, monkeypatch):
    sim = Sim(_peaked_rate)
    jp = str(tmp_path / "tuner_journal.rank0.jsonl")
    t1 = _make_tuner(sim, list(ot.TRAINING_KNOBS), journal_path=jp,
                     max_samples=4)
    t1._attach_journal()
    t1.replay()
    _drive(t1)
    tuned = t1.state()["values"]
    t1.stop()

    monkeypatch.setenv("HVD_TUNE", "cache")
    monkeypatch.setenv("HVD_TUNE_JOURNAL_DIR", str(tmp_path))
    monkeypatch.setenv("HOROVOD_RANK", "0")
    ot.stop_online_tuner()
    tuner = ot.start_online_tuner(role="training")
    assert tuner is not None
    assert tuner._thread is None
    st = tuner.state()
    for name in ("ring_chunk_bytes", "socket_buf_bytes"):
        assert st["values"][name] == tuned[name]
    assert os.environ["HVD_RING_CHUNK_BYTES"] == \
        str(int(tuned["ring_chunk_bytes"]))
    jtypes = [json.loads(line)["type"] for line in open(jp)]
    assert "tune_replay" in jtypes


def test_start_online_tuner_off_and_all_frozen(monkeypatch):
    monkeypatch.delenv("HVD_TUNE", raising=False)
    ot.stop_online_tuner()
    assert ot.start_online_tuner() is None
    monkeypatch.setenv("HVD_TUNE", "1")
    monkeypatch.setenv("HVD_TUNE_FREEZE", ",".join(ot.TRAINING_KNOBS))
    assert ot.start_online_tuner(role="training") is None


def test_live_unsafe_knobs_dropped_in_multi_rank_world(monkeypatch, world):
    monkeypatch.setenv("HVD_TUNE", "cache")  # no search thread needed
    world["v"] = 2
    monkeypatch.setattr(ot, "TRAINING_KNOBS",
                        ("ring_chunk_bytes", "grad_bucket_bytes"))
    ot.stop_online_tuner()
    try:
        tuner = ot.start_online_tuner(role="training")
        assert {b.name for b in tuner.bindings} == {"ring_chunk_bytes"}
    finally:
        ot.stop_online_tuner()
    world["v"] = 1
    tuner = ot.start_online_tuner(role="training")
    assert {b.name for b in tuner.bindings} == \
        {"ring_chunk_bytes", "grad_bucket_bytes"}


# --- metrics ----------------------------------------------------------------


def test_tuner_metrics_families_move():
    w0 = _metrics.value("hvd_tune_windows_total") or 0.0
    sim = Sim(_peaked_rate)
    tuner = _make_tuner(sim, ["ring_chunk_bytes"], max_samples=3)
    _drive(tuner)
    assert (_metrics.value("hvd_tune_windows_total") or 0.0) > w0
    assert _metrics.value("hvd_tune_frozen") == 1.0
    assert _metrics.value("hvd_tune_objective") > 0


def test_full_loop_propose_apply_revert_journal_replay(tmp_path):
    def plateau_cliff(values):
        rc = values.get("ring_chunk_bytes", 0.0)
        return 1e6 if rc <= (8 << 20) else 1e4

    sim = Sim(plateau_cliff)
    jp = str(tmp_path / "j.jsonl")
    tuner = _make_tuner(sim, ["ring_chunk_bytes"], journal_path=jp,
                        max_samples=10)
    tuner._attach_journal()
    tuner.replay()
    records = _drive(tuner)
    types = [r["type"] for r in records]
    assert "tune_accept" in types, types
    assert "tune_revert" in types, types
    assert types[-1] == "tune_freeze"
    tuned = tuner.state()["values"]
    assert tuned["ring_chunk_bytes"] <= (8 << 20)
    tuner.stop()
    jtypes = {json.loads(line)["type"] for line in open(jp)}
    assert {"tune_meta", "tune_apply", "tune_accept", "tune_revert",
            "tune_freeze"} <= jtypes
    sim2 = Sim(plateau_cliff)
    restarted = _make_tuner(sim2, ["ring_chunk_bytes"], journal_path=jp,
                            max_samples=10)
    assert restarted.replay() is True
    assert restarted.state()["values"] == tuned
    assert restarted.step() is None
    assert sim2.values["ring_chunk_bytes"] == tuned["ring_chunk_bytes"]


# --- live-unsafe knobs in a world that grows --------------------------------


def test_live_unsafe_apply_refused_after_world_grows(monkeypatch, world):
    monkeypatch.delenv("HVD_GRAD_BUCKET_BYTES", raising=False)
    b = ot.KnobBinding(TUNABLE["grad_bucket_bytes"])
    assert b.apply(float(8 << 20)) == float(8 << 20)
    assert os.environ["HVD_GRAD_BUCKET_BYTES"] == str(8 << 20)
    world["v"] = 2
    assert b.apply(float(16 << 20)) == float(8 << 20)
    assert os.environ["HVD_GRAD_BUCKET_BYTES"] == str(8 << 20)
    # The guardrail's revert lands the launch anchor (unset: the mirror
    # is deleted, the default reported).
    assert b.apply(float(4 << 20), restore=True) == float(4 << 20)
    assert "HVD_GRAD_BUCKET_BYTES" not in os.environ
    monkeypatch.delenv("HVD_RING_CHUNK_BYTES", raising=False)
    safe = ot.KnobBinding(TUNABLE["ring_chunk_bytes"])
    assert safe.apply(float(2 << 20)) == float(2 << 20)


def test_live_unsafe_apply_gate_is_atomic_with_the_write(monkeypatch, world):
    monkeypatch.delenv("HVD_GRAD_BUCKET_BYTES", raising=False)
    b = ot.KnobBinding(TUNABLE["grad_bucket_bytes"])
    results = []
    t = threading.Thread(
        target=lambda: results.append(b.apply(float(16 << 20))))
    with ot._apply_lock:
        t.start()
        t.join(timeout=0.5)
        assert t.is_alive(), "apply must serialize on _apply_lock"
        world["v"] = 2  # the world grows while the apply is parked
    t.join(timeout=5)
    assert not t.is_alive()
    assert "HVD_GRAD_BUCKET_BYTES" not in os.environ
    assert results == [TUNABLE["grad_bucket_bytes"].default]


def test_shared_world_revert_clamps_to_launch_anchor(monkeypatch, world):
    monkeypatch.setenv("HVD_GRAD_BUCKET_BYTES", str(6 << 20))
    b = ot.KnobBinding(TUNABLE["grad_bucket_bytes"])  # launch = 6 MiB
    assert b.apply(float(16 << 20)) == float(16 << 20)
    world["v"] = 2
    assert b.apply(float(16 << 20), restore=True) == float(6 << 20)
    assert os.environ["HVD_GRAD_BUCKET_BYTES"] == str(6 << 20)
    world["v"] = 1
    assert b.apply(float(8 << 20), restore=True) == float(8 << 20)


def test_live_unsafe_binding_pruned_when_world_grows(world):
    sim = Sim(lambda v: 100.0)
    tuner = _make_tuner(sim, ["ring_chunk_bytes", "grad_bucket_bytes"],
                        max_samples=3)
    assert {b.name for b in tuner.bindings} == \
        {"ring_chunk_bytes", "grad_bucket_bytes"}
    assert tuner.step() is not None
    world["v"] = 2
    rec = tuner.step()
    assert {b.name for b in tuner.bindings} == {"ring_chunk_bytes"}
    assert rec is not None
    assert sim.values["grad_bucket_bytes"] == \
        TUNABLE["grad_bucket_bytes"].default
    assert tuner.state()["values"]["grad_bucket_bytes"] == \
        TUNABLE["grad_bucket_bytes"].default
    assert any(r["type"] == "tune_prune" and
               r["dropped"] == ["grad_bucket_bytes"]
               for r in tuner.trajectory())
    sim2 = Sim(lambda v: 100.0)
    t2 = _make_tuner(sim2, ["grad_bucket_bytes"], max_samples=3)
    assert t2.step() is None and t2.state()["frozen"]
    [frz] = [r for r in t2.trajectory() if r["type"] == "tune_freeze"]
    assert frz["pruned"] == ["grad_bucket_bytes"]
    assert t2.state()["values"] == frz["values"]


def test_pruned_knob_restores_job_env_value_not_schema_default(
        monkeypatch, world):
    monkeypatch.setenv("HVD_GRAD_BUCKET_BYTES", str(8 << 20))
    sim = Sim(lambda v: 100.0)
    tuner = _make_tuner(sim, ["ring_chunk_bytes", "grad_bucket_bytes"],
                        max_samples=3)
    assert tuner.state()["values"]["grad_bucket_bytes"] == float(8 << 20)
    [b] = [b for b in tuner.bindings if b.name == "grad_bucket_bytes"]
    b.apply(float(16 << 20))
    assert os.environ["HVD_GRAD_BUCKET_BYTES"] == str(16 << 20)
    world["v"] = 2
    assert tuner.step() is not None
    assert os.environ["HVD_GRAD_BUCKET_BYTES"] == str(8 << 20)


def test_journal_replays_across_live_safe_recomposition(tmp_path):
    jp = str(tmp_path / "tuner_journal.jsonl")
    sim = Sim(lambda v: 100.0)
    both = ["ring_chunk_bytes", "grad_bucket_bytes"]
    t1 = _make_tuner(sim, both, journal_path=jp, max_samples=2)
    t1._attach_journal()
    t1.replay()
    _drive(t1)
    tuned = t1.state()["values"]["ring_chunk_bytes"]
    t1.stop()
    sim2 = Sim(lambda v: 100.0)
    t2 = ot.OnlineTuner([sim2.binding("ring_chunk_bytes")],
                        sim2.objective, journal_path=jp,
                        clock=sim2.clock, wait=sim2.wait,
                        window_sec=1.0, max_samples=2,
                        fence_knobs=[TUNABLE[n] for n in both])
    t2._attach_journal()
    assert t2.replay() is True
    assert t2.state()["values"]["ring_chunk_bytes"] == tuned
    assert t2.state()["frozen"]
    t2.stop()


def test_frozen_live_unsafe_value_restored_on_world_change(monkeypatch,
                                                           world):
    monkeypatch.delenv("HVD_GRAD_BUCKET_BYTES", raising=False)
    sim = Sim(lambda v: 1.0 + v.get("grad_bucket_bytes", 0.0))
    tuner = _make_tuner(sim, ["grad_bucket_bytes"], max_samples=3)
    _drive(tuner)
    assert tuner.state()["frozen"]
    assert sim.values["grad_bucket_bytes"] != \
        TUNABLE["grad_bucket_bytes"].default
    world["v"] = 2
    monkeypatch.setattr(ot, "_global_tuner", tuner)
    ot.on_world_change()
    assert sim.values["grad_bucket_bytes"] == \
        TUNABLE["grad_bucket_bytes"].default
    assert tuner.state()["values"]["grad_bucket_bytes"] == \
        TUNABLE["grad_bucket_bytes"].default
    assert any(r["type"] == "tune_prune" for r in tuner.trajectory())
    n = len(tuner.trajectory())
    ot.on_world_change()
    assert len(tuner.trajectory()) == n
    monkeypatch.setattr(ot, "_global_tuner", None)
    assert ot.on_world_change() is None


def test_live_search_world_change_restores_values_inline(monkeypatch,
                                                        world):
    monkeypatch.delenv("HVD_GRAD_BUCKET_BYTES", raising=False)
    sim = Sim(lambda v: 100.0)
    tuner = _make_tuner(sim, ["ring_chunk_bytes", "grad_bucket_bytes"],
                        max_samples=3)
    [b] = [b for b in tuner.bindings if b.name == "grad_bucket_bytes"]
    b.apply(float(16 << 20))

    class _FakeThread:
        @staticmethod
        def is_alive():
            return True

    world["v"] = 2
    monkeypatch.setattr(ot, "_global_tuner", tuner)
    tuner._thread = _FakeThread()
    ot.on_world_change()
    assert sim.values["grad_bucket_bytes"] == \
        TUNABLE["grad_bucket_bytes"].default
    assert any(r["type"] == "tune_restore" for r in tuner.trajectory())
    assert {b.name for b in tuner.bindings} == \
        {"ring_chunk_bytes", "grad_bucket_bytes"}
    tuner._thread = None
    monkeypatch.setattr(ot, "_global_tuner", None)


def test_shared_world_restore_deletes_env_mirror_unset_at_launch(
        monkeypatch, world):
    monkeypatch.delenv("HVD_FLASH_BLOCK_Q", raising=False)
    b = ot.KnobBinding(TUNABLE["flash_block_q"])  # launch: unset
    assert b.apply(384.0) == 384.0
    assert os.environ["HVD_FLASH_BLOCK_Q"] == "384"
    world["v"] = 2
    assert b.apply(384.0, restore=True) == TUNABLE["flash_block_q"].default
    assert "HVD_FLASH_BLOCK_Q" not in os.environ
    monkeypatch.setenv("HVD_FLASH_BLOCK_K", "256")
    bk = ot.KnobBinding(TUNABLE["flash_block_k"])
    assert bk.apply(512.0, restore=True) == 256.0
    assert os.environ["HVD_FLASH_BLOCK_K"] == "256"


# --- parity with the reference ----------------------------------------------


def _cliff(values):
    return 1e6 if values.get("ring_chunk_bytes") == \
        TUNABLE["ring_chunk_bytes"].default else 1e3


_CASES = {
    "convergence": (_peaked_rate, ["ring_chunk_bytes", "socket_buf_bytes"],
                    12),
    "reverts": (_cliff, ["ring_chunk_bytes"], 6),
    "idle": (lambda values: 0.0, ["ring_chunk_bytes"], 4),
}


def _run_case(mod, case, journal_path):
    """One package's tuner on the case's Sim, from a scrubbed env."""
    rate, names, samples = _CASES[case]
    _scrub()
    sim = Sim(rate, mod)
    tuner = _make_tuner(sim, names, journal_path=journal_path,
                        max_samples=samples)
    tuner._attach_journal()
    tuner.replay()
    if case == "idle":
        records = [tuner.step() for _ in range(5)]
    else:
        records = _drive(tuner)
    tuner.stop()
    return records, tuner.trajectory(), tuner.state(), dict(sim.values)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_same_clock_same_decisions(tmp_path, case):
    ref = _run_case(ref_ot, case, str(tmp_path / "ref.jsonl"))
    got = _run_case(ot, case, str(tmp_path / "port.jsonl"))
    assert got == ref
    with open(tmp_path / "ref.jsonl") as a, open(tmp_path / "port.jsonl") \
            as b:
        assert b.read() == a.read()
    if case == "reverts":
        assert any(r["type"] == "tune_revert" for r in got[1])
    if case == "idle":
        assert [r["type"] for r in got[1]] == ["tune_idle"]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_journal_replays_in_the_other_package(tmp_path, writer):
    mods = (ref_ot, ot) if writer == "reference" else (ot, ref_ot)
    jp = str(tmp_path / "j.jsonl")
    records, _, state, _ = _run_case(mods[0], "convergence", jp)
    assert state["frozen"]
    _scrub()
    sim = Sim(_peaked_rate, mods[1])
    reader = _make_tuner(sim, _CASES["convergence"][1], journal_path=jp)
    assert reader.replay() is True
    assert reader.state() == state
    assert sim.values == state["values"]
    assert reader.step() is None


@pytest.mark.parametrize("role", ["TRAINING_KNOBS", "SERVE_KNOBS"])
def test_schema_fence_is_the_references(role):
    names = getattr(ot, role)
    assert names == getattr(ref_ot, role)
    assert ot.schema_fence([TUNABLE[n] for n in names]) == \
        ref_ot.schema_fence([REF_TUNABLE[n] for n in names])
    assert ot.schema_fence(list(TUNABLE.values())) == \
        ref_ot.schema_fence(list(REF_TUNABLE.values()))


# --- the port's wiring ------------------------------------------------------


@pytest.fixture(scope="module")
def np2(tmp_path_factory):
    return start_runs(WORKER, [(("tuner",), 2, [])],
                      tmp_path_factory.mktemp("tuner"), jax=False)


@pytest.mark.parametrize("rank", [0, 1])
def test_set_wire_params_reaches_the_core_np2(np2, rank):
    """``ring_chunk_bytes`` applied through the tuner's binding: the
    serial schedule takes no sub-chunk step, a 64 KiB chunk more than a
    1 MiB one, and the sums stay exact."""
    res = np2["tuner", ][rank]
    steps = list(res["steps"])
    assert list(res["chunks"]) == [0, 1 << 20, 64 << 10]
    assert steps == list(res["native_steps"])
    assert steps[0] == 0 and 0 < steps[1] < steps[2], steps
    assert all(res["exact"])


@pytest.mark.parametrize("rank", [0, 1])
def test_plane_counts_ring_bytes_np2(np2, rank):
    """2(n-1)/n B each way at n = 2: the payload, once out and once in."""
    res = np2["tuner", ][rank]
    assert list(res["one"]) == [float(res["one_bytes"])] * 2
    assert list(res["fused"]) == [float(res["fused_bytes"])] * 2
    # An allgather's (n-1)/n of the gathered bytes, a broadcast's payload,
    # an alltoall's half that goes to (and comes from) the other member.
    assert list(res["gathered"]) == [float(res["gathered_bytes"]) / 2] * 2
    assert list(res["cast"]) == [float(res["one_bytes"])] * 2
    assert list(res["swapped"]) == [float(res["swapped_bytes"]) / 2] * 2
    assert int(res["plane_responses"]) >= 5


def test_plane_counts_nothing_at_size_one(monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import device_plane

    for name in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_TIMELINE",
                 "HVD_METRICS_PORT"):
        monkeypatch.delenv(name, raising=False)
    hvd.init(device="cpu")
    try:
        core = basics.core_session()
        device_plane.attach(core, torch.device("cpu"), 1)
        before = [ot.wire_bytes_total(), core.plane.responses]
        x = torch.ones(1 << 16)
        assert torch.equal(hvd.allreduce(x, name="tune.size1"), x)
        hvd.grouped_allreduce([x, x[:5]], name="tune.size1.g")
        assert core.plane.responses > before[1]
        assert ot.wire_bytes_total() == before[0]
    finally:
        hvd.shutdown()


class _State:
    """The elastic state's protocol, recording its calls."""

    def __init__(self, events):
        self.events = events
        self._known_version = 0

    def sync(self):
        self.events.append("sync")

    def restore(self):
        self.events.append("restore")

    def on_reset(self):
        self.events.append("on_reset")


def _run_elastic(monkeypatch, world_change):
    from horovod_tpu_torch.elastic import worker

    events = []
    monkeypatch.setattr(ot, "start_online_tuner",
                        lambda role="training", **kw:
                        events.append("start_online_tuner:" + role))
    monkeypatch.setattr(ot, "on_world_change", world_change(events))
    monkeypatch.setattr(worker, "reinit_for_version",
                        lambda v: events.append("reinit:%d" % v) or v)
    calls = []

    @worker.run
    def train(state):
        calls.append(len(calls))
        events.append("train")
        if len(calls) == 1:
            raise HorovodInternalError("injected: a peer is gone")
        return "done"

    assert train(_State(events)) == "done"
    return events


def test_elastic_run_starts_the_tuner_and_calls_it_after_reinit(
        monkeypatch):
    def world_change(events):
        return lambda: events.append("on_world_change")

    events = _run_elastic(monkeypatch, world_change)
    assert events == ["start_online_tuner:training", "sync", "train",
                      "restore", "reinit:1", "on_world_change", "on_reset",
                      "sync", "train"]


def test_elastic_run_survives_a_failing_world_change_hook(monkeypatch,
                                                          capsys):
    def world_change(events):
        def fail():
            events.append("on_world_change")
            raise OSError("journal fsync failed")
        return fail

    events = _run_elastic(monkeypatch, world_change)
    assert events[-4:] == ["on_world_change", "on_reset", "sync", "train"]
    assert "tuner world-change hook failed" in capsys.readouterr().err


def test_elastic_run_starts_the_real_tuner(monkeypatch, tmp_path):
    """Under HVD_TUNE=cache, the wrapper's hook starts the library's
    tuner, which replays its journal."""
    from horovod_tpu_torch.elastic import worker

    jp = str(tmp_path / "tuner_journal.rank0.jsonl")
    # The cache-mode tuner composes the whole training set: journal it.
    sim = Sim(_peaked_rate)
    t1 = _make_tuner(sim, list(ot.TRAINING_KNOBS), journal_path=jp,
                     max_samples=3)
    t1._attach_journal()
    t1.replay()
    _drive(t1)
    t1.stop()
    monkeypatch.setenv("HVD_TUNE", "cache")
    monkeypatch.setenv("HVD_TUNE_JOURNAL_DIR", str(tmp_path))
    monkeypatch.setenv("HOROVOD_RANK", "0")
    replays = _metrics.value("hvd_tune_replays_total") or 0.0
    seen = []

    @worker.run
    def train(state):
        seen.append(ot.online_tuner())

    train(_State([]))
    assert seen[0] is not None and seen[0] is ot.online_tuner()
    assert seen[0].state()["frozen"]
    assert seen[0].state()["values"]["ring_chunk_bytes"] == \
        t1.state()["values"]["ring_chunk_bytes"]
    assert (_metrics.value("hvd_tune_replays_total") or 0.0) == replays + 1
