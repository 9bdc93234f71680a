"""Fault injection on the port's core, and a broadcast whose root is
outside its set (ROADMAP A16, C8).

* ``horovod_tpu_torch.common.fault_injection`` builds, clears and reads
  the injector's environment exactly as the reference's
  ``horovod_tpu/common/fault_injection.py`` does, validation errors
  included;
* the port's core under the injector, host tensors on the CPU
  (tests/torch_port_fault_worker.py, in the style of the reference's
  tests/chaos_worker.py), with ``HOROVOD_COMM_TIMEOUT_SEC=3``: ``drop``,
  ``stall`` and ``half_close`` on rank 1 at np=2 make the survivor raise
  ``HorovodAbortedError`` within twice the deadline plus a margin;
  ``reset`` inside a pipelined ring transfer at np=3 and a
  ``reconnect_storm`` at np=2 heal in place, bit for bit with the
  fault-free run, with reconnects on every rank and no abort;
* the elastic drill at np=3 under ``HVD_TUNE=1``: ``drop`` on rank 1; the
  survivors restore, reform at size 2 through ``elastic.run``, whose
  reset runs ``on_world_change``, and finish with equal weights and equal
  live-unsafe knobs;
* C8: ``broadcast`` with a root outside its set raises at size 1 and at
  np=2 (the set [0] with root 1, the global set with root 2), and the same
  core then serves the next collectives.

Every rank is a subprocess with its own ``communicate(timeout=...)``; a
victim left wedged is killed in ``finally``.
"""

import json
import os
import time

import pytest
import torch

from horovod_tpu.common import fault_injection as ref_fi

from horovod_tpu_torch.common import fault_injection as port_fi
from torch_port_fault_worker import (
    DEADLINE,
    ELASTIC_STEPS,
    RUN_TIMEOUT,
    WINDOW,
    drive_elastic,
    fired_at,
    run_job,
)


# --- the shim --------------------------------------------------------------


_ARGS = [
    dict(),
    dict(peer=0, after_frames=7),
    dict(delay_ms=25),
    dict(after_subchunks=30),
    dict(after_frames=200, every_frames=400, count=3),
]


@pytest.mark.parametrize("mode", ref_fi.MODES)
@pytest.mark.parametrize("kw", _ARGS, ids=range(len(_ARGS)))
def test_fault_env_is_the_references(mode, kw):
    want = ref_fi.fault_env(1, mode, **kw)
    got = port_fi.fault_env(1, mode, **kw)
    assert got == want
    assert sorted(got) == sorted(port_fi.FAULT_ENV_KEYS)
    for env in (dict(got), dict(got, HVD_FAULT_MODE="bogus"),
                {"HVD_FAULT_MODE": mode}, {}):
        for rank in (None, 0, 1):
            assert port_fi.is_armed(env, rank) == ref_fi.is_armed(env, rank)
    port_env, ref_env = dict(got, OTHER="1"), dict(want, OTHER="1")
    port_fi.clear_fault_env(port_env)
    ref_fi.clear_fault_env(ref_env)
    assert port_env == ref_env == {"OTHER": "1"}


@pytest.mark.parametrize("args,kw", [
    ((0, "bogus"), {}),
    ((-1, "drop"), {}),
    ((0, "drop"), dict(after_frames=-1)),
    ((0, "delay"), dict(delay_ms=-5)),
    ((0, "reset"), dict(after_subchunks=-2)),
    ((0, "reconnect_storm"), dict(every_frames=0)),
    ((0, "reconnect_storm"), dict(count=-1)),
])
def test_fault_env_rejects_what_the_reference_rejects(args, kw):
    with pytest.raises(ValueError) as ref:
        ref_fi.fault_env(*args, **kw)
    with pytest.raises(ValueError) as port:
        port_fi.fault_env(*args, **kw)
    assert str(port.value) == str(ref.value)


def test_os_environ_is_the_default(monkeypatch):
    for key in port_fi.FAULT_ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    assert not port_fi.is_armed()
    for key, value in port_fi.fault_env(2, "stall").items():
        monkeypatch.setenv(key, value)
    assert port_fi.is_armed() and port_fi.is_armed(rank=2)
    assert not port_fi.is_armed(rank=1)
    port_fi.clear_fault_env()
    assert not any(key in os.environ for key in port_fi.FAULT_ENV_KEYS)


# --- the port's core under the injector ------------------------------------


def _typed(out, ranks, error="HorovodAbortedError"):
    """Each of ``ranks`` raised ``error`` within the window of the moment
    the injector fired on rank 1; returns their detection seconds."""
    fault = fired_at(out[1][2])
    assert fault is not None, out[1][2]
    detect = {}
    for r in ranks:
        code, rec, text = out[r]
        assert code == 0 and rec is not None, "rank %d:\n%s" % (r, text)
        assert rec["error"] == error, rec
        detect[r] = rec["raised_at"] - fault
        assert 0 <= detect[r] < WINDOW, (detect, rec)
    return detect


def test_drop_makes_the_survivor_raise_the_typed_error():
    out = run_job("typed", 2, port_fi.fault_env(1, "drop",
                                                 after_frames=100))
    _typed(out, (0, 1))


def test_stall_makes_the_survivor_raise_after_the_deadline():
    out = run_job("typed", 2, port_fi.fault_env(1, "stall",
                                                 after_frames=100),
                  hangs=(1,))
    detect = _typed(out, (0,))
    # Only the progress deadline can see a parked peer.
    assert out[0][1]["comm_timeouts"] >= 1, out[0][1]
    assert detect[0] >= DEADLINE * 0.5, detect


def test_half_close_makes_every_rank_raise_the_typed_error():
    out = run_job("typed", 2, port_fi.fault_env(1, "half_close",
                                                 after_frames=100))
    _typed(out, (0, 1))


def _digests(out, size):
    for r in range(size):
        code, rec, text = out[r]
        assert code == 0 and rec is not None, "rank %d:\n%s" % (r, text)
    return [out[r][1]["digest"] for r in range(size)]


@pytest.fixture(scope="module")
def fault_free():
    """The heal runs' fault-free digests, by size."""
    env = {"HVD_RING_CHUNK_BYTES": "262144"}
    return {size: _digests(run_job("heal", size, env), size)
            for size in (2, 3)}


def test_reset_mid_transfer_heals_in_place_np3(fault_free):
    out = run_job("heal", 3, dict(port_fi.fault_env(2, "reset",
                                                    after_subchunks=30),
                                  HVD_RING_CHUNK_BYTES="262144"))
    assert _digests(out, 3) == fault_free[3]
    recs = [out[r][1] for r in range(3)]
    assert all(r["reconnects"] >= 1 and r["aborts"] == 0 and
               r["reconnect_failures"] == 0 for r in recs), recs
    assert recs[2]["reconnects"] >= 2, recs  # the victim heals both links


def test_reconnect_storm_heals_repeatedly(fault_free):
    out = run_job("heal", 2, dict(port_fi.fault_env(
        1, "reconnect_storm", after_frames=200, every_frames=400, count=3),
        HVD_RING_CHUNK_BYTES="262144"))
    assert _digests(out, 2) == fault_free[2]
    recs = [out[r][1] for r in range(2)]
    assert all(r["reconnects"] >= 2 and r["aborts"] == 0 for r in recs), \
        recs


# --- C8 ----------------------------------------------------------------------


def test_broadcast_root_outside_the_set_raises_at_size_one(monkeypatch):
    import horovod_tpu_torch as hvd

    for name in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_TIMELINE",
                 "HVD_METRICS_PORT"):
        monkeypatch.delenv(name, raising=False)
    hvd.init(device="cpu")
    try:
        x = torch.arange(6, dtype=torch.float32)
        t0 = time.monotonic()
        with pytest.raises(hvd.HorovodInternalError,
                           match="root rank 1 is not a member"):
            hvd.broadcast(x, 1, name="c8.size1")
        handle = hvd.broadcast_async(x, 3, name="c8.size1.async")
        with pytest.raises(hvd.HorovodInternalError, match="root rank 3"):
            hvd.synchronize(handle)
        assert time.monotonic() - t0 < 10
        assert torch.equal(hvd.broadcast(x, 0, name="c8.size1.ok"), x)
        assert torch.equal(hvd.allreduce(x, name="c8.size1.next"), x)
        assert basics_running()
    finally:
        hvd.shutdown()


def basics_running():
    from horovod_tpu_torch.common import basics

    return basics.core_session().running()


def test_broadcast_root_outside_the_set_raises_at_np2():
    out = run_job("c8", 2)
    for r in (0, 1):
        code, rec, text = out[r]
        assert code == 0 and rec is not None, "rank %d:\n%s" % (r, text)
        assert rec["aborts"] == 0, rec
    assert set(out[0][1]["raised"]) == {"set", "global"}
    assert set(out[1][1]["raised"]) == {"global"}
    assert "not a member of process set" in out[0][1]["raised"]["set"]


# --- the elastic drill ------------------------------------------------------


def test_elastic_drill_resets_the_world_and_the_tuner_follows(tmp_path):
    codes, records, outputs = drive_elastic("cpu", 3, str(tmp_path),
                                            timeout=RUN_TIMEOUT)
    assert set(codes.values()) == {0}, {
        s: open(p).read()[-2000:] for s, p in outputs.items()}
    survivors = ("localhost:0", "localhost:2")
    restores = {r["slot"] for r in records if r.get("event") == "restore"}
    assert set(survivors) <= restores, records
    # The fault landed in training at full size, and was seen in time.
    fault = fired_at(open(outputs["localhost:1"]).read())
    assert fault is not None
    assert any(r.get("size") == 3 and r["t"] < fault for r in records
               if "step" in r)
    assert all(0 <= r["t"] - fault < WINDOW for r in records
               if r.get("event") == "restore" and r["slot"] in survivors)
    changes = [r for r in records if r.get("event") == "world_change"]
    assert sorted(r["slot"] for r in changes) == list(survivors)
    assert all(r["size"] == 2 for r in changes)
    finals = [r for r in records if r.get("final")]
    assert sorted(r["slot"] for r in finals) == list(survivors)
    assert len({json.dumps(r["unsafe"], sort_keys=True)
                for r in finals}) == 1
    assert len({r["weights"] for r in finals}) == 1
    for slot in survivors:
        steps = [r["step"] for r in records if r["slot"] == slot and
                 r.get("size") == 2 and "step" in r and "event" not in r]
        assert len(steps) == ELASTIC_STEPS, (slot, steps)
    assert len({r["steps"] for r in finals}) == 1
    # The tuner ran through the reset and measured the host ring.
    assert all(r["tuner"] is not None and r["windows"] > 0
               for r in finals), finals
