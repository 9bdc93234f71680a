"""Fault injection with card tensors, over NCCL, on 2 and 4 cards.

The injector (``HVD_FAULT_*``, ``common/fault_injection.py``) sabotages the
core's TCP connections, which on the card carry only the negotiation:
NCCL moves the payload (``core/device_plane.py``). Through
tests/torch_port_fault_worker.py, each rank on the card of its local
rank, with ``HOROVOD_COMM_TIMEOUT_SEC=3``:

* ``drop``, ``stall`` and ``half_close`` on rank 1 stop the survivors'
  cores; the failure watch (``common/failure.py``) aborts the NCCL groups,
  and each survivor raises ``HorovodInternalError`` (or its subclass)
  within twice the deadline plus a margin. The detection seconds are
  printed with the card's name and power limit (run with ``-s``);
* ``reset`` heals the TCP link in place and leaves NCCL alone: every card
  result equals the fault-free run's bit for bit, and no abort is counted;
* a broadcast of a card tensor whose root is outside its set raises, and
  the next collectives run (ROADMAP C8);
* the elastic drill under ``HVD_TUNE=1`` (``drive_elastic``): the
  survivors' reset runs ``on_world_change``, they finish with equal
  weights, no live-unsafe knob differs across ranks, and the tuner
  measured card traffic (the plane's NCCL bytes in the wire families).

Skips without two cards::

    python3 -m pytest tests/test_torch_port_fault_cards.py -m cuda -q -s
"""

import json
import subprocess

import pytest
import torch

from horovod_tpu_torch.common.fault_injection import fault_env
from torch_port_fault_worker import (
    DEADLINE,
    ELASTIC_STEPS,
    WINDOW,
    drive_elastic,
    fired_at,
    run_job,
)

SIZES = [2, 4]


def _cards():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _need(size):
    if _cards() < size:
        pytest.skip("needs %d CUDA cards: NCCL under the injector" % size)


def _card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


@pytest.mark.cuda
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("mode", ["drop", "stall", "half_close"])
def test_card_tensors_raise_after_the_watch_aborts_nccl(mode, size):
    _need(size)
    out = run_job("typed", size, fault_env(1, mode, after_frames=300),
                  device="cuda", hangs=(1,) if mode == "stall" else ())
    fault = fired_at(out[1][2])
    assert fault is not None, out[1][2]
    detect = {}
    for r in range(size):
        if r == 1:
            continue
        code, rec, text = out[r]
        assert code == 0 and rec is not None, "rank %d:\n%s" % (r, text)
        assert rec["error"] in ("HorovodInternalError",
                                "HorovodAbortedError"), rec
        detect[r] = round(rec["raised_at"] - fault, 3)
        assert 0 <= detect[r] < WINDOW, (detect, rec)
    print("fault cards: %s on rank 1 of %d: survivors raised %s s after "
          "the injector fired (deadline %.0f s, window %.0f s); %s"
          % (mode, size, json.dumps(detect), DEADLINE, WINDOW,
             _card_line()))


@pytest.mark.cuda
@pytest.mark.parametrize("size", SIZES)
def test_reset_leaves_card_results_bit_equal(size):
    _need(size)
    clean = run_job("heal", size, device="cuda")
    faulted = run_job("heal", size, fault_env(1, "reset", after_frames=300),
                      device="cuda")
    for out in (clean, faulted):
        for r in range(size):
            code, rec, text = out[r]
            assert code == 0 and rec is not None, "rank %d:\n%s" % (r, text)
    assert [faulted[r][1]["digest"] for r in range(size)] == \
        [clean[r][1]["digest"] for r in range(size)]
    recs = [faulted[r][1] for r in range(size)]
    assert all(r["aborts"] == 0 for r in recs), recs
    assert recs[1]["reconnects"] >= 1, recs
    print("fault cards: reset on rank 1 of %d healed, reconnects %s; %s"
          % (size, [r["reconnects"] for r in recs], _card_line()))


@pytest.mark.cuda
def test_card_broadcast_root_outside_the_set_raises():
    _need(2)
    out = run_job("c8", 2, device="cuda")
    for r in (0, 1):
        code, rec, text = out[r]
        assert code == 0 and rec is not None, "rank %d:\n%s" % (r, text)
        assert rec["seconds"] < 10, rec
    assert set(out[0][1]["raised"]) == {"set", "global"}


@pytest.mark.cuda
@pytest.mark.parametrize("size", SIZES)
def test_elastic_drill_on_cards_under_the_tuner(size, tmp_path):
    _need(size)
    codes, records, outputs = drive_elastic("cuda", size, str(tmp_path))
    assert set(codes.values()) == {0}, {
        s: open(p).read()[-2000:] for s, p in outputs.items()}
    survivors = sorted(s for s in codes if s != "localhost:1")
    fault = fired_at(open(outputs["localhost:1"]).read())
    assert fault is not None
    # The fault landed in training at full size.
    assert any(r.get("size") == size and r["t"] < fault for r in records
               if "step" in r)
    restore = {r["slot"]: round(r["t"] - fault, 3) for r in records
               if r.get("event") == "restore" and r["slot"] in survivors}
    assert sorted(restore) == survivors
    assert all(0 <= t < WINDOW for t in restore.values()), restore
    changes = [r for r in records if r.get("event") == "world_change"]
    assert sorted(r["slot"] for r in changes) == survivors
    assert all(r["size"] == size - 1 for r in changes)
    finals = [r for r in records if r.get("final")]
    assert sorted(r["slot"] for r in finals) == survivors
    assert len({json.dumps(r["unsafe"], sort_keys=True)
                for r in finals}) == 1
    assert len({r["weights"] for r in finals}) == 1
    assert len({r["steps"] for r in finals}) == 1
    assert all(sum(1 for r in records if r["slot"] == slot and
                   r.get("size") == size - 1 and "step" in r and
                   "event" not in r) == ELASTIC_STEPS
               for slot in survivors)
    assert all(r["tuner"] is not None for r in finals)
    print("fault cards: elastic drill on %d cards: survivors restored %s s "
          "after the injector fired; decisions %s; last objective %s "
          "bytes/s; plane bytes sent %s; %s"
          % (size, json.dumps(restore), [r["decisions"] for r in finals],
             [r["objective"] for r in finals],
             [r["plane_tx"] for r in finals], _card_line()))
    # The plane's NCCL bytes reach the wire families, and so the tuner's
    # objective (above one survivor, also after the reset).
    assert all(r["plane_tx"] > 0 for r in finals), finals
    if size > 2:
        assert all(r["objective"] > 0 for r in finals), finals
