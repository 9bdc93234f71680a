"""Elastic recovery over NCCL on four cards.

tests/torch_port_elastic_cards_driver.py is the elastic driver (a local
KV store; the JAX package's driver needs jax, which the cards' machine
does not have). Four ranks train on four cards; rank 3 exits at step 5.
The survivors' collectives hang on NCCL until the native core sees the
peer gone, and the failure watch (``horovod_tpu_torch/common/failure.py``)
aborts the communicators: each survivor must raise
``HorovodInternalError`` within ``DETECT_LIMIT_SEC`` of the exit, restore
its last commit and reform at size 3. The world then grows back to 4: a
fresh rank 3 syncs from rank 0. All four end at step 16 with equal
weights. The detection seconds are printed (run with ``-s``)::

    python3 -m pytest tests/test_torch_port_elastic_cards.py -m cuda -q -s

``python tests/torch_port_elastic_cards_driver.py cpu`` rehearses the
flow on gloo.
"""

import json
import os

import pytest
import torch

import torch_port_elastic_cards_driver as driver

# The core gives a peer whose connection reset up after the reconnect
# budget the driver sets (HVD_WIRE_RECONNECT_SEC=2); the watch polls every
# 0.05 s, and the abort and the host's return take the rest.
DETECT_LIMIT_SEC = 10.0


@pytest.mark.cuda
def test_nccl_failure_recovery_and_growth_across_four_cards(tmp_path):
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < driver.SIZE:
        pytest.skip("needs four CUDA cards: elastic recovery over NCCL")
    # The ceiling bounds each stage of the driver; the test runs ~80 s.
    # analysis: tier1-ok(skips without four cards)
    codes, records, outputs = driver.drive("cuda", str(tmp_path),
                                           timeout=600)

    def tail(key):
        with open(outputs[key]) as f:
            return f.read()[-3000:]

    dead = ("localhost:3", 0)
    assert codes[dead] == 17, tail(dead)
    for key, code in codes.items():
        if key != dead:
            assert code == 0, "%s: %s" % (key, tail(key))
    exit_t = [r["t"] for r in records if r.get("event") == "exit"]
    restores = {r["rank"]: r["t"] for r in records
                if r.get("event") == "restore"}
    assert len(exit_t) == 1 and sorted(restores) == [0, 1, 2], records
    detect = {rank: t - exit_t[0] for rank, t in restores.items()}
    print("elastic cards: survivors raised HorovodInternalError %s s "
          "after rank 3's exit (limit %.1f s); %s"
          % (json.dumps({r: round(s, 3) for r, s in detect.items()}),
             DETECT_LIMIT_SEC, torch.cuda.get_device_name(0)))
    assert all(0 < s < DETECT_LIMIT_SEC for s in detect.values()), detect
    steps = [r for r in records if "step" in r and "event" not in r]
    assert {r["size"] for r in steps} == {3, 4}, steps
    assert {r["rank"] for r in steps if r["size"] == 3} == {0, 1, 2}
    finals = [r for r in records if r.get("final")]
    assert sorted(r["rank"] for r in finals) == [0, 1, 2, 3]
    assert all(r["equal"] for r in finals)
    assert len({r["checksum"] for r in finals}) == 1
    assert max(r["step"] for r in steps) == driver.STEPS
    assert os.path.exists(tmp_path / "fail_marker")
