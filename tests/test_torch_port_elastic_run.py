"""A port worker under the JAX package's elastic driver, on the CPU.

tests/torch_port_elastic_worker.py (torch and horovod_tpu_torch only, on
gloo) runs under ``python -m horovod_tpu.runner --min-np/--max-np
--host-discovery-script``, as tests/test_elastic.py:44-61 runs the JAX
worker: through a rank's death, a world that grows, and a cold restart
from the checkpoint directory. The driver publishes ``controller_port:
0``, so every world's rendezvous port is negotiated by its rank 0. Each
case ends with every rank's weights equal (the worker checks them by an
allgather and logs a checksum).
"""

import json
import os
import re
import stat
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "tests", "torch_port_elastic_worker.py")


def _discovery(tmp_path, before, after=None, trigger=None):
    """A discovery script printing ``before``, or ``after`` once
    ``trigger`` exists (a step-anchored change, not a wall-clock one)."""
    script = tmp_path / "discover.sh"
    if trigger is None:
        body = 'echo "%s"\n' % before
    else:
        body = ('if [ -f "%s" ]; then echo "%s"; else echo "%s"; fi\n'
                % (trigger, after, before))
    script.write_text("#!/bin/sh\n" + body)
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


def _run(tmp_path, discovery, min_np, max_np, extra_env, timeout,
         logs="logs"):
    log_dir = tmp_path / logs
    log_dir.mkdir(exist_ok=True)
    # One intra-op thread per worker: three workers of a tiny model share
    # the machine with the rest of the suite.
    env = dict(os.environ, JAX_PLATFORMS="cpu", ELASTIC_LOG_DIR=str(log_dir),
               OMP_NUM_THREADS="1", **extra_env)
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu.runner",
         "--min-np", str(min_np), "--max-np", str(max_np),
         "--host-discovery-script", discovery, sys.executable, _WORKER],
        cwd=_REPO, env=env, capture_output=True, text=True, timeout=timeout)
    records = []
    for name in os.listdir(log_dir):
        if name.startswith("slot_") and name.endswith(".log"):
            with open(log_dir / name) as f:
                records += [json.loads(line) for line in f]
    return proc, records


def _steps(records):
    return [r for r in records if not r.get("final")]


def _finals(records):
    return [r for r in records if r.get("final")]


def _assert_equal_weights(records, size):
    finals = _finals(records)
    assert sorted(r["rank"] for r in finals) == list(range(size)), finals
    assert len({r["checksum"] for r in finals}) == 1, finals


def test_port_worker_recovers_from_a_rank_failure(tmp_path):
    """Rank 1 exits at step 5 of 10: the survivors' collectives raise
    ``HorovodInternalError``, they restore the last commit and rejoin at
    the next version with the respawned slot; size 3 throughout."""
    proc, records = _run(
        tmp_path, _discovery(tmp_path, "localhost:3"), 3, 3,
        # A survivor idle in the core when the peer's connection resets
        # gives it up after the reconnect budget (default 30 s).
        {"ELASTIC_TOTAL_STEPS": "10", "ELASTIC_FAIL_RANK": "1",
         "ELASTIC_FAIL_STEP": "5", "HVD_WIRE_RECONNECT_SEC": "2"},
        timeout=150)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert os.path.exists(tmp_path / "logs" / "fail_marker")
    assert "exited with code 17" in proc.stderr
    steps = _steps(records)
    assert {r["size"] for r in steps} == {3}
    assert max(r["step"] for r in steps) == 10
    # Step 6 was run again after the restore, by every rank.
    assert sorted(r["rank"] for r in steps if r["step"] == 6) == [0, 1, 2]
    _assert_equal_weights(records, 3)


def test_port_worker_world_grows(tmp_path):
    """Two slots become three once rank 0 has committed step 4: the
    survivors take a graceful reset at a commit, the new rank syncs from
    rank 0, and the run ends at size 3."""
    trigger = str(tmp_path / "grow")
    proc, records = _run(
        tmp_path, _discovery(tmp_path, "localhost:2", "localhost:3",
                             trigger), 2, 4,
        {"ELASTIC_TOTAL_STEPS": "10", "ELASTIC_TRIGGER_FILE": trigger,
         "ELASTIC_TRIGGER_STEP": "4"}, timeout=150)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    steps = _steps(records)
    assert {r["size"] for r in steps} == {2, 3}
    assert {r["rank"] for r in steps if r["size"] == 3} == {0, 1, 2}
    assert max(r["step"] for r in steps) == 10
    _assert_equal_weights(records, 3)


def test_port_worker_cold_restart_auto_resumes(tmp_path):
    """A job of 6 steps checkpoints every commit; a new job on the same
    directory (every process fresh) auto-resumes at step 6 and runs to
    step 10 instead of starting over."""
    discovery = _discovery(tmp_path, "localhost:2")
    ckpt = {"ELASTIC_CKPT_DIR": str(tmp_path / "ckpt"),
            "ELASTIC_CKPT_INTERVAL": "1"}
    first, _ = _run(tmp_path, discovery, 2, 2,
                    dict(ckpt, ELASTIC_TOTAL_STEPS="6"), timeout=120,
                    logs="logs1")
    assert first.returncode == 0, first.stdout[-4000:] + first.stderr[-4000:]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["4", "5", "6"]
    second, records = _run(tmp_path, discovery, 2, 2,
                           dict(ckpt, ELASTIC_TOTAL_STEPS="10"),
                           timeout=120, logs="logs2")
    assert second.returncode == 0, \
        second.stdout[-4000:] + second.stderr[-4000:]
    resumed = [int(s) for s in re.findall(
        r"auto-resumed from checkpoint step (\d+)", second.stdout)]
    assert resumed == [6, 6], second.stdout[-4000:]
    steps = _steps(records)
    assert min(r["step"] for r in steps) == 7
    assert max(r["step"] for r in steps) == 10
    _assert_equal_weights(records, 2)
