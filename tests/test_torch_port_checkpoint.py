"""The port's torch-native ``Checkpointer`` against the JAX package's orbax
one (``horovod_tpu/utils/checkpoint.py``).

Both take the same sequence of ``save(step)`` calls (repeats, steps off
the interval, ``force``, more steps than ``max_to_keep``) and must agree
on every returned bool, on ``all_steps()`` and ``latest_step()`` after
each call, and on the restored values. Also: an empty restore, a failed
save that still reaches the completion barrier, the atomic commit (a step
without its marker is no step), a template's dtypes, and np=2 under gloo
(this file, run as a script by two processes, is the two ranks).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# (step, force) in order: the first save is taken off the interval,
# repeats and steps at or below the newest are skipped, off-interval
# steps are skipped unless forced, and five kept steps exceed
# max_to_keep=2.
SEQUENCE = [(1, False), (2, False), (3, False), (3, False), (4, False),
            (5, True), (6, False), (7, False), (8, True), (6, False),
            (9, False), (10, False), (12, False), (15, False)]


def _value(step):
    return {"w": np.arange(4, dtype=np.float32) * step,
            "n": np.arange(3, dtype=np.int64) + step}


def test_both_checkpointers_agree_on_a_save_sequence(tmp_path):
    from horovod_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer

    from horovod_tpu_torch.utils.checkpoint import Checkpointer

    jax_ck = JaxCheckpointer(str(tmp_path / "jax"), max_to_keep=2,
                             save_interval_steps=3)
    port_ck = Checkpointer(str(tmp_path / "port"), max_to_keep=2,
                           save_interval_steps=3)
    assert jax_ck.latest_step() is None and port_ck.latest_step() is None
    for step, force in SEQUENCE:
        v = _value(step)
        got_jax = jax_ck.save(step, v, force=force)
        got_port = port_ck.save(
            step, {k: torch.from_numpy(a) for k, a in v.items()},
            force=force)
        assert got_port == got_jax, (step, force)
        assert port_ck.all_steps() == list(jax_ck.all_steps()), step
        assert port_ck.latest_step() == jax_ck.latest_step(), step
    assert port_ck.all_steps() == [12, 15]
    for step in port_ck.all_steps():
        want = jax_ck.restore(step=step)
        got = port_ck.restore(step=step)
        for k in ("w", "n"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
            assert got[k].numpy().dtype == np.asarray(want[k]).dtype
    newest = port_ck.restore()
    np.testing.assert_array_equal(newest["w"].numpy(), _value(15)["w"])
    # A fresh Checkpointer on the same directory sees the steps on disk:
    # a step already saved is skipped, the next one on the interval taken.
    again = Checkpointer(str(tmp_path / "port"), max_to_keep=2,
                         save_interval_steps=3)
    assert again.save(15, {"w": torch.zeros(1)}) is False
    assert again.save(16, {"w": torch.zeros(1)}) is False
    assert again.save(18, {"w": torch.zeros(1)}) is True
    assert again.all_steps() == [15, 18]
    jax_ck.close()
    port_ck.close()


def test_forced_save_of_an_existing_step_raises_like_orbax(tmp_path):
    from horovod_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer

    from horovod_tpu_torch.utils.checkpoint import (
        Checkpointer, StepAlreadyExistsError,
    )

    jax_ck = JaxCheckpointer(str(tmp_path / "jax"))
    port_ck = Checkpointer(str(tmp_path / "port"))
    jax_ck.save(4, _value(4))
    port_ck.save(4, {"w": torch.zeros(2)})
    with pytest.raises(ValueError):
        jax_ck.save(4, _value(4), force=True)
    with pytest.raises(StepAlreadyExistsError):
        port_ck.save(4, {"w": torch.zeros(2)}, force=True)
    assert issubclass(StepAlreadyExistsError, ValueError)


def test_restore_of_an_empty_directory_raises(tmp_path):
    from horovod_tpu_torch.utils.checkpoint import Checkpointer

    ck = Checkpointer(str(tmp_path / "empty"))
    assert ck.all_steps() == [] and ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore()
    with pytest.raises(FileNotFoundError):
        ck.restore(step=3)


def test_failed_save_still_reaches_the_barrier(tmp_path, monkeypatch):
    """Rank 0's write fails: it still enters the completion barrier the
    other ranks wait in, and raises only after it; nothing is left on
    disk."""
    from horovod_tpu_torch.utils import checkpoint

    ck = checkpoint.Checkpointer(str(tmp_path / "boom"))
    calls = []
    monkeypatch.setattr(ck, "_barrier", lambda: calls.append("barrier"))

    def boom(*args, **kwargs):
        calls.append("save")
        raise IOError("disk full")

    monkeypatch.setattr(checkpoint.torch, "save", boom)
    with pytest.raises(IOError, match="disk full"):
        ck.save(1, {"w": torch.zeros(2)})
    assert calls == ["save", "barrier"]
    assert ck.all_steps() == [] and os.listdir(ck.directory) == []


def test_a_step_without_its_marker_is_no_step(tmp_path):
    """The commit is atomic: a torn step directory (no marker) and a
    temporary directory left by a crash are not steps, and a new
    Checkpointer removes the temporary one."""
    from horovod_tpu_torch.utils import checkpoint

    ck = checkpoint.Checkpointer(str(tmp_path / "c"))
    assert ck.save(1, {"w": torch.ones(2)})
    os.makedirs(os.path.join(ck.directory, "2"))
    torch.save({"w": torch.zeros(2)},
               os.path.join(ck.directory, "2", checkpoint.STATE_FILE))
    os.makedirs(os.path.join(ck.directory, ".tmp-3-1"))
    assert ck.all_steps() == [1] and ck.latest_step() == 1
    again = checkpoint.Checkpointer(ck.directory)
    assert sorted(os.listdir(again.directory)) == ["1", "2"]
    # The torn step's number can be written properly.
    assert again.save(2, {"w": torch.full((2,), 2.0)})
    assert again.all_steps() == [1, 2]
    assert torch.equal(again.restore()["w"], torch.full((2,), 2.0))


def test_restore_with_a_template_takes_its_dtypes(tmp_path):
    from horovod_tpu_torch.utils.checkpoint import Checkpointer

    ck = Checkpointer(str(tmp_path / "t"))
    ck.save(7, {"w": torch.arange(4, dtype=torch.float32),
                "inner": [torch.ones(2, dtype=torch.int64)], "step": 7})
    out = ck.restore(template={"w": torch.zeros(4, dtype=torch.float64),
                               "inner": [torch.zeros(2,
                                                     dtype=torch.int32)],
                               "step": 0})
    assert out["w"].dtype == torch.float64
    assert out["inner"][0].dtype == torch.int32
    assert out["step"] == 7
    assert torch.equal(out["w"], torch.arange(4, dtype=torch.float64))


def test_checkpointer_np2_gloo(tmp_path):
    """Two ranks on gloo: rank 0 writes and returns True, rank 1 returns
    False; after the barrier both restore rank 0's values."""
    init_file = str(tmp_path / "rendezvous")
    procs = []
    for rank in range(2):
        env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE="2",
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE="2",
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), init_file,
             str(tmp_path / "shared"), str(tmp_path / ("rank%d" % rank))],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=120)[0].decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    got = [open(str(tmp_path / ("rank%d" % r))).read().split()
           for r in range(2)]
    assert got[0] == ["True", "[1,2]", "2", "7.0"]
    assert got[1] == ["False", "[1,2]", "2", "7.0"]


def _worker_main(init_file, directory, out_path):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.utils.checkpoint import Checkpointer

    hvd.init(device="cpu", init_method="file://" + init_file)
    ck = Checkpointer(directory, max_to_keep=2)
    ck.save(1, {"w": torch.full((3,), 1.0 + 5 * hvd.rank())})
    saved = ck.save(2, {"w": torch.full((3,), 2.0 + 5 * hvd.rank())})
    steps = ck.all_steps()
    out = ck.restore()
    with open(out_path, "w") as f:
        f.write("%s [%s] %s %s\n" % (saved, ",".join(map(str, steps)),
                                     ck.latest_step(),
                                     float(out["w"].sum()) + 1.0))
    hvd.shutdown()


if __name__ == "__main__":
    _worker_main(*sys.argv[1:4])
