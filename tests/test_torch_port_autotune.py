"""The port's autotuner (``horovod_tpu_torch/utils/autotune.py``) against
the JAX package's (``horovod_tpu/utils/autotune.py``), and
``HOROVOD_AUTOTUNE`` on the port's core.

* ``GaussianProcess``, ``BayesianOptimizer`` and ``ParameterManager``
  with the same seed and the same calls give the same predictions,
  suggestions, applied parameters and log, bit for bit;
* ``HOROVOD_AUTOTUNE=1`` at size 1 moves the core's fusion threshold and
  cycle time within the reference's box as allreduces complete, and the
  results stay those of ``LocalBackend``; ``HOROVOD_AUTOTUNE=native``
  starts the core's own tuner and reports its state.
"""

import numpy as np
import pytest
import torch

from horovod_tpu.utils import autotune as ref_at

from horovod_tpu_torch.utils import autotune as port_at

SEEDS = [0, 1, 7]


@pytest.mark.parametrize("seed", SEEDS)
def test_gaussian_process_predicts_as_the_reference(seed):
    rng = np.random.RandomState(seed)
    x, y, q = rng.rand(9, 2), rng.randn(9), rng.rand(40, 2)
    out = []
    for mod in (ref_at, port_at):
        gp = mod.GaussianProcess(length_scale=0.3)
        gp.fit(x, y)
        out.append(gp.predict(q))
    for a, b in zip(*out):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("seed", SEEDS)
def test_bayesian_optimizer_suggests_as_the_reference(seed):
    bounds = [port_at.FUSION_MB_BOUNDS, port_at.CYCLE_MS_BOUNDS]
    ref = ref_at.BayesianOptimizer(bounds, seed=seed)
    got = port_at.BayesianOptimizer(bounds, seed=seed)
    for _ in range(15):
        a, b = ref.suggest(), got.suggest()
        assert np.array_equal(a, b)
        score = float(np.sin(a[0] / 9.0) + np.cos(a[1] / 17.0))
        ref.add_sample(a, score)
        got.add_sample(b, score)


@pytest.mark.parametrize("seed", SEEDS)
def test_parameter_manager_applies_as_the_reference(seed, tmp_path,
                                                    monkeypatch):
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", str(32 << 20))
    monkeypatch.setenv("HOROVOD_CYCLE_TIME", "2.5")
    rng = np.random.RandomState(seed)
    calls = [(int(rng.randint(1, 1 << 24)), float(t))
             for t in np.cumsum(rng.uniform(1e-4, 1e-2, 400))]
    applied, currents = {}, {}
    for name, mod in (("ref", ref_at), ("port", port_at)):
        got = applied[name] = []
        pm = mod.ParameterManager(lambda c, f: got.append((c, f)),
                                  log_file=str(tmp_path / name))
        seen = [pm.current]
        for nbytes, now in calls:
            pm.record(nbytes, now)
            seen.append(pm.current)
        currents[name] = (seen, pm.done)
        pm._log.close()
    assert applied["port"] == applied["ref"]
    assert len(applied["port"]) == port_at.MAX_SAMPLES
    assert currents["port"] == currents["ref"]
    assert currents["port"][1]  # froze its best point
    with open(str(tmp_path / "ref")) as a, open(str(tmp_path / "port")) as b:
        assert a.read() == b.read()
    for cycle_ms, fusion_bytes in applied["port"]:
        assert 1.0 <= cycle_ms <= 100.0
        assert 1 <= fusion_bytes <= 64 << 20


def _size_one(monkeypatch, **env):
    for name in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_TIMELINE",
                 "HVD_METRICS_PORT", "HOROVOD_AUTOTUNE"):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def test_python_autotune_moves_the_cores_parameters(monkeypatch, tmp_path):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.eager import LocalBackend

    _size_one(monkeypatch, HOROVOD_AUTOTUNE="1",
              HOROVOD_AUTOTUNE_LOG=str(tmp_path / "log.csv"))
    hvd.init(device="cpu")
    try:
        core = hvd.common.basics.core_session()
        assert core.autotune_state() is None
        start = core.fusion_bytes()
        initial = core.autotune.current
        points, thresholds = {initial}, {start}
        gen = torch.Generator().manual_seed(0)
        for i in range(80):
            xs = [torch.randn(33, generator=gen) for _ in range(4)]
            got = [hvd.synchronize(h) for h in [
                hvd.allreduce_async(x, name="at.%d" % k)
                for k, x in enumerate(xs)]]
            want = LocalBackend().allreduce_async(
                xs, None, hvd.Average, 1.0, 1.0, None).result()
            for g, w in zip(got, want):
                assert torch.equal(g.view(torch.int32), w.view(torch.int32))
            points.add(core.autotune.current)
            thresholds.add(core.fusion_bytes())
        moved = points - {initial}
        assert len(moved) >= 5
        assert all(0.0 <= f <= 64.0 and 1.0 <= c <= 100.0
                   for f, c in moved)
        # The core runs the tuner's point: it moved off the start, and
        # holds the point the tuner froze (its start, if that scored best).
        assert len(thresholds - {start}) >= 3
        assert core.autotune.done
        assert core.fusion_bytes() == max(
            int(core.autotune.current[0] * 1024 * 1024), 1)
    finally:
        hvd.shutdown()
    with open(str(tmp_path / "log.csv")) as f:
        assert f.readline().startswith("sample,fusion_mb,cycle_ms")


def test_native_autotune_starts_the_cores_tuner(monkeypatch):
    import horovod_tpu_torch as hvd

    _size_one(monkeypatch, HOROVOD_AUTOTUNE="native")
    hvd.init(device="cpu")
    try:
        core = hvd.common.basics.core_session()
        assert core.autotune is None
        state = core.autotune_state()
        assert set(state) == {"fusion_mb", "cycle_ms", "done", "samples",
                              "cache_enabled", "hierarchical",
                              "categorical_samples"}
        x = torch.ones(1024)
        for i in range(200):
            hvd.allreduce(x, name="nat.x")
            if core.autotune_state()["samples"] >= 2:
                break
        state = core.autotune_state()
        assert state["samples"] >= 2, state
        assert 0.0 <= state["fusion_mb"] <= 64.0
        assert 1.0 <= state["cycle_ms"] <= 100.0
    finally:
        hvd.shutdown()
