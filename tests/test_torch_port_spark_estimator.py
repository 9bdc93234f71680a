"""The port's ``TorchEstimator``, ``spark.run`` and ``spark.run_elastic``
on the CPU.

Parity: tests/torch_port_spark_worker.py fits the same pickled MLP on the
same seeded rows with each package's estimator, each in its own process
(their cores export the same symbols). At np 1 (inline) the history, the
state dict and the predictions must be equal bit for bit; at np 2 (each
package's launcher; the port's with ``platform="cpu"``) within
``NP2_TOL``, relative to the largest magnitude of the reference's tensor.
The two cases are plain MSE on shuffled rows and per-row weights with a
zero-weight block (skipped at size 1, the lockstep step above it).

The port alone, in this process: resume from the run's checkpoint,
``terminate_on_nan`` and the checkpoint callback, and the estimator and
``spark.run`` raising where there is no card. ``spark.run`` and
``run_elastic`` over tests/fake_pyspark.py (barrier tasks are spawned
processes) at np 2 on gloo, as tests/test_cluster_fakes.py holds the
reference's; ``run_elastic`` runs chip_smoke.py's elastic task on the tiny
transformer with one raised failure and must end with the uninterrupted
run's weights.
"""

import os
import sys
import time

import numpy as np
import pandas as pd
import pytest
import torch

import fake_pyspark
from torch_port_runs import start_runs

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_port_spark_worker.py")
# np 2: both packages average the two ranks' gradients through their
# cores' TCP ring in fp32, the same sum in the same order; the observed gap
# is 0 (the tolerance leaves room for a summation order that differs).
NP2_TOL = 1e-6
CASES = [("plain", 1), ("weights", 1), ("plain", 2), ("weights", 2)]
_LAUNCHER_ENV = ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
                 "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK",
                 "HOROVOD_CROSS_SIZE", "HOROVOD_CONTROLLER_ADDR",
                 "HOROVOD_CONTROLLER_PORT", "HOROVOD_WORKER_PLATFORM")


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spark_fits")
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(2, 8), torch.nn.Tanh(),
                                torch.nn.Linear(8, 1))
    path = str(tmp / "model.pt")
    torch.save(model, path)
    specs = [((pkg, case, n), 1, [pkg, case, str(n), path])
             for pkg in ("jax", "port") for case, n in CASES]
    return start_runs(WORKER, specs, tmp, env={"OMP_NUM_THREADS": "1"})


def _fields(run):
    return {k: v for k, v in run[0].items()}


@pytest.mark.parametrize("case", ["plain", "weights"])
def test_fit_at_np1_equals_the_reference_bit_for_bit(fits, case):
    got, want = _fields(fits["port", case, 1]), _fields(fits["jax", case, 1])
    assert sorted(got) == sorted(want)
    assert np.isfinite(got["history"]).all()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("case", ["plain", "weights"])
def test_fit_at_np2_within_tolerance_of_the_reference(fits, case):
    got, want = _fields(fits["port", case, 2]), _fields(fits["jax", case, 2])
    assert sorted(got) == sorted(want)
    gaps = {}
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        gaps[k] = float(np.abs(got[k].astype(np.float64)
                               - want[k].astype(np.float64)).max()) / scale
    print("np 2 %s: largest gap to the reference %.3e (%s)"
          % (case, max(gaps.values()), max(gaps, key=gaps.get)))
    assert max(gaps.values()) <= NP2_TOL, gaps


# ------------------------------------------------------------- in-process ---

@pytest.fixture
def port_env(monkeypatch):
    """No launcher env; the estimator's inline backend sets
    HOROVOD_WORKER_PLATFORM in this process, so the whole env is restored
    and the port shut down afterwards."""
    import horovod_tpu_torch as hvd

    for name in _LAUNCHER_ENV:
        monkeypatch.delenv(name, raising=False)
    saved = dict(os.environ)
    try:
        yield
    finally:
        hvd.shutdown()
        os.environ.clear()
        os.environ.update(saved)


def _toy_pdf(n=64):
    rng = np.random.RandomState(0)
    x1, x2 = rng.rand(n), rng.rand(n)
    return pd.DataFrame({"x1": x1, "x2": x2, "y": 2.0 * x1 - x2 + 0.5})


def _estimator(tmp_path, store_dir, **kw):
    from horovod_tpu_torch.spark.common import FilesystemStore, LocalBackend
    from horovod_tpu_torch.spark.torch import TorchEstimator

    args = dict(loss=torch.nn.MSELoss(), feature_cols=["x1", "x2"],
                label_cols=["y"], batch_size=16, verbose=0,
                store=FilesystemStore(str(tmp_path / store_dir)),
                backend=LocalBackend(num_proc=1, platform="cpu"))
    args.update(kw)
    if "model" not in args:
        args["model"] = torch.nn.Linear(2, 1)
    return TorchEstimator(**args)


def test_fit_resumes_from_the_runs_checkpoint(port_env, tmp_path):
    pdf = _toy_pdf(128)
    first = _estimator(tmp_path, "s", epochs=4, run_id="resume").fit(pdf)
    x = [[0.3, 0.4], [0.9, 0.1]]
    trained = first.predict(x, device="cpu")
    # lr=0: the returned weights are what training started from.
    frozen = lambda params: torch.optim.SGD(params, lr=0.0)  # noqa: E731
    resumed = _estimator(tmp_path, "s", epochs=1, run_id="resume",
                         optimizer=frozen,
                         resume_from_checkpoint=True).fit(pdf)
    assert np.array_equal(resumed.predict(x, device="cpu"), trained)
    fresh = _estimator(tmp_path, "s", epochs=1, run_id="fresh",
                       optimizer=frozen).fit(pdf)
    assert not np.allclose(fresh.predict(x, device="cpu"), trained,
                           atol=1e-6)
    # The checkpoint holds CPU tensors, and save/load round-trips.
    from horovod_tpu_torch.spark.torch import TorchModel

    ckpt = torch.load(first.store.get_checkpoint_path("resume"),
                      weights_only=False)
    assert all(v.device.type == "cpu" for v in ckpt.values())
    first.save()
    loaded = TorchModel.load(first.store, "resume")
    assert loaded.history == first.history
    assert np.array_equal(loaded.predict(x, device="cpu"), trained)


def test_terminate_on_nan_and_checkpoint_callback(port_env, tmp_path):
    seen = []
    _estimator(tmp_path, "s", epochs=3,
               checkpoint_callback=lambda model, epoch: seen.append(
                   epoch)).fit(_toy_pdf())
    assert seen == [0, 1, 2]
    diverge = lambda params: torch.optim.SGD(params, lr=1e9)  # noqa: E731
    with pytest.raises(RuntimeError, match="terminate_on_nan"):
        _estimator(tmp_path, "s2", epochs=5, optimizer=diverge,
                   terminate_on_nan=True).fit(_toy_pdf())


def test_sample_weights_ignore_zero_weight_rows(port_env, tmp_path):
    rng = np.random.RandomState(3)
    x1, x2 = rng.rand(128), rng.rand(128)
    y = 2.0 * x1 - x2
    y[::2] = 100.0
    w = np.ones(128)
    w[::2] = 0.0
    pdf = pd.DataFrame({"x1": x1, "x2": x2, "y": y, "w": w})
    torch.manual_seed(7)
    m = _estimator(tmp_path, "s", loss=torch.nn.MSELoss(reduction="none"),
                   sample_weight_col="w", epochs=40, random_seed=7).fit(pdf)
    assert abs(float(m.predict([[0.5, 0.5]], device="cpu")[0, 0])
               - 0.5) < 0.5
    with pytest.raises(ValueError, match="reduction"):
        _estimator(tmp_path, "s2", sample_weight_col="w",
                   epochs=1).fit(pdf)


def test_the_card_path_raises_without_a_card(port_env, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    from horovod_tpu_torch.spark.common import LocalBackend

    est = _estimator(tmp_path, "s", epochs=1, backend=LocalBackend())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        est.fit(_toy_pdf())
    fitted = _estimator(tmp_path, "s2", epochs=1).fit(_toy_pdf())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fitted.predict([[0.1, 0.2]])


# -------------------------------------------------------- spark over fakes ---

@pytest.fixture
def pyspark_fake():
    fake_pyspark.install()
    yield
    fake_pyspark.uninstall()


def _train_fn():
    """In a barrier task: init from the task's env, one Sum allreduce."""
    import torch

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common import basics

    hvd.init()
    out = hvd.allreduce(torch.full((4,), float(hvd.rank() + 1)),
                        name="spark_fake_ar", op=hvd.Sum)
    return (hvd.rank(), hvd.size(), float(out[0]), basics.init_device(),
            hvd.local_rank(), "jax" in sys.modules)


def test_spark_run_barrier_mode(pyspark_fake):
    from horovod_tpu_torch import spark

    got = spark.run(_train_fn, num_proc=2, platform="cpu")
    assert got == [(0, 2, 3.0, "cpu", 0, False), (1, 2, 3.0, "cpu", 1,
                                                  False)]


def test_spark_run_propagates_task_failure(pyspark_fake):
    from horovod_tpu_torch import spark

    def boom():
        raise ValueError("rank exploded")

    with pytest.raises(RuntimeError, match="rank exploded"):
        spark.run(boom, num_proc=2, platform="cpu")


def test_spark_run_raises_without_a_card(pyspark_fake):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    from horovod_tpu_torch import spark

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spark.run(_train_fn, num_proc=1)
    assert time.monotonic() - t0 < 120


def test_init_raises_for_a_local_rank_without_a_card(monkeypatch):
    """A task whose local rank has no card raises from init() before it
    joins any rendezvous (the card count patched: this box has none)."""
    from horovod_tpu_torch.common import basics

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for name, value in (("HOROVOD_RANK", "1"), ("HOROVOD_SIZE", "2"),
                        ("HOROVOD_LOCAL_RANK", "1"),
                        ("HOROVOD_LOCAL_SIZE", "2")):
        monkeypatch.setenv(name, value)
    with pytest.raises(RuntimeError, match=r"cuda:1 \(local rank 1\), "
                       r"but this host shows 1 CUDA card"):
        basics.init(device="cuda")
    assert not basics.is_initialized()


def test_task_env_topology():
    from horovod_tpu_torch.spark import task_env

    hosts = ["a", "a", "b", "b", "a"]
    envs = [task_env(r, 5, hosts, "a:1234", "gpu") for r in range(5)]
    assert [(e["HOROVOD_LOCAL_RANK"], e["HOROVOD_LOCAL_SIZE"],
             e["HOROVOD_CROSS_RANK"], e["HOROVOD_CROSS_SIZE"])
            for e in envs] == [("0", "3", "0", "2"), ("1", "3", "0", "2"),
                               ("0", "2", "1", "2"), ("1", "2", "1", "2"),
                               ("2", "3", "0", "1")]
    assert [e["HOROVOD_CONTROLLER_ADDR"] for e in envs] == \
        ["127.0.0.1", "127.0.0.1", "a", "a", "127.0.0.1"]
    assert {e["HOROVOD_CONTROLLER_PORT"] for e in envs} == {"1234"}
    assert {e["HOROVOD_WORKER_PLATFORM"] for e in envs} == {"gpu"}
    assert task_env(0, 1, ["a"], "a:1", "cpu")[
        "HOROVOD_WORKER_PLATFORM"] == "cpu"
    with pytest.raises(ValueError):
        task_env(0, 1, ["a"], "a:1", "tpu")


def test_run_elastic_validates_the_world():
    from horovod_tpu_torch import spark

    with pytest.raises(ValueError, match="min_np"):
        spark.run_elastic(_train_fn, num_proc=1, min_np=2)
    with pytest.raises(ValueError, match="max_np"):
        spark.run_elastic(_train_fn, num_proc=3, max_np=2)


def test_run_elastic_retries_to_the_uninterrupted_weights(pyspark_fake,
                                                          tmp_path):
    from horovod_tpu_torch import models, spark

    def elastic(fail_step):
        state, model, opt = chip_smoke.spark_elastic_state(torch, models,
                                                           tiny=True)
        return spark.run_elastic(
            chip_smoke.spark_elastic_task,
            args=(state, model, opt, 4, fail_step,
                  str(tmp_path / "raised"), True),
            num_proc=2, retries=1, platform="cpu")

    # The tasks import chip_smoke (by reference) from the driver's path.
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke

        whole = elastic(0)
        failed = elastic(2)
    finally:
        sys.path.remove(ROOT)
    assert [r["started_from"] for r in whole] == [0, 0]
    assert [r["generation"] for r in whole] == [1, 1]
    assert [r["started_from"] for r in failed] == [1, 1]
    assert [r["generation"] for r in failed] == [2, 2]
    assert [r["step"] for r in failed] == [4, 4]
    assert all(os.path.exists(str(tmp_path / "raised") + ".%d" % r)
               for r in range(2))
    assert len({r["checksum"] for r in whole + failed}) == 1
    assert {r["device"] for r in failed} == {"cpu"}
