"""The port's serving package (``horovod_tpu_torch/serve``) against the
reference's (``horovod_tpu/serve``), on the CPU.

* ``batching``: the bucket math and the bit-equality check against the
  reference's functions, case by case, and the reference's own
  tests/test_serve_batching.py run against the port's module (its
  ``mlp_apply``-fixture cases excepted: they hold a flax model's buckets,
  which the replica cases below cover for the port's models).
* The router, autoscale monitor, standby, rollout and server are the
  reference's jax-free modules with the port's imports: the reference's
  tests/test_serve_router.py runs against them whole, its imports
  rewritten to the port's modules.
* The replica: ``mnist_mlp`` and ``mnist_cnn`` served from the flax
  models' weights carried across (``models/convert.py``
  ``mnist_from_jax_params``, saved through the port's ``Checkpointer``)
  against the reference's ``apply`` within ``SERVE_RTOL`` of the largest
  logit (fp32: XLA's and oneDNN's GEMMs and convolutions sum in other
  orders); the port's own bucket path bit for bit at any row position;
  the heartbeat payload key for key with the reference replica's; the
  reference's tests/test_serve_replica.py cases mirrored; and the port's
  router fronting a port replica through a directed reload, a drain and
  the goodbye beat.
"""

import inspect
import json
import os
import time
import types

import numpy as np
import pytest
import torch

from horovod_tpu.serve import batching as ref_batching

from horovod_tpu_torch.serve import batching

HERE = os.path.dirname(os.path.abspath(__file__))
# fp32 logits of the port against the reference's, relative to the
# largest magnitude.
SERVE_RTOL = 1e-5


def _port_copy(filename, name):
    """The reference test file ``filename`` with every ``horovod_tpu.``
    import rewritten to ``horovod_tpu_torch.``, as a module."""
    with open(os.path.join(HERE, filename)) as f:
        src = f.read().replace("horovod_tpu.", "horovod_tpu_torch.")
    mod = types.ModuleType(name)
    mod.__file__ = os.path.join(HERE, filename)
    exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    return mod


def _tests(mod, exclude=()):
    return sorted(n for n, f in vars(mod).items()
                  if n.startswith("test_") and callable(f)
                  and n not in exclude)


def _call(fn, request):
    args = {}
    for p in inspect.signature(fn).parameters:
        args[p] = request.getfixturevalue(p)
    return fn(**args)


ROUTER = _port_copy("test_serve_router.py", "_port_serve_router_tests")
BATCHING = _port_copy("test_serve_batching.py", "_port_serve_batching_tests")
FIXTURED = {"test_batched_vs_unbatched_bit_equality",
            "test_bucket_equality_assertion_passes_stable_buckets",
            "test_bucket_equality_tripwire_catches_unstable_bucket"}


@pytest.mark.parametrize("name", _tests(ROUTER))
def test_the_references_router_tests_on_the_port(name, request):
    _call(getattr(ROUTER, name), request)


@pytest.mark.parametrize("name", _tests(BATCHING, FIXTURED))
def test_the_references_batching_tests_on_the_port(name, request):
    _call(getattr(BATCHING, name), request)


def test_the_rewritten_tests_import_only_the_port():
    for mod in (ROUTER, BATCHING):
        for v in vars(mod).values():
            name = getattr(v, "__module__", None) or getattr(
                v, "__name__", "")
            assert not name.startswith("horovod_tpu.")


# --- batching, case by case ---------------------------------------------


@pytest.mark.parametrize("max_batch,min_bucket", [
    (8, 4), (8, 1), (1, 4), (5, 2), (16, 4), (12, 3), (0, 4), (4, 9)])
def test_bucket_sizes_are_the_references(max_batch, min_bucket):
    try:
        want = ref_batching.bucket_sizes(max_batch, min_bucket)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            batching.bucket_sizes(max_batch, min_bucket)
        return
    assert batching.bucket_sizes(max_batch, min_bucket) == want


@pytest.mark.parametrize("n", range(0, 11))
def test_pick_and_pad_are_the_references(n):
    buckets = [4, 8]
    try:
        want = ref_batching.pick_bucket(n, buckets)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            batching.pick_bucket(n, buckets)
        return
    assert batching.pick_bucket(n, buckets) == want
    rows = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    np.testing.assert_array_equal(batching.pad_to_bucket(rows, want),
                                  ref_batching.pad_to_bucket(rows, want))


def _stable(x):
    return x * 2.0


def _coupled(x):
    return x + x.sum(axis=0, keepdims=True)


def _bucket_unstable(x):
    return x * (1.0 + 1e-7 * (x.shape[0] > 4))


@pytest.mark.parametrize("fn", [_stable, _coupled, _bucket_unstable])
def test_assert_bucket_equality_is_the_references(fn):
    sample = np.linspace(-1, 1, 6).astype(np.float32).reshape(2, 3)
    outcomes = []
    for mod in (ref_batching, batching):
        try:
            mod.assert_bucket_equality(fn, [4, 8], sample)
            outcomes.append(None)
        except AssertionError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


# --- the replica --------------------------------------------------------


def _post(port, path, doc, timeout=15.0):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=json.dumps(doc))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode() or "{}")
    finally:
        conn.close()


def _get(port, path, timeout=15.0):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode() or "{}")
    finally:
        conn.close()


MNIST = {"mnist_mlp": ("MnistMLP", "mlp", (28, 28)),
         "mnist_cnn": ("MnistCNN", "cnn", (28, 28, 1))}


def _flax_params(model, seed):
    import jax
    import jax.numpy as jnp

    from horovod_tpu import models as ref_models

    cls, _, shape = MNIST[model]
    module = getattr(ref_models, cls)()
    params = module.init(jax.random.PRNGKey(seed), jnp.ones((1,) + shape))
    return module, params


def _save(directory, model, steps):
    """Save each step's flax weights, carried across, through the port's
    ``Checkpointer``; returns {step: (flax module, flax params)}."""
    from horovod_tpu_torch.models.convert import mnist_from_jax_params
    from horovod_tpu_torch.utils.checkpoint import Checkpointer

    ck = Checkpointer(str(directory), max_to_keep=None)
    out = {}
    for step in steps:
        module, params = _flax_params(model, step)
        state = mnist_from_jax_params(params, MNIST[model][1])
        assert ck.save(step, {"params": state})
        out[step] = (module, params)
    return out


@pytest.mark.parametrize("model", sorted(MNIST))
def test_replica_serves_the_flax_weights_as_the_reference(model, tmp_path):
    from horovod_tpu_torch.serve.replica import Replica

    saved = _save(tmp_path, model, [0])
    module, params = saved[0]
    replica = Replica(model=model, ckpt_dir=str(tmp_path), replica_id="r0",
                      device="cpu", max_batch=8, min_bucket=4)
    try:
        replica.start()
        assert replica.step == 0
        rng = np.random.RandomState(3)
        for n in (1, 3, 6, 8):
            xs = rng.standard_normal((n,) + MNIST[model][2]) \
                .astype(np.float32)
            status, doc = _post(replica.port, "/v1/predict",
                                {"inputs": xs.tolist()})
            assert status == 200, doc
            assert doc["model"] == model and doc["step"] == 0
            got = np.asarray(doc["outputs"], dtype=np.float32)
            want = np.asarray(module.apply(params, xs, train=False))
            assert got.shape == want.shape == (n, 10)
            assert np.abs(got - want).max() <= \
                SERVE_RTOL * np.abs(want).max(), (n, got, want)
            # The replica's own bucket path, bit for bit, with the rows
            # at any place in the batch.
            apply, _ = replica._loaded_state()
            bucket = batching.pick_bucket(n, [4, 8])
            np.testing.assert_array_equal(
                got, apply(batching.pad_to_bucket(xs, bucket))[:n])
            shifted = np.concatenate([rng.standard_normal(
                (8 - n,) + MNIST[model][2]).astype(np.float32), xs])
            np.testing.assert_array_equal(got, apply(shifted)[8 - n:])
    finally:
        replica.stop()


def test_the_heartbeat_payload_is_the_references():
    from horovod_tpu.serve.replica import Replica as RefReplica

    from horovod_tpu_torch.serve.replica import Replica

    mine, ref = Replica(model="identity"), RefReplica(model="identity")
    for r in (mine, ref):
        r.load()
    try:
        assert list(mine.endpoint_payload()) == list(ref.endpoint_payload())
        for r in (mine, ref):
            r._draining = True
        assert list(mine.endpoint_payload()) == list(ref.endpoint_payload())
        assert mine.endpoint_payload()["draining"] is True
        assert mine._handle_healthz()[0] == 200
        assert sorted(json.loads(mine._handle_healthz()[2])) == \
            sorted(json.loads(ref._handle_healthz()[2]))
    finally:
        mine.stop()
        ref.stop()


def test_unknown_model_and_missing_ckpt_dir_fail_loudly():
    from horovod_tpu_torch.serve.replica import Replica

    with pytest.raises(ValueError, match="unknown model"):
        Replica(model="no_such_model", device="cpu").load()
    with pytest.raises(ValueError, match="ckpt-dir"):
        Replica(model="mnist_mlp", device="cpu").load()


def test_checkpoint_hot_reload_swaps_newer_committed_step(tmp_path,
                                                          monkeypatch):
    from horovod_tpu_torch.serve.replica import Replica
    from horovod_tpu_torch.utils.checkpoint import Checkpointer

    monkeypatch.setenv("HVD_SERVE_CKPT_POLL_SEC", "0.2")
    ck = Checkpointer(str(tmp_path), max_to_keep=3)
    assert ck.save(0, {"params": {"scale": torch.tensor(2.0)}})

    def apply_fn(params, x):
        return x * params["scale"].item()

    replica = Replica(ckpt_dir=str(tmp_path), replica_id="r0",
                      apply_fn=apply_fn, sample_shape=(2,), max_batch=4,
                      min_bucket=4, deadline_ms=1)
    try:
        replica.start()
        status, doc = _post(replica.port, "/v1/predict",
                            {"inputs": [[1.0, 1.0]]})
        assert status == 200 and doc["outputs"] == [[2.0, 2.0]]
        assert doc["step"] == 0
        assert ck.save(1, {"params": {"scale": torch.tensor(5.0)}})
        deadline = time.monotonic() + 30
        while True:
            status, doc = _post(replica.port, "/v1/predict",
                                {"inputs": [[1.0, 1.0]]})
            assert status == 200
            if doc["outputs"] == [[5.0, 5.0]]:
                assert doc["step"] == 1
                break
            assert time.monotonic() < deadline, doc
            time.sleep(0.2)
    finally:
        replica.stop()


def test_replica_startup_self_check_blocks_coupled_model(tmp_path):
    from horovod_tpu_torch.serve.replica import Replica
    from horovod_tpu_torch.utils.checkpoint import Checkpointer

    ck = Checkpointer(str(tmp_path), max_to_keep=1)
    assert ck.save(0, {"params": {"bias": torch.tensor(1.0)}})

    def coupled(params, x):
        return x + x.sum(axis=0, keepdims=True) + params["bias"].item()

    replica = Replica(ckpt_dir=str(tmp_path), apply_fn=coupled,
                      sample_shape=(2,), max_batch=4, min_bucket=4)
    with pytest.raises(AssertionError, match="bit-exactness"):
        replica.load()


REPLICA = _port_copy("test_serve_replica.py", "_port_serve_replica_tests")


@pytest.mark.parametrize("name", [
    "test_replica_readers_snapshot_apply_and_step_under_the_lock",
    "test_replica_hot_reload_never_serves_a_torn_apply_step_pair",
    "test_predict_step_label_matches_the_apply_that_ran"])
def test_the_references_replica_locking_tests_on_the_port(name, request):
    _call(getattr(REPLICA, name), request)


def _wait(cond, timeout=20.0, what=""):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.05)


def test_the_ports_router_fronts_a_port_replica(tmp_path, monkeypatch):
    """Predicts through the router, a directed reload to step 2 and back
    to step 1, then a drain: the replica finishes, sends its goodbye beat,
    and the router culls it."""
    from horovod_tpu_torch.serve.replica import Replica
    from horovod_tpu_torch.serve.router import Router

    monkeypatch.setenv("HVD_HEARTBEAT_SEC", "0.2")
    monkeypatch.setenv("HVD_SERVE_CKPT_POLL_SEC", "0")
    saved = _save(tmp_path / "ck", "mnist_cnn", [1, 2])
    router = Router(port=0, liveness_sec=30, monitor=False)
    port = router.start()
    replica = Replica(model="mnist_cnn", ckpt_dir=str(tmp_path / "ck"),
                      router="127.0.0.1:%d" % port, replica_id="r0",
                      device="cpu")
    x = np.random.RandomState(5).standard_normal((3, 28, 28, 1)) \
        .astype(np.float32)

    def predict():
        status, doc = _post(port, "/v1/predict", {"inputs": x.tolist()})
        assert status == 200, doc
        module, params = saved[doc["step"]]
        want = np.asarray(module.apply(params, x, train=False))
        got = np.asarray(doc["outputs"], np.float32)
        assert np.abs(got - want).max() <= SERVE_RTOL * np.abs(want).max()
        return doc

    try:
        replica.start()
        assert replica.step == 2
        _wait(lambda: "r0" in router.replicas(), what="registration")
        assert predict()["step"] == 2
        status, doc = _post(replica.port, "/v1/reload", {"step": 1})
        assert status == 200 and doc["step"] == 1
        assert predict()["step"] == 1
        status, doc = _post(replica.port, "/v1/reload", {"step": 9})
        assert status == 500 and doc["step"] == 1
        _wait(lambda: _get(port, "/healthz")[1]["replicas"]["r0"]["step"]
              == 1, what="the heartbeat's step")
        status, doc = _post(port, "/v1/drain", {"replica": "r0"})
        assert status == 200 and doc["replica_notified"] is True
        _wait(lambda: replica._stop.is_set(), what="the drain")
        _wait(lambda: "r0" not in router.replicas(), what="the goodbye")
        status, doc = _post(port, "/v1/predict", {"inputs": x.tolist()})
        assert status in (502, 503), doc
    finally:
        replica.stop()
        router.stop()
