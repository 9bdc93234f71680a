"""The port's elastic state, worker and failure mapping, on the CPU.

* The cases of tests/test_torch_elastic.py against the port's
  ``TorchState``, with the port's bucketed ``DistributedOptimizer``, and
  the port's own: a second restore after more training, and the
  checkpoint payload's native state dicts.
* The worker and state cases of tests/test_elastic_resilience.py against
  the port's modules: version fencing, the timeout knob, port negotiation
  and its superseded case, the heartbeat payload, best effort and thread
  survival, and the checkpoint cadence and auto-resume.
* State parity: a narrow transformer converted from the flax reference's
  init with ``from_jax_params`` trains the same steps under the JAX
  package's ``TorchState`` and the port's; the committed tensors, and
  what each checkpoints, are equal. ``CudaState`` and ``TpuState`` on one
  numpy pytree restore equal values.
* Failure mapping (``common/failure.py``): a wait point maps the backend's
  error to ``HorovodInternalError``, and the watch marks the world failed
  when the core stops. At np=2 on gloo (this file, run as a script by two
  processes, is the two ranks) rank 1 exits: rank 0's bucketed step
  raises ``HorovodInternalError``, its watch sees the death while idle,
  and it shuts down and re-inits alone in the same process.
"""

import copy
import http.client
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.linen import meta

import __graft_entry__ as graft
from horovod_tpu.elastic.state import TorchState as JaxTorchState
from horovod_tpu.elastic.state import TpuState
from horovod_tpu.models import Transformer as JaxTransformer
from horovod_tpu.runner.http_server import KVStoreServer

import horovod_tpu_torch as hvd_p
from horovod_tpu_torch import models as port_models
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common import failure
from horovod_tpu_torch.common.exceptions import HorovodInternalError
from horovod_tpu_torch.elastic import state as es
from horovod_tpu_torch.elastic import worker as ew
from horovod_tpu_torch.elastic.state import CudaState, ObjectState, TorchState
from horovod_tpu_torch.torch.elastic import ElasticSampler

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@pytest.fixture(scope="module", autouse=True)
def world():
    """A size-1 world on gloo for the whole module."""
    basics.init(device="cpu")
    yield
    basics.shutdown()


# --- TorchState (tests/test_torch_elastic.py) --------------------------------

def _tiny_model():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.ReLU(),
                               torch.nn.Linear(3, 1))


def _train_step(model, optimizer):
    optimizer.zero_grad()
    loss = model(torch.ones(2, 4)).sum()
    loss.backward()
    optimizer.step()


def test_commit_restore_rolls_back_model_and_optimizer():
    model = _tiny_model()
    optimizer = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    state = TorchState(model=model, optimizer=optimizer, epoch=3, batch=7)
    _train_step(model, optimizer)  # momentum buffers now exist
    state.commit()
    committed = {k: v.clone() for k, v in model.state_dict().items()}
    committed_mom = [optimizer.state[p]["momentum_buffer"].clone()
                     for p in model.parameters()]
    for _ in range(3):
        _train_step(model, optimizer)
    state.epoch, state.batch = 9, 0
    assert any(not torch.equal(v, committed[k])
               for k, v in model.state_dict().items())
    state.restore()
    for k, v in model.state_dict().items():
        assert torch.equal(v, committed[k]), k
    for p, saved in zip(model.parameters(), committed_mom):
        assert torch.equal(optimizer.state[p]["momentum_buffer"], saved)
    assert state.epoch == 3 and state.batch == 7


def test_a_second_restore_still_gives_the_commit():
    """The optimizer loads a copy of the snapshot: AdamW updates its
    moments and step count in place, and a restore that handed it the
    snapshot itself would let the next step change what a second restore
    gives back."""
    model = _tiny_model()
    optimizer = torch.optim.AdamW(model.parameters(), lr=0.1)
    state = TorchState(model=model, optimizer=optimizer, step=0)
    _train_step(model, optimizer)
    state.commit()
    committed = copy.deepcopy(optimizer.state_dict())
    for _ in range(2):
        state.restore()
        _train_step(model, optimizer)
    state.restore()
    got = optimizer.state_dict()["state"]
    for pid, entries in committed["state"].items():
        for key, value in entries.items():
            assert torch.equal(got[pid][key], value), (pid, key)


def test_restore_without_commit_uses_constructor_snapshot():
    state = TorchState(epoch=1, batch=2)
    state.epoch = 50
    state.restore()
    assert state.epoch == 1 and state.batch == 2


def test_reset_callbacks_fire_once_per_reset():
    state = TorchState(epoch=0)
    calls = []
    state.register_reset_callbacks([lambda: calls.append("a"),
                                    lambda: calls.append("b")])
    state.on_reset()
    assert calls == ["a", "b"]
    state.on_reset()
    assert calls == ["a", "b", "a", "b"]


def test_new_attributes_commit_after_registration():
    state = TorchState(step=0)
    state.step = 5
    state.extra = "post-construction"
    state.commit()
    state.step = 11
    state.extra = "mutated"
    state.restore()
    assert state.step == 5
    assert state.extra == "mutated"


def test_torch_state_with_sampler_reshards():
    sampler = ElasticSampler(list(range(12)), shuffle=False)
    sampler.set_epoch(0)
    state = TorchState(sampler=sampler, batch=0)
    first = list(sampler)[:2]
    sampler.record_batch(0, 2)
    state.commit()
    sampler.record_batch(1, 2)
    assert len(sampler.processed_indices) == 4
    state.restore()
    assert len(sampler.processed_indices) == 2
    assert first == [0, 1]


def test_restore_drops_the_bucketed_optimizers_flights():
    """A failure between backward and step leaves launched buckets and
    accumulated gradients of the old world: restore drops both, so the
    next step runs clean (without it the next backward would count a
    second accumulation and raise)."""
    model = _tiny_model()
    opt = hvd_p.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=0.1))
    state = TorchState(model=model, optimizer=opt, step=0)
    _train_step(model, opt)
    state.commit()
    committed = {k: v.clone() for k, v in model.state_dict().items()}
    model(torch.ones(2, 4)).sum().backward()  # buckets launch, no step
    assert opt.buckets_launched > len(opt.buckets)
    state.restore()
    assert all(p.grad is None for p in model.parameters())
    for k, v in model.state_dict().items():
        assert torch.equal(v, committed[k])
    _train_step(model, opt)
    assert opt.state_dict()["state"]


class _StubCheckpointer:
    """Duck-types utils/checkpoint.Checkpointer in memory."""

    def __init__(self):
        self.saved = {}
        self.fail_steps = set()

    def save(self, step, payload, force=False):
        self.saved[int(step)] = copy.deepcopy(payload)
        return True

    def restore(self, step=None, template=None):
        if step is None:
            step = self.latest_step()
        if step in self.fail_steps:
            raise IOError("simulated torn checkpoint at step %d" % step)
        return self.saved[int(step)]

    def latest_step(self):
        return max(self.saved) if self.saved else None

    def all_steps(self):
        return sorted(self.saved)


def test_checkpointer_persists_and_restores_model_and_optimizer():
    ck = _StubCheckpointer()
    model = _tiny_model()
    optimizer = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    state = TorchState(model=model, optimizer=optimizer, step=0,
                       checkpointer=ck)
    _train_step(model, optimizer)
    state.step = 3
    state.commit()
    committed = {k: v.clone() for k, v in model.state_dict().items()}
    payload = ck.saved[3]
    assert payload["state"]["step"] == 3
    # Natively: the port's Checkpointer writes torch files.
    assert set(payload["model"]) == set(committed)
    assert payload["optimizer"]["state"]
    model2 = _tiny_model()
    _train_step(model2, torch.optim.SGD(model2.parameters(), lr=0.5))
    optimizer2 = torch.optim.SGD(model2.parameters(), lr=0.1, momentum=0.9)
    fresh = TorchState(model=model2, optimizer=optimizer2, step=0,
                       checkpointer=ck)
    assert fresh._maybe_auto_resume() == 3
    assert fresh.step == 3
    for k, v in model2.state_dict().items():
        assert torch.equal(v, committed[k])
    assert optimizer2.state_dict()["state"]


def test_checkpoint_carries_the_samplers_progress(tmp_path):
    """Through the port's real Checkpointer: a cold resume continues the
    epoch where the commit left it."""
    from horovod_tpu_torch.utils.checkpoint import Checkpointer

    ck = Checkpointer(str(tmp_path / "c"))
    sampler = ElasticSampler(list(range(20)), shuffle=True, seed=1)
    model = _tiny_model()
    state = TorchState(model=model, sampler=sampler, step=0,
                       checkpointer=ck)
    sampler.record_batch(0, 4)
    state.step = 1
    state.commit()
    fresh_sampler = ElasticSampler(list(range(20)), shuffle=True, seed=1)
    fresh = TorchState(model=_tiny_model(), sampler=fresh_sampler, step=0,
                       checkpointer=ck)
    assert fresh._maybe_auto_resume() == 1
    assert fresh_sampler.processed_indices == sampler.processed_indices
    sampler.reset()  # what the committing process would reshard to
    assert fresh_sampler.indices == sampler.indices
    assert len(fresh_sampler) == 16


# --- version fencing, port negotiation, heartbeats ---------------------------
# (tests/test_elastic_resilience.py:207-376, against the port's worker)

@pytest.fixture
def kv(monkeypatch):
    server = KVStoreServer()
    server.start()
    monkeypatch.setenv("HOROVOD_RENDEZVOUS_ADDR", "127.0.0.1")
    monkeypatch.setenv("HOROVOD_RENDEZVOUS_PORT", str(server.port))
    yield server
    server.stop()


def test_poll_meta_fences_stale_versions(kv):
    kv.put("control", "meta", json.dumps(
        {"version": 3, "controller_addr": "x"}).encode())
    with pytest.raises(HorovodInternalError):
        ew._poll_meta(min_version=5, timeout=1.5)
    kv.put("control", "meta", json.dumps(
        {"version": 5, "controller_addr": "x"}).encode())
    assert ew._poll_meta(min_version=5, timeout=5)["version"] == 5


def test_poll_meta_honors_elastic_timeout_knob(kv, monkeypatch):
    monkeypatch.setenv("HOROVOD_ELASTIC_TIMEOUT", "1")
    t0 = time.time()
    with pytest.raises(HorovodInternalError):
        ew._poll_meta(min_version=1)
    assert time.time() - t0 < 10


def test_controller_port_negotiation(kv, monkeypatch):
    monkeypatch.setenv("HOROVOD_RENDEZVOUS_VERSION", "7")
    monkeypatch.setenv("HOROVOD_CONTROLLER_PORT", "0")
    chosen = ew.negotiate_controller_port(rank=0)
    assert chosen > 0
    assert os.environ["HOROVOD_CONTROLLER_PORT"] == str(chosen)
    assert kv.get("control", "controller_port.7") == str(chosen).encode()
    monkeypatch.setenv("HOROVOD_CONTROLLER_PORT", "0")
    assert ew.negotiate_controller_port(rank=1, timeout=5) == chosen
    assert os.environ["HOROVOD_CONTROLLER_PORT"] == str(chosen)


def test_controller_port_wait_superseded(kv, monkeypatch):
    monkeypatch.setenv("HOROVOD_RENDEZVOUS_VERSION", "2")
    kv.put("control", "meta", json.dumps({"version": 3}).encode())
    t0 = time.time()
    with pytest.raises(HorovodInternalError, match="superseded"):
        ew.negotiate_controller_port(rank=1, timeout=30)
    assert time.time() - t0 < 10


def test_init_negotiates_the_port_under_the_elastic_driver(monkeypatch):
    """The elastic env with port 0 sends ``init`` through the
    negotiation; without it, or with a real port, it does not."""
    monkeypatch.setenv("HOROVOD_CONTROLLER_PORT", "0")
    assert not basics._negotiated_port()
    monkeypatch.setenv("HOROVOD_ELASTIC", "1")
    monkeypatch.setenv("HOROVOD_RENDEZVOUS_ADDR", "127.0.0.1")
    assert basics._negotiated_port()
    monkeypatch.setenv("HOROVOD_CONTROLLER_PORT", "29500")
    assert not basics._negotiated_port()


def test_worker_heartbeat_put_and_payload(kv, monkeypatch):
    monkeypatch.setenv("HOROVOD_SLOT_KEY", "localhost:1")
    monkeypatch.setenv("HOROVOD_RENDEZVOUS_VERSION", "3")
    before = es.commit_count()
    ObjectState(step=0).commit()
    assert ew.send_heartbeat() is True
    payload = json.loads(kv.get("heartbeat", "localhost:1").decode())
    assert sorted(payload) == ["commits", "pid", "ts", "version"]
    assert payload["version"] == 3
    assert payload["pid"] == os.getpid()
    assert payload["ts"] <= time.time()
    assert payload["commits"] == before + 1


def test_worker_heartbeat_best_effort_without_env(monkeypatch):
    monkeypatch.delenv("HOROVOD_RENDEZVOUS_ADDR", raising=False)
    monkeypatch.delenv("HOROVOD_SLOT_KEY", raising=False)
    assert ew.send_heartbeat() is False
    assert ew.start_heartbeats() is None


def test_heartbeat_thread_survives_exceptions(kv, monkeypatch):
    monkeypatch.setenv("HOROVOD_SLOT_KEY", "localhost:9")
    monkeypatch.setenv("HVD_HEARTBEAT_SEC", "0.05")
    calls = {"n": 0}
    real = ew.send_heartbeat_ex

    def flaky():
        calls["n"] += 1
        if calls["n"] <= 2:
            raise http.client.HTTPException("garbled KV response")
        return real()

    monkeypatch.setattr(ew, "send_heartbeat_ex", flaky)
    thread = ew.start_heartbeats()
    assert thread is not None
    deadline = time.time() + 10
    while (time.time() < deadline
           and kv.get("heartbeat", "localhost:9") is None):
        time.sleep(0.05)
    assert thread.is_alive()
    assert calls["n"] >= 3
    assert kv.get("heartbeat", "localhost:9") is not None


def test_heartbeat_defers_a_shed_beat(monkeypatch):
    """A typed 503 with Retry-After is a deferral, not a failure."""
    monkeypatch.setenv("HOROVOD_RENDEZVOUS_ADDR", "127.0.0.1")
    monkeypatch.setenv("HOROVOD_RENDEZVOUS_PORT", "1")
    monkeypatch.setenv("HOROVOD_SLOT_KEY", "localhost:2")
    monkeypatch.setattr(ew, "put_kv", lambda *a, **k: (503, 0.25))
    assert ew.send_heartbeat_ex() == (False, 0.25)


def test_check_host_updates_is_version_fenced(kv, monkeypatch):
    from horovod_tpu_torch.common.exceptions import HostsUpdatedInterrupt

    monkeypatch.setenv("HOROVOD_RENDEZVOUS_VERSION", "4")
    state = ObjectState(step=0)
    kv.put("control", "meta", json.dumps({"version": 3}).encode())
    state.commit()  # older than ours: a stale driver's, ignored
    kv.put("control", "meta", json.dumps({"version": 5}).encode())
    with pytest.raises(HostsUpdatedInterrupt):
        state.commit()
    state.commit()  # version 5 adopted: no second interrupt
    assert es.current_rendezvous_version() == 5


# --- checkpoint cadence and auto-resume (resilience :591-714) ----------------

def _fresh_state(ck, interval=1, **kwargs):
    return ObjectState(checkpointer=ck, checkpoint_interval=interval,
                       **kwargs)


def test_commit_persists_every_nth_commit():
    ck = _StubCheckpointer()
    state = _fresh_state(ck, interval=3, step=0, loss=0.0)
    for i in range(1, 10):
        state.step = i
        state.commit()
    assert sorted(ck.saved) == [3, 6, 9]
    assert ck.saved[9]["state"]["step"] == 9


def test_auto_resume_restores_latest_committed_step():
    ck = _StubCheckpointer()
    old = _fresh_state(ck, step=0, w=1.5)
    old.step, old.w = 7, 99.5
    old.commit()
    fresh = _fresh_state(ck, step=0, w=0.0)
    assert fresh._maybe_auto_resume() == 7
    assert fresh.step == 7 and fresh.w == 99.5
    fresh.step = 11
    fresh.save()
    assert fresh._maybe_auto_resume() is None
    assert fresh.step == 11


def test_auto_resume_falls_back_one_step():
    ck = _StubCheckpointer()
    old = _fresh_state(ck, step=0)
    for s in (5, 6):
        old.step = s
        old.commit()
    ck.fail_steps.add(6)
    fresh = _fresh_state(ck, step=0)
    assert fresh._maybe_auto_resume() == 5
    assert fresh.step == 5


def test_auto_resume_without_checkpoints_is_noop():
    ck = _StubCheckpointer()
    fresh = _fresh_state(ck, step=3)
    assert fresh._maybe_auto_resume() is None
    assert fresh.step == 3
    plain = ObjectState(step=4)
    assert plain._maybe_auto_resume() is None
    plain.commit()


def test_apply_checkpoint_ignores_unknown_keys():
    ck = _StubCheckpointer()
    ck.saved[3] = {"state": {"step": 3, "evil_new_attr": 1}}
    fresh = _fresh_state(ck, step=0)
    assert fresh._maybe_auto_resume() == 3
    assert fresh.step == 3
    assert not hasattr(fresh, "evil_new_attr")


def test_checkpoint_cadence_is_step_keyed_across_respawns():
    ck_survivor, ck_respawn = _StubCheckpointer(), _StubCheckpointer()
    survivor = _fresh_state(ck_survivor, interval=2, step=0)
    for s in (1, 2, 3):
        survivor.step = s
        survivor.commit()
    assert sorted(ck_survivor.saved) == [2]
    respawn = _fresh_state(ck_respawn, interval=2, step=0)
    respawn.step = 4
    survivor.step = 4
    respawn.commit()
    survivor.commit()
    assert sorted(ck_survivor.saved) == [2, 4]
    assert sorted(ck_respawn.saved) == [4]


def test_failed_save_is_swallowed():
    class _Boom(_StubCheckpointer):
        def save(self, step, payload, force=False):
            raise IOError("disk full")

    state = _fresh_state(_Boom(), step=0)
    state.step = 1
    state.commit()  # must not raise


def test_auto_resume_falls_back_when_apply_fails():
    class _Picky(ObjectState):
        def _apply_checkpoint(self, payload):
            if "poison" in payload:
                raise ValueError("schema drift")
            super()._apply_checkpoint(payload)

    ck = _StubCheckpointer()
    old = _Picky(checkpointer=ck, step=0)
    for s in (5, 6):
        old.step = s
        old.commit()
    ck.saved[6]["poison"] = True
    fresh = _Picky(checkpointer=ck, step=0)
    assert fresh._maybe_auto_resume() == 5
    assert fresh.step == 5


# --- state parity with the JAX package ---------------------------------------

def _narrow_transformer():
    """The flax reference's tiny flagship config, converted."""
    jcfg = graft._flagship_config(tiny=True)
    pcfg = port_models.TransformerConfig(
        vocab_size=jcfg.vocab_size, d_model=jcfg.d_model,
        n_heads=jcfg.n_heads, n_layers=jcfg.n_layers, d_ff=jcfg.d_ff,
        max_seq_len=jcfg.max_seq_len, dtype=torch.float32,
        attention="dense")
    tokens = np.random.RandomState(0).randint(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    params = JaxTransformer(jcfg).init(jax.random.PRNGKey(1),
                                       jnp.asarray(tokens))
    tree = jax.tree_util.tree_map(np.asarray, meta.unbox(params))
    weights = port_models.from_jax_params(tree, pcfg)

    def build():
        model = port_models.Transformer(pcfg, device="cpu")
        model.load_state_dict(weights)
        return model, torch.optim.AdamW(model.parameters(), lr=1e-2,
                                        weight_decay=1e-4)

    return build, pcfg


def _state_dicts_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        elif isinstance(a[k], dict):
            _state_dicts_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


def test_state_parity_with_the_jax_torch_state():
    build, cfg = _narrow_transformer()
    (jm, jo), (pm, po) = build(), build()
    ck_j, ck_p = _StubCheckpointer(), _StubCheckpointer()
    jstate = JaxTorchState(model=jm, optimizer=jo, step=0, checkpointer=ck_j)
    pstate = TorchState(model=pm, optimizer=po, step=0, checkpointer=ck_p)
    gen = torch.Generator().manual_seed(3)
    for step in range(1, 4):
        tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
        for model, opt, state in ((jm, jo, jstate), (pm, po, pstate)):
            opt.zero_grad()
            port_models.lm_loss(model(tokens), tokens).backward()
            opt.step()
            state.step = step
            state.commit()
        _state_dicts_equal(jstate._saved_model, pstate._saved_model)
        _state_dicts_equal(jstate._saved_optimizer["state"],
                           pstate._saved_optimizer["state"])
    # What each checkpoints: the JAX state's torch blob and the port's
    # native state dicts hold the same tensors.
    blob = torch.load(io.BytesIO(np.asarray(ck_j.saved[3]["torch"]).tobytes()),
                      map_location="cpu", weights_only=True)
    _state_dicts_equal(blob["model"], ck_p.saved[3]["model"])
    _state_dicts_equal(blob["optimizer"]["state"],
                       ck_p.saved[3]["optimizer"]["state"])
    assert ck_j.saved[3]["state"] == ck_p.saved[3]["state"] == {"step": 3}
    # And both roll back to the same commit.
    for model, opt, state in ((jm, jo, jstate), (pm, po, pstate)):
        opt.zero_grad()
        tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
        port_models.lm_loss(model(tokens), tokens).backward()
        opt.step()
        state.restore()
    _state_dicts_equal(jm.state_dict(), pm.state_dict())
    _state_dicts_equal(jo.state_dict()["state"], po.state_dict()["state"])


def test_cuda_state_and_tpu_state_restore_equal_values():
    rng = np.random.RandomState(0)
    tree = {"w": rng.randn(3, 4).astype(np.float32),
            "layers": [rng.randn(5).astype(np.float16),
                       (np.arange(6, dtype=np.int32),)]}
    tpu = TpuState(params=jax.tree_util.tree_map(jnp.asarray, tree),
                   epoch=2)
    cuda = CudaState(params={"w": torch.from_numpy(tree["w"].copy()),
                             "layers": [torch.from_numpy(tree["layers"][0]),
                                        (torch.from_numpy(
                                            tree["layers"][1][0]),)]},
                     epoch=2)
    for s in (tpu, cuda):
        s.commit()
    tpu.params = jax.tree_util.tree_map(lambda x: x * 0 + 7, tpu.params)
    tpu.epoch = 9
    cuda.params["w"].mul_(0).add_(7)  # in place: the snapshot must not move
    cuda.params["layers"][1][0].fill_(7)
    cuda.epoch = 9
    for s in (tpu, cuda):
        s.restore()
    assert tpu.epoch == cuda.epoch == 2
    np.testing.assert_array_equal(cuda.params["w"].numpy(),
                                  np.asarray(tpu.params["w"]))
    np.testing.assert_array_equal(cuda.params["layers"][0].numpy(),
                                  np.asarray(tpu.params["layers"][0]))
    np.testing.assert_array_equal(cuda.params["layers"][1][0].numpy(),
                                  np.asarray(tpu.params["layers"][1][0]))
    assert cuda.params["layers"][0].dtype == torch.float16
    assert isinstance(cuda.params["layers"][1], tuple)
    np.testing.assert_array_equal(cuda.params["w"].numpy(), tree["w"])


def test_cuda_state_rolls_back_before_its_first_commit():
    x = torch.arange(4.0)
    state = CudaState(x=x, step=0)
    x.add_(10)
    state.restore()
    assert torch.equal(state.x, torch.arange(4.0))


# --- failure mapping, generation ---------------------------------------------

def test_init_generation_and_shared_world():
    gen = basics.init_generation()
    assert gen >= 1
    assert basics.is_shared_world() is False  # size 1
    assert basics.init_device() == "cpu"


class _Idle:
    """A core that never stops, for a watch of the test's own."""

    def running(self):
        return True


def test_mapped_turns_a_backend_error_into_horovod_internal_error(
        monkeypatch):
    watch = failure.Watch(_Idle())
    aborted = []
    monkeypatch.setattr(failure, "abort_groups", lambda: aborted.append(1))
    monkeypatch.setattr(basics, "watch", lambda: watch)
    with pytest.raises(HorovodInternalError, match="Connection reset"):
        with failure.mapped():
            raise RuntimeError("Read error: Connection reset by peer")
    assert aborted == [1] and "Connection reset" in watch.failed
    with pytest.raises(HorovodInternalError):  # the world stays failed
        with failure.mapped():
            pass
    with pytest.raises(HorovodInternalError):
        es.ObjectState(step=0).commit()
    watch.stop()
    healthy = failure.Watch(_Idle())
    monkeypatch.setattr(basics, "watch", lambda: healthy)
    with pytest.raises(ValueError):  # not the backend's: passes through
        with failure.mapped():
            raise ValueError("bad argument")
    assert healthy.failed is None
    healthy.stop()


def test_the_watch_fails_the_world_when_the_core_stops(monkeypatch):
    class _Core:
        alive = True

        def running(self):
            return self.alive

    aborted = []
    monkeypatch.setattr(failure, "abort_groups", lambda: aborted.append(1))
    core = _Core()
    watch = failure.Watch(core)
    try:
        time.sleep(3 * failure.POLL_SEC)
        assert watch.failed is None and not aborted
        t0 = time.monotonic()
        core.alive = False
        deadline = time.time() + 5
        while watch.failed is None and time.time() < deadline:
            time.sleep(0.01)
        assert watch.failed is not None and aborted == [1]
        assert watch.failed_at - t0 < 1.0
        with pytest.raises(HorovodInternalError):
            watch.check()
    finally:
        watch.stop()


def test_a_dead_peer_raises_horovod_internal_error_np2(tmp_path):
    """Rank 1 exits after one bucketed step. Rank 0's watch marks the
    world failed while it is idle, its next bucketed step raises
    ``HorovodInternalError``, and it shuts down and re-inits alone."""
    init_file = str(tmp_path / "rendezvous")
    out = str(tmp_path / "rank0.json")
    procs = []
    for rank in range(2):
        # A peer that dies with unread data resets its connections, and
        # the core then tries to reconnect for HVD_WIRE_RECONNECT_SEC
        # (default 30 s) before it gives the peer up: that budget bounds
        # the detection.
        env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE="2",
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE="2",
                   HVD_WIRE_RECONNECT_SEC="2",
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), init_file, out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=120)[0].decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert procs[1].returncode == 17, logs[1]
    assert procs[0].returncode == 0, logs[0]
    with open(out) as f:
        got = json.load(f)
    assert got["watch_failed"] and got["raised"] == "HorovodInternalError"
    assert got["detect_sec"] < 2.0 + 3.0, got
    assert got["raise_sec"] < 1.0, got
    assert got["reinit_size"] == 1 and got["reinit_generation"] == 2
    assert got["reinit_allreduce"] == 2.0


def _worker_main(init_file, out_path):
    import horovod_tpu_torch.torch as hvd_t

    basics.init(device="cpu", init_method="file://" + init_file)
    model = _tiny_model()
    opt = hvd_p.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                     lr=0.1))
    _train_step(model, opt)
    hvd_t.allreduce(torch.ones(1), name="before")
    if basics.rank() == 1:
        os._exit(17)
    # Rank 0, idle: the core sees the peer's death, the watch fails the
    # world and aborts its groups.
    t0 = time.monotonic()
    watch = basics.watch()
    while watch.failed is None and time.monotonic() - t0 < 10:
        time.sleep(0.01)
    result = {"watch_failed": watch.failed,
              "detect_sec": (watch.failed_at or t0 + 99) - t0}
    t1 = time.monotonic()
    try:
        _train_step(model, opt)
        result["raised"] = None
    except HorovodInternalError as e:
        result["raised"] = type(e).__name__
    result["raise_sec"] = time.monotonic() - t1
    basics.shutdown()
    os.environ.update(HOROVOD_RANK="0", HOROVOD_SIZE="1",
                      HOROVOD_LOCAL_SIZE="1")
    basics.init(device="cpu")
    result["reinit_size"] = basics.size()
    result["reinit_generation"] = basics.init_generation()
    result["reinit_allreduce"] = float(
        hvd_p.allreduce(torch.full((1,), 2.0))[0])
    basics.shutdown()
    with open(out_path, "w") as f:
        json.dump(result, f)


if __name__ == "__main__":
    _worker_main(sys.argv[1], sys.argv[2])
