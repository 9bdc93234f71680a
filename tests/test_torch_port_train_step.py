"""Two training steps of the port against the reference, at size 1.

Port: ``DistributedOptimizer(torch.optim.AdamW(lr=1e-3, weight_decay=1e-4))``
under ``init(device="cpu")`` (a gloo group of one; the bucket allreduces
really run). Reference: ``horovod_tpu.jax.DistributedOptimizer(
optax.adamw(1e-3))`` in its size-1 identity path (optax's weight decay
default is 1e-4, torch's is 1e-2, hence the explicit value). The tiny
flagship config with flash attention, fp32; losses and updated params
must agree to 1e-4 relative. Params are compared by the norm of the
difference over the norm of the reference: Adam's first steps move an
element by about lr * g / (|g| + eps), so an element whose gradient is
near eps = 1e-8 turns fp32 rounding noise in g into a visible share of
lr, and the largest single element says more about that element than
about the two optimizers.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax.linen import meta

import __graft_entry__ as graft
import horovod_tpu.jax as hvd_jax
import horovod_tpu_torch as hvd
from horovod_tpu.models import Transformer as JaxTransformer
from horovod_tpu_torch import models as port

TOL = 1e-4
STEPS = 2

_LAUNCHER_ENV = ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
                 "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK",
                 "HOROVOD_CROSS_SIZE", "OMPI_COMM_WORLD_RANK",
                 "OMPI_COMM_WORLD_SIZE", "PMI_RANK", "PMI_SIZE",
                 "SLURM_PROCID", "SLURM_STEP_NUM_TASKS")


@pytest.fixture
def world_of_one(monkeypatch):
    for name in _LAUNCHER_ENV:
        monkeypatch.delenv(name, raising=False)
    hvd.init(device="cpu")
    try:
        yield
    finally:
        hvd.shutdown()


def _rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, meta.unbox(tree))


def _jax_steps(jmodel, params, tokens):
    tx = hvd_jax.DistributedOptimizer(optax.adamw(1e-3))
    opt_state = tx.init(params)

    def loss_fn(p):
        logits = jmodel.apply(p, tokens)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.roll(tokens, -1, axis=1)).mean()

    losses = []
    for _ in range(STEPS):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return losses, params


@pytest.mark.parametrize("bucket_bytes", [None, "0", "4096"])
def test_two_steps_match_reference(world_of_one, monkeypatch, bucket_bytes):
    if bucket_bytes is not None:
        monkeypatch.setenv("HVD_GRAD_BUCKET_BYTES", bucket_bytes)
    jcfg = dataclasses.replace(graft._flagship_config(tiny=True),
                               attention="flash")
    pcfg = port.TransformerConfig(
        vocab_size=jcfg.vocab_size, d_model=jcfg.d_model,
        n_heads=jcfg.n_heads, n_layers=jcfg.n_layers, d_ff=jcfg.d_ff,
        max_seq_len=jcfg.max_seq_len, dtype=torch.float32,
        attention="flash")
    tokens = np.random.RandomState(0).randint(
        0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    jmodel = JaxTransformer(jcfg)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(tokens))
    ref_losses, ref_params = _jax_steps(jmodel, params, jnp.asarray(tokens))

    model = port.Transformer(pcfg, device="cpu")
    model.load_state_dict(port.from_jax_params(_numpy_tree(params), pcfg))
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-3, weight_decay=1e-4))
    ttokens = torch.tensor(tokens, dtype=torch.long)
    losses = []
    for _ in range(STEPS):
        loss = port.lm_loss(model(ttokens), ttokens)
        loss.backward()
        opt.step()
        opt.zero_grad()
        losses.append(loss.item())

    assert opt.buckets_launched == STEPS * len(opt.buckets)
    if bucket_bytes == "0":
        assert len(opt.buckets) == 1
    if bucket_bytes == "4096":
        assert len(opt.buckets) > 1
    np.testing.assert_allclose(losses, ref_losses, rtol=TOL)
    ref = port.from_jax_params(_numpy_tree(ref_params), pcfg)
    for name, p in model.state_dict().items():
        assert _rel_norm(p.numpy(), ref[name].numpy()) < TOL, name


def test_unported_options_raise(world_of_one):
    opt = torch.optim.SGD([torch.nn.Parameter(torch.ones(2))], lr=0.1)
    with pytest.raises(ValueError, match=">= 1"):
        hvd.DistributedOptimizer(opt, backward_passes_per_step=0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        hvd.DistributedOptimizer(opt, op=hvd.Adasum)


# --------------------------------------------- backward_passes_per_step ---

ACC_TOL = 1e-5
MICRO_BATCHES = 4


def _mlp_weights():
    rng = np.random.RandomState(3)
    return {"w1": rng.randn(3, 4).astype(np.float32),
            "b1": rng.randn(4).astype(np.float32),
            "w2": rng.randn(4, 2).astype(np.float32)}


def _micro_batches():
    rng = np.random.RandomState(4)
    return [(rng.randn(5, 3).astype(np.float32),
             rng.randn(5, 2).astype(np.float32))
            for _ in range(MICRO_BATCHES)]


def _mlp_loss(w, x, y, np_like):
    h = np_like.tanh(x @ w["w1"] + w["b1"])
    return ((h @ w["w2"] - y) ** 2).mean()


def _jax_accumulated(k):
    """The reference: ``optax.MultiSteps`` of the allreduce and SGD with
    momentum; params after each micro-batch."""
    tx = hvd_jax.DistributedOptimizer(optax.sgd(0.1, momentum=0.9),
                                      backward_passes_per_step=k)
    params = jax.tree_util.tree_map(jnp.asarray, _mlp_weights())
    state = tx.init(params)
    history = []
    for x, y in _micro_batches():
        grads = jax.grad(_mlp_loss)(params, jnp.asarray(x), jnp.asarray(y),
                                    jnp)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        history.append({n: np.asarray(v) for n, v in params.items()})
    return history


def _port_mlp():
    return {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
            for n, v in _mlp_weights().items()}


@pytest.mark.parametrize("loop", ["step_every_pass", "step_every_k"])
def test_backward_passes_per_step_matches_optax_multisteps(world_of_one,
                                                           loop):
    """k=2 over 4 micro-batches: the update sees the mean of 2
    gradients, and the passes in between leave the weights as they are,
    whether the loop calls step()/zero_grad() after every backward pass
    or once per k."""
    k = 2
    want = _jax_accumulated(k)
    w = _port_mlp()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(list(w.values()), lr=0.1, momentum=0.9),
        backward_passes_per_step=k)
    for i, (x, y) in enumerate(_micro_batches()):
        _mlp_loss(w, torch.from_numpy(x), torch.from_numpy(y),
                  torch).backward()
        if loop == "step_every_pass" or (i + 1) % k == 0:
            opt.step()
            opt.zero_grad()
        for n, p in w.items():
            np.testing.assert_allclose(p.detach().numpy(), want[i][n],
                                       rtol=ACC_TOL, atol=ACC_TOL,
                                       err_msg="%s after %d" % (n, i + 1))
    assert opt.buckets_launched == (MICRO_BATCHES // k) * len(opt.buckets)


def test_backward_passes_per_step_moves_nothing_in_between(world_of_one):
    w = _port_mlp()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(list(w.values()), lr=0.1, momentum=0.9),
        backward_passes_per_step=3)
    x, y = (torch.from_numpy(a) for a in _micro_batches()[0])
    grads = []
    for _ in range(2):
        _mlp_loss(w, x, y, torch).backward()
        grads.append(w["w1"].grad.clone())
        assert opt.step() is None
        opt.zero_grad()
        assert opt.buckets_launched == 0
        assert not opt.optimizer.state
    assert torch.allclose(grads[1], 2 * grads[0])
    for n, p in w.items():
        assert np.array_equal(p.detach().numpy(), _mlp_weights()[n])
    _mlp_loss(w, x, y, torch).backward()
    assert opt.buckets_launched == len(opt.buckets)
    with pytest.raises(RuntimeError, match="4 times"):
        _mlp_loss(w, x, y, torch).backward()


def test_unused_parameter_is_reduced_as_zero(world_of_one):
    """A parameter that gets no gradient is allreduced as zeros, like the
    reference's gradient pytree, so step() never waits on a hook."""
    used = torch.nn.Parameter(torch.ones(3))
    unused = torch.nn.Parameter(torch.ones(3))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([used, unused], lr=0.5))
    (used * 2.0).sum().backward()
    opt.step()
    assert torch.equal(used.detach(), torch.zeros(3))
    assert torch.equal(unused.detach(), torch.ones(3))
    assert torch.equal(unused.grad, torch.zeros(3))


def test_second_backward_before_step_raises(world_of_one):
    w = torch.nn.Parameter(torch.ones(2))
    hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1))
    (w * w).sum().backward()
    with pytest.raises(RuntimeError, match="twice"):
        (w * w).sum().backward()
