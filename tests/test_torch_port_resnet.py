"""The port's ResNet against the flax ResNet, on the CPU.

Both models get the same weights (flax's init, with every batch-norm
scale, bias and running statistic then redrawn from a seed, so that no
zero-initialised scale hides a block's gradient) through
``resnet_from_jax_variables``, and the same NHWC/NCHW images from a
numpy seed. The port's fp32 train-mode logits, updated running
statistics and every parameter's loss gradient agree elementwise with
the flax model's within 1e-4 of the tensor's largest magnitude
(``_close``). The flax side runs in float64 (``jax.enable_x64``), the
exact value of the same math, so the tolerance measures the port's
rounding alone. The inputs are batch 8 at 32px, seeds 0-3, where the
port's fp32 gradients stay within 3.05e-5 of float64
(``tools/port_numerics.py``). Other draws are ill-conditioned in fp32:
at batch 2, 32px ResNet-18's last batch norm sees 2 values a channel,
and the fp32 gradients of the port and of XLA alike stray from float64
by 1e-2 to O(1); and on some draws torch's oneDNN convolutions on the
CPU lose precision (ResNet-18, batch 8, 64px, seed 0: 1.9% with oneDNN,
7e-6 without). One pair of
``optax.sgd(0.05, momentum=0.9)`` steps matches ``torch.optim.SGD`` under
``DistributedOptimizer`` at size 1 (gloo), and the parity traps each
have a test that the naive torch version fails.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax

import horovod_tpu.jax as hvd_jax
import horovod_tpu_torch as hvd
from horovod_tpu import models as jax_models
from horovod_tpu_torch import models as port
from horovod_tpu_torch.models import resnet as port_resnet
from horovod_tpu_torch.sync_batch_norm import BatchNorm

TOL = 1e-4
# bf16 compute on both sides: each conv rounds its inputs and output to
# bf16 (8 significant bits), each batch norm divides that rounding by
# the channel's spread, and the two sides round in different places.
# Against the float64 logits both stray by 1.6-4.0% of the largest
# logit at batch 4, 64px, and from each other by up to 3.7% (seeds 0-2,
# both configurations; tools/port_numerics.py); 8% is twice that.
BF16_TOL = 8e-2
N_CLASSES = 10

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


def _flax(which, jdtype):
    if which == "resnet18":
        return jax_models.ResNet18(num_classes=N_CLASSES, dtype=jdtype)
    return jax_models.ResNet(stage_sizes=[1, 1, 1, 1], num_filters=8,
                             num_classes=N_CLASSES, dtype=jdtype)


def _port_model(which, dtype, **kw):
    if which == "resnet18":
        return port.ResNet18(num_classes=N_CLASSES, dtype=dtype,
                             device="cpu", **kw)
    return port.ResNet([1, 1, 1, 1], num_filters=8, num_classes=N_CLASSES,
                       dtype=dtype, device="cpu", **kw)


def _inputs(batch=8, px=32, seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randn(batch, px, px, 3).astype(np.float32)
    labels = rng.randint(0, N_CLASSES, size=batch)
    return images, labels


def _variables(which, images, seed=1):
    """flax's init, then every batch-norm leaf redrawn: scales near 1,
    biases and means near 0, variances positive."""
    variables = jax.tree_util.tree_map(np.asarray, _flax(
        which, jnp.float32).init(jax.random.PRNGKey(0), jnp.asarray(images),
                                 train=True))
    rng = np.random.RandomState(seed)

    def redraw(path, leaf):
        key = path[-1].key
        if key == "scale":
            return (1.0 + 0.2 * rng.randn(*leaf.shape)).astype(np.float32)
        if key in ("bias", "mean") and leaf.ndim == 1:
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        if key == "var":
            return (0.5 + rng.rand(*leaf.shape)).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(redraw, variables)


def _nchw(images):
    return torch.from_numpy(images.transpose(0, 3, 1, 2).copy())


def _close(got, want, tol=TOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _as_np(tree, dtype=None):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), tree)


def _reference(which, variables, images, labels):
    """flax's train-mode loss, logits, updated batch stats and gradients,
    in float64."""
    with jax.enable_x64(True):
        return _jax_train(_flax(which, jnp.float64),
                          _as_np(variables, np.float64),
                          images.astype(np.float64), labels)


def _jax_train(jmodel, variables, images, labels):
    def loss_fn(params):
        logits, upd = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(images), train=True, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean()
        return loss, (logits, upd["batch_stats"])

    (loss, (logits, stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    return float(loss), np.asarray(logits), _as_np(stats), _as_np(grads)


def _port(model, variables):
    model.load_state_dict(port.resnet_from_jax_variables(variables, model))
    return model


@pytest.mark.parametrize("which", ["resnet18", "bottleneck"])
def test_train_mode_matches_flax(which):
    model = _port_model(which, torch.float32)
    images, labels = _inputs()
    variables = _variables(which, images)
    loss, logits, stats, grads = _reference(which, variables, images,
                                            labels)
    _port(model, variables).train()
    out = model(_nchw(images))
    got_loss = F.cross_entropy(out, torch.from_numpy(labels))
    got_loss.backward()
    _close(out.detach().numpy(), logits, what="logits")
    assert abs(got_loss.item() - loss) <= TOL * abs(loss)
    want_stats = port.resnet_from_jax_variables(
        {"params": variables["params"], "batch_stats": stats}, model)
    want_grads = port.resnet_from_jax_variables(
        {"params": grads, "batch_stats": stats}, model)
    buffers = dict(model.named_buffers())
    assert len(buffers) > 0
    for name, buf in buffers.items():
        _close(buf.numpy(), want_stats[name].numpy(), what=name)
    for name, p in model.named_parameters():
        _close(p.grad.numpy(), want_grads[name].numpy(), what=name)


@pytest.mark.parametrize("which", ["resnet18", "bottleneck"])
def test_eval_mode_matches_flax(which):
    model = _port_model(which, torch.float32)
    images, _ = _inputs(seed=3)
    variables = _variables(which, images)
    with jax.enable_x64(True):
        want = _flax(which, jnp.float64).apply(
            _as_np(variables, np.float64), images.astype(np.float64),
            train=False)
    _port(model, variables).eval()
    with torch.no_grad():
        got = model(_nchw(images))
    _close(got.numpy(), np.asarray(want), what="eval logits")
    assert torch.equal(model.bn_init.mean,
                       torch.from_numpy(variables["batch_stats"]["bn_init"]
                                        ["mean"]))


@pytest.mark.parametrize("which", ["resnet18", "bottleneck"])
def test_bf16_logits_match_flax(which):
    model = _port_model(which, torch.bfloat16)
    images, labels = _inputs(batch=4, px=64)
    variables = _variables(which, images)
    _, logits, _, _ = _jax_train(_flax(which, jnp.bfloat16), variables,
                                 images, labels)
    _port(model, variables).train()
    out = model(_nchw(images))
    assert out.dtype == torch.float32
    _close(out.detach().numpy(), logits, tol=BF16_TOL, what="bf16 logits")


@pytest.mark.parametrize("which", ["resnet18", "bottleneck"])
def test_sgd_momentum_steps_match_optax(world_of_one, which):
    """Two steps, so the second runs on the momentum buffer. After each,
    the running statistics and each parameter's change since the start
    equal flax + optax's (the change, scaled by its own largest element:
    both sides start from the same weights, and a step of lr 0.05 moves
    some weights by more than their size)."""
    model = _port_model(which, torch.float32)
    images, labels = _inputs(seed=1)
    variables = _variables(which, images)
    _port(model, variables).train()
    tx = hvd_jax.DistributedOptimizer(optax.sgd(0.05, momentum=0.9))
    params, stats = variables["params"], variables["batch_stats"]
    with jax.enable_x64(True):
        opt_state = tx.init(_as_np(params, np.float64))
    opt = hvd.DistributedOptimizer(torch.optim.SGD(
        model.parameters(), lr=0.05, momentum=0.9))
    start = {n: p.detach().numpy().copy()
             for n, p in model.named_parameters()}
    for _ in range(2):
        _, _, stats, grads = _reference(
            which, {"params": params, "batch_stats": stats}, images, labels)
        with jax.enable_x64(True):
            updates, opt_state = tx.update(grads, opt_state,
                                           _as_np(params, np.float64))
            params = _as_np(optax.apply_updates(
                _as_np(params, np.float64), updates))
        F.cross_entropy(model(_nchw(images)),
                        torch.from_numpy(labels)).backward()
        opt.step()
        opt.zero_grad()
        want = port.resnet_from_jax_variables(
            {"params": params, "batch_stats": stats}, model)
        for name, t in model.state_dict().items():
            if name in start:
                _close(t.numpy() - start[name], want[name].numpy()
                       - start[name], what=name)
            else:
                _close(t.numpy(), want[name].numpy(), what=name)
    assert opt.buckets_launched == 2 * len(opt.buckets)


def test_remat_matches_plain_and_updates_stats_once():
    plain = _port_model("bottleneck", torch.float32)
    remat = _port_model("bottleneck", torch.float32, remat=True)
    remat.load_state_dict(plain.state_dict())
    x = _nchw(_inputs(seed=6)[0])
    for m in (plain, remat):
        m(x).square().sum().backward()
    for (name, a), b in zip(plain.state_dict().items(),
                            remat.state_dict().values()):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-7), name
    for (name, a), b in zip(plain.named_parameters(), remat.parameters()):
        assert torch.allclose(a.grad, b.grad, rtol=1e-5, atol=1e-7), name


def test_resnet50_parameter_count_and_names_match_flax():
    jmodel = jax_models.ResNet50(num_classes=1000, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    n_flax = sum(int(np.prod(s.shape))
                 for s in jax.tree_util.tree_leaves(shapes["params"]))
    model = port.ResNet50(num_classes=1000, dtype=torch.float32,
                          device="cpu")
    assert sum(p.numel() for p in model.parameters()) == n_flax == 25557032
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    converted = port.resnet_from_jax_variables(zeros, model)
    assert list(converted) == list(model.state_dict())
    with pytest.raises(ValueError, match="missing"):
        del zeros["params"]["Dense_0"]
        port.resnet_from_jax_variables(zeros, model)


@pytest.mark.parametrize("px", [8, 9, 32])
def test_stride2_same_padding_matches_flax_not_torch_padding_1(px):
    """On an even input flax's SAME pads (0, 1) for a 3x3 stride-2 conv
    and the 3x3 stride-2 max pool; torch's padding=1 pads (1, 1)."""
    rng = np.random.RandomState(px)
    x = rng.randn(2, px, px, 4).astype(np.float32)
    conv = nn.Conv(5, (3, 3), (2, 2), use_bias=False)
    variables = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(conv.apply(variables, jnp.asarray(x)))
    mine = port_resnet.Conv(4, 5, 3, 2, dtype=torch.float32)
    with torch.no_grad():
        mine.weight.copy_(torch.from_numpy(np.asarray(
            variables["params"]["kernel"]).transpose(3, 2, 0, 1).copy()))
        got = mine(_nchw(x)).permute(0, 2, 3, 1).numpy()
        naive = F.conv2d(_nchw(x), mine.weight, stride=2, padding=1
                         ).permute(0, 2, 3, 1).numpy()
    _close(got, want, what="conv SAME")
    pool_want = np.asarray(nn.max_pool(jnp.asarray(x), (3, 3), (2, 2),
                                       "SAME"))
    pool_got = F.max_pool2d(port_resnet._pad_same(
        _nchw(x), 3, 2, float("-inf")), 3, 2).permute(0, 2, 3, 1).numpy()
    pool_naive = F.max_pool2d(_nchw(x), 3, 2, padding=1
                              ).permute(0, 2, 3, 1).numpy()
    assert np.array_equal(pool_got, pool_want)
    if px % 2 == 0:
        with pytest.raises(AssertionError):
            _close(naive, want)
        assert not np.array_equal(pool_naive, pool_want)
    else:  # odd inputs pad (1, 1): the same as torch's
        _close(naive, want)
        assert np.array_equal(pool_naive, pool_want)


def test_running_variance_is_biased_as_flax_not_batchnorm2d():
    """flax updates the running variance with the biased batch variance,
    momentum 0.9 on the old value; nn.BatchNorm2d(momentum=0.1) uses the
    unbiased one, n / (n - 1) larger."""
    x = np.random.RandomState(7).randn(2, 3, 3, 6).astype(np.float32) + 2.0
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    mine = BatchNorm(6)
    got = mine(_nchw(x))
    _close(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y))
    want_var = np.asarray(upd["batch_stats"]["var"])
    _close(mine.var.numpy(), want_var, what="running var")
    _close(mine.mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
           what="running mean")
    naive = torch.nn.BatchNorm2d(6, momentum=0.1, eps=1e-5)
    naive(_nchw(x))
    with pytest.raises(AssertionError):
        _close(naive.running_var.detach().numpy(), want_var)
