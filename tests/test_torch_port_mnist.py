"""The port's MNIST models against the flax ones, on the CPU.

flax's init, carried by ``mnist_from_jax_params``; images from a numpy
seed, NHWC for flax and NCHW for the port. Eval-mode logits agree
elementwise within 1e-5 of the largest logit (fp32 sums in another
order). The CNN's flatten order is pinned: the port's features before
``dense0`` are the flax model's NHWC flatten, (H, W, C), and an NCHW
flatten would give other logits.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from horovod_tpu import models as jax_models
from horovod_tpu_torch import models as port

TOL = 1e-5


def _images(n=4, seed=0):
    return np.random.RandomState(seed).rand(n, 28, 28, 1).astype(np.float32)


def _setup(which):
    jmodel = {"cnn": jax_models.MnistCNN, "mlp": jax_models.MnistMLP}[which]()
    x = _images()
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    model = {"cnn": port.MnistCNN, "mlp": port.MnistMLP}[which](
        device="cpu")
    model.load_state_dict(port.mnist_from_jax_params(params, which))
    return jmodel, params, model.eval(), x


def _nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("which", ["cnn", "mlp"])
def test_eval_logits_match_flax(which):
    jmodel, params, model, x = _setup(which)
    want = np.asarray(jmodel.apply(params, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model(_nchw(x)).numpy()
    assert got.shape == (4, 10)
    _close(got, want)


def test_cnn_flattens_nhwc_features():
    jmodel, params, model, x = _setup("cnn")
    _, inter = jmodel.apply(params, jnp.asarray(x), train=False,
                            capture_intermediates=True)
    conv1 = np.asarray(inter["intermediates"]["Conv_1"]["__call__"][0])
    pooled = np.maximum(conv1.reshape(4, 4, 2, 4, 2, 20).max(axis=(2, 4)),
                        0.0)
    seen = []
    model.dense0.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].detach().numpy()))
    with torch.no_grad():
        logits = model(_nchw(x))
    _close(seen[0], pooled.reshape(4, -1))  # (H, W, C) order
    nchw = torch.from_numpy(pooled.transpose(0, 3, 1, 2).reshape(4, -1))
    with torch.no_grad():
        wrong = model.dense1(F.relu(model.dense0(nchw)))
    assert (wrong - logits).abs().max() > 100 * TOL * logits.abs().max()


def test_dropout_draws_from_the_model_generator():
    make = lambda: port.MnistMLP(  # noqa: E731
        device="cpu", generator=torch.Generator().manual_seed(3)).train()
    x = torch.from_numpy(_images(seed=1)).reshape(4, -1)
    a, b = make(), make()
    assert torch.equal(a(x), b(x))
    assert not torch.equal(a(x), a.eval()(x))


def test_converter_checks_names_and_shapes():
    _, params, _, _ = _setup("mlp")
    bad = jax.tree_util.tree_map(lambda a: a, params)
    bad["params"]["Dense_0"]["kernel"] = np.zeros((10, 512), np.float32)
    with pytest.raises(ValueError, match="shape"):
        port.mnist_from_jax_params(bad, "mlp")
    with pytest.raises(ValueError, match="missing"):
        port.mnist_from_jax_params({"Dense_0": params["params"]["Dense_0"]},
                                   "mlp")

