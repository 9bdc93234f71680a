"""The port's transformer against the flax reference, at the tiny config.

Weights come from the reference's init and reach the port through
``from_jax_params``. Logits and the gradients of the bench loss must agree
to 1e-4 relative (fp32 on both sides; the two differ only in summation
order, the flash path's online softmax, and LayerNorm's variance formula).
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
from horovod_tpu.models import Transformer as JaxTransformer
from horovod_tpu_torch import models as port

TOL = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _configs(attention):
    jcfg = dataclasses.replace(graft._flagship_config(tiny=True),
                               attention=attention)
    pcfg = port.TransformerConfig(
        vocab_size=jcfg.vocab_size, d_model=jcfg.d_model,
        n_heads=jcfg.n_heads, n_layers=jcfg.n_layers, d_ff=jcfg.d_ff,
        max_seq_len=jcfg.max_seq_len, dtype=torch.float32,
        attention=attention)
    return jcfg, pcfg


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, meta.unbox(tree))


def _setup(attention, batch=2, seq=32):
    jcfg, pcfg = _configs(attention)
    tokens = np.random.RandomState(0).randint(
        0, jcfg.vocab_size, (batch, seq)).astype(np.int32)
    jmodel = JaxTransformer(jcfg)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(tokens))
    pmodel = port.Transformer(pcfg, device="cpu")
    pmodel.load_state_dict(port.from_jax_params(_numpy_tree(params), pcfg))
    return jmodel, params, pmodel, pcfg, tokens


def _jax_loss(jmodel, params, tokens):
    logits = jmodel.apply(params, tokens)
    targets = jnp.roll(tokens, -1, axis=1)
    return optax.softmax_cross_entropy_with_integer_labels(
        logits, targets).mean()


@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_logits_match_reference(attention):
    jmodel, params, pmodel, _, tokens = _setup(attention)
    ref = np.asarray(jmodel.apply(params, jnp.asarray(tokens)))
    with torch.no_grad():
        out = pmodel(torch.tensor(tokens, dtype=torch.long))
    assert out.dtype == torch.float32
    assert out.shape == ref.shape
    assert _rel(out.numpy(), ref) < TOL


@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_loss_gradients_match_reference(attention):
    jmodel, params, pmodel, pcfg, tokens = _setup(attention)
    jtokens = jnp.asarray(tokens)
    jloss, jgrads = jax.value_and_grad(
        lambda p: _jax_loss(jmodel, p, jtokens))(params)
    ttokens = torch.tensor(tokens, dtype=torch.long)
    loss = port.lm_loss(pmodel(ttokens), ttokens)
    loss.backward()
    assert abs(loss.item() - float(jloss)) < TOL * abs(float(jloss))
    ref = port.from_jax_params(_numpy_tree(jgrads), pcfg)
    grads = {n: p.grad for n, p in pmodel.named_parameters()}
    assert set(grads) == set(ref)
    for name, g in grads.items():
        assert _rel(g.numpy(), ref[name].numpy()) < TOL, name


def test_state_dict_names_and_shapes_follow_flax():
    _, params, pmodel, pcfg, _ = _setup("dense")
    converted = port.from_jax_params(_numpy_tree(params), pcfg)
    assert {n: tuple(p.shape) for n, p in pmodel.state_dict().items()} == \
        {n: tuple(t.shape) for n, t in converted.items()}
    assert converted["layers.0.attn.wqkv"].shape == (3, 64, 4, 16)
    assert converted["layers.1.attn.wo"].shape == (4, 16, 64)


def test_converter_rejects_a_tree_of_another_config():
    _, params, _, pcfg, _ = _setup("dense")
    wrong = dataclasses.replace(pcfg, d_ff=pcfg.d_ff * 2)
    with pytest.raises(ValueError, match="shape"):
        port.from_jax_params(_numpy_tree(params), wrong)


@pytest.mark.parametrize("attention,num_experts", [("ring", 0),
                                                   ("ulysses", 0),
                                                   ("dense", 2)])
def test_unported_paths_raise(attention, num_experts):
    cfg = port.TransformerConfig(vocab_size=16, d_model=8, n_heads=2,
                                 n_layers=1, d_ff=16, max_seq_len=8,
                                 attention=attention,
                                 num_experts=num_experts)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.Transformer(cfg, device="cpu")


def test_gelu_and_layernorm_parity_traps():
    """flax nn.gelu is the tanh approximation; flax LayerNorm eps 1e-6."""
    import flax.linen as nn

    x = np.random.RandomState(4).randn(3, 16).astype(np.float32) * 3
    ref_gelu = np.asarray(nn.gelu(jnp.asarray(x)))
    got = torch.nn.functional.gelu(torch.tensor(x), approximate="tanh")
    assert _rel(got.numpy(), ref_gelu) < 1e-6
    small = x * 1e-3  # variance near eps: the eps value shows
    ln = nn.LayerNorm()
    ref_ln = np.asarray(ln.apply(ln.init(jax.random.PRNGKey(0),
                                         jnp.asarray(small)),
                                 jnp.asarray(small)))
    got_ln = port.transformer.LayerNorm(16, torch.float32, "cpu")(
        torch.tensor(small))
    assert _rel(got_ln.detach().numpy(), ref_ln) < 1e-4
