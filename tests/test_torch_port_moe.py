"""The port's MoE (``parallel/moe.py``) against the JAX package.

Routing is held in float64 on both sides (``jax.enable_x64``), so that
no near-tie between two experts' logits rounds differently in the two
packages. The gates are fp32 all the same: the reference's
``top1_dispatch`` takes its softmax in fp32 (horovod_tpu/parallel/moe.py:
39), and the port does too, so XLA's fp32 exp and torch's may round a
gate one unit in the last place apart. Hence:

* dispatch (T, E, C) equal, element for element;
* combine, and every output (a token's output is its gate times one
  expert's output), within ``GATE_RTOL`` = 2^-22, two fp32 units;
* the port against itself with the same gates (``expert_parallel_moe``
  at n=4, E=8 on gloo against ``moe_ffn``, outputs and gradients):
  1e-10 relative, float64 summed in another order;
* the MoE transformer (2 layers, float64, dense attention, whose softmax
  the reference also takes in fp32) through ``from_jax_params``: logits
  and loss gradients within ``MODEL_RTOL`` of the largest magnitude.

This file, run as a script by each rank (file rendezvous), is the ranks
of the expert-parallel case.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
N = 4
E, M, F, T_LOCAL, CAPACITY = 8, 16, 32, 10, 6
GATE_RTOL = 2.0 ** -22
SELF_RTOL = 1e-10
MODEL_RTOL = 1e-6


def _moe_inputs(seed=4):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, T_LOCAL, M)
    router = rng.randn(M, E) * 0.5
    wi = rng.randn(E, M, F) * 0.1
    wo = rng.randn(E, F, M) * 0.1
    dout = rng.randn(N, T_LOCAL, M)
    return x, router, wi, wo, dout


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300))


# ---------------------------------------------------------------- worker ---

def _worker_main(init_file, out_path):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import moe

    hvd.init(device="cpu", init_method="file://" + init_file)
    rank = hvd.rank()
    experts = hvd.add_process_set(list(range(N)))
    x, router, wi, wo, dout = (torch.tensor(a) for a in _moe_inputs())
    per = E // N
    mine = slice(rank * per, (rank + 1) * per)
    leaves = [x[rank].clone().requires_grad_(), router.clone()
              .requires_grad_(), wi[mine].clone().requires_grad_(),
              wo[mine].clone().requires_grad_()]
    y = moe.expert_parallel_moe(*leaves, CAPACITY, axis=experts,
                                dtype=torch.float64)
    (y * dout[rank]).sum().backward()
    out = {"out": y.detach().numpy()}
    for name, leaf in zip(("dx", "drouter", "dwi", "dwo"), leaves):
        out[name] = leaf.grad.numpy()

    # The same layer with every expert here, over every member's tokens:
    # the expert weights' gradients sum over all of them.
    whole = [router, wi, wo]
    dwi, dwo = torch.zeros_like(wi), torch.zeros_like(wo)
    for r in range(N):
        xr = x[r].clone().requires_grad_()
        ws = [w.clone().requires_grad_() for w in whole]
        ref = moe.moe_ffn(xr, *ws, CAPACITY, dtype=torch.float64)
        g = torch.autograd.grad((ref * dout[r]).sum(), [xr] + ws)
        dwi += g[2]
        dwo += g[3]
        if r == rank:
            out["ref_out"] = ref.detach().numpy()
            out["ref_dx"], out["ref_drouter"] = g[0].numpy(), g[1].numpy()
    out["ref_dwi"], out["ref_dwo"] = dwi[mine].numpy(), dwo[mine].numpy()

    try:
        moe.expert_parallel_moe(x[rank], router[:, :6], wi[:1], wo[:1],
                                CAPACITY, axis=experts)
    except ValueError as e:
        out["err.experts"] = np.array(str(e))
    try:
        moe.expert_parallel_moe(x[rank], router, wi[:3], wo[:3], CAPACITY,
                                axis=experts)
    except ValueError as e:
        out["err.shards"] = np.array(str(e))
    hvd.shutdown()
    np.savez(out_path, **out)


# ----------------------------------------------------------------- tests ---

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_np4")
    procs, outs = [], []
    for rank in range(N):
        env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(N),
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(N),
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        outs.append(str(tmp / ("rank%d.npz" % rank)))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             str(tmp / "rendezvous"), outs[-1]], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=180)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [dict(np.load(o)) for o in outs]


@pytest.mark.parametrize("seed,capacity", [(0, 3), (1, 6), (2, 40)])
def test_top1_dispatch_matches_reference(seed, capacity):
    import jax
    import jax.numpy as jnp
    from horovod_tpu.parallel import moe as JM
    from horovod_tpu_torch.parallel import moe as PM

    logits = np.random.RandomState(seed).randn(40, E)
    with jax.enable_x64(True):
        jd, jc = (np.asarray(a) for a in JM.top1_dispatch(
            jnp.asarray(logits), capacity))
    pd, pc = (a.numpy() for a in PM.top1_dispatch(torch.tensor(logits),
                                                  capacity))
    assert pd.dtype == jd.dtype == np.float32
    np.testing.assert_array_equal(pd, jd)
    np.testing.assert_allclose(pc, jc, rtol=GATE_RTOL, atol=0)
    assert pd.sum(axis=(1, 2)).max() <= 1 and pd.sum(axis=0).max() <= 1


def _literal_top1_dispatch(logits, capacity):
    """The reference's ``top1_dispatch`` (moe.py:30-50) written line for
    line in torch: one-hot of the expert, cumsum positions, ``keep *
    one_hot(clip(pos))`` over (T, E, C), then times the gate."""
    t, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    expert = probs.argmax(-1)
    gate = probs.gather(1, expert[:, None])[:, 0]
    onehot = torch.nn.functional.one_hot(expert, e).float()
    pos = (onehot.cumsum(0) - 1.0) * onehot
    keep = (pos < capacity) * onehot
    clipped = pos.clamp(0, capacity - 1).long()
    dispatch = keep[..., None] * torch.nn.functional.one_hot(
        clipped, capacity).float()
    return dispatch, dispatch * gate[:, None, None]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
def test_routing_tensors_in_the_compute_dtype(dtype):
    """``moe_ffn`` builds dispatch and combine in its dtype: the same
    values as the reference's fp32 tensors cast to it, and the same
    gradient of the logits, bit for bit (capacity 5 drops tokens)."""
    from horovod_tpu_torch.parallel import moe as PM

    rng = np.random.RandomState(7)
    logits = torch.tensor(rng.randn(40, E), dtype=dtype)
    cot = torch.tensor(rng.randn(40, E, 5), dtype=dtype)
    results = []
    for build in (lambda x: PM._dispatch_combine(x, 5, dtype),
                  lambda x: tuple(a.to(dtype) for a in
                                  _literal_top1_dispatch(x, 5))):
        x = logits.clone().requires_grad_()
        dispatch, combine = build(x)
        (combine * cot).sum().backward()
        results.append((dispatch, combine.detach(), x.grad))
    assert results[0][0].sum() < 40   # some tokens were dropped
    for got, want in zip(*results):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moe_ffn_matches_reference(seed):
    import jax
    import jax.numpy as jnp
    from horovod_tpu.parallel import moe as JM
    from horovod_tpu_torch.parallel import moe as PM

    x, router, wi, wo, _ = _moe_inputs(seed)
    with jax.enable_x64(True):
        want = np.asarray(JM.moe_ffn(*(jnp.asarray(a) for a in (
            x[0], router, wi, wo)), CAPACITY, dtype=jnp.float64))
    got = PM.moe_ffn(*(torch.tensor(a) for a in (x[0], router, wi, wo)),
                     CAPACITY, dtype=torch.float64).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=GATE_RTOL,
                               atol=1e-12 * np.abs(want).max())


def test_expert_parallel_moe_matches_reference(ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from horovod_tpu.parallel import moe as JM
    from horovod_tpu.parallel.mesh import shard_map_compat as shard_map

    x, router, wi, wo, _ = _moe_inputs()
    mesh = Mesh(np.array(jax.devices()[:N]), ("expert",))
    with jax.enable_x64(True):
        fn = shard_map(
            lambda x_, wi_, wo_: JM.expert_parallel_moe(
                x_[0], jnp.asarray(router), wi_, wo_, CAPACITY,
                axis="expert", dtype=jnp.float64)[None],
            mesh=mesh, in_specs=(P("expert"),) * 3, out_specs=P("expert"))
        want = np.asarray(jax.jit(fn)(x, wi, wo))
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["out"], want[rank], rtol=GATE_RTOL,
                                   atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("what", ["out", "dx", "drouter", "dwi", "dwo"])
def test_expert_parallel_moe_matches_moe_ffn(ranks, what):
    for r in ranks:
        assert _rel(r[what], r["ref_" + what]) < SELF_RTOL, what


def test_expert_parallel_moe_refuses_indivisible_experts(ranks):
    for r in ranks:
        assert "must divide expert axis (4)" in str(r["err.experts"])
        assert "want E/n = 2" in str(r["err.shards"])


def _moe_configs():
    import jax.numpy as jnp
    from horovod_tpu import models as jmodels
    from horovod_tpu_torch import models as port

    kw = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=2, d_ff=32,
              max_seq_len=32, attention="dense", num_experts=4)
    return (jmodels.TransformerConfig(dtype=jnp.float64, **kw),
            port.TransformerConfig(dtype=torch.float64, **kw))


def test_moe_transformer_through_from_jax_params():
    import jax
    import jax.numpy as jnp
    import optax
    from flax.core import meta
    from horovod_tpu import models as jmodels
    from horovod_tpu_torch import models as port

    jcfg, pcfg = _moe_configs()
    tokens = np.random.RandomState(6).randint(0, 64, (2, 16)).astype(
        np.int32)
    with jax.enable_x64(True):
        jmodel = jmodels.Transformer(jcfg)
        params = meta.unbox(jmodel.init(jax.random.PRNGKey(3), tokens))

        def loss_fn(p):
            logits = jmodel.apply(p, tokens)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.roll(tokens, -1, axis=1)).mean(), logits

        (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
        tree = jax.tree_util.tree_map(np.asarray, params)
        jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    assert "moe" in tree["params"]["layer_0"]
    model = port.Transformer(pcfg, device="cpu")
    model.load_state_dict(port.from_jax_params(tree, pcfg))
    t = torch.tensor(tokens, dtype=torch.long)
    logits = model(t)
    loss = port.lm_loss(logits, t)
    loss.backward()
    assert _rel(logits.detach().numpy(), np.asarray(jlogits)) < MODEL_RTOL
    assert abs(loss.item() - float(jloss)) < MODEL_RTOL * abs(float(jloss))
    want = port.from_jax_params(jgrads, pcfg)
    for name, p in model.named_parameters():
        assert _rel(p.grad.numpy(), want[name].numpy()) < MODEL_RTOL, name
    assert float(model.layers[0].moe.router.grad.abs().sum()) > 0


def test_moe_converter_rejects_a_dense_tree():
    _, pcfg = _moe_configs()
    from horovod_tpu_torch import models as port

    dense = port.Transformer(dataclasses.replace(pcfg, num_experts=0),
                             device="cpu")
    tree = {"params": {}}
    for name, value in dense.state_dict().items():
        node = tree["params"]
        parts = name.split(".")
        if parts[0] == "layers":
            parts = ["layer_" + parts[1]] + parts[2:]
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value.numpy()
    with pytest.raises(ValueError, match="moe.router"):
        port.from_jax_params(tree, pcfg)


if __name__ == "__main__":
    _worker_main(sys.argv[1], sys.argv[2])
