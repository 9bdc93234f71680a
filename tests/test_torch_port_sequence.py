"""The port's sequence parallelism at np=4 on gloo against the JAX package.

* ``mesh.ppermute`` and ``mesh.all_to_all`` against ``lax.ppermute`` and
  ``lax.all_to_all(tiled=True)``, bit for bit (they move values).
* ``ring_attention`` (causal and full) and ``ulysses_attention`` on a
  registered set of all four ranks, and the ring on two 2-member sets at
  once ([0, 2] and [1, 3]: set ranks are not global ranks), against the
  reference's functions under ``shard_map`` on 4 (or 2) of conftest's
  virtual CPU devices: outputs to rtol 2e-4 / atol 2e-5, as
  tests/test_sequence_moe.py holds the reference to dense attention, and
  the gradients of ``sum(out * dout)`` to rtol 1e-3 / atol 1e-5.
* The ring and the Ulysses transformer (2 layers, d_model 32, fp32), and
  the ring under ``remat`` (each block's exchanges run again in the
  backward), on weights converted from flax: logits against the flax model's ring and
  Ulysses runs to rtol 5e-3 / atol 5e-4 (test_sequence_moe.py's
  tolerance), and one step's loss and parameter gradients (each member's
  loss over its slice, ``shard_sequence``'s targets, averaged over the
  set) against flax's under ``shard_map``.
* No fallback: indivisible heads or sequence, and a set that does not
  hold the rank, raise.

This file, run as a script by each rank (file rendezvous), is the ranks.
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
ATTN = (2, 32, 4, 8)          # B, S (global), H, D
OUT_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
LOGIT_TOL = dict(rtol=5e-3, atol=5e-4)
A2A_AXES = ((0, 1), (1, 0), (2, 1), (1, 2), (1, 1))
# The ring under remat recomputes each block's exchanges in the backward.
TRANSFORMER_CASES = ("ring", "ulysses", "ring_remat")
PERM = ((0, 2), (2, 1), (1, 0))     # member 3 sends and receives nothing


def _attn_inputs(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*ATTN).astype(np.float32) for _ in range(4)]


def _a2a_input(rank):
    return (rank * 1000 + np.arange(4 * 8 * 4)).reshape(4, 8, 4).astype(
        np.float32)


def _a2a_weights(rank, split, concat):
    """The cotangent of the exchange's output on ``rank``."""
    shape = list(_a2a_input(rank).shape)
    shape[split] //= N
    shape[concat] *= N
    return (rank * 1000 + 7 * np.arange(int(np.prod(shape)))).reshape(
        shape).astype(np.float32)


def _config(port, attention, seq_axis=None):
    return port.TransformerConfig(
        vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
        max_seq_len=64, dtype=torch.float32, attention=attention,
        seq_axis=seq_axis)


def _shard(x, r, n, axis=1):
    s = x.shape[axis] // n
    return np.take(x, range(r * s, (r + 1) * s), axis=axis)


# ---------------------------------------------------------------- worker ---

def _attention_case(fn, inputs, rank, n, ps, out, tag, **kw):
    q, k, v, dout = (torch.tensor(_shard(x, rank, n), requires_grad=True)
                     for x in inputs)
    res = fn(q, k, v, axis=ps, **kw)
    (res * dout.detach()).sum().backward()
    out[tag + ".out"] = res.detach().numpy()
    for name, t in (("dq", q), ("dk", k), ("dv", v)):
        out["%s.%s" % (tag, name)] = t.grad.numpy()


def _error(out, key, fn):
    try:
        fn()
    except ValueError as e:
        out[key] = np.array(str(e))


def _worker_main(init_file, inputs_path, out_path):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import models as port
    from horovod_tpu_torch.parallel import mesh
    from horovod_tpu_torch.parallel import sequence as S

    hvd.init(device="cpu", init_method="file://" + init_file)
    rank = hvd.rank()
    every = hvd.add_process_set(list(range(N)))
    pairs = [hvd.add_process_set([0, 2]), hvd.add_process_set([1, 3])]
    mine = pairs[rank % 2]
    out = {"axis": np.array([mesh.axis_size(every), mesh.axis_index(every),
                             mesh.axis_size(mine), mesh.axis_index(mine)])}

    x = torch.tensor(_a2a_input(rank))
    out["ppermute"] = mesh.ppermute(x, PERM, every).numpy()
    for split, concat in A2A_AXES:
        out["a2a.%d%d" % (split, concat)] = mesh.all_to_all(
            x, split, concat, every).numpy()
        xg = x.clone().requires_grad_()
        y = hvd.alltoall_ingraph(xg, split_axis=split, concat_axis=concat,
                                 process_set=every)
        (y * torch.tensor(_a2a_weights(rank, split, concat))).sum() \
            .backward()
        out["hvd_a2a.%d%d" % (split, concat)] = y.detach().numpy()
        out["hvd_a2a_grad.%d%d" % (split, concat)] = xg.grad.numpy()

    for causal in (True, False):
        _attention_case(S.ring_attention, _attn_inputs(0), rank, N, every,
                        out, "ring.%d" % causal, causal=causal)
        _attention_case(S.ulysses_attention, _attn_inputs(1), rank, N,
                        every, out, "ulysses.%d" % causal, causal=causal)
    _attention_case(S.ring_attention, _attn_inputs(2), rank // 2, 2, mine,
                    out, "ring_pair", causal=True)

    inputs = dict(np.load(inputs_path))
    tokens = torch.tensor(inputs["tokens"], dtype=torch.long)
    state = {k[len("w."):]: torch.tensor(v) for k, v in inputs.items()
             if k.startswith("w.")}
    for case in TRANSFORMER_CASES:
        attention = case.split("_")[0]
        model = port.Transformer(dataclasses.replace(
            _config(port, attention, every), remat=case.endswith("remat")),
            device="cpu")
        model.load_state_dict(state)
        local, targets = port.shard_sequence(tokens, every)
        logits = model(local)
        loss = port.lm_loss(logits, local, targets)
        loss.backward()
        names = [n for n, _ in model.named_parameters()]
        grads = hvd.grouped_allreduce_ingraph(
            [p.grad for p in model.parameters()], hvd.Average,
            process_set=every)
        out[case + ".logits"] = logits.detach().numpy()
        out[case + ".loss"] = hvd.allreduce_ingraph(
            loss.detach(), hvd.Average, process_set=every).numpy()
        for name, g in zip(names, grads):
            out["%s.grad.%s" % (case, name)] = g.numpy()

    q = torch.zeros(1, 8, 6, 4)
    _error(out, "err.heads", lambda: S.ulysses_attention(q, q, q,
                                                         axis=every))
    _error(out, "err.not_member", lambda: S.ring_attention(
        q, q, q, axis=pairs[1 - rank % 2]))
    _error(out, "err.sequence", lambda: port.shard_sequence(
        torch.zeros(1, 30, dtype=torch.long), every))
    _error(out, "err.unregistered", lambda: S.ring_attention(
        q, q, q, axis=hvd.ProcessSet(list(range(N)))))
    _error(out, "err.positions", lambda: port.Transformer(
        _config(port, "ring", every), device="cpu")(
            torch.zeros(1, 20, dtype=torch.long)))
    hvd.shutdown()
    np.savez(out_path, **out)


# ----------------------------------------------------------------- tests ---

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import jax
    from flax.core import meta
    from horovod_tpu import models as jmodels
    from horovod_tpu_torch import models as port

    tmp = tmp_path_factory.mktemp("sequence_np4")
    cfg = _jax_config("dense")
    tokens = np.random.RandomState(5).randint(0, 64, (2, 32)).astype(
        np.int32)
    params = meta.unbox(jmodels.Transformer(cfg).init(
        jax.random.PRNGKey(0), tokens))
    state = port.from_jax_params(_numpy(params), _config(port, "dense"))
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, tokens=tokens,
             **{"w." + k: v.numpy() for k, v in state.items()})
    procs, outs = [], []
    for rank in range(N):
        env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(N),
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(N),
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        outs.append(str(tmp / ("rank%d.npz" % rank)))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             str(tmp / "rendezvous"), inputs, outs[-1]], env=env,
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
    return dict(params=params, tokens=tokens,
                res=[dict(np.load(o)) for o in outs])


def _numpy(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_config(attention):
    import jax.numpy as jnp
    from horovod_tpu import models as jmodels

    return jmodels.TransformerConfig(
        vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
        max_seq_len=64, dtype=jnp.float32, attention=attention,
        seq_axis=None if attention == "dense" else "seq")


def _shard_map(fn, n, in_specs, out_specs):
    import jax
    from jax.sharding import Mesh
    from horovod_tpu.parallel.mesh import shard_map_compat as shard_map

    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs))


def _jax_attention(fn, inputs, n, **kw):
    """The reference's output and the gradients of sum(out * dout) on
    each shard, every member differentiating its own scalar (as each
    rank of the port does)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    def local(q, k, v, dout):
        def scalar(q, k, v):
            return jnp.sum(fn(q, k, v, axis="seq", **kw) * dout)
        return (fn(q, k, v, axis="seq", **kw),) + jax.grad(
            scalar, argnums=(0, 1, 2))(q, k, v)

    spec = P(None, "seq")
    outs = _shard_map(local, n, (spec,) * 4, (spec,) * 4)(*inputs)
    return [np.asarray(o) for o in outs]


def _assert_shards(res, key, want, n, tol, members=None):
    for rank, r in enumerate(res):
        member = rank if members is None else members[rank]
        np.testing.assert_allclose(r[key], _shard(want, member, n),
                                   err_msg=key, **tol)


def test_axis_size_and_index(ranks):
    for rank, r in enumerate(ranks["res"]):
        assert r["axis"].tolist() == [N, rank, 2, rank // 2]


def test_ppermute_and_all_to_all_match_lax(ranks):
    import jax
    from jax.sharding import PartitionSpec as P

    stacked = np.stack([_a2a_input(r) for r in range(N)])

    def run(fn):
        out = _shard_map(lambda s: fn(s[0])[None], N, P("seq"), P("seq"))(
            stacked)
        return np.asarray(out)

    want = run(lambda x: jax.lax.ppermute(x, "seq", PERM))
    for rank, r in enumerate(ranks["res"]):
        np.testing.assert_array_equal(r["ppermute"], want[rank])
    for split, concat in A2A_AXES:
        want = run(lambda x: jax.lax.all_to_all(
            x, "seq", split, concat, tiled=True))
        key = "a2a.%d%d" % (split, concat)
        for rank, r in enumerate(ranks["res"]):
            np.testing.assert_array_equal(r[key], want[rank], err_msg=key)


def test_tiled_alltoall_matches_reference_in_graph(ranks):
    """``hvd.alltoall_ingraph(x, split_axis=, concat_axis=)`` against the JAX
    package's in-graph ``alltoall``, and its gradient (of ``sum(y *
    w)``) against ``jax.grad`` of the same."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.ops import collective_ops as JC

    xs = np.stack([_a2a_input(r) for r in range(N)])
    for split, concat in A2A_AXES:
        ws = np.stack([_a2a_weights(r, split, concat) for r in range(N)])
        def local(x, w):
            def fn(x):
                return JC.alltoall(x, axis="seq", split_axis=split,
                                   concat_axis=concat)
            return (fn(x[0])[None],
                    jax.grad(lambda x: jnp.sum(fn(x[0]) * w[0]))(x))

        want, grad = (np.asarray(a) for a in _shard_map(
            local, N, (P("seq"), P("seq")), (P("seq"), P("seq")))(xs, ws))
        key = "%d%d" % (split, concat)
        for rank, r in enumerate(ranks["res"]):
            np.testing.assert_array_equal(r["hvd_a2a." + key], want[rank])
            np.testing.assert_array_equal(r["hvd_a2a_grad." + key],
                                          grad[rank])


@pytest.mark.parametrize("which", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_and_gradients_match_reference(ranks, which, causal):
    from horovod_tpu.parallel import sequence as JS

    fn = {"ring": JS.ring_attention, "ulysses": JS.ulysses_attention}[which]
    inputs = _attn_inputs(0 if which == "ring" else 1)
    want = _jax_attention(fn, inputs, N, causal=causal)
    tag = "%s.%d" % (which, causal)
    _assert_shards(ranks["res"], tag + ".out", want[0], N, OUT_TOL)
    for name, w in zip(("dq", "dk", "dv"), want[1:]):
        _assert_shards(ranks["res"], "%s.%s" % (tag, name), w, N, GRAD_TOL)


def test_ring_on_two_sets_of_two(ranks):
    """[0, 2] and [1, 3] run at once; rank r is member r // 2 of its set."""
    from horovod_tpu.parallel import sequence as JS

    want = _jax_attention(JS.ring_attention, _attn_inputs(2), 2,
                          causal=True)
    members = [r // 2 for r in range(N)]
    _assert_shards(ranks["res"], "ring_pair.out", want[0], 2, OUT_TOL,
                   members)
    for name, w in zip(("dq", "dk", "dv"), want[1:]):
        _assert_shards(ranks["res"], "ring_pair." + name, w, 2, GRAD_TOL,
                       members)


@pytest.mark.parametrize("case", TRANSFORMER_CASES)
def test_transformer_step_matches_flax(ranks, case):
    import jax
    import optax
    from jax.sharding import PartitionSpec as P
    from horovod_tpu import models as jmodels
    from horovod_tpu_torch import models as port

    attention = case.split("_")[0]
    model = jmodels.Transformer(dataclasses.replace(
        _jax_config(attention), remat=case.endswith("remat")))
    tokens = ranks["tokens"]
    targets = np.roll(tokens, -1, axis=1)

    def local(params, tok, tgt):
        def loss_fn(p):
            logits = model.apply(p, tok)
            loss = optax.softmax_cross_entropy_with_integer_labels(
                logits, tgt).mean()
            return loss, logits
        (loss, logits), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        return (logits, jax.lax.pmean(loss, "seq"),
                jax.lax.pmean(grads, "seq"))

    spec = P(None, "seq")
    logits, loss, grads = _shard_map(local, N, (P(), spec, spec),
                                     (spec, P(), P()))(
        ranks["params"], tokens, targets)
    _assert_shards(ranks["res"], case + ".logits", np.asarray(logits),
                   N, LOGIT_TOL)
    want = port.from_jax_params(_numpy(grads), _config(port, "dense"))
    for r in ranks["res"]:
        np.testing.assert_allclose(r[case + ".loss"], float(loss),
                                   rtol=1e-5)
        for name, g in want.items():
            np.testing.assert_allclose(r["%s.grad.%s" % (case, name)],
                                       g.numpy(), err_msg=name, **GRAD_TOL)


def test_no_fallback_errors(ranks):
    for r in ranks["res"]:
        assert "divisible by the seq axis size (4)" in str(r["err.heads"])
        assert "not a member" in str(r["err.not_member"])
        assert "not divisible by the sequence set's size 4" in str(
            r["err.sequence"])
        assert "not registered" in str(r["err.unregistered"])
        assert "exceeds max_seq_len" in str(r["err.positions"])


if __name__ == "__main__":
    _worker_main(*sys.argv[1:4])
