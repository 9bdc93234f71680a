"""The port's pipeline (``parallel/pipeline.py``) at np=4 on gloo against
the JAX package: 4 stages of ``tanh(x @ w)``, 6 microbatches, fp32.

* ``pipeline_apply``: the last stage's outputs against the reference's
  under ``shard_map`` on 4 virtual CPU devices, and zeros elsewhere;
* ``pipeline_loss``: the local scalar on each stage (the loss on the
  last, 0.0 elsewhere) and every stage's weight gradient from
  ``backward()`` on it, against ``jax.grad`` of the reference's local
  scalar: rtol 1e-5 (test_pipeline.py's tolerance);
* the same at one stage, on the global set at size 1, in this process.

Every stage must run every exchange backward, including those whose
output it never reads: the ranks finish under ``RANKS_TIMEOUT`` or the
test fails. This file, run as a script by each rank, is the ranks.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
N, M, MB, D = 4, 6, 3, 8
TOL = dict(rtol=1e-5, atol=1e-6)
RANKS_TIMEOUT = 120


def _inputs(n=N):
    rng = np.random.RandomState(0)
    ws = rng.randn(n, D, D).astype(np.float32) * 0.5
    xs = rng.randn(M, MB, D).astype(np.float32)
    return ws, xs


def _stage(w, x):
    return torch.tanh(x @ w)


def _loss(outs):
    return (outs ** 2).mean()


def _port_stage(process_set, rank, n):
    """This stage's outputs, local scalar and weight gradient."""
    from horovod_tpu_torch.parallel import pipeline

    ws, xs = _inputs(n)
    w = torch.tensor(ws[rank], requires_grad=True)
    xs = torch.tensor(xs)
    with torch.no_grad():
        outs = pipeline.pipeline_apply(_stage, w, xs, axis=process_set)
    local = pipeline.pipeline_loss(_stage, w, xs, _loss, axis=process_set)
    local.backward()
    return outs.numpy(), local.detach().numpy(), w.grad.numpy()


# ---------------------------------------------------------------- worker ---

def _worker_main(init_file, out_path):
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", init_method="file://" + init_file)
    pipe = hvd.add_process_set(list(range(N)))
    outs, local, grad = _port_stage(pipe, hvd.rank(), N)
    hvd.shutdown()
    np.savez(out_path, outs=outs, local=local, grad=grad)


# ----------------------------------------------------------------- tests ---

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline_np4")
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
            logs.append(p.communicate(timeout=RANKS_TIMEOUT)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [dict(np.load(o)) for o in outs]


def _reference(n):
    """The JAX package's outputs (last stage's), local scalars and
    per-stage gradients on ``n`` virtual devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from horovod_tpu.parallel.mesh import shard_map_compat as shard_map
    from horovod_tpu.parallel.pipeline import pipeline_apply, pipeline_loss

    ws, xs = _inputs(n)

    def stage(w, x):
        return jnp.tanh(x @ w[0])

    def fn(ws_local, xs_rep):
        def local(w):
            return pipeline_loss(stage, w, xs_rep,
                                 lambda o: jnp.mean(o ** 2), axis="pipe")
        outs = pipeline_apply(stage, ws_local, xs_rep, axis="pipe")
        return (jax.lax.psum(outs, "pipe"), local(ws_local)[None],
                jax.grad(local)(ws_local))

    mesh = Mesh(np.array(jax.devices()[:n]), ("pipe",))
    run = jax.jit(shard_map(fn, mesh=mesh, in_specs=(P("pipe"), P()),
                            out_specs=(P(), P("pipe"), P("pipe"))))
    return [np.asarray(a) for a in run(ws, xs)]


def test_pipeline_apply_matches_reference(ranks):
    outs, _, _ = _reference(N)
    for rank, r in enumerate(ranks):
        if rank == N - 1:
            np.testing.assert_allclose(r["outs"], outs, **TOL)
        else:
            np.testing.assert_array_equal(r["outs"], np.zeros_like(outs))


def test_pipeline_loss_gradients_reach_every_stage(ranks):
    _, local, grads = _reference(N)
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["local"], local[rank], **TOL)
        np.testing.assert_allclose(r["grad"], grads[rank], **TOL)
        assert np.abs(r["grad"]).sum() > 0
    assert all(float(r["local"]) == 0.0 for r in ranks[:-1])


def test_one_stage_on_the_global_set(monkeypatch):
    import horovod_tpu_torch as hvd

    for name in ("HOROVOD_RANK", "HOROVOD_SIZE", "OMPI_COMM_WORLD_RANK",
                 "OMPI_COMM_WORLD_SIZE", "PMI_RANK", "PMI_SIZE",
                 "SLURM_PROCID", "SLURM_STEP_NUM_TASKS"):
        monkeypatch.delenv(name, raising=False)
    hvd.init(device="cpu")
    try:
        outs, local, grad = _port_stage(None, 0, 1)
    finally:
        hvd.shutdown()
    want_outs, want_local, want_grad = _reference(1)
    np.testing.assert_allclose(outs, want_outs, **TOL)
    np.testing.assert_allclose(local, want_local[0], **TOL)
    np.testing.assert_allclose(grad, want_grad[0], **TOL)


if __name__ == "__main__":
    _worker_main(sys.argv[1], sys.argv[2])
