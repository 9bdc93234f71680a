"""The port's SyncBatchNorm at np=2 on gloo, against whole-batch batch
norm and the JAX package's ``sync_batch_stats``.

This file, run as a script by two processes, is the two ranks: each
normalises its half of one batch with ``SyncBatchNorm`` and saves the
outputs, the running statistics, the gradients of a fixed loss and the
``sync_batch_stats`` of its half. The tests hold them to the port's
plain ``BatchNorm`` over the whole batch (outputs and input gradients
are the halves of the whole batch's; scale and bias gradients sum over
the ranks) and to ``horovod_tpu.jax.sync_batch_stats`` run on 2 virtual
CPU devices with the same halves. fp32 throughout; 1e-5 relative to the
tensor's largest magnitude covers sums taken in another order.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TOL = 1e-5
C = 5


def _inputs():
    """The whole batch (8, C, 4, 4) NCHW, the loss weights, and the
    affine parameters."""
    rng = np.random.RandomState(0)
    x = (rng.randn(8, C, 4, 4) * 2 + 1).astype(np.float32)
    w = rng.randn(8, C, 4, 4).astype(np.float32)
    scale = (1 + 0.3 * rng.randn(C)).astype(np.float32)
    bias = (0.2 * rng.randn(C)).astype(np.float32)
    return x, w, scale, bias


def _run(bn, x, w, scale, bias):
    """Two train-mode steps (so the running statistics move twice), the
    loss sum(w * y) after the second; returns y, dy/dx and the
    gradients of scale and bias, with the running statistics."""
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).contiguous(memory_format=torch.channels_last)
    bn(xt * 0.5)
    xt.requires_grad_()
    y = bn(xt)
    (y * torch.from_numpy(w)).sum().backward()
    return dict(y=y.detach().numpy(), dx=xt.grad.numpy(),
                dscale=bn.scale.grad.numpy(), dbias=bn.bias.grad.numpy(),
                mean=bn.mean.numpy(), var=bn.var.numpy())


def _worker_main(init_file, out_path):
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", init_method="file://" + init_file)
    rank = hvd.rank()
    x, w, scale, bias = _inputs()
    half = slice(4 * rank, 4 * rank + 4)
    out = _run(hvd.SyncBatchNorm(C), x[half], w[half], scale, bias)
    mean, var = hvd.sync_batch_stats(torch.from_numpy(x[half]))
    out.update(stats_mean=mean.numpy(), stats_var=var.numpy())
    hvd.shutdown()
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def np2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("np2")
    init_file = str(tmp / "rendezvous")
    procs, outs = [], []
    for rank in range(2):
        env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE="2",
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE="2",
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        outs.append(str(tmp / ("rank%d.npz" % rank)))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             init_file, outs[-1]], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=120)[0].decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [dict(np.load(o)) for o in outs]


def _close(got, want, what=""):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max(), err_msg=what)


def test_sync_batch_norm_over_halves_equals_whole_batch(np2):
    from horovod_tpu_torch.sync_batch_norm import BatchNorm

    x, w, scale, bias = _inputs()
    whole = _run(BatchNorm(C), x, w, scale, bias)
    for key in ("y", "dx"):
        _close(np.concatenate([r[key] for r in np2]), whole[key], key)
    for key in ("dscale", "dbias"):
        _close(np2[0][key] + np2[1][key], whole[key], key)
    for res in np2:
        for key in ("mean", "var"):
            _close(res[key], whole[key], key)


def test_sync_batch_stats_match_the_reference(np2):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from horovod_tpu.jax import sync_batch_stats
    from horovod_tpu.parallel.mesh import shard_map_compat as shard_map

    x = _inputs()[0].transpose(0, 2, 3, 1)  # NHWC, as the reference takes
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))

    def stats(s):
        mean, var = sync_batch_stats(s, axis_name="data")
        return jnp.stack([mean, var])[None]

    want = np.asarray(jax.jit(shard_map(
        stats, mesh=mesh, in_specs=P("data"), out_specs=P("data")))(x))
    for rank, res in enumerate(np2):
        _close(res["stats_mean"], want[rank, 0], "mean")
        _close(res["stats_var"], want[rank, 1], "var")


def test_sync_batch_norm_at_size_one_equals_plain(monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.sync_batch_norm import BatchNorm

    for name in ("HOROVOD_RANK", "HOROVOD_SIZE", "OMPI_COMM_WORLD_RANK",
                 "OMPI_COMM_WORLD_SIZE", "PMI_RANK", "PMI_SIZE",
                 "SLURM_PROCID", "SLURM_STEP_NUM_TASKS"):
        monkeypatch.delenv(name, raising=False)
    hvd.init(device="cpu")
    try:
        x, w, scale, bias = _inputs()
        sync = _run(hvd.SyncBatchNorm(C), x, w, scale, bias)
        plain = _run(BatchNorm(C), x, w, scale, bias)
    finally:
        hvd.shutdown()
    for key, value in plain.items():
        _close(sync[key], value, key)


if __name__ == "__main__":
    _worker_main(sys.argv[1], sys.argv[2])
