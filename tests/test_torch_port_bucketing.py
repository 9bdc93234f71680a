"""The port's bucketing, collectives and topology against the reference.

- ``assign_buckets`` gives the reference's buckets on random inputs;
- pack/unpack round-trips;
- an np=2 gloo run (this file run as a script by two processes, file
  rendezvous): every op against numpy, bucketed Average equal
  to the unbucketed one and to the numpy mean, one DistributedOptimizer
  step equal to SGD on the averaged gradient;
- the topology reader gives the reference's tuples over an env matrix.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from horovod_tpu.common import basics as jax_basics
from horovod_tpu.parallel import bucketing as jax_bucketing
from horovod_tpu_torch.common import basics as port_basics
from horovod_tpu_torch.parallel import bucketing

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("reverse", [True, False])
def test_assign_buckets_matches_reference(seed, reverse):
    rng = np.random.RandomState(seed)
    n = rng.randint(1, 40)
    sizes = [int(s) for s in rng.randint(1, 5000, size=n)]
    keys = [str(k) for k in rng.choice(["float32", "bfloat16", "int32"],
                                       size=n)]
    for cap in (0, -1, 1, 512, 4096, 1 << 20):
        assert bucketing.assign_buckets(sizes, keys, cap, reverse=reverse) \
            == jax_bucketing.assign_buckets(sizes, keys, cap,
                                            reverse=reverse)


def test_assign_buckets_rejects_mismatched_lists():
    with pytest.raises(ValueError):
        bucketing.assign_buckets([1, 2], ["a"], 0)


def test_pack_unpack_round_trip():
    g = torch.Generator().manual_seed(0)
    leaves = [torch.randn(3, 4, generator=g), torch.randn(5, generator=g),
              torch.randn(2, 1, 2, generator=g)]
    flat = bucketing.pack_bucket(leaves)
    assert flat.shape == (21,)
    back = bucketing.unpack_bucket(flat, leaves)
    for a, b in zip(back, leaves):
        assert a.shape == b.shape and torch.equal(a, b)
    # Views: writing the flat buffer shows through the unpacked leaves.
    flat.zero_()
    assert all(float(t.abs().sum()) == 0.0 for t in back)


# ------------------------------------------------------------------ np=2 ---

def _inputs(rank):
    rng = np.random.RandomState(100 + rank)
    return {
        "a": rng.randn(5, 3).astype(np.float32),
        "b": rng.randn(7).astype(np.float32),
        "c": rng.randint(-5, 6, size=(4,)).astype(np.int32),
        "d": (rng.rand(6) + 0.5).astype(np.float32),
    }


def _worker_main(init_file, out_path):
    """One rank of the np=2 run: every result saved for the parent."""
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", init_method="file://" + init_file)
    rank = hvd.rank()
    x = {k: torch.tensor(v) for k, v in _inputs(rank).items()}
    out = {"rank": np.array(rank), "size": np.array(hvd.size())}

    for name, op in (("average", hvd.Average), ("sum", hvd.Sum),
                     ("min", hvd.Min), ("max", hvd.Max),
                     ("product", hvd.Product)):
        out["op_" + name] = hvd.allreduce(x["a"], op).numpy()
    out["op_sum_int"] = hvd.allreduce(x["c"], hvd.Sum).numpy()
    out["scaled"] = hvd.allreduce(x["d"], hvd.Sum, prescale_factor=0.5,
                                  postscale_factor=3.0).numpy()
    grouped = hvd.grouped_allreduce([x["a"], x["c"], x["b"]], hvd.Sum)
    for i, g in enumerate(grouped):
        out["grouped_%d" % i] = g.numpy()

    grads = [x["a"], x["b"], x["d"], x["a"] * 2.0]
    cap = os.environ["HVD_GRAD_BUCKET_BYTES"]
    os.environ["HVD_GRAD_BUCKET_BYTES"] = "64"
    bucketed = hvd.allreduce_gradients(grads)
    os.environ["HVD_GRAD_BUCKET_BYTES"] = "0"
    single = hvd.allreduce_gradients(grads)
    os.environ["HVD_GRAD_BUCKET_BYTES"] = cap
    per_tensor = [hvd.allreduce(g) for g in grads]
    for i, (b, s, p) in enumerate(zip(bucketed, single, per_tensor)):
        out["bucketed_%d" % i] = b.numpy()
        out["single_%d" % i] = s.numpy()
        out["per_tensor_%d" % i] = p.numpy()
    bf16 = hvd.allreduce_gradients(grads, compression=hvd.Compression.bf16)
    out["bf16_dtype_ok"] = np.array(all(t.dtype == torch.float32
                                        for t in bf16))
    out["bf16_0"] = bf16[0].numpy()

    # One DistributedOptimizer step on rank-local data.
    torch.manual_seed(0)  # same initial weights on both ranks
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Tanh(),
                                torch.nn.Linear(4, 2))
    for n, p in model.named_parameters():
        out["init_" + n] = p.detach().numpy().copy()
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1))
    model(x["a"]).square().sum().backward()
    for n, p in model.named_parameters():
        out["local_grad_" + n] = p.grad.detach().numpy().copy()
    opt.step()
    for n, p in model.named_parameters():
        out["stepped_" + n] = p.detach().numpy()
    out["n_buckets"] = np.array(len(opt.buckets))
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
                   HVD_GRAD_BUCKET_BYTES="40",
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


def test_np2_topology(np2):
    assert [int(r["rank"]) for r in np2] == [0, 1]
    assert all(int(r["size"]) == 2 for r in np2)


def test_np2_ops_match_numpy(np2):
    xs = [_inputs(r) for r in range(2)]
    a = np.stack([x["a"] for x in xs])
    want = {"average": a.mean(0), "sum": a.sum(0), "min": a.min(0),
            "max": a.max(0), "product": a.prod(0)}
    for res in np2:
        for name, ref in want.items():
            np.testing.assert_allclose(res["op_" + name], ref, rtol=1e-6,
                                       err_msg=name)
        assert np.array_equal(res["op_sum_int"], xs[0]["c"] + xs[1]["c"])
        np.testing.assert_allclose(
            res["scaled"], 3.0 * (0.5 * xs[0]["d"] + 0.5 * xs[1]["d"]),
            rtol=1e-6)
        for i, key in enumerate(["a", "c", "b"]):
            np.testing.assert_allclose(res["grouped_%d" % i],
                                       xs[0][key] + xs[1][key], rtol=1e-6)


def test_np2_bucketed_average_equals_unbucketed_and_numpy_mean(np2):
    xs = [_inputs(r) for r in range(2)]
    grads = [[x["a"], x["b"], x["d"], x["a"] * np.float32(2.0)] for x in xs]
    for res in np2:
        for i in range(4):
            b = res["bucketed_%d" % i]
            assert np.array_equal(b, res["single_%d" % i])
            assert np.array_equal(b, res["per_tensor_%d" % i])
            np.testing.assert_allclose(
                b, np.mean([grads[0][i], grads[1][i]], axis=0), rtol=1e-6)
        assert bool(res["bf16_dtype_ok"])
        # bf16 on the wire: 8 mantissa bits.
        np.testing.assert_allclose(res["bf16_0"], (xs[0]["a"] + xs[1]["a"])
                                   / 2, rtol=1e-2, atol=1e-2)


def test_np2_distributed_optimizer_step_is_sgd_on_the_mean_gradient(np2):
    names = [k[len("init_"):] for k in np2[0] if k.startswith("init_")]
    assert int(np2[0]["n_buckets"]) > 1  # HVD_GRAD_BUCKET_BYTES=40
    for n in names:
        mean_grad = (np2[0]["local_grad_" + n]
                     + np2[1]["local_grad_" + n]) / 2
        want = np2[0]["init_" + n] - 0.1 * mean_grad
        for res in np2:
            np.testing.assert_allclose(res["stepped_" + n], want, rtol=1e-5,
                                       atol=1e-7, err_msg=n)
        assert np.array_equal(np2[0]["stepped_" + n], np2[1]["stepped_" + n])


# -------------------------------------------------------------- topology ---

ENV_MATRIX = [
    {},
    {"HOROVOD_RANK": "3", "HOROVOD_SIZE": "8"},
    {"HOROVOD_RANK": "5", "HOROVOD_SIZE": "8", "HOROVOD_LOCAL_RANK": "1",
     "HOROVOD_LOCAL_SIZE": "4"},
    {"HOROVOD_RANK": "5", "HOROVOD_SIZE": "8", "HOROVOD_LOCAL_RANK": "1",
     "HOROVOD_LOCAL_SIZE": "4", "HOROVOD_CROSS_RANK": "1",
     "HOROVOD_CROSS_SIZE": "2"},
    {"HOROVOD_RANK": "2", "HOROVOD_SIZE": "6", "HOROVOD_LOCAL_SIZE": "4"},
    {"OMPI_COMM_WORLD_RANK": "2", "OMPI_COMM_WORLD_SIZE": "4",
     "OMPI_COMM_WORLD_LOCAL_RANK": "0", "OMPI_COMM_WORLD_LOCAL_SIZE": "2"},
    {"OMPI_COMM_WORLD_RANK": "1"},
    {"PMI_RANK": "3", "PMI_SIZE": "4", "MPI_LOCALRANKID": "1",
     "MPI_LOCALNRANKS": "2"},
    {"SLURM_PROCID": "3", "SLURM_STEP_NUM_TASKS": "8(x2)",
     "SLURM_LOCALID": "1", "SLURM_STEP_TASKS_PER_NODE": "4(x2)"},
    {"SLURM_NTASKS": "8", "SLURM_PROCID": "2"},
    {"HOROVOD_RANK": "1", "HOROVOD_SIZE": "2", "PMI_RANK": "0",
     "PMI_SIZE": "4"},
    {"HOROVOD_SIZE": "", "PMI_RANK": "1", "PMI_SIZE": "3"},
]
_ALL_VARS = sorted({k for env in ENV_MATRIX for k in env})


@pytest.mark.parametrize("env", ENV_MATRIX)
def test_topology_matches_reference(monkeypatch, env):
    for name in _ALL_VARS + ["HOROVOD_LOCAL_RANK", "HOROVOD_LOCAL_SIZE",
                             "HOROVOD_CROSS_RANK", "HOROVOD_CROSS_SIZE"]:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert dataclasses.astuple(port_basics._topology_from_env()) == \
        dataclasses.astuple(jax_basics._topology_from_env())


if __name__ == "__main__":
    _worker_main(sys.argv[1], sys.argv[2])
