"""The two-level ladder of the port (``parallel/hierarchical.py``) at np=4
on gloo, laid out as 2 nodes of 2 ranks, and its routing.

* ``hierarchical_allreduce``, ``grouped_hierarchical_allreduce``,
  ``hierarchical_allgather``, and ``allreduce``, ``grouped_allreduce``,
  ``allgather`` and the bucketed ``DistributedOptimizer`` under
  HOROVOD_HIERARCHICAL_ALLREDUCE / HOROVOD_HIERARCHICAL_ALLGATHER, against
  the flat collectives on integer-valued fp32 inputs, whose sums are exact
  in any order: bit for bit.
* The three functions against the JAX package's on a ``(dcn 2, ici 2)``
  mesh of 4 virtual CPU devices, on random inputs, rtol 1e-6.
* The routing predicate: the ladder for Average and Sum on the global set
  with the flag; flat for Min and Adasum, on a registered set, and on a
  layout of one node (np=2, no ladder).

This file, run as a script by each rank (file rendezvous), is the ranks.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FLAGS = ("HOROVOD_HIERARCHICAL_ALLREDUCE", "HOROVOD_HIERARCHICAL_ALLGATHER")
GROUP_SHAPES = ((5,), (3, 3), (1,), (7, 2))


def _ints(rank, shape, seed=0):
    """Small integers as fp32: every sum of four is exact."""
    n = int(np.prod(shape))
    return ((np.arange(n) * (seed + 3) + 7 * rank) % 11 - 5).reshape(
        shape).astype(np.float32)


def _randn(rank, shape, seed=0):
    return np.random.RandomState(seed + 10 * rank).randn(*shape).astype(
        np.float32)


# ---------------------------------------------------------------- worker ---

def _collectives(hvd, rank, out, tag):
    """The public collectives and the bucketed optimizer, saved under
    ``tag``."""
    t = torch.from_numpy
    out[tag + ".ar"] = hvd.allreduce_ingraph(t(_ints(rank, (5, 3)))).numpy()
    out[tag + ".sum"] = hvd.allreduce_ingraph(
        t(_ints(rank, (9,), 1)), op=hvd.Sum, prescale_factor=2.0).numpy()
    for k, g in enumerate(hvd.grouped_allreduce_ingraph(
            [t(_ints(rank, s, j)) for j, s in enumerate(GROUP_SHAPES)])):
        out["%s.grouped%d" % (tag, k)] = g.numpy()
    out[tag + ".ag"] = hvd.allgather_ingraph(
        t(_ints(rank, (rank + 1, 2), 2))).numpy()
    params = [torch.nn.Parameter(t(_ints(0, s, 5))) for s in GROUP_SHAPES]
    opt = hvd.DistributedOptimizer(torch.optim.SGD(params, lr=0.5))
    for k, p in enumerate(params):
        p.grad = t(_ints(rank, p.shape, 6 + k))
    opt.step()
    out[tag + ".buckets"] = np.array(len(opt.buckets))
    for k, p in enumerate(params):
        out["%s.opt%d" % (tag, k)] = p.detach().numpy()


def _worker_main(init_file, out_path):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import collective_ops as C
    from horovod_tpu_torch.parallel import hierarchical as H

    for flag in FLAGS:
        os.environ.pop(flag, None)
    os.environ["HVD_GRAD_BUCKET_BYTES"] = "64"
    hvd.init(device="cpu", init_method="file://" + init_file)
    rank = hvd.rank()
    t = torch.from_numpy
    out = {"ladder": np.array(H.ladder() is not None)}
    if H.ladder() is not None:
        for avg in (True, False):
            out["h.ar%d" % avg] = H.hierarchical_allreduce(
                t(_ints(rank, (4, 3))), average=avg).numpy()
            out["f.ar%d" % avg] = hvd.allreduce_ingraph(
                t(_ints(rank, (4, 3))),
                op=hvd.Average if avg else hvd.Sum).numpy()
        inputs = [t(_ints(rank, s, k)) for k, s in enumerate(GROUP_SHAPES)]
        for k, (h, f) in enumerate(zip(
                H.grouped_hierarchical_allreduce(inputs),
                hvd.grouped_allreduce_ingraph(inputs))):
            out["h.grouped%d" % k], out["f.grouped%d" % k] = \
                h.numpy(), f.numpy()
        out["h.ag"] = H.hierarchical_allgather(t(_ints(rank, (2, 3)))).numpy()
        out["f.ag"] = hvd.allgather_ingraph(t(_ints(rank, (2, 3)))).numpy()
        # Random inputs, for the JAX package's functions.
        out["r.ar"] = H.hierarchical_allreduce(t(_randn(rank, (4, 3)))).numpy()
        for k, g in enumerate(H.grouped_hierarchical_allreduce(
                [t(_randn(rank, s, k)) for k, s in enumerate(GROUP_SHAPES)])):
            out["r.grouped%d" % k] = g.numpy()
        out["r.ag"] = H.hierarchical_allgather(t(_randn(rank, (2, 3)))).numpy()

    calls = [0]
    ladder_sum = H.ladder_sum

    def counted(flat):
        calls[0] += 1
        return ladder_sum(flat)

    H.ladder_sum = counted
    _collectives(hvd, rank, out, "flat")
    out["flat.calls"] = np.array(calls[0])
    for flag in FLAGS:
        os.environ[flag] = "1"
    both = hvd.add_process_set(list(range(hvd.size())))
    out["pred"] = np.array([
        C._route_hierarchical(op, ps, FLAGS[0])
        for op, ps in ((C.Sum, hvd.global_process_set),
                       (C.Average, hvd.global_process_set),
                       (C.Min, hvd.global_process_set),
                       (C.Adasum, hvd.global_process_set),
                       (C.Sum, both))])
    _collectives(hvd, rank, out, "ladder")
    out["ladder.calls"] = np.array(calls[0])
    hvd.shutdown()
    np.savez(out_path, **out)


def _run(n, local_size, tmp):
    init_file = str(tmp / "rendezvous")
    procs, outs = [], []
    for rank in range(n):
        env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(n),
                   HOROVOD_LOCAL_RANK=str(rank % local_size),
                   HOROVOD_LOCAL_SIZE=str(local_size),
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        for name in ("HOROVOD_CROSS_RANK", "HOROVOD_CROSS_SIZE") + FLAGS:
            env.pop(name, None)
        outs.append(str(tmp / ("rank%d.npz" % rank)))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), init_file,
             outs[-1]], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
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


@pytest.fixture(scope="module")
def two_by_two(tmp_path_factory):
    return _run(4, 2, tmp_path_factory.mktemp("ladder_2x2"))


@pytest.fixture(scope="module")
def one_node(tmp_path_factory):
    return _run(2, 2, tmp_path_factory.mktemp("ladder_1x2"))


def _same(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


# ----------------------------------------------------------------- tests ---

def test_ladder_is_bit_equal_to_flat_on_integer_inputs(two_by_two):
    for res in two_by_two:
        assert bool(res["ladder"])
        for key in ("ar1", "ar0", "ag") + tuple(
                "grouped%d" % k for k in range(len(GROUP_SHAPES))):
            _same(res["h." + key], res["f." + key], key)
        routed = [k for k in res if k.startswith("ladder.")
                  and k != "ladder.calls"]
        assert len(routed) == 4 + 2 * len(GROUP_SHAPES)
        for key in routed:
            _same(res[key], res["flat" + key[len("ladder"):]], key)
        assert int(res["flat.calls"]) == 0
        # allreduce, its Sum, the group's buffer and every bucket.
        assert int(res["ladder.calls"]) == 3 + int(res["ladder.buckets"])
    for res in two_by_two[1:]:
        for key in res:
            _same(res[key], two_by_two[0][key], key)


def _in_graph_2x2(fn, per_rank, n_out):
    """The JAX package's ``fn`` on a (dcn 2, ici 2) mesh of 4 virtual CPU
    devices: device (c, l) holds rank 2c + l's arguments."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from horovod_tpu.parallel.mesh import shard_map_compat as shard_map

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("data_dcn", "data_ici"))
    spec = P(("data_dcn", "data_ici"))
    n_in = len(per_rank[0])

    def body(*xs):
        return tuple(o[None] for o in fn(*[x[0] for x in xs]))

    out = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec,) * n_in,
                            out_specs=(spec,) * n_out))(
        *[np.stack([args[i] for args in per_rank]) for i in range(n_in)])
    return [np.asarray(o) for o in out]


def test_functions_match_the_jax_package(two_by_two):
    from horovod_tpu.parallel import hierarchical as J

    def close(got, want, what):
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=what)

    (ar,) = _in_graph_2x2(lambda x: (J.hierarchical_allreduce(x),),
                          [[_randn(r, (4, 3))] for r in range(4)], 1)
    grouped = _in_graph_2x2(
        lambda *xs: tuple(J.grouped_hierarchical_allreduce(list(xs))),
        [[_randn(r, s, k) for k, s in enumerate(GROUP_SHAPES)]
         for r in range(4)], len(GROUP_SHAPES))
    (ag,) = _in_graph_2x2(lambda x: (J.hierarchical_allgather(x),),
                          [[_randn(r, (2, 3))] for r in range(4)], 1)
    for rank, res in enumerate(two_by_two):
        close(res["r.ar"], ar[rank], "hierarchical_allreduce")
        for k in range(len(GROUP_SHAPES)):
            close(res["r.grouped%d" % k], grouped[k][rank],
                  "grouped_hierarchical_allreduce %d" % k)
        close(res["r.ag"], ag[rank], "hierarchical_allgather")


def test_routing_predicate(two_by_two, one_node):
    for res in two_by_two:
        assert res["pred"].tolist() == [True, True, False, False, False]
    for res in one_node:
        assert not bool(res["ladder"])
        assert res["pred"].tolist() == [False] * 5
        assert int(res["ladder.calls"]) == 0
        for key in res:
            if key.startswith("ladder.") and key != "ladder.calls":
                _same(res[key], res["flat" + key[len("ladder"):]], key)


if __name__ == "__main__":
    _worker_main(sys.argv[1], sys.argv[2])
