"""Adasum in the port, against the JAX package and a model of the core.

* ``parallel/adasum.py``: ``adasum_pair``, the tree and ``adasum_reference``
  against the JAX package's on the same seeded inputs; the in-graph
  ``allreduce(op=Adasum)`` at np = 2, 3 (the odd carry) and 4 on gloo
  against the JAX package's ``adasum_allreduce`` on as many virtual CPU
  devices, rtol 1e-5 and atol 1e-6 of the largest magnitude (both sum
  fp32 dots, in other orders).
* ``ops/adasum.py``, the device plane's fp64 tree: the plain versions of
  the kernels against a numpy float64 model of the native core's
  ``AdasumAllreduce`` (``core/src/collectives.cc:145-245``), and the tree
  with an exchange that copies between buffers of one process against
  ``adasum_reference``.

This file, run as a script by each rank (file rendezvous), is the ranks of
the in-graph runs; at np=2 they also take one step of the bucketed
``DistributedOptimizer`` with ``op=Adasum`` (tests/test_torch_port_train_
step.py holds it to the JAX optimizer).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
RTOL, ATOL = 1e-5, 1e-6
SHAPES = ((6, 5), (7,), (1,), (3, 4, 2))


def _x(rank, shape, seed=0):
    """Rank ``rank``'s seeded input; every third rank's points away from
    the others, so that the coefficients move off 1/2 and 1."""
    rng = np.random.RandomState(seed + 100 * rank)
    x = rng.randn(*shape).astype(np.float32)
    return -x if rank % 3 == 2 else x


def _mlp_weights():
    rng = np.random.RandomState(3)
    return {"w1": rng.randn(3, 4).astype(np.float32),
            "b1": rng.randn(4).astype(np.float32),
            "w2": rng.randn(4, 2).astype(np.float32)}


def _mlp_batch(rank):
    rng = np.random.RandomState(40 + rank)
    return (rng.randn(5, 3).astype(np.float32),
            rng.randn(5, 2).astype(np.float32))


def _mlp_loss(w, x, y, np_like):
    h = np_like.tanh(x @ w["w1"] + w["b1"])
    return ((h @ w["w2"] - y) ** 2).mean()


# ---------------------------------------------------------------- worker ---

def _worker_main(init_file, out_path):
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", init_method="file://" + init_file)
    rank, n = hvd.rank(), hvd.size()
    out = {}
    t = torch.from_numpy
    for k, shape in enumerate(SHAPES):
        out["ar%d" % k] = hvd.allreduce_ingraph(t(_x(rank, shape, k)),
                                                op=hvd.Adasum).numpy()
    out["scaled"] = hvd.allreduce_ingraph(
        t(_x(rank, (9,), 7)), op=hvd.Adasum, prescale_factor=0.5,
        postscale_factor=4.0).numpy()
    grouped = hvd.grouped_allreduce_ingraph(
        [t(_x(rank, shape, k)) for k, shape in enumerate(SHAPES)],
        op=hvd.Adasum)
    for k, g in enumerate(grouped):
        out["grouped%d" % k] = g.numpy()
    if n == 2:
        w = {k: torch.nn.Parameter(t(v.copy()))
             for k, v in _mlp_weights().items()}
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(list(w.values()), lr=0.1), op=hvd.Adasum)
        x, y = _mlp_batch(rank)
        _mlp_loss(w, t(x), t(y), torch).backward()
        opt.step()
        out["opt_buckets"] = np.array([len(b.indices) for b in opt.buckets])
        for k, p in w.items():
            out["opt." + k] = p.detach().numpy()
    hvd.shutdown()
    np.savez(out_path, **out)


def run_ranks(n, tmp):
    """Runs this file as ``n`` ranks; returns each rank's results."""
    init_file = str(tmp / "rendezvous")
    procs, outs = [], []
    for rank in range(n):
        env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(n),
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(n),
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
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


@pytest.fixture(scope="module", params=[2, 3, 4], ids=lambda n: "np%d" % n)
def ranks(request, tmp_path_factory):
    n = request.param
    return n, run_ranks(n, tmp_path_factory.mktemp("adasum_np%d" % n))


# ------------------------------------------------- against the reference ---

def _in_graph(fn, per_rank):
    """The JAX package's in-graph ``fn`` over len(per_rank) virtual CPU
    devices on the axis "data"; returns each rank's output."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from horovod_tpu.parallel.mesh import shard_map_compat as shard_map

    mesh = Mesh(np.array(jax.devices()[:len(per_rank)]), ("data",))
    out = jax.jit(shard_map(lambda s: fn(s[0])[None], mesh=mesh,
                            in_specs=P("data"), out_specs=P("data")))(
        np.stack(per_rank))
    return list(np.asarray(out))


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max(), err_msg=what)


def test_in_graph_adasum_matches_the_jax_package(ranks):
    from horovod_tpu.ops import collective_ops as JC
    from horovod_tpu.parallel.adasum import adasum_allreduce

    n, res = ranks
    cases = [("ar%d" % k, "grouped%d" % k, [_x(r, s, k) for r in range(n)])
             for k, s in enumerate(SHAPES)]
    for single, grouped, inputs in cases:
        want = _in_graph(lambda s: adasum_allreduce(s), inputs)
        for rank in range(n):
            _close(res[rank][single], want[rank], single)
            _close(res[rank][grouped], want[rank], grouped)
    inputs = [_x(r, (9,), 7) for r in range(n)]
    want = _in_graph(lambda s: JC.allreduce(s, JC.Adasum,
                                            prescale_factor=0.5,
                                            postscale_factor=4.0), inputs)
    for rank in range(n):
        _close(res[rank]["scaled"], want[rank], "scaled")
        # Every rank merges the same gathered list: the same bits.
        for key in res[0]:
            if not key.startswith("opt"):
                np.testing.assert_array_equal(res[rank][key], res[0][key])


def test_adasum_pair_tree_and_reference_match_the_jax_package():
    import jax.numpy as jnp
    from horovod_tpu.parallel import adasum as J
    from horovod_tpu_torch.parallel import adasum as T

    rng = np.random.RandomState(5)
    for shape in SHAPES:
        a = rng.randn(*shape).astype(np.float32)
        b = rng.randn(*shape).astype(np.float32)
        for x, y in ((a, b), (a, -0.5 * a), (a, np.zeros_like(a)),
                     (np.zeros_like(a), b)):
            got = T.adasum_pair(torch.from_numpy(x), torch.from_numpy(y))
            want = np.asarray(J.adasum_pair(jnp.asarray(x), jnp.asarray(y)))
            _close(got.numpy(), want, "pair %s" % (shape,))
    for count in range(1, 6):
        vals = [rng.randn(4, 3).astype(np.float32) for _ in range(count)]
        got = T._tree_reduce([torch.from_numpy(v) for v in vals]).numpy()
        want = np.asarray(J._tree_reduce([jnp.asarray(v) for v in vals]))
        _close(got, want, "tree of %d" % count)
        assert np.array_equal(T.adasum_reference(vals),
                              J.adasum_reference(vals))
        _close(got, T.adasum_reference(vals), "tree vs float64")


# --------------------------------------- the device plane's fp64 tree ---

def _core_float_to_half(f):
    """codec.h FloatToHalf on a float32 array: truncating."""
    u = f.astype(np.float32).view(np.uint32).astype(np.int64)
    sign = (u >> 16) & 0x8000
    exp = ((u >> 23) & 0xFF) - 127 + 15
    mant = u & 0x7FFFFF
    sub = sign | ((mant | 0x800000) >> np.clip(14 - exp, 0, 63))
    out = np.where(exp <= 0, np.where(exp < -10, sign, sub),
                   np.where(exp >= 31, sign | 0x7C00,
                            sign | (np.maximum(exp, 0) << 10) | (mant >> 13)))
    return out.astype(np.uint16).view(np.float16)


def _core_float_to_bf16_bits(f):
    """codec.h FloatToBf16 on a float32 array, as uint16 bits."""
    u = f.astype(np.float32).view(np.uint32).astype(np.int64)
    return (((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFFFFFF) >> 16).astype(
        np.uint16)


def _core_pair(a, b):
    """collectives.cc:219-233: sequential double sums, then the merge."""
    dot = np.cumsum(a * b)[-1] if a.size else 0.0
    asq = np.cumsum(a * a)[-1] if a.size else 0.0
    bsq = np.cumsum(b * b)[-1] if b.size else 0.0
    ca = 1.0 - dot / (2.0 * asq) if asq > 1e-30 else 1.0
    cb = 1.0 - dot / (2.0 * bsq) if bsq > 1e-30 else 1.0
    return np.array([dot, asq, bsq]), ca * a + cb * b


COUNTS = (5, 0, 4097, 1, 300, 9000)


def test_plain_kernels_match_a_model_of_the_core():
    from horovod_tpu_torch.ops import adasum

    rng = np.random.RandomState(8)
    segs = adasum.Segments(COUNTS, torch.device("cpu"))
    assert segs.chunks == sum(-(-c // adasum.CHUNK) for c in COUNTS)
    a = rng.randn(segs.total) * 3.0
    b = rng.randn(segs.total) - 0.2 * a
    b[segs.offsets[3]:segs.offsets[3] + 1] = 0.0  # |b|^2 = 0: cb = 1
    mine, theirs = torch.from_numpy(a.copy()), torch.from_numpy(b)
    dots = adasum.plain_dots(mine, theirs, segs)
    adasum.plain_combine(mine, theirs, dots, segs)
    for s, (off, c) in enumerate(zip(segs.offsets, segs.counts)):
        want_dots, want = _core_pair(a[off:off + c], b[off:off + c])
        scale = np.array([np.linalg.norm(a[off:off + c])
                          * np.linalg.norm(b[off:off + c]),
                          want_dots[1], want_dots[2]])
        assert np.all(np.abs(dots[s].numpy() - want_dots)
                      <= 1e-12 * scale), s
        # Given the same dots, the merge is the model's bit for bit.
        d = dots[s].numpy()
        ca = 1.0 - d[0] / (2.0 * d[1]) if d[1] > 1e-30 else 1.0
        cb = 1.0 - d[0] / (2.0 * d[2]) if d[2] > 1e-30 else 1.0
        assert np.array_equal(mine[off:off + c].numpy(),
                              ca * a[off:off + c] + cb * b[off:off + c]), s
        np.testing.assert_allclose(mine[off:off + c].numpy(), want,
                                   rtol=0, atol=1e-12 * np.abs(want).max()
                                   if c else 0)

    # ToDouble and FromDouble (collectives.cc:145-195).
    y = rng.randn(2000) * 100.0
    y[:4] = [0.0, -0.0, 1e-9, 65519.9]
    for dt in adasum.FLOATS:
        x = torch.from_numpy(y).to(dt)
        if dt == torch.bfloat16:
            bits = x.view(torch.int16).numpy().view(np.uint16)
            exact = (bits.astype(np.uint32) << 16).view(np.float32)
        else:
            exact = x.numpy()
        assert np.array_equal(adasum.plain_to_double(x).numpy(),
                              exact.astype(np.float64)), dt
        got = adasum.plain_from_double(torch.from_numpy(y), dt)
        f32 = y.astype(np.float32)
        if dt == torch.float16:
            want = _core_float_to_half(f32).view(np.int16)
        elif dt == torch.bfloat16:
            want = _core_float_to_bf16_bits(f32).view(np.int16)
        elif dt == torch.float32:
            want = f32
        else:
            want = y
        view = torch.int16 if dt in (torch.float16, torch.bfloat16) else dt
        assert np.array_equal(got.view(view).numpy(), want), dt


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_plane_tree_with_a_copying_exchange_matches_the_reference(n):
    from horovod_tpu_torch.ops import adasum
    from horovod_tpu_torch.parallel.adasum import adasum_reference

    rng = np.random.RandomState(20 + n)
    segs = adasum.Segments(COUNTS, torch.device("cpu"))
    values = [rng.randn(segs.total) * (1 + r) for r in range(n)]
    got = adasum.simulated_tree([torch.from_numpy(v.copy()) for v in values],
                                segs).numpy()
    for off, c in zip(segs.offsets, segs.counts):
        want = adasum_reference([v[off:off + c] for v in values])
        np.testing.assert_allclose(got[off:off + c], want, rtol=0,
                                   atol=1e-12 * (np.abs(want).max() if c
                                                 else 0))
    # In a dtype: FromDouble of the fp64 result, within one unit in the
    # last place of the reference's value converted the core's way.
    for dt in (torch.float32, torch.float16, torch.bfloat16):
        cast = [torch.from_numpy(v).to(dt) for v in values]
        mines = [torch.empty(segs.total, dtype=torch.float64) for _ in cast]
        for src, dst in zip(cast, mines):
            adasum.to_double(src, dst)
        merged = torch.empty(segs.total, dtype=dt)
        adasum.from_double(adasum.simulated_tree(mines, segs), merged)
        want = np.concatenate([adasum_reference(
            [adasum.plain_to_double(x[off:off + c]).numpy() for x in cast])
            for off, c in zip(segs.offsets, segs.counts)])
        want = adasum.plain_from_double(torch.from_numpy(want), dt)
        assert int(adasum.ulp_distance(merged, want).max()) <= 1, dt


def test_plane_tree_of_two_equals_the_pair_merge():
    """At two members the tree is one merge: exactly the plain kernels'
    result on member 0's and member 1's buffers."""
    from horovod_tpu_torch.ops import adasum

    rng = np.random.RandomState(4)
    segs = adasum.Segments(COUNTS, torch.device("cpu"))
    a, b = rng.randn(segs.total), rng.randn(segs.total)
    got = adasum.simulated_tree([torch.from_numpy(a.copy()),
                                 torch.from_numpy(b.copy())], segs)
    mine, theirs = torch.from_numpy(a.copy()), torch.from_numpy(b)
    adasum.plain_combine(mine, theirs,
                         adasum.plain_dots(mine, theirs, segs), segs)
    assert torch.equal(got, mine)


def test_adasum_refuses_integer_dtypes():
    from horovod_tpu_torch.ops import adasum

    with pytest.raises(TypeError, match="floating-point"):
        adasum.to_double(torch.arange(4), torch.empty(4, dtype=torch.float64))


if __name__ == "__main__":
    _worker_main(sys.argv[1], sys.argv[2])
