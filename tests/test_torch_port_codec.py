"""The wire codecs of the port (``horovod_tpu_torch/ops/codec.py``) and the
device plane's compressed ring, bit for bit against the native core.

* The plain encode and decode, decode-reduce and int8 error feedback
  against the port's core (``hvd_codec_roundtrip``, core/src/codec.cc) on
  seeded blocks and edge blocks: zeros, NaN at the start, middle and end,
  infinities, subnormals, fp16 overflow, bf16 halfway values, int8
  halfway values, blocks of 0, 1 and 3 elements.
* tests/torch_port_codec_worker.py's matrix under bf16, fp16 and int8
  (``HVD_WIRE_CODEC``, then ``stage_wire_codec``), run at np 1, 2 and 3
  (3 is the odd world, where the ring's partition and int8's scales
  matter) in three modes, each package in processes of its own: the JAX
  package (np 2 and 3; at size 1 it starts no core), the port on its TCP
  ring, and the port with the device plane on the CPU over gloo, whose
  compressed ring runs the plain codec functions. All three agree bit for
  bit, and so do their codec counters; every other dtype stays exact;
  int8's residuals carry over three steps of a named tensor and a codec
  flip drops them.
* The one-process simulated ring (``codec.simulated_ring``, which the
  card check of chip_smoke.py runs) against the TCP ring's results.
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from horovod_tpu_torch.compression import CODEC_IDS, WIRE_TOLERANCE
from horovod_tpu_torch.ops import codec
from torch_port_codec_worker import COUNTS
from torch_port_runs import start_runs

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_port_codec_worker.py")
CODECS = ("bf16", "fp16", "int8")
SIZES = (1, 2, 3)
OPS = {"sum": 1, "min": 3, "max": 4, "product": 5, "average": 0,
       "copy": codec.COPY}


def _bits(*words):
    return torch.from_numpy(np.array(words, dtype=np.uint32).view(
        np.float32))


def _edge_blocks():
    nan, inf = float("nan"), float("inf")
    rng = np.random.RandomState(5)
    wide = rng.randn(3 * codec.CHUNK + 5).astype(np.float32) * 3
    across = wide.copy()
    across[codec.CHUNK - 1] = nan  # the last element of the first chunk
    return {
        "seeded": torch.from_numpy(rng.randn(10007).astype(np.float32) * 3),
        "zeros": torch.zeros(17),
        "nan_first": torch.tensor([nan, 1.0, -5.0, 2.0]),
        "nan_middle": torch.tensor([100.0, nan, 1.0, -5.0, 2.0]),
        "nan_last": torch.tensor([1.0, -5.0, 2.0, nan]),
        "nan_only": torch.tensor([nan, nan]),
        "nan_across_chunks": torch.from_numpy(across),
        "infinities": torch.tensor([1.0, inf, -2.0, -inf]),
        "subnormals": torch.tensor([1e-40, -3e-41, 1e-45, 0.0]),
        "tiny": torch.tensor([1e-45, -1e-45]),
        "fp16_overflow": torch.tensor([7e4, -1e5, 65504.0, 65520.0, 1e-8,
                                       6e-5, -6e-8]),
        "bf16_halfway": _bits(0x3F808000, 0x3F818000, 0x3F80FFFF,
                              0x7F7FFFFF, 0xFF7F8000, 0x7FFFFFFF),
        "int8_halfway": torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5]),
        "empty": torch.zeros(0),
        "one": torch.tensor([-3.5]),
        "three": torch.tensor([0.25, -7.0, 3.0]),
    }


EDGE = _edge_blocks()


@pytest.fixture(scope="module")
def core():
    """The port's core, for its codec hooks (no session is started)."""
    from horovod_tpu_torch.core.build import library_path

    lib = ctypes.CDLL(library_path())
    lib.hvd_codec_roundtrip.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_longlong]
    lib.hvd_codec_roundtrip.restype = ctypes.c_longlong

    def roundtrip(cid, x):
        y = x.clone().contiguous()
        assert lib.hvd_codec_roundtrip(cid, y.data_ptr(), y.numel()) == \
            codec.wire_bytes(cid, y.numel())
        return y

    return roundtrip


def _plain_roundtrip(cid, x):
    wire = torch.empty(codec.wire_bytes(cid, x.numel()) + 16,
                       dtype=torch.uint8)
    codec.plain_encode(cid, x, wire)
    return codec.plain_decode(cid, wire, x.numel())


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("block", sorted(EDGE))
@pytest.mark.parametrize("name", CODECS)
def test_plain_encode_decode_is_the_cores_roundtrip(core, name, block):
    cid = CODEC_IDS[name]
    x = EDGE[block]
    assert _same(_plain_roundtrip(cid, x), core(cid, x))


@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("name", CODECS)
def test_plain_decode_reduce_is_the_cores_reduce(core, name, op):
    """Decoded values (the core's round trip) combined as ReduceBuffer
    combines fp32 (std::min/std::max keep the left on a NaN), into edge
    and seeded ranges, NaN and infinities included."""
    cid = CODEC_IDS[name]
    rng = np.random.RandomState(11)
    for block in ("seeded", "nan_middle", "infinities", "bf16_halfway",
                  "three", "empty"):
        src = EDGE[block]
        dst = torch.from_numpy(
            rng.randn(src.numel()).astype(np.float32) * 2)
        if block == "three":
            dst[1] = float("nan")
        d = core(cid, src).numpy()
        a = dst.numpy().copy()
        want = {"sum": a + d, "min": np.where(d < a, d, a),
                "max": np.where(a < d, d, a), "product": a * d,
                "average": a + d, "copy": d}[op].astype(np.float32)
        wire = torch.empty(codec.wire_bytes(cid, src.numel()) + 16,
                           dtype=torch.uint8)
        codec.plain_encode(cid, src, wire)
        got = dst.clone()
        codec.decode_reduce(cid, wire, got, OPS[op])
        assert _same(got, torch.from_numpy(want)), block


def test_plain_error_feedback_is_the_cores(core):
    """Three steps of operations.cc's feedback on several tensors at once,
    each with its own scale: x += r; xq = roundtrip(x); r = x - xq."""
    rng = np.random.RandomState(3)
    sizes = (1, 5000, 3, 4097, 2)
    xs_r = [np.zeros(k, np.float32) for k in sizes]
    rs = [torch.zeros(k) for k in sizes]
    for step in range(3):
        xs = [rng.randn(k).astype(np.float32) * (1 + i) for i, k in
              enumerate(sizes)]
        xs[1][7] = np.nan if step == 1 else xs[1][7]
        got = [torch.from_numpy(x.copy()) for x in xs]
        codec.error_feedback(got, rs)
        for i, x in enumerate(xs):
            v = x + xs_r[i]
            xq = core(codec.INT8, torch.from_numpy(v)).numpy()
            xs_r[i] = v - xq
            assert got[i].numpy().tobytes() == xq.tobytes(), (step, i)
            assert rs[i].numpy().tobytes() == xs_r[i].tobytes(), (step, i)


def test_ring_partition_is_the_cores():
    from horovod_tpu_torch.core.build import library_path

    lib = ctypes.CDLL(library_path())
    lib.hvd_ring_partition.argtypes = [
        ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong)]
    lib.hvd_ring_partition.restype = ctypes.c_int
    for count, n in ((0, 3), (2, 3), (7, 3), (25557032, 4), (5, 1)):
        counts = (ctypes.c_longlong * n)()
        offsets = (ctypes.c_longlong * n)()
        assert lib.hvd_ring_partition(count, n, counts, offsets) == 0
        assert codec.partition(count, n) == (list(counts), list(offsets))


# ------------------------------------------------------------------ runs ---

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(mode, size): [rank 0's results, ...]}: every run at once, with
    HVD_WIRE_CODEC=bf16 (tests/torch_port_runs.py)."""
    specs = [(("jax", n), n, ["jax"]) for n in SIZES if n > 1]
    specs += [((mode, n), n, [mode]) for mode in ("port", "plane")
              for n in SIZES]
    return start_runs(WORKER, specs, tmp_path_factory.mktemp("codec"),
                      env={"HVD_WIRE_CODEC": "bf16",
                           "HVD_FLIGHTREC_EVENTS": "65536"})


FAMILIES = {
    "one_tensor": ".one.", "fused": ".fused.", "reducescatter": ".rs.",
    "other_dtypes": ".raw.", "feedback": ".ef.", "join": ".join",
    "counters": "counters", "flight_records": "wire_codec_records"}


def _family(res, family):
    return {k: v for k, v in res.items()
            if FAMILIES[family] in k and not k.startswith(("in.", "res."))}


def _assert_bitwise(a, b):
    assert sorted(a) == sorted(b)
    assert a, "no results"
    for k in a:
        assert (a[k].dtype, a[k].shape) == (b[k].dtype, b[k].shape), k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plane_matches_the_tcp_ring(runs, family, size):
    """The device plane's compressed ring (plain codec functions on gloo)
    against the port's TCP ring."""
    for ring, plane in zip(runs["port", size], runs["plane", size]):
        _assert_bitwise(_family(ring, family), _family(plane, family))


@pytest.mark.parametrize("size", [n for n in SIZES if n > 1])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_port_matches_the_jax_package(runs, family, size):
    for jax_res, port_res in zip(runs["jax", size], runs["port", size]):
        _assert_bitwise(_family(jax_res, family), _family(port_res, family))


@pytest.mark.parametrize("size", SIZES)
def test_other_dtypes_stay_exact(runs, size):
    """Every dtype but fp32 gives, under each codec, its bytes with no
    codec."""
    for res in runs["plane", size] + runs["port", size]:
        raw = [k for k in res if k.startswith("none.raw.")
               and not k.endswith(".shape")]
        assert len(raw) == 16
        for name in CODECS:
            for k in raw:
                mine = name + k[len("none"):]
                assert res[mine].tobytes() == res[k].tobytes(), mine


@pytest.mark.parametrize("size", SIZES)
def test_int8_residuals_carry_over_and_a_flip_drops_them(runs, size):
    """The plane's residuals of the named tensor after each int8 step are
    the core's feedback of that rank's inputs (they depend on nothing
    else); a codec flip dropped them, so the repeated first step gives
    the first step's bytes."""
    from torch_port_codec_worker import ef_input

    for r, res in enumerate(runs["plane", size]):
        resid = torch.zeros(ef_input(0, r).numel())
        for step in range(3):
            x = ef_input(step, r) + resid
            wire = torch.empty(codec.wire_bytes(codec.INT8, x.numel()),
                               dtype=torch.uint8)
            codec.plain_encode(codec.INT8, x, wire)
            xq = codec.plain_decode(codec.INT8, wire, x.numel())
            resid = x - xq
            got = res["res.int8.ef.%d" % step]
            assert got.tobytes() == resid.numpy().tobytes(), step
            assert np.abs(got).max() > 0
        assert res["flip.ef.0"].tobytes() == res["int8.ef.0"].tobytes()
        assert res["res.flip.ef.0"].tobytes() == \
            res["res.int8.ef.0"].tobytes()
        assert res["int8.ef.1"].tobytes() != res["flip.ef.0"].tobytes()


@pytest.mark.parametrize("size", SIZES)
def test_codec_counters_agree(runs, size):
    """codec_saved_bytes and the sends per codec: no ring at size 1; above
    it the plane's ring counts what the TCP ring counts."""
    modes = ("plane", "port") + (("jax",) if size > 1 else ())
    for r in range(size):
        # Per rank: at odd sizes the ranks send chunks of other sizes.
        counters = [runs[mode, size][r]["counters"] for mode in modes]
        assert all(np.array_equal(c, counters[0]) for c in counters), r
        if size == 1:
            assert not counters[0].any()
        else:
            assert (counters[0] > 0).all()


@pytest.mark.parametrize("size", [n for n in SIZES if n > 1])
@pytest.mark.parametrize("name", CODECS)
def test_fp32_sums_within_the_wire_tolerance(runs, name, size):
    """One-tensor sums against the exact sum of the ranks' inputs, within
    ``WIRE_TOLERANCE`` as the JAX package's equality worker applies it
    (tests/wire_equality_worker.py: ``atol`` times the world size, since
    each of the n - 1 hops and the allgather's encode may err by it, and
    ``rtol``): the codec is lossy, not wrong."""
    tol = WIRE_TOLERANCE[name]
    ranks = runs["plane", size]
    keys = [k[3:] for k in ranks[0]
            if k.startswith("in.%s." % name) and not k.endswith(".shape")]
    assert len(keys) == len(COUNTS)
    for k in keys:
        exact = sum(res["in." + k].astype(np.float64) for res in ranks)
        for res in ranks:
            err = np.abs(res[k] - exact)
            limit = tol["atol"] * size + tol["rtol"] * np.abs(exact)
            assert (err <= limit).all(), k


@pytest.mark.parametrize("size", [n for n in SIZES if n > 1])
@pytest.mark.parametrize("name", CODECS)
def test_simulated_ring_is_the_tcp_ring(runs, name, size):
    """``simulated_ring`` over the ranks' inputs (after int8's feedback with
    fresh residuals, as the core applies it) gives every rank's TCP ring
    result, bit for bit: at counts whose chunks start at every phase in a
    16-byte word, each member's wire bytes placed at its chunk's phase."""
    ranks = runs["port", size]
    cid = CODEC_IDS[name]
    for count in COUNTS:
        k = "%s.one.%d.sum.0" % (name, count)
        bufs = [torch.from_numpy(res["in." + k].copy()) for res in ranks]
        if cid == codec.INT8:
            codec.error_feedback(bufs, [torch.zeros(count) for _ in bufs])
        codec.simulated_ring(bufs, 1, cid)
        for buf, res in zip(bufs, ranks):
            assert buf.numpy().tobytes() == res[k].tobytes(), (k, count)


def test_card_submissions_under_every_codec_run_on_the_plane():
    """With the device plane attached (on the CPU), a submission that goes
    to it under each codec completes: no codec is refused any more. At
    size 1 the ring moves nothing and int8's feedback still runs: the
    result is the int8 round trip of the input, and the residual is kept
    by the tensor's name."""
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvd_t
    from horovod_tpu_torch.core import device_plane

    env = {k: os.environ.pop(k) for k in list(os.environ)
           if k.startswith(("HOROVOD_", "OMPI_", "PMI_", "SLURM_"))
           or k == "HVD_WIRE_CODEC"}
    hvd.init(device="cpu")
    try:
        session = hvd_t.core_session()
        plane = device_plane.attach(session, torch.device("cpu"), 1)
        x = torch.from_numpy(np.random.RandomState(9).randn(
            300).astype(np.float32))
        for name in CODECS:
            assert session.stage_wire_codec(name)
            hvd_t.allreduce(torch.zeros(1, dtype=torch.int32),
                            name="stage." + name)
            assert session.wire_codec() == CODEC_IDS[name]
            before = plane.responses, session.counters()["responses"]
            got = hvd_t.allreduce(x, name="card." + name, op=hvd_t.Sum)
            hvd_t.grouped_allreduce([x, x[:7]], name="cardg." + name)
            hvd_t.reducescatter(x.reshape(30, 10), name="cardrs." + name)
            # The plane ran every response (a group whose submission
            # straddles a negotiation cycle runs as two).
            ran = plane.responses - before[0]
            assert ran >= 3
            assert ran == session.counters()["responses"] - before[1]
            want = x if name != "int8" else _plain_roundtrip(codec.INT8, x)
            assert _same(got, want), name
        assert sorted(k.split("card.")[-1] for k in plane.residuals
                      if "card." in k) == ["int8"]
    finally:
        hvd.shutdown()
        os.environ.update(env)
