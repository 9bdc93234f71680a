"""One rank of the wire codecs' parity runs.

Run as a script, ``python torch_port_codec_worker.py MODE OUT``, by 1 to 3
processes that share the launcher environment (HOROVOD_RANK, SIZE,
CONTROLLER_ADDR, CONTROLLER_PORT) and ``HVD_WIRE_CODEC=bf16``; MODE is
``jax``, ``port`` or ``plane`` as in tests/torch_port_eager_worker.py (in
``plane`` every tensor takes the device plane's compressed ring, on the
CPU over gloo with the plain codec functions).

Under each codec in turn (bf16 from the knob, then fp16 and int8 staged
with ``stage_wire_codec``), it saves: fp32 allreduce of one tensor at
counts below, at and above the world size, for the five ops at two
scalings; a group of ragged tensors run as one fused response (the ring's
chunks, and so its int8 scales, follow the fused buffer); reducescatter
with rows above and below the world size; every other dtype (which must stay
bit-exact); and three steps of one named tensor, whose int8 residuals
carry over. Then it flips to bf16 and back to int8 and repeats the first
int8 step (its residuals must have been dropped), lets the last rank
join while the others allreduce, runs the other dtypes
once more with no codec, and saves the codec counters and the core's
WIRE_CODEC flight records. In ``plane`` mode
it also saves the plane's residuals of the named tensor after each int8
step.
"""

import sys

import numpy as np
import torch

from torch_port_eager_worker import BASE, _import, _save

CODECS = ("bf16", "fp16", "int8")
# Counts of one fp32 tensor. Over a ring of n members a count of 4nq + r
# gives chunks that start at other phases in a 16-byte word for each r:
# 1, 2 and 3 (mod 8 and mod 12) are among them.
COUNTS = (1, 2, 7, 1000, 1011, 4099)
SCALES = ((1.0, 1.0), (0.5, 3.0))
FUSED = (5, 4097, 1, 300, 2)
RS_ROWS = (1, 7)
EF_COUNT = 1003
RAW_DTYPES = (torch.float64, torch.float16, torch.bfloat16, torch.int32,
              torch.int64, torch.uint8, torch.int8, torch.bool)
COUNTER_KEYS = ("codec_saved_bytes", "codec_bf16_sends", "codec_fp16_sends",
                "codec_int8_sends")


def values(seed, count, op):
    """Seeded fp32 values; near 1 for Product, so that it stays finite."""
    x = np.random.RandomState(seed).randn(count).astype(np.float32)
    if op == "product":
        x = 1.0 + 0.25 * x
    return torch.from_numpy(x)


def ef_input(step, rank):
    return values(7000 + 10 * step + rank, EF_COUNT, "sum")


def adopted(hvd, session, name, ids, tag):
    """Whether every rank has adopted codec ``name``. A rank reads its
    codec before it joins the allreduce of what it read, so no rank can
    stage the next codec while another is still reading."""
    seen = torch.tensor([session.wire_codec()], dtype=torch.int32)
    low = hvd.allreduce(seen, name="seen.min." + tag, op=hvd.Min)
    high = hvd.allreduce(seen, name="seen.max." + tag, op=hvd.Max)
    return int(low) == int(high) == ids[name]


def stage(hvd, session, name, ids, tag):
    """Stage ``name`` and let one negotiation round adopt it everywhere."""
    assert session.stage_wire_codec(name)
    hvd.allreduce(torch.zeros(1, dtype=torch.int32), name="stage." + tag,
                  op=hvd.Sum)
    assert adopted(hvd, session, name, ids, tag), name


def fused(hvd, session, key, xs, op, wasted):
    """A group that the core ran as one fused response. The core learns a
    group's members from the requests it has seen, so a group whose
    submission straddles a negotiation cycle on every rank runs as two
    responses, whose ring chunks (and int8 scales) differ: such an attempt
    is repeated under a fresh name (the same on every rank, since every
    rank executes the same responses), and its codec sends and WIRE_CODEC
    records are kept in ``wasted``."""
    for attempt in range(20):
        before, first = session.counters(), len(wire_codec_records(session))
        res = hvd.grouped_allreduce(xs, name="%s.%d" % (key, attempt),
                                    op=op)
        after = session.counters()
        if after["responses"] - before["responses"] == 1:
            return res
        for i, k in enumerate(COUNTER_KEYS):
            wasted["counters"][i] += after[k] - before[k]
        wasted["records"] += range(first, len(wire_codec_records(session)))
    raise AssertionError("%s never ran as one response" % key)


def matrix(hvd, session, r, n, c, out, wasted):
    ops = {"sum": hvd.Sum, "min": hvd.Min, "max": hvd.Max,
           "product": hvd.Product, "average": hvd.Average}
    seed = 1000 * CODECS.index(c) + 100 * r
    for count in COUNTS:
        for oname, op in ops.items():
            for i, (pre, post) in enumerate(SCALES):
                key = "%s.one.%d.%s.%d" % (c, count, oname, i)
                x = values(seed + count + 7 * i, count, oname)
                if oname == "sum" and i == 0:
                    _save(out, "in." + key, x)
                _save(out, key, hvd.allreduce(
                    x, name=key, op=op, prescale_factor=pre,
                    postscale_factor=post))
    for oname, op in ops.items():
        key = "%s.fused.%s" % (c, oname)
        xs = [values(seed + 31 * k, k, oname) for k in FUSED]
        _save(out, key, fused(hvd, session, key, xs, op, wasted))
    for oname in ("sum", "average"):
        for rows in RS_ROWS:
            key = "%s.rs.%s.%d" % (c, oname, rows)
            x = values(seed + 53 * rows, 3 * rows, oname).reshape(rows, 3)
            _save(out, key, hvd.reducescatter(x, op=ops[oname], name=key))
    raw(hvd, r, c, out)


def raw(hvd, r, c, out):
    """Every dtype but fp32, which no codec compresses."""
    for dt in RAW_DTYPES:
        key = "%s.raw.%s" % (c, dt)
        x = torch.tensor(BASE * (r + 1) - 1.5 * r).to(dt)
        for oname, op in (("sum", hvd.Sum), ("max", hvd.Max)):
            _save(out, "%s.%s" % (key, oname), hvd.allreduce(
                x, name="%s.%s" % (key, oname), op=op))


def feedback_steps(hvd, r, c, out, plane, steps=3, tag=None):
    """``steps`` allreduces of one named tensor, each of fresh values."""
    for step in range(steps):
        key = "%s.ef.%d" % (tag or c, step)
        _save(out, key, hvd.allreduce(ef_input(step, r), name=c + ".ef",
                                      op=hvd.Average))
        if plane is not None and c == "int8":
            res = [v for k, v in plane.residuals.items()
                   if k.endswith(c + ".ef")]
            assert len(res) == 1, sorted(plane.residuals)
            _save(out, "res." + key, res[0])


def wire_codec_records(session):
    """The core's WIRE_CODEC flight records so far, in order, as rows of
    (codec, raw bytes, wire bytes): one per compressed ring, from the TCP
    ring or the device plane alike (HVD_FLIGHTREC_EVENTS keeps them
    all)."""
    import ctypes
    import json

    dump = sys.argv[2] + ".flightrec.jsonl"
    lib = session._lib
    lib.hvd_core_flightrec_dump.argtypes = [ctypes.c_char_p]
    lib.hvd_core_flightrec_dump.restype = ctypes.c_int
    assert lib.hvd_core_flightrec_dump(dump.encode()) > 0
    with open(dump) as f:
        events = [json.loads(line) for line in f]  # a header, then events
    return np.array([[e["a"], e["b"], e["c"]] for e in events
                     if e.get("kind") == "WIRE_CODEC"],
                    dtype=np.int64).reshape(-1, 3)


def main():
    mode, path = sys.argv[1], sys.argv[2]
    hvd = _import(mode)
    if mode == "jax":
        from horovod_tpu.common.basics import core_session
        from horovod_tpu.common.compression import CODEC_IDS
    else:
        from horovod_tpu_torch.common.basics import core_session
        from horovod_tpu_torch.compression import CODEC_IDS
    session = core_session()
    plane = session.plane if mode == "plane" else None
    r, n = hvd.rank(), hvd.size()
    out = {}
    wasted = {"counters": np.zeros(len(COUNTER_KEYS), dtype=np.int64),
              "records": []}
    for c in CODECS:
        if c == "bf16":
            # HVD_WIRE_CODEC: adopted at the first negotiation round.
            hvd.allreduce(torch.zeros(1, dtype=torch.int32), name="knob",
                          op=hvd.Sum)
            assert adopted(hvd, session, c, CODEC_IDS, "knob")
        else:
            stage(hvd, session, c, CODEC_IDS, c)
        matrix(hvd, session, r, n, c, out, wasted)
        feedback_steps(hvd, r, c, out, plane)
    # A flip drops the residuals: the first int8 step again, as it was.
    stage(hvd, session, "bf16", CODEC_IDS, "flip.bf16")
    stage(hvd, session, "int8", CODEC_IDS, "flip.int8")
    feedback_steps(hvd, r, "int8", out, plane, steps=1, tag="flip")
    # The last rank joins at once: its part of the ring is zeros.
    if r < n - 1:
        _save(out, "int8.join", hvd.allreduce(
            values(9000 + r, 1001, "sum"), name="int8.join", op=hvd.Sum))
    out["int8.join.last"] = np.array(hvd.join())
    stage(hvd, session, "none", CODEC_IDS, "none")
    raw(hvd, r, "none", out)
    counters = session.counters()
    out["counters"] = np.array([counters[k] for k in COUNTER_KEYS],
                               dtype=np.int64) - wasted["counters"]
    out["wire_codec_records"] = np.delete(wire_codec_records(session),
                                          wasted["records"], axis=0)
    hvd.shutdown()
    np.savez(path, **out)
    print("CODEC_WORKER_OK mode=%s rank=%d" % (mode, r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
