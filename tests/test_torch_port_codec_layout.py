"""What the codec kernels' design rests on, checked on the CPU
(``horovod_tpu_torch/csrc/codec.cu``, ``horovod_tpu_torch/ops/codec.py``).

* fp16 by the card's conversions: the core's float-to-half
  (``core/src/codec.h`` FloatToHalf, which the plain
  ``fusion._float_to_half`` repeats) is round-toward-zero with two
  fix-ups, an infinity for |x| >= 65536 and for a NaN; round-toward-zero is
  emulated here with numpy (round to nearest, then one step toward zero
  where that rounded away). Its half-to-float is torch's conversion on every
  half but a NaN, and no encode gives a NaN half.
* The ring's phase-matched layout (``RingMember``, ``wire_pad``): each
  chunk's wire bytes start at the chunk's phase in a 16-byte word, inside
  their own slot, and ``ring_wire_bytes`` covers every slot. The plain ring
  at counts whose chunks start at every phase is the core's TCP ring bit for
  bit in tests/test_torch_port_codec.py (``test_simulated_ring_is_the_tcp_ring``).
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import codec, fusion

SIGNS = (0, 1)


def _f32(bits):
    return np.asarray(bits, dtype=np.uint32).view(np.float32)


def _rz_with_fixups(x):
    """fp32 ``x`` to fp16 bits: round toward zero, then the core's
    infinities for |x| >= 65536 and for a NaN."""
    with np.errstate(over="ignore", invalid="ignore"):
        h = x.astype(np.float16)
        away = np.abs(h.astype(np.float64)) > np.abs(x.astype(np.float64))
    bits = h.view(np.uint16).astype(np.int64)
    bits = np.where(away, bits - 1, bits)  # sign and magnitude: one less
    f = x.view(np.uint32).astype(np.int64)
    sign = (f >> 16) & 0x8000
    big = ((f >> 23) & 0xFF) >= 143  # |x| >= 65536, infinities and NaNs
    return np.where(big, sign | 0x7C00, bits).astype(np.uint16)


def _samples(sign):
    """fp32 bit patterns of one sign: every exponent field with a seeded
    sample of mantissas and the mantissas at the fp16 rounding edges."""
    rng = np.random.RandomState(7 + sign)
    edges = np.array([0, 1, 0x1FFF, 0x2000, 0x2001, 0x3FFF, 0x400000,
                      0x7FDFFF, 0x7FE000, 0x7FFFFF], dtype=np.int64)
    mants = np.concatenate([edges, rng.randint(0, 1 << 23, 246)])
    exps = np.arange(256, dtype=np.int64)
    bits = (sign << 31) | (exps[:, None] << 23) | mants[None, :]
    return _f32(bits.reshape(-1))


def _boundaries():
    """65504, 65520 and 65536 and the floats beside them, fp16's smallest
    subnormal and normal and the floats beside them, fp32 subnormals and
    zeros, both signs."""
    values = np.array([65504, 65520, 65536, 2.0 ** -24, 2.0 ** -25,
                       2.0 ** -14, 2.0 ** -15, 1e-40, 1e-45, 0.0],
                      dtype=np.float32)
    near = np.concatenate([np.nextafter(values, np.float32(np.inf)),
                           np.nextafter(values, np.float32(0)), values])
    return np.concatenate([near, -near]).astype(np.float32)


@pytest.mark.parametrize("sign", SIGNS)
def test_float_to_half_is_round_toward_zero_with_two_fixups(sign):
    x = _samples(sign)
    got = fusion._float_to_half(torch.from_numpy(x)).view(
        torch.int16).numpy().view(np.uint16)
    want = _rz_with_fixups(x)
    bad = np.flatnonzero(got != want)
    assert bad.size == 0, [(hex(x.view(np.uint32)[i]), hex(got[i]),
                            hex(want[i])) for i in bad[:8]]


def test_float_to_half_at_its_boundaries():
    x = _boundaries()
    got = fusion._float_to_half(torch.from_numpy(x)).view(
        torch.int16).numpy().view(np.uint16)
    assert np.array_equal(got, _rz_with_fixups(x))
    # Spelled out: truncation below 65536, an infinity from there on.
    spelled = {65504.0: 0x7BFF, 65520.0: 0x7BFF, 65536.0: 0x7C00,
               -65536.0: 0xFC00, float(np.nextafter(np.float32(65536),
                                                    np.float32(0))): 0x7BFF}
    for v, bits in spelled.items():
        h = fusion._float_to_half(torch.tensor([v], dtype=torch.float32))
        assert int(h.view(torch.int16)[0]) & 0xFFFF == bits, v


def _core_half_to_float(h):
    """core/src/codec.h HalfToFloat on uint16 bits, as uint32 bits."""
    h = h.astype(np.int64)
    sign = (h & 0x8000) << 16
    exp = (h >> 10) & 0x1F
    mant = h & 0x3FF
    # A subnormal half: normalise the mantissa, as the core's loop does.
    shift = np.zeros_like(mant)
    m = mant.copy()
    for _ in range(10):
        grow = (exp == 0) & (m != 0) & ((m & 0x400) == 0)
        m = np.where(grow, m << 1, m)
        shift += grow
    sub = sign | ((127 - 15 + 1 - shift) << 23) | ((m & 0x3FF) << 13)
    out = np.where(exp == 0, np.where(mant == 0, sign, sub),
                   np.where(exp == 0x1F, sign | 0x7F800000 | (mant << 13),
                            sign | ((exp - 15 + 127) << 23) | (mant << 13)))
    return out.astype(np.uint32)


def test_half_to_float_is_torchs_on_every_half_but_a_nan():
    """All 65,536 halves: torch's float16 -> float32 gives the core's bits
    on each of the 63,490 that are not NaN (zeros, subnormals, normals,
    infinities). A NaN half keeps its payload in the core; torch's
    conversion gives a NaN, with a payload of its own."""
    h = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    want = _core_half_to_float(h)
    got = torch.from_numpy(h.view(np.int16).copy()).view(
        torch.float16).float().numpy().view(np.uint32)
    nan = ((h & 0x7C00) == 0x7C00) & ((h & 0x3FF) != 0)
    assert int((~nan).sum()) == 63490
    assert np.array_equal(got[~nan], want[~nan])
    assert np.isnan(got[nan].view(np.float32)).all()
    assert np.isnan(want[nan].view(np.float32)).all()


def test_plain_decode_is_the_cores_half_to_float_on_every_half():
    """All 65,536 halves through the plain fp16 decode: the core's
    HalfToFloat bits (``_core_half_to_float``, a transcription of
    core/src/codec.h:57), the 2,046 NaN halves with their payloads
    included (ROADMAP C6), and so the plain decode-reduce too."""
    h = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    want = _core_half_to_float(h)
    wire = torch.from_numpy(h.view(np.uint8).copy())
    got = codec.plain_decode(codec.FP16, wire, 1 << 16)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    dst = torch.zeros(1 << 16)
    codec.plain_decode_reduce(codec.FP16, wire, dst, codec.COPY)
    assert np.array_equal(dst.numpy().view(np.uint32), want)


@pytest.mark.parametrize("sign", SIGNS)
def test_no_encode_gives_a_nan_half(sign):
    """The core's float-to-half makes an infinity of a NaN, so the fp16
    wire never carries a NaN half: the decode's NaN rule is never reached
    on the ring."""
    x = np.concatenate([_samples(sign), _f32([0x7FC00000 | sign << 31,
                                              0x7F800001 | sign << 31])])
    h = fusion._float_to_half(torch.from_numpy(x)).view(torch.int16)
    bits = h.numpy().view(np.uint16)
    assert not (((bits & 0x7C00) == 0x7C00) & ((bits & 0x3FF) != 0)).any()


# ------------------------------------------------------------- layout ---

CODECS = {"bf16": codec.BF16, "fp16": codec.FP16, "int8": codec.INT8}
# Over n members, counts of 4nq + r for r = 0-3: the chunks' offsets take
# every phase.
LAYOUTS = [(name, n, 4 * n * 250 + r) for name in CODECS
           for n in (2, 3, 4) for r in range(4)]


def _members(cid, n, count, buf_shift, wire_shift):
    """The ``n`` members of a ring over ``count`` values, each buffer a
    view ``buf_shift`` values into its storage, each wire scratch a view
    ``wire_shift`` bytes into its own."""
    size = codec.ring_wire_bytes(cid, count, n)
    members = []
    for k in range(n):
        buf = torch.zeros(count + 4)[buf_shift:buf_shift + count]
        wire = torch.zeros(size + 16, dtype=torch.uint8)[
            wire_shift:wire_shift + size]
        members.append(codec.RingMember(buf, 1, cid, k, n, wire,
                                        plain=True))
    return members, size


def _slots(member):
    """(slot k, chunk c, wire bytes) of every slot the member uses."""
    n = member.n
    return [(k, c, member._bytes(k, c)) for k in range(n + 2)
            for c in range(n) if k < 2 or k == 2 + c]


@pytest.mark.parametrize("name,n,count", LAYOUTS)
def test_each_chunks_wire_starts_at_its_chunks_phase(name, n, count):
    cid = CODECS[name]
    for buf_shift in range(4):
        for wire_shift in range(8):
            members, _ = _members(cid, n, count, buf_shift, wire_shift)
            for m in members:
                for k, c, wire in _slots(m):
                    phase = (m._chunk(c).data_ptr() // 4) % 4
                    start = wire.data_ptr()
                    if cid == codec.INT8:
                        assert (start + 4) % 4 == phase, (k, c)
                    else:
                        assert start % 2 == 0 and (start // 2) % 4 == phase
                    assert wire.numel() == codec.wire_bytes(cid,
                                                            m.counts[c])


@pytest.mark.parametrize("name,n,count", LAYOUTS)
def test_slots_do_not_overlap_and_the_scratch_covers_them(name, n, count):
    cid = CODECS[name]
    for wire_shift in range(8):
        members, size = _members(cid, n, count, 1, wire_shift)
        for m in members:
            base = m.wire.data_ptr()
            for k, c, wire in _slots(m):
                lo = wire.data_ptr() - base
                hi = lo + wire.numel()
                assert k * m.slot <= lo and hi <= (k + 1) * m.slot, (k, c)
                assert hi <= size
                assert lo - k * m.slot < 8


@pytest.mark.parametrize("name", sorted(CODECS))
def test_the_plain_ring_does_not_see_the_layout(name):
    """The pads move no value: the plain ring over buffers and scratch at
    every phase gives the bytes of the ring over aligned ones."""
    cid, n, count = CODECS[name], 3, 4 * 3 * 50 + 3
    rng = np.random.RandomState(3)
    inputs = [torch.from_numpy(rng.randn(count).astype(np.float32))
              for _ in range(n)]
    want = [x.clone() for x in inputs]
    codec.simulated_ring(want, 1, cid, plain=True)
    for shift in range(1, 4):
        bufs = [torch.zeros(count + 4)[shift:shift + count].copy_(x)
                for x in inputs]
        codec.simulated_ring(bufs, 1, cid, plain=True)
        for got, w in zip(bufs, want):
            assert got.numpy().tobytes() == w.numpy().tobytes(), shift
