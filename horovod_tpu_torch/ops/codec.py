"""Wire codecs on the card: the device plane's compressed ring, its kernels
and their plain versions.

Under an adopted wire codec (``HVD_WIRE_CODEC``, ``compression.CODEC_IDS``)
the native core moves the fp32 steps of its TCP ring as bf16, fp16 or int8
bytes (``core/src/codec.cc``, ``collectives.cc:357-491`` RingCompressed),
and under int8 feeds each tensor's quantization error back into its next
submission (``operations.cc:261-292``). Here is the same on the card:

* ``encode``: one block of fp32 values to wire bytes (bf16 rounds to
  nearest even by a bias on the bits, fp16 is the core's truncating
  float-to-half, int8 is a 4-byte fp32 scale maxabs / 127 and one signed
  byte a value; on the card int8 is two launches, a max pass whose last
  block writes the scale, then the quantizer);
* ``decode_reduce``: a block's wire bytes decoded and combined into an fp32
  range with the core's ReduceBuffer op, or copied (``COPY``);
* ``error_feedback``: int8's feedback over a whole response, one scale per
  tensor, on each tensor and its residual in place;
* ``RingMember``: RingCompressed's schedule for one member, over the
  core's ``RingPartition``: each reduce-scatter step encodes the send range
  and decode-reduces the received bytes into the owner's range; in the
  allgather the owner encodes its reduced chunk once and adopts the
  decoded values, and every member forwards received bytes verbatim. The
  fp32 partial sums form in the core's order and every int8 scale sees
  the core's values, so the result is the TCP ring's bit for bit. Each
  chunk's wire bytes start, inside their slot, at the chunk's phase in a
  16-byte word (``wire_pad``): the kernels then move 16 bytes of fp32 per
  access on both sides in every step.

On a card tensor each function launches its hand-written kernel of
``csrc/codec.cu``; on a CPU tensor it runs the plain PyTorch version below,
which repeats the kernels' arithmetic and codec.cc's bit for bit: one IEEE
fp32 operation at a time, never a fused multiply-add; min and max as
std::min/std::max; int8's maxabs with codec.cc's NaN rule (a NaN is
replaced by the next element, so the max is taken after the last NaN) and
its clamp, which turns a NaN into 127.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

from horovod_tpu_torch.compression import CODEC_IDS
from horovod_tpu_torch.ops import fusion

BF16, FP16, INT8 = CODEC_IDS["bf16"], CODEC_IDS["fp16"], CODEC_IDS["int8"]
CODECS = (BF16, FP16, INT8)

# Kernel launches, by kernel, counted where each is launched; and the
# encode and decode-reduce launches by codec.
LAUNCHES = {"codec_encode": 0, "codec_decode_reduce": 0,
            "codec_error_feedback": 0}
LAUNCHES_BY_CODEC = {(kernel, c): 0
                     for kernel in ("codec_encode", "codec_decode_reduce")
                     for c in CODECS}

# Elements per block of the feedback's max pass (codec.cu kChunk) and of
# int8 encode's (kEncodeChunk).
CHUNK = 4096
ENCODE_CHUNK = 16384
# decode_reduce's op that overwrites the range (the allgather); the others
# are ReduceOp values of core/src/common.h.
COPY = -1
_AVERAGE, _SUM, _ADASUM, _MIN, _MAX, _PRODUCT = range(6)
# Wire slots start on this many bytes apart; a chunk's bytes start up to
# _PAD bytes into its slot (``wire_pad``).
_ALIGN = 16
_PAD = 8


def active(codec: int, dtype: torch.dtype) -> bool:
    """Whether ``codec`` compresses ``dtype`` (codec.h CodecActive): fp32
    only; every other dtype moves raw under any codec."""
    return codec in CODECS and dtype == torch.float32


def wire_bytes(codec: int, count: int) -> int:
    """codec.cc CodecWireBytes: the encoded size of a block of ``count``
    fp32 values; an empty block is no bytes, int8's scale included."""
    if codec in (BF16, FP16):
        return 2 * count
    if codec == INT8:
        return 4 + count if count > 0 else 0
    return 4 * count


def partition(count: int, n: int):
    """The core's RingPartition: ``n`` chunks of ``count // n`` elements,
    the first ``count % n`` one longer; their counts and offsets."""
    counts = [count // n + (1 if i < count % n else 0) for i in range(n)]
    return counts, fusion.offsets_of(counts)


# -------------------------------------------------------- plain version ---

_F32 = torch.float32


def plain_maxabs(x: torch.Tensor) -> torch.Tensor:
    """codec.cc's sequential maxabs of ``x`` as an fp32 0-d tensor: the
    largest |x| after the last NaN, NaN if ``x`` ends on one."""
    a = x.abs()
    nan = torch.isnan(a)
    if bool(nan.any()):
        last = int(nan.nonzero()[-1])
        if last == a.numel() - 1:
            return torch.tensor(float("nan"), dtype=_F32, device=x.device)
        a = a[last + 1:]
    if a.numel() == 0:
        return torch.zeros((), dtype=_F32, device=x.device)
    return a.max()


def _int8_scale(maxabs: torch.Tensor) -> torch.Tensor:
    one = torch.ones((), dtype=_F32, device=maxabs.device)
    return torch.where(maxabs > 0, maxabs / torch.tensor(
        127.0, dtype=_F32, device=maxabs.device), one)


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """lrintf(std::max(-127, std::min(127, x * (1 / scale)))) as int8."""
    v = x * (torch.ones((), dtype=_F32, device=x.device) / scale)
    m = torch.where(v < 127.0, v, torch.full_like(v, 127.0))
    c = torch.where(-127.0 < m, m, torch.full_like(m, -127.0))
    return torch.round(c).to(torch.int8)


def plain_encode(codec: int, x: torch.Tensor, wire: torch.Tensor) -> None:
    """``wire[:wire_bytes(codec, n)]`` = the encoding of the fp32 block
    ``x`` (n values)."""
    n = x.numel()
    if n == 0:
        return
    if codec == BF16:
        bits = fusion._float_to_bf16(x)
    elif codec == FP16:
        bits = fusion._float_to_half(x)
    elif codec == INT8:
        scale = _int8_scale(plain_maxabs(x))
        wire[:4] = scale.reshape(1).view(torch.uint8)
        wire[4:4 + n] = _quantize(x, scale).view(torch.uint8)
        return
    else:
        raise ValueError("no wire codec %r" % (codec,))
    wire[:2 * n] = bits.view(torch.uint8)


def _half_to_float(h: torch.Tensor) -> torch.Tensor:
    """The core's HalfToFloat (core/src/codec.h:57) on float16 values:
    torch's conversion, which is exact, except on a half with an all-ones
    exponent, which takes ``sign | 0x7f800000 | mant << 13``, so that a
    NaN keeps its payload (torch's conversion need not, and the CPU's
    quiets a signalling NaN)."""
    bits = h.view(torch.int16).to(torch.int32)
    special = (bits & 0x7C00) == 0x7C00
    core = 0x7F800000 | ((bits & 0x3FF) << 13)
    core = torch.where((bits & 0x8000) != 0, core | -(1 << 31), core)
    return torch.where(special, core.view(_F32), h.float())


def plain_decode(codec: int, wire: torch.Tensor, count: int) -> torch.Tensor:
    """The ``count`` fp32 values of an encoded block."""
    if count == 0:
        return torch.empty(0, dtype=_F32, device=wire.device)
    if codec == BF16:
        return wire[:2 * count].view(torch.bfloat16).float()
    if codec == FP16:
        return _half_to_float(wire[:2 * count].view(torch.float16))
    if codec == INT8:
        scale = wire[:4].clone().view(_F32)
        return wire[4:4 + count].view(torch.int8).float() * scale
    raise ValueError("no wire codec %r" % (codec,))


def plain_decode_reduce(codec: int, wire: torch.Tensor, dst: torch.Tensor,
                        op: int) -> None:
    """``dst = op(dst, decoded)`` as ReduceBuffer computes it for fp32, or
    ``dst = decoded`` for ``COPY``."""
    d = plain_decode(codec, wire, dst.numel())
    if op == COPY:
        dst.copy_(d)
    elif op in (_AVERAGE, _SUM, _ADASUM):
        dst.add_(d)
    elif op == _MIN:    # std::min(dst, d): d only where d < dst
        dst.copy_(torch.where(d < dst, d, dst))
    elif op == _MAX:    # std::max(dst, d): d only where dst < d
        dst.copy_(torch.where(dst < d, d, dst))
    elif op == _PRODUCT:
        dst.mul_(d)
    else:
        raise ValueError("no reduce op %r" % (op,))


def plain_error_feedback(xs: Sequence[torch.Tensor],
                         rs: Sequence[torch.Tensor]) -> None:
    """operations.cc:271-292 for each tensor ``x`` and its residual ``r``
    (flat fp32), in place: x += r; xq = the int8 round trip of x;
    r = x - xq; x = xq."""
    for x, r in zip(xs, rs):
        if x.numel() == 0:
            continue
        x.add_(r)
        wire = torch.empty(wire_bytes(INT8, x.numel()), dtype=torch.uint8,
                           device=x.device)
        plain_encode(INT8, x, wire)
        xq = plain_decode(INT8, wire, x.numel())
        r.copy_(x - xq)
        x.copy_(xq)


# ------------------------------------------------------------- dispatch ---

def _lib():
    from horovod_tpu_torch.ops import _build

    return _build, _build.load("codec")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_block(kernel: str, codec: int, x: torch.Tensor,
                 wire: torch.Tensor, count: int) -> None:
    if codec not in CODECS:
        raise ValueError("%s: no wire codec %r" % (kernel, codec))
    if x.dtype != _F32 or not x.is_contiguous() or x.numel() != count or \
            x.data_ptr() % 4:
        raise ValueError("%s: a contiguous, 4-byte aligned fp32 block of %d "
                         "values" % (kernel, count))
    if wire.dtype != torch.uint8 or not wire.is_contiguous() or \
            wire.numel() < wire_bytes(codec, count) or \
            wire.device != x.device:
        raise ValueError("%s: %d contiguous wire bytes on %s"
                         % (kernel, wire_bytes(codec, count), x.device))
    if codec != INT8 and wire.data_ptr() % 2:
        raise ValueError("%s: 16-bit wire bytes must start on an even "
                         "address" % kernel)


# int8 encode's device counters, one per (device, stream), each zeroed
# where it is made (on its stream) and left at zero by every launch.
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _counter(x: torch.Tensor, stream: int) -> torch.Tensor:
    key = (x.device.index, stream)
    counter = _COUNTERS.get(key)
    if counter is None:
        counter = _COUNTERS[key] = torch.zeros(1, dtype=torch.int32,
                                               device=x.device)
    return counter


def encode(codec: int, x: torch.Tensor, wire: torch.Tensor) -> None:
    """Encode the fp32 block ``x`` into ``wire``: the codec_encode kernel on
    the card (int8: a partial max per chunk, whose last block writes the
    scale into the wire on the card, then the quantizer)."""
    if x.device.type == "cpu":
        plain_encode(codec, x, wire)
        return
    _check_block("codec_encode", codec, x, wire, x.numel())
    if x.numel() == 0:
        return
    stream = _stream(x)
    counter = scratch = None
    if codec == INT8:
        counter = _counter(x, stream)
        scratch = torch.empty(12 * -(-x.numel() // ENCODE_CHUNK),
                              dtype=torch.uint8, device=x.device)
    build, lib = _lib()
    err = lib.hvd_codec_encode(
        codec, x.data_ptr(), x.numel(), wire.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        None if counter is None else counter.data_ptr(), stream)
    if err:
        # A refused launch never ran; a fault is sticky. Either way the
        # next call starts from a fresh zeroed counter.
        _COUNTERS.pop((x.device.index, stream), None)
    build.check(lib, err, "codec_encode")
    LAUNCHES["codec_encode"] += 1
    LAUNCHES_BY_CODEC["codec_encode", codec] += 1


def decode_reduce(codec: int, wire: torch.Tensor, dst: torch.Tensor,
                  op: int) -> None:
    """``dst = op(dst, decode(wire))`` (``COPY``: ``dst = decode(wire)``):
    the codec_decode_reduce kernel on the card. An empty ``dst`` reads no
    byte, not even int8's scale."""
    if dst.device.type == "cpu":
        plain_decode_reduce(codec, wire, dst, op)
        return
    _check_block("codec_decode_reduce", codec, dst, wire, dst.numel())
    if op not in (COPY, _AVERAGE, _SUM, _ADASUM, _MIN, _MAX, _PRODUCT):
        raise ValueError("codec_decode_reduce: no reduce op %r" % (op,))
    if dst.numel() == 0:
        return
    build, lib = _lib()
    err = lib.hvd_codec_decode_reduce(codec, wire.data_ptr(), dst.numel(),
                                      dst.data_ptr(), op, _stream(dst))
    build.check(lib, err, "codec_decode_reduce")
    LAUNCHES["codec_decode_reduce"] += 1
    LAUNCHES_BY_CODEC["codec_decode_reduce", codec] += 1


def error_feedback(xs: Sequence[torch.Tensor],
                   rs: Sequence[torch.Tensor]) -> None:
    """int8's error feedback on each flat fp32 tensor ``x`` and its
    residual ``r`` of the same size, in place: one codec_error_feedback
    call for all of them on the card (a table of rows; each tensor's scale
    from its own maxabs)."""
    pairs = [(x, r) for x, r in zip(xs, rs) if x.numel()]
    if not pairs:
        return
    if pairs[0][0].device.type == "cpu":
        plain_error_feedback([x for x, _ in pairs], [r for _, r in pairs])
        return
    launch_feedback(*feedback_table(pairs))


def feedback_table(pairs):
    """The feedback kernel's table of ``(x, r)`` pairs on their card: int64
    rows of (x pointer, r pointer, count, first chunk), written through
    pinned memory with a copy on the current stream, so the host never
    waits; with the row and chunk counts."""
    device = pairs[0][0].device
    rows, first = [], 0
    for x, r in pairs:
        for t in (x, r):
            if t.dtype != _F32 or not t.is_contiguous() or \
                    t.device != device or t.numel() != x.numel():
                raise ValueError("codec_error_feedback: contiguous fp32 "
                                 "tensors and residuals of their sizes on "
                                 "one device")
        rows += [x.data_ptr(), r.data_ptr(), x.numel(), first]
        first += -(-x.numel() // CHUNK)
    host = torch.tensor(rows, dtype=torch.int64).pin_memory()
    return host.to(device, non_blocking=True), len(pairs), first


def launch_feedback(table: torch.Tensor, n_rows: int, chunks: int) -> None:
    """One codec_error_feedback call over a table built by
    ``feedback_table``, on the current stream."""
    scratch = torch.empty(12 * chunks + 4 * n_rows, dtype=torch.uint8,
                          device=table.device)
    build, lib = _lib()
    err = lib.hvd_codec_error_feedback(table.data_ptr(), n_rows, chunks,
                                       scratch.data_ptr(), _stream(table))
    build.check(lib, err, "codec_error_feedback")
    LAUNCHES["codec_error_feedback"] += 1


# ----------------------------------------------------------------- ring ---

# exchange(send, recv): send the bytes ``send`` to the right neighbour and
# receive the left neighbour's into ``recv`` (either may be empty).
Exchange = Callable[[torch.Tensor, torch.Tensor], None]


def ring_wire_bytes(codec: int, count: int, n: int) -> int:
    """The wire scratch a member of an ``n``-member ring over ``count``
    values needs: a send and a receive slot and the allgather's ``n``
    chunk slots."""
    return (n + 2) * _slot(codec, max(partition(count, n)[0]))


def _slot(codec: int, count: int) -> int:
    return -(-(wire_bytes(codec, count) + _PAD) // _ALIGN) * _ALIGN


def wire_pad(codec: int, f32_addr: int, wire_addr: int) -> int:
    """The bytes (0-7) to skip at ``wire_addr`` so that the encoding of an
    fp32 block at ``f32_addr`` has its wire element 0 at the phase of the
    block's element 0 in a 16-byte word: bf16/fp16 element i then lies in
    the same 8-byte word as fp32 element i in its 16-byte word, int8's
    (after the 4-byte scale) in the same 4-byte word, and the kernels take
    four values per access on both sides."""
    phase = (f32_addr // 4) % 4
    if codec == INT8:
        return (phase - (wire_addr + 4)) % 4
    return (2 * phase - wire_addr) % 8


class RingMember:
    """Member ``idx`` of ``n`` running RingCompressed's schedule on the
    flat fp32 ``buf`` with ``op``, its wire bytes in ``wire``
    (``ring_wire_bytes``). A driver calls, for each step ``s``, the
    ``*_send`` and ``*_recv`` of a phase, moves the send bytes to the right
    neighbour's receive bytes, then ``*_done``."""

    def __init__(self, buf: torch.Tensor, op: int, codec: int, idx: int,
                 n: int, wire: torch.Tensor, plain: bool = False):
        self.buf, self.op, self.codec, self.idx, self.n = \
            buf, op, codec, idx, n
        self.counts, self.offsets = partition(buf.numel(), n)
        self.slot = _slot(codec, max(self.counts))
        self.wire = wire
        self.filled = [False] * n
        self._encode = plain_encode if plain else encode
        self._decode_reduce = plain_decode_reduce if plain \
            else decode_reduce

    def _chunk(self, c: int) -> torch.Tensor:
        return self.buf[self.offsets[c]:self.offsets[c] + self.counts[c]]

    def _bytes(self, k: int, c: int) -> torch.Tensor:
        """Wire slot ``k`` (0 send, 1 receive, 2 + c chunk c) cut to chunk
        ``c``'s encoded size, from the pad that gives it the chunk's phase.
        Each member places its own bytes: the bytes sent and received are
        the same, wherever either side keeps them."""
        start = k * self.slot
        start += wire_pad(self.codec, self._chunk(c).data_ptr(),
                          self.wire.data_ptr() + start)
        return self.wire[start:start + wire_bytes(self.codec,
                                                  self.counts[c])]

    def sends(self) -> List[int]:
        """This member's sends in order, as raw fp32 bytes each: the
        core's CountCodecSend arguments."""
        n, i = self.n, self.idx
        return ([4 * self.counts[(i - s) % n] for s in range(n - 1)]
                + [4 * self.counts[(i + 1 - s) % n] for s in range(n - 1)])

    # Reduce-scatter step s: send chunk idx - s, receive idx - s - 1.
    def rs_send(self, s: int) -> torch.Tensor:
        c = (self.idx - s) % self.n
        wire = self._bytes(0, c)
        self._encode(self.codec, self._chunk(c), wire)
        return wire

    def rs_recv(self, s: int) -> torch.Tensor:
        return self._bytes(1, (self.idx - s - 1) % self.n)

    def rs_done(self, s: int) -> None:
        c = (self.idx - s - 1) % self.n
        self._decode_reduce(self.codec, self._bytes(1, c), self._chunk(c),
                            self.op)

    # Allgather step s: send chunk idx + 1 - s, receive idx - s.
    def ag_send(self, s: int) -> torch.Tensor:
        c = (self.idx + 1 - s) % self.n
        wire = self._bytes(2 + c, c)
        if not self.filled[c] and wire.numel():
            # This member owns chunk c, reduced: encoded once, and the
            # codec-rounded values adopted here too.
            self._encode(self.codec, self._chunk(c), wire)
            self.filled[c] = True
            self._decode_reduce(self.codec, wire, self._chunk(c), COPY)
        return wire

    def ag_recv(self, s: int) -> torch.Tensor:
        c = (self.idx - s) % self.n
        return self._bytes(2 + c, c)

    def ag_done(self, s: int) -> None:
        c = (self.idx - s) % self.n
        self.filled[c] = True
        self._decode_reduce(self.codec, self._bytes(2 + c, c),
                            self._chunk(c), COPY)


def ring_allreduce(member: RingMember, exchange: Exchange) -> None:
    """Run ``member``'s ring with ``exchange`` moving each step's bytes."""
    for s in range(member.n - 1):
        exchange(member.rs_send(s), member.rs_recv(s))
        member.rs_done(s)
    for s in range(member.n - 1):
        exchange(member.ag_send(s), member.ag_recv(s))
        member.ag_done(s)


def simulated_ring(bufs: List[torch.Tensor], op: int, codec: int,
                   plain: bool = False) -> None:
    """The ring of ``len(bufs)`` members in one process, in place: member
    k's flat fp32 buffer is ``bufs[k]``, and an exchange is a copy from
    each member's send bytes to its right neighbour's receive bytes.
    ``plain`` runs the plain versions whatever the device."""
    n = len(bufs)
    size = ring_wire_bytes(codec, bufs[0].numel(), n)
    members = [RingMember(b, op, codec, k, n,
                          torch.empty(size, dtype=torch.uint8,
                                      device=b.device), plain)
               for k, b in enumerate(bufs)]
    for send, recv, done in (("rs_send", "rs_recv", "rs_done"),
                             ("ag_send", "ag_recv", "ag_done")):
        for s in range(n - 1):
            sent = [getattr(m, send)(s) for m in members]
            for k, m in enumerate(members):
                getattr(m, recv)(s).copy_(sent[(k - 1) % n])
                getattr(m, done)(s)
