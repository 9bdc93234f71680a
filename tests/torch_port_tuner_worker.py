"""One rank of the online tuner's np=2 runs on the port's core.

Run as ``python torch_port_tuner_worker.py OUT`` by the ranks of one job
(tests/torch_port_runs.py ``start_runs``), host tensors on the CPU:

1. ``ring_chunk_bytes`` through the tuner's own ``KnobBinding`` (the
   native apply path, ``CoreSession.set_wire_params``) at 0, 1 MiB and
   64 KiB, one 4 MiB allreduce after each: the change of
   ``hvd_ring_subchunk_steps_total`` (the registry's family) and of the
   core's own counter under each value, and whether the sums are exact;
2. the device plane attached on the CPU (gloo), as a card tensor's path
   runs it: the bytes the plane adds to ``hvd_comm_tx_bytes_total`` and
   ``_rx_`` for one allreduce of 4 MiB, one fused allreduce, an allgather,
   a broadcast and an alltoall, apart from the TCP ring's own (the core's
   counters, as the bridge published them).

Results go to OUT (an .npz).
"""

import sys

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.knobs import TUNABLE
from horovod_tpu_torch.utils import metrics
from horovod_tpu_torch.utils import online_tuner as ot

CHUNKS = (0, 1 << 20, 64 << 10)
COUNT = 1 << 20  # fp32 values: 4 MiB


def plane_bytes(core, fn):
    """The wire bytes ``fn`` made the plane add: the registry's change
    less the TCP ring's change as the bridge published it."""
    def read():
        metrics.value("hvd_comm_tx_bytes_total")  # publishes the bridge
        # Under the bridge's lock, the families and what the bridge has
        # published of the core's counters agree, whatever other thread
        # (the health reporter) runs the collector.
        with core._metrics_lock:
            vals = [metrics.REGISTRY.get("hvd_comm_%s_bytes_total" % k)
                    ._children[()].get() for k in ("tx", "rx")]
            return vals + [core._metrics_last.get(k + "_bytes", 0)
                           for k in ("tx", "rx")]

    before = read()
    fn()
    after = read()
    return [(after[i] - before[i]) - (after[i + 2] - before[i + 2])
            for i in range(2)]


def main(out_path):
    hvd.init(device="cpu")
    core = basics.core_session()
    rank, size = hvd.rank(), hvd.size()
    out = {}
    binding = ot.KnobBinding(TUNABLE["ring_chunk_bytes"])
    x = torch.arange(COUNT, dtype=torch.float32) + rank
    want = sum(torch.arange(COUNT, dtype=torch.float32) + r
               for r in range(size))
    steps, native, exact = [], [], []
    for chunk in CHUNKS:
        binding.apply(float(chunk))
        family0 = metrics.value("hvd_ring_subchunk_steps_total") or 0.0
        native0 = core.counters()["ring_subchunk_steps"]
        got = hvd.allreduce(x, name="tune.ring.%d" % chunk, op=hvd.Sum)
        steps.append((metrics.value("hvd_ring_subchunk_steps_total") or 0.0)
                     - family0)
        native.append(core.counters()["ring_subchunk_steps"] - native0)
        exact.append(bool(torch.equal(got, want)))
    out.update(chunks=np.array(CHUNKS), steps=np.array(steps),
               native_steps=np.array(native), exact=np.array(exact))

    from horovod_tpu_torch.core import device_plane

    device_plane.attach(core, torch.device("cpu"), size)
    y = torch.ones(COUNT, dtype=torch.float32)
    one = plane_bytes(core, lambda: hvd.allreduce(y, name="tune.plane",
                                                  op=hvd.Sum))
    parts = [torch.ones(n, dtype=torch.float32) for n in (1000, 3000, 5)]
    fused = plane_bytes(core, lambda: hvd.grouped_allreduce(
        parts, name="tune.fused", op=hvd.Sum))
    # The other ops: an allgather of G gathered bytes moves (n-1)/n G each
    # way, a broadcast its B bytes, an alltoall what goes to and comes
    # from the other members.
    rows = torch.ones(4, 256, dtype=torch.float32)
    gathered = plane_bytes(core, lambda: hvd.allgather(rows, name="tune.ag"))
    cast = plane_bytes(core, lambda: hvd.broadcast(y, 0, name="tune.bc"))
    swapped = plane_bytes(core, lambda: hvd.alltoall(
        torch.ones(2 * size, 256), name="tune.a2a"))
    out.update(one=np.array(one), one_bytes=np.array(y.numel() * 4),
               fused=np.array(fused),
               fused_bytes=np.array(sum(p.numel() for p in parts) * 4),
               gathered=np.array(gathered),
               gathered_bytes=np.array(rows.numel() * 4 * size),
               cast=np.array(cast), swapped=np.array(swapped),
               swapped_bytes=np.array(2 * size * 256 * 4),
               plane_responses=np.array(core.plane.responses))
    hvd.shutdown()
    np.savez(out_path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
