"""Wall time of the device plane's compressed ring across cards.

Starts ``--np`` ranks of itself on one host (the launcher's environment:
HOROVOD_RANK, SIZE, LOCAL_RANK, LOCAL_SIZE, CONTROLLER_ADDR, CONTROLLER_PORT),
each on the card of its rank. Each rank allreduces one fp32 tensor of the
161 ResNet-50 gradients' size (25,557,032 values) through
``horovod_tpu_torch.torch.allreduce`` with no codec, then under bf16, fp16
and int8 (staged with ``stage_wire_codec``; int8 runs its error feedback
too): two warm-up calls, then ``--reps`` calls, each between two
``torch.cuda.synchronize``. Rank 0 prints one JSON line: the card (name and
power limit), the root, and the median and spread of each codec's ms.

Run from the repo root on a machine with four cards::

    python3 tools/codec_ring_times.py --np 4               # this port
    python3 tools/codec_ring_times.py --np 4 --root DIR    # the port under DIR

``cpu`` in place of the cards (``--device cpu``) rehearses the flow on gloo
with a smaller tensor; its times are the CPU's.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
VALUES = 25557032
CODECS = ("none", "bf16", "fp16", "int8")


def _rank_main(args) -> int:
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.compression import CODEC_IDS

    rank = int(os.environ["HOROVOD_RANK"])
    cuda = args.device == "cuda"
    card = torch.device("cuda", rank) if cuda else torch.device("cpu")
    hvd.init(device=str(card))
    session = hvd.core_session()

    def sync():
        if cuda:
            torch.cuda.synchronize(card)

    gen = torch.Generator(device=card).manual_seed(100 + rank)
    x = torch.randn(args.values, generator=gen, device=card)
    ids = dict(CODEC_IDS, none=0)
    out = {}
    for name in CODECS:
        assert session.stage_wire_codec(name)
        hvd.allreduce(torch.zeros(1, dtype=torch.int32),
                      name="stage." + name)
        seen = torch.tensor([session.wire_codec()], dtype=torch.int32)
        low = hvd.allreduce(seen, name="seen.min." + name, op=hvd.Min)
        high = hvd.allreduce(seen, name="seen.max." + name, op=hvd.Max)
        assert int(low) == int(high) == ids[name], (name, low, high)
        times = []
        for i in range(2 + args.reps):
            sync()
            t0 = time.perf_counter()
            hvd.allreduce(x, name="ring." + name, op=hvd.Sum)
            sync()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        out[name] = dict(median_ms=statistics.median(times),
                         min_ms=min(times), max_ms=max(times))
    hvd.shutdown()
    if rank == 0:
        line = ""
        if cuda:
            line = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip().splitlines()[0]
        print(json.dumps({"card": line, "root": str(Path(args.root)
                                                      .resolve()),
                          "ranks": int(os.environ["HOROVOD_SIZE"]),
                          "values": args.values, "reps": args.reps,
                          "times": out}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--np", type=int, default=4)
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--values", type=int, default=VALUES)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if "HOROVOD_RANK" in os.environ:
        return _rank_main(args)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    procs = []
    for rank in range(args.np):
        env = dict(os.environ, HOROVOD_RANK=str(rank),
                   HOROVOD_SIZE=str(args.np), HOROVOD_LOCAL_RANK=str(rank),
                   HOROVOD_LOCAL_SIZE=str(args.np),
                   HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                   HOROVOD_CONTROLLER_PORT=port)
        procs.append(subprocess.Popen([sys.executable, __file__] + (
            argv if argv is not None else sys.argv[1:]), env=env))
    rcs = []
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return max(rcs) if len(rcs) == len(procs) else 1


if __name__ == "__main__":
    sys.exit(main())
