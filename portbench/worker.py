"""One rank of a cell: set-up, the measured window, the traced steps, then
the plain reference over the checked steps, once the program is freed.

``run.py`` calls ``run_rank`` in its own process on one chip; on more,
it starts this file through the port's launcher (``python -m
horovod_tpu_torch.runner -np N``), one process a card, and each rank
writes its record to ``--out``."""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

FORBIDDEN = ("jax", "jaxlib", "flax", "horovod_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def run_rank(cell, seed: int, seconds: float, traced: bool, t0: float,
             device=None, hooks=None) -> dict:
    """The rank's record. ``device`` None is the launcher's platform (the
    card unless ``--platform cpu``); ``hooks`` (tests only) is called with
    the job after it is built, to break the timed path underneath."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import models
    from horovod_tpu_torch.common.basics import init_device
    from portbench import judge, script
    from portbench.reference.train import follow

    phases = [("imports", time.time() - t0)]
    hvd.init(device=device)
    dev = torch.device(init_device())
    phases.append(("init", time.time() - t0))
    if dev.type == "cuda":
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize(dev)
        phases.append(("CUDA context", time.time() - t0))
    traffic = cell.traffic
    torch.backends.cudnn.benchmark = bool(traffic.get("cudnn_benchmark"))
    job = script.Job(cell, seed, hvd, models, dev)
    phases += [(what, t - t0) for what, t in job.marks]
    if hooks is not None:
        hooks(job)
    program = job.setup_steps(traffic["check_steps"])
    setup_s = time.time() - t0
    phases.append(("checked steps", setup_s))
    window = job.window(seconds)
    summary = job.traced(traffic["trace_steps"]) if traced else None
    record = {
        "rank": job.rank, "size": job.size, "setup_s": setup_s,
        "setup_phases": phases,
        "window": window, "trace": summary, "program": program,
        "buckets": job.buckets(),
        "forbidden": forbidden_modules(),
        "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else 0),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    job_rank = job.rank
    job.free()
    del job
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.time()
    record["reference"] = follow(cell.config, traffic, seed, hvd.rank(),
                                 traffic["check_steps"], dev)
    record["reference_s"] = time.time() - t
    if job_rank == 0:
        judge.settle_samples(record["program"], record["reference"])
    else:
        for what in judge.DIRECTIONS:
            record["reference"].pop(what + "_sample")
    hvd.shutdown()
    return record


def main(argv=None, hooks=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", required=True)
    p.add_argument("--root", default=None,
                   help="the checkout that holds BENCHMARK.json")
    args = p.parse_args(argv)
    from portbench import spec

    rank = int(os.environ.get("HOROVOD_RANK", "0"))
    with open(os.path.join(args.out, "pid%d" % rank), "w") as f:
        f.write(str(os.getpid()))
    cell = spec.load_cell(args.workload, args.root or spec.ROOT)
    record = run_rank(cell, args.seed, args.seconds, bool(args.trace),
                      float(os.environ["PORTBENCH_T0"]), hooks=hooks)
    path = os.path.join(args.out, "rank%d.json" % rank)
    with open(path + ".part", "w") as f:
        json.dump(record, f)
    os.replace(path + ".part", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
