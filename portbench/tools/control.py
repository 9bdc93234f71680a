"""Readings of a cell's control and faults, at the cell's own size.

    python3 portbench/tools/control.py --workload NAME --seeds 1 2 3
    python3 -m horovod_tpu_torch.runner -np 4 python3 \\
        portbench/tools/control.py --workload NAME --seeds 1 2 3

For each seed the float32 reference follows the checked steps; then, each
in the program's place and compared with it by the cell's own numbers:

- ``fp8``: the control, the reference with every matmul and convolution
  on float8 e4m3 operands (the step below the cells' bf16);
- ``half_batch``: the second half of each rank's batch left out, the mean
  taken over the rest;
- ``no_exchange`` (more than one rank): each rank steps on its own
  gradient;
- ``inner_wgrad`` (ResNet): each block's 3x3 weight gradient doubled;
  ``inner_flip``: turned end for end instead, wrong and of the same norm;
- ``bf16``: a witness, not a fault: the reference on bf16-rounded
  operands, the cells' own precision, to show how far bf16 rounding alone
  moves each number.

A step that returns its state unchanged reads 1 by the change's measure
and needs no run. One JSON line a reading on standard output (rank 0)."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from portbench import judge, spec  # noqa: E402
from portbench.reference.train import follow  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variants", nargs="+",
                   default=["fp8", "half_batch", "no_exchange",
                            "inner_wgrad", "inner_flip", "bf16"])
    args = p.parse_args(argv)
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.basics import init_device

    hvd.init()
    dev = torch.device(init_device())
    cell = spec.load_cell(args.workload)
    steps = cell.traffic["check_steps"]
    for seed in args.seeds:
        t = time.time()
        base = follow(cell.config, cell.traffic, seed, hvd.rank(), steps,
                      dev)
        base_s = time.time() - t
        for variant in args.variants:
            if variant == "no_exchange" and hvd.size() == 1 or \
                    variant.startswith("inner_") \
                    and cell.config["family"] != "resnet":
                continue
            t = time.time()
            if variant in ("fp8", "bf16"):
                got = follow(cell.config, cell.traffic, seed, hvd.rank(),
                             steps, dev, precision=variant)
            else:
                got = follow(cell.config, cell.traffic, seed, hvd.rank(),
                             steps, dev, fault=variant)
            ref = dict(base)
            judge.settle_samples(got, ref)
            if hvd.rank() == 0:
                print(json.dumps({
                    "workload": cell.name, "seed": seed, "variant": variant,
                    "numbers": judge.numbers(got, ref),
                    "directions": {
                        what: sorted(judge.leaf_diffs(got, ref, what).items(),
                                     key=lambda kv: -kv[1][0])[:8]
                        for what in judge.DIRECTIONS},

                    "losses": got["losses"], "reference": base["losses"],
                    "reference_s": base_s, "variant_s": time.time() - t}),
                    flush=True)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
