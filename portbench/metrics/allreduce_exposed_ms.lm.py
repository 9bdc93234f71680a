"""Milliseconds a step in which NCCL kernels run on the card and no
other kernel does (DistributedOptimizer layer; moves tokens_per_s)."""

from portbench import readers


def read(run):
    return readers.exposed_ms(run, "nccl")
