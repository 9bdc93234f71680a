"""GEMM kernel milliseconds a step, by kernel-name family (models layer;
moves tokens_per_s)."""

from portbench import readers


def read(run):
    return readers.family_ms(run, ["matmul"])
