"""CUDA-event milliseconds of DistributedOptimizer.step() a step, ResNet
cell (moves images_per_s)."""

from portbench import readers


def read(run):
    return readers.opt_step_ms(run)
