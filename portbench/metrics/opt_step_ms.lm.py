"""CUDA-event milliseconds of DistributedOptimizer.step() a step, LM cell
(moves tokens_per_s)."""

from portbench import readers


def read(run):
    return readers.opt_step_ms(run)
