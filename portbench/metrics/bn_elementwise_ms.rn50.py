"""Batch-norm and elementwise kernel milliseconds a step, by kernel-name
family (models layer; moves images_per_s)."""

from portbench import readers


def read(run):
    return readers.family_ms(run, ["batch_norm", "elementwise"])
