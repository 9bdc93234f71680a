"""Percent of its roofline that the flash forward kernel reaches over
the traced launches, the remat recompute's included (flash kernels
layer; moves tokens_per_s)."""

from portbench import readers


def read(run):
    bound = readers.flash_bounds(run)["flash_fwd"]
    return readers.roofline(run, ["flash_fwd"], bound)
