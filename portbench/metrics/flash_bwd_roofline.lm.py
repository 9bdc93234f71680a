"""Percent of its roofline that the flash backward pair (dK/dV and dQ)
reaches over the traced launches (flash kernels layer; moves
tokens_per_s)."""

from portbench import readers


def read(run):
    b = readers.flash_bounds(run)
    return readers.roofline(run, ["flash_bwd_dkv", "flash_bwd_dq"],
                            b["flash_bwd_dkv"] + b["flash_bwd_dq"])
