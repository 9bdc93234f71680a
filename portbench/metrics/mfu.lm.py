"""Percent of the cards' bf16 peak that the model FLOPs of the LM
cell's tokens reach (whole step; moves tokens_per_s). The remat
recompute is no model FLOP."""

from portbench import readers, yardstick


def read(run):
    cell = run.cell
    return readers.mfu(run, "tokens_per_s", yardstick.lm_flops_per_token(
        cell.config, cell.traffic["seq_len"]))
