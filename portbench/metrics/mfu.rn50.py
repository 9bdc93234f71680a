"""Percent of the card's bf16 peak that the model FLOPs of the ResNet
cell's images reach: 3 x the forward counted on the layer shapes (whole
step; moves images_per_s)."""

from portbench import readers, yardstick


def read(run):
    cell = run.cell
    return readers.mfu(run, "images_per_s", 3 * yardstick.resnet_fwd_flops(
        cell.config, cell.traffic["px"]))
