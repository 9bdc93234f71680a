"""Percent of the traced window in which no operation runs on the card,
ResNet cell (device layer; moves images_per_s)."""

from portbench import readers


def read(run):
    return readers.idle_share(run)
