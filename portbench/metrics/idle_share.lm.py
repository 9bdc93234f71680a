"""Percent of the traced window in which no operation runs on the card,
LM cell (device layer; moves tokens_per_s)."""

from portbench import readers


def read(run):
    return readers.idle_share(run)
