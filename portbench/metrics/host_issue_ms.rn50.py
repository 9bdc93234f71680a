"""Host milliseconds to issue one step of the ResNet cell (training
script layer; moves images_per_s)."""

from portbench import readers


def read(run):
    return readers.host_issue_ms(run)
