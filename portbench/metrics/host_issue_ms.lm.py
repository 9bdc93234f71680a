"""Host milliseconds to issue one step of the LM cell (training script
layer; moves tokens_per_s)."""

from portbench import readers


def read(run):
    return readers.host_issue_ms(run)
