"""The comparison that decides ``correct`` catches what it must, at toy
sizes on the CPU: a sound run passes; a run with the timed path broken
underneath (a step that leaves the state unchanged, half of the batch
left out, the exchange between ranks left out) and the control (the
float32 reference's products on fp8 operands, in the program's place)
come out not correct under each cell's own limits."""

import argparse

import pytest

import portbench_tiny as tiny
from portbench import judge
from portbench import run as prun
from portbench.reference.train import follow

CELLS = [tiny.LM, tiny.RN]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tmp_path, workload):
    cell = tiny.tiny_cell(str(tmp_path), workload)
    record = tiny.run_tiny(cell)
    result, correct, nums = prun.compose(cell, [record], False)
    assert correct, nums
    assert result["correct"] is True


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(tmp_path, workload, fault):
    cell = tiny.tiny_cell(str(tmp_path), workload)
    record = tiny.run_tiny(cell, hooks=tiny.FAULTS[fault])
    _, correct, nums = prun.compose(cell, [record], False)
    assert not correct, nums


def test_wrong_inner_conv_wgrad_is_not_correct(tmp_path):
    """A ResNet block's inner convolutions get a gradient only from the
    second step (their block's last batch norm starts at 0): a wrong
    weight gradient there must still fail."""
    cell = tiny.tiny_cell(str(tmp_path), tiny.RN)
    record = tiny.run_tiny(cell, hooks=tiny.FAULTS["inner_wgrad"])
    _, correct, nums = prun.compose(cell, [record], False)
    assert not correct, nums


def test_exchange_left_out_is_not_correct(tmp_path):
    """Two gloo ranks through the port's launcher, each stepping on its
    own gradient; and the same launch without the fault is correct."""
    cell = tiny.tiny_cell(str(tmp_path), tiny.LM)
    cell.chips = 2
    args = argparse.Namespace(seed=2**31 + 5, seconds=0.2, trace=0)
    sound = prun.launch(cell, args, platform="cpu")
    assert prun.compose(cell, sound, False)[1]
    script = tiny.__file__.replace("portbench_tiny.py",
                                   "portbench_fault_worker.py")
    broken = prun.launch(cell, args, platform="cpu",
                         script=[script, "no_exchange"])
    _, correct, nums = prun.compose(cell, broken, False)
    assert not correct, nums


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(tmp_path, workload):
    """The control in the program's place fails the cell's limits."""
    cell = tiny.tiny_cell(str(tmp_path), workload)
    import torch

    dev = torch.device("cpu")
    seed, steps = 2**31 + 3, cell.traffic["check_steps"]
    reference = follow(cell.config, cell.traffic, seed, 0, steps, dev)
    control = follow(cell.config, cell.traffic, seed, 0, steps, dev,
                     precision="fp8")
    judge.settle_samples(control, reference)
    correct, nums = judge.judge(control, reference, cell.limits)
    assert not correct, nums
