"""The comparison that decides ``correct`` for a training cell.

The numbers, each compared against its limit where the cell's
``limits/<workload>.json`` gives one (the others are printed as readings):

- ``loss_gap``: the largest over the checked steps of
  |program's loss - reference's| / |reference's|;
- ``grad_gap``: the worst leaf's gap between the program's norm of the
  first step's gradient (as its optimizer got it, worked out from the
  optimizer's state after one step) and the reference's;
- ``change_gap``: the same for each leaf's change over the checked steps;
- ``grad_gap_median``, ``change_gap_median``: the median leaf's gap;
- ``grad_diff_median``: the median leaf's |g_program - g_reference| /
  |g_reference| of the first step's gradient, over a strided sample of
  ``SAMPLE`` elements of each leaf (the same positions on both sides). A
  gap of norms is blind to rounding that leaves a gradient's size alone
  and turns its direction; this reads the direction;
- ``change_diff_median``: the same for each leaf's change over the checked
  steps (parameters and running statistics);
- ``grad_diff``, ``change_diff``: the worst leaf's of these, each leaf's
  |g_program - g_reference| / |g_reference| weighed as a gap of norms is,
  by min(1, its reference norm / the median leaf's). A median does not
  move when one layer in ten goes wrong; the worst leaf does, but it
  also holds the widest rounding of the cell's own precision;
- ``state_gap``, ``state_gap_median``, ``state_diff``,
  ``state_diff_median``: the same four for the optimizer's first moment
  after the last checked step (SGD's momentum buffer, AdamW's
  ``exp_avg``), a sum of every checked step's gradient. A ResNet block's
  inner layers, whose first gradient is 0 behind the block's last batch
  norm at scale 0, and whose change over the checked steps is under a
  thousandth of the median leaf's, hold a first moment there above the
  median leaf's.

A leaf's gap is |norm_program - norm_reference| over the larger of the
reference's norm of that leaf and the median leaf's. Leaves whose
reference norm is under a thousandth of the median leaf's are nought to
rounding (they move by round-off alone) and are left out, by that rule
and not by name; the median is taken over leaves whose norm is not 0.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Tuple

import torch

NOUGHT = 1e-3
SAMPLE = 65536
NUMBERS = ("loss_gap", "grad_gap", "grad_gap_median", "change_gap",
           "change_gap_median", "grad_diff", "grad_diff_median",
           "change_diff", "change_diff_median", "state_gap",
           "state_gap_median", "state_diff", "state_diff_median")
DIRECTIONS = ("grad", "change", "state")


def sample(t: torch.Tensor) -> torch.Tensor:
    """Every ``numel // SAMPLE``-th element of ``t`` (all of a smaller
    leaf), a copy in float32 on the host: the optimizer's state that it
    may come from changes in place at the next step."""
    flat = t.detach().reshape(-1)
    stride = max(1, flat.numel() // SAMPLE)
    return flat[::stride][:SAMPLE].float().cpu().clone()


def sample_diffs(program: Dict[str, torch.Tensor],
                 reference: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's |program - reference| / |reference| over its sample."""
    out = {}
    for name, ref in reference.items():
        den = float(torch.linalg.vector_norm(ref))
        got = program.get(name)
        num = float(torch.linalg.vector_norm(got - ref)) \
            if got is not None and got.shape == ref.shape else float("nan")
        out[name] = num / den if den > 0 else 0.0
    return out


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float]
              ) -> Dict[str, float]:
    """Each counted leaf's gap (inf where the program's is not finite)."""
    nonzero = [v for v in reference.values() if v > 0]
    if not nonzero:
        raise ValueError("every reference leaf is 0")
    median = statistics.median(nonzero)
    gaps = {}
    for name, ref in reference.items():
        if ref < NOUGHT * median:
            continue
        gap = abs(program.get(name, float("nan")) - ref) / max(ref, median)
        gaps[name] = gap if math.isfinite(gap) else float("inf")
    return gaps


def loss_gap(program: List[float], reference: List[float]) -> float:
    if len(program) != len(reference):
        raise ValueError("%d program losses against %d reference losses"
                         % (len(program), len(reference)))
    gaps = [abs(p - r) / abs(r) for p, r in zip(program, reference)]
    return max(g if math.isfinite(g) else float("inf") for g in gaps)


def numbers(program: dict, reference: dict) -> Dict[str, dict]:
    """Each number compared, with the leaf that set it where one did."""
    out = {"loss_gap": {"value": loss_gap(program["losses"],
                                          reference["losses"])}}
    for what in DIRECTIONS:
        if what + "_norms" not in reference:
            continue
        gaps = leaf_gaps(program[what + "_norms"], reference[what + "_norms"])
        worst = max(gaps, key=gaps.get)
        out[what + "_gap"] = {"value": gaps[worst], "leaf": worst}
        out[what + "_gap_median"] = {"value": statistics.median(
            gaps.values())}
    for what in DIRECTIONS:
        leaves = leaf_diffs(program, reference, what)
        if leaves is None:
            continue
        out[what + "_diff_median"] = {"value": statistics.median(
            d for d, _ in leaves.values())}
        weighed = {n: d * min(1.0, r) for n, (d, r) in leaves.items()}
        worst = max(weighed, key=weighed.get)
        out[what + "_diff"] = {"value": weighed[worst], "leaf": worst}
    return out


def leaf_diffs(program: dict, reference: dict, what: str
               ) -> Optional[Dict[str, Tuple[float, float]]]:
    """{leaf: (its direction diff, its reference norm / the median
    leaf's)} over the counted leaves of ``what`` ("grad", "change" or
    "state"); None where the samples were not compared."""
    diffs = reference.get(what + "_diffs")
    if diffs is None:
        return None
    ref = reference[what + "_norms"]
    counted = leaf_gaps(program[what + "_norms"], ref)
    median = statistics.median(v for v in ref.values() if v > 0)
    return {n: (diffs[n] if math.isfinite(diffs[n]) else float("inf"),
                ref[n] / median) for n in counted}


def settle_samples(program: dict, reference: dict) -> None:
    """Replace the two sides' samples of the first gradient, of the
    change and of the last first moment by the reference's ``grad_diffs``,
    ``change_diffs`` and ``state_diffs`` (the samples are large; the
    numbers need only these)."""
    for what in DIRECTIONS:
        reference[what + "_diffs"] = sample_diffs(
            program.pop(what + "_sample"), reference.pop(what + "_sample"))


def judge(program: dict, reference: dict, limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {number: {value, [limit], ...}}): correct when every
    number that has a limit is finite and at most it."""
    nums = numbers(program, reference)
    ok = True
    for name, limit in limits.items():
        entry = nums[name]
        entry["limit"] = limit
        ok = ok and math.isfinite(entry["value"]) and entry["value"] <= limit
    return ok, nums
