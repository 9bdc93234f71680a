"""The reference's run of a training cell's first steps: the same weights
and batches as the program's, every rank's gradient summed over the ranks
and divided by the tokens or images of all of them, then the optimizer by
its formula. It returns what the comparison reads: the mean loss of each
step, each leaf's norm of the first step's gradient, each leaf's norm
of its change over the steps (parameters and running statistics), and
each leaf's norm of the optimizer's first moment after the last step."""

from __future__ import annotations

from typing import Optional

import torch

from portbench import feed, weights
from portbench.reference import lm, resnet
from portbench.judge import sample
from portbench.reference.common import (Ops, exact, first_moment, norms,
                                        step_optimizer, sum_over_ranks)

# The faults a training check must catch, planted in the reference put in
# the program's place: "half_batch" drops the second half of each rank's
# batch and takes the mean over the rest; "no_exchange" skips the sum
# over ranks, so each rank steps on its own gradient; "inner_wgrad"
# doubles the weight gradient of each ResNet block's 3x3 convolution;
# "inner_flip" turns it end for end in both spatial dimensions instead
# (its norm stays).
FAULTS = ("half_batch", "no_exchange", "inner_wgrad", "inner_flip")
INNER = ("blocks.", "conv1.weight")


def trainable(config: dict, W) -> list:
    """The leaves the optimizer updates: all but batch-norm statistics."""
    return [n for n in W if not n.endswith((".mean", ".var"))] \
        if config["family"] == "resnet" else list(W)


def follow(config: dict, traffic: dict, seed: int, rank: int, steps: int,
           device, precision: str = "fp32",
           fault: Optional[str] = None) -> dict:
    if fault is not None and fault not in FAULTS:
        raise ValueError("unknown fault %r" % (fault,))
    ops = Ops(precision)
    W = weights.make(config, seed, device)
    names = trainable(config, W)
    params = {n: W[n] for n in names}
    for p in params.values():
        p.requires_grad_(True)
    state, losses, first = {}, [], None
    with exact():
        for step in range(steps):
            x, y = feed.batch(traffic, config, seed, rank, step, device)
            if fault == "half_batch":
                x, y = x[:x.shape[0] // 2], y[:y.shape[0] // 2]
            count = torch.tensor(float(y.numel()), device=device)
            if config["family"] == "transformer":
                loss = lm.accumulate(W, config, x, y, ops)
                stats = None
            else:
                loss, stats = resnet.accumulate(W, config, x, y, ops)
            grads = {n: p.grad for n, p in params.items()}
            if fault in ("inner_wgrad", "inner_flip"):
                with torch.no_grad():
                    for n, g in grads.items():
                        if n.startswith(INNER[0]) and n.endswith(INNER[1]):
                            g.copy_(g * 2 if fault == "inner_wgrad"
                                    else g.flip(-1, -2))
            totals = torch.stack([loss, count])
            exchange = fault != "no_exchange"
            sum_over_ranks(list(grads.values()), exchange)
            # The losses are read as the mean over ranks, as the program's
            # are, whether or not the gradients were exchanged.
            sum_over_ranks([totals])
            mean_count = totals[1] if exchange else count
            with torch.no_grad():
                for g in grads.values():
                    g.div_(mean_count)
                losses.append(float(totals[0] / totals[1]))
                if step == 0:
                    first = norms(grads)
                    kept = {n: sample(g) for n, g in grads.items()}
                step_optimizer(traffic["optimizer"], params, grads, state)
                if stats is not None:
                    resnet.update_running(W, stats)
            for p in params.values():
                p.grad = None
    moments = {n: first_moment(state, n) for n in params}
    last = norms(moments)
    last_kept = {n: sample(m) for n, m in moments.items()}
    del state, grads, params, moments
    with torch.no_grad():
        start = weights.make(config, seed, device)
        change = norms({n: W[n].detach() - start[n] for n in W})
        moved = {n: sample(W[n].detach() - start[n]) for n in W}
    return {"losses": losses, "grad_norms": first, "change_norms": change,
            "state_norms": last, "grad_sample": kept,
            "change_sample": moved, "state_sample": last_kept}
