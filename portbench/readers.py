"""What the per-layer readers under ``metrics/`` share. A reader takes a
``Run`` and returns its number, or None where it finds nothing to read
(then the metric is left out of the line). Nothing here is read in a run
with ``--trace 0``.

A ``Run`` holds the cell, the end-to-end numbers of this run, and one
record a rank: ``window`` (the measured window's ``opt.step()``
milliseconds a step) and ``trace`` (``trace.summarize`` of
the traced steps, with ``steps``)."""

from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, Iterable, List, Optional

from portbench import trace as tr
from portbench import yardstick as ys


@dataclasses.dataclass
class Run:
    cell: object                 # spec.Cell
    end_to_end: Dict[str, float]
    ranks: List[dict]


def _traces(run: Run) -> List[dict]:
    return [r["trace"] for r in run.ranks if r.get("trace")]


def host_issue_ms(run: Run) -> Optional[float]:
    """Rank 0's host milliseconds to issue a step, from its first call to
    the return of ``opt.step()``, less the time in it that the host waited
    on the card (a full launch queue, a synchronise): the host's own
    cost, averaged over the traced steps. Where the card paces the step,
    the host's span is the card's; what is left is what the host spends."""
    t = run.ranks[0].get("trace")
    steps = t.get("host_steps") if t else None
    if not steps:
        return None
    return 1e3 * statistics.fmean(span - wait for span, wait in steps)


def opt_step_ms(run: Run) -> Optional[float]:
    """Rank 0's CUDA-event milliseconds around ``opt.step()`` (wait on the
    buckets, write-back, inner update), averaged over the window."""
    ms = run.ranks[0]["window"]["opt_step_ms"]
    return statistics.fmean(ms) if ms else None


def family_ms(run: Run, families: Iterable[str]) -> Optional[float]:
    """Kernel milliseconds a step in ``families``, averaged over ranks."""
    families = set(families)
    per_rank = []
    for t in _traces(run):
        secs = tr.family_seconds(t, ys.family)
        if any(f in secs for f in families):
            per_rank.append(1e3 * sum(secs.get(f, 0.0) for f in families)
                            / t["steps"])
    return statistics.fmean(per_rank) if per_rank else None


def exposed_ms(run: Run, fam: str) -> Optional[float]:
    """Milliseconds a step in which kernels of ``fam`` run on the card and
    no other kernel does, averaged over ranks."""
    per_rank = []
    for t in _traces(run):
        names = t["names"]
        mine, other = [], []
        for idx, s, e in t["kernels"]:
            (mine if ys.family(names[idx]) == fam else other).append((s, e))
        if mine:
            per_rank.append(1e3 * tr.uncovered(tr.union(mine),
                                               tr.union(other))
                            / t["steps"])
    return statistics.fmean(per_rank) if per_rank else None


def roofline(run: Run, families: List[str], bound_ms: float
             ) -> Optional[float]:
    """Percent: launches x the least time a launch could take, over the
    kernels' own time summed over the traced launches. A launch is one of
    ``families[0]``; the time is that of every family listed (the dQ
    kernel of the backward pair beside dK/dV). Over all ranks."""
    launches, secs = 0, 0.0
    for t in _traces(run):
        names = t["names"]
        for idx, s, e in t["kernels"]:
            f = ys.family(names[idx])
            if f == families[0]:
                launches += 1
            if f in families:
                secs += e - s
    if not launches or secs <= 0:
        return None
    return 100.0 * launches * bound_ms / 1e3 / secs


def flash_bounds(run: Run) -> Dict[str, float]:
    """bound_ms of each flash kernel at the cell's attention shape."""
    cfg, traffic = run.cell.config, run.cell.traffic
    b, h, s, d = ys.attention_shape(cfg, traffic)
    kind = {"bfloat16": "bf16", "float16": "fp16"}[cfg["dtype"]]
    return {k: v[0] for k, v in ys.bounds(b, h, s, s, d, kind,
                                          True).items()}


def mfu(run: Run, rate: str, flops_per_unit: float) -> Optional[float]:
    """Percent of the cards' bf16 peak: model FLOPs of a unit x the rate
    of this run's window, over chips x 989 TFLOP/s."""
    value = run.end_to_end.get(rate)
    if not value:
        return None
    return 100.0 * value * flops_per_unit / (
        run.cell.chips * ys.PEAK_FLOPS["bf16"])


def idle_share(run: Run) -> Optional[float]:
    """Percent of the traced window in which no operation ran on the card,
    averaged over ranks (1 - busy_s / window_s)."""
    traces = _traces(run)
    if not traces:
        return None
    return 100.0 * statistics.fmean(1.0 - t["busy_s"] / t["window_s"]
                                    for t in traces)
