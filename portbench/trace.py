"""The traced window: a few steps under ``torch.profiler`` (CPU and CUDA
activity), cut down to what the per-layer readers and the breakdown need.

The window is the host's span ``portbench.window`` around the steps and a
final ``synchronize``; the device's operations (kernels, copies, sets;
not the device-side copies of user annotations) are clipped to it. Busy
time is the union of their spans, as ``chip_smoke.py``'s
``device_breakdown`` computes it. An idle gap is labelled by the phase of
the step (``portbench.forward``, ``.backward``, ``.opt_step``) and the
innermost host operation running where the gap ends: what the host was
doing while the card waited.

Each traced step's host span runs from its ``forward`` phase's start to
the end of its ``opt_step``. Inside it, the host may wait on the card:
in "Command Buffer Full" (a launch that finds the card's queue full, as
it does when the card paces the step) or in a CUDA synchronise. The
summary keeps each step's span and that waiting beside it."""

from __future__ import annotations

import bisect
import contextlib
from typing import Callable, Dict, List, Optional

PHASE = "portbench."
TOP = 10            # entries of each list of the breakdown
MIN_GAP_S = 5e-6    # shorter gaps are launch latency, not labelled
BLOCKED = "Command Buffer Full"
WALK = 400          # host operations looked back at from a gap's end


def phase(name: str, on: bool):
    """A labelled span of a traced step; nothing when not tracing."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(PHASE + name)


def profile_window(run: Callable[[], None],
                   warm: Optional[Callable[[], None]] = None) -> dict:
    """Run ``run`` (which issues the traced steps) under the profiler and
    return ``summarize`` of it. ``warm`` runs first under the profiler but
    outside the window, so that the tracer's start-up falls on it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if warm is not None:
            warm()
            torch.cuda.synchronize()
        with record_function(PHASE + "window"):
            run()
            torch.cuda.synchronize()
    return summarize(prof.profiler.kineto_results.events())


def summarize(events) -> dict:
    """{window_s, busy_s, names, kernels: [[name index, start s, end s]]
    (relative to the window's start), device_ops, idle_gaps, host_steps:
    [[span s, waiting s]] a traced step}."""
    from torch.autograd import DeviceType

    window, host, phases, device, waits = None, [], [], [], []
    for ev in events:
        name = ev.name()
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == DeviceType.CPU:
            if name == BLOCKED or (name.startswith("cuda")
                                   and name.endswith("Synchronize")):
                waits.append((start, end))
            if name == PHASE + "window":
                window = (start, end)
            elif name.startswith(PHASE):
                phases.append((start, end, name[len(PHASE):]))
            elif not name.startswith(("cuda", "cu")) \
                    and not ev.is_user_annotation():
                host.append((start, end, name))
        elif not ev.is_user_annotation():
            device.append((start, end, name))
    if window is None:
        raise RuntimeError("the profiler kept no window span")
    ws, we = window
    device = sorted((max(s, ws), min(e, we), n) for s, e, n in device
                    if e > ws and s < we)
    names: Dict[str, int] = {}
    kernels, by_name = [], {}
    for s, e, n in device:
        idx = names.setdefault(n, len(names))
        kernels.append([idx, (s - ws) / 1e9, (e - ws) / 1e9])
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
    busy, gaps, cur = 0.0, [], None
    for s, e, _ in device:
        if cur is None:
            gaps.append((ws, s))
            cur = [s, e]
        elif s > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
        gaps.append((cur[1], we))
    else:
        gaps.append((ws, we))
    return {"window_s": (we - ws) / 1e9, "busy_s": busy / 1e9,
            "names": sorted(names, key=names.get), "kernels": kernels,
            "device_ops": sorted(([n, t] for n, t in by_name.items()),
                                 key=lambda kv: -kv[1])[:TOP],
            "idle_gaps": _label_gaps(gaps, host, phases),
            "host_steps": host_steps(phases, waits)}


def host_steps(phases, waits) -> List[list]:
    """[span s, waiting s] of each step: from a ``forward`` phase's start
    to the end of the next ``opt_step``, and the part of it that the
    union of ``waits`` covers."""
    waits = union(waits)
    starts = sorted(s for s, _, n in phases if n == "forward")
    ends = sorted(e for _, e, n in phases if n == "opt_step")
    out = []
    for s in starts:
        e = next((x for x in ends if x > s), None)
        if e is None:
            continue
        span = (e - s) / 1e9
        free = uncovered([[s, e]], waits) / 1e9
        out.append([span, span - free])
    return out


def _innermost(spans: List[tuple], starts: List[int], t) -> str:
    i = bisect.bisect_right(starts, t) - 1
    best = None
    for j in range(i, max(i - WALK, -1), -1):
        s, e, n = spans[j]
        if e >= t and (best is None or s > best[0]):
            best = (s, n)
    return best[1] if best else "none"


def _label_gaps(gaps, host, phases) -> List[list]:
    host.sort()
    phases.sort()
    hs, ps = [h[0] for h in host], [p[0] for p in phases]
    by_label: Dict[str, float] = {}
    for s, e in gaps:
        if (e - s) / 1e9 < MIN_GAP_S:
            continue
        label = "%s:%s" % (_innermost(phases, ps, e),
                           _innermost(host, hs, e))
        by_label[label] = by_label.get(label, 0.0) + (e - s) / 1e9
    return sorted(([k, v] for k, v in by_label.items()),
                  key=lambda kv: -kv[1])[:TOP]


def family_seconds(summary: dict, fam: Callable[[str], str]
                   ) -> Dict[str, float]:
    """Device seconds in the window by kernel family."""
    out: Dict[str, float] = {}
    names = summary["names"]
    for idx, s, e in summary["kernels"]:
        f = fam(names[idx])
        out[f] = out.get(f, 0.0) + (e - s)
    return out


def union(spans: List[tuple]) -> List[list]:
    merged: List[list] = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def uncovered(spans: List[list], cover: List[list]) -> float:
    """Length of the union ``spans`` that the union ``cover`` leaves
    uncovered."""
    out, j = 0.0, 0
    for s, e in spans:
        t = s
        while j < len(cover) and cover[j][1] <= t:
            j += 1
        k = j
        while t < e:
            if k < len(cover) and cover[k][0] < e:
                c0, c1 = cover[k]
                if c0 > t:
                    out += c0 - t
                t = max(t, c1)
                k += 1
            else:
                out += e - t
                t = e
    return out
