"""Hold two readers against an answer known another way, on the card.

``python3 portbench/tools/check_readers.py``

- ``idle_share``: bursts of matmuls with host sleeps between them,
  traced; the reader's idle share against the one that CUDA events around
  each burst give over the same window.
- the flash rooflines: the port's flash kernels at the kernel table's
  slice shape (B 4, H 8, S 2048, D 64, causal, bf16), traced, through the
  cell's roofline readers; beside them the share that CUDA events give
  over the same launches issued back to back, the table's own method.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from portbench import readers, spec, trace, yardstick  # noqa: E402

SLICE = (4, 8, 2048, 64)
ROUNDS = 20


def idle_check(torch) -> dict:
    """Bursts of 8192² bf16 matmuls (about a millisecond each) with host
    sleeps of 2-8 ms between them, the card synchronised before each
    sleep; CUDA events around each burst give the busy time."""
    x = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    for _ in range(3):
        x @ x
    marks = []

    def run():
        for i in range(10):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(5 + 10 * (i % 3)):
                x @ x
            e.record()
            marks.append((s, e))
            torch.cuda.synchronize()
            time.sleep(0.002 * (1 + i % 4))

    summary = trace.profile_window(run)
    run_ = readers.Run(None, {}, [{"trace": dict(summary, steps=1)}])
    bursts_s = sum(s.elapsed_time(e) for s, e in marks) / 1e3
    return {"reader_idle_pct": readers.idle_share(run_),
            "events_idle_pct": 100.0 * (1 - bursts_s / summary["window_s"]),
            "window_s": summary["window_s"], "busy_s": summary["busy_s"],
            "bursts_by_events_s": bursts_s}


def flash_check(torch) -> dict:
    from horovod_tpu_torch.ops import flash_attention as fa

    b, h, s, d = SLICE
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    o, lse = fa.flash_fwd(q, k, v, True, scale)
    delta = (do.float() * o.float()).sum(-1)

    def fwd():
        fa.flash_fwd(q, k, v, True, scale)

    def bwd():
        fa.flash_bwd_dkv(q, k, v, do, lse, delta, True, scale)
        fa.flash_bwd_dq(q, k, v, do, lse, delta, True, scale)

    for _ in range(3):
        fwd()
        bwd()

    def run():
        for _ in range(ROUNDS):
            fwd()
            bwd()

    summary = trace.profile_window(run)
    summary["steps"] = ROUNDS
    cell = types.SimpleNamespace(
        config={"n_embd": h * d, "n_head": h, "dtype": "bfloat16"},
        traffic={"batch": b, "seq_len": s}, chips=1)
    run_ = readers.Run(cell, {}, [{"trace": summary}])
    out = {}
    for name in ("flash_fwd_roofline.lm", "flash_bwd_roofline.lm"):
        out["reader " + name] = spec.load_reader(name)(run_)
    bounds = yardstick.bounds(b, h, s, s, d, "bf16", True)
    for what, fn, bound in (
            ("fwd", fwd, bounds["flash_fwd"][0]),
            ("bwd pair", bwd, bounds["flash_bwd_dkv"][0]
             + bounds["flash_bwd_dq"][0])):
        times = []
        for _ in range(5):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(ROUNDS):
                fn()
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1) / ROUNDS)
        ms = statistics.median(times)
        out["events %s ms" % what] = ms
        out["events %s share pct" % what] = 100.0 * bound / ms
    fams = trace.family_seconds(summary, yardstick.family)
    out["traced ms a launch"] = {f: 1e3 * t / ROUNDS for f, t in fams.items()}
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("check_readers needs a CUDA card\n")
        return 2
    result = {"card": torch.cuda.get_device_name(0),
              "idle": idle_check(torch), "flash": flash_check(torch)}
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
