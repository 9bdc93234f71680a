"""The ring-step codec kernels' times on the card, for one checkout's port.

Times ``codec_encode`` and ``codec_decode_reduce`` (sum) of
``horovod_tpu_torch/ops/codec.py`` for bf16, fp16 and int8 as
``chip_smoke.py``'s ``codec_times`` does: one step of the 4-member ring
over the 161 ResNet-50 gradients (6,389,258 fp32 values), the fp32 block
and its wire bytes at each of the ring's two phases, each call on the next
of enough input sets that the others hold twice the L2; ``ms`` on the
card's clock (a sleep kernel ahead of the calls), ``issue_ms`` issued back
to back, and the PyTorch call that computes the same function. The timing
code is this checkout's, whichever port it times, so two ports timed in
one call on one card compare like with like.

Run from the repo root on a machine with a card::

    python3 -m tools.codec_times                 # this checkout's port
    python3 tools/codec_times.py --root DIR      # the port under DIR

Prints one JSON line: the card (``nvidia-smi`` name and power limit), the
root, and one row per (kernel, codec, phase).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
# All 161 ResNet-50 v1.5 gradients (PERF.md, the codec cell).
RESNET50_VALUES = 25557032


def _wire_pad(codec: int, f32_addr: int, wire_addr: int) -> int:
    """ops/codec.py ``wire_pad``, for a port that has none: where the ring
    of this checkout places a chunk's wire bytes."""
    phase = (f32_addr // 4) % 4
    if codec == 3:
        return (phase - (wire_addr + 4)) % 4
    return (2 * phase - wire_addr) % 8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE),
                    help="the checkout whose horovod_tpu_torch is timed")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    import chip_smoke  # this checkout's timing code

    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("tools.codec_times: no CUDA device", file=sys.stderr)
        return 1
    from horovod_tpu_torch.ops import codec

    if not hasattr(codec, "wire_pad"):
        codec.wire_pad = _wire_pad
    times = chip_smoke.codec_times(torch, codec, [RESNET50_VALUES], "cuda",
                                   feedback=False)
    rows = [dict(kernel=k, codec=c, phase=p,
                 **{key: t[key] for key in ("ms", "issue_ms", "library_ms",
                                            "bound_ms", "plain_ms")})
            for (k, c, p), t in times.items()]
    print(json.dumps({"card": chip_smoke.card_line(),
                      "root": str(Path(args.root).resolve()),
                      "codec_py": codec.__file__, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
