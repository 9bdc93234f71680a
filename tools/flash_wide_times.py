"""Flash attention's times on the card at the catalog's wide head dims.

Runs ``chip_smoke.py``'s ``kernel_times`` (each kernel's ms, the median of
5 rounds of 20 in turns with SDPA's forward; its plain version's; SDPA's
forward and backward; the bound) in bf16, causal, at the attention of the
four catalog layers of ``chip_smoke.WIDE_SHAPES`` (GLM-5.2 192,
Qwen3-Next-80B-A3B 256, DeepSeek-V4-Flash 512, sarvam-105b 576; k and v at
the query head count), which run on the wide family
(``csrc/flash_attention_wide.cu``), and at ``chip_smoke.D128_SHAPE``.
``chip_smoke.py`` itself times only the Qwen3-Next-80B-A3B shape, within
its time limit. With ``--parent DIR`` (an unpacked parent tree) it first
times the parent's wide forward and wide backward pair (dK/dV then dQ),
built from ``DIR``'s ``flash_attention_wide.cu``, against this tree's at
the four shapes, in turns parent, new, new, parent
(``chip_smoke.ab_forward`` and ``chip_smoke.ab_backward``).

Run from the repo root on a machine with a card::

    python3 -m tools.flash_wide_times [--parent DIR]

Prints the card (``nvidia-smi`` name and power limit), the ``ab forward``
and ``ab backward`` lines, and one ``time`` line per kernel and shape, as
``chip_smoke.py`` does.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", help="an unpacked parent tree")
    args = parser.parse_args()
    import torch

    import chip_smoke
    from horovod_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_wide_times: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print("card: %s" % chip_smoke.card_line())
    if args.parent:
        lib = chip_smoke.parent_library(args.parent, "flash_attention_wide")
        for label, shape in chip_smoke.WIDE_SHAPES:
            chip_smoke.ab_forward(torch, fa, lib.hvd_flash_fwd, shape,
                                  torch.bfloat16, "cuda", "%s; the parent's "
                                  "wide forward against this tree's" % label)
            chip_smoke.ab_backward(torch, fa, lib, shape, torch.bfloat16,
                                   "cuda", "%s; the parent's wide backward "
                                   "pair against this tree's" % label)
    chip_smoke.kernel_times(torch, fa, *chip_smoke.D128_SHAPE,
                            torch.bfloat16, "cuda", " (head dim 128)")
    for label, shape in chip_smoke.WIDE_SHAPES:
        chip_smoke.kernel_times(torch, fa, *shape, torch.bfloat16, "cuda",
                                " (%s, wide)" % label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
