"""Diagnostics of the Hopper flash forward: variants built from text edits.

Builds copies of this checkout's ``horovod_tpu_torch/csrc/flash_attention.cu``
with ``hopper_fwd.cuh`` (which holds ``fwd_wgmma_kernel``), each with one
change to the header, and times their ``hvd_flash_fwd`` in turns with the
unchanged kernel and with SDPA's forward (bf16, causal; each the median of
5 rounds of 20, CUDA events, as ``chip_smoke.py`` times kernels):

- ``products``: the softmax stubbed (P is the raw scores, O is not
  rescaled): what the wgmma products and the pipeline alone take;
- ``no_turns``: the two consumer warpgroups issue their products without
  taking turns (no named barriers);
- ``keys64``: 64-key tiles at every head dim (128 at D <= 64 otherwise);
- ``keys128``: 128-key tiles at every head dim (64 at D = 128 otherwise).

With ``--wide`` it builds ``flash_attention_wide.cu`` instead, where the
same kernel runs at D = 192 and 256 (and ``wide_fwd_wgmma_kernel`` above),
and times the four catalog shapes of ``chip_smoke.WIDE_SHAPES``: the
kernel at each; ``products``, ``no_turns`` and ``keys_wide`` (96-key tiles
at D = 192, 80-key tiles at 256), which edit ``hopper_fwd.cuh``, only at
the head dims that header's kernel serves there (192 and 256); and the
heads' grouping of both wide forwards (``grouped_tile`` in
``hopper_common.cuh``) at other L2 budgets, at every shape: ``l2_8MB``,
``l2_64MB`` and ``ungrouped`` (query tiles last to first across all
heads).

Only the times are read: ``products`` computes a wrong result by design.
Every edit asserts that its text is in the source, so a tool that no
longer matches the kernel stops instead of timing the wrong thing.

Run from the repo root on a machine with a card::

    python3 -m tools.flash_fwd_variants [--wide]

Prints the card (``nvidia-smi`` name and power limit), each variant's
ptxas spill line, and one line per shape with each variant's ms.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SHAPES = ((4, 8, 2048, 64), (1, 32, 2048, 128), (4, 8, 2048, 32))


def _softmax_stub(src: str) -> str:
    head = "template <int HN, bool MASK>\n__device__ __forceinline__ " \
           "void softmax_tile("
    start = src.index(head)
    end = src.index("\n}\n", start) + 3
    body = src.index("{\n", start) + 2
    return src[:body] + "  alpha[0] = alpha[1] = 1.f;\n}\n" + src[end:]


def _edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit("flash_fwd_variants: %r is no longer in the "
                         "source" % old[:60])
    return src.replace(old, new)


GROUP = "constexpr long long L2_GROUP_BYTES = 16ll << 20;"


# The wide head dims at which flash_attention_wide.cu runs hopper_fwd.cuh's
# kernel (its HVD_ROWS_FWD_DIMS): the only ones an edit of that header
# changes.
ROWS_DIMS = (192, 256)


def wide_variants(src: str, common: str):
    """{name: (hopper_fwd.cuh, hopper_common.cuh, the head dims it is
    timed at, or None for every shape)} of ``--wide``."""
    old = "static constexpr int HN = D <= 64 ? 128 : 64;"
    out = {
        "kernel": (src, common, None),
        "products": (_softmax_stub(src), common, ROWS_DIMS),
        "no_turns": (variants(src)["no_turns"], common, ROWS_DIMS),
        "keys_wide": (_edit(src, old, "static constexpr int HN = D <= 64 ? "
                            "128 : D == 192 ? 96 : D == 256 ? 80 : 64;"),
                      common, ROWS_DIMS),
    }
    for name, budget in (("l2_8MB", "8ll << 20"), ("l2_64MB", "64ll << 20"),
                         ("ungrouped", "1ll << 60")):
        out[name] = (src, _edit(common, GROUP, GROUP.replace(
            "16ll << 20", budget)), None)
    return out


def variants(src: str):
    return {
        "kernel": src,
        "products": _softmax_stub(src),
        "no_turns": _edit(_edit(
            src, 'asm volatile("bar.sync %0, 256;\\n" ::"r"(1 + wg) '
                 ': "memory");', ""),
            'asm volatile("bar.arrive %0, 256;\\n" ::"r"(2 - wg) '
            ': "memory");', ""),
        "keys64": _edit(src, "static constexpr int HN = D <= 64 ? 128 : 64;",
                        "static constexpr int HN = 64;"),
        "keys128": _edit(src, "static constexpr int HN = D <= 64 ? 128 : 64;",
                         "static constexpr int HN = 128;"),
    }


def main() -> int:
    import torch

    import chip_smoke
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_fwd_variants: no CUDA device", file=sys.stderr)
        return 1
    print("card: %s" % chip_smoke.card_line())
    wide = "--wide" in sys.argv
    csrc = _build.CSRC
    library = "flash_attention_wide" if wide else "flash_attention"
    fwd_src = (csrc / "hopper_fwd.cuh").read_text()
    common = (csrc / "hopper_common.cuh").read_text()
    headers = wide_variants(fwd_src, common) if wide else {
        name: (text, common, None)
        for name, text in variants(fwd_src).items()}
    shapes = [shape for _, shape in chip_smoke.WIDE_SHAPES] if wide \
        else SHAPES

    def build(name):
        # Each variant in its own directory, beside its own header.
        tmp = Path(tempfile.mkdtemp(prefix="hvd_fwd_%s_" % name))
        for src in csrc.glob("*.cuh"):
            (tmp / src.name).write_text(src.read_text())
        (tmp / "hopper_fwd.cuh").write_text(headers[name][0])
        (tmp / "hopper_common.cuh").write_text(headers[name][1])
        path = tmp / (library + ".cu")
        path.write_text((csrc / (library + ".cu")).read_text())
        out = tmp / ("lib%s.so" % name)
        proc = subprocess.run(_build.nvcc_command(path, out),
                              capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit("%s does not build:\n%s%s"
                             % (name, proc.stdout, proc.stderr))
        return name, out, proc.stdout + proc.stderr

    fns = {}
    with concurrent.futures.ThreadPoolExecutor(len(headers)) as pool:
        for name, out, log in pool.map(build, headers):
            spills = sorted(set(re.findall(
                r"Function properties for \w*[0-9]fwd_wgmma_kernel\w*\n"
                r"\s*\d+ bytes stack frame, (\d+) bytes spill stores", log)))
            print("ptxas %s: fwd_wgmma_kernel spill stores %s bytes%s"
                  % (name, "/".join(spills) or "?",
                     "; wgmma serialized" if "serialized" in log else ""))
            fn = ctypes.CDLL(str(out)).hvd_flash_fwd
            fn.argtypes, fn.restype = _build.SIGNATURES["flash_attention"][
                "hvd_flash_fwd"]
            fns[name] = fn
    for b, h, s, d in shapes:
        q, k, v, _ = chip_smoke.make_inputs(torch, b, h, s, s, d,
                                            torch.bfloat16, "cuda",
                                            chip_smoke.SEED)
        o = torch.empty_like(q)
        lse = torch.empty(b, h, s, device="cuda")

        def call(fn):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     lse.data_ptr(), b, h, s, s, d,
                     fa._DTYPE_CODES[torch.bfloat16], 1, d ** -0.5,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit("hvd_flash_fwd failed (%d)" % err)

        here = {name: fn for name, fn in fns.items()
                if headers[name][2] is None or d in headers[name][2]}
        times = {name: [] for name in list(here) + ["sdpa"]}
        for _ in range(2):  # two passes over every variant, in turns
            for name, fn in here.items():
                times[name].append(chip_smoke.median_ms(
                    torch, lambda: call(fn), 20))
            times["sdpa"].append(chip_smoke.median_ms(
                torch, lambda: torch.nn.functional.
                scaled_dot_product_attention(q, k, v, is_causal=True), 20))
        print("B=%d H=%d S=%d D=%d bf16 causal (bound %.4f ms): %s"
              % (b, h, s, d, chip_smoke.bounds(b, h, s, s, d, "bf16", True)[
                  "flash_fwd"][0], "; ".join(
                  "%s %s ms" % (name, " ".join("%.4f" % t for t in ts))
                  for name, ts in times.items())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
