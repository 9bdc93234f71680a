"""Diagnostics of the Hopper wide backward: variants built from text edits.

Builds copies of this checkout's ``horovod_tpu_torch/csrc/
flash_attention_wide.cu``, each with one change, and times their
``hvd_flash_bwd_dkv`` and ``hvd_flash_bwd_dq`` in turns with the unchanged
kernels (bf16, causal, at the four catalog shapes of
``chip_smoke.WIDE_SHAPES``; each the median of 3 rounds of 10, CUDA events,
two passes over every variant):

- ``rows_loaded``: ``wide_dkv_wgmma_kernel``'s consumers read each query
  tile's lse and delta from device memory (16 values a thread at 64-row
  tiles) instead of from the rows the producer stages in shared memory;
- ``rows_const``: those values replaced by constants, what the kernel takes
  without them (a wrong result);
- ``no_scores``: ``wide_dkv_wgmma_kernel`` without its score products (a
  wrong result): what the rest of a tile takes;
- ``stages2``: two stages of the streamed operands at every head dim;
- ``stages3``: three stages wherever they fit, the streamed tile shrinking
  to make room (64 to 32 rows at D = 256, for one);
- ``rows_stages2`` and ``rows_stages4``: ``wide_dq_rows_wgmma_kernel`` (dQ
  at D = 192 and 256) with two stages of a larger key tile, or four of a
  smaller one, in place of three.

Every edit asserts that its text is in the source, so a tool that no longer
matches the kernels stops instead of timing the wrong thing. A variant's
results are compared with the unchanged kernels' bit for bit; one that
differs prints its largest error as a fraction of ``chip_smoke.TOLS``.

Run from the repo root on a machine with a card::

    python3 -m tools.flash_bwd_variants

Prints the card (``nvidia-smi`` name and power limit), each variant's
ptxas spill and serialization report, and one line per shape with each
variant's ms for both kernels.
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

ROWS_STAGED = """    // This thread's query columns q0 + 8 i + 2 t + c: -lse log2(e)
    // (warpgroup 0) or delta (1).
    const float* rs = Rs + st * 2 * BM + wg * BM;
    float cv[BM / 4];
#pragma unroll
    for (int i = 0; i < BM / 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) cv[2 * i + c] = rs[8 * i + 2 * t + c];"""
ROWS_LOADED = """    const float* cvp = (wg == 0 ? lse : delta) + (size_t)bh * Sq;
    float cv[BM / 4];
#pragma unroll
    for (int i = 0; i < BM / 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = q0 + 8 * i + 2 * t + c;
        cv[2 * i + c] = col >= Sq ? (wg == 0 ? -INFINITY : 0.f)
                        : wg == 0 ? -__ldg(cvp + col) * LOG2E
                                  : __ldg(cvp + col);
      }"""
ROWS_CONST = ROWS_STAGED.replace("rs[8 * i + 2 * t + c]", "1e-3f * c")
SCORES = "    issue_abt<BM, D, 64, L::AB, T>(s, a_desc, b_desc + st * QO_STEP);\n"
TILE_RULE = """  for (int rows = 64; rows >= 16; rows -= 16)
    if (wide_bwd_fits(D, dkv, rows, 2))
      return rows * 8 + (wide_bwd_fits(D, dkv, rows, 3) ? 3 : 2);
  return 0;"""
TWO_STAGES = """  for (int rows = 64; rows >= 16; rows -= 16)
    if (wide_bwd_fits(D, dkv, rows, 2)) return rows * 8 + 2;
  return 0;"""
THREE_FIRST = """  for (int ns = 3; ns >= 2; --ns)
    for (int rows = 64; rows >= 16; rows -= 16)
      if (wide_bwd_fits(D, dkv, rows, ns)) return rows * 8 + ns;
  return 0;"""

ROWS_STAGES = "constexpr int WIDE_DQ_ROWS_STAGES = 3;"


def _edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit("flash_bwd_variants: %r is not once in the source"
                         % old[:60])
    return src.replace(old, new)


def variants(src: str):
    """{name: the edited flash_attention_wide.cu}."""
    return {
        "kernel": src,
        "rows_loaded": _edit(src, ROWS_STAGED, ROWS_LOADED),
        "rows_const": _edit(src, ROWS_STAGED, ROWS_CONST),
        "no_scores": _edit(src, SCORES, ""),
        "stages2": _edit(src, TILE_RULE, TWO_STAGES),
        "stages3": _edit(src, TILE_RULE, THREE_FIRST),
        "rows_stages2": _edit(src, ROWS_STAGES,
                              ROWS_STAGES.replace("3", "2")),
        "rows_stages4": _edit(src, ROWS_STAGES,
                              ROWS_STAGES.replace("3", "4")),
    }


def main() -> int:
    import torch

    import chip_smoke
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    print("card: %s" % chip_smoke.card_line())
    csrc = _build.CSRC
    library = "flash_attention_wide"
    sources = variants((csrc / (library + ".cu")).read_text())

    def build(name):
        # Each variant in its own directory, beside the headers.
        tmp = Path(tempfile.mkdtemp(prefix="hvd_bwd_%s_" % name))
        for src in csrc.glob("*.cuh"):
            (tmp / src.name).write_text(src.read_text())
        path = tmp / (library + ".cu")
        path.write_text(sources[name])
        out = tmp / ("lib%s.so" % name)
        proc = subprocess.run(_build.nvcc_command(path, out),
                              capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit("%s does not build:\n%s%s"
                             % (name, proc.stdout, proc.stderr))
        return name, out, proc.stdout + proc.stderr

    libs = {}
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        for name, out, log in pool.map(build, sources):
            spills = sorted(set(re.findall(
                r"Function properties for \w*wide_d(?:kv|q|q_rows)_wgmma_kernel"
                r"\w*\n"
                r"\s*\d+ bytes stack frame, (\d+) bytes spill stores", log)))
            print("ptxas %s: wide_dkv/dq_wgmma_kernel spill stores %s "
                  "bytes; %s" % (name, "/".join(spills) or "?",
                                 "wgmma serialized" if "serialized" in log
                                 else "no wgmma serialized"))
            # The two entry points, with the signatures the port declares.
            lib = ctypes.CDLL(str(out))
            libs[name] = {}
            for fn in ("hvd_flash_bwd_dkv", "hvd_flash_bwd_dq"):
                entry = getattr(lib, fn)
                entry.argtypes, entry.restype = _build.SIGNATURES[library][fn]
                libs[name][fn] = entry
    code = fa._DTYPE_CODES[torch.bfloat16]
    for label, (b, h, s, d) in chip_smoke.WIDE_SHAPES:
        scale = d ** -0.5
        q, k, v, do = chip_smoke.make_inputs(torch, b, h, s, s, d,
                                             torch.bfloat16, "cuda",
                                             chip_smoke.SEED)
        o, lse = fa.flash_fwd(q, k, v, True, scale)
        delta = (do.float() * o.float()).sum(-1)
        ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
               lse.data_ptr(), delta.data_ptr())
        outs = {name: [torch.empty_like(x) for x in (k, v, q)]
                for name in libs}

        def call(name, which):
            stream = torch.cuda.current_stream().cuda_stream
            dk, dv, dq = outs[name]
            entry = libs[name]["hvd_flash_bwd_" + which]
            err = (entry(*ins, dk.data_ptr(), dv.data_ptr(), b, h, s, s, d,
                         code, 1, scale, stream) if which == "dkv" else
                   entry(*ins, dq.data_ptr(), b, h, s, s, d, code, 1, scale,
                         stream))
            if err:
                raise SystemExit("%s %s failed (%d)" % (name, which, err))

        line = []
        for which in ("dkv", "dq"):
            times = {name: [] for name in libs}
            for _ in range(2):  # two passes over every variant, in turns
                for name in libs:
                    times[name].append(chip_smoke.median_ms(
                        torch, lambda: call(name, which), 10, 3))
            torch.cuda.synchronize()
            notes = {}
            for name in libs:
                got = outs[name][:2] if which == "dkv" else outs[name][2:]
                want = outs["kernel"][:2] if which == "dkv" else \
                    outs["kernel"][2:]
                if not all(torch.equal(x, y) for x, y in zip(got, want)):
                    notes[name] = " (differs: %.3g of the limit)" % max(
                        chip_smoke.limit_ratio(x, y, *chip_smoke.TOLS[
                            "bfloat16"]) for x, y in zip(got, want))
            line.append("%s: %s" % (which, "; ".join(
                "%s %s ms%s" % (name, " ".join("%.4f" % t for t in ts),
                                notes.get(name, ""))
                for name, ts in times.items())))
        print("%s B=%d H=%d S=%d D=%d bf16 causal: %s"
              % (label, b, h, s, d, " | ".join(line)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
