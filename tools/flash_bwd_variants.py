"""Diagnostics of the Hopper backward: variants built from text edits.

Builds copies of this checkout's ``horovod_tpu_torch/csrc/``, each with one
change to ``hopper_bwd.cuh`` or to a library's source, and times their
``hvd_flash_bwd_dkv`` and ``hvd_flash_bwd_dq`` in turns with the unchanged
kernels (bf16, causal; each the median of 3 rounds of 10, CUDA events, two
passes over every variant).

The wide library (``flash_attention_wide.cu``), at the four catalog shapes
of ``chip_smoke.WIDE_SHAPES``:

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
- ``rows_stages2`` and ``rows_stages4``: ``dq_rows_wgmma_kernel`` (dQ at
  D = 192 and 256) with two stages of a larger key tile, or four of a
  smaller one, in place of three.

With ``--narrow``, the library of head dims 16-128 (``flash_attention.cu``)
at the slice's attention (``chip_smoke.SLICE_SHAPE``) and at head dim 128
(``chip_smoke.D128_SHAPE``):

- ``split_dkv``: dK/dV at D = 64 and 128 on ``wide_dkv_wgmma_kernel`` (64
  keys a block, the score products split between the warpgroups, P^T
  crossing through shared memory, A operands from shared tiles) in place
  of ``dkv_rows_wgmma_kernel`` (128 keys, each warpgroup 64 of them end to
  end, A operands in registers);
- ``dkv_no_exp``: ``dkv_rows_wgmma_kernel`` with P^T from one FMA and no
  ex2 (a wrong result): what the exponentials take;
- ``dkv_no_turns``: ``dkv_rows_wgmma_kernel`` with its turns removed (the
  two consumer warpgroups issue when ready);
- ``dkv_no_dscores`` and ``dq_no_dscores``: the kernel without forming P
  and dS from the scores (a wrong result): what its elementwise work takes;
- ``dq_no_scores``: ``dq_rows_wgmma_kernel`` issuing S and dP for the first
  key tile only (a wrong result): what its score products take;
- ``dkv_rows128``: ``dkv_rows_wgmma_kernel`` on 128-row query tiles at
  D <= 64;
- ``dkv_stages2`` and ``dkv_stages4``: its Q/dO ring in two or four stages;
- ``dq_keys64``: ``dq_rows_wgmma_kernel`` on 64-key tiles at D <= 64;
- ``dq_stages2`` and ``dq_stages4``: its K/V ring in two or four stages.

Every edit asserts that its text is in the source, so a tool that no longer
matches the kernels stops instead of timing the wrong thing. A variant's
results are compared with the unchanged kernels' bit for bit; one that
differs prints its largest error as a fraction of ``chip_smoke.TOLS``.

Run from the repo root on a machine with a card::

    python3 -m tools.flash_bwd_variants [--narrow]

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

BWD = "hopper_bwd.cuh"
COMMON = "hopper_common.cuh"
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
DQ_STAGES = "constexpr int DQ_STAGES = 3;"
DKV_STAGES = "constexpr int DKV_STAGES = 3;"
DKV_ROWS = "  static constexpr int BM = DKV_ROWS;"
DQ_KEYS = "  if (D <= 128) return D <= 64 ? 128 : 64;"
DKV_EXP = ("        float p = ex2(fmaf(s[4 * i + e], sl2, (e & 1) ? nl.y : "
           "nl.x));")
DKV_KERNEL = ("    dkv_rows_wgmma_kernel(", "cudaError_t launch_dkv_rows(")
DQ_KERNEL = ("    dq_rows_wgmma_kernel(", "cudaError_t launch_dq_rows(")
DQ_SCORES = """    issue_qk<D, T, HN>(s, q_desc, k_desc + st * KV_STEP);
    issue_qk<D, T, HN>(dp, do_desc, v_desc + st * KV_STEP);
"""


def _edit_within(src: str, span, old: str, new: str) -> str:
    """``src`` with every ``old`` between the markers of ``span`` (each
    once in ``src``) replaced by ``new``; there must be one at least."""
    a, b = (src.index(m) for m in span)
    if src.count(span[0]) != 1 or src.count(span[1]) != 1 or \
            old not in src[a:b]:
        raise SystemExit("flash_bwd_variants: %r is not in the span" % old)
    return src[:a] + src[a:b].replace(old, new) + src[b:]
ROWS_DKV = """    return launch_dkv_rows<D, T>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq,
                                 Skv, causal, scale, st);"""
SPLIT_DKV = """    if constexpr (D >= 64)
      return launch_wide_dkv_wgmma<D, T>(q, k, v, dout, lse, delta, dk, dv,
                                         B, H, Sq, Skv, causal, scale, st);
    else
""" + ROWS_DKV
# What the split layout needs below D = 192, which no shipped route
# instantiates: its head-dim assert relaxed, and the output products'
# wgmma at N = 64 (dV and dK of 64 columns).
WIDE_DKV_DIMS = ('static_assert(D % 64 == 0 && D >= 192 && D <= 576, '
                 '"a wide head dim");')
SST128 = ('HVD_WGMMA_SST(128, bf16, "bf16", 64, 65, 66)\n',
          'HVD_WGMMA_SST(128, f16, "f16", 64, 65, 66)\n')


def _split_dkv(src):
    """The ``split_dkv`` variant's edits of the three files it changes."""
    common = src[COMMON]
    for line in SST128:
        common = _edit(common, line, line.replace("128", "64").replace(
            "64, 65, 66", "32, 33, 34") + line)
    return {"flash_attention.cu": _edit(src["flash_attention.cu"], ROWS_DKV,
                                        SPLIT_DKV),
            BWD: _edit(src[BWD], WIDE_DKV_DIMS,
                       WIDE_DKV_DIMS.replace("192", "64")),
            COMMON: common}


def _edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit("flash_bwd_variants: %r is not once in the source"
                         % old[:60])
    return src.replace(old, new)


def variants(src, narrow=False):
    """{name: {file: its edited text}} over ``src``, {file: text} of the
    csrc files that the variants edit."""
    if narrow:
        return {
            "kernel": {},
            "split_dkv": _split_dkv(src),
            "dkv_no_exp": {BWD: _edit(src[BWD], DKV_EXP, DKV_EXP.replace(
                "ex2(", "("))},
            "dkv_no_turns": {BWD: _edit_within(
                _edit_within(src[BWD], DKV_KERNEL, "turn_wait(wg);", ";"),
                DKV_KERNEL, "turn_pass(wg);", ";")},
            "dkv_no_dscores": {BWD: _edit_within(src[BWD], DKV_KERNEL,
                                                 "dscores(", "(void)(")},
            "dq_no_dscores": {BWD: _edit_within(src[BWD], DQ_KERNEL,
                                                "dscores(", "(void)(")},
            "dq_no_scores": {BWD: _edit(src[BWD], DQ_SCORES, "")},
            "dkv_rows128": {BWD: _edit(src[BWD], DKV_ROWS, DKV_ROWS.replace(
                "DKV_ROWS", "D <= 64 ? 128 : DKV_ROWS"))},
            "dkv_stages2": {BWD: _edit(src[BWD], DKV_STAGES,
                                       DKV_STAGES.replace("3", "2"))},
            "dkv_stages4": {BWD: _edit(src[BWD], DKV_STAGES,
                                       DKV_STAGES.replace("3", "4"))},
            "dq_keys64": {BWD: _edit(src[BWD], DQ_KEYS, DQ_KEYS.replace(
                "D <= 64 ? 128 : 64", "64"))},
            "dq_stages2": {BWD: _edit(src[BWD], DQ_STAGES,
                                      DQ_STAGES.replace("3", "2"))},
            "dq_stages4": {BWD: _edit(src[BWD], DQ_STAGES,
                                      DQ_STAGES.replace("3", "4"))},
        }
    return {
        "kernel": {},
        "rows_loaded": {BWD: _edit(src[BWD], ROWS_STAGED, ROWS_LOADED)},
        "rows_const": {BWD: _edit(src[BWD], ROWS_STAGED, ROWS_CONST)},
        "no_scores": {BWD: _edit(src[BWD], SCORES, "")},
        "stages2": {BWD: _edit(src[BWD], TILE_RULE, TWO_STAGES)},
        "stages3": {BWD: _edit(src[BWD], TILE_RULE, THREE_FIRST)},
        "rows_stages2": {BWD: _edit(src[BWD], DQ_STAGES,
                                    DQ_STAGES.replace("3", "2"))},
        "rows_stages4": {BWD: _edit(src[BWD], DQ_STAGES,
                                    DQ_STAGES.replace("3", "4"))},
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
    narrow = "--narrow" in sys.argv
    csrc = _build.CSRC
    library = "flash_attention" if narrow else "flash_attention_wide"
    files = {p.name: p.read_text() for p in csrc.iterdir() if p.is_file()}
    sources = variants(files, narrow)

    def build(name):
        # Each variant in its own directory: the csrc files, edited.
        tmp = Path(tempfile.mkdtemp(prefix="hvd_bwd_%s_" % name))
        for fname, text in {**files, **sources[name]}.items():
            (tmp / fname).write_text(text)
        out = tmp / ("lib%s.so" % name)
        proc = subprocess.run(_build.nvcc_command(tmp / (library + ".cu"),
                                                  out),
                              capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit("%s does not build:\n%s%s"
                             % (name, proc.stdout, proc.stderr))
        return name, out, proc.stdout + proc.stderr

    libs = {}
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        for name, out, log in pool.map(build, sources):
            spills = sorted(set(re.findall(
                r"Function properties for \w*d(?:kv|q)_(?:rows_)?wgmma_kernel"
                r"\w*\n"
                r"\s*\d+ bytes stack frame, (\d+) bytes spill stores", log)))
            print("ptxas %s: backward wgmma kernels' spill stores %s "
                  "bytes; %s" % (name, "/".join(spills) or "?",
                                 "wgmma serialized"
                                 if chip_smoke.SERIALIZED.search(log)
                                 else "no wgmma serialized"))
            # The two entry points, with the signatures the port declares.
            lib = ctypes.CDLL(str(out))
            libs[name] = {}
            for fn in ("hvd_flash_bwd_dkv", "hvd_flash_bwd_dq"):
                entry = getattr(lib, fn)
                entry.argtypes, entry.restype = _build.SIGNATURES[library][fn]
                libs[name][fn] = entry
    code = fa._DTYPE_CODES[torch.bfloat16]
    shapes = ((("slice", chip_smoke.SLICE_SHAPE),
               ("head dim 128", chip_smoke.D128_SHAPE)) if narrow
              else chip_smoke.WIDE_SHAPES)
    for label, (b, h, s, d) in shapes:
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
