"""Does ptxas compile a consumer branch to the register count that
``setmaxnreg.inc`` asks for?

Compiles (nvcc ``-Xptxas -v``, ``sm_90a``, no launch) one kernel that keeps
``LIVE`` fp32 values live a thread in its consumer branch, in four
layouts:

- ``setmaxnreg``: 384 threads (``__launch_bounds__(384, 1)``, so 168
  registers at entry), warpgroup 2 gives registers up
  (``setmaxnreg.dec`` 24) and warpgroups 0-1 ask for 240
  (``setmaxnreg.inc``), as the flash forwards do;
- ``trap_before``: the same, with a ``__trap()`` in the consumer branch
  before its loop (behind a test that never holds);
- ``trap_in_loop``: the same, with the ``__trap()`` inside the loop;
- ``wait_trap``: the same, with a wait inside the loop that traps when it
  spins too long, as ``mbar_wait`` does;
- ``wait_record``: the same, with a wait that instead records that it gave
  up in a device word and a host word and returns, as
  ``mbar_wait_bounded`` does;
- ``plain384``: the same 384 threads with no ``setmaxnreg``;
- ``warp288``: 288 threads (two warpgroups and one producer warp), no
  ``setmaxnreg``.

A layout that compiles without the spills of ``plain384`` gets more than
the entry cap; one that spills as ``plain384`` does is held to it.

Run from the repo root on a machine with the CUDA toolkit::

    python3 -m tools.setmaxnreg_probe

Prints one line per layout: registers and spill bytes as ptxas reports.
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

LIVE = 200

SOURCE = r"""
__device__ unsigned g_gave_up;
__device__ unsigned* g_host_word;

template <int THREADS, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    probe(const float* __restrict__ in, float* __restrict__ out, int n) {
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    if (MODE != 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    return;
  }
  if (MODE != 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  if (MODE == 2 && n < 0) __trap();
  float acc[LIVE];
#pragma unroll
  for (int i = 0; i < LIVE; ++i) acc[i] = in[threadIdx.x + i * THREADS];
  for (int k = 0; k < n; ++k) {
    const float x = in[k];
    if (MODE == 3 && x == -1.f) __trap();
    if (MODE == 4)
      for (int w = 0; in[w] < 0.f; ++w)
        if (w == 1000000) __trap();
    if (MODE == 5 && !*(volatile unsigned*)&g_gave_up)
      for (int w = 0; in[w] < 0.f; ++w)
        if (w == 1000000) {
          *(volatile unsigned*)&g_gave_up = 1;
          if (g_host_word) *(volatile unsigned*)g_host_word = 1;
          __threadfence_system();
          break;
        }
#pragma unroll
    for (int i = 0; i < LIVE; ++i)
      acc[i] = fmaf(acc[i], x, acc[(i + 1) % LIVE]);
  }
#pragma unroll
  for (int i = 0; i < LIVE; ++i) out[threadIdx.x + i * THREADS] = acc[i];
}

template __global__ void probe<384, 0>(const float*, float*, int);
template __global__ void probe<384, 2>(const float*, float*, int);
template __global__ void probe<384, 3>(const float*, float*, int);
template __global__ void probe<384, 4>(const float*, float*, int);
template __global__ void probe<384, 5>(const float*, float*, int);
template __global__ void probe<384, 1>(const float*, float*, int);
template __global__ void probe<288, 1>(const float*, float*, int);
"""

LAYOUTS = {"probeILi384ELi0E": "setmaxnreg",
           "probeILi384ELi2E": "trap_before",
           "probeILi384ELi3E": "trap_in_loop",
           "probeILi384ELi4E": "wait_trap",
           "probeILi384ELi5E": "wait_record",
           "probeILi384ELi1E": "plain384", "probeILi288ELi1E": "warp288"}


def main() -> int:
    from horovod_tpu_torch.ops import _build

    tmp = Path(tempfile.mkdtemp(prefix="hvd_setmaxnreg_"))
    src = tmp / "probe.cu"
    src.write_text("#define LIVE %d\n" % LIVE + SOURCE)
    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
           "-Xptxas", "-v", "-cubin", "-o", str(tmp / "probe.cubin"),
           str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode:
        print(log, file=sys.stderr)
        return 1
    for entry, label in LAYOUTS.items():
        m = re.search(r"Compiling entry function '\w*%s\w*'.*?"
                      r"(\d+) bytes spill stores.*?Used (\d+) registers"
                      % entry, log, re.S)
        print("setmaxnreg probe %s (%d live fp32 a thread): %s registers, "
              "%s bytes spilled"
              % (label, LIVE, m.group(2) if m else "?",
                 m.group(1) if m else "?"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
