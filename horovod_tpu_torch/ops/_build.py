"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled at first use with ``nvcc`` into a
shared library with a plain C interface, which is loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds, not minutes). Libraries go
to ``csrc/build/`` (listed in ``.gitignore``), keyed by a hash of the
files under ``csrc/``, so an edited source or header is rebuilt and a
stale library is never loaded. The compiler's report (ptxas registers,
shared memory, spills) is kept beside each library as ``<lib>.log`` and
read back when a built library is reused, so every run can print it.
Nothing here runs at import time: the CPU tests import every module of
the port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_D = ctypes.c_double

# C signatures of every entry point, by library.
SIGNATURES: Dict[str, Dict[str, Tuple[list, type]]] = {
    "flash_attention": {
        "hvd_cuda_error_string": ([_I], ctypes.c_char_p),
        # q, k, v, o, lse, B, H, Sq, Skv, D, dtype, causal, scale, stream
        "hvd_flash_fwd": ([_P] * 5 + [_I] * 7 + [_F, _P], _I),
        # q, k, v, do, lse, delta, dk, dv, B, H, Sq, Skv, D, dtype,
        # causal, scale, stream
        "hvd_flash_bwd_dkv": ([_P] * 8 + [_I] * 7 + [_F, _P], _I),
        # q, k, v, do, lse, delta, dq, B, H, Sq, Skv, D, dtype, causal,
        # scale, stream
        "hvd_flash_bwd_dq": ([_P] * 7 + [_I] * 7 + [_F, _P], _I),
    },
    "adasum": {
        "hvd_cuda_error_string": ([_I], ctypes.c_char_p),
        # mine, theirs, table, n_segments, n_chunks, partials, dots, stream
        "hvd_adasum_dots": ([_P, _P, _P, _I, _L, _P, _P, _P], _I),
        # mine, theirs, table, n_segments, n_chunks, dots, stream
        "hvd_adasum_combine": ([_P, _P, _P, _I, _L, _P, _P], _I),
        # src, dst, n, dtype, to_double, stream
        "hvd_adasum_convert": ([_P, _P, _L, _I, _I, _P], _I),
    },
    "fusion": {
        "hvd_cuda_error_string": ([_I], ctypes.c_char_p),
        # table, n_segments, buf, total, dtype, factor, stream
        "hvd_fusion_pack": ([_P, _I, _P, _L, _I, _D, _P], _I),
        "hvd_fusion_unpack": ([_P, _I, _P, _L, _I, _D, _P], _I),
    },
    "codec": {
        "hvd_cuda_error_string": ([_I], ctypes.c_char_p),
        # codec, src, count, wire, scratch, counter, stream
        "hvd_codec_encode": ([_I, _P, _L, _P, _P, _P, _P], _I),
        # codec, wire, count, dst, op, stream
        "hvd_codec_decode_reduce": ([_I, _P, _L, _P, _I, _P], _I),
        # table, n_segments, n_chunks, scratch, stream
        "hvd_codec_error_feedback": ([_P, _I, _L, _P, _P], _I),
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each library loaded,
# from its build or, for a library built earlier, from its ``.log``.
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in %s and on PATH): the CUDA kernels "
            "of horovod_tpu_torch are built at first use on a machine "
            "with the CUDA toolkit" % cand)
    return found


def nvcc_command(src: Path, out: Path) -> List[str]:
    return [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out),
            str(src)]


def library_path(name: str) -> Path:
    """The library's path, keyed by a hash of every file directly under
    ``csrc/`` (the source and any header it includes)."""
    digest = hashlib.sha256(name.encode())
    for src in sorted(p for p in CSRC.iterdir() if p.is_file()):
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / ("lib%s_%s.so" % (name, digest.hexdigest()[:16]))


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    log = out.with_suffix(".log")
    if out.exists():
        if log.exists():
            build_logs[name] = log.read_text()
        return out
    tmp = out.with_suffix(".so.tmp%d" % os.getpid())
    cmd = nvcc_command(CSRC / (name + ".cu"), tmp)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on %s.cu:\n%s%s"
                           % (name, proc.stdout, proc.stderr))
    build_logs[name] = proc.stdout + proc.stderr
    log.write_text(build_logs[name])  # before the library appears
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` with every entry point's signature set."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _loaded[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by an entry point."""
    if err != 0:
        msg = lib.hvd_cuda_error_string(err).decode(errors="replace")
        raise RuntimeError("%s failed: CUDA error %d (%s)" % (what, err, msg))
