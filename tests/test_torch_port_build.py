"""The port's kernel build (``horovod_tpu_torch/ops/_build.py``): a library
is keyed by a hash of every file under ``csrc/``, so an edited source or
header never loads a stale library, and its ptxas report is kept beside it;
and every entry point's ctypes signature (``SIGNATURES``) is the one its
source declares. Needs no nvcc.
"""

import ctypes
import re
import sys

import pytest

from horovod_tpu_torch.ops import _build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that ``_build`` reads instead of the real one."""
    for src in _build.CSRC.iterdir():
        if src.is_file():
            (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def test_an_edited_source_changes_the_library_path(csrc_copy):
    src = csrc_copy / "flash_attention.cu"
    before = _build.library_path("flash_attention")
    src.write_bytes(src.read_bytes() + b"// edited\n")
    after = _build.library_path("flash_attention")
    assert before != after
    assert before.parent == after.parent == csrc_copy / "build"


def test_an_edited_header_changes_the_library_path(csrc_copy):
    header = csrc_copy / "tiles.cuh"
    header.write_text("#pragma once\n")
    before = _build.library_path("flash_attention")
    header.write_text("#pragma once\n// edited\n")
    assert _build.library_path("flash_attention") != before
    header.unlink()
    assert _build.library_path("flash_attention") != before


def test_built_libraries_do_not_change_the_key(csrc_copy):
    before = _build.library_path("flash_attention")
    (csrc_copy / "build").mkdir()
    (csrc_copy / "build" / before.name).write_bytes(b"\0")
    assert _build.library_path("flash_attention") == before


# The ctypes type of each C parameter or return type the sources use.
C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
           "float": ctypes.c_float, "double": ctypes.c_double,
           "const char*": ctypes.c_char_p}


def _declared(lib):
    """{name: ([ctypes of each parameter], ctypes of the result)} of every
    ``extern "C"`` function defined in ``csrc/<lib>.cu``."""
    src = (_build.CSRC / (lib + ".cu")).read_text()
    body = src[src.index('extern "C" {'):]
    out = {}
    for ret, name, params in re.findall(
            r"^(int|long long|const char\*)\s+(hvd_\w+)\(([^)]*)\)\s*\{",
            body, flags=re.M):
        types = []
        for param in " ".join(params.split()).split(","):
            decl = param.strip().rsplit(" ", 1)[0]
            types.append(ctypes.c_void_p if "*" in param and
                         decl != "const char*" else C_TYPES[decl])
        out[name] = (types, C_TYPES[ret])
    return out


@pytest.mark.parametrize("lib", sorted(_build.SIGNATURES))
def test_signatures_are_the_sources_declarations(lib):
    """Each library's ctypes signatures, argument by argument, against its
    source: a pointer is c_void_p, an int c_int, a long long c_longlong."""
    assert _declared(lib) == _build.SIGNATURES[lib]


PTXAS = "ptxas info    : Used 42 registers, 0 bytes spill stores\n"


def test_a_cached_library_reports_its_build_log(csrc_copy, monkeypatch):
    """A library built by an earlier run still yields its ptxas report."""
    monkeypatch.setattr(_build, "build_logs", {})
    lib = _build.library_path("flash_attention")
    lib.parent.mkdir()
    lib.write_bytes(b"\0")
    lib.with_suffix(".log").write_text(PTXAS)
    assert _build.build("flash_attention") == lib
    assert _build.build_logs["flash_attention"] == PTXAS


def test_a_build_writes_its_log_beside_the_library(csrc_copy, monkeypatch):
    """A stand-in compiler writes the library and prints the report; the
    report is kept, written beside the library, and read back on reuse."""
    fake = ("import sys; open(sys.argv[1], 'wb').write(b'\\0'); "
            "sys.stdout.write(%r)" % PTXAS)
    monkeypatch.setattr(_build, "nvcc_command",
                        lambda src, out: [sys.executable, "-c", fake,
                                          str(out)])
    monkeypatch.setattr(_build, "build_logs", {})
    lib = _build.build("flash_attention")
    assert lib == _build.library_path("flash_attention") and lib.exists()
    assert _build.build_logs["flash_attention"] == PTXAS
    assert lib.with_suffix(".log").read_text() == PTXAS
    _build.build_logs.clear()
    assert _build.build("flash_attention") == lib
    assert _build.build_logs["flash_attention"] == PTXAS


def test_core_copy_differs_from_the_reference_only_by_the_hook():
    """``horovod_tpu_torch/core/src`` is ``horovod_tpu/core/src`` plus the
    device plane's files, the hook in PerformOperation, the
    ``hvd_core_running`` query that the failure watch polls
    (``common/failure.py``), the library's name, and the fix of a
    broadcast whose root is outside its set (ROADMAP C8: the coordinator
    answers it with an error response, and ``ExecuteBroadcast`` completes
    the entry with its error); two comments of comm.cc drop a note of the
    reference's history (an issue number)."""
    import difflib
    import re
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    ref = root / "horovod_tpu" / "core" / "src"
    port = root / "horovod_tpu_torch" / "core" / "src"
    names = sorted(p.name for p in ref.iterdir() if p.is_file())
    assert sorted(p.name for p in port.iterdir() if p.is_file()) == sorted(
        names + ["device_plane.cc", "device_plane.h"])
    changed = {}
    for name in names:
        a = (ref / name).read_text().splitlines()
        b = (port / name).read_text().splitlines()
        diff = [line for line in difflib.ndiff(a, b)
                if line[:2] in ("- ", "+ ")]
        if diff:
            changed[name] = (sorted(x[2:] for x in diff if x[0] == "-"),
                             sorted(x[2:] for x in diff if x[0] == "+"))
    assert sorted(changed) == ["Makefile", "comm.cc", "controller.cc",
                               "operations.cc"]
    assert changed["controller.cc"] == ([], sorted([
        "  // A root outside the set is every member's error at "
        "negotiation: no",
        "  // member could send or receive, and the error response "
        "completes each",
        "  // entry (ExecuteError) where an executed broadcast would hang "
        "them.",
        "  if (first.op_type == OpType::BROADCAST &&",
        "      ps.member_index(first.root_rank) < 0)",
        '    return error("Broadcast root rank " + '
        "std::to_string(first.root_rank) +",
        '                 " is not a member of process set " + '
        "std::to_string(ps.id) +",
        '                 " for tensor " + name);']))
    removed, added = changed["comm.cc"]
    assert len(removed) == 2 and all(line.lstrip().startswith("//")
                                     for line in removed)
    assert sorted(re.sub(r" \(\w+ \d+ \w+\)", "", line)
                  for line in removed) == added
    assert changed["operations.cc"] == (
        sorted(["  switch (resp.op_type) {",
                "  if (root_idx < 0)",
                '    return Status::InvalidArgument("broadcast root not in '
                'process set");']),
        sorted(['#include "device_plane.h"',
                "  if (root_idx < 0) {",
                "    // The coordinator rejects such a root at negotiation; "
                "should one get",
                "    // here, the entry still completes with the error "
                "instead of hanging.",
                '    Status bad = Status::InvalidArgument("broadcast root '
                'not in process set");',
                "    if (present && e.callback) e.callback(bad, nullptr, 0, "
                "nullptr, 0);",
                "    return bad;",
                "  }",
                "  if (DevicePlaneOwns(resp)) {  // card tensors: never "
                "the TCP ring",
                "    st = DevicePlaneExecute(ps, resp, "
                "g->controller->wire_codec(),",
                "                            g->controller->hierarchical());",
                "  } else switch (resp.op_type) {",
                "// 1 while the background loop coordinates; 0 before init, "
                "after",
                "// shutdown, and once the loop stopped on its own: a peer "
                "closed during an",
                "// idle cycle, or a failure cascaded. The Python side's "
                "failure watch",
                "// polls it to abort the process groups that a dead peer "
                "would hang.",
                "int hvd_core_running() {",
                "  return g && !g->shut_down.load() && !g->failed.load() ? 1 "
                ": 0;",
                "}",
                ""]))
    removed, added = changed["Makefile"]
    assert removed == sorted([
        "TARGET := $(BUILDDIR)/libhvdcore.so",
        "        $(BUILDDIR)/perf.o $(BUILDDIR)/flightrec.o "
        "$(BUILDDIR)/operations.o",
        "$(BUILDDIR)/%.o: %.cc common.h comm.h codec.h collectives.h "
        "controller.h perf.h flightrec.h | $(BUILDDIR)",
        "        flightrec.cc operations.cc"])
    assert added == sorted([
        "TARGET := $(BUILDDIR)/libhvdcore_torch.so",
        "        $(BUILDDIR)/perf.o $(BUILDDIR)/flightrec.o "
        "$(BUILDDIR)/operations.o \\",
        "        $(BUILDDIR)/device_plane.o",
        "$(BUILDDIR)/%.o: %.cc common.h comm.h codec.h collectives.h "
        "controller.h perf.h flightrec.h device_plane.h | $(BUILDDIR)",
        "        flightrec.cc operations.cc device_plane.cc"])
