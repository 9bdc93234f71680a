"""The port's kernel build (``horovod_tpu_torch/ops/_build.py``): a library
is keyed by a hash of every file under ``csrc/``, so an edited source or
header never loads a stale library, and its ptxas report is kept beside it.
Needs no nvcc.
"""

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
