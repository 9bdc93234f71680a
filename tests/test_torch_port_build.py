"""The port's kernel build (``horovod_tpu_torch/ops/_build.py``): a library
is keyed by a hash of every file under ``csrc/``, so an edited source or
header never loads a stale library. Needs no nvcc.
"""

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
