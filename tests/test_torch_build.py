"""The port's kernel build cache, on the CPU (nothing is compiled here).

``repro_torch.kernels._build`` names each library by a hash of its source,
every header under ``csrc/`` and the compiler flags, so an edited header
(``common.cuh`` or the attention tile ``attn_tile.cuh``) can never be
served from a library built before the edit.
"""
import shutil

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    return csrc


@pytest.mark.parametrize("header", ["common.cuh", "attn_tile.cuh", "new_header.cuh"])
def test_library_path_follows_every_header(csrc_copy, header):
    before = {n: _build._lib_path(n) for n in _build.SOURCES}
    assert len(set(before.values())) == len(before)
    path = csrc_copy / header
    path.write_text((path.read_text() if path.exists() else "") + "\n// edited\n")
    after = {n: _build._lib_path(n) for n in _build.SOURCES}
    assert all(after[n] != before[n] for n in _build.SOURCES)
    assert all(after[n].parent == before[n].parent for n in _build.SOURCES)


def test_library_path_follows_its_own_source_only(csrc_copy):
    before = {n: _build._lib_path(n) for n in _build.SOURCES}
    src = csrc_copy / _build.SOURCES["paged_attention"]
    src.write_text(src.read_text() + "\n// edited\n")
    after = {n: _build._lib_path(n) for n in _build.SOURCES}
    assert {n for n in _build.SOURCES if after[n] != before[n]} == {"paged_attention"}
