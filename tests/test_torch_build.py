"""The build helper names each library by what it is built from, so an
edited source or header is rebuilt and nothing else is.  No nvcc needed:
these tests only compute library paths, over a copy of ``csrc/``."""

import pathlib
import shutil

import pytest

from ray_tpu_torch.ops import _build

SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "splash_attention.cu")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that the build helper reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, copy)
    monkeypatch.setattr(_build, "CSRC_DIR", str(copy))
    return copy


def test_the_shared_header_exists_and_the_wgmma_sources_include_it():
    csrc = pathlib.Path(_build.CSRC_DIR)
    assert (csrc / "hopper.cuh").is_file()
    for source in SOURCES:
        assert '#include "hopper.cuh"' in (csrc / source).read_text()


@pytest.mark.parametrize("source", SOURCES)
def test_path_is_stable_for_unchanged_files(csrc, source):
    assert _build.library_path(source) == _build.library_path(source)
    assert _build.library_path(source).startswith(_build.BUILD_DIR)


@pytest.mark.parametrize("source", SOURCES)
def test_a_header_edit_changes_every_library_path(csrc, source):
    before = _build.library_path(source)
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path(source) != before


def test_a_source_edit_changes_only_its_own_path(csrc):
    before = {s: _build.library_path(s) for s in SOURCES}
    src = csrc / "flash_fwd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = {s: _build.library_path(s) for s in SOURCES}
    assert after["flash_fwd.cu"] != before["flash_fwd.cu"]
    assert {s: after[s] for s in SOURCES[1:]} == \
        {s: before[s] for s in SOURCES[1:]}


def test_a_new_header_changes_the_path(csrc):
    before = _build.library_path("splash_attention.cu")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path("splash_attention.cu") != before


def test_build_count_counts_nvcc_builds_only(csrc, tmp_path, monkeypatch):
    """A fake nvcc that writes its ``-o`` file: the first ``build_all``
    builds once, the second finds the library and builds nothing."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then : > "$2"; fi; shift\n'
                    'done\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(nvcc.parent.parent))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    before = _build.build_count()
    assert _build.build_all(["flash_fwd.cu"])["flash_fwd.cu"]["nvcc_s"] > 0
    assert _build.build_count() == before + 1
    assert _build.build_all(["flash_fwd.cu"])["flash_fwd.cu"]["nvcc_s"] == 0
    assert _build.build_count() == before + 1
