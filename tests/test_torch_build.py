"""ops/build.py names each kernel library by a hash of what it is built
from, so an edited source or shared header is rebuilt. CPU only: nothing
is compiled here."""

import shutil

import pytest

from graph_detr4d_tpu_torch.ops import build


def _paths():
    return {name: build.library_path(name) for name in build.SOURCES}


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of csrc/ under tmp_path that build.py reads in its place."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    original = _paths()
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    return csrc, original


def test_editing_a_header_changes_the_library_path(csrc_copy):
    csrc, original = csrc_copy
    before = _paths()
    assert before == original  # the path depends on content only
    header = csrc / "dcn_forward.cuh"
    header.write_text(header.read_text() + "\n// an edit\n")
    after = _paths()
    # both DCN sources include the header: both are rebuilt
    for name in ("deform_conv", "deform_conv_int8"):
        assert after[name] != before[name]
        assert after[name].parent == build.BUILD_DIR


def test_editing_a_source_changes_only_its_library_path(csrc_copy):
    csrc, _ = csrc_copy
    before = _paths()
    src = csrc / "msda.cu"
    src.write_text(src.read_text() + "\n// an edit\n")
    after = _paths()
    assert after["msda"] != before["msda"]
    assert {n: p for n, p in after.items() if n != "msda"} == {
        n: p for n, p in before.items() if n != "msda"}
