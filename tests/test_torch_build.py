"""The kernel build cache (``kernels/_build.py``) on the CPU: a library's
path is keyed by its source, every local header that source includes, and
the nvcc flags, so editing any of them rebuilds.  Nothing is compiled."""
from repro_torch.kernels import _build


def _csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include <stdint.h>\n#include "a.cuh"\n'
                               "int k() { return A; }\n")
    (csrc / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n'
                                "#define A B\n")
    (csrc / "b.cuh").write_text("#define B 1\n")
    (csrc / "other.cuh").write_text("#define C 2\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    return csrc


def test_sources_follow_local_includes(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    assert _build.sources("k") == [csrc / "k.cu", csrc / "a.cuh",
                                   csrc / "b.cuh"]


def test_library_path_changes_with_an_included_header(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    first = _build.library_path("k")
    assert _build.library_path("k") == first            # stable
    (csrc / "other.cuh").write_text("#define C 3\n")     # not included
    assert _build.library_path("k") == first
    (csrc / "b.cuh").write_text("#define B 2\n")         # included twice over
    second = _build.library_path("k")
    assert second != first and second.name.startswith("libk-")
    (csrc / "k.cu").write_text((csrc / "k.cu").read_text() + "\n")
    assert _build.library_path("k") not in (first, second)


def test_shipped_sources_hash_their_shared_header():
    for name in ("pull_spmv", "flash_attention"):
        assert _build.CSRC / "hopper.cuh" in _build.sources(name)
