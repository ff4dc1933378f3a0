"""The kernel build's cache key (``ops/runtime.library_path``): a library
is named by a hash of its source, every ``csrc/*.cuh`` header and the nvcc
flags, so that editing a header a source includes rebuilds the library.
Nothing is compiled here (the CPU host has no ``nvcc``)."""
from tnn_tpu_torch.ops import runtime


def _csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "kern.cu").write_text('#include "tiles.cuh"\n')
    (csrc / "tiles.cuh").write_text("// tiles, first version\n")
    monkeypatch.setattr(runtime, "CSRC", csrc)
    monkeypatch.setenv("TNN_TORCH_BUILD_DIR", str(tmp_path / "build"))
    return csrc


def test_library_path_changes_with_a_header(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    first = runtime.library_path("kern")
    assert runtime.library_path("kern") == first      # stable
    assert first.parent == tmp_path / "build"
    (csrc / "tiles.cuh").write_text("// tiles, second version\n")
    second = runtime.library_path("kern")
    assert second != first
    (csrc / "more.cuh").write_text("")                 # a new header
    assert runtime.library_path("kern") not in (first, second)


def test_library_path_changes_with_the_source_and_flags(tmp_path,
                                                        monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    first = runtime.library_path("kern")
    (csrc / "kern.cu").write_text('#include "tiles.cuh"\n// edited\n')
    second = runtime.library_path("kern")
    assert second != first
    monkeypatch.setattr(runtime, "NVCC_FLAGS", [*runtime.NVCC_FLAGS, "-G"])
    assert runtime.library_path("kern") not in (first, second)
