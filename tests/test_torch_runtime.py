"""The kernel build's cache key (``ops/runtime.library_path``): a library
is named by a hash of its source, every ``csrc/*.cuh`` header and the nvcc
flags, so that editing a header a source includes rebuilds the library.
Nothing is compiled here (the CPU host has no ``nvcc``). Also the launch
counts under threads (``count_launch``) and the build directory that
``serving.compile_cache`` sets."""
import sys
import threading

from tnn_tpu_torch.ops import runtime
from tnn_tpu_torch.serving import compile_cache


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


def test_launch_counts_lose_no_update_under_threads():
    """More threads than cores bump one counter with a tiny switch
    interval: the total is exact and each thread's tally is its own."""
    def fn():
        pass

    fn.launches = 0
    tallies = {}

    def work(i):
        before = runtime.thread_launches()[(id(fn), "launches")]
        for _ in range(2000):
            runtime.count_launch(fn)
        tallies[i] = runtime.thread_launches()[(id(fn), "launches")] - before

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert fn.launches == 16 * 2000
    assert tallies == {i: 2000 for i in range(16)}


def test_compile_cache_sets_the_build_directory(tmp_path):
    try:
        cache = compile_cache.enable(str(tmp_path / "kernels"))
        assert runtime.build_dir() == tmp_path / "kernels"
        assert compile_cache.active_dir() == cache
        assert runtime.library_path("paged_attention").parent == \
            tmp_path / "kernels"
        assert compile_cache.entry_count(cache) == 0
        (tmp_path / "kernels" / "paged_attention-0123.so").write_bytes(b"")
        (tmp_path / "kernels" / "tmpabc.txt").write_bytes(b"")
        assert compile_cache.entry_count(cache) == 1
        assert compile_cache.entry_count(str(tmp_path / "missing")) == 0
    finally:
        compile_cache.disable()
    assert compile_cache.active_dir() is None
    assert runtime.build_dir() != tmp_path / "kernels"


def test_private_counters_are_the_threads_own():
    """Inside ``private_counters`` a thread's kernels take arrival-counter
    buffers of their own (a pdecode graph's warm-up and capture run beside
    other replicas' launches), while every other thread, and this one
    after the block, keeps the shared buffer."""
    shared = runtime.zeroed_counters("test_kernel", "cpu", 8)
    inside, other = {}, {}
    entered, checked = threading.Event(), threading.Event()

    def capture():
        with runtime.private_counters() as own:
            inside["t"] = runtime.zeroed_counters("test_kernel", "cpu", 8)
            inside["again"] = runtime.zeroed_counters("test_kernel", "cpu", 8)
            inside["own"] = dict(own)
            entered.set()
            assert checked.wait(10)

    def replica():
        assert entered.wait(10)
        other["t"] = runtime.zeroed_counters("test_kernel", "cpu", 8)
        checked.set()

    threads = [threading.Thread(target=f) for f in (capture, replica)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    assert inside["t"] is inside["again"] and inside["t"] is not shared
    assert inside["own"] == {("test_kernel", "cpu"): inside["t"]}
    assert other["t"] is shared
    assert runtime.zeroed_counters("test_kernel", "cpu", 8) is shared
