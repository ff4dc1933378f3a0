"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). Libraries land in
``build/kernels/`` at the repository root (``TNN_TORCH_BUILD_DIR``
overrides, and ``serving.compile_cache.enable`` overrides both), named by
a hash of the source, the headers beside it and the flags, so a changed
source or header rebuilds and an unchanged one loads the existing
library. Builds happen at first use, never at import: the
CPU-only test host has no ``nvcc`` and imports every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from collections import Counter
from pathlib import Path
from typing import Dict, Optional

# the H100 SXM's streaming multiprocessors: what the launch plans of the
# wrappers assume where no card is at hand (the CPU tests)
H100_SMS = 132

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# --split-compile=0 spreads each source's device-code optimisation over
# every core (on an 8-core H100 host: 7.5 s -> 5.7 s for flash_attention.cu)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--split-compile=0", "-shared", "-Xcompiler", "-fPIC"]

_loaded: Dict[str, ctypes.CDLL] = {}
# set by serving.compile_cache.enable; wins over TNN_TORCH_BUILD_DIR
_build_dir_override: Optional[Path] = None
# nvcc processes this process ran (a warm build directory runs none)
nvcc_runs = 0


def build_dir() -> Path:
    if _build_dir_override is not None:
        return _build_dir_override
    env = os.environ.get("TNN_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "kernels"


def loaded_libraries() -> list:
    """Names of the kernel libraries this process has loaded."""
    return sorted(_loaded)


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built on the machine with the card")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by the source, every
    ``csrc/*.cuh`` header (a source may include any of them) and the
    flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Build ``csrc/<name>.cu`` unless it is built already; returns the
    library path."""
    out = library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    global nvcc_runs
    nvcc_runs += 1
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, out)   # atomic: readers never see half a file
    return out


_load_lock = threading.Lock()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    One lock: replicas stepping on threads of their own build a library
    once between them."""
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = _loaded[name] = ctypes.CDLL(str(build(name)))
    return lib


_sms: Dict[int, int] = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (cached): the launch
    plans size their grids by it."""
    import torch

    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sms[index]


_counters: Dict[tuple, "object"] = {}
# a table of this thread's own, in place of ``_counters``, inside
# ``private_counters``
_scope = threading.local()


def zeroed_counters(name: str, device, n: int):
    """A persistent int32 tensor of at least ``n`` zeros on ``device``, one
    per kernel name: the arrival counters of a kernel whose last block of a
    group reduces the group's partials. Such a kernel leaves its counters 0
    again, so the buffer is filled once, when it is made or grown. Two
    launches that may run at once must not share it: launches in stream
    order share the process's table; inside ``private_counters`` a thread
    takes buffers of its own."""
    import torch

    table = getattr(_scope, "table", None)
    if table is None:
        table = _counters
    key = (name, str(torch.device(device)))
    t = table.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        table[key] = t
    return t


class private_counters:
    """``with private_counters() as own:`` the kernels this thread launches
    inside the block take counter buffers of their own, held in ``own``
    (kernel name and device -> tensor). A pdecode graph's warm-up and
    capture run on a side stream while other replicas' workers launch the
    same kernels on the default stream: with one shared buffer their
    arrival counts would mix, so a group could reduce before its last
    partial and leave a counter off zero for a later launch. The graph
    keeps ``own``; its replays run on the default stream, in turn with
    every other launch there."""

    def __enter__(self) -> Dict[tuple, "object"]:
        self._outer = getattr(_scope, "table", None)
        _scope.table = {}
        return _scope.table

    def __exit__(self, *exc) -> None:
        _scope.table = self._outer


# -- launch counts ------------------------------------------------------------
#
# Each kernel wrapper counts its launches in an attribute of its own
# (``paged_attention.launches``, ...). Replicas of a fleet step on threads of
# their own, so the counts go through one lock, and each thread also keeps
# its own tally: a pdecode graph capture takes back out exactly the launches
# its own thread made (serving/step_graph.py), never another replica's.

_count_lock = threading.Lock()
_tally = threading.local()


def count_launch(fn, attr: str = "launches", n: int = 1) -> None:
    """Add ``n`` to the launch counter ``fn.<attr>`` (and to this thread's
    tally)."""
    with _count_lock:
        setattr(fn, attr, getattr(fn, attr) + n)
    tally = getattr(_tally, "counts", None)
    if tally is None:
        tally = _tally.counts = Counter()
    tally[(id(fn), attr)] += n


def thread_launches() -> Counter:
    """A copy of this thread's launch tally, by (id(fn), attr)."""
    return Counter(getattr(_tally, "counts", None) or {})
