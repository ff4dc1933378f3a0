"""Persistent kernel build cache for serving restarts
(``tnn_tpu.serving.compile_cache``).

The JAX package points XLA's persistent compilation cache at an operator's
directory, so a restart, a rolling deploy or an autoscaler scale-up loads
its step programs instead of compiling them again. The port's compiled
programs are its hand-written CUDA kernels: ``ops/runtime.py`` builds each
``csrc/*.cu`` with ``nvcc`` into a shared library named by a hash of the
source, the headers and the flags, and loads an existing one without
running ``nvcc``. ``enable(dir)`` makes ``dir`` that build directory
(``tnn-serve --compile-cache DIR``), and ``entry_count(dir)`` counts the
libraries in it, so a warm start is observable: a second process with the
same directory runs no ``nvcc`` (``runtime.nvcc_runs`` stays 0).

A library is keyed by its content, so replicas of one checkout can share
the directory; a changed source or flag set misses and builds anew, never
loading a stale library. Eviction is the operator's (a plain directory).
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from ..ops import runtime

#: the directory most recently handed to :func:`enable` (None = disabled)
_active_dir: Optional[str] = None


def enable(cache_dir: str) -> str:
    """Make ``cache_dir`` (created if missing) the kernel build directory
    and return it. Takes effect for every library not loaded yet, so call
    it before the first kernel runs; a library this process has loaded
    already is not moved, and enabling after that raises."""
    cache_dir = os.path.abspath(os.path.expanduser(cache_dir))
    loaded = runtime.loaded_libraries()
    if loaded and runtime.build_dir() != Path(cache_dir):
        raise RuntimeError(
            f"compile cache enabled after kernel libraries were loaded "
            f"({', '.join(loaded)}): enable it before the first kernel "
            "runs")
    os.makedirs(cache_dir, exist_ok=True)
    runtime._build_dir_override = Path(cache_dir)
    global _active_dir
    _active_dir = cache_dir
    return cache_dir


def active_dir() -> Optional[str]:
    """The enabled cache directory, or None when the cache is off."""
    return _active_dir


def disable() -> None:
    """Return to the default build directory (tests and embedders; the CLI
    never needs this). Safe to call when already off."""
    runtime._build_dir_override = None
    global _active_dir
    _active_dir = None


def entry_count(cache_dir: str) -> int:
    """Number of built kernel libraries (``*.so``) under ``cache_dir``. A
    missing or unreadable directory counts as empty rather than raising:
    callers use this for gauges and warm/cold log lines."""
    try:
        return sum(1 for name in os.listdir(cache_dir)
                   if name.endswith(".so") and not name.startswith("."))
    except OSError:
        return 0
