"""Engine thread-ownership annotation (``tnn_tpu.serving.ownership``).

The supervised engine has no locks by design: exactly one thread (the
supervisor's worker, or the caller itself in the inline ``run_sync``/
``pump`` modes) may touch it.  ``@worker_only`` marks the methods allowed
to do so (the JAX package's ``cross-thread-engine-access`` lint rule reads
the marker), and ``TNN_DEBUG_THREADS=1`` arms a runtime assert
that the caller actually IS the owning thread (cheap enough for chaos
soaks, off by default for production).
"""
from __future__ import annotations

import functools
import os
import threading

_RUNTIME_CHECK = os.environ.get("TNN_DEBUG_THREADS", "") == "1"


def worker_only(method):
    """Mark a supervisor method as running on the engine's owning thread.

    The marker (``_worker_only`` attribute) is what the lint rule reads.
    With TNN_DEBUG_THREADS=1 at import time, the method additionally
    asserts the calling thread is the supervisor's worker (``self._thread``)
    — or that no worker exists yet, which covers construction and the
    inline ``run_sync``/``pump`` modes where the caller IS the owner.
    """
    if not _RUNTIME_CHECK:
        method._worker_only = True
        return method

    @functools.wraps(method)
    def checked(self, *args, **kwargs):
        worker = getattr(self, "_thread", None)
        if worker is not None and threading.current_thread() is not worker:
            raise AssertionError(
                f"{type(self).__name__}.{method.__name__} called from "
                f"{threading.current_thread().name!r} but the engine is "
                f"owned by {worker.name!r} — marshal through the command "
                f"queue instead")
        return method(self, *args, **kwargs)

    checked._worker_only = True
    return checked
