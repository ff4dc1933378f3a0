"""The engine's ``TNN_DEBUG_SYNC`` guard: the port's counterpart of the JAX
engine's ``jax.transfer_guard("disallow")`` around its step.

Under ``TNN_DEBUG_SYNC=1`` a CUDA engine runs the step's build, its commit
and the speculative dispatch inside ``guarded()``, where torch's
sync-debug mode is "error": any call that makes the host wait for the
card (``.item()``, ``.tolist()``, ``int(t)`` on a device tensor,
``torch.nonzero``, boolean-mask indexing, a copy from pageable memory, a
stream or device synchronize) raises there. The points where the step
moves data on purpose hold ``exempt()`` around them: the engine's input
put (pinned memory, non-blocking), the wait on the step's fetch event and
a pdecode graph's capture. A trip leaves the region as ``SyncTripped``,
whose message names the synchronizing line; the engine fails the step's
requests with it, as the JAX engine fails them with its transfer error.

The mode is process-wide in c10, not per thread, while the supervisor
steps an engine on its worker thread, a fleet's replicas step on threads
of their own on one card and TP shards share a process. So the state is
counted under a lock: the mode is "error" while at least one thread is
inside a guarded region and no thread is inside an exempt point, and
"default" otherwise. One engine's exempt fetch can therefore hide another
engine's sync for that moment: a false negative, which this guard
allows. An engine's own transfers outside its step (``export_prefix``,
``adopt_prefix``) hold ``exempt()`` as well, so that one engine's guarded
step never trips another engine's deliberate copy between its steps.
Code outside any engine that syncs on another thread while a step is
guarded trips all the same: drive guarded engines from threads that
make no synchronizing call of their own meanwhile.

On a CPU engine the guard is a no-op: such an engine makes no
host-to-device transfer, and torch built without CUDA refuses the mode
setter. A CUDA engine with the knob set always arms it.
"""
from __future__ import annotations

import contextlib
import os
import threading
import traceback
from typing import Iterator

import torch

# what c10 raises in "error" mode
SYNC_ERROR = "called a synchronizing CUDA operation"


class SyncTripped(RuntimeError):
    """A synchronizing call inside a guarded region; the message names
    it."""


def set_mode(mode: str) -> None:
    """The process-wide setter (``torch.cuda.set_sync_debug_mode``)."""
    torch.cuda.set_sync_debug_mode(mode)


_lock = threading.Lock()
_guarded = 0        # threads inside a guarded region
_exempt = 0         # threads inside an exempt point
_mode = "default"


def _apply() -> None:
    """Set the mode the counts ask for (the caller holds ``_lock``)."""
    global _mode
    want = "error" if _guarded and not _exempt else "default"
    if want != _mode:
        set_mode(want)
        _mode = want


def _count(guarded: int = 0, exempt: int = 0) -> None:
    global _guarded, _exempt
    with _lock:
        _guarded += guarded
        _exempt += exempt
        _apply()


def where(exc: BaseException) -> str:
    """``file:line in function: source`` of the innermost frame of
    ``exc``'s traceback outside torch's own package: the line that made
    the synchronizing call."""
    frames = traceback.extract_tb(exc.__traceback__)
    torch_dir = os.path.dirname(torch.__file__)
    ours = [f for f in frames if not f.filename.startswith(torch_dir)]
    f = (ours or frames)[-1]
    return (f"{os.path.basename(f.filename)}:{f.lineno} in {f.name}: "
            f"{(f.line or '').strip()}")


@contextlib.contextmanager
def guarded() -> Iterator[None]:
    """A guarded region: every synchronizing call in it raises, as
    ``SyncTripped``."""
    _count(guarded=1)
    try:
        yield
    except RuntimeError as e:
        if isinstance(e, SyncTripped) or SYNC_ERROR not in str(e):
            raise
        raise SyncTripped(f"TNN_DEBUG_SYNC: synchronizing CUDA operation "
                          f"inside the step at {where(e)}") from e
    finally:
        _count(guarded=-1)


@contextlib.contextmanager
def exempt() -> Iterator[None]:
    """A deliberate transfer: the mode is "default" while it runs."""
    _count(exempt=1)
    try:
        yield
    finally:
        _count(exempt=-1)


def mode() -> str:
    """The mode the guard last set."""
    return _mode
