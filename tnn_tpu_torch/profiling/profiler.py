"""Host-side event profiler with cross-process merge and Chrome-trace export
(``tnn_tpu.profiling.profiler``, pure Python; the port keeps its own copy).

Parity map (reference -> here):
- ``Event`` / ``EventType {COMPUTE, COMMUNICATION, OTHER}`` (include/profiling/event.hpp:11,30)
  -> ``Event`` / ``EventType`` (DATA added for loader/staging spans).
- thread-safe ``Profiler`` with ``add_event`` and merge-with-rebase (profiler.hpp:52-63)
  -> ``Profiler.add_event`` / ``Profiler.merge`` (rebase aligns the other profiler's
  clock by start-time delta, so profiles from hosts with different monotonic origins
  line up on one timeline).
- ``GlobalProfiler`` (profiler.hpp:132) -> module-level singleton with enable gating.
- serialized Profiler travelling the control plane as a message payload
  (message.hpp:21, binary_serializer.hpp:46) -> ``to_dict``/``from_dict`` (JSON-safe).
- communicator per-key microsecond counters (communicator.hpp:157-184) -> ``counters``.
"""
from __future__ import annotations

import contextlib
import enum
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional


class EventType(enum.Enum):
    COMPUTE = "compute"
    COMMUNICATION = "communication"
    DATA = "data"
    OTHER = "other"


@dataclass
class Event:
    type: EventType
    start: float  # seconds on this process's perf_counter clock
    end: float
    name: str
    source: str = ""  # e.g. "host0", "stage1" — who recorded it

    @property
    def duration(self) -> float:
        return self.end - self.start


class Profiler:
    """Thread-safe span accumulator.

    Use ``scope`` to time a block, ``add_event`` for pre-measured spans, ``tick`` for
    key->time counters, ``merge`` to fold in another (possibly remote) profiler.
    """

    def __init__(self, source: str = ""):
        self.source = source
        self._events: List[Event] = []
        self._counters: Dict[str, float] = {}
        self._lock = threading.Lock()
        # clock origin so merges can rebase between processes
        self._origin = time.perf_counter()

    # -- recording ------------------------------------------------------------

    def add_event(self, type: EventType, start: float, end: float, name: str,
                  source: str = "") -> None:
        ev = Event(type, start, end, name, source or self.source)
        with self._lock:
            self._events.append(ev)

    @contextlib.contextmanager
    def scope(self, name: str,
              type: EventType = EventType.COMPUTE) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_event(type, t0, time.perf_counter(), name)

    def tick(self, key: str, seconds: float) -> None:
        """Accumulate a duration under ``key`` (parity: communicator.hpp:157-184)."""
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + seconds

    # -- access ---------------------------------------------------------------

    @property
    def events(self) -> List[Event]:
        with self._lock:
            return list(self._events)

    @property
    def counters(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._counters.clear()
            self._origin = time.perf_counter()

    # -- merge / serialization ------------------------------------------------

    def merge(self, other: "Profiler") -> None:
        """Fold ``other``'s events into this timeline.

        Rebase rule (parity: profiler.hpp:52-63): shift the other profiler's
        timestamps by the difference of clock origins, so both ranges share this
        profiler's clock. Cross-host skew beyond origin alignment is accepted, as in
        the reference.
        """
        if other is self:
            return
        delta = self._origin - other._origin
        # copy under other's lock, then insert under ours — never hold both
        # (self-merge or concurrent mutual merges would deadlock otherwise)
        with other._lock:
            evs = list(other._events)
            ctrs = dict(other._counters)
        with self._lock:
            for ev in evs:
                self._events.append(Event(ev.type, ev.start + delta, ev.end + delta,
                                          ev.name, ev.source or other.source))
            for k, v in ctrs.items():
                self._counters[k] = self._counters.get(k, 0.0) + v

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "source": self.source,
                "origin": self._origin,
                "events": [
                    {"type": ev.type.value, "start": ev.start, "end": ev.end,
                     "name": ev.name, "source": ev.source}
                    for ev in self._events
                ],
                "counters": dict(self._counters),
            }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Profiler":
        p = cls(source=d.get("source", ""))
        p._origin = float(d.get("origin", 0.0))
        p._events = [
            Event(EventType(e["type"]), float(e["start"]), float(e["end"]),
                  e["name"], e.get("source", ""))
            for e in d.get("events", [])
        ]
        p._counters = {k: float(v) for k, v in d.get("counters", {}).items()}
        return p

    # -- reporting ------------------------------------------------------------

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-name aggregate: count, total seconds, mean seconds."""
        out: Dict[str, Dict[str, float]] = {}
        for ev in self.events:
            s = out.setdefault(ev.name, {"count": 0, "total_s": 0.0, "mean_s": 0.0})
            s["count"] += 1
            s["total_s"] += ev.duration
        for s in out.values():
            s["mean_s"] = s["total_s"] / max(s["count"], 1)
        return out

    def to_chrome_trace(self, path: Optional[str] = None) -> List[Dict[str, Any]]:
        """Chrome trace-event JSON (load in chrome://tracing or Perfetto).

        One 'thread' row per source — the same view the reference's Gantt
        visualizer draws per coordinator/worker (visualizers/visualize_profiler.py).
        """
        sources = sorted({ev.source or "local" for ev in self.events})
        tids = {s: i for i, s in enumerate(sources)}
        trace = [
            {"name": s, "ph": "M", "pid": 0, "tid": tids[s],
             "args": {"name": s}, "cat": "__metadata"}
            for s in sources
        ]
        for ev in self.events:
            trace.append({
                "name": ev.name, "cat": ev.type.value, "ph": "X", "pid": 0,
                "tid": tids[ev.source or "local"],
                "ts": ev.start * 1e6, "dur": ev.duration * 1e6,
            })
        if path is not None:
            with open(path, "w") as f:
                json.dump({"traceEvents": trace}, f)
        return trace


# -- process-global profiler (parity: GlobalProfiler, profiler.hpp:132) -----------

GlobalProfiler = Profiler(source="main")
_enabled = False


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def is_enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def profiled(name: str, type: EventType = EventType.COMPUTE,
             profiler: Optional[Profiler] = None) -> Iterator[None]:
    """Time a block into ``profiler`` (default: GlobalProfiler); no-op when disabled
    and no explicit profiler given — keeps the hot loop clean at zero cost."""
    p = profiler or (GlobalProfiler if _enabled else None)
    if p is None:
        yield
        return
    with p.scope(name, type):
        yield


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[None]:
    """Capture a device-side trace of the block with ``torch.profiler``
    (CPU and, where a card is present, CUDA activities) and write it as a
    Chrome trace (``trace.json``) into ``logdir``: the port's counterpart of
    the JAX package's ``jax.profiler`` trace, per-kernel timing from the
    runtime rather than host wall clocks."""
    import os

    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
