"""Request-scoped tracing + crash flight recorder for the serving stack
(``tnn_tpu.serving.tracing``).

Two small, host-side-only observability primitives (neither ever touches a
device tensor, so tracing adds no synchronization to the step path):

- ``Tracer`` — a thin span/instant recorder over the port's
  ``profiling.Profiler``. Engine, supervisor, and router each hold one;
  spans carry ``(trace_id, rid, step_seq)`` encoded into the event name so
  ``Profiler.to_chrome_trace`` yields one Perfetto view across
  router → replicas → engine steps (one track per profiler ``source``).
  A ``Tracer(None)`` is a complete no-op: tracing off must cost nothing
  and change nothing (tracing on ≡ off token-exact is a standing gate).

- ``FlightRecorder`` — a bounded ring buffer of recent engine step
  records (step kind + compile key, batch rids, fill, pool occupancy,
  step latency, faults fired), owned by the supervisor and dumped as
  JSONL on crash, watchdog trip, restart-budget exhaustion, and drain.
  The post-mortem artifact for every failure path the chaos suite
  exercises: the final record of a crash dump identifies the step (and
  batch) that died.

Trace ids are deterministic (caller-assigned, derived from request ids) —
no randomness, so traced replays stay reproducible.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Deque, Dict, Iterator, List, Optional

from ..profiling.profiler import EventType, Profiler


def span_name(base: str, **attrs: Any) -> str:
    """Encode span attributes into the event name (``base k=v k=v``).

    Chrome-trace ``args`` would be richer, but the profiler's event model
    is (type, start, end, name, source) — flat names keep the span usable
    by both ``to_chrome_trace`` and ``tools/visualize_profiler``.
    """
    if not attrs:
        return base
    parts = [f"{k}={v}" for k, v in attrs.items() if v is not None]
    return base + (" " + " ".join(parts) if parts else "")


class Tracer:
    """Span/instant recorder over a ``Profiler`` (no-op when profiler is
    None). All methods are safe from any thread — the profiler locks."""

    def __init__(self, profiler: Optional[Profiler] = None):
        self.profiler = profiler

    @property
    def enabled(self) -> bool:
        return self.profiler is not None

    @contextmanager
    def span(self, base: str, type: EventType = EventType.OTHER,
             **attrs: Any) -> Iterator[None]:
        """Timed span: records ``base k=v ...`` over the body's duration."""
        if self.profiler is None:
            yield
            return
        start = time.perf_counter()
        try:
            yield
        finally:
            self.profiler.add_event(type, start, time.perf_counter(),
                                    span_name(base, **attrs))

    def instant(self, base: str, type: EventType = EventType.OTHER,
                **attrs: Any) -> None:
        """Zero-duration marker (dispatch, retry, preemption, publish...)."""
        if self.profiler is None:
            return
        now = time.perf_counter()
        self.profiler.add_event(type, now, now, span_name(base, **attrs))


class FlightRecorder:
    """Bounded ring buffer of step records with JSONL dumps.

    Records are plain dicts (one engine step each — see
    ``InferenceEngine.last_step_record``). ``dump`` writes a meta header
    line (reason, capacity, counts) followed by the retained records in
    step order; the last line of a crash dump is the crashing step.
    """

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError("flight recorder capacity must be >= 1")
        self.capacity = int(capacity)
        self._records: Deque[Dict[str, Any]] = deque(maxlen=self.capacity)
        self._total = 0              # records ever seen (ring may drop old)
        self._dumps = 0
        self._lock = threading.Lock()

    def record(self, rec: Optional[Dict[str, Any]]) -> None:
        if rec is None:
            return
        with self._lock:
            self._total += 1
            self._records.append(dict(rec))

    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(r) for r in self._records]

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def dump(self, path: str, reason: str,
             extra: Optional[Dict[str, Any]] = None) -> str:
        """Write the retained records as JSONL; returns ``path``."""
        with self._lock:
            records = [dict(r) for r in self._records]
            total = self._total
            self._dumps += 1
        meta: Dict[str, Any] = {
            "kind": "flight_recorder_meta",
            "reason": reason,
            "capacity": self.capacity,
            "records": len(records),
            "total_steps_seen": total,
            "wall_time": time.time(),
        }
        if extra:
            meta.update(extra)
        with open(path, "w") as f:
            f.write(json.dumps(meta) + "\n")
            for rec in records:
                f.write(json.dumps(rec, default=str) + "\n")
        return path

    @property
    def dumps(self) -> int:
        with self._lock:
            return self._dumps
