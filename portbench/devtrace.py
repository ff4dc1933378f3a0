"""The traced sub-window: ``torch.profiler`` over a bounded stretch of a
run, read in memory (no trace file).

The reduction follows the program's trace tool (``tools/torch_trace_step
.py``: the device operations' total, the gap, the idle share) with two
changes: busy time is the union of the device operations' intervals, so
operations that overlap are not counted twice, and each idle gap is
named by what the host was doing when it began (the innermost host
operation open at that moment).
"""
from __future__ import annotations

import bisect
import collections
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .yardstick import kernel_label

# the profiler's activity types of work on the device
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_ACTIVITIES = ("cpu_op", "user_annotation", "cuda_runtime",
                   "python_function")


@dataclass
class TraceSummary:
    """What one traced sub-window held."""
    window_s: float
    busy_s: float
    # kernel label -> (seconds, launches)
    by_label: Dict[str, Tuple[float, int]] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    device_events: int = 0

    @property
    def idle_share(self) -> Optional[float]:
        if self.window_s <= 0 or self.device_events == 0:
            return None
        return max(self.window_s - self.busy_s, 0.0) / self.window_s

    def seconds_of(self, predicate) -> Tuple[float, int]:
        """Summed seconds and launches of the kernels whose label
        ``predicate`` accepts."""
        s, n = 0.0, 0
        for label, (sec, cnt) in self.by_label.items():
            if predicate(label):
                s += sec
                n += cnt
        return s, n


class DeviceWindow:
    """``start()`` and ``stop()`` a profiler (on the thread that drives
    the device); ``summary()`` reduces it afterwards.

    Constructing one runs an empty profile on the constructing thread
    (the run's main thread): the device tracer initialises there, where
    the profiler registered it, and a window started later on another
    thread (the serving engine's worker) records."""

    def __init__(self, device_type: str = "cuda"):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if device_type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts):
            pass
        self._prof = torch.profiler.profile(activities=acts)

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> None:
        self._prof.stop()

    def summary(self, top: int = 10) -> TraceSummary:
        events = self._prof.profiler.kineto_results.events()
        return reduce_events([
            (e.name(), _activity(e), e.start_ns(),
             e.start_ns() + e.duration_ns()) for e in events], top)


def _activity(e) -> str:
    """An event's activity type: the profiler's own where the event has
    it, else by the side it ran on (a device record that is no annotation
    and no synchronisation is device work)."""
    if hasattr(e, "activity_type"):
        return str(e.activity_type()).rsplit(".", 1)[-1]
    if e.is_user_annotation():
        return "user_annotation"
    if str(e.device_type()).rsplit(".", 1)[-1] == "CUDA":
        return "cuda_sync" if "Sync" in e.name() else "kernel"
    return "cpu_op"


def reduce_events(events: List[Tuple[str, str, int, int]], top: int = 10
                  ) -> TraceSummary:
    """Reduce (name, activity type, start ns, end ns) records: the window
    spans every record, busy is the union of the device records, and the
    gaps between device records are named by the innermost host record
    open at each gap's start."""
    events = [ev for ev in events if ev[3] >= ev[2]]
    if not events:
        return TraceSummary(0.0, 0.0)
    t0 = min(e[2] for e in events)
    t1 = max(e[3] for e in events)
    dev = sorted((e for e in events if e[1] in DEVICE_ACTIVITIES),
                 key=lambda e: e[2])
    host = sorted((e for e in events if e[1] in HOST_ACTIVITIES),
                  key=lambda e: e[2])
    by_label: Dict[str, List[float]] = collections.defaultdict(
        lambda: [0.0, 0])
    by_op: Dict[str, float] = collections.Counter()
    busy = 0
    gaps: List[Tuple[int, int]] = []
    cur_s = cur_e = None
    for name, _, s, e in dev:
        rec = by_label[kernel_label(name)]
        rec[0] += (e - s) / 1e9
        rec[1] += 1
        by_op[re.sub(r"[.\d]+$", "", kernel_label(name))[:160]] += \
            (e - s) / 1e9
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            elif s > t0:
                gaps.append((t0, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        if t1 > cur_e:
            gaps.append((cur_e, t1))
    starts = [h[2] for h in host]
    named: Dict[str, float] = collections.Counter()
    for g0, g1 in gaps:
        # host records open at g0: started at or before it, ending after
        i = bisect.bisect_right(starts, g0)
        inner = None
        for h in reversed(host[max(0, i - 4096):i]):
            if h[3] > g0:
                inner = h
                break
        named[inner[0][:160] if inner else "(no host operation)"] += \
            (g1 - g0) / 1e9
    return TraceSummary(
        window_s=(t1 - t0) / 1e9, busy_s=busy / 1e9,
        by_label={k: (v[0], int(v[1])) for k, v in by_label.items()},
        device_ops=sorted(by_op.items(), key=lambda kv: -kv[1])[:top],
        idle_gaps=sorted(named.items(), key=lambda kv: -kv[1])[:top],
        device_events=len(dev))
