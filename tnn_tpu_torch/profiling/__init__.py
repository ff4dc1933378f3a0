"""Profiling (``tnn_tpu.profiling``): event tracing, cross-process merge,
Chrome-trace export, device traces.

Parity: reference ``include/profiling/`` — ``Event{type, start, end, name, source}``
(event.hpp:11,30), thread-safe ``Profiler`` accumulator with cross-process merge that
re-bases timestamps (profiler.hpp:52-63), process-global ``GlobalProfiler``
(profiler.hpp:132). Rendered by visualizers/visualize_profiler.py as a Gantt chart; here
the export is standard Chrome trace JSON (chrome://tracing / Perfetto) instead.

``device_trace`` wraps ``torch.profiler`` so device-side kernel timing is captured
alongside the host-side event timeline (the JAX package's wraps ``jax.profiler``).
"""
from .profiler import (
    Event,
    EventType,
    GlobalProfiler,
    Profiler,
    device_trace,
    profiled,
)

__all__ = [
    "Event",
    "EventType",
    "Profiler",
    "GlobalProfiler",
    "device_trace",
    "profiled",
]
