"""Serving engine (``tnn_tpu.serving``): continuous batching over a paged
KV-cache pool, on the card.

    from tnn_tpu_torch import serving
    engine = serving.InferenceEngine(model, num_blocks=64)
    rid = engine.submit(prompt_ids, max_new_tokens=32)
    outputs = engine.run_until_complete()

Requests always reach a terminal state (FINISHED / FAILED / CANCELLED /
TIMED_OUT), failures are isolated per request, admission is bounded
(``max_queue_depth``), and ``faults.FaultPlan`` injects deterministic
chaos. ``EngineSupervisor`` wraps the step loop with crash recovery, a
watchdog and graceful drain; ``Router`` fronts several supervised
replicas (failover, hedging, disaggregation, KV handoff, the fleet prefix
directory), ``Autoscaler`` sizes the fleet, and ``server.ServingServer``
puts an asyncio HTTP/SSE front end over a supervisor or a router.
"""
from . import compile_cache
from .autoscaler import Autoscaler
from .engine import InferenceEngine
from .faults import EngineCrash, FaultInjected, FaultPlan
from .kv_pool import (PagedKVPool, PoolExhausted, gather_kv, scatter_prefill,
                      scatter_token)
from .kv_tier import HostKVTier
from .metrics import (ServingMetrics, label_series, merge_series,
                      render_prometheus)
from .ownership import worker_only
from .prefix_cache import PrefixCache
from .router import (BreakerState, CircuitBreaker, HealthScore, NetDrop,
                     Router)
from .scheduler import (TERMINAL_STATES, AdmissionRejected, Request,
                        RequestState, Scheduler, StepPlan)
from .server import ServingServer, run_server
from .supervisor import EngineSupervisor, ShuttingDown, SupervisorState
from .tracing import FlightRecorder, Tracer, span_name

__all__ = [
    "InferenceEngine", "PagedKVPool", "PoolExhausted", "gather_kv",
    "scatter_prefill", "scatter_token", "ServingMetrics", "PrefixCache",
    "Request", "RequestState", "Scheduler", "StepPlan", "AdmissionRejected",
    "TERMINAL_STATES", "FaultPlan", "FaultInjected", "EngineCrash",
    "EngineSupervisor", "SupervisorState", "ShuttingDown",
    "Router", "CircuitBreaker", "BreakerState", "NetDrop", "HealthScore",
    "HostKVTier", "Autoscaler",
    "ServingServer", "run_server", "worker_only",
    "Tracer", "FlightRecorder", "span_name", "compile_cache",
    "render_prometheus", "label_series", "merge_series",
]
