"""95th percentile queue wait (ms) of the requests the engine admitted
inside the window: the engine's own observations
(``ServingMetrics.observe_queue_wait``) through its profiler's ticks."""
from portbench.metrics_common import ticks_in_window
from portbench.yardstick import percentile


def read(run):
    vals = ticks_in_window(run, "serve.queue_wait_s")
    return None if not vals else percentile(vals, 95) * 1e3
