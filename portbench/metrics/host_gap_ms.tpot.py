"""Mean host gap a step (ms): the engine's own observations of the time
the card waited on the host between steps
(``ServingMetrics.observe_host_gap``), inside the window."""
from portbench.metrics_common import ticks_in_window


def read(run):
    vals = ticks_in_window(run, "serve.host_gap_s")
    return None if not vals else sum(vals) / len(vals) * 1e3
