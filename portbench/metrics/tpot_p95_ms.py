"""95th percentile time per output token (ms) over every request sent
in the window: (last token - first token) / (tokens - 1), as the client
stamped them. Missing requests count as in ``ttft_p95_ms``."""
from portbench.metrics_common import latency_p95


def read(run):
    return latency_p95(run, lambda r: (r.t_last - r.t_first) / (r.n - 1)
                       if r.n > 1 else None)
