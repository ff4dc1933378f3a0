"""95th percentile time to first token (ms) over every request sent in
the window: from its scheduled send to its first token reaching the
client. A request that failed, was refused or never finished counts as
missing: it ranks above every answered one, and where the percentile
falls on it, the time from its send to the end of the run's wait
stands for it."""
from portbench.metrics_common import latency_p95


def read(run):
    return latency_p95(run, lambda r: r.t_first - r.t_sched)
