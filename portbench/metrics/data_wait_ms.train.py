"""Input wait a step (ms): the benchmark's own host span around each
batch fetch from the program's prefetching feed, over the window's
steps."""


def read(run):
    steps = run.data.get("steps")
    if not steps:
        return None
    return run.data["data_wait_s"] / steps * 1e3
