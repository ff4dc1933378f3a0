"""Train step time (ms): the window's wall time, from its start to the
card's finishing the last step begun in it, over the steps begun."""


def read(run):
    steps = run.data.get("steps")
    if not steps:
        return None
    return run.data["window_s"] / steps * 1e3
