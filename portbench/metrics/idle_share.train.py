"""The device's idle share (%) in the traced sub-window: the time no
device operation ran over the window's length."""


def read(run):
    if run.trace is None or run.trace.idle_share is None:
        return None
    return 100.0 * run.trace.idle_share
