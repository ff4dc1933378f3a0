"""Served tokens a second: output tokens that reached the client inside
the window, over the window's seconds."""


def read(run):
    if "window_tokens" not in run.data:
        return None
    return run.data["window_tokens"] / run.seconds
