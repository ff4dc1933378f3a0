"""Arithmetic the metric readers share."""
from __future__ import annotations

import math

from .yardstick import flash_work, kernel_base, least_time_s

ELEM_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def latency_p95(run, value):
    """The 95th percentile (ms) of ``value(rec)`` over every request sent
    in the window (nearest rank). A request that did not finish, or has
    no value, ranks above every answered one; where the percentile falls
    on one, the time from its send to the end of the run's wait stands
    for it."""
    reqs = run.data.get("requests")
    if not reqs or "t1" not in run.data:
        return None
    keyed = []
    for r in reqs:
        v = value(r) if r.state == "done" and r.t_first is not None \
            else None
        keyed.append((0, v) if v is not None
                     else (1, run.data["t1"] - r.t_sched))
    keyed.sort()
    k = max(1, math.ceil(0.95 * len(keyed)))
    return keyed[k - 1][1] * 1e3


def ticks_in_window(run, key: str):
    """The values of the engine's profiler ticks under ``key`` stamped
    inside the window, before the counters' end (where a traced run's
    profiler starts)."""
    ticks = run.data.get("ticks")
    if ticks is None:
        return None
    t0, t1 = run.data["t0"], run.data["counters_end"]
    return [v for t, k, v in ticks if k == key and t0 <= t <= t1]


def flash_roofline(run, which: int, kernels, calls):
    """A flash kernel's share (%) of its roofline in the traced steps:
    the least time of one call at the step's causal self-attention shape
    (``which`` 0: forward, 1: backward) over the device time of the
    kernels ``kernels`` accepts (by base name) a call, calls counted by
    the launches ``calls`` accepts."""
    if run.trace is None or "batch" not in run.data:
        return None
    sec, _ = run.trace.seconds_of(lambda lb: kernels(kernel_base(lb)))
    _, n = run.trace.seconds_of(lambda lb: calls(kernel_base(lb)))
    if n == 0 or sec <= 0:
        return None
    cfg = run.config
    dtype = cfg["precision"]["compute"]
    nbytes, ops = flash_work(run.data["batch"], cfg["n_head"],
                             run.data["seq"], cfg["n_embd"] // cfg["n_head"],
                             ELEM_BYTES[dtype], causal=True)[which]
    return 100.0 * least_time_s(nbytes, ops, dtype) / (sec / n)

