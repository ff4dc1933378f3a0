#!/usr/bin/env python
"""Trace train or decode steps of the PyTorch port (``tnn_tpu_torch``) on
the card and print where the device time goes: the port's
``tools/trace_step.py``.

    python -m tools.torch_trace_step --what wrn          # WRN-16-8 train
    python -m tools.torch_trace_step --what gpt2_decode  # int8 decode
    python -m tools.torch_trace_step --what gpt2_train   # GPT-2 small train
    python -m tools.torch_trace_step --what gpt2_train_fused_head

The sizes are the JAX tool's: WRN-16-8 at B=256 for 3 steps of SGD with
momentum 0.9; GPT-2 small at B=8, S=512 under AdamW for 2 steps (the
fused head: the chunked LM-head loss at ``lm_head_chunk=8192``); an int8
GPT-2 small decoding 32 new tokens after a 64-token prompt. One untraced
step (or generation) runs first. ``--steps`` sets how many are traced.

The steps run inside ``profiling.profiler.device_trace`` (which writes
``trace.json`` under ``--out``) and one ``record_function`` window that
ends with a synchronize of the card. The tool then prints the window,
the device operations' total (kernels, copies and fills), the gap (the
window's time with no device operation: host work, launch latency, idle)
and the top operations by summed time, with trailing digits stripped
from their names as the JAX tool strips them.

It runs on the card. ``--device cpu`` (for the tests) traces on the CPU
and sums the top-level CPU operations of the window's thread instead.
Without a card and without ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import tempfile

import torch

WINDOW = "tnn.trace_window"
# the trace's categories of device work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def resolve(device: str) -> torch.device:
    """The device to trace on; a CUDA device needs a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no card (torch.cuda.is_available() is False): "
                           "pass --device cpu to trace on the CPU")
    return dev


def capture(run, out: str, device) -> str:
    """Trace ``run()`` inside one window ending in a synchronize of the
    card; returns the Chrome trace's path."""
    from tnn_tpu_torch.profiling.profiler import device_trace

    device = torch.device(device)
    with device_trace(out):
        with torch.profiler.record_function(WINDOW):
            run()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    return os.path.join(out, "trace.json")


def _top_level(events):
    """The events of one thread that no other of them contains."""
    out, end = [], -1.0
    for e in sorted(events, key=lambda e: (e["ts"], -e["dur"])):
        if e["ts"] >= end:
            out.append(e)
            end = e["ts"] + e["dur"]
    return out


def aggregate(path: str, top: int = 30, device="cuda"):
    """Sum the window's device operations (on the CPU: the top-level CPU
    operations of its thread) by name, print the window, their total, the
    gap and the ``top`` names; returns the name -> microseconds counter,
    with ``window_us`` and ``events`` beside it as attributes."""
    with open(path) as f:
        trace = json.load(f)
    evs = [e for e in trace["traceEvents"]
           if e.get("ph") == "X" and "dur" in e]
    wins = [e for e in evs if e["name"] == WINDOW
            and e.get("cat") == "user_annotation"]
    if not wins:
        raise SystemExit(f"no {WINDOW} window in {path}: the profiler "
                         "recorded nothing")
    win = max(wins, key=lambda e: e["dur"])
    t0, t1 = win["ts"], win["ts"] + win["dur"]
    if torch.device(device).type == "cuda":
        ops = [e for e in evs if e.get("cat") in DEVICE_CATEGORIES]
    else:
        ops = _top_level([e for e in evs if e.get("cat") == "cpu_op"
                          and e.get("tid") == win.get("tid")])
    ops = [e for e in ops if t0 <= e["ts"] and e["ts"] + e["dur"] <= t1]
    cat = collections.Counter()
    cnt = collections.Counter()
    for e in ops:
        base = re.sub(r"[.\d]+$", "", e["name"])
        cat[base] += e["dur"]
        cnt[base] += 1
    total = sum(cat.values())
    window = t1 - t0
    print(f"\nwindow {window / 1e3:.2f} ms; device ops {total / 1e3:.2f} "
          f"ms over {len(ops)} events (gap {max(window - total, 0) / 1e3:.2f}"
          f" ms, idle share {max(window - total, 0) / max(window, 1e-9):.3f})")
    print(f"{'ms':>9} {'count':>7}  op")
    for name, d in cat.most_common(top):
        print(f"{d / 1e3:9.3f} {cnt[name]:7d}  {name[:120]}")
    cat.window_us = window
    cat.events = len(ops)
    return cat


def trace_wrn(out: str, device, batch: int = 256, steps: int = 3):
    from tnn_tpu_torch import nn
    from tnn_tpu_torch.models import zoo
    from tnn_tpu_torch.train.step import create_train_state, make_train_step

    model = zoo.create("cifar100_wrn16_8", device=device, seed=0)
    opt = nn.SGD(lr=0.1, momentum=0.9)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt)
    x = torch.zeros((batch, 32, 32, 3), dtype=torch.bfloat16, device=device)
    y = torch.zeros((batch,), dtype=torch.long, device=device)
    state, m = step(state, x, y)                 # the untraced first step

    def run():
        nonlocal state
        for _ in range(steps):
            state, m = step(state, x, y)
        print("loss:", float(m["loss"]))
    return capture(run, out, device)


def trace_gpt2_train(out: str, device, batch: int = 8, seq: int = 512,
                     steps: int = 2, fused_head: bool = False):
    from tnn_tpu_torch import nn
    from tnn_tpu_torch.models import zoo
    from tnn_tpu_torch.train.step import create_train_state, make_train_step

    model = zoo.create("gpt2_small", device=device, seed=0)
    opt = nn.AdamW(lr=1e-4)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, compute_accuracy=not fused_head,
                           lm_head_chunk=8192 if fused_head else None)
    ids = (torch.arange(batch * seq, device=device).reshape(batch, seq)
           % model.vocab_size)
    state, m = step(state, ids, ids)

    def run():
        nonlocal state
        for _ in range(steps):
            state, m = step(state, ids, ids)
        print("loss:", float(m["loss"]))
    return capture(run, out, device)


def trace_gpt2_decode(out: str, device, new: int = 32, steps: int = 1):
    from tnn_tpu_torch.models import zoo
    from tnn_tpu_torch.models.gpt2 import generate
    from tnn_tpu_torch.nn.quant import quantize_for_decode

    model = quantize_for_decode(zoo.create("gpt2_small", device=device,
                                           seed=0))
    ids = torch.arange(64, device=device)[None] + 1
    generate(model, ids, new)

    def run():
        for _ in range(steps):
            toks = generate(model, ids, new)
        print("first tok:", int(toks[0, 0]))
    return capture(run, out, device)


DEFAULT_STEPS = {"wrn": 3, "gpt2_decode": 1, "gpt2_train": 2,
                 "gpt2_train_fused_head": 2}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--what", default="wrn", choices=sorted(DEFAULT_STEPS))
    ap.add_argument("--out", default=None,
                    help="trace directory (default: a new temporary one)")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--steps", type=int, default=None,
                    help="traced steps (generations for gpt2_decode)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    out = args.out or tempfile.mkdtemp(prefix="tnn_trace_")
    steps = args.steps or DEFAULT_STEPS[args.what]
    if args.what == "wrn":
        path = trace_wrn(out, device, steps=steps)
    elif args.what == "gpt2_decode":
        path = trace_gpt2_decode(out, device, steps=steps)
    else:
        path = trace_gpt2_train(out, device, steps=steps,
                                fused_head=args.what.endswith("fused_head"))
    return aggregate(path, args.top, device)


if __name__ == "__main__":
    main()
