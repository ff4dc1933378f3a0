"""Language-model training driver: the program's train step
(``train.step.make_train_step`` with its AdamW), fed as its training
loop feeds it: windows of a token file through
``data.token_stream.TokenStreamDataLoader``, staged on the card by
``data.loader.prefetch`` on a producer thread.

Set-up writes the mix's seeded token file under the temporary directory,
makes the weights from the seed, and drives the one train state through
its first ``CHECK_STEPS`` steps through the window's own feed and call:
those are the warm-up and the steps the reference follows. The window
then steps the same state for ``seconds``; its time is the wall time
from its start to the card's finishing the last step it began. A traced
run profiles two more steps after the window.

Once the program's state is freed, the plain reference
(``reference.gpt2.train_steps``, float32, TF32 off) runs the same first
steps from the same weights on the same windows, read from the raw file
at the starts the loader drew: each step's loss, the first gradient's
norm leaf by leaf (the program's from its optimizer's first moment after
one step, m / (1 - beta1)) and each leaf's change over the steps (the
program's taken before the window's first step) are compared.
``--control fp8`` puts the reference with fp8 products in the
program's place.

``run.data`` keys: ``steps``, ``window_s``, ``data_wait_s`` (the
benchmark's own host time around each batch fetch), ``batch``, ``seq``.
"""
from __future__ import annotations

import copy
import gc
import math
import shutil
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np

from portbench import compare, harness, weights
from portbench.devtrace import DeviceWindow
from portbench.reference import gpt2 as reference

CHECK_STEPS = 3
TRACE_STEPS = 2


def _opt_cfg(cfg: dict) -> dict:
    o = cfg["optimizer"]
    return {k: o[k] for k in ("lr", "beta1", "beta2", "eps", "weight_decay",
                              "grad_clip_norm")}


def _starts(state, n_samples: int, batch: int) -> np.ndarray:
    """The window starts a loader draws from an rng in ``state``: uniform
    over the valid starts."""
    rng = np.random.Generator(np.random.PCG64())
    rng.bit_generator.state = state
    return rng.integers(0, n_samples, batch)


def run(run: harness.Run) -> None:
    import torch

    cfg, mix, dev = run.config, run.traffic, run.device
    batch, seq = int(mix["batch"]), int(mix["seq"])
    if batch != int(cfg["micro_batch_size"]) or seq > cfg["n_positions"]:
        raise ValueError(f"mix {run.cell.traffic_name} (B={batch}, S={seq})"
                         f" does not fit configuration {run.cell.config_name}")
    gen = run.module("generators", mix["generator"])
    tmp = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        path = gen.write(tmp / "train.bin", int(mix["tokens"]),
                         cfg["vocab_size"], run.seed)
        if run.control != "off":
            prog, states = _control(run, cfg, path, batch, seq)
        else:
            prog, states = _program(run, cfg, path, batch, seq)
        _check(run, cfg, path, batch, seq, prog, states)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _program(run, cfg, path, batch, seq):
    """Set-up, the checked first steps, the window and the traced steps
    of the program; returns its numbers for the check and the rng states
    its first batches were drawn from."""
    import torch
    from tnn_tpu_torch.data.loader import prefetch, stage_batch
    from tnn_tpu_torch.data.token_stream import TokenStreamDataLoader
    from tnn_tpu_torch.nn.optimizers import AdamW
    from tnn_tpu_torch.train.step import create_train_state, make_train_step

    dev = run.device
    if dev.type == "cuda":
        torch.empty(0, device=dev)          # the allocator, before its reset
        torch.cuda.reset_peak_memory_stats(dev)
    builder = run.module("builders", cfg["model_type"])
    model = builder.build(cfg, run.seed, dev, train=True)
    o = _opt_cfg(cfg)
    opt = AdamW(lr=o["lr"], beta1=o["beta1"], beta2=o["beta2"], eps=o["eps"],
                weight_decay=o["weight_decay"],
                grad_clip_norm=o["grad_clip_norm"])
    state = create_train_state(model, opt, seed=int(run.seed) % (1 << 63))
    step = make_train_step(model, opt, compute_accuracy=True)
    names = {n: ".".join(p) for n, p in state.jax_paths.items()}
    loader = TokenStreamDataLoader(str(path), seq)
    rng = np.random.default_rng([int(run.seed) % (1 << 63), 4])
    states, firsts = [], []

    def batches():
        while True:
            if len(states) < CHECK_STEPS:
                states.append(copy.deepcopy(rng.bit_generator.state))
            data, labels = loader.random_windows(batch, rng)
            if len(firsts) < CHECK_STEPS:
                firsts.append(np.asarray(data, np.int64).copy())
            yield data, labels

    def place(b):
        return tuple(t.long() for t in stage_batch(b, dev))

    feed = prefetch(batches(), to_device=place)
    losses, grad_norms = [], {}
    for i in range(CHECK_STEPS):
        data, labels = next(feed)
        state, m = step(state, data, labels)
        losses.append(float(m["loss"]))
        if i == 0:
            b1 = o["beta1"]
            grad_norms = {names[k]: float((v.double() / (1 - b1)).norm())
                          for k, v in state.opt_state["m"].items()}
    p0 = weights.make_gpt2(cfg, run.seed, dev)
    delta = {names[k]: (v.detach().float() - p0[names[k]]).cpu()
             for k, v in state.params.items()}
    del p0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    run.setup_done()

    t0 = time.perf_counter()
    n, wait = 0, 0.0
    while True:
        tw = time.perf_counter()
        if tw - t0 >= run.seconds:
            break
        data, labels = next(feed)
        wait += time.perf_counter() - tw
        state, m = step(state, data, labels)
        n += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    last = float(m["loss"]) if n else math.nan
    if run.traced:
        win = DeviceWindow(dev.type)
        win.start()
        for _ in range(TRACE_STEPS):
            data, labels = next(feed)
            state, m = step(state, data, labels)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        win.stop()
        run.trace = win.summary()
    feed.close()
    if dev.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    run.attempted = n
    run.failed = 0 if math.isfinite(last) else n
    run.data.update(steps=n, window_s=t1 - t0, data_wait_s=wait,
                    batch=batch, seq=seq, first_batches=firsts)
    del state, step, model, opt, feed, data, labels, m
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "grad": grad_norms, "delta": delta}, states


def _control(run, cfg, path, batch, seq):
    """A control or a planted fault in the program's place, on the
    windows a loader-drawn rng gives (no window: they read no time):
    "fp8", the reference with fp8 products; "frozen", a step that returns
    its state unchanged (each loss at the first weights, no gradient in
    the optimizer's state, no change); "half_batch", the reference over
    half of each batch, its mean taken over the rest."""
    import torch

    rng = np.random.default_rng([int(run.seed) % (1 << 63), 4])
    n_samples = len(np.memmap(path, dtype=np.uint16, mode="r")) - seq
    states = []
    for _ in range(CHECK_STEPS):
        states.append(copy.deepcopy(rng.bit_generator.state))
        rng.integers(0, n_samples, batch)       # the draw a loader makes
    run.setup_done()
    if run.control == "frozen":
        reference.exact_float32()
        p0 = weights.make_gpt2(cfg, run.seed, run.device)
        wins = _windows(run, path, batch, seq, states)
        out = {"losses": [reference.loss(p0, d, l, cfg) for _, d, l in wins],
               "grad": {k: torch.zeros_like(v) for k, v in p0.items()},
               "delta": {k: torch.zeros_like(v) for k, v in p0.items()}}
    elif run.control == "half_batch":
        out = _reference(run, cfg, path, batch, seq, states,
                         rows=batch // 2)
    else:
        out = _reference(run, cfg, path, batch, seq, states,
                         mm=reference.fp8_mm)
    run.data.update(steps=0, window_s=0.0, data_wait_s=0.0, batch=batch,
                    seq=seq)
    return out, states


def _windows(run, path, batch, seq, states):
    import torch

    gen = run.module("generators", run.traffic["generator"])
    n_samples = len(np.memmap(path, dtype=np.uint16, mode="r")) - seq
    out = []
    for st in states:
        d, l = gen.windows(path, _starts(st, n_samples, batch), seq)
        out.append((d, torch.from_numpy(d).to(run.device),
                    torch.from_numpy(l).to(run.device)))
    return out


def _reference(run, cfg, path, batch, seq, states, mm=reference.f32_mm,
               rows=None):
    """The reference's numbers over the first steps' windows (their first
    ``rows`` rows where given)."""
    reference.exact_float32()
    wins = _windows(run, path, batch, seq, states)
    p0 = weights.make_gpt2(cfg, run.seed, run.device)
    res = reference.train_steps(
        p0, [(d[:rows], l[:rows]) for _, d, l in wins], cfg, _opt_cfg(cfg),
        mm=mm)
    delta = {k: res["params"][k] - p0[k] for k in p0}
    return {"losses": res["losses"], "grad": res["first_grad"],
            "delta": delta}


def _check(run, cfg, path, batch, seq, prog, states) -> None:
    import torch

    ref = _reference(run, cfg, path, batch, seq, states)
    if run.control == "off":
        wins = _windows(run, path, batch, seq, states)
        firsts = run.data.pop("first_batches")
        run.check("batch_rows", sum(
            int((f != raw).any(axis=1).sum()) if f.shape == raw.shape
            else batch for f, (raw, _, _) in zip(firsts, wins)))
        del wins
    ref_grad = compare.leaf_norms(ref["grad"])
    prog_grad = prog["grad"] if run.control == "off" \
        else compare.leaf_norms(prog["grad"])
    keep = compare.kept_leaves(ref_grad)
    floor = compare.roundoff_floor(ref["grad"])
    run.check("loss", compare.loss_gap(prog["losses"], ref["losses"]))
    grad_gaps = compare.leaf_gaps(prog_grad, ref_grad, keep)
    update_gaps = compare.leaf_gaps(
        compare.change_norms(prog["delta"], ref["grad"], floor),
        compare.change_norms(ref["delta"], ref["grad"], floor), keep)
    grad_leaf = max(grad_gaps, key=grad_gaps.get)
    update_leaf = max(update_gaps, key=update_gaps.get)
    grad, update = grad_gaps[grad_leaf], update_gaps[update_leaf]
    run.info.update(grad_leaf=grad_leaf, update_leaf=update_leaf,
                    kept_leaves=len(keep),
                    grad_median_leaf=statistics.median(grad_gaps.values()),
                    update_median_leaf=statistics.median(
                        update_gaps.values()))
    run.check("grad", grad)
    run.check("update", update)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
