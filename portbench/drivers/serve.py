"""Serving driver: the program's supervised engine, as its serving front
end builds it (``serving.supervisor.EngineSupervisor`` over one
``serving.engine.InferenceEngine`` with the overlapped loop), fed by a
client inside this process.

Set-up makes the weights from the seed, builds the engine from the
configuration's ``serving`` entry and warms it with one burst of the
mix's shapes: a full batch of prompts across the mix's prompt lengths,
so that the kernels build, the mixed programs run and the pure-decode
program's graph is captured. The window then offers the mix's load for
``seconds``: a closed loop of clients, or open arrivals at a fixed rate.
Every request goes in through ``EngineSupervisor.submit`` with a
listener that stamps the host time of each event as the client sees it.
A closed window cancels what is still open when it closes; an open one
waits for every request it sent, a minute past the close at most.

Once the engine is gone, a sample of the finished requests drawn from
the seed, the longest among them, goes to the plain reference
(``compare.served_gaps``); the mean of the served tokens' gaps is
compared. Each served request must also carry exactly the tokens it
asked for.

``run.data`` keys for the readers: ``requests`` (list of ``Rec``),
``t0`` / ``window_end`` (the window), ``t1`` (the end of the wait past
it), ``window_tokens`` (tokens that reached the client inside the
window), ``counters_end`` with ``steps_before`` / ``steps_after`` (the
engine's ``program_steps`` at ``t0`` and at ``counters_end``), ``ticks``
(the engine's profiler ticks as (time, key, value), traced runs) and
``trace_steps`` (model steps inside the traced sub-window). In a traced
run the counters stop where the profiler starts, late in the window, so
that the profiler's own cost, and the backlog it leaves, stay out of
them; ``counters_end`` is the window's end otherwise.
"""
from __future__ import annotations

import functools
import gc
import math
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from portbench import compare, harness, weights
from portbench.devtrace import DeviceWindow
from portbench.reference import gpt2 as reference

# the traced sub-window: where it starts in the window, and how long
TRACE_AT = 0.8
TRACE_S = 1.0
# how long an open window waits past its close for the requests it sent
WAIT_S = 60.0
# requests the reference reads
CHECK_REQUESTS = 64


@dataclass
class Rec:
    prompt: np.ndarray
    out_len: int
    t_sched: float
    rid: Optional[int] = None
    t_first: Optional[float] = None
    t_last: Optional[float] = None
    n: int = 0
    win_lo: Optional[int] = None      # first token index inside the window
    win_hi: int = 0                   # one past the last
    state: Optional[str] = None       # the terminal event's name
    tokens: Optional[List[int]] = None
    t_done: Optional[float] = None


def _recording_profiler():
    from tnn_tpu_torch.profiling.profiler import Profiler

    class TickRecorder(Profiler):
        """The engine's profiler, keeping every tick with its time."""

        def __init__(self):
            super().__init__(source="engine")
            self.ticks = []

        def tick(self, key, seconds):
            super().tick(key, seconds)
            self.ticks.append((time.perf_counter(), key, seconds))

    return TickRecorder()


class Client:
    """The in-process client: submits, stamps events, keeps the loop."""

    def __init__(self, sup, plan, closed: bool):
        self.sup = sup
        self.plan = plan
        self.closed = closed
        self.next = 0
        self.recs: List[Rec] = []
        self.open = 0
        self.t0 = self.t_end = math.inf
        self.stopping = False
        self.window_tokens = 0
        self.errors: List[str] = []
        self.lock = threading.Lock()

    def submit(self, t_sched: Optional[float] = None) -> None:
        """Send the plan's next request (on the engine's worker)."""
        if self.next >= len(self.plan):
            self.errors.append("the plan ran out of requests")
            return
        req = self.plan[self.next]
        self.next += 1
        rec = Rec(req.prompt, req.out_len,
                  time.perf_counter() if t_sched is None else t_sched)
        self.recs.append(rec)
        with self.lock:
            self.open += 1
        try:
            rec.rid = self.sup.submit(
                req.prompt, req.out_len,
                listener=functools.partial(self.on_event, rec))
        except Exception as e:  # noqa: BLE001 — refused: counted failed
            rec.state = "refused"
            rec.t_done = time.perf_counter()
            self.errors.append(f"{type(e).__name__}: {e}")
            with self.lock:
                self.open -= 1

    def on_event(self, rec: Rec, ev: dict) -> None:
        t = time.perf_counter()
        if ev["event"] == "token":
            if rec.t_first is None:
                rec.t_first = t
            rec.t_last = t
            if self.t0 <= t <= self.t_end:
                if rec.win_lo is None:
                    rec.win_lo = rec.n
                rec.win_hi = rec.n + 1
                self.window_tokens += 1
            rec.n += 1
            return
        rec.state = ev["event"]
        rec.t_done = t
        rec.tokens = ev.get("tokens")
        with self.lock:
            self.open -= 1
        if self.closed and not self.stopping and t < self.t_end:
            try:
                self.submit()
            except Exception as e:  # noqa: BLE001 — the listener must not raise
                self.errors.append(f"{type(e).__name__}: {e}")

    def wait_idle(self, timeout: float) -> bool:
        end = time.perf_counter() + timeout
        while time.perf_counter() < end:
            with self.lock:
                if self.open == 0:
                    return True
            time.sleep(0.005)
        return False


def _warm_up(sup, engine, cfg, mix, seed) -> None:
    """One burst of the mix's shapes: a full batch of prompts across its
    prompt lengths, a few tokens each, then waits for all of them."""
    rows = int(cfg["serving"]["max_batch_size"])
    lo, hi = int(mix["prompt_len"]["min"]), int(mix["prompt_len"]["max"])
    rng = np.random.default_rng([int(seed) % (1 << 63), 5])
    done = threading.Event()
    left = [rows]

    def listen(ev):
        if ev["event"] != "token":
            left[0] -= 1
            if left[0] == 0:
                done.set()

    def burst():
        for n in np.linspace(lo, hi, rows).astype(int):
            sup.submit(rng.integers(0, cfg["vocab_size"], int(n),
                                    dtype=np.int32), 8, listener=listen)

    sup.execute(burst)
    if not done.wait(600):
        raise RuntimeError("the warm-up burst did not finish")


def _snapshot(engine) -> dict:
    return dict(engine.program_steps)


def run(run: harness.Run) -> None:
    import torch
    from tnn_tpu_torch.serving.engine import InferenceEngine
    from tnn_tpu_torch.serving.supervisor import EngineSupervisor

    cfg, mix, dev = run.config, run.traffic, run.device
    srv = cfg["serving"]
    plan = run.module("generators", mix["generator"]).plan(
        mix, run.seed, run.seconds, cfg["vocab_size"])
    closed = mix["arrivals"]["kind"] == "closed"
    control = cfg["control"][run.control] if run.control != "off" else {}
    builder = run.module("builders", cfg["model_type"])
    if dev.type == "cuda":
        torch.empty(0, device=dev)          # the allocator, before its reset
        torch.cuda.reset_peak_memory_stats(dev)
    model = builder.build(cfg, run.seed, dev)
    prof = _recording_profiler() if run.traced else None
    engine = InferenceEngine(
        model, num_blocks=srv["num_blocks"], block_size=srv["block_size"],
        max_batch_size=srv["max_batch_size"],
        token_budget=srv["token_budget"], chunk_size=srv["chunk_size"],
        prefix_cache=srv["prefix_cache"], decode_path=srv["decode_path"],
        overlap=srv["overlap"], seed=int(run.seed) % (1 << 63),
        kv_dtype=control.get("kv_dtype", "f32"),
        quant_weights=control.get("quant_weights", False),
        profiler=prof, device=dev)
    sup = EngineSupervisor(engine, drain_deadline_s=None).start()
    client = Client(sup, plan, closed)
    window = DeviceWindow(dev.type) if run.traced else None
    trace_marks = {}
    try:
        _warm_up(sup, engine, cfg, mix, run.seed)
        steps_before = sup.execute(lambda: _snapshot(engine))
        run.setup_done()
        t0 = time.perf_counter()
        client.t0, client.t_end = t0, t0 + run.seconds
        todo = []          # (time, action) in order
        if window is not None:
            ts = t0 + TRACE_AT * run.seconds
            todo += [(ts, "trace_start"),
                     (ts + min(TRACE_S, 0.3 * run.seconds), "trace_stop")]
        if closed:
            clients = int(mix["arrivals"]["clients"])
            sup.execute(lambda: [client.submit() for _ in range(clients)])
        else:
            todo += [(t0 + r.at, i) for i, r in enumerate(plan)]
        todo.sort(key=lambda a: a[0])
        late = 0.0
        k = 0
        while k < len(todo):
            now = time.perf_counter()
            if todo[k][0] > now:
                time.sleep(min(todo[k][0] - now, 0.05))
                continue
            due = []
            while k < len(todo) and todo[k][0] <= now:
                due.append(todo[k])
                k += 1
            sends = [a for a in due if not isinstance(a[1], str)]
            if sends:
                late = max(late, now - sends[0][0])

                def send(items=sends):
                    for t_sched, _ in items:
                        client.submit(t_sched)

                sup.execute(send)
            for t_at, action in due:
                if action == "trace_start":
                    trace_marks["start"] = sup.execute(
                        lambda: (time.perf_counter(), _snapshot(engine),
                                 window.start())[:2])
                elif action == "trace_stop":
                    trace_marks["stop"] = sup.execute(
                        lambda: (window.stop(), _snapshot(engine))[1])
        now = time.perf_counter()
        if now < client.t_end:
            time.sleep(client.t_end - now)
        client.stopping = True
        if closed:
            sup.execute(lambda: [engine.cancel(r.rid) for r in client.recs
                                 if r.state is None and r.rid is not None])
            client.wait_idle(WAIT_S)
        elif not client.wait_idle(WAIT_S):
            sup.execute(lambda: [engine.cancel(r.rid) for r in client.recs
                                 if r.state is None and r.rid is not None])
            client.wait_idle(WAIT_S)
        t1 = time.perf_counter()
        steps_after = sup.execute(lambda: _snapshot(engine))
    finally:
        sup.request_drain("window closed")
        sup.join(120)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    sup.release()
    del sup, engine, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    recs = client.recs
    sent = [r for r in recs if r.t_sched <= client.t_end]
    cut = "cancelled" if closed else None
    run.attempted = len(sent)
    run.failed = sum(1 for r in sent if r.state not in ("done", cut))
    run.info.update(
        completed_per_s=sum(1 for r in recs if r.state == "done"
                            and client.t0 <= r.t_done <= client.t_end)
        / run.seconds, sender_late_s=late,
        client_errors=client.errors[:3])
    counters_end = client.t_end
    if "start" in trace_marks:
        counters_end, steps_after = trace_marks["start"]
    run.data.update(requests=sent, t0=client.t0, t1=t1,
                    window_end=client.t_end,
                    window_tokens=client.window_tokens,
                    counters_end=counters_end,
                    steps_before=steps_before, steps_after=steps_after)
    if prof is not None:
        run.data["ticks"] = list(prof.ticks)
    if window is not None and "stop" in trace_marks:
        run.trace = window.summary()
        run.data["trace_steps"] = sum(trace_marks["stop"].values()) - sum(
            trace_marks["start"][1].values())
    _check(run, cfg, sent)


def _check(run: harness.Run, cfg: dict, sent: List[Rec]) -> None:
    """The mean gap over a seeded sample of finished requests (the
    longest among them) against the plain reference, and the count of
    finished requests that did not carry every token they asked for."""
    import torch

    done = [r for r in sent if r.state == "done"]
    short = sum(1 for r in done
                if r.tokens is None or len(r.tokens) != r.out_len)
    run.check("short_answers", short)
    if not done:
        run.check("gap_mean", math.inf)
        return
    rng = np.random.default_rng([int(run.seed) % (1 << 63), 6])
    longest = max(range(len(done)),
                  key=lambda i: len(done[i].prompt) + done[i].out_len)
    others = [i for i in range(len(done)) if i != longest]
    pick = [longest] + list(rng.choice(
        others, min(CHECK_REQUESTS - 1, len(others)), replace=False))
    reference.exact_float32()
    p = weights.make_gpt2(cfg, run.seed, run.device)
    served = [(done[i].prompt.tolist(), done[i].tokens) for i in pick
              if done[i].tokens]
    gaps = compare.served_gaps(p, cfg, served, run.device)
    del p
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    run.info.update(checked_tokens=int(gaps.numel()),
                    gap_max=float(gaps.max()) if gaps.numel() else 0.0,
                    flip_share=float((gaps > 0).double().mean())
                    if gaps.numel() else 0.0)
    run.check("gap_mean", float(gaps.mean()) if gaps.numel() else math.inf)
