"""Port parity: ``serving/supervisor.py`` (``EngineSupervisor``) over the
port's engine, driven through ``run_sync`` / ``pump`` (and one threaded
``start()``), at the tiny size of ``tests/test_serving.py``.

- Drain: ``request_drain`` closes admissions (``ShuttingDown``), the work
  in flight finishes, the supervisor ends STOPPED with exit code 0 and a
  drain duration; a drain deadline already past times the stragglers out.
- Crash migration (JAX's ``TestCrashResumeExactness``): an engine crash at
  a prefill chunk, at decode and at a speculative draft step restarts the
  engine once, and every greedy stream, streamed and final, is
  byte-identical to an uninterrupted run, in both packages, and the two
  packages' streams are equal (FP32, tie-free prompts).
- The restart budget: crashes past ``max_restarts`` end FAILED with exit
  code 1 and every request terminal; a request past its migration budget
  fails as poison.
- The watchdog: a step slower than ``watchdog_step_s`` restarts the engine
  and leaves a "watchdog" flight dump.
- Exactly one terminal event per request on every path.
- The CLI on ``--device cpu`` under the supervisor: EOF drains and exits 0
  (with ``--watchdog-s``, ``--trace`` and ``--flight-dir``; a bad line
  gets an error event), and SIGTERM mid-stream drains and exits 0.
"""
import json
import os
import signal
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from tnn_tpu.core import dtypes as jdt
from tnn_tpu.models.gpt2 import GPT2 as JGPT2
from tnn_tpu.serving import EngineSupervisor as JSupervisor
from tnn_tpu.serving import InferenceEngine as JEngine
from tnn_tpu.serving.faults import FaultPlan as JPlan
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.serving.engine import InferenceEngine
from tnn_tpu_torch.serving.faults import FaultPlan
from tnn_tpu_torch.serving.scheduler import TERMINAL_STATES
from tnn_tpu_torch.serving.supervisor import (EngineSupervisor,
                                              ShuttingDown, SupervisorState)

TINY = dict(vocab_size=128, max_len=64, num_layers=2, d_model=32,
            num_heads=2)
KW = dict(num_blocks=32, block_size=4, max_batch_size=4, max_seq_len=32)
TERMINAL_EVENTS = ("done", "error", "cancelled", "timeout")
MARGIN = 1e-3
JOIN_S = 60.0


@pytest.fixture(scope="module")
def tiny():
    jm = JGPT2(**TINY, policy=jdt.FP32)
    params = jm.init(jax.random.PRNGKey(0), (1, 8))["params"]
    tm = GPT2(**TINY, policy=tdt.FP32, device="cpu", seed=None)
    tm.load_jax_params(jax.tree.map(np.asarray, params))
    return jm, params, tm


def _terminals(events):
    out = {}
    for e in events:
        if e["event"] in TERMINAL_EVENTS:
            assert e["id"] not in out, f"two terminal events for {e['id']}"
            out[e["id"]] = e
    return out


def _assert_drained(eng):
    assert all(r.state in TERMINAL_STATES for r in eng.requests.values())
    assert not eng.has_work and eng.in_flight is None
    assert eng.pool.num_allocated == 0
    eng.check_invariants()


def _sup(eng, events, **kw):
    return EngineSupervisor(eng, event_sink=events.append,
                            restart_backoff_s=0.0, **kw)


def _tie_free(tm, prompts, outs):
    for prompt, out in zip(prompts, outs):
        seq = np.concatenate([prompt, out[:-1]]).astype(np.int64)
        with torch.inference_mode():
            logits = tm(torch.from_numpy(seq)[None])[0, len(prompt) - 1:]
        top2 = logits.topk(2, dim=-1).values
        assert (top2[:, 0] - top2[:, 1]).min() > MARGIN
        assert logits.argmax(-1).tolist() == list(out)


# -- drain --------------------------------------------------------------------

@pytest.mark.parametrize("overlap", [False, True])
def test_drain_finishes_in_flight_and_refuses_new_work(tiny, overlap):
    _, _, tm = tiny
    eng = InferenceEngine(tm, device="cpu", overlap=overlap, **KW)
    events = []
    sup = _sup(eng, events)
    rng = np.random.default_rng(0)
    rids = [sup.submit(rng.integers(0, 128, 6), 6) for _ in range(3)]
    sup.pump(2)
    sup.request_drain("test")
    assert sup.draining
    with pytest.raises(ShuttingDown, match="draining"):
        sup.submit([1, 2, 3], 4)
    sup.run_sync()
    assert sup.state is SupervisorState.STOPPED and sup.exit_code == 0
    assert sup.drain_duration_s is not None and sup.drain_duration_s >= 0
    assert eng.metrics.drain_duration_s == sup.drain_duration_s
    term = _terminals(events)
    assert sorted(term) == sorted(rids)
    assert all(term[r]["event"] == "done" for r in rids)
    assert all("latency_breakdown" in term[r] and term[r]["trace_id"]
               for r in rids)
    with pytest.raises(ShuttingDown, match="stopped"):
        sup.submit([1, 2, 3], 4)
    _assert_drained(eng)


def test_drain_deadline_times_out_stragglers(tiny):
    _, _, tm = tiny
    eng = InferenceEngine(tm, device="cpu", **KW)
    events = []
    sup = _sup(eng, events, drain_deadline_s=1e-9)
    rids = [sup.submit(np.arange(1, 7), 20) for _ in range(2)]
    sup.pump(2)
    sup.request_drain()
    sup.run_sync()
    term = _terminals(events)
    assert [term[r]["event"] for r in rids] == ["timeout", "timeout"]
    assert "drain deadline" in term[rids[0]]["reason"]
    assert sup.state is SupervisorState.STOPPED and sup.exit_code == 0
    _assert_drained(eng)


# -- crash migration, in both packages ----------------------------------------

def _cyclic_prompts(n, seed=0, vocab=128):
    # test_serving.py's
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        motif = rng.integers(0, vocab, int(rng.integers(2, 5)))
        out.append(np.tile(motif, int(rng.integers(3, 6))).astype(np.int32))
    return out


def _crash_case(site):
    """(engine kwargs, prompts, crash step) of JAX's
    TestCrashResumeExactness, with prompt seeds tie-free on the FP32
    model (JAX's own seeds give near-ties here)."""
    if site == "spec_draft":
        return dict(spec="ngram", spec_k=3), _cyclic_prompts(2, seed=3), 4
    if site == "prefill_chunk":
        rng = np.random.default_rng(6)
        return dict(chunk_size=4), [rng.integers(0, 128, n).astype(np.int32)
                                    for n in (10, 9)], 2
    rng = np.random.default_rng(6)
    return {}, [rng.integers(0, 128, n).astype(np.int32)
                for n in (5, 7)], 4


def _crash_run(eng_factory, sup_cls, plan, prompts, max_new=6):
    eng = eng_factory(plan)
    events = []
    sup = sup_cls(eng, event_sink=events.append, restart_backoff_s=0.0,
                  max_restarts=2)
    rids = [sup.submit(p, max_new) for p in prompts]
    sup.run_sync()
    term = {e["id"]: e for e in events if e["event"] != "token"}
    streams = [[e["token"] for e in events
                if e["event"] == "token" and e["id"] == r] for r in rids]
    return eng, sup, [term[r] for r in rids], streams


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("site", ["prefill_chunk", "decode", "spec_draft"])
def test_crash_resume_token_exact_in_both_packages(tiny, site, overlap):
    jm, params, tm = tiny
    kw, prompts, crash_at = _crash_case(site)
    kw = {**KW, **kw, "decode_path": "paged", "overlap": overlap}
    runs = {}
    for name, factory, sup_cls, plan_cls in (
            ("port", lambda p: InferenceEngine(tm, device="cpu", faults=p,
                                               **kw),
             EngineSupervisor, FaultPlan),
            ("jax", lambda p: JEngine(jm, params, faults=p, **kw),
             JSupervisor, JPlan)):
        _, _, ref, ref_streams = _crash_run(factory, sup_cls, None, prompts)
        plan = plan_cls(step_crash_calls=(crash_at,))
        eng, sup, term, streams = _crash_run(factory, sup_cls, plan, prompts)
        assert sup.restarts == 1 and plan.fired["engine.step"] == 1
        assert eng.metrics.migrated_requests >= 1
        assert [t["event"] for t in term] == ["done"] * len(prompts)
        assert [t["tokens"] for t in term] == [r["tokens"] for r in ref]
        assert streams == ref_streams == [r["tokens"] for r in ref]
        assert eng.pool.num_allocated == 0
        runs[name] = [t["tokens"] for t in term]
    _tie_free(tm, prompts, runs["port"])
    assert runs["port"] == runs["jax"]
    assert sum(t["latency_breakdown"]["migrations"] for t in term) >= 1


# -- the restart budget, poison requests, the watchdog ------------------------

def test_restart_budget_exhaustion_fails_everything(tiny, tmp_path):
    _, _, tm = tiny
    plan = FaultPlan(step_crash_calls=(2, 3, 4))
    eng = InferenceEngine(tm, device="cpu", faults=plan, **KW)
    events = []
    sup = _sup(eng, events, max_restarts=2, flight_dir=str(tmp_path))
    rids = [sup.submit(np.arange(1, 6), 8) for _ in range(3)]
    sup.run_sync()
    assert sup.state is SupervisorState.FAILED and sup.exit_code == 1
    assert sup.restarts == 3
    term = _terminals(events)
    assert sorted(term) == sorted(rids)
    assert all(term[r]["event"] == "error" for r in rids)
    assert "restart budget exhausted" in term[rids[0]]["reason"]
    reasons = [os.path.basename(p).split("_", 2)[2] for p in sup.flight_dumps]
    assert reasons == ["crash.jsonl"] * 3 + ["restart_budget.jsonl"]
    with pytest.raises(ShuttingDown, match="failed"):
        sup.submit([1, 2], 2)
    _assert_drained(eng)


def test_migration_budget_fails_the_poison_request(tiny):
    _, _, tm = tiny
    plan = FaultPlan(step_crash_calls=(3, 5))
    eng = InferenceEngine(tm, device="cpu", faults=plan, **KW)
    events = []
    sup = _sup(eng, events, max_restarts=5)
    poison = sup.submit(np.arange(1, 6), 10, migration_budget=1)
    fine = sup.submit(np.arange(3, 9), 10)
    sup.run_sync()
    term = _terminals(events)
    assert term[poison]["event"] == "error"
    assert "migration budget exhausted" in term[poison]["reason"]
    assert term[fine]["event"] == "done"
    assert term[fine]["latency_breakdown"]["migrations"] == 2
    assert sup.state is SupervisorState.RUNNING and sup.restarts == 2
    _assert_drained(eng)


@pytest.mark.parametrize("overlap", [False, True])
def test_watchdog_trips_restart_and_dumps(tiny, tmp_path, overlap):
    _, _, tm = tiny
    # a threshold far above a tiny step, even on a loaded host
    plan = FaultPlan(step_delay_s=2.0, step_delay_calls=(3,))
    eng = InferenceEngine(tm, device="cpu", faults=plan, overlap=overlap,
                          **KW)
    events = []
    sup = _sup(eng, events, watchdog_step_s=1.5, flight_dir=str(tmp_path))
    rids = [sup.submit(np.arange(2, 8), 6) for _ in range(2)]
    sup.run_sync()
    assert sup.restarts == 1 and eng.metrics.engine_restarts == 1
    dumps = [os.path.basename(p) for p in sup.flight_dumps]
    assert dumps == ["flight_001_watchdog.jsonl"]
    with open(sup.flight_dumps[0]) as f:
        meta = json.loads(f.readline())
    assert meta["reason"] == "watchdog" and meta["records"] >= 1
    term = _terminals(events)
    assert all(term[r]["event"] == "done" for r in rids)
    _assert_drained(eng)


def test_one_terminal_event_per_request_on_every_path(tiny):
    """Finished, cancelled, shed, timed out and crash-failed requests each
    get exactly one terminal event, whichever path ended them."""
    _, _, tm = tiny
    plan = FaultPlan(nan_logit_calls=(3,))
    eng = InferenceEngine(tm, device="cpu", faults=plan, max_queue_depth=2,
                          **KW)
    events = []
    sup = _sup(eng, events)
    a = sup.submit(np.arange(1, 6), 6)
    b = sup.submit(np.arange(2, 7), 6, priority=5)
    c = sup.submit(np.arange(3, 8), 6)       # sheds b
    sup.pump(1)
    d = sup.submit(np.arange(4, 9), 6, deadline_s=1e-9)
    e = sup.submit(np.arange(5, 10), 20)
    assert sup.cancel(e)
    assert not sup.cancel(e)
    sup.run_sync()
    term = _terminals(events)
    assert sorted(term) == sorted([a, b, c, d, e])
    kinds = {k: v["event"] for k, v in term.items()}
    assert kinds[b] == "error" and "shed" in term[b]["reason"]
    assert kinds[d] == "timeout" and kinds[e] == "cancelled"
    assert list(kinds.values()).count("error") == 2      # shed + NaN row
    _assert_drained(eng)


def test_started_supervisor_serves_threads_and_drains(tiny):
    """``start()``: the engine steps on the worker thread, submits and
    stats marshal through the command queue, a drain from this thread
    ends the worker; every wait has a timeout."""
    _, _, tm = tiny
    eng = InferenceEngine(tm, device="cpu", overlap=True, **KW)
    events, done = [], threading.Event()
    want = 4

    def sink(ev):
        events.append(ev)
        if sum(e["event"] in TERMINAL_EVENTS for e in events) == want:
            done.set()

    sup = EngineSupervisor(eng, event_sink=sink, idle_wait_s=0.01).start()
    with pytest.raises(RuntimeError, match="already started"):
        sup.start()
    with pytest.raises(RuntimeError, match="unstarted"):
        sup.run_sync()
    rids = [sup.submit(np.arange(i + 1, i + 7), 5) for i in range(want)]
    assert done.wait(JOIN_S)
    st = sup.stats()
    assert st["supervisor_state"] == "running" and st["finished"] == want
    assert sup.health_gauges()["queue_depth"] == 0
    sup.request_drain("test")
    assert sup.join(JOIN_S)
    assert sup.state is SupervisorState.STOPPED and sup.exit_code == 0
    term = _terminals(events)
    assert sorted(term) == sorted(rids)
    assert all(term[r]["event"] == "done" for r in rids)
    _assert_drained(eng)


# -- the supervised CLI -------------------------------------------------------

CLI = [sys.executable, "-m", "tnn_tpu_torch.cli.serve", "--model", "gpt2_tiny",
       "--device", "cpu", "--num-blocks", "16"]


def test_cli_eof_drains_with_trace_and_flight_dir(tmp_path):
    """EOF drains: every accepted line gets one terminal event, a bad line
    an error event, the trace and the drain's flight dump are written,
    and the process exits 0."""
    lines = [json.dumps({"id": "a", "tokens": [1, 2, 3], "max_new_tokens": 4}),
             "not json",
             json.dumps({"id": "b", "tokens": [5, 6], "max_new_tokens": 3})]
    trace, flight = tmp_path / "t.json", tmp_path / "fd"
    proc = subprocess.run(
        CLI + ["--watchdog-s", "600", "--max-restarts", "1",
               "--migration-budget", "2", "--drain-deadline-s", "60",
               "--trace", str(trace), "--flight-dir", str(flight)],
        input="\n".join(lines) + "\n", capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    events = [json.loads(x) for x in proc.stdout.splitlines()]
    term = _terminals([e for e in events if "id" in e])
    assert {k: v["event"] for k, v in term.items()} == {"a": "done",
                                                       "b": "done"}
    assert [e for e in events if "id" not in e][0]["event"] == "error"
    with open(trace) as f:
        names = {e["name"].split(" ")[0] for e in json.load(f)["traceEvents"]}
    assert {"serve.submit", "serve.finish", "serve.mixed"} <= names
    assert sorted(os.listdir(flight)) == ["flight_001_drain.jsonl"]
    assert '"supervisor_state": "stopped"' in proc.stderr


def test_cli_sigterm_drains_and_exits_zero():
    """SIGTERM mid-stream with stdin still open: the request in flight
    finishes (one terminal event) and the process exits 0."""
    proc = subprocess.Popen(CLI, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.append(
        proc.stdout.readline()), daemon=True)
    try:
        proc.stdin.write(json.dumps({"id": "x", "tokens": [1, 2, 3],
                                     "max_new_tokens": 40}) + "\n")
        proc.stdin.flush()
        reader.start()
        reader.join(JOIN_S)
        first = json.loads(lines[0])
        assert first["event"] == "token" and first["id"] == "x"
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == 0, err
    events = [first] + [json.loads(x) for x in out.splitlines()]
    term = _terminals(events)
    assert list(term) == ["x"] and term["x"]["event"] == "done"
    assert len(term["x"]["tokens"]) == 40
    assert "SIGTERM" not in out and '"supervisor_state": "stopped"' in err
