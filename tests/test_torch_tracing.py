"""Port parity: request-scoped tracing (``serving/tracing.py``, the engine's
instants and ``profiled`` spans), the flight recorder and the profiler
(``profiling/profiler.py``), at the tiny size of ``tests/test_serving.py``.

- A traced engine is token-exact against an untraced one.
- On the same synchronous traffic (shared prefixes that publish and match,
  a preemption, a crash the supervisor recovers) the port's engine and
  supervisor record the same multiset of instant names and of span names
  as the JAX package's.
- Flight records carry the JAX engine's keys (and each program's); the last
  record of a crash dump names the dying step with ``crashed=True``.
- ``Profiler.merge`` (with its clock rebase), ``to_dict`` / ``from_dict``,
  ``summary`` and ``to_chrome_trace`` give what JAX's give on the same
  events.
"""
import collections
import json
import os

import jax
import numpy as np
import pytest

from tnn_tpu.core import dtypes as jdt
from tnn_tpu.models.gpt2 import GPT2 as JGPT2
from tnn_tpu.profiling import profiler as jprof
from tnn_tpu.serving import EngineSupervisor as JSupervisor
from tnn_tpu.serving import InferenceEngine as JEngine
from tnn_tpu.serving.faults import FaultPlan as JPlan
from tnn_tpu.serving.tracing import FlightRecorder as JFlight
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.profiling import profiler as tprof
from tnn_tpu_torch.serving.engine import InferenceEngine
from tnn_tpu_torch.serving.faults import FaultPlan
from tnn_tpu_torch.serving.supervisor import EngineSupervisor
from tnn_tpu_torch.serving.tracing import FlightRecorder, Tracer, span_name

TINY = dict(vocab_size=128, max_len=64, num_layers=2, d_model=32,
            num_heads=2)
# a small pool: the traffic preempts
KW = dict(num_blocks=12, block_size=4, max_batch_size=4, max_seq_len=32)


@pytest.fixture(scope="module")
def tiny():
    jm = JGPT2(**TINY, policy=jdt.FP32)
    params = jm.init(jax.random.PRNGKey(0), (1, 8))["params"]
    tm = GPT2(**TINY, policy=tdt.FP32, device="cpu", seed=None)
    tm.load_jax_params(jax.tree.map(np.asarray, params))
    return jm, params, tm


def _prompts():
    # a shared 8-token prefix (publishes, then matches)
    base = (np.arange(16) * 5 % 128).astype(np.int32)
    return [base[:12], base[:9], base[:10] + 1,
            np.concatenate([base[:8], base[:4] + 1]).astype(np.int32)]


def _serve(eng, sup_cls, max_new=8):
    events = []
    sup = sup_cls(eng, event_sink=events.append, restart_backoff_s=0.0)
    prompts = _prompts()
    rids = [sup.submit(prompts[0], max_new)]
    sup.pump(2)           # the first request publishes its prefix
    rids += [sup.submit(p, max_new) for p in prompts[1:]]
    sup.run_sync()
    return sup, rids, events


def _names(profiler, instants):
    return collections.Counter(
        ev.name.split(" ")[0] for ev in profiler.events
        if (ev.start == ev.end) == instants)


def test_traced_equals_untraced(tiny):
    _, _, tm = tiny
    outs = []
    for trace in (False, True):
        eng = InferenceEngine(tm, device="cpu", trace=trace, **KW)
        _, rids, events = _serve(eng, EngineSupervisor)
        outs.append([[e["tokens"] for e in events
                      if e["event"] == "done" and e["id"] == r] for r in rids])
        assert (eng.profiler is not None) == trace
    assert outs[0] == outs[1] and all(len(x) == 1 for x in outs[0])


def test_instant_and_span_names_match_jax(tiny):
    """The same synchronous traffic with one crash (step 6) through both
    packages' supervisors: the same instants (serve.submit, admit,
    prefill_chunk, first_token, publish, preempt, migrate, finish,
    terminal, host_gap, sup.admit, sup.restart) and spans (serve.mixed,
    serve.decode_paged, serve.fetch), each the same number of times."""
    jm, params, tm = tiny
    jeng = JEngine(jm, params, trace=True, faults=JPlan(step_crash_calls=(6,)),
                   **KW)
    teng = InferenceEngine(tm, device="cpu", trace=True,
                           faults=FaultPlan(step_crash_calls=(6,)), **KW)
    (jsup, jrids, jev), (tsup, trids, tev) = (
        _serve(jeng, JSupervisor), _serve(teng, EngineSupervisor))
    assert tsup.restarts == jsup.restarts == 1
    tin, jin = _names(teng.profiler, True), _names(jeng.profiler, True)
    for name in ("serve.submit", "serve.admit", "serve.prefill_chunk",
                 "serve.first_token", "serve.publish", "serve.preempt",
                 "serve.migrate", "serve.finish", "serve.host_gap",
                 "sup.admit", "sup.restart"):
        assert tin[name] >= 1, name
    assert tin == jin
    assert _names(teng.profiler, False) == _names(jeng.profiler, False)
    assert [e["event"] for e in tev] == [e["event"] for e in jev]
    # names encode their attributes: "serve.finish trace=t0 rid=0 ..."
    finish = [ev.name for ev in teng.profiler.events
              if ev.name.startswith("serve.finish")]
    assert finish[0].startswith("serve.finish trace=t")
    assert "serve.engine_restarts" in teng.profiler.counters


def test_flight_records_carry_jax_keys_and_crash_marks_last(tiny, tmp_path):
    jm, params, tm = tiny
    jeng = JEngine(jm, params, faults=JPlan(step_crash_calls=(4,),
                                            nan_logit_calls=(2,)), **KW)
    teng = InferenceEngine(tm, device="cpu", faults=FaultPlan(
        step_crash_calls=(4,), nan_logit_calls=(2,)), **KW)
    dumps = []
    for eng, cls in ((jeng, JSupervisor), (teng, EngineSupervisor)):
        events = []
        sup = cls(eng, event_sink=events.append, restart_backoff_s=0.0,
                  flight_dir=str(tmp_path / cls.__module__))
        for p in _prompts():
            sup.submit(p, 6)
        sup.run_sync()
        recs = sup.flight.records()
        assert recs and eng.last_step_record() is not None
        dumps.append((sup, recs))
    (jsup, jrecs), (tsup, trecs) = dumps
    assert [set(r) for r in trecs] == [set(r) for r in jrecs]
    prog_keys = {k for r in trecs for p in r["programs"] for k in p}
    assert prog_keys == {k for r in jrecs for p in r["programs"] for k in p}
    assert [r["faults_fired"] for r in trecs] == \
        [r["faults_fired"] for r in jrecs]
    assert [[p["kind"] for p in r["programs"]] for r in trecs] == \
        [[p["kind"] for p in r["programs"]] for r in jrecs]
    path = next(p for p in tsup.flight_dumps if p.endswith("_crash.jsonl"))
    with open(path) as f:
        lines = [json.loads(x) for x in f]
    assert lines[0]["kind"] == "flight_recorder_meta"
    assert lines[0]["reason"] == "crash"
    last = lines[-1]
    assert last["crashed"] is True and "EngineCrash" in last["error"]
    assert last["faults_fired"] == {"engine.step": 1}
    assert [os.path.basename(p) for p in tsup.flight_dumps] == \
        [os.path.basename(p) for p in jsup.flight_dumps]


def test_flight_recorder_ring_and_dump(tmp_path):
    for cls in (FlightRecorder, JFlight):
        fr = cls(capacity=3)
        for i in range(5):
            fr.record({"step_seq": i})
        fr.record(None)
        assert len(fr) == 3 and [r["step_seq"] for r in fr.records()] == \
            [2, 3, 4]
        path = fr.dump(str(tmp_path / f"{cls.__module__}.jsonl"), "test",
                       extra={"restarts": 1})
        with open(path) as f:
            lines = [json.loads(x) for x in f]
        meta = lines[0]
        assert (meta["records"], meta["total_steps_seen"], meta["restarts"],
                meta["capacity"]) == (3, 5, 1, 3)
        assert fr.dumps == 1
        with pytest.raises(ValueError, match="capacity"):
            cls(capacity=0)
    assert span_name("a", x=1, y=None) == "a x=1"
    assert not Tracer().enabled


def _events(mod, source, shift):
    p = mod.Profiler(source=source)
    p._origin = 100.0 + shift
    T = mod.EventType
    for i, (t, name) in enumerate([(T.COMPUTE, "serve.mixed"),
                                   (T.DATA, "load"), (T.OTHER, "mark"),
                                   (T.COMMUNICATION, "psum")]):
        p.add_event(t, 0.5 * i, 0.5 * i + 0.25 * (i % 3), name)
    p.tick("serve.ttft_s", 0.125)
    p.tick("serve.ttft_s", 0.25)
    return p


def test_profiler_merge_and_chrome_trace_match_jax(tmp_path):
    out = []
    for mod in (tprof, jprof):
        a, b = _events(mod, "engine", 0.0), _events(mod, "router", -3.0)
        a.merge(b)
        a.merge(a)                      # self-merge is a no-op
        path = str(tmp_path / f"{mod.__name__}.json")
        trace = a.to_chrome_trace(path)
        with open(path) as f:
            assert json.load(f) == {"traceEvents": trace}
        again = mod.Profiler.from_dict(json.loads(json.dumps(a.to_dict())))
        assert again.to_dict() == a.to_dict()
        out.append((trace, a.summary(), a.counters, a.to_dict()))
    assert out[0] == out[1]
    assert out[0][2] == {"serve.ttft_s": 0.75}
    # profiled: a no-op unless enabled or given a profiler
    p = tprof.Profiler()
    with tprof.profiled("x"):
        pass
    with tprof.profiled("y", profiler=p):
        pass
    assert [e.name for e in p.events] == ["y"]
    tprof.enable(True)
    try:
        with tprof.profiled("z"):
            pass
        assert tprof.GlobalProfiler.events[-1].name == "z"
    finally:
        tprof.enable(False)
        tprof.GlobalProfiler.clear()


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with tprof.device_trace(str(tmp_path / "dev")):
        sum(range(1000))
    with open(tmp_path / "dev" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
