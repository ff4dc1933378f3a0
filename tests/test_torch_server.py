"""Port parity: the HTTP/SSE front end (``serving/server.py``) and the
fleet flags of ``cli.serve``, against the JAX package's.

A JAX stack and a port stack (tiny FP32 engines on the CPU under their
supervisors, each server on its own event-loop thread, ports picked by
binding ``127.0.0.1:0``) get the same raw-socket requests; status codes
and payloads are compared with the wall-clock fields (``ttft_ms``,
``latency_breakdown``, ``uptime_s``) left out:

- ``GET /v1/health`` and ``/v1/stats``, streamed and non-stream
  ``POST /v1/generate`` (token-exact), ``POST /v1/cancel`` of an unknown
  id, 404, the 400s of malformed bodies and bad sampling parameters, and
  ``GET /metrics`` (the same families and types, in text format 0.0.4);
- port-only, with JAX's status and payload shapes: a cancel mid-stream, a
  client disconnect, the 408 read timeout, 503 ``rejected`` under
  backpressure and 503 ``draining`` during a drain (the in-flight stream
  still completes);
- a router front: ``replica`` labels on every series;
- ``cli.serve --replicas 2`` on stdin (tokens equal to one engine's) and
  with ``--http 127.0.0.1:0`` (the ``listening on`` line, a request, SIGTERM
  exits 0), and the fleet flag refusals with JAX's texts.

Prompts are ``range`` ramps; greedy tokens compared exactly (checked
tie-free at 1e-3 where the test compares across packages).
"""
import asyncio
import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from tnn_tpu.core import dtypes as jdt
from tnn_tpu.models.gpt2 import GPT2 as JGPT2
from tnn_tpu.serving import EngineSupervisor as JSupervisor
from tnn_tpu.serving import FaultPlan as JPlan
from tnn_tpu.serving import InferenceEngine as JEngine
from tnn_tpu.serving import ServingServer as JServer
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.serving import (EngineSupervisor, FaultPlan,
                                   InferenceEngine, RequestState, Router,
                                   ServingServer, SupervisorState)

TINY = dict(vocab_size=128, max_len=64, num_layers=2, d_model=32,
            num_heads=2)
EKW = dict(num_blocks=32, block_size=4, max_batch_size=4, max_seq_len=32,
           max_queue_depth=8)
WALL = ("ttft_ms", "latency_breakdown", "uptime_s", "age_s")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARGIN = 1e-3


@pytest.fixture(scope="module")
def tiny():
    jm = JGPT2(**TINY, policy=jdt.FP32)
    params = jm.init(jax.random.PRNGKey(0), (1, 8))["params"]
    tm = GPT2(**TINY, policy=tdt.FP32, device="cpu", seed=None)
    tm.load_jax_params(jax.tree.map(np.asarray, params))
    return jm, params, tm


def _start(sup, server_cls, **server_kw):
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    srv = server_cls(sup, port=0, **server_kw)
    asyncio.run_coroutine_threadsafe(srv.start(), loop).result(timeout=30)
    return SimpleNamespace(sup=sup, srv=srv, loop=loop, thread=thread,
                           port=srv.port)


def _stop(st):
    if not st.sup.finished:
        st.sup.request_drain("test teardown")
    st.sup.join(timeout=120)
    asyncio.run_coroutine_threadsafe(st.srv.stop(1.0),
                                     st.loop).result(timeout=30)
    st.loop.call_soon_threadsafe(st.loop.stop)
    st.thread.join(timeout=10)
    st.loop.close()


def _port_stack(tm, plan=None, engine_kw=None, **server_kw):
    eng = InferenceEngine(tm, device="cpu", faults=plan,
                          **dict(EKW, **(engine_kw or {})))
    st = _start(EngineSupervisor(eng).start(), ServingServer, **server_kw)
    st.eng = eng
    return st


@pytest.fixture(scope="module")
def twins(tiny):
    jm, params, tm = tiny
    j = _start(JSupervisor(JEngine(jm, params, faults=JPlan(
        step_delay_s=0.002), **EKW)).start(), JServer)
    t = _port_stack(tm, plan=FaultPlan(step_delay_s=0.002))
    yield j, t
    _stop(j)
    _stop(t)


# -- raw clients ---------------------------------------------------------------

def _request_bytes(method, path, body=None):
    payload = b"" if body is None else (
        body if isinstance(body, bytes) else json.dumps(body).encode())
    return (f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(payload)}\r\n\r\n").encode() + payload


async def _head(reader):
    status = int((await reader.readline()).split()[1])
    ctype = ""
    while True:
        ln = await reader.readline()
        if ln in (b"\r\n", b""):
            return status, ctype
        if ln.lower().startswith(b"content-type:"):
            ctype = ln.split(b":", 1)[1].strip().decode()


async def _http(port, method, path, body=None, raw=False):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(_request_bytes(method, path, body))
    await writer.drain()
    status, ctype = await _head(reader)
    data = await reader.read()
    writer.close()
    with contextlib.suppress(ConnectionError, OSError):
        await writer.wait_closed()
    if raw:
        return status, ctype, data.decode()
    return status, (json.loads(data) if data else None)


async def _sse(reader, limit=10_000):
    events = []
    for _ in range(limit):
        ln = await reader.readline()
        if not ln:
            break
        if ln.startswith(b"data: "):
            ev = json.loads(ln[len(b"data: "):])
            events.append(ev)
            if ev.get("event") not in ("start", "token"):
                break
    return events


async def _open_stream(port, body):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(_request_bytes("POST", "/v1/generate", body))
    await writer.drain()
    status, _ = await _head(reader)
    return reader, writer, status


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in WALL}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _parse_prometheus(text):
    types, samples = {}, []
    for ln in text.splitlines():
        if ln.startswith("# TYPE "):
            _, _, name, t = ln.split(" ", 3)
            types[name] = t
        elif ln and not ln.startswith("#"):
            metric, value = ln.rsplit(" ", 1)
            labels = {}
            if "{" in metric:
                metric, _, rest = metric.partition("{")
                for pair in rest.rstrip("}").split(","):
                    k, _, v = pair.partition("=")
                    labels[k] = v.strip('"')
            samples.append((metric, labels, float(value)))
    return types, samples


def _tie_free(tm, prompt, out):
    seq = np.concatenate([prompt, out[:-1]]).astype(np.int64)
    with torch.inference_mode():
        logits = tm(torch.from_numpy(seq)[None])[0, len(prompt) - 1:]
    top2 = logits.topk(2, dim=-1).values
    assert (top2[:, 0] - top2[:, 1]).min() > MARGIN
    assert logits.argmax(-1).tolist() == list(out)


# -- twin endpoints ------------------------------------------------------------

REQUESTS = {
    "health": ("GET", "/v1/health", None),
    "nonstream": ("POST", "/v1/generate",
                  {"tokens": list(range(2, 8)), "max_new_tokens": 4,
                   "stream": False}),
    "cancel_unknown": ("POST", "/v1/cancel", {"id": 10_000_000}),
    "not_found": ("GET", "/v2/nope", None),
    "bad_temperature": ("POST", "/v1/generate",
                        {"tokens": [1, 2], "temperature": "hot"}),
    "bad_json": ("POST", "/v1/generate", b"{not json"),
    "bad_tokens": ("POST", "/v1/generate", {"tokens": "abc"}),
    "bad_prompt": ("POST", "/v1/generate", {"prompt": 7}),
    "no_input": ("POST", "/v1/generate", {"nothing": True}),
    "bad_method": ("PUT", "/v1/generate", {"tokens": [1]}),
}


@pytest.mark.parametrize("name", list(REQUESTS))
def test_endpoint_matches_jax(twins, tiny, name):
    method, path, body = REQUESTS[name]
    got = [asyncio.run(_http(st.port, method, path, body)) for st in twins]
    (js, jb), (ts, tb) = got
    assert ts == js
    assert _strip(tb) == _strip(jb)
    if name == "nonstream":
        assert ts == 200 and tb["event"] == "done"
        _tie_free(tiny[2], np.arange(2, 8), tb["tokens"])


def test_stream_generate_matches_jax(twins, tiny):
    async def go(port):
        reader, writer, status = await _open_stream(
            port, {"tokens": list(range(1, 7)), "max_new_tokens": 5})
        events = await _sse(reader)
        writer.close()
        return status, events

    (js, jev), (ts, tev) = [asyncio.run(go(st.port)) for st in twins]
    assert ts == js == 200
    assert tev[0]["event"] == "start"
    assert _strip(tev[1:]) == _strip(jev[1:])
    toks = [e["token"] for e in tev if e["event"] == "token"]
    assert tev[-1]["event"] == "done" and tev[-1]["tokens"] == toks
    _tie_free(tiny[2], np.arange(1, 7), toks)


def test_stats_and_metrics_match_jax(twins):
    for st in twins:
        asyncio.run(_http(st.port, "POST", "/v1/generate",
                          {"tokens": [5, 6, 7], "max_new_tokens": 3,
                           "stream": False}))
    stats = [asyncio.run(_http(st.port, "GET", "/v1/stats"))
             for st in twins]
    (js, jb), (ts, tb) = stats
    assert ts == js == 200
    for k in ("supervisor_state", "queue_depth", "num_running",
              "kv_dtype", "spec", "prefix_cache_enabled",
              "host_tier_enabled", "tier_blocks", "engine_restarts"):
        assert tb[k] == jb[k], k
    assert tb["server_connections"] >= 2
    scraped = [asyncio.run(_http(st.port, "GET", "/metrics", raw=True))
               for st in twins]
    (js, jct, jtext), (ts, tct, ttext) = scraped
    assert ts == js == 200 and tct == jct == \
        "text/plain; version=0.0.4; charset=utf-8"
    jtypes, _ = _parse_prometheus(jtext)
    ttypes, samples = _parse_prometheus(ttext)
    assert ttypes == jtypes
    by = {}
    for m, lb, v in samples:
        by.setdefault(m, []).append((lb, v))
    assert by["tnn_serve_requests_finished_total"][0][1] >= 1
    buckets = by["tnn_serve_ttft_seconds_bucket"]
    assert [v for _, v in buckets] == sorted(v for _, v in buckets)
    assert buckets[-1][0]["le"] == "+Inf"
    assert buckets[-1][1] == by["tnn_serve_ttft_seconds_count"][0][1]


# -- port-only resilience paths ----------------------------------------------

def _poll(eng, rid, timeout_s=60.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        req = eng.requests.get(rid)
        if req is not None and req.is_terminal:
            return req
        time.sleep(0.01)
    raise AssertionError(f"request {rid} never finished")


def test_cancel_and_disconnect_mid_stream(twins):
    st = twins[1]

    async def cancel():
        reader, writer, _ = await _open_stream(
            st.port, {"tokens": [3, 4, 5, 6], "max_new_tokens": 25})
        rid = (await _sse(reader, limit=1))[0]["id"]
        cs, body = await _http(st.port, "POST", "/v1/cancel", {"id": rid})
        rest = await _sse(reader)
        writer.close()
        return cs, body, rest

    cs, body, rest = asyncio.run(cancel())
    assert cs == 200 and body["cancelled"] is True
    assert rest[-1]["event"] == "cancelled"
    assert "cancelled via /v1/cancel" in rest[-1]["reason"]
    before = st.srv.disconnect_cancels

    async def drop():
        reader, writer, _ = await _open_stream(
            st.port, {"tokens": [7, 8, 9], "max_new_tokens": 25})
        rid = (await _sse(reader, limit=1))[0]["id"]
        writer.transport.abort()
        return rid

    req = _poll(st.eng, asyncio.run(drop()))
    assert req.state is RequestState.CANCELLED
    assert "client disconnected" in req.error
    t0 = time.monotonic()
    while st.srv.disconnect_cancels <= before and time.monotonic() - t0 < 10:
        time.sleep(0.01)
    assert st.srv.disconnect_cancels > before


def test_read_timeout_408(tiny):
    st = _port_stack(tiny[2], read_timeout_s=0.2)
    try:
        async def go():
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           st.port)
            status, _ = await asyncio.wait_for(_head(reader), 30)
            writer.close()
            return status

        assert asyncio.run(go()) == 408
    finally:
        _stop(st)


def test_backpressure_503_rejected(tiny):
    st = _port_stack(tiny[2], plan=FaultPlan(step_delay_s=0.05),
                     engine_kw=dict(max_queue_depth=1))
    try:
        async def go():
            return await asyncio.gather(*[
                _http(st.port, "POST", "/v1/generate",
                      {"tokens": [1, 2, 3], "max_new_tokens": 8,
                       "stream": False}) for _ in range(5)])

        results = asyncio.run(go())
        rejected = [b for s, b in results if s == 503]
        assert rejected and all(b.get("rejected") for b in rejected)
        assert all(b["event"] == "done" for s, b in results if s == 200)
    finally:
        _stop(st)


def test_drain_over_http(tiny):
    st = _port_stack(tiny[2], plan=FaultPlan(step_delay_s=0.01))
    try:
        async def go():
            reader, writer, status = await _open_stream(
                st.port, {"tokens": [2, 3, 4, 5], "max_new_tokens": 20})
            await _sse(reader, limit=1)
            st.sup.request_drain("SIGTERM received")
            ds, dbody = await _http(st.port, "POST", "/v1/generate",
                                    {"tokens": [1], "stream": False})
            hs, health = await _http(st.port, "GET", "/v1/health")
            rest = await _sse(reader)
            writer.close()
            return ds, dbody, hs, health, rest

        ds, dbody, hs, health, rest = asyncio.run(go())
        assert ds == 503 and dbody["draining"] is True
        assert hs == 503 and health["status"] in ("draining", "stopped")
        assert rest[-1]["event"] == "done" and len(rest[-1]["tokens"]) == 20
        assert st.sup.join(timeout=120)
        assert st.sup.state is SupervisorState.STOPPED
        assert st.sup.exit_code == 0
    finally:
        _stop(st)
    assert st.eng.pool.num_allocated == 0


def test_router_front_labels_replicas(tiny):
    tm = tiny[2]
    kw = dict(EKW)
    sups = [EngineSupervisor(InferenceEngine(tm, device="cpu", **kw))
            for _ in range(2)]
    router = Router(sups, seed=0).start()
    st = _start(router, ServingServer)
    try:
        async def go():
            await asyncio.gather(*[
                _http(st.port, "POST", "/v1/generate",
                      {"tokens": [1 + i, 2, 3], "max_new_tokens": 3,
                       "stream": False}) for i in range(4)])
            return await _http(st.port, "GET", "/metrics", raw=True)

        status, _, text = asyncio.run(go())
        assert status == 200
        types, samples = _parse_prometheus(text)
        assert {"router", "0", "1"} <= {lb.get("replica")
                                        for _, lb, _ in samples}
        done = sum(v for m, lb, v in samples
                   if m == "tnn_serve_requests_finished_total"
                   and lb.get("replica") in ("0", "1"))
        assert done == 4
        hs, health = asyncio.run(_http(st.port, "GET", "/v1/health"))
        assert hs == 200 and health["replicas_total"] == 2
    finally:
        _stop(st)


# -- the CLI -------------------------------------------------------------------

CLI = [sys.executable, "-m", "tnn_tpu_torch.cli.serve", "--device", "cpu",
       "--model", "gpt2_tiny", "--num-blocks", "16", "--block-size", "4"]


def test_cli_replicas_on_stdin():
    lines = [{"id": i, "tokens": list(range(1 + i, 6 + i)),
              "max_new_tokens": 4} for i in range(3)]
    proc = subprocess.run(
        CLI + ["--replicas", "2"], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        input="".join(json.dumps(x) + "\n" for x in lines))
    assert proc.returncode == 0, proc.stderr[-2000:]
    events = [json.loads(x) for x in proc.stdout.splitlines()]
    done = {e["id"]: e["tokens"] for e in events if e["event"] == "done"}
    assert sorted(done) == [0, 1, 2]
    assert "router: 2 supervised replicas" in proc.stderr
    from tnn_tpu_torch.models import zoo

    model = zoo.create("gpt2_tiny", device="cpu", seed=0)
    eng = InferenceEngine(model, device="cpu", num_blocks=16, block_size=4)
    rids = [eng.submit(x["tokens"], 4) for x in lines]
    want = eng.run_until_complete()
    assert [done[i] for i in range(3)] == [want[r] for r in rids]


def test_cli_http_fleet_sigterm_exits_zero(tmp_path):
    proc = subprocess.Popen(
        CLI + ["--replicas", "2", "--http", "127.0.0.1:0",
               "--compile-cache", str(tmp_path / "cc")],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = None
        for line in proc.stderr:
            if "listening on http://" in line:
                port = int(line.rsplit(":", 1)[1])
                break
        assert port is not None
        status, body = asyncio.run(_http(
            port, "POST", "/v1/generate",
            {"tokens": [1, 2, 3], "max_new_tokens": 3, "stream": False}))
        assert status == 200 and body["event"] == "done"
        assert asyncio.run(_http(port, "GET", "/v1/health"))[0] == 200
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
        rest = proc.stderr.read()
        assert "serve summary" in rest
        assert "nvcc ran 0 time(s)" in rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


FLEET_REFUSALS = [
    ["--autoscale", "3:1"], ["--autoscale", "x"], ["--autoscale", "0:2"],
    ["--host-tier-bytes", "-5"],
    ["--host-tier-bytes", "1024", "--no-prefix-cache"],
    ["--roles", "prefill,decode"],
    ["--replicas", "2", "--roles", "prefill,gpu"],
    ["--replicas", "2", "--roles", "prefill,prefill"],
    ["--replicas", "2", "--disagg-prompt-threshold", "0"],
    ["--fleet-prefix", "--no-chunked-prefill"],
]


def _refusal(main, argv):
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2
    return err.getvalue().strip().splitlines()[-1].split("error: ", 1)[1]


@pytest.mark.parametrize("argv", FLEET_REFUSALS,
                         ids=[" ".join(a) for a in FLEET_REFUSALS])
def test_cli_fleet_refusals_match_jax(argv):
    from tnn_tpu.cli.serve import main as jmain
    from tnn_tpu_torch.cli.serve import main as tmain

    assert _refusal(tmain, ["--device", "cpu"] + argv) == \
        _refusal(jmain, argv)
