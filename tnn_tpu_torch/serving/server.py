"""Asyncio HTTP + SSE front end over the supervised serving runtime
(``tnn_tpu.serving.server``).

Stdlib-only (``asyncio.start_server`` + hand-rolled HTTP/1.1): the serving
stack must not grow a web-framework dependency for four endpoints, and a
flat protocol keeps the failure surface auditable. One request per
connection (``Connection: close``), JSON bodies, SSE streaming.

Endpoints
---------
- ``POST /v1/generate`` — body ``{"tokens": [...]}`` (or ``"prompt"`` text
  when the server has a tokenizer) plus optional ``max_new_tokens``,
  ``temperature``, ``top_k``, ``top_p``, ``stop_token``, ``deadline_s``,
  ``max_queue_s``, ``priority``, ``stream``. With ``stream`` (default
  true) the response is an SSE stream: a ``start`` event carrying the
  request id, one ``token`` event per generated token, then exactly one
  terminal event (``done``/``error``/``cancelled``/``timeout``). With
  ``stream: false`` the terminal event is returned as one JSON body.
- ``POST /v1/cancel`` — ``{"id": rid}``; the stream observes ``cancelled``.
- ``GET /v1/health`` — 200 while serving, 503 while draining/stopped
  (load balancers pull the instance before shutdown completes). Reads
  only scalar gauges, so it never blocks behind a slow step.
- ``GET /v1/stats`` — full ``engine.stats()`` marshalled through the
  worker thread, plus server connection counters.
- ``GET /metrics`` — Prometheus text exposition (format 0.0.4) of the
  supervisor's counters/gauges/histograms; behind a ``Router`` front the
  per-replica series carry a ``replica`` label.

Resilience wiring: the engine runs on the supervisor's worker thread; the
event loop talks to it only through thread-safe supervisor calls (off-loop
via ``run_in_executor``, so a blocking submit can't stall other
connections) and per-request ``asyncio.Queue`` bridges fed by
``call_soon_threadsafe``. A client disconnect mid-stream cancels its
request (detected by reading the dead connection). A consumer that stops
reading trips the per-write ``write_timeout_s`` and is cancelled too — a
stalled client must not pin pool blocks. Submits during overload map
``AdmissionRejected`` to 503 ``{"rejected": true}``; submits during drain
map ``ShuttingDown`` to 503 ``{"draining": true}``.
"""
from __future__ import annotations

import asyncio
import functools
import json
import signal
import sys
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .metrics import render_prometheus
from .scheduler import AdmissionRejected
from .supervisor import EngineSupervisor, ShuttingDown, SupervisorState

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            408: "Request Timeout", 500: "Internal Server Error",
            503: "Service Unavailable"}

# Prometheus text exposition format 0.0.4
_PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class _BadRequest(ValueError):
    """Client-side protocol error -> 400 with the message as detail."""


class ServingServer:
    """One engine supervisor behind an asyncio HTTP/SSE listener."""

    def __init__(self, supervisor: EngineSupervisor, *,
                 host: str = "127.0.0.1", port: int = 8100,
                 read_timeout_s: float = 30.0, write_timeout_s: float = 30.0,
                 max_body_bytes: int = 1 << 20, tokenizer=None,
                 default_max_new: int = 32):
        self.sup = supervisor
        self.host = host
        self._port_arg = int(port)
        self.read_timeout_s = float(read_timeout_s)
        self.write_timeout_s = float(write_timeout_s)
        self.max_body_bytes = int(max_body_bytes)
        self.tokenizer = tokenizer
        self.default_max_new = int(default_max_new)
        self.connections = 0
        self.disconnect_cancels = 0
        self.stall_cancels = 0
        self._server: Optional[asyncio.AbstractServer] = None
        self._handlers: set = set()
        self._t0 = time.perf_counter()

    @property
    def port(self) -> int:
        """The bound port (useful with ``port=0`` in tests)."""
        assert self._server is not None, "server not started"
        return self._server.sockets[0].getsockname()[1]

    async def start(self) -> "ServingServer":
        self._server = await asyncio.start_server(
            self._handle, self.host, self._port_arg)
        return self

    async def stop(self, handler_grace_s: float = 10.0) -> None:
        """Stop accepting connections, then give in-flight handlers a
        bounded grace to flush their (supervisor-guaranteed) terminal
        events before returning."""
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        if self._handlers:
            await asyncio.wait(set(self._handlers), timeout=handler_grace_s)

    # -- connection handling --------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self.connections += 1
        task = asyncio.current_task()
        if task is not None:
            self._handlers.add(task)
        try:
            try:
                method, path, headers, body = \
                    await self._read_request(reader)
            except asyncio.TimeoutError:
                await self._respond_json(writer, 408,
                                         {"error": "read timeout"})
                return
            except (asyncio.IncompleteReadError, asyncio.LimitOverrunError,
                    ConnectionError, OSError):
                return  # client went away / garbage framing: nothing to say
            except _BadRequest as e:
                await self._respond_json(writer, 400, {"error": str(e)})
                return
            try:
                await self._route(method, path, body, reader, writer)
            except _BadRequest as e:
                await self._respond_json(writer, 400, {"error": str(e)})
        except (ConnectionError, OSError):
            pass
        except Exception as e:  # noqa: BLE001 — one connection, not the server
            try:
                await self._respond_json(
                    writer, 500, {"error": f"{type(e).__name__}: {e}"})
            except Exception:  # noqa: BLE001
                pass
        finally:
            if task is not None:
                self._handlers.discard(task)
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass

    async def _read_request(self, reader: asyncio.StreamReader
                            ) -> Tuple[str, str, Dict[str, str], bytes]:
        head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"),
                                      self.read_timeout_s)
        lines = head.decode("latin1").split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) < 3:
            raise _BadRequest(f"malformed request line: {lines[0]!r}")
        method, path = parts[0].upper(), parts[1]
        headers: Dict[str, str] = {}
        for ln in lines[1:]:
            if ":" in ln:
                k, v = ln.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        try:
            n = int(headers.get("content-length", "0") or "0")
        except ValueError as e:
            raise _BadRequest("bad Content-Length") from e
        if n > self.max_body_bytes:
            raise _BadRequest(f"body too large ({n} bytes)")
        body = b""
        if n:
            body = await asyncio.wait_for(reader.readexactly(n),
                                          self.read_timeout_s)
        return method, path, headers, body

    async def _route(self, method: str, path: str, body: bytes,
                     reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        if method == "GET" and path == "/v1/health":
            await self._health(writer)
        elif method == "GET" and path == "/v1/stats":
            await self._stats(writer)
        elif method == "GET" and path == "/metrics":
            await self._metrics(writer)
        elif method == "POST" and path == "/v1/generate":
            await self._generate(body, reader, writer)
        elif method == "POST" and path == "/v1/cancel":
            await self._cancel(body, writer)
        else:
            await self._respond_json(
                writer, 404, {"error": f"no route {method} {path}"})

    # -- endpoints ------------------------------------------------------------

    async def _health(self, writer: asyncio.StreamWriter) -> None:
        # scalar gauges only — health must answer even mid-step, so it
        # never marshals through the (possibly busy) worker thread
        st = self.sup.state
        serving = st in (SupervisorState.NEW, SupervisorState.RUNNING)
        body = {
            "status": st.value,
            "draining": st is SupervisorState.DRAINING,
            "uptime_s": time.perf_counter() - self._t0,
            "engine_restarts": self.sup.restarts,
        }
        # host-side gauges cached at commit time (supervisor) or behind the
        # router lock (router front) — no engine access, no device sync
        body.update(self.sup.health_gauges())
        await self._respond_json(writer, 200 if serving else 503, body)

    async def _stats(self, writer: asyncio.StreamWriter) -> None:
        loop = asyncio.get_running_loop()
        s = await loop.run_in_executor(None, self.sup.stats)
        s.update({
            "server_connections": self.connections,
            "server_disconnect_cancels": self.disconnect_cancels,
            "server_stall_cancels": self.stall_cancels,
        })
        await self._respond_json(writer, 200, s)

    async def _metrics(self, writer: asyncio.StreamWriter) -> None:
        # marshals through the worker thread (or router lock) like /v1/stats;
        # a Router front aggregates its replicas under a `replica` label
        loop = asyncio.get_running_loop()
        fams = await loop.run_in_executor(None, self.sup.prometheus_series)
        await self._respond_text(writer, 200, render_prometheus(fams))

    async def _cancel(self, body: bytes, writer: asyncio.StreamWriter) -> None:
        payload = self._parse_json(body)
        rid = payload.get("id")
        if not isinstance(rid, int):
            raise _BadRequest("cancel needs an integer \"id\"")
        loop = asyncio.get_running_loop()
        ok = await loop.run_in_executor(
            None, functools.partial(self.sup.cancel, rid,
                                    "cancelled via /v1/cancel"))
        await self._respond_json(writer, 200, {"id": rid,
                                               "cancelled": bool(ok)})

    async def _generate(self, body: bytes, reader: asyncio.StreamReader,
                        writer: asyncio.StreamWriter) -> None:
        payload = self._parse_json(body)
        prompt = self._prompt_ids(payload)
        stream = bool(payload.get("stream", True))
        kwargs = self._sampling_kwargs(payload)
        max_new = int(payload.get("max_new_tokens", self.default_max_new))

        loop = asyncio.get_running_loop()
        events: "asyncio.Queue[dict]" = asyncio.Queue()

        def listener(ev: dict) -> None:
            loop.call_soon_threadsafe(events.put_nowait, ev)

        try:
            rid = await loop.run_in_executor(
                None, functools.partial(self.sup.submit, prompt, max_new,
                                        listener=listener, **kwargs))
        except AdmissionRejected as e:
            await self._respond_json(writer, 503,
                                     {"error": str(e), "rejected": True})
            return
        except ShuttingDown as e:
            await self._respond_json(writer, 503,
                                     {"error": str(e), "draining": True})
            return
        except (ValueError, TypeError) as e:
            await self._respond_json(writer, 400, {"error": str(e)})
            return
        if stream:
            await self._stream_events(rid, events, reader, writer)
        else:
            await self._collect_terminal(rid, events, writer)

    async def _stream_events(self, rid: int, events: "asyncio.Queue[dict]",
                             reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        loop = asyncio.get_running_loop()

        def cancel(reason: str) -> None:
            # fire-and-forget off-loop; the sweep emits the terminal event
            # but this stream is already gone
            loop.run_in_executor(None, functools.partial(
                self.sup.cancel, rid, reason))

        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        # one monitor read: with one-request-per-connection semantics any
        # inbound byte/EOF after the request means the client went away
        monitor = asyncio.ensure_future(reader.read(1))
        try:
            try:
                await self._send_event(writer, {"event": "start", "id": rid})
            except asyncio.TimeoutError:
                self.stall_cancels += 1
                cancel("stalled consumer (write timeout)")
                return
            while True:
                getter = asyncio.ensure_future(events.get())
                done, _ = await asyncio.wait(
                    {getter, monitor},
                    return_when=asyncio.FIRST_COMPLETED)
                if getter not in done:
                    getter.cancel()
                    self.disconnect_cancels += 1
                    cancel("client disconnected mid-stream")
                    return
                ev = getter.result()
                try:
                    await self._send_event(writer, ev)
                except asyncio.TimeoutError:
                    self.stall_cancels += 1
                    cancel("stalled consumer (write timeout)")
                    return
                except (ConnectionError, OSError):
                    self.disconnect_cancels += 1
                    cancel("client disconnected mid-stream")
                    return
                if ev.get("event") not in ("token", "start"):
                    return  # terminal delivered — stream complete
        finally:
            monitor.cancel()

    async def _collect_terminal(self, rid: int,
                                events: "asyncio.Queue[dict]",
                                writer: asyncio.StreamWriter) -> None:
        while True:
            ev = await events.get()
            if ev.get("event") not in ("token", "start"):
                await self._respond_json(writer, 200, ev)
                return

    # -- request parsing ------------------------------------------------------

    def _parse_json(self, body: bytes) -> Dict[str, Any]:
        try:
            payload = json.loads(body.decode("utf-8") or "{}")
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise _BadRequest(f"malformed JSON body: {e}") from e
        if not isinstance(payload, dict):
            raise _BadRequest("JSON body must be an object")
        return payload

    def _prompt_ids(self, payload: Dict[str, Any]) -> np.ndarray:
        if "tokens" in payload:
            toks = payload["tokens"]
            if not isinstance(toks, list) or \
                    not all(isinstance(t, int) for t in toks):
                raise _BadRequest("\"tokens\" must be a list of ints")
            return np.asarray(toks, np.int32)
        if "prompt" in payload:
            text = payload["prompt"]
            if not isinstance(text, str):
                raise _BadRequest("\"prompt\" must be a string")
            if self.tokenizer is None:
                raise _BadRequest(
                    "server has no tokenizer — submit \"tokens\" instead")
            return np.asarray(self.tokenizer.encode(text), np.int32)
        raise _BadRequest("need \"tokens\" (or \"prompt\" with a tokenizer)")

    @staticmethod
    def _sampling_kwargs(payload: Dict[str, Any]) -> Dict[str, Any]:
        kw: Dict[str, Any] = {}
        for key, cast in (("temperature", float), ("top_k", int),
                          ("top_p", float), ("stop_token", int),
                          ("deadline_s", float), ("max_queue_s", float),
                          ("priority", int)):
            if payload.get(key) is not None:
                try:
                    kw[key] = cast(payload[key])
                except (TypeError, ValueError) as e:
                    raise _BadRequest(f"bad {key!r}: {payload[key]!r}") from e
        return kw

    # -- low-level writes -----------------------------------------------------

    async def _drain(self, writer: asyncio.StreamWriter) -> None:
        # separated out so tests can simulate a consumer that stops reading
        await writer.drain()

    async def _send_event(self, writer: asyncio.StreamWriter,
                          ev: dict) -> None:
        writer.write(b"data: " + json.dumps(ev).encode() + b"\n\n")
        await asyncio.wait_for(self._drain(writer), self.write_timeout_s)

    async def _respond_json(self, writer: asyncio.StreamWriter, status: int,
                            obj: Dict[str, Any]) -> None:
        await self._respond_bytes(writer, status, json.dumps(obj).encode(),
                                  "application/json")

    async def _respond_text(self, writer: asyncio.StreamWriter, status: int,
                            text: str,
                            content_type: str = _PROM_CONTENT_TYPE) -> None:
        await self._respond_bytes(writer, status, text.encode(), content_type)

    async def _respond_bytes(self, writer: asyncio.StreamWriter, status: int,
                             body: bytes, content_type: str) -> None:
        head = (f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}\r\n"
                f"Content-Type: {content_type}\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"Connection: close\r\n\r\n").encode()
        writer.write(head + body)
        try:
            await asyncio.wait_for(self._drain(writer), self.write_timeout_s)
        except (asyncio.TimeoutError, ConnectionError, OSError):
            pass  # response to a dead/stalled client: nothing left to do


def run_server(supervisor: EngineSupervisor, *, host: str = "127.0.0.1",
               port: int = 8100, tokenizer=None, default_max_new: int = 32,
               read_timeout_s: float = 30.0, write_timeout_s: float = 30.0,
               install_signals: bool = True) -> int:
    """Blocking entry point: start the supervisor's worker thread and the
    HTTP listener, serve until SIGTERM/SIGINT triggers a graceful drain,
    and return the supervisor's exit code (0 on a clean drain)."""

    async def _main() -> int:
        srv = ServingServer(supervisor, host=host, port=port,
                            tokenizer=tokenizer,
                            default_max_new=default_max_new,
                            read_timeout_s=read_timeout_s,
                            write_timeout_s=write_timeout_s)
        supervisor.start()
        await srv.start()
        loop = asyncio.get_running_loop()
        wake = asyncio.Event()
        if install_signals:
            for sig in (signal.SIGINT, signal.SIGTERM):
                loop.add_signal_handler(
                    sig, lambda s=sig: (
                        supervisor.request_drain(f"{s.name} received"),
                        wake.set()))
        print(f"tnn-serve: listening on http://{srv.host}:{srv.port}",
              file=sys.stderr)
        while not supervisor.finished:
            if supervisor.draining:
                # poll off-loop so in-flight SSE streams keep flushing
                await loop.run_in_executor(None, supervisor.join, 0.1)
            else:
                try:
                    await asyncio.wait_for(wake.wait(), 0.25)
                except asyncio.TimeoutError:
                    pass
        await srv.stop()
        code = supervisor.exit_code
        return code if code is not None else (
            0 if supervisor.state is SupervisorState.STOPPED else 1)

    return asyncio.run(_main())
