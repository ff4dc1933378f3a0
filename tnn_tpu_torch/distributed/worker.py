"""Worker: a training process's control-plane agent
(``tnn_tpu.distributed.worker``).

Parity: reference Worker event loop (include/distributed/worker.hpp:41-315) —
process_message dispatch over CommandType, CONFIG_TRANSFER -> set_config,
UPDATE/SAVE/SHUTDOWN handling — minus the FORWARD/BACKWARD jobs (tensors never
travel this channel). Beyond the reference: a heartbeat thread (its
HEALTH_CHECK was a stub).

Use: construct, register handlers, ``start()``; the compute process then calls
``barrier(name)`` at sync points while the event loop runs in the background.
"""
from __future__ import annotations

import queue
import socket as _socket
import threading
import time
from typing import Any, Callable, Dict, Optional

from ..profiling import GlobalProfiler
from ..profiling import profiler as _prof_mod
from ..utils.logging import get_logger
from .protocol import Command, pack, unpack
from .transport import Transport, make_transport


class Worker:
    def __init__(self, coordinator_host: str, coordinator_port: int,
                 rank: Optional[int] = None, heartbeat_interval: float = 2.0,
                 transport: Optional[Transport] = None):
        self._t = transport or make_transport(listen_port=None)
        self._log = get_logger("tnn.dist.worker")
        self._conn = self._t.connect(coordinator_host, coordinator_port)
        self._heartbeat_interval = heartbeat_interval
        self._handlers: Dict[str, Callable[[Dict[str, Any]], Any]] = {}
        self.config: Optional[Dict[str, Any]] = None
        self.training = True
        self.on_config: Optional[Callable[[Dict[str, Any]], None]] = None
        self.on_save: Optional[Callable[[str], None]] = None
        self._barrier_ok: "queue.Queue" = queue.Queue()
        self._custom: "queue.Queue" = queue.Queue()
        self._running = False
        self._threads = []

        # handshake (parity: worker.hpp HANDSHAKE path)
        info = {"host": _socket.gethostname(), "pid": None}
        if rank is not None:
            info["rank"] = int(rank)
        self._t.send(self._conn, Command.HANDSHAKE, pack(info))
        ev = self._t.recv(timeout=30.0)
        if ev is None or Command(ev[2]) != Command.HANDSHAKE_ACK:
            got = "timeout" if ev is None else Command(ev[2]).name
            raise ConnectionError(
                f"no HANDSHAKE_ACK from coordinator (got: {got})")
        ack = unpack(ev[3])
        self.rank = int(ack["rank"])
        self.world = int(ack["world"])
        # stamp this process's profiler with its rank so events merged at the
        # coordinator attribute to "workerN", not the default "main" (parity:
        # per-source rows in the reference's Gantt, visualize_profiler.py)
        if GlobalProfiler.source in ("", "main"):
            GlobalProfiler.source = f"worker{self.rank}"

    # -- registration ----------------------------------------------------------

    def on(self, name: str, fn: Callable[[Dict[str, Any]], Any]) -> None:
        """Handle CUSTOM messages with payload {"name": name, ...}; a non-None
        return value is sent back as a CUSTOM reply."""
        self._handlers[name] = fn

    # -- event loop ------------------------------------------------------------

    def start(self) -> "Worker":
        self._running = True
        loop = threading.Thread(target=self._serve, daemon=True)
        beat = threading.Thread(target=self._heartbeat, daemon=True)
        self._threads = [loop, beat]
        loop.start()
        beat.start()
        return self

    def _heartbeat(self):
        seq = 0
        while self._running:
            self._t.send(self._conn, Command.HEARTBEAT,
                         pack({"rank": self.rank, "seq": seq}))
            seq += 1
            time.sleep(self._heartbeat_interval)

    def _serve(self):
        while self._running:
            ev = self._t.recv(timeout=0.2)
            if ev is None:
                continue
            kind, conn, cmd, payload = ev
            if kind == "disconnect":
                self._log.warning("coordinator connection lost; stopping")
                self._running = False
                return
            if kind != "msg":
                continue
            try:
                self._dispatch(Command(cmd), unpack(payload))
            except Exception as e:  # report, keep serving (exceeds reference)
                self._log.error("handler error: %s", e)
                self._t.send(self._conn, Command.ERROR_REPORT,
                             pack({"rank": self.rank, "error": str(e)}))

    def _dispatch(self, command: Command, obj: Dict[str, Any]):
        if command == Command.CONFIG_TRANSFER:
            self.config = obj
            if self.on_config:
                self.on_config(obj)
            self._t.send(self._conn, Command.CONFIG_RECEIVED,
                         pack({"rank": self.rank}))
        elif command == Command.TRAIN_MODE:
            self.training = True
        elif command == Command.EVAL_MODE:
            self.training = False
        elif command == Command.BARRIER_OK:
            self._barrier_ok.put(obj.get("name"))
        elif command == Command.START_PROFILING:
            _prof_mod.enable(True)
        elif command == Command.CLEAR_PROFILING:
            GlobalProfiler.clear()
        elif command == Command.REPORT_PROFILING:
            d = GlobalProfiler.to_dict()
            d["source"] = d.get("source") or f"worker{self.rank}"
            self._t.send(self._conn, Command.REPORT_PROFILING, pack(d))
        elif command == Command.SAVE_TO_FILE:
            # serviced OFF the event loop: an on_save that rendezvouses with
            # the training thread (cli/dist_worker.py) must not block
            # BARRIER_OK / CONFIG dispatch — that would deadlock a worker
            # sitting in barrier() while the coordinator waits for the save.
            # Honest ack either way: a raising handler still acks ok:False,
            # when the save resolves, so save_all fails fast instead of
            # timing out.
            def _do_save(path=obj["path"]):
                if self.on_save:
                    try:
                        self.on_save(path)
                        reply = {"rank": self.rank, "ok": True}
                    except Exception as e:
                        reply = {"rank": self.rank, "ok": False, "error": str(e)}
                else:
                    reply = {"rank": self.rank, "ok": False,
                             "error": "no on_save handler registered"}
                self._t.send(self._conn, Command.SAVED, pack(reply))

            threading.Thread(target=_do_save, daemon=True).start()
        elif command == Command.HEALTH_CHECK:
            self._t.send(self._conn, Command.HEALTH_OK, pack({"rank": self.rank}))
        elif command == Command.CUSTOM:
            name = obj.get("name")
            fn = self._handlers.get(name)
            if fn is None:
                self._custom.put(obj)
            else:
                out = fn(obj)
                if out is not None:
                    self._t.send(self._conn, Command.CUSTOM,
                                 pack({"name": name, "rank": self.rank, **out}))
        elif command == Command.SHUTDOWN:
            self._t.send(self._conn, Command.SHUTDOWN_ACK,
                         pack({"rank": self.rank}))
            self._running = False

    # -- calls from the compute thread ----------------------------------------

    def barrier(self, name: str, timeout: float = 60.0):
        """Block at a named sync point until the coordinator releases it."""
        self._t.send(self._conn, Command.BARRIER, pack({"name": name}))
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"barrier {name} not released")
            try:
                got = self._barrier_ok.get(timeout=min(remaining, 0.5))
            except queue.Empty:
                continue
            if got == name:
                return

    def send_custom(self, obj: Dict[str, Any]) -> bool:
        return self._t.send(self._conn, Command.CUSTOM, pack(obj))

    def recv_custom(self, timeout: float = 60.0) -> Dict[str, Any]:
        return self._custom.get(timeout=timeout)

    def report_error(self, error: str):
        self._t.send(self._conn, Command.ERROR_REPORT,
                     pack({"rank": self.rank, "error": error}))

    @property
    def running(self) -> bool:
        return self._running

    def join(self, timeout: Optional[float] = None):
        """Wait for the event loop to end (SHUTDOWN or lost coordinator)."""
        self._threads[0].join(timeout)

    def close(self):
        self._running = False
        for t in self._threads:
            t.join(timeout=2)
        self._t.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
