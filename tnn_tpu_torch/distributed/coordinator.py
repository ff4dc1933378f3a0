"""Coordinator: the control-plane master of a multi-process run
(``tnn_tpu.distributed.coordinator``).

Parity: reference Coordinator (include/distributed/coordinator.hpp:50) — topology
init + config deploy (:368-456), barrier-style join(cmd, count, timeout) (:146-157),
train/eval broadcast (:100), profiling RPCs (:277-362) — rebuilt on the framed-TCP
transport. Beyond the reference: heartbeat-based failure detection that actually
fires (the reference's health handlers are stubs, worker.hpp:216-277), and a
failed rank's rejoin.

One Coordinator for the run, one Worker per training process. This class
moves intent (configs, barriers, saves, profiles), never tensors.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..profiling import Profiler
from ..utils.logging import get_logger
from .protocol import Command, pack, unpack
from .transport import Transport, make_transport


class WorkerHandle:
    def __init__(self, conn: int, rank: int, info: Dict[str, Any]):
        self.conn = conn
        self.rank = rank
        self.info = info
        self.last_heartbeat = time.monotonic()
        self.alive = True


class Coordinator:
    def __init__(self, num_workers: int, bind: str = "", port: int = 0,
                 transport: Optional[Transport] = None,
                 heartbeat_timeout: float = 10.0,
                 on_failure: Optional[Callable[[int], None]] = None):
        self.num_workers = int(num_workers)
        self.heartbeat_timeout = heartbeat_timeout
        self.on_failure = on_failure
        self._t = transport or make_transport(bind, port)
        self._log = get_logger("tnn.dist.coord")
        self._workers: Dict[int, WorkerHandle] = {}  # rank -> handle
        self._by_conn: Dict[int, WorkerHandle] = {}
        self._queues: Dict[Command, "queue.Queue"] = {
            c: queue.Queue() for c in Command}
        self._lock = threading.Lock()
        self._barrier_ranks: Dict[str, set] = {}  # name -> ranks that arrived
        self._barrier_cv = threading.Condition()
        # notified on every membership transition (disconnect, rejoin) and on
        # every heartbeat, so wait_failed/wait_alive are event-driven — a
        # SIGKILLed worker's disconnect wakes waiters immediately instead of
        # being discovered by a polling loop's next lap
        self._member_cv = threading.Condition()
        self._running = True
        self._pump = threading.Thread(target=self._pump_loop, daemon=True)
        self._pump.start()

    # -- event pump -----------------------------------------------------------

    def _pump_loop(self):
        while self._running:
            ev = self._t.recv(timeout=0.2)
            if ev is None:
                continue
            try:
                self._pump_one(ev)
            except Exception as e:  # unknown command / bad payload must not
                # kill the pump — everything would silently time out after
                self._log.error("dropping bad control frame: %s", e)

    def _pump_one(self, ev):
        kind, conn, cmd, payload = ev
        if kind == "connect":
            return  # rank assignment happens at HANDSHAKE
        if kind == "disconnect":
            self._mark_failed(conn)
            return
        command = Command(cmd)
        if command == Command.HEARTBEAT:
            with self._lock:
                h = self._by_conn.get(conn)
                if h:
                    h.last_heartbeat = time.monotonic()
            with self._member_cv:
                self._member_cv.notify_all()
            return
        if command == Command.ERROR_REPORT:
            msg = unpack(payload)
            self._log.error("worker %s reported: %s", msg.get("rank"),
                            msg.get("error"))
        if command == Command.BARRIER:
            # track WHICH ranks arrived, per barrier name — a dead worker's
            # arrival must not release a barrier a live worker never reached,
            # and early arrivals for other barriers are never lost
            name = unpack(payload).get("name")
            with self._lock:
                h = self._by_conn.get(conn)
            if h is None:
                self._log.warning("BARRIER %r from unknown conn %d", name, conn)
                return
            with self._barrier_cv:
                self._barrier_ranks.setdefault(name, set()).add(h.rank)
                self._barrier_cv.notify_all()
            return
        if command == Command.HANDSHAKE and self._membership_complete():
            self._handle_rejoin(conn, unpack(payload))
            return
        self._queues[command].put((conn, unpack(payload)))

    def _membership_complete(self) -> bool:
        with self._lock:
            return len(self._workers) >= self.num_workers

    def _handle_rejoin(self, conn: int, info: Dict[str, Any]):
        """A worker restarting after a failure reconnects with its old rank
        (exceeds reference: its recovery commands are unimplemented stubs)."""
        rank = info.get("rank")
        with self._lock:
            h = self._workers.get(rank) if rank is not None else None
            if h is None or h.alive:
                self._log.warning(
                    "rejected handshake on conn %d (rank %s %s)", conn, rank,
                    "unknown" if h is None else "already alive")
                return
            # purge arrivals from the rank's previous life BEFORE marking it
            # alive — once alive, barrier() counts the rank as live, and a
            # stale pre-crash arrival could release a barrier the restarted
            # worker never reached (nested under _lock; nothing acquires _lock
            # while holding _barrier_cv, so the ordering cannot deadlock)
            with self._barrier_cv:
                for ranks in self._barrier_ranks.values():
                    ranks.discard(rank)
            self._by_conn.pop(h.conn, None)
            h.conn = conn
            h.info = info
            h.alive = True
            h.last_heartbeat = time.monotonic()
            self._by_conn[conn] = h
        if not self._t.send(conn, Command.HANDSHAKE_ACK,
                            pack({"rank": rank, "world": self.num_workers})):
            # the worker never learns its rank and will give up — mark the
            # handle dead NOW so wait_alive/failed_workers tell the truth
            # instead of the heartbeat timeout discovering it minutes later
            self._log.error("HANDSHAKE_ACK send failed for rank %s conn %d",
                            rank, conn)
            with self._lock:
                h.alive = False
        with self._member_cv:
            self._member_cv.notify_all()
        self._log.info("worker %d rejoined", rank)

    def _mark_failed(self, conn: int):
        # a waiter acting on the death must be able to assume the failure
        # callback has already run: the mark, the callback and the wake-up
        # all hold the member condition, under which wait_failed() checks
        # its predicate (else a heartbeat's wake-up or the 0.5 s cadence
        # could show the death between the mark and the callback)
        with self._member_cv:
            with self._lock:
                h = self._by_conn.get(conn)
                if h is None or not h.alive:
                    return
                h.alive = False
                rank = h.rank
            self._log.warning("worker %d disconnected", rank)
            if self.on_failure:
                self.on_failure(rank)
            self._member_cv.notify_all()

    # -- membership -----------------------------------------------------------

    def port(self) -> int:
        return self._t.port()

    def wait_for_workers(self, timeout: float = 60.0) -> List[int]:
        """Accept HANDSHAKEs until all ranks are present (parity: handshake +
        initialize, coordinator.hpp:69-99). Ranks are assigned in arrival order
        unless the worker requests one."""
        deadline = time.monotonic() + timeout
        while len(self._workers) < self.num_workers:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"only {len(self._workers)}/{self.num_workers} workers joined")
            try:
                conn, info = self._queues[Command.HANDSHAKE].get(timeout=remaining)
            except queue.Empty:
                continue
            with self._lock:
                rank = info.get("rank")
                if rank is None or rank in self._workers:
                    rank = next(r for r in range(self.num_workers + len(self._workers) + 1)
                                if r not in self._workers)  # lowest free rank
                h = WorkerHandle(conn, rank, info)
                self._workers[rank] = h
                self._by_conn[conn] = h
            if not self._t.send(conn, Command.HANDSHAKE_ACK,
                                pack({"rank": rank,
                                      "world": self.num_workers})):
                self._log.error("HANDSHAKE_ACK send failed for rank %s "
                                "conn %d", rank, conn)
                with self._lock:
                    h.alive = False
            with self._member_cv:
                self._member_cv.notify_all()  # wake wait_alive(initial join)
            self._log.info("worker %d joined (%s)", rank, info.get("host", "?"))
        return sorted(self._workers)

    def failed_workers(self) -> List[int]:
        """Ranks considered dead: disconnected, or heartbeat older than the
        timeout (exceeds reference: its HEALTH_CHECK handler is a stub)."""
        now = time.monotonic()
        out = []
        with self._lock:
            for rank, h in self._workers.items():
                if not h.alive or now - h.last_heartbeat > self.heartbeat_timeout:
                    out.append(rank)
        return sorted(out)

    def wait_failed(self, rank: int, timeout: float = 60.0) -> None:
        """Block until ``rank`` is considered dead. Event-driven: a disconnect
        wakes this immediately; only heartbeat *staleness* (which generates no
        event by nature) is re-checked on a short cadence."""
        self._wait_member(lambda: rank in self.failed_workers(), timeout,
                          f"rank {rank} still alive after {timeout}s")

    def wait_alive(self, rank: int, timeout: float = 60.0) -> None:
        """Block until ``rank`` is alive (initial join or rejoin after a
        failure); woken by the (re)join handshake, not a polling lap."""
        def joined_and_live():
            # a never-connected rank has no handle — "not failed" alone would
            # be vacuously true before its first handshake
            with self._lock:
                if rank not in self._workers:
                    return False
            return rank not in self.failed_workers()

        self._wait_member(joined_and_live, timeout,
                          f"rank {rank} did not (re)join within {timeout}s")

    def _wait_member(self, pred, timeout: float, msg: str) -> None:
        deadline = time.monotonic() + timeout
        with self._member_cv:
            while not pred():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(msg)
                # 0.5s cap only to notice heartbeat-age expiry, which no
                # transport event announces; all real transitions notify
                self._member_cv.wait(timeout=min(remaining, 0.5))

    # -- broadcast / join (parity: coordinator.hpp:100-157) --------------------

    def broadcast(self, command: Command, obj: Optional[Dict[str, Any]] = None):
        payload = pack(obj) if obj else b""
        with self._lock:
            targets = [(h.rank, h.conn) for h in self._workers.values() if h.alive]
        for rank, conn in targets:
            if not self._t.send(conn, command, payload):
                self._mark_failed(conn)

    def _join(self, command: Command, count: Optional[int] = None,
              timeout: float = 60.0) -> List[Dict[str, Any]]:
        """Collect ``count`` replies of ``command`` (parity: join, :146-157 — but a
        timeout here raises instead of merely warning)."""
        want = self.num_workers if count is None else count
        got: List[Dict[str, Any]] = []
        deadline = time.monotonic() + timeout
        while len(got) < want:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"join({command.name}): {len(got)}/{want} replies "
                    f"(failed workers: {self.failed_workers()})")
            try:
                _, obj = self._queues[command].get(timeout=min(remaining, 0.5))
                got.append(obj)
            except queue.Empty:
                continue
        return got

    def deploy_config(self, config: Dict[str, Any], timeout: float = 60.0):
        """CONFIG_TRANSFER broadcast + CONFIG_RECEIVED join (parity: deploy_stages,
        coordinator.hpp:368). Per-rank configs go under config["ranks"][str(rank)]."""
        self.broadcast(Command.CONFIG_TRANSFER, config)
        self._join(Command.CONFIG_RECEIVED, timeout=timeout)

    def set_train_mode(self, train: bool = True):
        self.broadcast(Command.TRAIN_MODE if train else Command.EVAL_MODE)

    def barrier(self, name: str, timeout: float = 60.0):
        """Wait until every LIVE worker reaches ``barrier(name)``, then release.

        Arrivals are counted per barrier name (early arrivals for other barriers
        are never lost), and the target shrinks if workers die while we wait —
        a crash makes the barrier raise promptly instead of hanging to timeout.
        """
        deadline = time.monotonic() + timeout
        while True:
            failed = set(self.failed_workers())
            with self._lock:
                joined = set(self._workers)
            # before the full membership has joined, never release — everyone
            # currently present arriving is not the same as everyone arriving
            # (live is joined-minus-failed, NOT range(num_workers): a worker may
            # have requested an out-of-range rank, and a phantom in-range rank
            # that never joins could otherwise block every barrier forever)
            ready = len(joined) >= self.num_workers
            live = joined - failed
            with self._barrier_cv:
                arrived = set(self._barrier_ranks.get(name, ()))
                if ready and live and live <= arrived:
                    # release consumes this occurrence entirely; workers only
                    # re-arrive after BARRIER_OK (sent below, after the clear),
                    # so nothing can leak into the next same-name barrier
                    self._barrier_ranks.pop(name, None)
                    break
                self._barrier_cv.wait(timeout=0.2)
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"barrier {name}: arrived {sorted(arrived)} of live "
                    f"{sorted(live)} (failed workers: {sorted(failed)})")
            if ready and not live:
                raise RuntimeError(f"barrier {name}: all workers failed")
        self.broadcast(Command.BARRIER_OK, {"name": name})

    # -- profiling RPCs (parity: coordinator.hpp:277-362) ----------------------

    def start_profiling(self):
        self.broadcast(Command.START_PROFILING)

    def clear_profiling(self):
        self.broadcast(Command.CLEAR_PROFILING)

    def collect_profiles(self, timeout: float = 60.0) -> Profiler:
        """REPORT_PROFILING broadcast; merge every worker's serialized profiler
        onto one timeline (Profiler.merge rebases clocks)."""
        self.broadcast(Command.REPORT_PROFILING)
        merged = Profiler(source="coordinator")
        for obj in self._join(Command.REPORT_PROFILING, timeout=timeout):
            merged.merge(Profiler.from_dict(obj))
        return merged

    def save_all(self, path: str, timeout: float = 300.0):
        """Parity: SAVE_TO_FILE (worker.hpp:287-303). Raises if any worker acked
        without actually saving (no on_save handler registered)."""
        self.broadcast(Command.SAVE_TO_FILE, {"path": path})
        replies = self._join(Command.SAVED, timeout=timeout)
        bad = [r for r in replies if not r.get("ok", True)]
        if bad:
            raise RuntimeError(f"save_all: workers did not save: {bad}")

    # -- custom messages -------------------------------------------------------

    def send_custom(self, rank: int, obj: Dict[str, Any]) -> bool:
        with self._lock:
            h = self._workers.get(rank)
            if h is None or not h.alive:
                return False
            conn = h.conn
        return self._t.send(conn, Command.CUSTOM, pack(obj))

    def recv_custom(self, timeout: float = 60.0) -> Dict[str, Any]:
        _, obj = self._queues[Command.CUSTOM].get(timeout=timeout)
        return obj

    # -- shutdown --------------------------------------------------------------

    def shutdown(self, timeout: float = 10.0):
        self.broadcast(Command.SHUTDOWN)
        try:
            self._join(Command.SHUTDOWN_ACK,
                       count=len([r for r in self._workers
                                  if r not in self.failed_workers()]),
                       timeout=timeout)
        except TimeoutError:
            self._log.warning("shutdown: not all workers acked")
        self.close()

    def close(self):
        self._running = False
        self._pump.join(timeout=2)
        self._t.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
