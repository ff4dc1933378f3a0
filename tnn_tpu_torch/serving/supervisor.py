"""Engine supervisor: the process-level resilience layer above the engine
(``tnn_tpu.serving.supervisor``).

``InferenceEngine`` makes one *step* fault-tolerant; this module makes the
*loop around it* survivable. The
supervisor owns the engine on a single worker thread and layers four
guarantees on top:

- **Crash recovery with request migration.** An exception escaping
  ``engine.step()`` (the one class of failure the engine cannot isolate —
  modelled by ``faults.EngineCrash``) resets the pool pages and prefix
  index, then re-admits the in-flight requests through the scheduler's
  preemption-resume path (``engine.migrate_running``): committed tokens
  become an extended prompt and each stream continues from its last
  emitted token, token-exact under greedy decoding. A request whose
  per-request ``migration_budget`` is exhausted is FAILED with a
  structured reason instead — poison isolation. QUEUED requests hold no
  KV state and simply re-prefill. Restarts are budgeted
  (``max_restarts``) with exponential backoff (interruptible: a drain or
  command arriving mid-backoff wakes the loop); exhausting the budget
  fails everything and parks the supervisor in ``FAILED``.
- **Step-latency watchdog.** A synchronous step cannot be preempted, so
  the watchdog measures each step after the fact: a step exceeding
  ``watchdog_step_s`` is treated like a crash (the step loop is wedged
  enough that its batch cannot meet any latency target). Note the first
  steps of a cold process build the CUDA kernels with ``nvcc``
  (``ops/runtime.py``) and capture the pdecode CUDA graph — set the
  threshold above that or warm the engine first.
- **Graceful drain.** ``request_drain()`` (thread- and signal-safe) stops
  admissions immediately — new submits raise ``ShuttingDown`` — while the
  loop keeps stepping until in-flight work finishes, or ``drain_deadline_s``
  expires and the stragglers are deadline-failed as TIMED_OUT. Every event
  is flushed, ``drain_duration_s`` is recorded in metrics, and the
  supervisor parks in ``STOPPED`` with ``exit_code`` 0.
- **Exactly one terminal event per request.** The supervisor is the single
  emitter of terminal events: after every step or command batch it sweeps
  its open-request table for newly-terminal requests and synthesizes the
  event from request state. Any termination path — step bucket, cancel,
  shed at admission, crash recovery, drain deadline — flows through the
  same sweep, so listeners can never see zero or two terminal events.

Threading model: the engine is NOT thread-safe, so every engine touch
happens on the worker thread. ``submit``/``cancel``/``stats`` from other
threads enqueue a closure on a command queue and block on its Future;
calls made *from* the worker thread (e.g. a listener cancelling its own
request mid-dispatch) execute inline to avoid self-deadlock. Without
``start()`` the same object doubles as a deterministic synchronous
harness (``run_sync``/``pump``) — that is what the chaos tests drive.

Events are plain dicts::

    {"event": "token",     "id": rid, "token": t}
    {"event": "done",      "id": rid, "tokens": [...],
     "finish_reason": "length"|"stop_token", "ttft_ms": ...}
    {"event": "error",     "id": rid, "reason": "..."}   # FAILED
    {"event": "cancelled", "id": rid, "reason": "..."}   # CANCELLED
    {"event": "timeout",   "id": rid, "reason": "..."}   # TIMED_OUT

Terminal events additionally carry ``trace_id`` and a ``latency_breakdown``
dict (queued/prefill/decode/stalled ms + preemption/migration counts) —
see ``scheduler.Request.latency_breakdown`` and docs/observability.md.

CUDA and threads: the worker sets the engine's device as its current
device before its first engine call (torch's current device, stream and
``inference_mode`` are per thread; the engine enters ``inference_mode``
itself). Every engine touch stays on the worker (``@worker_only``; the
other threads marshal ``submit``/``cancel``/``stats`` through the command
queue), and the pdecode graph is captured with
``capture_error_mode="thread_local"`` (``serving/step_graph.py``), so a
CUDA call from the main thread cannot break a capture. A CUDA error the
engine raises propagates here like any crash; a sticky error raises again
at every restart (the page reset is a CUDA call), so the supervisor ends
FAILED with exit code 1 within ``max_restarts`` and never rebuilds the
CUDA context. ``_run`` catches ``BaseException`` so that no client hangs.

``prometheus_series`` is the ``GET /metrics`` backend; ``export_prefix``,
``adopt_prefix`` and ``prefix_keys`` are the router's KV handoff and fleet
directory calls. Each runs on the worker between steps, like every other
engine touch.

The supervisor also owns the crash **flight recorder** (``self.flight``):
every step's record (``engine.last_step_record``) lands in a bounded ring
buffer, dumped as JSONL on crash, watchdog trip, restart-budget
exhaustion, kill, and drain when ``flight_dir`` is set. The last record of
a crash dump is the step that died, annotated ``crashed=True``.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import Future
from enum import Enum
from typing import Any, Callable, Dict, List, Optional

from .ownership import worker_only
from .scheduler import Request, RequestState
from .tracing import FlightRecorder, Tracer


class ShuttingDown(RuntimeError):
    """Structured admission refusal while the supervisor is draining or
    stopped — the lifecycle analogue of ``AdmissionRejected``."""

    def __init__(self, state: str):
        self.state = state
        super().__init__(
            f"supervisor is {state}: not accepting new requests")


class SupervisorState(Enum):
    NEW = "new"
    RUNNING = "running"
    DRAINING = "draining"    # admissions closed, finishing in-flight work
    STOPPED = "stopped"      # drained cleanly (exit_code 0)
    FAILED = "failed"        # restart budget exhausted / supervisor fault


#: terminal request state -> event name
EVENT_OF_STATE = {
    RequestState.FINISHED: "done",
    RequestState.FAILED: "error",
    RequestState.CANCELLED: "cancelled",
    RequestState.TIMED_OUT: "timeout",
}

EventListener = Callable[[dict], None]


class EngineSupervisor:
    """Supervised step loop over one ``InferenceEngine`` (see module doc).

    Parameters
    ----------
    engine : the engine to own. All access goes through the supervisor
        after construction.
    watchdog_step_s : fail-and-restart threshold on single-step wall time
        (None = watchdog off).
    max_restarts : crash/watchdog recoveries allowed before the supervisor
        gives up, fails all requests, and parks in FAILED.
    restart_backoff_s, restart_backoff_max_s : exponential backoff between
        restarts (``restart_backoff_s * 2**(n-1)``, capped).
    drain_deadline_s : wall budget for a graceful drain; in-flight work
        past it is failed as TIMED_OUT (None = wait forever).
    event_sink : optional listener receiving EVERY event (per-request
        listeners receive only their own request's events).
    idle_wait_s : worker-thread poll interval while idle (submits wake it
        immediately via the command queue).
    flight_recorder_capacity : ring-buffer depth of the crash flight
        recorder (always on — recording a step is a dict append).
    flight_dir : directory for flight-recorder JSONL dumps; dumps fire on
        crash, watchdog trip, restart-budget exhaustion, kill, and drain
        (None = record but never write; ``flight.dump`` still works).
    """

    def __init__(self, engine, *, watchdog_step_s: Optional[float] = None,
                 max_restarts: int = 2, restart_backoff_s: float = 0.05,
                 restart_backoff_max_s: float = 2.0,
                 drain_deadline_s: Optional[float] = 30.0,
                 event_sink: Optional[EventListener] = None,
                 idle_wait_s: float = 0.05,
                 command_timeout_s: float = 600.0,
                 flight_recorder_capacity: int = 256,
                 flight_dir: Optional[str] = None):
        self.engine = engine
        self.watchdog_step_s = watchdog_step_s
        self.max_restarts = int(max_restarts)
        self.restart_backoff_s = float(restart_backoff_s)
        self.restart_backoff_max_s = float(restart_backoff_max_s)
        self.drain_deadline_s = drain_deadline_s
        self.event_sink = event_sink
        self.idle_wait_s = float(idle_wait_s)
        self.command_timeout_s = float(command_timeout_s)
        self.restarts = 0
        self.drain_duration_s: Optional[float] = None
        self.exit_code: Optional[int] = None
        self._state = SupervisorState.NEW
        self._state_lock = threading.Lock()
        self._cmds: "queue.Queue" = queue.Queue()
        self._cmds_closed = False
        self._wake = threading.Event()  # interrupts the restart backoff
        self._thread: Optional[threading.Thread] = None
        self._listeners: Dict[int, EventListener] = {}
        self._open: Dict[int, Request] = {}
        self._drain_reason = ""
        self._drain_started: Optional[float] = None
        # host-side health gauges, copied from the engine's commit-time
        # snapshot at the end of every tick — ``/healthz`` reads these from
        # the server thread without ever touching the engine (or forcing a
        # device sync)
        self._health: Dict[str, int] = {"queue_depth": 0, "num_running": 0}
        # monotonic stamp of the last gauge refresh: ``health_gauges``
        # serves its age so the router can tell a wedged-but-responsive
        # worker (stale snapshot, answering thread) from a healthy one
        self._health_stamp = time.monotonic()
        self.flight = FlightRecorder(flight_recorder_capacity)
        self.flight_dir = flight_dir
        self.flight_dumps: List[str] = []
        self._flight_seq = 0
        # share the engine's tracer so supervisor instants land on the same
        # profiler timeline (a no-op tracer when the engine is untraced)
        self.tracer: Tracer = getattr(engine, "tracer", None) or Tracer()

    # -- state ----------------------------------------------------------------

    @property
    def state(self) -> SupervisorState:
        return self._state

    @property
    def draining(self) -> bool:
        return self._state is SupervisorState.DRAINING

    @property
    def finished(self) -> bool:
        """True once the loop has permanently exited (STOPPED or FAILED)."""
        return self._state in (SupervisorState.STOPPED,
                               SupervisorState.FAILED)

    def _set_state(self, state: SupervisorState) -> None:
        with self._state_lock:
            self._state = state

    # -- public API (any thread) ----------------------------------------------

    def start(self) -> "EngineSupervisor":
        """Run the supervision loop on a daemon worker thread."""
        if self._thread is not None:
            raise RuntimeError("supervisor already started")
        if self._state is SupervisorState.NEW:
            self._set_state(SupervisorState.RUNNING)
        self._thread = threading.Thread(
            target=self._run, name="engine-supervisor", daemon=True)
        self._thread.start()
        return self

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the worker thread to exit; True when it has."""
        t = self._thread
        if t is None:
            return self.finished
        t.join(timeout)
        return not t.is_alive()

    def submit(self, prompt_ids, max_new_tokens: int, *,
               listener: Optional[EventListener] = None, **kwargs) -> int:
        """Thread-safe ``engine.submit`` + atomic listener registration.
        Raises ``ShuttingDown`` once a drain has started, and passes
        through the engine's ``AdmissionRejected``/``ValueError``."""
        return self._execute(
            lambda: self._do_submit(prompt_ids, max_new_tokens, listener,
                                    kwargs))

    def cancel(self, rid: int, reason: str = "cancelled by client") -> bool:
        """Thread-safe ``engine.cancel``; the terminal event is emitted by
        the sweep, exactly once, like every other termination."""
        return self._execute(lambda: self.engine.cancel(rid, reason))

    def stats(self) -> Dict[str, Any]:
        """Thread-safe ``engine.stats()`` plus supervisor lifecycle state
        (marshalled through the worker, so the dict is consistent)."""
        return self._execute(self._stats)

    def prometheus_series(self) -> List[Any]:
        """Thread-safe snapshot of the engine's Prometheus metric families
        (``metrics.ServingMetrics.prometheus_series``) plus the supervisor's
        lifecycle counters: the ``GET /metrics`` backend."""
        return self._execute(self._prometheus_series)

    def export_prefix(self, tokens, max_blocks: Optional[int] = None) \
            -> List[Any]:
        """Thread-safe ``engine.export_prefix``: the longest exportable
        chain prefix of ``tokens`` as digest-carrying wire blocks, read on
        the worker between steps."""
        return self._execute(
            lambda: self.engine.export_prefix(tokens, max_blocks))

    def adopt_prefix(self, exports) -> int:
        """Thread-safe ``engine.adopt_prefix``: verify and adopt wire
        blocks; returns how many are resident (a short count makes the
        router recompute)."""
        return self._execute(lambda: self.engine.adopt_prefix(exports))

    def prefix_keys(self) -> List[bytes]:
        """Thread-safe ``engine.prefix_keys``: the chain keys this replica
        can export (the router's fleet directory)."""
        return self._execute(lambda: self.engine.prefix_keys())

    def release(self) -> bool:
        """Give back the engine's device memory (its pool's pages and
        captured graphs) once the worker has exited: a retired or killed
        replica's last act. Returns False while the worker still runs."""
        if not self.finished or not self.join(0):
            return False
        self.engine.release()
        return True

    def execute(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn()`` on the worker between steps and return its result
        (thread-safe; inline when called from the worker or without one).
        Engine calls inside ``fn`` (``submit``, ``cancel``) run in one
        command batch: no step runs between them."""
        return self._execute(fn)

    def request_drain(self, reason: str = "drain requested") -> None:
        """Begin a graceful drain (idempotent; safe from signal handlers):
        close admissions now, let in-flight work finish or deadline out,
        then stop the loop with exit_code 0."""
        with self._state_lock:
            if self._state in (SupervisorState.DRAINING,
                               SupervisorState.STOPPED,
                               SupervisorState.FAILED):
                return
            self._state = SupervisorState.DRAINING
            self._drain_reason = reason
            self._drain_started = time.perf_counter()
        self._cmds.put(None)  # wake an idle worker
        self._wake.set()      # ...and one sleeping in restart backoff

    def kill(self, reason: str = "replica killed") -> None:
        """Hard-kill — the in-process analogue of the replica's process
        dying mid-step: every request FAILs NOW with ``reason``, the
        supervisor parks in FAILED (exit_code 1), and the worker exits.
        Unlike ``request_drain``, in-flight work does not get to finish. A
        router above treats this replica as dead and fails its requests
        over. Safe from any thread; idempotent once finished."""
        self._execute(lambda: self._do_kill(reason))

    # -- synchronous drive loops (tests, single-threaded harnesses) ----------

    @worker_only
    def run_sync(self, max_steps: int = 100_000) -> None:
        """Drive the loop inline on the calling thread until the engine is
        idle (or, when draining, until the drain completes). Deterministic —
        the chaos suite's harness. Incompatible with ``start()`` (the
        ``@worker_only`` contract: with no worker thread, the caller IS the
        engine's owning thread)."""
        if self._thread is not None:
            raise RuntimeError("run_sync is for unstarted supervisors")
        if self._state is SupervisorState.NEW:
            self._set_state(SupervisorState.RUNNING)
        for _ in range(max_steps):
            if self.finished:
                return
            self._tick(block=False)
            if not self.engine.has_work and not self.draining \
                    and getattr(self.engine, "in_flight", None) is None:
                return
        raise RuntimeError(f"run_sync exceeded {max_steps} steps")

    @worker_only
    def pump(self, max_steps: int = 1) -> None:
        """Process pending commands and at most ``max_steps`` engine steps
        inline — fine-grained deterministic control for tests."""
        if self._thread is not None:
            raise RuntimeError("pump is for unstarted supervisors")
        if self._state is SupervisorState.NEW:
            self._set_state(SupervisorState.RUNNING)
        for _ in range(max_steps):
            if self.finished:
                return
            self._tick(block=False)
            if not self.engine.has_work and not self.draining \
                    and getattr(self.engine, "in_flight", None) is None:
                return

    # -- command marshalling --------------------------------------------------

    def _execute(self, fn: Callable[[], Any]) -> Any:
        if self._thread is None or \
                threading.current_thread() is self._thread:
            return fn()
        with self._state_lock:
            closed = self._cmds_closed
            if not closed:
                fut: Future = Future()
                self._cmds.put((fn, fut))
                self._wake.set()  # command arrival interrupts a backoff
        if closed:
            # the worker has exited; no concurrency left, run inline (a
            # submit will see STOPPED/FAILED and raise ShuttingDown)
            return fn()
        return fut.result(timeout=self.command_timeout_s)

    def _run_commands(self, block: bool) -> None:
        try:
            item = self._cmds.get(timeout=self.idle_wait_s) if block \
                else self._cmds.get_nowait()
        except queue.Empty:
            return
        ran = False
        while True:
            if item is not None:
                fn, fut = item
                ran = True
                if fut.set_running_or_notify_cancel():
                    try:
                        fut.set_result(fn())
                    except BaseException as e:  # noqa: BLE001 — to caller
                        fut.set_exception(e)
            try:
                item = self._cmds.get_nowait()
            except queue.Empty:
                break
        if ran:
            # a command (cancel, shed-at-submit) may have terminalized
            # requests outside any step
            self._sweep_terminals()

    def _close_cmds(self) -> None:
        """After the loop exits: reject queued commands instead of leaving
        their callers blocked on never-resolved futures."""
        with self._state_lock:
            self._cmds_closed = True
        while True:
            try:
                item = self._cmds.get_nowait()
            except queue.Empty:
                return
            if item is None:
                continue
            fn, fut = item
            if fut.set_running_or_notify_cancel():
                try:
                    fut.set_result(fn())
                except BaseException as e:  # noqa: BLE001 — to caller
                    fut.set_exception(e)

    # -- engine-thread internals ----------------------------------------------

    @worker_only
    def _do_submit(self, prompt_ids, max_new_tokens,
                   listener: Optional[EventListener], kwargs) -> int:
        if self._state in (SupervisorState.DRAINING, SupervisorState.STOPPED,
                           SupervisorState.FAILED):
            raise ShuttingDown(self._state.value)
        rid = self.engine.submit(prompt_ids, max_new_tokens, **kwargs)
        req = self.engine.requests[rid]
        self._open[rid] = req
        if listener is not None:
            self._listeners[rid] = listener
        if self.tracer.enabled:
            self.tracer.instant("sup.admit", trace=req.trace_id, rid=rid)
        self._refresh_health()
        return rid

    @worker_only
    def _refresh_health(self) -> None:
        """Copy the engine's commit-time gauge snapshot into the
        supervisor-owned dict that ``health_gauges`` serves cross-thread."""
        gauges = getattr(self.engine, "_health_gauges", None)
        if gauges is not None:
            self._health = dict(gauges)
        self._health_stamp = time.monotonic()

    def health_gauges(self) -> Dict[str, int]:
        """Host-side liveness gauges (queue depth, running count, last step
        latency, and the engine's static extras — ``tp_degree`` and the
        per-shard KV residency under tensor-parallel serving) cached at
        commit time, plus ``age_s`` — seconds since the
        worker last refreshed the snapshot. A wedged-but-responsive worker
        (alive thread, no ticks) shows up as unbounded age, which the
        router's health scoring penalizes. Safe from any thread WITHOUT
        marshalling through the worker: the snapshot dict is replaced
        wholesale each tick, never mutated in place, and reading it cannot
        force a device sync."""
        return {**self._health,
                "age_s": time.monotonic() - self._health_stamp}

    @worker_only
    def _stats(self) -> Dict[str, Any]:
        s = self.engine.stats()
        s["supervisor_state"] = self._state.value
        s["supervisor_restarts"] = self.restarts
        s["flight_dumps"] = self.flight.dumps
        return s

    @worker_only
    def _prometheus_series(self) -> List[Any]:
        fams = list(self.engine.metrics.prometheus_series())
        fams.append({
            "name": "tnn_serve_supervisor_restarts", "type": "counter",
            "help": "Supervisor crash/watchdog restarts",
            "samples": [("", {}, float(self.restarts))]})
        fams.append({
            "name": "tnn_serve_flight_dumps", "type": "counter",
            "help": "Flight-recorder JSONL dumps written",
            "samples": [("", {}, float(self.flight.dumps))]})
        return fams

    @worker_only
    def _do_kill(self, reason: str) -> None:
        if self.finished:
            return
        self._dump_flight("kill")
        self.engine.abort_all(reason, include_queued=True, reset_pages=True)
        self._sweep_terminals()
        self._set_state(SupervisorState.FAILED)
        self.exit_code = 1

    def _last_step_record(self) -> Optional[Dict[str, Any]]:
        fn = getattr(self.engine, "last_step_record", None)
        return fn() if fn is not None else None

    def _dump_flight(self, reason: str) -> Optional[str]:
        """Write the flight ring as JSONL under ``flight_dir`` (no-op when
        unset; appends to ``flight_dumps`` on success). Never raises — a
        failing post-mortem write must not take down recovery itself."""
        if self.flight_dir is None:
            return None
        self._flight_seq += 1
        path = os.path.join(self.flight_dir,
                            f"flight_{self._flight_seq:03d}_{reason}.jsonl")
        try:
            os.makedirs(self.flight_dir, exist_ok=True)
            self.flight.dump(path, reason,
                             extra={"restarts": self.restarts,
                                    "supervisor_state": self._state.value})
        except OSError:
            return None
        self.flight_dumps.append(path)
        return path

    def _emit(self, rid: int, ev: dict) -> None:
        listener = self._listeners.get(rid)
        for sink in (listener, self.event_sink):
            if sink is None:
                continue
            try:
                sink(ev)
            except Exception:  # noqa: BLE001 — a bad listener can't kill us
                pass

    def _dispatch_tokens(self, events: Dict[str, List]) -> None:
        for rid, tok in events["tokens"]:
            self._emit(rid, {"event": "token", "id": rid, "token": int(tok)})

    def _sweep_terminals(self) -> None:
        """The single emitter of terminal events: any open request observed
        in a terminal state gets exactly one structured event, no matter
        which path terminated it (step bucket, cancel, shed, crash
        recovery, drain deadline). Popping before delivery makes the sweep
        re-entrant: a listener may submit a new request from its own
        terminal event (closed-loop clients) without double delivery."""
        for rid in [r for r, req in self._open.items() if req.is_terminal]:
            req = self._open.pop(rid)
            listener = self._listeners.pop(rid, None)
            ev: dict = {"event": EVENT_OF_STATE[req.state], "id": rid}
            if req.state is RequestState.FINISHED:
                ev["tokens"] = [int(t) for t in req.out_tokens]
                ev["finish_reason"] = req.finish_reason
                ev["ttft_ms"] = round((req.ttft_s or 0.0) * 1e3, 3)
            else:
                ev["reason"] = req.error
            if req.trace_id:
                ev["trace_id"] = req.trace_id
            # where this request's lifetime went — the per-request latency
            # attribution tracing exists to answer
            ev["latency_breakdown"] = req.latency_breakdown()
            for sink in (listener, self.event_sink):
                if sink is None:
                    continue
                try:
                    sink(ev)
                except Exception:  # noqa: BLE001 — a bad listener can't
                    pass           # take down the loop

    @worker_only
    def _restart(self, reason: str) -> None:
        self.restarts += 1
        self._wake.clear()
        self.engine.metrics.observe_restart()
        if self.tracer.enabled:
            self.tracer.instant("sup.restart", n=self.restarts)
        if self.restarts > self.max_restarts:
            self._dump_flight("restart_budget")
            self.engine.abort_all(
                f"restart budget exhausted ({self.max_restarts}) — "
                f"last failure: {reason}",
                include_queued=True, reset_pages=True)
            self._sweep_terminals()
            self._set_state(SupervisorState.FAILED)
            self.exit_code = 1
            return
        # in-flight requests lost their KV but NOT their progress: they
        # re-admit through the scheduler's resume path (committed tokens
        # become an extended prompt, streams continue token-exact), unless
        # their migration_budget is exhausted — then they FAIL as poison.
        # Queued requests hold no KV and simply re-prefill.
        self.engine.migrate_running(f"engine restarted: {reason}")
        self._sweep_terminals()
        backoff = min(self.restart_backoff_s * (2 ** (self.restarts - 1)),
                      self.restart_backoff_max_s)
        if backoff > 0 and self._cmds.empty():
            # interruptible: request_drain / command arrival sets _wake, so
            # a drain never waits out the exponential backoff
            self._wake.wait(backoff)

    @worker_only
    def _finish_drain(self) -> None:
        started = self._drain_started
        self.drain_duration_s = (
            time.perf_counter() - started if started is not None else 0.0)
        self.engine.metrics.observe_drain(self.drain_duration_s)
        self._dump_flight("drain")
        self._set_state(SupervisorState.STOPPED)
        self.exit_code = 0

    def _drain_expired(self) -> bool:
        return (self.draining and self.drain_deadline_s is not None
                and self._drain_started is not None
                and time.perf_counter() - self._drain_started
                > self.drain_deadline_s)

    @worker_only
    def _tick(self, *, block: bool) -> None:
        """One supervision quantum. Dispatches on the engine's loop mode:
        the synchronous tick steps the engine whole (``engine.step``); the
        overlapped tick splits the quantum into begin/speculate/deferred/
        finish so host bookkeeping runs while a step is in flight."""
        if getattr(self.engine, "overlap", False):
            self._tick_overlap(block=block)
        else:
            self._tick_sync(block=block)

    @worker_only
    def _tick_sync(self, *, block: bool) -> None:
        """Synchronous quantum: run queued commands, then one
        watchdog-timed, crash-supervised engine step when there is work."""
        self._run_commands(block=block and not self.engine.has_work)
        if self.finished:
            return
        if not self.engine.has_work:
            if self.draining:
                self._finish_drain()
            return
        if self._drain_expired():
            self.engine.abort_all(
                f"drain deadline {self.drain_deadline_s}s exceeded "
                f"({self._drain_reason})",
                state=RequestState.TIMED_OUT, include_queued=True,
                reset_pages=False)
            self._sweep_terminals()
            self._finish_drain()
            return
        t0 = time.perf_counter()
        try:
            events = self.engine.step()
        except Exception as e:  # noqa: BLE001 — crash recovery is the point
            # the engine finalizes its step record even on a crash, so the
            # dump's LAST line is the step that died, annotated with the
            # exception that killed it
            rec = self._last_step_record() or {}
            rec["crashed"] = True
            rec["error"] = f"{type(e).__name__}: {e}"
            self.flight.record(rec)
            self._dump_flight("crash")
            self._sweep_terminals()
            self._restart(f"engine step crashed: {type(e).__name__}: {e}")
            return
        dt = time.perf_counter() - t0
        self.flight.record(self._last_step_record())
        self._dispatch_tokens(events)
        self._sweep_terminals()
        self._refresh_health()
        if self.watchdog_step_s is not None and dt > self.watchdog_step_s:
            self._dump_flight("watchdog")
            self._restart(
                f"step-latency watchdog tripped: step took {dt:.3f}s "
                f"(threshold {self.watchdog_step_s}s)")

    @worker_only
    def _tick_overlap(self, *, block: bool) -> None:
        """Overlapped quantum: with a step in flight on-device, the host
        side of this tick (command batch, deferred publishes/instants,
        speculative build of step N+1) runs INSIDE the device's compute
        window; only ``finish_step`` blocks, on the one bundle fetch.

        Crash semantics match the sync tick: any exception out of
        begin/speculate/finish finalizes the dying step's note (the engine
        guarantees this), so the crash dump's last line is still the step
        that died. A drain deadline aborts the in-flight step too —
        ``abort_all`` discards the flight and the fetched-but-uncommitted
        tokens with it."""
        eng = self.engine
        idle = not eng.has_work and getattr(eng, "in_flight", None) is None
        self._run_commands(block=block and idle)
        if self.finished:
            return
        if not eng.has_work and getattr(eng, "in_flight", None) is None:
            # nothing on-device: flush any deferred work left by the last
            # commit before declaring the drain complete
            eng.run_deferred()
            self._refresh_health()
            if self.draining:
                self._finish_drain()
            return
        if self._drain_expired():
            eng.abort_all(
                f"drain deadline {self.drain_deadline_s}s exceeded "
                f"({self._drain_reason})",
                state=RequestState.TIMED_OUT, include_queued=True,
                reset_pages=False)
            self._sweep_terminals()
            self._finish_drain()
            return
        t0 = time.perf_counter()
        try:
            if eng.in_flight is None:
                eng.begin_step()
            # host work below overlaps the dispatched step's device time
            eng.try_speculate()
            eng.run_deferred()
            events = eng.finish_step()
        except Exception as e:  # noqa: BLE001 — crash recovery is the point
            rec = self._last_step_record() or {}
            rec["crashed"] = True
            rec["error"] = f"{type(e).__name__}: {e}"
            self.flight.record(rec)
            self._dump_flight("crash")
            self._sweep_terminals()
            self._restart(f"engine step crashed: {type(e).__name__}: {e}")
            return
        dt = time.perf_counter() - t0
        # the engine's CURRENT note may belong to a speculative step N+1
        # already in flight — record the step that just committed instead
        self.flight.record(eng.last_finished_record())
        self._dispatch_tokens(events)
        self._sweep_terminals()
        self._refresh_health()
        if self.watchdog_step_s is not None and dt > self.watchdog_step_s:
            self._dump_flight("watchdog")
            self._restart(
                f"step-latency watchdog tripped: step took {dt:.3f}s "
                f"(threshold {self.watchdog_step_s}s)")

    @worker_only
    def _run(self) -> None:
        try:
            device = getattr(self.engine, "device", None)
            if device is not None and device.type == "cuda":
                # torch's current device is per thread
                import torch

                torch.cuda.set_device(device)
            while not self.finished:
                self._tick(block=True)
        except BaseException as e:  # noqa: BLE001 — never hang clients
            reason = f"supervisor loop crashed: {type(e).__name__}: {e}"
            try:
                try:
                    self.engine.abort_all(reason, include_queued=True)
                except BaseException:  # noqa: BLE001 — a sticky CUDA
                    # error fails the page reset too; the requests were
                    # terminated before it, so only bookkeeping remains
                    self.engine.abort_all(reason, include_queued=True,
                                          reset_pages=False)
                self._sweep_terminals()
            finally:
                self._set_state(SupervisorState.FAILED)
                self.exit_code = 1
        finally:
            self._close_cmds()
