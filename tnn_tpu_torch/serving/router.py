"""Replicated failover router (``tnn_tpu.serving.router``): one front end
over N supervised replicas.

``EngineSupervisor`` makes a single engine's crash survivable (in-flight
requests *migrate* through the scheduler's resume path instead of
failing). This module decouples request failure from *replica* failure:
a request outlives the death of the entire engine+supervisor stack
serving it.

The router fronts N ``EngineSupervisor`` instances (in-process here, but
every router↔replica interaction goes through process-shaped seams — the
supervisor's thread-safe public API via the ``_call`` seam — so swapping a
replica handle for an RPC stub changes no control flow):

- **Join-shortest-queue placement.** New requests go to the healthy
  replica with the fewest router-assigned live requests. "Healthy" means
  not killed, not finished, and its circuit breaker admits traffic.
- **Circuit breaker per replica.** CLOSED → OPEN after
  ``breaker_threshold`` consecutive failures (failed dispatches, dropped
  calls, replica-level request failures); OPEN → HALF_OPEN after
  ``breaker_cooldown_s``, admitting a single probe dispatch; the probe's
  success re-CLOSEs, its failure re-OPENs. An open breaker removes the
  replica from placement without declaring it dead.
- **Bounded retries with backoff + jitter.** A failed dispatch retries on
  another replica up to ``max_retries`` times with exponential backoff
  (``retry_backoff_s * 2**(n-1)``, capped, plus seeded jitter), always
  respecting the request's ``deadline_s`` — a retry that cannot complete
  before the deadline fails the request as TIMED_OUT instead of burning
  the budget.
- **Token-exact mid-stream migration.** The router records every token it
  streams. When a replica dies — hard kill (``kill_replica`` /
  ``EngineSupervisor.kill``), restart-budget exhaustion, supervisor loop
  crash — its live requests re-dispatch to a healthy replica with the
  committed prefix as an extended prompt (``prompt + emitted``) and
  ``max_new - len(emitted)`` tokens to go. The new replica's prefill
  samples the *successor* of the last emitted token, so the client stream
  continues with no token duplicated or dropped — byte-identical to an
  uninterrupted run under greedy decoding. Per-request router migrations
  are bounded by ``migration_budget`` (poison isolation: a request that
  keeps killing replicas FAILs with a structured reason). Engine-level
  failures that name an exhausted *engine* migration budget pass through
  unmigrated for the same reason.
- **Cascading drain.** ``request_drain`` closes router admissions and
  drains every replica; the router parks STOPPED (exit_code 0) once all
  replicas finish and every routed request has reached exactly one
  terminal event.

Gray-failure tolerance — a replica that is *slow* but not
dead defeats both the breaker (calls still succeed) and JSQ (its queue
drains slowly, so it keeps absorbing traffic). Three cooperating
mechanisms handle it:

- **Health-scored placement.** Every replica carries a ``HealthScore`` —
  EWMAs of router-observed dispatch latency, the engine's last step
  latency and queue depth (sampled from ``health_gauges()`` by the probe
  loop), and recent dispatch error rate, plus gauge staleness. Placement
  weighs queue length by the score *ratio* against the healthiest
  replica, with a dead-band (``score_tolerance``): when scores are within
  tolerance of uniform, routing is byte-identical to pure JSQ.
- **Degraded-replica ejection.** A replica whose score stays worse than
  ``degrade_factor`` × the fleet median for ``degrade_window_s`` enters
  DEGRADED — distinct from breaker OPEN: the replica is *alive*, so its
  in-flight streams either finish in place or are proactively migrated
  through the same token-exact recompute-resume path (the old stream is
  cancelled quietly; no breaker charge). New admissions route away. After
  ``degrade_cooldown_s`` a recovery-probe dispatch is admitted; a score
  back under ``readmit_factor`` × median sustained for the window
  re-admits it (hysteresis: readmit_factor < degrade_factor, so a
  replica hovering at the threshold cannot flap).
- **Hedged dispatch.** A request whose first token hasn't arrived within
  the hedge threshold (``hedge_ttft_s``, or adaptively the fleet's
  rolling TTFT p95) is duplicated onto the next-best replica under a
  fresh epoch; the epoch guard dedupes the two streams to exactly-once.
  First token wins; the loser is cancelled quietly and never charges a
  breaker. A hedge budget (``hedge_budget`` × open requests, consulted
  before every fire) bounds amplification.

Disaggregated prefill/decode serving — prefill is
compute-bound and bursty, decode is latency-bound and steady; co-locating
them makes every long prompt stall every decode stream sharing the batch.
Replicas therefore carry a **role** (``prefill`` / ``decode`` / ``mixed``,
the default), assigned statically per replica or dynamically (``roles=
"auto"``: the probe loop ranks replicas by health score and dedicates the
healthiest half to decode). Roles are placement *preferences*, never
admission gates — a fleet with no matching role falls back to any
available replica, so no request can fail because of a role:

- **Long-prompt admission** (``len(prompt) >= disagg_prompt_threshold``)
  prefers prefill replicas; everything else prefers decode/mixed, keeping
  prefill bursts off the decode batch.
- **Boundary handoff.** When a prefill replica streams a request's FIRST
  token, the router moves the stream to a decode replica through the same
  epoch-guarded migration path as crash failover — token-exact by
  recompute-resume. With ``handoff_kv`` the move is cheap: the source
  exports its prefix KV blocks (``export_prefix``, content-addressed by
  chain key + blake2b digest) and the target adopts them through the
  digest-verified path (``adopt_prefix``) before re-dispatch, so the
  "recompute" prefill hits the adopted prefix instead of re-running it.
  A failed export/adopt (corrupt wire bytes, pool full, receiver killed
  mid-adopt) degrades to plain recompute-resume — never a wrong token,
  never a dropped request.
- **Fleet-wide shared prefix cache** (``fleet_prefix``). The probe loop
  maintains a content-addressed directory of which replica holds which
  chain keys (``prefix_keys()``); at dispatch, a prompt whose prefix
  misses on the chosen replica but hits on a peer pulls the blocks over
  through the same export/adopt path instead of recomputing them.

Chaos seams: the router's optional ``FaultPlan`` fires ``net.delay`` /
``net.drop`` inside ``_call`` (injected router↔replica latency and loss),
``net.partition`` opens windows during which every router↔replica call
fails, ``net.flaky`` drops calls to one configured replica only, and the
harness consults ``replica.kill`` / ``replica.slow`` to schedule
``kill_replica`` / ``slow_replica``.

Like the supervisor, an unstarted router doubles as a deterministic
synchronous harness: ``pump`` round-robins one step across live replicas
and runs the health probe; ``run_sync`` drives to quiescence. ``start()``
spawns every replica's worker plus a monitor thread running the probe.

Events mirror the supervisor's shapes with router-global ids; the router
is the single emitter of terminal events for routed requests (a stale
replica epoch — e.g. a killed replica's last sweep — is dropped, so
listeners can never see zero or two terminal events).

On the card the replicas of one process share the model's weights and
each owns an engine, a pool and a worker thread (``cli/serve.py``). Their
pdecode graph captures are serialized process-wide
(``step_graph._CAPTURE_LOCK``), and each worker's kernel launches are
counted under one lock (``ops/runtime.count_launch``). Once a retired or
killed replica's worker has exited, the probe releases its pool's pages
and captured graphs (``EngineSupervisor.release``), so a scale-down gives
its device memory back.
"""
from __future__ import annotations

import functools
import itertools
import statistics
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

import numpy as np

from ..profiling.profiler import Profiler
from .metrics import ServingMetrics, label_series, merge_series
from .prefix_cache import chain_keys
from .scheduler import AdmissionRejected
from .supervisor import (EngineSupervisor, EventListener, ShuttingDown,
                         SupervisorState)
from .tracing import Tracer


class NetDrop(ConnectionError):
    """Injected router↔replica call loss (fault site "net.drop")."""


class BreakerState(Enum):
    CLOSED = "closed"          # healthy: traffic flows
    OPEN = "open"              # tripped: no traffic until cooldown
    HALF_OPEN = "half_open"    # cooldown elapsed: one probe in flight


class CircuitBreaker:
    """Per-replica failure gate: CLOSED → OPEN after ``threshold``
    consecutive failures, OPEN → HALF_OPEN after ``cooldown_s``, where a
    single probe dispatch decides between re-CLOSE and re-OPEN."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 0.25):
        if threshold < 1:
            raise ValueError("breaker threshold must be >= 1")
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.state = BreakerState.CLOSED
        self.failures = 0          # consecutive
        self._opened_at: Optional[float] = None
        self._probing = False

    def allows(self) -> bool:
        """May a dispatch go to this replica right now? (Advances
        OPEN → HALF_OPEN when the cooldown has elapsed.)"""
        if self.state is BreakerState.CLOSED:
            return True
        if self.state is BreakerState.OPEN:
            if self._opened_at is not None and \
                    time.monotonic() - self._opened_at >= self.cooldown_s:
                self.state = BreakerState.HALF_OPEN
                self._probing = False
            else:
                return False
        return not self._probing   # HALF_OPEN: exactly one probe at a time

    def on_dispatch(self) -> None:
        if self.state is BreakerState.HALF_OPEN:
            self._probing = True

    def record_success(self) -> None:
        """Close only from CLOSED (refresh) or HALF_OPEN (probe success).

        A success landing while OPEN is *stale* — a call that started
        before the trip, finishing after it — and must not short-circuit
        the cooldown: the replica earned the open state with ``threshold``
        consecutive failures, and only a deliberate HALF_OPEN probe may
        re-close it."""
        if self.state is BreakerState.OPEN:
            return
        self.state = BreakerState.CLOSED
        self.failures = 0
        self._probing = False
        self._opened_at = None

    def record_failure(self) -> None:
        self.failures += 1
        if self.state is BreakerState.HALF_OPEN or \
                self.failures >= self.threshold:
            self.trip()

    def trip(self) -> None:
        self.state = BreakerState.OPEN
        self._opened_at = time.monotonic()
        self._probing = False


class HealthScore:
    """EWMA health of one replica, folded into a scalar placement weight.

    ``score()`` is ``1.0`` for a perfectly healthy replica and grows with
    smoothed dispatch latency, engine step latency, queue depth, recent
    dispatch error rate, and gauge staleness (a wedged-but-responsive
    worker stops refreshing its gauges, so ``age_s`` climbs). All EWMAs
    start at the healthy fixed point 0.0, so a fresh fleet scores exactly
    uniform and placement degenerates to pure JSQ."""

    ALPHA = 0.3                # EWMA smoothing: new = (1-a)*old + a*x
    W_DISPATCH = 25.0          # per second of smoothed dispatch latency
    W_STEP = 25.0              # per second of smoothed engine step latency
    W_QUEUE = 0.05             # per smoothed queued/running request
    W_ERROR = 2.0              # per unit of smoothed error rate (0..1)
    W_STALE = 0.5              # per second of gauge staleness past grace
    STALE_GRACE_S = 1.0        # probe cadence slack before staleness counts

    def __init__(self) -> None:
        self.dispatch_latency_s = 0.0
        self.step_latency_s = 0.0
        self.queue_depth = 0.0
        self.error_rate = 0.0
        self.staleness_s = 0.0     # instantaneous, not smoothed
        self.samples = 0

    def _ewma(self, old: float, x: float) -> float:
        return (1.0 - self.ALPHA) * old + self.ALPHA * float(x)

    def observe_dispatch(self, seconds: float) -> None:
        """One successful router→replica dispatch took ``seconds``."""
        self.dispatch_latency_s = self._ewma(self.dispatch_latency_s,
                                             seconds)
        self.samples += 1

    def observe_outcome(self, ok: bool) -> None:
        """One dispatch/stream outcome: folds into the error-rate EWMA."""
        self.error_rate = self._ewma(self.error_rate, 0.0 if ok else 1.0)
        self.samples += 1

    def observe_gauges(self, step_latency_s: float, queue_depth: float,
                       staleness_s: float) -> None:
        """One probe-loop sample of the replica's ``health_gauges()``."""
        self.step_latency_s = self._ewma(self.step_latency_s,
                                         step_latency_s)
        self.queue_depth = self._ewma(self.queue_depth, queue_depth)
        self.staleness_s = float(staleness_s)
        self.samples += 1

    def score(self) -> float:
        """Scalar placement weight: 1.0 = healthy, larger = worse."""
        return (1.0
                + self.W_DISPATCH * self.dispatch_latency_s
                + self.W_STEP * self.step_latency_s
                + self.W_QUEUE * self.queue_depth
                + self.W_ERROR * self.error_rate
                + self.W_STALE * max(0.0, self.staleness_s
                                     - self.STALE_GRACE_S))


@dataclass
class _Replica:
    """One supervised replica plus the router's view of it."""
    idx: int
    sup: EngineSupervisor
    breaker: CircuitBreaker
    live: Set[int] = field(default_factory=set)   # router gids assigned here
    killed: bool = False
    health: HealthScore = field(default_factory=HealthScore)
    # DEGRADED state machine (gray failure — alive but ejected from
    # placement; distinct from breaker OPEN, which means calls FAIL)
    degraded: bool = False
    suspect_since: Optional[float] = None   # score first crossed threshold
    readmit_since: Optional[float] = None   # score first back under readmit
    degraded_at: Optional[float] = None     # ejection time (cooldown base)
    recovery_probing: bool = False          # one probe dispatch at a time
    # scale-down: a retired replica takes no new placements and drains to
    # completion (its live streams are proactively migrated first); unlike
    # killed it stays token-correct while it empties
    retired: bool = False
    # disaggregation role (module doc): a placement PREFERENCE, never an
    # admission gate — "mixed" serves anything
    role: str = "mixed"
    # the replica's pool and graphs were given back after its worker exited
    released: bool = False

    @property
    def available(self) -> bool:
        return (not self.killed and not self.degraded and not self.retired
                and not self.sup.finished and self.breaker.allows())


@dataclass
class _Routed:
    """Router-side record of one request: everything needed to re-dispatch
    it mid-stream — the original prompt, every token already streamed to
    the client, and the submit kwargs."""
    gid: int
    prompt: np.ndarray
    max_new: int
    kwargs: Dict[str, Any]
    listener: Optional[EventListener]
    t_submit: float
    emitted: List[int] = field(default_factory=list)
    replica: Optional[int] = None
    local_rid: Optional[int] = None
    epoch: int = 0            # current primary stream; stale-event guard
    epoch_seq: int = 0        # allocator: highest epoch ever issued for
    #                           this request. Every new stream (failover,
    #                           proactive migration, hedge) takes the next
    #                           value, so a hedge epoch can never collide
    #                           with a later migration epoch
    migrations: int = 0
    ttft_s: Optional[float] = None
    t_dispatch: float = 0.0   # perf_counter of the last primary dispatch
    # pending hedge race (duplicate stream on another replica); None/False
    # when no race is in flight. ``hedged`` stays True after resolution —
    # at most one hedge per request, ever
    hedge_epoch: Optional[int] = None
    hedge_replica: Optional[int] = None
    hedge_local_rid: Optional[int] = None
    hedged: bool = False
    done: bool = False
    # disaggregation: role preference for the NEXT dispatch ("prefill"
    # until the boundary handoff flips it to "decode"), plus a one-replica
    # affinity hint so a re-dispatch lands where the KV was just adopted
    prefer_role: Optional[str] = None
    prefer_replica: Optional[int] = None


#: substrings identifying a terminal error as the REPLICA dying (migrate)
#: rather than the request itself failing (pass through). Checked only
#: after the engine-level poison marker "migration budget exhausted".
_REPLICA_FAILURE_MARKERS = (
    "replica killed",
    "restart budget exhausted",
    "supervisor loop crashed",
    "engine restarted",
    "KV pages lost",
)


class Router:
    """Failover front end over N supervised engine replicas (module doc).

    Duck-types the supervisor surface ``server.ServingServer`` and
    ``cli/serve`` consume — ``submit`` / ``cancel`` / ``stats`` /
    ``request_drain`` / ``start`` / ``join`` / ``state`` / ``draining`` /
    ``finished`` / ``exit_code`` / ``restarts`` / ``event_sink`` — so one
    ``--replicas N`` flag swaps it in above the existing front ends.
    """

    def __init__(self, supervisors: Sequence[EngineSupervisor], *,
                 faults=None, max_retries: int = 3,
                 retry_backoff_s: float = 0.02,
                 retry_backoff_max_s: float = 0.5,
                 retry_jitter_s: float = 0.01,
                 migration_budget: int = 3,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 0.25,
                 probe_interval_s: float = 0.05,
                 hedge_ttft_s: Optional[float] = None,
                 hedge_budget: float = 0.1,
                 degrade_factor: float = 2.0,
                 degrade_window_s: float = 0.25,
                 degrade_cooldown_s: float = 0.5,
                 readmit_factor: Optional[float] = None,
                 score_tolerance: float = 0.5,
                 roles: Optional[Sequence[str]] = None,
                 disagg_prompt_threshold: int = 0,
                 handoff_kv: bool = True,
                 fleet_prefix: bool = False,
                 event_sink: Optional[EventListener] = None,
                 profiler: Optional[Profiler] = None,
                 seed: int = 0):
        if not supervisors:
            raise ValueError("router needs at least one replica")
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if migration_budget < 0:
            raise ValueError("migration_budget must be >= 0")
        if score_tolerance < 0:
            raise ValueError("score_tolerance must be >= 0")
        self._handles = [
            _Replica(idx=i, sup=s,
                     breaker=CircuitBreaker(breaker_threshold,
                                            breaker_cooldown_s))
            for i, s in enumerate(supervisors)]
        # disaggregation (module doc): roles is a per-replica sequence, the
        # string "auto" (health-ranked assignment by the probe loop), or
        # None (all mixed — disaggregation off)
        self._auto_roles = roles == "auto"
        if roles is not None and not self._auto_roles:
            rl = list(roles)
            if len(rl) != len(self._handles):
                raise ValueError(
                    f"roles must name every replica: got {len(rl)} roles "
                    f"for {len(self._handles)} replicas")
            bad = sorted(set(r for r in rl
                             if r not in ("prefill", "decode", "mixed")))
            if bad:
                raise ValueError(f"unknown replica role(s): {bad}")
            if "prefill" in rl and not any(r in ("decode", "mixed")
                                           for r in rl):
                raise ValueError(
                    "a disaggregated fleet needs at least one decode or "
                    "mixed replica to stream completions")
            for h, r in zip(self._handles, rl):
                h.role = r
        self.disagg_prompt_threshold = int(disagg_prompt_threshold)
        self.handoff_kv = bool(handoff_kv)
        self.fleet_prefix = bool(fleet_prefix)
        # fleet prefix directory: replica idx -> chain keys it can export
        # (refreshed by the probe loop at a slower cadence)
        self._replica_keys: Dict[int, Set[bytes]] = {}
        self._probe_count = 0
        # block size for chain-key computation at the router (immutable
        # engine config; None when the handle is not a real supervisor)
        eng = getattr(supervisors[0], "engine", None)
        self._block_size = getattr(getattr(eng, "pool", None),
                                   "block_size", None)
        # kept for add_replica: replicas joining mid-flight get the same
        # breaker configuration the founding set got
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.faults = faults
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.retry_backoff_max_s = float(retry_backoff_max_s)
        self.retry_jitter_s = float(retry_jitter_s)
        self.migration_budget = int(migration_budget)
        self.probe_interval_s = float(probe_interval_s)
        # gray-failure knobs (module doc): hedge_budget <= 0 disables
        # hedging; degrade_factor <= 0 disables ejection; hedge_ttft_s
        # None means adaptive (rolling fleet TTFT p95)
        self.hedge_ttft_s = (None if hedge_ttft_s is None
                             else float(hedge_ttft_s))
        self.hedge_budget = float(hedge_budget)
        self.degrade_factor = float(degrade_factor)
        self.degrade_window_s = float(degrade_window_s)
        self.degrade_cooldown_s = float(degrade_cooldown_s)
        self.readmit_factor = (0.7 * self.degrade_factor
                               if readmit_factor is None
                               else float(readmit_factor))
        self.score_tolerance = float(score_tolerance)
        self._ttft_window: deque = deque(maxlen=64)  # adaptive hedge p95
        self.event_sink = event_sink
        # with a profiler, the router's dispatch/retry/migration instants
        # land on its own Perfetto track (source = the profiler's source) —
        # merge the replicas' profilers into it for the one-view trace
        self.metrics = ServingMetrics(profiler)
        self.tracer = Tracer(profiler)
        self.drain_duration_s: Optional[float] = None
        self.exit_code: Optional[int] = None
        self._rng = np.random.default_rng(seed)
        self._gid = itertools.count()
        self._open: Dict[int, _Routed] = {}
        self._submitted = 0
        self._state = SupervisorState.NEW
        self._lock = threading.RLock()
        self._thread: Optional[threading.Thread] = None
        self._drain_started: Optional[float] = None
        self._wake = threading.Event()

    # -- lifecycle surface (supervisor-compatible) -----------------------------

    @property
    def state(self) -> SupervisorState:
        return self._state

    @property
    def draining(self) -> bool:
        return self._state is SupervisorState.DRAINING

    @property
    def finished(self) -> bool:
        return self._state in (SupervisorState.STOPPED,
                               SupervisorState.FAILED)

    @property
    def restarts(self) -> int:
        """Total engine restarts across replicas (``replica_restarts``)."""
        return sum(h.sup.restarts for h in self._handles)

    @property
    def replicas(self) -> List[_Replica]:
        return list(self._handles)

    def start(self) -> "Router":
        """Start every replica's worker thread plus the router's health
        monitor (runs the probe every ``probe_interval_s``)."""
        if self._thread is not None:
            raise RuntimeError("router already started")
        if self._state is SupervisorState.NEW:
            self._state = SupervisorState.RUNNING
        for h in self._handles:
            h.sup.start()
        self._thread = threading.Thread(
            target=self._monitor, name="replica-router", daemon=True)
        self._thread.start()
        return self

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the monitor thread AND every replica worker to exit.

        Joining only the monitor is not enough: replica workers are daemon
        threads, and an interpreter that finalizes while one is still inside
        a kernel launch or a graph replay tears CUDA down under it. Callers
        that need a clean process exit (the CLI) must see True here first.
        """
        t = self._thread
        if t is None:
            return self.finished
        deadline = None if timeout is None else time.monotonic() + timeout
        t.join(timeout)
        done = not t.is_alive()
        for h in self._handles:
            left = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            done = h.sup.join(left) and done
        return done

    def request_drain(self, reason: str = "drain requested") -> None:
        """Close router admissions and cascade the drain to every replica;
        the monitor/probe parks the router STOPPED once all replicas finish
        and every routed request has its terminal event."""
        with self._lock:
            if self._state in (SupervisorState.DRAINING,
                               SupervisorState.STOPPED,
                               SupervisorState.FAILED):
                return
            self._state = SupervisorState.DRAINING
            self._drain_started = time.perf_counter()
        for h in self._handles:
            if not h.killed:
                try:
                    h.sup.request_drain(reason)
                except Exception:  # noqa: BLE001 — a dead replica can't veto
                    pass
        self._wake.set()

    # -- synchronous drive loops (tests, single-threaded harnesses) ----------

    def pump(self, rounds: int = 1) -> None:
        """Deterministic inline drive: one engine step round-robined across
        live replicas, then the health probe. Incompatible with start()."""
        if self._thread is not None:
            raise RuntimeError("pump is for unstarted routers")
        if self._state is SupervisorState.NEW:
            self._state = SupervisorState.RUNNING
        for _ in range(rounds):
            for h in list(self._handles):
                if h.killed or h.sup.finished:
                    continue
                h.sup.pump(1)
            self._probe()

    def run_sync(self, max_rounds: int = 100_000) -> None:
        """Drive inline until every routed request is terminal (and, when
        draining, until every replica has finished draining)."""
        for _ in range(max_rounds):
            self.pump(1)
            if self.finished:
                return
            with self._lock:
                idle = not self._open
            if idle and not self.draining:
                return
        raise RuntimeError(f"run_sync exceeded {max_rounds} rounds")

    # -- request surface -------------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens: int, *,
               listener: Optional[EventListener] = None, **kwargs) -> int:
        """Place a request on the shortest-queue healthy replica; returns a
        router-global id. Raises ``ShuttingDown`` once draining and, when
        no replica can admit after the bounded retries, the last
        ``AdmissionRejected``/``ShuttingDown`` — the server maps both to
        structured 503s exactly as for a single supervisor."""
        if self._state in (SupervisorState.DRAINING, SupervisorState.STOPPED,
                           SupervisorState.FAILED):
            raise ShuttingDown(self._state.value)
        if self._state is SupervisorState.NEW and self._thread is None:
            self._state = SupervisorState.RUNNING
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        rec = _Routed(gid=next(self._gid), prompt=prompt,
                      max_new=int(max_new_tokens), kwargs=dict(kwargs),
                      listener=listener, t_submit=time.perf_counter())
        # one trace id for the request's whole life — a migration
        # re-submits with the SAME id, so the Perfetto view shows one
        # request hopping across replica tracks
        rec.kwargs.setdefault("trace_id", f"g{rec.gid}")
        # disaggregation: a long prompt is prefill-bound — prefer a
        # prefill replica; the boundary handoff moves it to decode after
        # the first token (module doc)
        if (self._disagg_on() and self.disagg_prompt_threshold > 0
                and len(prompt) >= self.disagg_prompt_threshold):
            rec.prefer_role = "prefill"
        with self._lock:
            self._open[rec.gid] = rec
            self._submitted += 1
        try:
            self._dispatch(rec, raising=True)
        except BaseException:
            with self._lock:
                self._close(rec, None)
            raise
        return rec.gid

    def cancel(self, gid: int, reason: str = "cancelled by client") -> bool:
        """Cancel a routed request wherever it currently lives; mid-failover
        (unassigned) requests are terminalized at the router."""
        with self._lock:
            rec = self._open.get(gid)
            if rec is None or rec.done:
                return False
            h = (self._handles[rec.replica]
                 if rec.replica is not None else None)
            lrid = rec.local_rid
        if h is not None and not h.killed and not h.sup.finished and \
                lrid is not None:
            try:
                return bool(self._call(
                    h, functools.partial(h.sup.cancel, lrid, reason)))
            except Exception:  # noqa: BLE001 — dead replica: fall through
                pass           # to router-side cancellation
        with self._lock:
            if rec.done:
                return False
            loser = self._resolve_hedge_locked(rec, hedge_won=False)
            self._close(rec, h)
        if loser is not None:
            self._cancel_quiet(*loser)
        self._emit(rec, {"event": "cancelled", "id": gid, "reason": reason})
        return True

    def stats(self) -> Dict[str, Any]:
        """Router-level stats plus per-replica health and aggregated engine
        counters — the dict ``GET /v1/stats`` serves in router mode."""
        with self._lock:
            per_replica = [{
                "replica": h.idx,
                "state": h.sup.state.value,
                "breaker_state": h.breaker.state.value,
                "restarts": h.sup.restarts,
                "live_requests": len(h.live),
                "killed": h.killed,
                "degraded": h.degraded,
                "retired": h.retired,
                "role": h.role,
                "health_score": round(h.health.score(), 4),
            } for h in self._handles]
            s: Dict[str, Any] = {
                "supervisor_state": self._state.value,
                "router_replicas": len(self._handles),
                "router_open_requests": len(self._open),
                "router_submitted": self._submitted,
                "router_retries": self.metrics.router_retries,
                "migrated_requests": self.metrics.migrated_requests,
                "migration_resume_tokens":
                    self.metrics.migration_resume_tokens,
                "hedges_fired": self.metrics.hedges_fired,
                "hedges_won": self.metrics.hedges_won,
                "hedges_cancelled": self.metrics.hedges_cancelled,
                "degraded_ejections": self.metrics.degraded_ejections,
                "proactive_migrations": self.metrics.proactive_migrations,
                "boundary_handoffs": self.metrics.boundary_handoffs,
                "handoff_fallbacks": self.metrics.handoff_fallbacks,
                "fleet_prefix_pulls": self.metrics.fleet_prefix_pulls,
                "replica_restarts": sum(h.sup.restarts
                                        for h in self._handles),
                "replicas": per_replica,
            }
        # engine-level aggregation, marshalled per live replica (outside the
        # router lock — sup.stats() may block behind a step)
        agg_keys = ("requests_finished", "failed", "cancelled", "timed_out",
                    "decode_tokens", "migrated_requests",
                    "migration_resume_tokens", "preemptions")
        for k in agg_keys:
            s.setdefault(k, 0)
        for h in list(self._handles):
            if h.sup.finished and not h.sup.join(0):
                continue  # worker mid-exit: don't race the closing cmd queue
            try:
                rs = h.sup.stats()
            except Exception:  # noqa: BLE001 — a dying replica yields no stats
                continue
            for k in agg_keys:
                s[k] = s.get(k, 0) + rs.get(k, 0)
        return s

    def prometheus_series(self) -> List[Dict]:
        """Fleet-wide Prometheus families for ``GET /metrics``: the
        router's own series under ``replica="router"`` plus every live
        replica's engine series under its replica index — one family per
        metric name, one labelled sample stream per replica. Dead replicas
        keep their last-scraped series out rather than blocking the
        scrape."""
        fams = self.metrics.prometheus_series()
        with self._lock:
            fams.append({
                "name": "tnn_serve_replica_health_score", "type": "gauge",
                "help": "Router health score per replica (1.0 = healthy, "
                        "larger = worse)",
                # per-sample labels win in label_series' merge, so each
                # sample keeps its own replica index
                "samples": [("", {"replica": str(h.idx)},
                             float(h.health.score()))
                            for h in self._handles]})
        parts = [label_series(fams, {"replica": "router"})]
        for h in list(self._handles):
            if h.sup.finished and not h.sup.join(0):
                continue  # worker mid-exit: don't race the closing queue
            try:
                fams = h.sup.prometheus_series()
            except Exception:  # noqa: BLE001 — a dying replica yields none
                continue
            parts.append(label_series(fams, {"replica": str(h.idx)}))
        return merge_series(*parts)

    def health_gauges(self) -> Dict[str, Any]:
        """Scalar health gauges for ``GET /v1/health`` — router-side
        bookkeeping only, never touching a replica's engine."""
        with self._lock:
            healthy = sum(1 for h in self._handles if h.available)
            return {
                "queue_depth": 0,   # the router places immediately
                "num_running": len(self._open),
                "replicas_total": len(self._handles),
                "replicas_healthy": healthy,
                "replicas_degraded": sum(1 for h in self._handles
                                         if h.degraded),
                "replicas_active": sum(
                    1 for h in self._handles
                    if not h.killed and not h.retired
                    and not h.sup.finished),
                "replicas_retired": sum(1 for h in self._handles
                                        if h.retired),
                "hedges_fired": self.metrics.hedges_fired,
                "hedges_won": self.metrics.hedges_won,
                "hedges_cancelled": self.metrics.hedges_cancelled,
                "degraded_ejections": self.metrics.degraded_ejections,
                "proactive_migrations": self.metrics.proactive_migrations,
                "boundary_handoffs": self.metrics.boundary_handoffs,
                "handoff_fallbacks": self.metrics.handoff_fallbacks,
                "fleet_prefix_pulls": self.metrics.fleet_prefix_pulls,
            }

    def kill_replica(self, idx: int,
                     reason: str = "replica killed") -> None:
        """Chaos actuator for the ``replica.kill`` fault site: hard-kill
        one replica as if its process died mid-step. Its live requests fail
        over to healthy replicas, streams resuming token-exact."""
        h = self._handles[idx]
        if h.killed:
            return
        h.killed = True
        h.breaker.trip()
        try:
            # the supervisor fails everything NOW; the resulting
            # "replica killed" error events drive the listeners' migration
            h.sup.kill(reason)
        except Exception:  # noqa: BLE001 — it was dying anyway
            pass
        self._probe()

    def slow_replica(self, idx: int, delay_s: float) -> None:
        """Chaos actuator for the ``replica.slow`` fault site: the replica
        stays alive and token-correct, but every engine step gains
        ``delay_s`` of wall time — the gray failure the health score (not
        the breaker: its calls still succeed) must catch. ``delay_s <= 0``
        restores full speed (recovery half of the readmit tests)."""
        from .faults import FaultPlan
        eng = self._handles[idx].sup.engine
        if getattr(eng, "faults", None) is None:
            eng.faults = FaultPlan()
        eng.faults.step_delay_s = float(max(0.0, delay_s))

    # -- elastic fleet: join / retire ------------------------------------------

    def num_active_replicas(self) -> int:
        """Replicas that can still take placements or are serving live
        streams: not killed, not retired, not finished (degraded counts —
        it may readmit). The autoscaler's actuated value."""
        with self._lock:
            return sum(1 for h in self._handles
                       if not h.killed and not h.retired
                       and not h.sup.finished)

    @property
    def open_requests(self) -> int:
        """Requests routed but not yet terminal (the autoscaler's load
        numerator)."""
        with self._lock:
            return len(self._open)

    def replica_load(self) -> Dict[int, int]:
        """Live-stream count per active replica (router-assigned counts,
        no cross-thread engine reads) — the scale-down victim picker's
        input."""
        with self._lock:
            return {h.idx: len(h.live) for h in self._handles
                    if not h.killed and not h.retired
                    and not h.sup.finished}

    def ttft_quantile(self, q: float) -> Optional[float]:
        """Fleet TTFT quantile (seconds) over the rolling window the
        adaptive hedge threshold already maintains; None until enough
        samples landed to trust a tail estimate."""
        with self._lock:
            if len(self._ttft_window) < 8:
                return None
            return float(np.percentile(
                np.asarray(list(self._ttft_window)), float(q)))

    def add_replica(self, supervisor_or_factory) -> int:
        """Scale-up join: append one replica and open it for placement.

        Accepts a ready ``EngineSupervisor`` or a zero-arg factory building
        one; the ``scale.join_fail`` chaos site fires BEFORE the factory
        runs, so an injected join failure never leaks a half-built engine.
        On a started router the new replica's worker thread starts
        immediately; on a pump-driven router it joins the next pump round.
        Returns the new replica index."""
        if self.faults is not None and self.faults.scale_join_fail():
            raise NetDrop("injected join failure: new replica never "
                          "came up")
        sup = (supervisor_or_factory()
               if not hasattr(supervisor_or_factory, "submit")
               else supervisor_or_factory)
        with self._lock:
            idx = len(self._handles)
            self._handles.append(_Replica(
                idx=idx, sup=sup,
                breaker=CircuitBreaker(self.breaker_threshold,
                                       self.breaker_cooldown_s)))
        if self._thread is not None:
            sup.start()
        self.metrics.observe_replicas(self.num_active_replicas())
        if self.tracer.enabled:
            self.tracer.instant("scale.up", replica=idx,
                                replicas=self.num_active_replicas())
        self._wake.set()
        return idx

    def retire_replica(self, idx: int,
                       reason: str = "scale-down") -> bool:
        """Zero-loss scale-down: mark one replica retired (no further
        placements), proactively migrate its live streams token-exact to
        the rest of the fleet (the recompute-resume path), then
        drain it gracefully. Streams a migration guard keeps in place
        (over budget, racing a hedge, effectively done) finish on the
        draining replica — either way no request is dropped. Returns False
        when the replica is already retired/killed/finished."""
        with self._lock:
            h = self._handles[idx]
            if h.retired or h.killed or h.sup.finished:
                return False
            others = sum(1 for o in self._handles
                         if o.idx != idx and not o.killed
                         and not o.retired and not o.sup.finished)
            if others == 0:
                return False   # never retire the last replica standing
            h.retired = True
            victims = [(self._open[gid], self._open[gid].epoch, h)
                       for gid in list(h.live) if gid in self._open
                       and self._open[gid].replica == idx]
        for rec, epoch, hh in victims:
            self._proactive_migrate(rec, epoch, hh)
        try:
            h.sup.request_drain(reason)
        except Exception:  # noqa: BLE001 — a dying replica drains itself
            pass
        self.metrics.observe_replicas(self.num_active_replicas())
        if self.tracer.enabled:
            self.tracer.instant("scale.down", replica=idx, reason=reason,
                                migrated=len(victims),
                                replicas=self.num_active_replicas())
        self._wake.set()
        return True

    # -- internals -------------------------------------------------------------

    def _call(self, h: _Replica, fn: Callable[[], Any]) -> Any:
        """Process-shaped seam for every router→replica data-plane call;
        the chaos plan's ``net.partition`` (window read — the per-round
        ``net_partition`` consult does the accounting), ``net.flaky``
        (per-replica drop), ``net.delay`` and ``net.drop`` sites fire
        here."""
        if self.faults is not None:
            if self.faults.partition_active:
                raise NetDrop(f"injected net partition: call to replica "
                              f"{h.idx} dropped")
            if self.faults.flaky_drop(h.idx):
                raise NetDrop(
                    f"injected flaky drop on call to replica {h.idx}")
            if self.faults.net_delay():
                time.sleep(self.faults.net_delay_s)
            if self.faults.net_drop():
                raise NetDrop(
                    f"injected net drop on call to replica {h.idx}")
        return fn()

    def _disagg_on(self) -> bool:
        """Any non-mixed role assigned? (Reads are GIL-atomic; callers
        that must not race hold the lock anyway.)"""
        return any(h.role != "mixed" for h in self._handles)

    @staticmethod
    def _role_ok(h: _Replica, want: str) -> bool:
        """Does replica ``h`` match the role preference ``want``? Mixed
        replicas match everything; a decode-phase request also matches
        decode-only replicas, never prefill-only ones (and vice versa)."""
        if want == "prefill":
            return h.role in ("prefill", "mixed")
        return h.role in ("decode", "mixed")

    def _pick(self, exclude: Optional[int] = None,
              prefer_role: Optional[str] = None,
              prefer: Optional[int] = None) -> Optional[_Replica]:
        """Health-score-weighted join-shortest-queue over available
        replicas (router-assigned live counts, so no cross-thread engine
        reads). The placement key is ``(live + 1) * weight`` where the
        weight is the replica's score ratio against the healthiest
        candidate, snapped to 1.0 inside the ``score_tolerance`` dead-band
        — a fleet with uniform scores routes byte-identical to pure JSQ.

        Disaggregation narrows the pool by role preference first: an
        explicit ``prefer_role``, else (when any role is assigned)
        "decode" — short requests belong on the decode side. An empty
        role-matched pool falls back to the full pool: roles are
        preferences, not admission gates. ``prefer`` is a single-replica
        affinity hint (the KV-handoff target) honored when available.

        DEGRADED replicas are excluded, except: past ``degrade_cooldown_s``
        one recovery-probe dispatch is admitted (so the replica can prove
        itself), and when *no* non-degraded replica is available the
        degraded ones are better than failing the request."""
        with self._lock:
            now = time.monotonic()
            pool = [h for h in self._handles
                    if h.available and h.idx != exclude]
            degraded_alive = [
                h for h in self._handles
                if h.degraded and not h.killed and not h.retired
                and not h.sup.finished
                and h.breaker.allows() and h.idx != exclude]
            probes = [h for h in degraded_alive
                      if not h.recovery_probing
                      and h.degraded_at is not None
                      and now - h.degraded_at >= self.degrade_cooldown_s]
            if pool:
                pool = pool + probes
            else:
                pool = probes or degraded_alive
            if not pool:
                return None
            if prefer_role is not None or self._disagg_on():
                want = prefer_role or "decode"
                matched = [h for h in pool if self._role_ok(h, want)]
                if matched:
                    pool = matched
            if prefer is not None:
                for h in pool:
                    if h.idx == prefer:
                        h.breaker.on_dispatch()
                        if h.degraded:
                            h.recovery_probing = True
                        return h
            scores = {h.idx: h.health.score() for h in pool}
            ref = min(scores.values())
            best: Optional[_Replica] = None
            best_key = 0.0
            for h in pool:
                ratio = scores[h.idx] / ref if ref > 0 else 1.0
                weight = (ratio if ratio >= 1.0 + self.score_tolerance
                          else 1.0)
                key = (len(h.live) + 1.0) * weight
                if best is None or key < best_key:
                    best, best_key = h, key
            best.breaker.on_dispatch()
            if best.degraded:
                best.recovery_probing = True
            return best

    def _deadline_left(self, rec: _Routed) -> Optional[float]:
        dl = rec.kwargs.get("deadline_s")
        if dl is None:
            return None
        return float(dl) - (time.perf_counter() - rec.t_submit)

    def _resume_args(self, rec: _Routed):
        """(prompt, max_new, kwargs) for (re-)dispatch: the committed
        prefix becomes an extended prompt and the generation budget shrinks
        by what was already streamed — the new replica's prefill samples
        the successor of the last emitted token (token-exact for greedy)."""
        prompt = (np.concatenate(
            [rec.prompt, np.asarray(rec.emitted, np.int32)])
            if rec.emitted else rec.prompt)
        kwargs = dict(rec.kwargs)
        left = self._deadline_left(rec)
        if left is not None:
            kwargs["deadline_s"] = max(left, 1e-3)
        return prompt, rec.max_new - len(rec.emitted), kwargs

    def _dispatch(self, rec: _Routed, *, raising: bool = False) -> None:
        """Bounded placement: up to ``max_retries`` re-attempts with
        exponential backoff + seeded jitter, each respecting the request
        deadline. With ``raising`` (the synchronous submit path) a final
        admission failure propagates to the caller; otherwise (migration)
        it becomes a terminal error event."""
        last: Optional[BaseException] = None
        attempt = 0
        while attempt <= self.max_retries:   # explicit retry budget
            if attempt:
                self.metrics.observe_router_retry()
                if self.tracer.enabled:
                    self.tracer.instant(
                        "router.retry", trace=rec.kwargs.get("trace_id"),
                        gid=rec.gid, attempt=attempt)
                delay = min(self.retry_backoff_s * (2 ** (attempt - 1)),
                            self.retry_backoff_max_s)
                delay += float(self._rng.random()) * self.retry_jitter_s
                left = self._deadline_left(rec)
                if left is not None and delay >= left:
                    self._finish_failed(
                        rec, "timeout",
                        f"deadline exceeded during failover retries "
                        f"(attempt {attempt}/{self.max_retries})")
                    return
                if delay > 0:
                    time.sleep(delay)
            attempt += 1
            h = self._pick(prefer_role=rec.prefer_role,
                           prefer=(rec.prefer_replica
                                   if attempt == 1 else None))
            if h is None:
                last = ShuttingDown("no healthy replica "
                                    "(all dead or breakers open)")
                continue
            if (self.fleet_prefix and attempt == 1
                    and not rec.emitted and rec.migrations == 0):
                # shared prefix cache: before the first prefill, pull any
                # peer-resident prefix blocks over (best-effort; a failed
                # pull just means the prefill recomputes them)
                self._fleet_prefix_pull(rec, h)
            epoch = rec.epoch
            listener = self._listener_for(rec, epoch, h)
            prompt, max_new, kwargs = self._resume_args(rec)
            t_call = time.perf_counter()
            try:
                lrid = self._call(h, functools.partial(
                    h.sup.submit, prompt, max_new,
                    listener=listener, **kwargs))
            except AdmissionRejected as e:
                # backpressure, not failure: the replica is healthy, just
                # full — retry elsewhere without charging its breaker
                last = e
                continue
            except (NetDrop, ShuttingDown) as e:
                h.breaker.record_failure()
                h.health.observe_outcome(False)
                last = e
                continue
            except (ValueError, TypeError) as e:
                # a malformed request is the REQUEST's fault, not the
                # replica's: no breaker hit, no retry
                if raising:
                    raise
                self._finish_failed(rec, "error", str(e))
                return
            with self._lock:
                rec.replica = h.idx
                rec.local_rid = lrid
                rec.t_dispatch = time.perf_counter()
                h.live.add(rec.gid)
                h.breaker.record_success()
                h.health.observe_dispatch(rec.t_dispatch - t_call)
                h.health.observe_outcome(True)
            if self.tracer.enabled:
                self.tracer.instant(
                    "router.dispatch", trace=rec.kwargs.get("trace_id"),
                    gid=rec.gid, replica=h.idx, rid=lrid)
            return
        if raising and last is not None:
            raise last
        self._finish_failed(
            rec, "error",
            f"router retries exhausted ({self.max_retries}) — "
            f"last failure: {last}")

    # -- event plumbing --------------------------------------------------------

    def _listener_for(self, rec: _Routed, epoch: int,
                      h: _Replica) -> EventListener:
        def listener(ev: dict) -> None:
            self._on_event(rec, epoch, h, ev)
        return listener

    def _on_event(self, rec: _Routed, epoch: int, h: _Replica,
                  ev: dict) -> None:
        kind = ev.get("event")
        migrate_reason: Optional[str] = None
        out: Optional[dict] = None
        boundary = False       # prefill→decode handoff due after the emit
        loser = None           # (handle, lrid) to cancel outside the lock
        with self._lock:
            if rec.done:
                return
            if epoch == rec.epoch:
                # a primary token or terminal (except a replica-level
                # error, which _migrate resolves by promoting the hedge)
                # wins any pending race: the duplicate is the loser
                if rec.hedge_epoch is not None and not (
                        kind == "error"
                        and self._replica_level(ev.get("reason", ""))):
                    loser = self._resolve_hedge_locked(rec, hedge_won=False)
            elif rec.hedge_epoch is not None and epoch == rec.hedge_epoch:
                if kind in ("token", "done"):
                    # the duplicate won the race: promote it to primary,
                    # cancel the original stream quietly
                    loser = self._resolve_hedge_locked(rec, hedge_won=True)
                    h = self._handles[rec.replica]
                    epoch = rec.epoch
                else:
                    # the duplicate failed / was cancelled: a hedge loser
                    # never charges a breaker — drop it and move on
                    self._resolve_hedge_locked(rec, hedge_won=False)
                    return
            else:
                return  # stale epoch: a failed-over replica still talking
            if kind == "token":
                rec.emitted.append(int(ev["token"]))
                if rec.ttft_s is None:
                    rec.ttft_s = time.perf_counter() - rec.t_submit
                    self._ttft_window.append(rec.ttft_s)
                    # prefill→decode boundary: the FIRST token from a
                    # prefill replica triggers the handoff (after the
                    # token is emitted — TTFT comes from the prefill side)
                    if (h.role == "prefill"
                            and rec.hedge_epoch is None
                            and rec.migrations < self.migration_budget
                            and rec.max_new - len(rec.emitted) > 0):
                        boundary = True
                out = {"event": "token", "id": rec.gid,
                       "token": int(ev["token"])}
            elif kind == "done":
                self._close(rec, h)
                h.breaker.record_success()
                out = {"event": "done", "id": rec.gid,
                       "tokens": list(rec.emitted),
                       "finish_reason": ev.get("finish_reason", ""),
                       "ttft_ms": round((rec.ttft_s or 0.0) * 1e3, 3)}
                self._enrich_terminal(rec, ev, out)
            elif kind == "error" and \
                    self._replica_level(ev.get("reason", "")):
                migrate_reason = ev.get("reason", "replica failure")
            else:  # request-level error / cancelled / timeout: pass through
                self._close(rec, h)
                out = {"event": kind, "id": rec.gid,
                       "reason": ev.get("reason", "")}
                self._enrich_terminal(rec, ev, out)
        if loser is not None:
            self._cancel_quiet(*loser)
        if migrate_reason is not None:
            self._migrate(rec, epoch, h, migrate_reason)
            return
        if out is not None:
            self._emit(rec, out)
        if boundary:
            self._boundary_handoff(rec, epoch, h)

    def _resolve_hedge_locked(self, rec: _Routed, *,
                              hedge_won: bool):
        """Resolve a pending hedge race (caller holds the lock). With
        ``hedge_won`` the duplicate stream becomes the primary and the
        original is the loser; otherwise the duplicate loses. Returns the
        loser's ``(handle, local_rid)`` for a quiet cancel outside the
        lock — a hedge loser never charges a breaker — or None."""
        if rec.hedge_epoch is None:
            return None
        if hedge_won:
            loser = (rec.replica, rec.local_rid)
            if rec.replica is not None:
                self._handles[rec.replica].live.discard(rec.gid)
            rec.epoch = rec.hedge_epoch
            rec.replica = rec.hedge_replica
            rec.local_rid = rec.hedge_local_rid
            self.metrics.observe_hedge_won()
        else:
            loser = (rec.hedge_replica, rec.hedge_local_rid)
            if rec.hedge_replica is not None:
                self._handles[rec.hedge_replica].live.discard(rec.gid)
        rec.hedge_epoch = None
        rec.hedge_replica = None
        rec.hedge_local_rid = None
        self.metrics.observe_hedge_cancelled()
        idx, lrid = loser
        if idx is None or lrid is None:
            return None
        return self._handles[idx], lrid

    def _cancel_quiet(self, h: _Replica, lrid: int) -> None:
        """Best-effort cancel of a superseded stream (hedge loser or
        proactively migrated original). Failure is fine: the epoch guard
        drops whatever the stream still says, and no breaker is charged."""
        if h.killed or h.sup.finished:
            return
        try:
            self._call(h, functools.partial(
                h.sup.cancel, lrid, "superseded stream"))
        except Exception:  # noqa: BLE001 — quiet by design
            pass

    def _enrich_terminal(self, rec: _Routed, ev: dict, out: dict) -> None:
        """Carry the replica's observability fields across the gid/rid
        translation: trace_id (router-assigned, so constant across
        migrations) and the engine's latency breakdown, with the
        router-level migration count layered on top."""
        tid = rec.kwargs.get("trace_id")
        if tid:
            out["trace_id"] = tid
        bd = ev.get("latency_breakdown")
        if isinstance(bd, dict):
            bd = dict(bd)
            bd["migrations"] = bd.get("migrations", 0) + rec.migrations
            out["latency_breakdown"] = bd

    @staticmethod
    def _replica_level(reason: str) -> bool:
        """Is this terminal error the replica dying (migrate) rather than
        the request failing (pass through)? The engine-level poison marker
        wins: a request that exhausted its ENGINE migration budget must
        fail cleanly, not bounce to the next replica."""
        if "migration budget exhausted" in reason:
            return False
        return any(m in reason for m in _REPLICA_FAILURE_MARKERS)

    def _migrate(self, rec: _Routed, epoch: int, h: _Replica,
                 reason: str) -> None:
        """Fail one routed request over to another replica, mid-stream."""
        with self._lock:
            if rec.done or rec.epoch != epoch:
                return
            h.breaker.record_failure()
            h.health.observe_outcome(False)
            h.live.discard(rec.gid)
            if rec.hedge_epoch is not None:
                # a duplicate stream is already racing on another replica:
                # promote it in place of a recompute-resume re-dispatch.
                # (While a hedge is pending no tokens have streamed, so
                # the duplicate's full-prompt run is token-exact.)
                rec.epoch = rec.hedge_epoch
                rec.replica = rec.hedge_replica
                rec.local_rid = rec.hedge_local_rid
                rec.hedge_epoch = None
                rec.hedge_replica = None
                rec.hedge_local_rid = None
                self.metrics.observe_hedge_won()
                promoted_to = rec.replica
            else:
                promoted_to = None
                rec.epoch_seq += 1
                rec.epoch = rec.epoch_seq
                rec.replica = None
                rec.local_rid = None
            if promoted_to is not None:
                out = None
            elif rec.migrations >= self.migration_budget:
                self._close(rec, None)
                out = {"event": "error", "id": rec.gid,
                       "reason": f"router migration budget exhausted "
                                 f"({self.migration_budget}) — "
                                 f"last failure: {reason}"}
            else:
                rec.migrations += 1
                out = None
            remaining = rec.max_new - len(rec.emitted)
        if promoted_to is not None:
            if self.tracer.enabled:
                self.tracer.instant(
                    "router.migrate", trace=rec.kwargs.get("trace_id"),
                    gid=rec.gid, from_replica=h.idx,
                    promoted_hedge=True, to_replica=promoted_to)
            return
        if out is not None:
            self._emit(rec, out)
            return
        if remaining <= 0:
            # everything was streamed before the replica died; only the
            # terminal event was lost — synthesize it
            with self._lock:
                if rec.done:
                    return
                self._close(rec, None)
            out = {"event": "done", "id": rec.gid,
                   "tokens": list(rec.emitted),
                   "finish_reason": "length",
                   "ttft_ms": round((rec.ttft_s or 0.0) * 1e3, 3)}
            self._enrich_terminal(rec, {}, out)
            self._emit(rec, out)
            return
        self.metrics.observe_migration(len(rec.prompt) + len(rec.emitted))
        if self.tracer.enabled:
            self.tracer.instant(
                "router.migrate", trace=rec.kwargs.get("trace_id"),
                gid=rec.gid, from_replica=h.idx,
                emitted=len(rec.emitted))
        self._dispatch(rec)   # failure here emits the terminal error event

    def _finish_failed(self, rec: _Routed, kind: str, reason: str) -> None:
        with self._lock:
            if rec.done:
                return
            self._close(rec, None)
        out = {"event": kind, "id": rec.gid, "reason": reason}
        self._enrich_terminal(rec, {}, out)
        self._emit(rec, out)

    def _close(self, rec: _Routed, h: Optional[_Replica]) -> None:
        """Caller holds the lock."""
        rec.done = True
        self._open.pop(rec.gid, None)
        if rec.hedge_replica is not None:   # belt and braces: no gid may
            self._handles[rec.hedge_replica].live.discard(rec.gid)
        if h is not None:                   # outlive its record anywhere
            h.live.discard(rec.gid)
        elif rec.replica is not None:
            self._handles[rec.replica].live.discard(rec.gid)

    def _emit(self, rec: _Routed, ev: dict) -> None:
        for sink in (rec.listener, self.event_sink):
            if sink is None:
                continue
            try:
                sink(ev)
            except Exception:  # noqa: BLE001 — a bad listener can't kill us
                pass

    # -- gray-failure tolerance: scoring / ejection / hedging ------------------

    def _update_health(self) -> None:
        """Sample every live replica's ``health_gauges()`` into its EWMA
        score, then run the degrade/readmit state machine (module doc).
        Gauges are unreachable during a partition window, so scores keep
        their last values (staleness keeps climbing on its own)."""
        proactive = []
        with self._lock:
            # retired replicas are leaving anyway: sampling them would
            # skew the fleet median and ejecting them is meaningless
            alive = [h for h in self._handles
                     if not h.killed and not h.retired
                     and not h.sup.finished]
            partitioned = (self.faults is not None
                           and self.faults.partition_active)
            if not partitioned:
                for h in alive:
                    try:
                        g = h.sup.health_gauges()
                    except Exception:  # noqa: BLE001 — dying replica
                        continue
                    h.health.observe_gauges(
                        float(g.get("step_latency_s", 0.0)),
                        float(g.get("queue_depth", 0))
                        + float(g.get("num_running", 0)),
                        float(g.get("age_s", 0.0)))
            if self.degrade_factor <= 0 or len(alive) < 2:
                return
            now = time.monotonic()
            scores = {h.idx: h.health.score() for h in alive}
            # role-aware baseline: a disaggregated fleet is heterogeneous
            # BY DESIGN — the prefill replica eats every long prompt, so
            # its step latency and queue depth are structurally inflated
            # relative to decode peers. Judged against the fleet-wide
            # median it would be ejected for doing exactly its job; judged
            # against same-role peers only genuine gray failure stands
            # out. With roles off every replica is "mixed" and this
            # degenerates to the fleet-wide median unchanged.
            med_by_role = {}
            for role in set(a.role for a in alive):
                grp = [scores[a.idx] for a in alive if a.role == role]
                med_by_role[role] = (statistics.median(grp), len(grp))
            non_degraded = sum(1 for h in alive if not h.degraded)
            for h in alive:
                sc = scores[h.idx]
                med, n_peers = med_by_role[h.role]
                if n_peers < 2:
                    # a role singleton has no like-for-like baseline:
                    # never eject it (the breaker + restart path still
                    # covers hard failure), and readmit it if a past
                    # ejection stranded it in a group of one
                    h.suspect_since = None
                    if h.degraded:
                        h.degraded = False
                        h.readmit_since = None
                        h.degraded_at = None
                        h.recovery_probing = False
                    continue
                if not h.degraded:
                    if med > 0 and sc > self.degrade_factor * med:
                        if h.suspect_since is None:
                            h.suspect_since = now
                            if self.tracer.enabled:
                                self.tracer.instant(
                                    "router.degrade", replica=h.idx,
                                    score=round(sc, 4),
                                    median=round(med, 4))
                        elif (now - h.suspect_since
                              >= self.degrade_window_s
                              and non_degraded > 1):
                            # never eject the last non-degraded replica
                            proactive.extend(self._eject_locked(h, sc, med))
                            non_degraded -= 1
                    else:
                        h.suspect_since = None
                else:
                    if sc <= self.readmit_factor * med:
                        if h.readmit_since is None:
                            h.readmit_since = now
                        elif (now - h.readmit_since
                              >= self.degrade_window_s):
                            h.degraded = False
                            h.suspect_since = None
                            h.readmit_since = None
                            h.degraded_at = None
                            h.recovery_probing = False
                            if self.tracer.enabled:
                                self.tracer.instant(
                                    "router.readmit", replica=h.idx,
                                    score=round(sc, 4))
                    else:
                        h.readmit_since = None
                    if not h.live:
                        # the probe stream finished: allow the next one
                        h.recovery_probing = False
        for rec, epoch, h in proactive:
            self._proactive_migrate(rec, epoch, h)

    def _eject_locked(self, h: _Replica, score: float, median: float):
        """Eject one replica as DEGRADED (caller holds the lock). Returns
        the ``(rec, epoch, handle)`` list of its live streams to
        proactively migrate outside the lock."""
        h.degraded = True
        h.degraded_at = time.monotonic()
        h.suspect_since = None
        h.readmit_since = None
        h.recovery_probing = False
        self.metrics.observe_ejection()
        if self.tracer.enabled:
            self.tracer.instant("router.eject", replica=h.idx,
                                score=round(score, 4),
                                median=round(median, 4),
                                live=len(h.live))
        return [(self._open[gid], self._open[gid].epoch, h)
                for gid in list(h.live) if gid in self._open
                and self._open[gid].replica == h.idx]

    def _proactive_migrate(self, rec: _Routed, epoch: int,
                           h: _Replica) -> None:
        """Pull one live stream off a degraded replica before it fails
        outright — the same token-exact recompute-resume path as crash
        migration, but the old stream is cancelled quietly (the replica
        is alive, merely slow) and no breaker is charged. Streams that
        are over budget, already racing a hedge, or effectively done
        finish in place instead."""
        with self._lock:
            if (rec.done or rec.epoch != epoch or rec.replica != h.idx
                    or rec.hedge_epoch is not None
                    or rec.migrations >= self.migration_budget
                    or rec.max_new - len(rec.emitted) <= 0):
                return
            old_lrid = rec.local_rid
            h.live.discard(rec.gid)
            rec.migrations += 1
            rec.epoch_seq += 1
            rec.epoch = rec.epoch_seq
            rec.replica = None
            rec.local_rid = None
        if old_lrid is not None:
            self._cancel_quiet(h, old_lrid)
        self.metrics.observe_migration(len(rec.prompt) + len(rec.emitted))
        self.metrics.observe_proactive_migration()
        if self.tracer.enabled:
            self.tracer.instant(
                "router.migrate", trace=rec.kwargs.get("trace_id"),
                gid=rec.gid, from_replica=h.idx, proactive=True,
                emitted=len(rec.emitted))
        self._dispatch(rec)   # failure here emits the terminal error event

    # -- disaggregated serving: boundary handoff / fleet prefix cache ----------

    def _boundary_handoff(self, rec: _Routed, epoch: int,
                          h: _Replica) -> None:
        """Move one stream from its prefill replica to a decode replica at
        the first-token boundary — the same epoch-guarded, token-exact
        migration path as crash failover, but the old stream is cancelled
        quietly (the prefill replica is healthy) and no breaker is
        charged. With ``handoff_kv`` the prefix KV ships ahead of the
        re-dispatch through the digest-verified export/adopt path, so the
        resume prefill on the decode side hits the adopted blocks instead
        of recomputing them; ANY failure along that path (corrupt wire
        bytes, pool full, the target dying mid-adopt) degrades to plain
        recompute-resume. Streams that resolved, hedged, or ran out of
        migration budget while we worked finish in place."""
        with self._lock:
            if self._state is not SupervisorState.RUNNING:
                # a draining fleet refuses new engine-level submits, so
                # cancelling the healthy source stream would strand the
                # resume in rejected re-dispatches — finish where we are
                return
        target = self._pick(exclude=h.idx, prefer_role="decode")
        if target is None:
            return   # no decode-side capacity: finish where we are
        handed = 0
        if self.handoff_kv:
            try:
                toks = (np.concatenate(
                    [rec.prompt, np.asarray(rec.emitted, np.int32)])
                    if rec.emitted else rec.prompt)
                exports = self._call(h, functools.partial(
                    h.sup.export_prefix, toks))
                if exports:
                    handed = int(self._call(target, functools.partial(
                        target.sup.adopt_prefix, exports)))
            except Exception:  # noqa: BLE001 — degrade to recompute-resume
                handed = 0
        with self._lock:
            if (rec.done or rec.epoch != epoch or rec.replica != h.idx
                    or rec.hedge_epoch is not None
                    or rec.migrations >= self.migration_budget
                    or rec.max_new - len(rec.emitted) <= 0):
                return
            old_lrid = rec.local_rid
            h.live.discard(rec.gid)
            rec.migrations += 1
            rec.epoch_seq += 1
            rec.epoch = rec.epoch_seq
            rec.replica = None
            rec.local_rid = None
            rec.prefer_role = "decode"
            rec.prefer_replica = target.idx
        if old_lrid is not None:
            self._cancel_quiet(h, old_lrid)
        self.metrics.observe_boundary_handoff()
        if self.handoff_kv and handed == 0:
            self.metrics.observe_handoff_fallback()
        self.metrics.observe_migration(len(rec.prompt) + len(rec.emitted))
        if self.tracer.enabled:
            self.tracer.instant(
                "router.handoff", trace=rec.kwargs.get("trace_id"),
                gid=rec.gid, from_replica=h.idx, to_replica=target.idx,
                adopted_blocks=handed, kv=self.handoff_kv)
        self._dispatch(rec)   # failure here emits the terminal error event

    def _fleet_prefix_pull(self, rec: _Routed, h: _Replica) -> None:
        """Shared prefix cache: before ``rec``'s first prefill on replica
        ``h``, find the peer whose directory entry covers the longest
        leading chain of the prompt — strictly longer than what ``h``
        already holds — and pull those blocks over through the verified
        export/adopt path. Entirely best-effort: any miss, stale directory
        entry, or wire failure leaves the prefill to recompute."""
        if self._block_size is None or len(rec.prompt) < self._block_size:
            return
        keys = chain_keys(rec.prompt, self._block_size)
        if not keys:
            return
        with self._lock:
            directory = dict(self._replica_keys)
        have = directory.get(h.idx, set())
        lead = 0
        while lead < len(keys) and keys[lead] in have:
            lead += 1
        if lead >= len(keys):
            return   # the chosen replica already holds the whole chain
        best: Optional[_Replica] = None
        best_run = lead
        for idx, ks in directory.items():
            if idx == h.idx:
                continue
            hh = self._handles[idx]
            if hh.killed or hh.sup.finished:
                continue
            run = 0
            while run < len(keys) and keys[run] in ks:
                run += 1
            if run > best_run:
                best, best_run = hh, run
        if best is None:
            return
        try:
            exports = self._call(best, functools.partial(
                best.sup.export_prefix, rec.prompt, best_run))
            if not exports:
                return
            adopted = int(self._call(h, functools.partial(
                h.sup.adopt_prefix, exports)))
        except Exception:  # noqa: BLE001 — a failed pull is a cache miss
            self.metrics.observe_handoff_fallback()
            return
        if adopted:
            self.metrics.observe_fleet_prefix_pull()
            with self._lock:
                self._replica_keys.setdefault(h.idx, set()).update(
                    k for k, _, _ in exports)
            if self.tracer.enabled:
                self.tracer.instant(
                    "router.prefix_pull", gid=rec.gid, source=best.idx,
                    target=h.idx, blocks=adopted)

    def _refresh_prefix_dir(self) -> None:
        """Probe-loop refresh of the fleet prefix directory: which replica
        can export which chain keys. Dead/retired replicas drop out; a
        replica that cannot answer keeps its last entry (content
        addressing makes staleness safe — a stale key at worst yields an
        empty export, never wrong bytes)."""
        for h in list(self._handles):
            if h.killed or h.retired or h.sup.finished:
                with self._lock:
                    self._replica_keys.pop(h.idx, None)
                continue
            try:
                ks = self._call(h, h.sup.prefix_keys)
            except Exception:  # noqa: BLE001 — keep the last snapshot
                continue
            with self._lock:
                self._replica_keys[h.idx] = set(ks)

    def _auto_assign_roles(self) -> None:
        """Dynamic role assignment (``roles="auto"``): rank live replicas
        by health score and dedicate the healthiest half to decode (the
        latency-bound side), the rest to prefill. A one-replica fleet
        stays mixed. Roles are preferences, so reassignment never strands
        a stream — at worst the next dispatch prefers a different
        replica."""
        with self._lock:
            alive = [h for h in self._handles
                     if not h.killed and not h.retired
                     and not h.sup.finished]
            if len(alive) < 2:
                for h in alive:
                    h.role = "mixed"
                return
            ranked = sorted(alive, key=lambda h: (h.health.score(), h.idx))
            n_decode = (len(ranked) + 1) // 2
            for i, h in enumerate(ranked):
                want = "decode" if i < n_decode else "prefill"
                if h.role != want:
                    h.role = want
                    if self.tracer.enabled:
                        self.tracer.instant("router.role", replica=h.idx,
                                            role=want)

    def _hedge_threshold_locked(self) -> Optional[float]:
        """The TTFT past which a request gets hedged (caller holds the
        lock): the fixed ``hedge_ttft_s`` when configured, else adaptive —
        the rolling fleet TTFT p95, None until enough samples landed to
        trust a tail estimate."""
        if self.hedge_ttft_s is not None:
            return self.hedge_ttft_s
        if len(self._ttft_window) < 8:
            return None
        return float(np.percentile(np.asarray(list(self._ttft_window)),
                                   95.0))

    def _maybe_hedge(self) -> None:
        """Duplicate overdue first-token requests onto the next-best
        replica. The budget (``hedge_budget`` × open requests) is
        consulted before EVERY fire, so amplification stays bounded even
        when the whole fleet stalls at once."""
        if self.hedge_budget <= 0:
            return
        now = time.perf_counter()
        with self._lock:
            thr = self._hedge_threshold_locked()
            if thr is None:
                return
            pending = sum(1 for r in self._open.values()
                          if r.hedge_epoch is not None)
            # a request still awaiting its prefill→decode boundary
            # (prefer_role == "prefill") is slow BY SELECTION — it is a
            # long prompt on the prefill tier, and the boundary handoff
            # is already the migration that will move it. Hedging it
            # would duplicate the most expensive prefill in the fleet
            # onto a decode replica, defeating the disaggregation.
            overdue = [r for r in self._open.values()
                       if not r.done and r.ttft_s is None and not r.hedged
                       and r.replica is not None
                       and r.local_rid is not None
                       and r.prefer_role != "prefill"
                       and now - r.t_dispatch > thr]
        for rec in overdue:
            with self._lock:
                cap = max(1, int(self.hedge_budget * len(self._open)))
                if pending >= cap:
                    return
            if self._fire_hedge(rec):
                pending += 1

    def _fire_hedge(self, rec: _Routed) -> bool:
        """Race one duplicate of ``rec`` on another replica under a fresh
        epoch. Returns True when the duplicate is actually in flight."""
        with self._lock:
            if (rec.done or rec.ttft_s is not None or rec.hedged
                    or rec.hedge_epoch is not None or rec.replica is None):
                return False
            primary = rec.replica
            rec.epoch_seq += 1
            epoch = rec.epoch_seq
            prompt, max_new, kwargs = self._resume_args(rec)
        hh = self._pick(exclude=primary)
        if hh is None:
            return False   # nowhere to hedge to; the primary keeps running
        listener = self._listener_for(rec, epoch, hh)
        try:
            lrid = self._call(hh, functools.partial(
                hh.sup.submit, prompt, max_new,
                listener=listener, **kwargs))
        except Exception:  # noqa: BLE001 — a failed hedge is a non-event:
            return False   # the primary is still running; no terminal here
        with self._lock:
            if rec.done or rec.ttft_s is not None \
                    or rec.hedge_epoch is not None:
                stale = True   # the race resolved while we submitted
            else:
                stale = False
                rec.hedged = True
                rec.hedge_epoch = epoch
                rec.hedge_replica = hh.idx
                rec.hedge_local_rid = lrid
                hh.live.add(rec.gid)
                hh.breaker.record_success()
                self.metrics.observe_hedge_fired()
        if stale:
            self._cancel_quiet(hh, lrid)
            return False
        if self.tracer.enabled:
            self.tracer.instant(
                "router.hedge", trace=rec.kwargs.get("trace_id"),
                gid=rec.gid, replica=hh.idx, primary=primary)
        return True

    # -- health probe / lifecycle convergence ----------------------------------

    def _probe(self) -> None:
        """Health probe: advance the partition-window consult, migrate
        requests stranded on dead replicas (belt and braces over the event
        path), drop hedges stranded on dead replicas (the primary is still
        alive), refresh health scores and the degrade/readmit state
        machine, fire overdue hedges, then converge the router's
        lifecycle state."""
        if self.faults is not None and (
                self.faults.net_partition_prob > 0
                or self.faults.net_partition_calls):
            # once per probe round: the window accounting consult
            self.faults.net_partition()
        with self._lock:
            stranded = [
                (r, r.epoch, self._handles[r.replica])
                for r in list(self._open.values())
                if not r.done and r.replica is not None
                and (self._handles[r.replica].killed
                     or self._handles[r.replica].sup.finished)]
        for r, epoch, h in stranded:
            self._migrate(r, epoch, h,
                          f"replica {h.idx} dead ({h.sup.state.value})")
        self._release_finished()
        with self._lock:
            for r in list(self._open.values()):
                if r.hedge_replica is not None and (
                        self._handles[r.hedge_replica].killed
                        or self._handles[r.hedge_replica].sup.finished):
                    self._resolve_hedge_locked(r, hedge_won=False)
        self._update_health()
        if self._auto_roles:
            self._auto_assign_roles()
        if self.fleet_prefix:
            # directory refresh at a slower cadence than the health probe:
            # prefix publication changes far slower than health does
            self._probe_count += 1
            if self._probe_count % 4 == 1:
                self._refresh_prefix_dir()
        self._maybe_hedge()
        # keep the tnn_serve_replicas gauge fresh even when fleet changes
        # happen through kill/drain rather than an explicit scale event
        self.metrics.observe_replicas(self.num_active_replicas())
        with self._lock:
            all_dead = all(h.killed or h.sup.finished
                           for h in self._handles)
            leftovers = ([r for r in self._open.values() if not r.done]
                         if all_dead else [])
        for r in leftovers:
            self._finish_failed(r, "error",
                                "no healthy replica left to serve request")
        with self._lock:
            if self.finished:
                return
            all_dead = all(h.killed or h.sup.finished
                           for h in self._handles)
            if not all_dead or self._open:
                return
            if self._state is SupervisorState.DRAINING:
                started = self._drain_started
                self.drain_duration_s = (
                    time.perf_counter() - started
                    if started is not None else 0.0)
                self._state = SupervisorState.STOPPED
                self.exit_code = 0
            elif self._state is SupervisorState.RUNNING:
                # every replica died out from under a running router
                self._state = SupervisorState.FAILED
                self.exit_code = 1

    def _release_finished(self) -> None:
        """Give back the device memory of retired or killed replicas whose
        worker has exited: their pools' pages and captured graphs
        (``EngineSupervisor.release``). Nothing routes to them again."""
        with self._lock:
            done = [h for h in self._handles
                    if (h.retired or h.killed) and not h.released
                    and h.sup.finished]
        for h in done:
            h.released = h.sup.release()   # False while the worker exits

    def _monitor(self) -> None:
        while not self.finished:
            self._probe()
            self._wake.wait(self.probe_interval_s)
            self._wake.clear()
