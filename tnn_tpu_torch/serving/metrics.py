"""Serving metrics (``tnn_tpu.serving.metrics``): TTFT, per-token latency,
queue depth, pool occupancy, throughput, and a Prometheus exposition.

Three surfaces share one observation path:

- ``summary()``: the flat dict ``engine.stats()`` and ``GET /v1/stats``
  report (the JAX package's key set, plus the port's own keys: ``finished``,
  ``prefills``, ``prefill_ms_mean``, ``overlap_adopted``, ...);
- ``prometheus_series()``: counter, gauge and histogram families that
  ``render_prometheus`` turns into text format 0.0.4 for ``GET /metrics``;
  the router merges the replicas' families under a ``replica`` label
  (``label_series``, ``merge_series``);
- ``Profiler.tick`` counters, when a profiler is wired, under the same
  ``serve.*`` keys, so a traced run's counters sit beside its spans.

Every ``_tick`` key is registered in ``EXPOSITION``. Latency series are
capped by a deterministic reservoir (Algorithm R, an RNG seeded from the
series name), so a long serve holds a bounded number of samples and the
same observations keep the same samples. All clocks are host wall clocks.
"""
from __future__ import annotations

import math
import random
import time
from typing import Dict, Iterator, List, Optional, Tuple

from ..profiling.profiler import Profiler

#: default per-series sample cap (reservoir size). Large enough that the
#: smoke/bench workloads never evict (their aggregates stay exact), small
#: enough that a sustained run holds a few hundred KB of floats total.
RESERVOIR_SIZE = 2048

#: fixed histogram bucket upper bounds (seconds) for the latency families.
#: Fixed — not adaptive — so scrapes from different replicas/restarts are
#: always mergeable and dashboards never see bucket churn.
LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

#: The exposition registry: every ``_tick`` key maps to
#: ``(prometheus name, type, help, summary key)`` where ``type`` is
#: "counter" (cumulative sum of ticked values) or "histogram" (the tick's
#: value stream also feeds a fixed-bucket histogram), and ``summary key``
#: names the ``summary()`` entry through which the series is reachable.
#: The ``unregistered-metric-key`` lint rule cross-checks all three:
#: ticked keys must appear here, and the named summary keys must appear
#: as literals in ``summary()``.
EXPOSITION: Dict[str, Tuple[str, str, str, str]] = {
    "serve.ttft_s": (
        "tnn_serve_ttft_seconds", "histogram",
        "Time to first token per request", "ttft_ms_p50"),
    "serve.token_latency_s": (
        "tnn_serve_token_latency_seconds", "histogram",
        "Per-token decode latency (step wall time per emitted token)",
        "token_latency_ms_p50"),
    "serve.step_latency_s": (
        "tnn_serve_step_latency_seconds", "histogram",
        "Engine step wall time", "step_latency_ms_p50"),
    "serve.queue_wait_s": (
        "tnn_serve_queue_wait_seconds", "histogram",
        "Time spent QUEUED before (each) admission", "queue_wait_ms_p50"),
    "serve.prefill_s": (
        "tnn_serve_prefill_seconds_total", "counter",
        "Cumulative prefill wall seconds", "prefill_tokens"),
    "serve.prefill_chunks": (
        "tnn_serve_prefill_chunks_total", "counter",
        "Prompt chunks pushed inside mixed steps", "prefill_chunks"),
    "serve.prefix_tokens_saved": (
        "tnn_serve_prefix_tokens_saved_total", "counter",
        "Prompt tokens served from cached KV (prefill skipped)",
        "prefill_tokens_saved"),
    "serve.prefix_cows": (
        "tnn_serve_prefix_cows_total", "counter",
        "Copy-on-write block copies at full-cover prefix hits",
        "prefix_cows"),
    "serve.mixed_step_fill": (
        "tnn_serve_mixed_step_fill_total", "counter",
        "Cumulative mixed-step fill ratio (live tokens / compiled capacity)",
        "mixed_step_fill_mean"),
    "serve.decode_stall_s": (
        "tnn_serve_decode_stall_seconds_total", "counter",
        "Cumulative wall gap between token-emitting steps",
        "decode_stall_ms_p50"),
    "serve.host_gap_s": (
        "tnn_serve_host_gap_seconds_total", "counter",
        "Cumulative wall gap between a step's result fetch and the next "
        "dispatch (device idle on host bookkeeping)", "host_gap_ms_p50"),
    "serve.overlap_rebuild": (
        "tnn_serve_overlap_rebuilds_total", "counter",
        "Speculatively dispatched steps rolled back on misprediction",
        "overlap_rebuilds"),
    "serve.decode_s": (
        "tnn_serve_decode_seconds_total", "counter",
        "Cumulative decode-step wall seconds", "tok_per_s"),
    "serve.spec_accepted": (
        "tnn_serve_spec_accepted_total", "counter",
        "Drafted tokens accepted by the speculative verifier",
        "spec_accepted_tokens"),
    "serve.preemptions": (
        "tnn_serve_preemptions_total", "counter",
        "Recompute preemptions (pool pressure victims)", "preemptions"),
    "serve.shed": (
        "tnn_serve_shed_total", "counter",
        "Queued requests displaced by higher-priority arrivals",
        "shed_requests"),
    "serve.engine_restarts": (
        "tnn_serve_engine_restarts_total", "counter",
        "Supervisor-driven engine recoveries", "engine_restarts"),
    "serve.migrated_requests": (
        "tnn_serve_migrated_requests_total", "counter",
        "Requests re-admitted after an engine restart or replica failover",
        "migrated_requests"),
    "serve.router_retries": (
        "tnn_serve_router_retries_total", "counter",
        "Router-level dispatch retries", "router_retries"),
    "serve.hedges_fired": (
        "tnn_serve_hedges_fired_total", "counter",
        "Requests duplicated onto a second replica past the TTFT hedge "
        "threshold", "hedges_fired"),
    "serve.hedges_won": (
        "tnn_serve_hedges_won_total", "counter",
        "Hedge races the duplicate stream won (first token or promotion "
        "after primary death)", "hedges_won"),
    "serve.hedges_cancelled": (
        "tnn_serve_hedges_cancelled_total", "counter",
        "Hedge losers cancelled/discarded once the race resolved",
        "hedges_cancelled"),
    "serve.degraded_ejections": (
        "tnn_serve_degraded_ejections_total", "counter",
        "Replicas ejected from placement as DEGRADED (gray failure)",
        "degraded_ejections"),
    "serve.proactive_migrations": (
        "tnn_serve_proactive_migrations_total", "counter",
        "Live streams proactively migrated off degraded replicas",
        "proactive_migrations"),
    "serve.drain_duration_s": (
        "tnn_serve_drain_seconds_total", "counter",
        "Wall seconds spent in graceful drains", "drain_duration_s"),
    "serve.publish_suspended": (
        "tnn_serve_publish_suspended_total", "counter",
        "Prefix publishes skipped under pool pressure", "publish_suspended"),
    "serve.rejected": (
        "tnn_serve_rejected_total", "counter",
        "Submits rejected by bounded admission", "rejected"),
    "serve.cancelled": (
        "tnn_serve_cancelled_total", "counter",
        "Requests cancelled by clients", "cancelled"),
    "serve.timed_out": (
        "tnn_serve_timed_out_total", "counter",
        "Requests that hit deadline_s / max_queue_s", "timed_out"),
    "serve.failed": (
        "tnn_serve_failed_total", "counter",
        "Requests failed by isolated faults", "failed"),
    "serve.step_retries": (
        "tnn_serve_step_retries_total", "counter",
        "Transient decode faults retried in place", "step_retries"),
    "serve.kv_bytes_per_token": (
        "tnn_serve_kv_bytes_per_token", "gauge",
        "Page-array bytes one resident KV token costs (K+V, all layers; "
        "int8 scale sidecars excluded)", "kv_bytes_per_token"),
    "serve.tp_degree": (
        "tnn_serve_tp_degree", "gauge",
        "Tensor-parallel degree of this engine (attention heads and KV "
        "pool head-sharded over tp chips; 1 = single-chip)", "tp_degree"),
    "serve.sp_degree": (
        "tnn_serve_sp_degree", "gauge",
        "Sequence-parallel degree of this engine (KV blocks sharded "
        "position-wise over a context mesh of sp chips; 1 = single-chip)",
        "sp_degree"),
    "serve.tier_hits": (
        "tnn_serve_tier_hits_total", "counter",
        "KV blocks re-admitted from the host-RAM tier (digest-verified "
        "device_put instead of recomputed prefill)", "tier_hits"),
    "serve.tier_corrupt": (
        "tnn_serve_tier_corrupt_total", "counter",
        "Host-tier entries dropped at readmit because their integrity "
        "digest failed (degraded to an uncached miss)", "tier_corrupt"),
    "serve.tier_blocks": (
        "tnn_serve_tier_blocks", "gauge",
        "KV blocks currently resident in the host-RAM tier", "tier_blocks"),
    "serve.tier_bytes": (
        "tnn_serve_tier_bytes", "gauge",
        "Host-RAM bytes held by demoted KV blocks (int8 blocks cost about "
        "half their f32 footprint)", "tier_bytes"),
    "serve.replicas": (
        "tnn_serve_replicas", "gauge",
        "Active (non-retired, non-dead) replicas in the fleet — the "
        "autoscaler's actuated value", "replicas"),
    "serve.handoff_exported": (
        "tnn_serve_handoff_exported_blocks_total", "counter",
        "KV blocks serialized for cross-replica handoff (device or host-"
        "tier staged, digest attached)", "handoff_exported_blocks"),
    "serve.handoff_adopted": (
        "tnn_serve_handoff_adopted_blocks_total", "counter",
        "Wire KV blocks adopted after digest verification (prefill those "
        "positions never recompute)", "handoff_adopted_blocks"),
    "serve.handoff_corrupt": (
        "tnn_serve_handoff_corrupt_total", "counter",
        "Wire KV blocks dropped at adopt because their integrity digest "
        "failed (handoff degraded to recompute-resume)", "handoff_corrupt"),
    "serve.boundary_handoffs": (
        "tnn_serve_boundary_handoffs_total", "counter",
        "Requests handed prefill->decode across replicas at the first-"
        "token boundary", "boundary_handoffs"),
    "serve.handoff_fallbacks": (
        "tnn_serve_handoff_fallbacks_total", "counter",
        "Boundary handoffs whose KV shipment failed or fell short — the "
        "stream continued via token-exact recompute-resume",
        "handoff_fallbacks"),
    "serve.fleet_prefix_pulls": (
        "tnn_serve_fleet_prefix_pulls_total", "counter",
        "Admissions whose prefix KV was pulled from a peer replica via "
        "the fleet chain-key directory instead of recomputed",
        "fleet_prefix_pulls"),
}

#: direct (non-``_tick``) families: attribute/gauge name → (prometheus
#: name, type, help). Rendered alongside the EXPOSITION families.
_DIRECT_FAMILIES: Tuple[Tuple[str, str, str, str], ...] = (
    ("finished", "tnn_serve_requests_finished_total", "counter",
     "Requests finished normally"),
    ("decode_tokens", "tnn_serve_decode_tokens_total", "counter",
     "Tokens emitted by decode steps"),
    ("prefill_tokens", "tnn_serve_prefill_tokens_total", "counter",
     "Prompt tokens pushed through prefill"),
    ("steps", "tnn_serve_steps_total", "counter",
     "Engine steps executed"),
)


def _finite(xs) -> List[float]:
    """Drop NaN/inf samples — a poisoned or clock-skewed observation must
    degrade one sample, not the whole aggregate."""
    return [x for x in xs if math.isfinite(x)]


def _percentile(xs, q: float) -> float:
    """Nearest-rank percentile without a numpy dependency on the hot path.
    NaN-safe: non-finite samples are ignored and an empty (or all-NaN)
    series reports 0.0 instead of raising/propagating NaN — a cache-only
    run with zero decode steps must not crash ``engine.stats()``."""
    ys = sorted(_finite(xs))
    if not ys:
        return 0.0
    idx = min(len(ys) - 1, max(0, int(round(q / 100.0 * (len(ys) - 1)))))
    return ys[idx]


def _mean(xs) -> float:
    """NaN-safe mean over the finite samples; 0.0 when none exist."""
    ys = _finite(xs)
    return sum(ys) / len(ys) if ys else 0.0


def _max(xs) -> float:
    """NaN-safe max over the finite samples; 0.0 when none exist."""
    return max(_finite(xs), default=0.0)


class Reservoir:
    """Fixed-size uniform sample of an unbounded stream (Algorithm R).

    Drop-in for the previous unbounded lists: supports ``append``, ``len``,
    iteration, and ``max(..., default=)``. The RNG is seeded from the
    series name, so a given observation sequence always retains the same
    samples — metric aggregates stay run-to-run deterministic. Below the
    cap the reservoir IS the full series (aggregates exact); above it,
    percentiles hold within sampling tolerance while memory stays flat.
    """

    __slots__ = ("cap", "_items", "_seen", "_rng")

    def __init__(self, name: str = "", cap: int = RESERVOIR_SIZE):
        if cap < 1:
            raise ValueError("reservoir cap must be >= 1")
        self.cap = int(cap)
        self._items: List[float] = []
        self._seen = 0
        self._rng = random.Random(name)

    def append(self, x: float) -> None:
        self._seen += 1
        if len(self._items) < self.cap:
            self._items.append(x)
            return
        j = self._rng.randrange(self._seen)
        if j < self.cap:
            self._items[j] = x

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self) -> Iterator[float]:
        return iter(self._items)

    @property
    def seen(self) -> int:
        """Observations ever appended (>= len once the cap is hit)."""
        return self._seen


class Histogram:
    """Fixed-bucket cumulative histogram (Prometheus classic shape)."""

    __slots__ = ("buckets", "counts", "total", "count")

    def __init__(self, buckets: Tuple[float, ...] = LATENCY_BUCKETS_S):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)   # +1 for +Inf
        self.total = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        if not math.isfinite(value):
            return
        self.count += 1
        self.total += value
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def samples(self) -> List[Tuple[str, Dict[str, str], float]]:
        """Prometheus sample tuples: cumulative ``_bucket`` series plus
        ``_sum`` and ``_count``."""
        out: List[Tuple[str, Dict[str, str], float]] = []
        cum = 0
        for ub, n in zip(self.buckets, self.counts):
            cum += n
            out.append(("_bucket", {"le": _format_float(ub)}, float(cum)))
        out.append(("_bucket", {"le": "+Inf"}, float(self.count)))
        out.append(("_sum", {}, self.total))
        out.append(("_count", {}, float(self.count)))
        return out


def _format_float(x: float) -> str:
    s = repr(float(x))
    return s[:-2] if s.endswith(".0") else s


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def label_series(families: List[Dict], labels: Dict[str, str]) -> List[Dict]:
    """Return a deep-enough copy of ``families`` with ``labels`` merged
    into every sample (the Router uses this to add ``replica="N"``)."""
    out = []
    for fam in families:
        samples = [(suffix, {**labels, **lbls}, value)
                   for suffix, lbls, value in fam["samples"]]
        out.append({**fam, "samples": samples})
    return out


def merge_series(*family_lists: List[Dict]) -> List[Dict]:
    """Merge family lists by metric name, concatenating samples — the
    per-replica series of one family land under one HELP/TYPE header."""
    by_name: Dict[str, Dict] = {}
    order: List[str] = []
    for fams in family_lists:
        for fam in fams:
            have = by_name.get(fam["name"])
            if have is None:
                by_name[fam["name"]] = {**fam,
                                        "samples": list(fam["samples"])}
                order.append(fam["name"])
            else:
                have["samples"].extend(fam["samples"])
    return [by_name[n] for n in order]


def render_prometheus(families: List[Dict]) -> str:
    """Render metric families as Prometheus text exposition format 0.0.4."""
    lines: List[str] = []
    for fam in families:
        lines.append(f"# HELP {fam['name']} {fam['help']}")
        lines.append(f"# TYPE {fam['name']} {fam['type']}")
        for suffix, labels, value in fam["samples"]:
            name = fam["name"] + suffix
            if labels:
                lbl = ",".join(f'{k}="{_escape_label(str(v))}"'
                               for k, v in sorted(labels.items()))
                name = f"{name}{{{lbl}}}"
            lines.append(f"{name} {_format_float(float(value))}")
    return "\n".join(lines) + "\n"


class ServingMetrics:
    """Aggregates one engine's request and step observations.

    Latency samples are wall-clock seconds; throughput is decode tokens
    over the span from the first observation to the latest one.
    """

    def __init__(self, profiler: Optional[Profiler] = None, *,
                 slo_ttft_s: Optional[float] = None,
                 slo_stall_s: Optional[float] = None,
                 reservoir_size: int = RESERVOIR_SIZE):
        self.profiler = profiler
        # SLO targets for goodput accounting (None = no SLO configured)
        self.slo_ttft_s = slo_ttft_s
        self.slo_stall_s = slo_stall_s

        def res(name: str) -> Reservoir:
            return Reservoir(name, cap=reservoir_size)

        self.ttft_s = res("ttft_s")
        self.ttft_under_load_s = res("ttft_under_load_s")
        self.token_latency_s = res("token_latency_s")
        self.decode_stall_s = res("decode_stall_s")
        self.host_gap_s = res("host_gap_s")
        self.step_latency_s = res("step_latency_s")
        self.queue_wait_s = res("queue_wait_s")
        self.queue_depth = res("queue_depth")
        self.pool_occupancy = res("pool_occupancy")
        self.batch_fill = res("batch_fill")
        self.mixed_step_fill = res("mixed_step_fill")
        self.finished_ttft_s = res("finished_ttft_s")  # TTFT of *finished*
        #: cumulative sum of every value ever ticked, by tick key: the
        #: counter surface behind the Prometheus exposition
        self.counters: Dict[str, float] = {}
        #: fixed-bucket histograms for the EXPOSITION "histogram" families
        self.histograms: Dict[str, Histogram] = {
            key: Histogram() for key, (_, mtype, _, _) in EXPOSITION.items()
            if mtype == "histogram"}
        self.prefill_tokens = 0
        self.prefill_chunks = 0
        # whole-prompt prefills (chunked prefill counts its chunks)
        self.prefills = 0
        self.prefill_s = 0.0
        # prefix cache: admission-time lookups against the block index
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_tokens_total = 0     # prompt tokens the lookups covered
        self.prefill_tokens_saved = 0    # of those, served from cached KV
        self.prefix_cows = 0             # clones at full-cover hits
        self.decode_tokens = 0
        # speculative decoding: drafted and accepted candidates, committed
        # tokens (accepted + the verifier's own) per decode-row step
        self.spec_draft_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_committed_tokens = 0
        self.spec_row_steps = 0
        self.preemptions = 0
        self.preemptions_by_request: Dict[int, int] = {}
        self.finished = 0
        self.rejected = 0
        self.cancelled = 0
        self.timed_out = 0
        self.failed = 0
        self.step_retries = 0
        self.steps = 0                # committed engine steps (any kind)
        # the overlapped loop: speculative steps adopted and rolled back
        self.overlap_adopted = 0
        self.overlap_rebuilds = 0
        # the supervised server
        self.shed = 0                 # queued requests displaced by priority
        self.engine_restarts = 0      # supervisor-driven engine recoveries
        self.drain_duration_s: Optional[float] = None  # the last drain
        self.publish_suspended = 0    # prefix publishes skipped under pressure
        self.migrated_requests = 0       # re-admissions after a crash/failover
        self.migration_resume_tokens = 0  # tokens re-prefilled by migrations
        self.router_retries = 0          # router-level dispatch retries
        # gray-failure tolerance (health-scored routing, hedging)
        self.hedges_fired = 0         # duplicates dispatched past the threshold
        self.hedges_won = 0           # races the duplicate stream won
        self.hedges_cancelled = 0     # losing streams cancelled/discarded
        self.degraded_ejections = 0   # replicas ejected from placement
        self.proactive_migrations = 0  # streams pulled off degraded replicas
        # the host KV tier
        self.tier_hits = 0            # blocks re-admitted from the host tier
        self.tier_corrupt = 0         # entries dropped on digest mismatch
        # disaggregated serving (cross-replica KV handoff)
        self.handoff_exported_blocks = 0  # blocks serialized for shipment
        self.handoff_adopted_blocks = 0   # wire blocks digest-verified in
        self.handoff_corrupt = 0          # wire blocks failing their digest
        self.boundary_handoffs = 0    # prefill->decode replica handoffs
        self.handoff_fallbacks = 0    # handoffs degraded to recompute-resume
        self.fleet_prefix_pulls = 0   # peer-sourced prefix admissions
        self._t_created = time.perf_counter()
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    # -- observations ---------------------------------------------------------

    def _mark(self) -> float:
        now = time.perf_counter()
        if self._t_first is None:
            self._t_first = now
        self._t_last = now
        return now

    def _tick(self, metric: str, value: float) -> None:
        self.counters[metric] = self.counters.get(metric, 0.0) + value
        hist = self.histograms.get(metric)
        if hist is not None:
            hist.observe(value)
        if self.profiler is not None:
            self.profiler.tick(metric, value)

    def observe_ttft(self, seconds: float, under_load: bool = False) -> None:
        """``under_load`` marks a first token produced while other requests
        were decoding in the same step."""
        self._mark()
        self.ttft_s.append(seconds)
        if under_load:
            self.ttft_under_load_s.append(seconds)
        self._tick("serve.ttft_s", seconds)

    def observe_prefill(self, num_tokens: int, seconds: float) -> None:
        """One whole-prompt prefill of ``num_tokens``, ``seconds`` from its
        launch to its commit."""
        self._mark()
        self.prefills += 1
        self.prefill_tokens += num_tokens
        self.prefill_s += seconds
        self._tick("serve.prefill_s", seconds)

    def observe_prefill_chunk(self, num_tokens: int) -> None:
        """One prompt chunk pushed inside a mixed step."""
        self._mark()
        self.prefill_chunks += 1
        self.prefill_tokens += num_tokens
        self._tick("serve.prefill_chunks", 1)

    def observe_prefix_lookup(self, tokens_saved: int, total: int) -> None:
        """One admission probe over a ``total``-token prompt, of which
        ``tokens_saved`` positions came from cached KV."""
        self._mark()
        self.prefix_lookups += 1
        self.prefix_tokens_total += total
        if tokens_saved > 0:
            self.prefix_hits += 1
            self.prefill_tokens_saved += tokens_saved
        self._tick("serve.prefix_tokens_saved", tokens_saved)

    def observe_prefix_cow(self) -> None:
        """A full-cover hit cloned its last block (copy-on-write)."""
        self.prefix_cows += 1
        self._tick("serve.prefix_cows", 1)

    def observe_mixed_step(self, live_tokens: int, width: int) -> None:
        """Packing of one mixed step: live tokens over its row capacity."""
        if width:
            self.mixed_step_fill.append(live_tokens / width)
            self._tick("serve.mixed_step_fill", live_tokens / width)

    def observe_decode_stall(self, seconds: float) -> None:
        """Wall gap between consecutive steps that emitted decode tokens."""
        self.decode_stall_s.append(seconds)
        self._tick("serve.decode_stall_s", seconds)

    def observe_host_gap(self, seconds: float) -> None:
        """Wall gap between a step's bundle fetch and the next dispatch:
        the window where the device waits on host bookkeeping, which the
        overlapped loop exists to close."""
        self.host_gap_s.append(seconds)
        self._tick("serve.host_gap_s", seconds)

    def observe_overlap_adopted(self) -> None:
        """A speculatively dispatched step N+1 became the next step."""
        self.overlap_adopted += 1

    def observe_overlap_rebuild(self) -> None:
        """A speculatively dispatched step N+1 was rolled back: step N's
        commit changed the row set it predicted."""
        self.overlap_rebuilds += 1
        self._tick("serve.overlap_rebuild", 1)

    def observe_decode(self, num_tokens: int, seconds: Optional[float] = None,
                       batch_width: int = 0) -> None:
        """A step that emitted ``num_tokens`` decode-phase tokens; with
        ``seconds`` (the step's wall time) it is also each token's latency,
        and ``batch_width`` the rows the step ran (fill = padding waste).
        Steps are counted by ``observe_step_latency``."""
        self._mark()
        self.decode_tokens += num_tokens
        if seconds is not None:
            if num_tokens:
                self.token_latency_s.append(seconds)
                self._tick("serve.token_latency_s", seconds)
            self._tick("serve.decode_s", seconds)
        if batch_width:
            self.batch_fill.append(num_tokens / batch_width)

    def observe_step_latency(self, seconds: float) -> None:
        """Wall time of one whole committed engine step (any kind)."""
        self.steps += 1
        self.step_latency_s.append(seconds)
        self._tick("serve.step_latency_s", seconds)

    def observe_queue_wait(self, seconds: float) -> None:
        """One stretch QUEUED, ended by an admission (a re-admission after
        preemption or migration observes its own)."""
        self.queue_wait_s.append(seconds)
        self._tick("serve.queue_wait_s", seconds)

    def observe_spec(self, drafted: int, accepted: int, committed: int,
                     rows: int = 1) -> None:
        """Speculative outcome of ``rows`` decode-row steps: ``drafted``
        candidates, ``accepted`` of them verified, ``committed`` tokens
        emitted (accepted + the verifier's own, cut by a stop or the
        length). Rows that drafted nothing count too, so a drafter that
        never fires shows about one token a step."""
        self._mark()
        self.spec_draft_tokens += drafted
        self.spec_accepted_tokens += accepted
        self.spec_committed_tokens += committed
        self.spec_row_steps += rows
        self._tick("serve.spec_accepted", accepted)

    def observe_gauges(self, queue_depth: int, pool_occupancy: float,
                       kv_bytes_per_token: float = 0.0,
                       tp_degree: float = 1.0,
                       sp_degree: float = 1.0,
                       tier_blocks: int = 0,
                       tier_bytes: float = 0.0) -> None:
        """The live gauges at a step's commit."""
        self.queue_depth.append(queue_depth)
        self.pool_occupancy.append(pool_occupancy)
        self._last_queue_depth = queue_depth
        self._last_pool_occupancy = pool_occupancy
        self._last_kv_bytes_per_token = kv_bytes_per_token
        self._last_tp_degree = tp_degree
        self._last_sp_degree = sp_degree
        self._last_tier_blocks = tier_blocks
        self._last_tier_bytes = tier_bytes

    def observe_replicas(self, n: int) -> None:
        """Active replica count after a fleet change (scale-up or -down,
        death, readmit): the ``tnn_serve_replicas`` gauge."""
        self._last_replicas = n

    def observe_tier_hit(self, blocks: int = 1) -> None:
        """``blocks`` KV blocks re-admitted from the host tier (each one a
        digest-verified copy to the card instead of a recomputed prefill)."""
        self.tier_hits += blocks
        self._tick("serve.tier_hits", blocks)

    def observe_tier_corrupt(self) -> None:
        """A host-tier entry failed its digest at readmit and was dropped:
        the lookup degraded to an uncached miss."""
        self.tier_corrupt += 1
        self._tick("serve.tier_corrupt", 1)

    def observe_handoff_export(self, blocks: int) -> None:
        """``blocks`` KV blocks serialized (chain key + digest) for a
        cross-replica handoff, from the pages or the host tier."""
        self.handoff_exported_blocks += blocks
        self._tick("serve.handoff_exported", blocks)

    def observe_handoff_adopt(self, blocks: int) -> None:
        """``blocks`` wire KV blocks adopted after digest verification."""
        self.handoff_adopted_blocks += blocks
        self._tick("serve.handoff_adopted", blocks)

    def observe_handoff_corrupt(self) -> None:
        """A wire KV block failed its digest at adopt and was dropped: the
        handoff degrades to recompute-resume."""
        self.handoff_corrupt += 1
        self._tick("serve.handoff_corrupt", 1)

    def observe_boundary_handoff(self) -> None:
        """One request handed prefill -> decode across replicas at its
        first-token boundary."""
        self.boundary_handoffs += 1
        self._tick("serve.boundary_handoffs", 1)

    def observe_handoff_fallback(self) -> None:
        """A boundary handoff's KV shipment failed or fell short; the
        stream went on token-exact through recompute-resume."""
        self.handoff_fallbacks += 1
        self._tick("serve.handoff_fallbacks", 1)

    def observe_fleet_prefix_pull(self) -> None:
        """An admission's prefix KV was pulled from a peer replica through
        the fleet chain-key directory instead of recomputed."""
        self.fleet_prefix_pulls += 1
        self._tick("serve.fleet_prefix_pulls", 1)

    def observe_preemption(self, rid: Optional[int] = None) -> None:
        self.preemptions += 1
        if rid is not None:
            self.preemptions_by_request[rid] = \
                self.preemptions_by_request.get(rid, 0) + 1
        self._tick("serve.preemptions", 1)

    def observe_finish(self, ttft_s: Optional[float] = None) -> None:
        self.finished += 1
        if ttft_s is not None:
            self.finished_ttft_s.append(ttft_s)

    def observe_shed(self) -> None:
        """A queued request displaced by a more important arrival."""
        self.shed += 1
        self._tick("serve.shed", 1)

    def observe_restart(self) -> None:
        """The supervisor reset the engine after a crash or watchdog trip."""
        self.engine_restarts += 1
        self._tick("serve.engine_restarts", 1)

    def observe_migration(self, resume_tokens: int) -> None:
        """One running request re-admitted through the resume path after
        an engine restart or a replica failover; ``resume_tokens`` is what
        its re-prefill pushes."""
        self.migrated_requests += 1
        self.migration_resume_tokens += resume_tokens
        self._tick("serve.migrated_requests", 1)

    def observe_router_retry(self) -> None:
        """The router re-dispatched a request after a replica-level failure
        (a backoff retry or a mid-stream migration)."""
        self.router_retries += 1
        self._tick("serve.router_retries", 1)

    def observe_hedge_fired(self) -> None:
        """A request idled past the TTFT hedge threshold and was duplicated
        onto a second replica under a fresh epoch."""
        self.hedges_fired += 1
        self._tick("serve.hedges_fired", 1)

    def observe_hedge_won(self) -> None:
        """The duplicate stream won the hedge race."""
        self.hedges_won += 1
        self._tick("serve.hedges_won", 1)

    def observe_hedge_cancelled(self) -> None:
        """A hedge loser was cancelled once the race resolved."""
        self.hedges_cancelled += 1
        self._tick("serve.hedges_cancelled", 1)

    def observe_ejection(self) -> None:
        """A replica's health score stayed above the degrade threshold and
        it left placement as DEGRADED (gray failure)."""
        self.degraded_ejections += 1
        self._tick("serve.degraded_ejections", 1)

    def observe_proactive_migration(self) -> None:
        """A live stream migrated off a degraded replica before the replica
        failed outright."""
        self.proactive_migrations += 1
        self._tick("serve.proactive_migrations", 1)

    def observe_drain(self, seconds: float) -> None:
        """A graceful drain finished after ``seconds``."""
        self.drain_duration_s = seconds
        self._tick("serve.drain_duration_s", seconds)

    def observe_publish_suspended(self) -> None:
        """A prefix publish was skipped: the pool was above the engine's
        ``prefix_publish_max_occupancy``."""
        self.publish_suspended += 1
        self._tick("serve.publish_suspended", 1)

    def observe_rejected(self) -> None:
        """A submit refused by bounded admission (``AdmissionRejected``)."""
        self.rejected += 1
        self._tick("serve.rejected", 1)

    def observe_cancelled(self) -> None:
        self.cancelled += 1
        self._tick("serve.cancelled", 1)

    def observe_timeout(self) -> None:
        self.timed_out += 1
        self._tick("serve.timed_out", 1)

    def observe_failed(self) -> None:
        self.failed += 1
        self._tick("serve.failed", 1)

    def observe_step_retry(self) -> None:
        """A transient step fault was retried (same inputs, same sampling
        state)."""
        self.step_retries += 1
        self._tick("serve.step_retries", 1)

    # -- aggregates -----------------------------------------------------------

    @property
    def elapsed_s(self) -> float:
        if self._t_first is None or self._t_last is None:
            return 0.0
        return self._t_last - self._t_first

    @property
    def tokens_per_s(self) -> float:
        """Decode tokens over the wall span from the first observed token
        to the last."""
        el = self.elapsed_s
        return self.decode_tokens / el if el > 0 else 0.0

    @property
    def uptime_s(self) -> float:
        return time.perf_counter() - self._t_created

    @property
    def goodput_at_slo(self) -> float:
        """Finished requests per second that met the TTFT SLO; with no SLO
        configured every finished request counts."""
        el = self.elapsed_s
        if el <= 0:
            return 0.0
        if self.slo_ttft_s is None:
            good = self.finished
        else:
            good = sum(1 for t in _finite(self.finished_ttft_s)
                       if t <= self.slo_ttft_s)
        return good / el

    @property
    def stall_slo_violations(self) -> int:
        """Decode-stall samples above the stall SLO (0 when unset)."""
        if self.slo_stall_s is None:
            return 0
        return sum(1 for s in _finite(self.decode_stall_s)
                   if s > self.slo_stall_s)

    def summary(self) -> Dict[str, float]:
        """One flat dict: the JAX package's keys (every aggregate defined,
        0.0, on an empty series) plus the port's own."""
        def ms(x):
            return x * 1e3

        lat = list(self.step_latency_s)
        return {
            "requests_finished": self.finished,
            "finished": self.finished,
            "decode_tokens": self.decode_tokens,
            "prefill_tokens": self.prefill_tokens,
            "prefills": self.prefills,
            "prefill_ms_mean": (self.prefill_s / self.prefills * 1e3)
            if self.prefills else 0.0,
            "steps": self.steps,
            "preemptions": self.preemptions,
            "preemptions_max_per_request": max(
                self.preemptions_by_request.values(), default=0),
            "rejected": self.rejected,
            "cancelled": self.cancelled,
            "timed_out": self.timed_out,
            "failed": self.failed,
            "step_retries": self.step_retries,
            "uptime_s": self.uptime_s,
            "engine_restarts": self.engine_restarts,
            "drain_duration_s": self.drain_duration_s,
            "shed_requests": self.shed,
            "publish_suspended": self.publish_suspended,
            "migrated_requests": self.migrated_requests,
            "migration_resume_tokens": self.migration_resume_tokens,
            "router_retries": self.router_retries,
            "hedges_fired": self.hedges_fired,
            "hedges_won": self.hedges_won,
            "hedges_cancelled": self.hedges_cancelled,
            "degraded_ejections": self.degraded_ejections,
            "proactive_migrations": self.proactive_migrations,
            "goodput_at_slo": self.goodput_at_slo,
            "stall_slo_violations": self.stall_slo_violations,
            "tok_per_s": self.tokens_per_s,
            "spec_draft_tokens": self.spec_draft_tokens,
            "spec_accepted_tokens": self.spec_accepted_tokens,
            "spec_acceptance_rate": (self.spec_accepted_tokens
                                     / self.spec_draft_tokens)
            if self.spec_draft_tokens else 0.0,
            "mean_accepted_per_step": (self.spec_committed_tokens
                                       / self.spec_row_steps)
            if self.spec_row_steps else 0.0,
            "prefix_lookups": self.prefix_lookups,
            "prefix_hits": self.prefix_hits,
            "prefix_cows": self.prefix_cows,
            "prefill_tokens_saved": self.prefill_tokens_saved,
            # token-weighted: saved positions over all looked-up ones
            "prefix_hit_rate": (self.prefill_tokens_saved
                                / self.prefix_tokens_total)
            if self.prefix_tokens_total else 0.0,
            "ttft_ms_mean": ms(_mean(self.ttft_s)),
            "ttft_ms_p50": ms(_percentile(self.ttft_s, 50)),
            "ttft_ms_p95": ms(_percentile(self.ttft_s, 95)),
            "ttft_ms_p99": ms(_percentile(self.ttft_s, 99)),
            "ttft_under_load_ms_p50": ms(_percentile(self.ttft_under_load_s,
                                                     50)),
            "ttft_under_load_ms_p99": ms(_percentile(self.ttft_under_load_s,
                                                     99)),
            "token_latency_ms_p50": ms(_percentile(self.token_latency_s, 50)),
            "token_latency_ms_p95": ms(_percentile(self.token_latency_s, 95)),
            "token_latency_ms_p99": ms(_percentile(self.token_latency_s, 99)),
            "decode_stall_ms_p50": ms(_percentile(self.decode_stall_s, 50)),
            "decode_stall_ms_p99": ms(_percentile(self.decode_stall_s, 99)),
            "decode_stall_ms_max": ms(_max(self.decode_stall_s)),
            "host_gap_ms_mean": ms(_mean(self.host_gap_s)),
            "host_gap_ms_p50": ms(_percentile(self.host_gap_s, 50)),
            "host_gap_ms_p99": ms(_percentile(self.host_gap_s, 99)),
            "overlap_adopted": self.overlap_adopted,
            "overlap_rebuilds": self.overlap_rebuilds,
            "step_latency_ms_mean": ms(_mean(lat)),
            "step_latency_ms_p50": ms(_percentile(lat, 50)),
            "step_latency_ms_p99": ms(_percentile(lat, 99)),
            "queue_wait_ms_p50": ms(_percentile(self.queue_wait_s, 50)),
            "queue_wait_ms_p99": ms(_percentile(self.queue_wait_s, 99)),
            "prefill_chunks": self.prefill_chunks,
            "queue_depth_max": max(self.queue_depth, default=0),
            "pool_occupancy_max": _max(self.pool_occupancy),
            "batch_fill_mean": _mean(self.batch_fill),
            "mixed_step_fill_mean": _mean(self.mixed_step_fill),
            "kv_bytes_per_token": getattr(self, "_last_kv_bytes_per_token",
                                          0.0),
            "tp_degree": getattr(self, "_last_tp_degree", 1.0),
            "sp_degree": getattr(self, "_last_sp_degree", 1.0),
            "tier_hits": self.tier_hits,
            "tier_corrupt": self.tier_corrupt,
            "handoff_exported_blocks": self.handoff_exported_blocks,
            "handoff_adopted_blocks": self.handoff_adopted_blocks,
            "handoff_corrupt": self.handoff_corrupt,
            "boundary_handoffs": self.boundary_handoffs,
            "handoff_fallbacks": self.handoff_fallbacks,
            "fleet_prefix_pulls": self.fleet_prefix_pulls,
            "tier_blocks": getattr(self, "_last_tier_blocks", 0),
            "tier_bytes": getattr(self, "_last_tier_bytes", 0.0),
            "replicas": getattr(self, "_last_replicas", 0.0),
        }

    # -- Prometheus exposition ------------------------------------------------

    def prometheus_series(self) -> List[Dict]:
        """Metric families for ``render_prometheus``: every EXPOSITION
        entry (counters render the cumulative ticked sum, histograms their
        fixed buckets, gauges the last observed value), the direct request
        and token counters, and the live gauges. Families render before
        their first observation, so the scrape surface is stable from the
        first request."""
        families: List[Dict] = []
        for key, (name, mtype, help_, summary_key) in EXPOSITION.items():
            if mtype == "histogram":
                samples = self.histograms[key].samples()
            elif mtype == "gauge":
                samples = [("", {}, float(getattr(
                    self, "_last_" + summary_key, 0.0)))]
            else:
                samples = [("", {}, self.counters.get(key, 0.0))]
            families.append({"name": name, "type": mtype, "help": help_,
                             "samples": samples})
        for attr, name, mtype, help_ in _DIRECT_FAMILIES:
            families.append({"name": name, "type": mtype, "help": help_,
                             "samples": [("", {}, float(getattr(self,
                                                                attr)))]})
        families.append({
            "name": "tnn_serve_queue_depth", "type": "gauge",
            "help": "Waiting requests at the last engine step",
            "samples": [("", {}, float(getattr(self, "_last_queue_depth",
                                               0)))]})
        families.append({
            "name": "tnn_serve_pool_occupancy", "type": "gauge",
            "help": "KV pool block occupancy ratio at the last engine step",
            "samples": [("", {}, float(getattr(self, "_last_pool_occupancy",
                                               0.0)))]})
        families.append({
            "name": "tnn_serve_uptime_seconds", "type": "gauge",
            "help": "Seconds since this metrics registry was created",
            "samples": [("", {}, self.uptime_s)]})
        return families
