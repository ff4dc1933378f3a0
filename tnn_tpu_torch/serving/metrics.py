"""Serving metrics (a small ``tnn_tpu.serving.metrics.ServingMetrics``):
TTFT percentiles, decode tokens/s, step latency, preemptions, finished
requests, cancelled and timed-out requests, whole-prompt prefills,
rejected and shed submits, the pool's KV bytes per token, the prefix cache's and speculative decoding's counters, and the
overlapped loop's host gap, adopted speculative steps and rebuilds, and
the supervised server's restarts, crash migrations, transient-fault retries,
queue waits and drain time. All clocks are host wall clocks.

``ServingMetrics(profiler)`` also ticks each observation into the
profiler's counters under the JAX package's keys (``serve.ttft_s``,
``serve.engine_restarts``, ...; ``_tick``), so a traced run's counters
sit beside its spans. ``Reservoir``, ``Histogram`` and the Prometheus
exposition are not ported yet (ROADMAP.md)."""
from __future__ import annotations

import time
from typing import Dict, List, Optional

from ..profiling.profiler import Profiler


def percentile(xs: List[float], q: float) -> float:
    """Nearest-rank percentile (0 for an empty series)."""
    if not xs:
        return 0.0
    s = sorted(xs)
    k = min(len(s) - 1, max(0, int(round(q / 100.0 * len(s) + 0.5)) - 1))
    return s[k]


class ServingMetrics:
    def __init__(self, profiler: Optional[Profiler] = None):
        self.profiler = profiler
        self.ttft_s: List[float] = []
        self.step_latency_s: List[float] = []
        self.decode_tokens = 0
        self.prefill_tokens = 0
        self.steps = 0
        self.preemptions = 0
        self.finished = 0
        self.failed = 0
        self.cancelled = 0
        self.timed_out = 0
        # whole-prompt prefills (chunked prefill counts its chunks in
        # prefill_tokens only) and bounded admission's refusals
        self.prefills = 0
        self.prefill_s = 0.0
        self.rejected = 0
        self.shed = 0
        # the overlapped loop: wall gaps between a step's bundle fetch and
        # the next dispatch, speculative steps adopted and rolled back
        self.host_gap_s: List[float] = []
        self.overlap_adopted = 0
        self.overlap_rebuilds = 0
        # the pool's page bytes per resident token (K + V, all layers; int8
        # scales excluded), set by the engine that owns the pool
        self.kv_bytes_per_token = 0
        # prefix cache: admission-time lookups against the block index
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_tokens_total = 0     # prompt tokens the lookups covered
        self.prefill_tokens_saved = 0    # of those, served from cached KV
        self.prefix_cows = 0             # clones at full-cover hits
        self.publish_suspended = 0       # publishes skipped under pressure
        # speculative decoding: drafted and accepted candidates, committed
        # tokens (accepted + the verifier's own) per decode-row step
        self.spec_draft_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_committed_tokens = 0
        self.spec_row_steps = 0
        # the supervised server: restarts, crash migrations (and the resume
        # tokens they re-prefill), transient-fault retries, queue waits,
        # the last drain's duration
        self.engine_restarts = 0
        self.migrated_requests = 0
        self.migration_resume_tokens = 0
        self.step_retries = 0
        self.queue_wait_s: List[float] = []
        self.drain_duration_s: Optional[float] = None
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    def _mark(self) -> None:
        now = time.perf_counter()
        if self._t_first is None:
            self._t_first = now
        self._t_last = now

    def _tick(self, metric: str, value: float) -> None:
        if self.profiler is not None:
            self.profiler.tick(metric, value)

    def observe_ttft(self, seconds: float) -> None:
        self._mark()
        self.ttft_s.append(seconds)
        self._tick("serve.ttft_s", seconds)

    def observe_prefill(self, num_tokens: int, seconds: float) -> None:
        """One whole-prompt prefill of ``num_tokens``, ``seconds`` from its
        launch to its commit."""
        self._mark()
        self.prefills += 1
        self.prefill_tokens += num_tokens
        self.prefill_s += seconds
        self._tick("serve.prefill_s", seconds)

    def observe_rejected(self) -> None:
        """A submit refused by bounded admission (``AdmissionRejected``)."""
        self.rejected += 1
        self._tick("serve.rejected", 1)

    def observe_shed(self) -> None:
        """A queued request displaced by a more important arrival."""
        self.shed += 1
        self._tick("serve.shed", 1)

    def observe_prefill_chunk(self, num_tokens: int) -> None:
        self.prefill_tokens += num_tokens
        self._tick("serve.prefill_chunks", 1)

    def observe_decode(self, num_tokens: int) -> None:
        """A step that emitted ``num_tokens`` decode-phase tokens."""
        self._mark()
        self.decode_tokens += num_tokens

    def observe_prefix_lookup(self, tokens_saved: int, total: int) -> None:
        """One admission probe over a ``total``-token prompt, of which
        ``tokens_saved`` positions came from cached KV."""
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

    def observe_publish_suspended(self) -> None:
        """A prefix publish was skipped: the pool was above the engine's
        ``prefix_publish_max_occupancy``."""
        self.publish_suspended += 1
        self._tick("serve.publish_suspended", 1)

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

    def observe_step_latency(self, seconds: float) -> None:
        self.steps += 1
        self.step_latency_s.append(seconds)
        self._tick("serve.step_latency_s", seconds)

    def observe_queue_wait(self, seconds: float) -> None:
        """One stretch QUEUED, ended by an admission (a re-admission after
        preemption or migration observes its own)."""
        self.queue_wait_s.append(seconds)
        self._tick("serve.queue_wait_s", seconds)

    def observe_preemption(self) -> None:
        self.preemptions += 1
        self._tick("serve.preemptions", 1)

    def observe_finish(self) -> None:
        self.finished += 1

    def observe_failed(self) -> None:
        self.failed += 1
        self._tick("serve.failed", 1)

    def observe_cancelled(self) -> None:
        self.cancelled += 1
        self._tick("serve.cancelled", 1)

    def observe_timeout(self) -> None:
        self.timed_out += 1
        self._tick("serve.timed_out", 1)

    def observe_restart(self) -> None:
        """The supervisor reset the engine after a crash or watchdog trip."""
        self.engine_restarts += 1
        self._tick("serve.engine_restarts", 1)

    def observe_migration(self, resume_tokens: int) -> None:
        """One running request re-admitted through the resume path after
        an engine restart; ``resume_tokens`` is what its re-prefill
        pushes."""
        self.migrated_requests += 1
        self.migration_resume_tokens += resume_tokens
        self._tick("serve.migrated_requests", 1)

    def observe_step_retry(self) -> None:
        """A transient step fault was retried (same inputs, same sampling
        state)."""
        self.step_retries += 1
        self._tick("serve.step_retries", 1)

    def observe_drain(self, seconds: float) -> None:
        """A graceful drain finished after ``seconds``."""
        self.drain_duration_s = seconds
        self._tick("serve.drain_duration_s", seconds)

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

    def summary(self) -> Dict[str, float]:
        lat = self.step_latency_s
        return {
            "ttft_ms_p50": percentile(self.ttft_s, 50) * 1e3,
            "ttft_ms_p95": percentile(self.ttft_s, 95) * 1e3,
            "tok_per_s": self.tokens_per_s,
            "decode_tokens": self.decode_tokens,
            "prefill_tokens": self.prefill_tokens,
            "prefills": self.prefills,
            "prefill_ms_mean": (self.prefill_s / self.prefills * 1e3)
            if self.prefills else 0.0,
            "rejected": self.rejected,
            "shed_requests": self.shed,
            "steps": self.steps,
            "step_latency_ms_mean": (sum(lat) / len(lat) * 1e3) if lat
            else 0.0,
            "step_latency_ms_p50": percentile(lat, 50) * 1e3,
            "preemptions": self.preemptions,
            "finished": self.finished,
            "failed": self.failed,
            "cancelled": self.cancelled,
            "timed_out": self.timed_out,
            "step_retries": self.step_retries,
            "engine_restarts": self.engine_restarts,
            "migrated_requests": self.migrated_requests,
            "migration_resume_tokens": self.migration_resume_tokens,
            "drain_duration_s": self.drain_duration_s,
            "queue_wait_ms_p50": percentile(self.queue_wait_s, 50) * 1e3,
            "queue_wait_ms_p99": percentile(self.queue_wait_s, 99) * 1e3,
            "host_gap_ms_mean": (sum(self.host_gap_s) / len(self.host_gap_s)
                                 * 1e3) if self.host_gap_s else 0.0,
            "host_gap_ms_p50": percentile(self.host_gap_s, 50) * 1e3,
            "host_gap_ms_p99": percentile(self.host_gap_s, 99) * 1e3,
            "overlap_adopted": self.overlap_adopted,
            "overlap_rebuilds": self.overlap_rebuilds,
            "kv_bytes_per_token": self.kv_bytes_per_token,
            "prefix_lookups": self.prefix_lookups,
            "prefix_hits": self.prefix_hits,
            "prefix_cows": self.prefix_cows,
            "prefill_tokens_saved": self.prefill_tokens_saved,
            # token-weighted: saved positions over all looked-up ones
            "prefix_hit_rate": (self.prefill_tokens_saved
                                / self.prefix_tokens_total)
            if self.prefix_tokens_total else 0.0,
            "publish_suspended": self.publish_suspended,
            "spec_draft_tokens": self.spec_draft_tokens,
            "spec_accepted_tokens": self.spec_accepted_tokens,
            "spec_acceptance_rate": (self.spec_accepted_tokens
                                     / self.spec_draft_tokens)
            if self.spec_draft_tokens else 0.0,
            "mean_accepted_per_step": (self.spec_committed_tokens
                                       / self.spec_row_steps)
            if self.spec_row_steps else 0.0,
        }
