"""Serving metrics (a small ``tnn_tpu.serving.metrics.ServingMetrics``):
TTFT percentiles, decode tokens/s, step latency, preemptions, finished
requests, cancelled and timed-out requests, whole-prompt prefills,
rejected and shed submits, the pool's KV bytes per token, the prefix cache's and speculative decoding's counters, and the
overlapped loop's host gap, adopted speculative steps and rebuilds. All
clocks are host wall clocks."""
from __future__ import annotations

import time
from typing import Dict, List, Optional


def percentile(xs: List[float], q: float) -> float:
    """Nearest-rank percentile (0 for an empty series)."""
    if not xs:
        return 0.0
    s = sorted(xs)
    k = min(len(s) - 1, max(0, int(round(q / 100.0 * len(s) + 0.5)) - 1))
    return s[k]


class ServingMetrics:
    def __init__(self):
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
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    def _mark(self) -> None:
        now = time.perf_counter()
        if self._t_first is None:
            self._t_first = now
        self._t_last = now

    def observe_ttft(self, seconds: float) -> None:
        self._mark()
        self.ttft_s.append(seconds)

    def observe_prefill(self, num_tokens: int, seconds: float) -> None:
        """One whole-prompt prefill of ``num_tokens``, ``seconds`` from its
        launch to its commit."""
        self._mark()
        self.prefills += 1
        self.prefill_tokens += num_tokens
        self.prefill_s += seconds

    def observe_rejected(self) -> None:
        """A submit refused by bounded admission (``AdmissionRejected``)."""
        self.rejected += 1

    def observe_shed(self) -> None:
        """A queued request displaced by a more important arrival."""
        self.shed += 1

    def observe_prefill_chunk(self, num_tokens: int) -> None:
        self.prefill_tokens += num_tokens

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

    def observe_prefix_cow(self) -> None:
        """A full-cover hit cloned its last block (copy-on-write)."""
        self.prefix_cows += 1

    def observe_publish_suspended(self) -> None:
        """A prefix publish was skipped: the pool was above the engine's
        ``prefix_publish_max_occupancy``."""
        self.publish_suspended += 1

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

    def observe_step_latency(self, seconds: float) -> None:
        self.steps += 1
        self.step_latency_s.append(seconds)

    def observe_preemption(self) -> None:
        self.preemptions += 1

    def observe_finish(self) -> None:
        self.finished += 1

    def observe_failed(self) -> None:
        self.failed += 1

    def observe_cancelled(self) -> None:
        self.cancelled += 1

    def observe_timeout(self) -> None:
        self.timed_out += 1

    def observe_host_gap(self, seconds: float) -> None:
        """Wall gap between a step's bundle fetch and the next dispatch:
        the window where the device waits on host bookkeeping, which the
        overlapped loop exists to close."""
        self.host_gap_s.append(seconds)

    def observe_overlap_adopted(self) -> None:
        """A speculatively dispatched step N+1 became the next step."""
        self.overlap_adopted += 1

    def observe_overlap_rebuild(self) -> None:
        """A speculatively dispatched step N+1 was rolled back: step N's
        commit changed the row set it predicted."""
        self.overlap_rebuilds += 1

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
