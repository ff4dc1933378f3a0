"""Serving metrics (a small ``tnn_tpu.serving.metrics.ServingMetrics``):
TTFT percentiles, decode tokens/s, step latency, preemptions, finished
requests and the pool's KV bytes per token. All clocks are host wall clocks
around synchronised steps."""
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
        # the pool's page bytes per resident token (K + V, all layers; int8
        # scales excluded), set by the engine that owns the pool
        self.kv_bytes_per_token = 0
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

    def observe_prefill_chunk(self, num_tokens: int) -> None:
        self.prefill_tokens += num_tokens

    def observe_decode(self, num_tokens: int) -> None:
        """A step that emitted ``num_tokens`` decode-phase tokens."""
        self._mark()
        self.decode_tokens += num_tokens

    def observe_step_latency(self, seconds: float) -> None:
        self.steps += 1
        self.step_latency_s.append(seconds)

    def observe_preemption(self) -> None:
        self.preemptions += 1

    def observe_finish(self) -> None:
        self.finished += 1

    def observe_failed(self) -> None:
        self.failed += 1

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
            "steps": self.steps,
            "step_latency_ms_mean": (sum(lat) / len(lat) * 1e3) if lat
            else 0.0,
            "step_latency_ms_p50": percentile(lat, 50) * 1e3,
            "preemptions": self.preemptions,
            "finished": self.finished,
            "failed": self.failed,
            "kv_bytes_per_token": self.kv_bytes_per_token,
        }
