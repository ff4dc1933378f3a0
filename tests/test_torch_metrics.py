"""Port parity: ``serving/metrics.py``'s exposition against the JAX
package's (``tnn_tpu.serving.metrics``).

- ``Reservoir`` keeps the same samples as JAX's past its cap (Algorithm R
  with an RNG seeded from the series name), and its refusal.
- ``Histogram``, ``label_series``, ``merge_series`` and
  ``render_prometheus`` give text equal to JAX's for the same families.
- ``summary()`` carries JAX's whole key set (the port adds its own keys).
- ``prometheus_series`` has JAX's family names, types and help texts, and,
  after the same observations, equal counter and histogram samples (the
  uptime gauge, a wall clock, excepted).
- An engine's exposition renders, and its engine-level counters follow
  what the engine did.
"""
import math

import numpy as np
import pytest

from tnn_tpu.serving import metrics as jm
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.serving import metrics as tm
from tnn_tpu_torch.serving.engine import InferenceEngine


def test_constants_and_registry_match_jax():
    assert tm.RESERVOIR_SIZE == jm.RESERVOIR_SIZE
    assert tm.LATENCY_BUCKETS_S == jm.LATENCY_BUCKETS_S
    assert tm.EXPOSITION == jm.EXPOSITION
    assert tm._DIRECT_FAMILIES == jm._DIRECT_FAMILIES


@pytest.mark.parametrize("cap,n", [(8, 5), (16, 1000), (64, 10_000)])
def test_reservoir_keeps_jax_samples(cap, n):
    xs = np.random.default_rng(cap).random(n).tolist()
    a, b = tm.Reservoir("ttft_s", cap=cap), jm.Reservoir("ttft_s", cap=cap)
    for x in xs:
        a.append(x)
        b.append(x)
    assert list(a) == list(b)
    assert len(a) == min(cap, n) and a.seen == b.seen == n
    with pytest.raises(ValueError, match="cap"):
        tm.Reservoir("x", cap=0)


def test_histogram_and_rendering_match_jax():
    values = [0.0005, 0.003, 0.003, 0.2, 1.5, 99.0, float("nan"),
              float("inf"), 0.01]
    ha, hb = tm.Histogram(), jm.Histogram()
    for v in values:
        ha.observe(v)
        hb.observe(v)
    assert ha.samples() == hb.samples()
    fams = [{"name": "x_seconds", "type": "histogram", "help": "a \"q\"",
             "samples": ha.samples()},
            {"name": "y_total", "type": "counter", "help": "b",
             "samples": [("", {"k": 'v"\\\n'}, 3.0)]}]
    labelled_a = tm.label_series(fams, {"replica": "0"})
    labelled_b = jm.label_series(fams, {"replica": "0"})
    assert labelled_a == labelled_b
    merged_a = tm.merge_series(labelled_a, tm.label_series(
        fams, {"replica": "1"}))
    merged_b = jm.merge_series(labelled_b, jm.label_series(
        fams, {"replica": "1"}))
    assert merged_a == merged_b
    assert tm.render_prometheus(merged_a) == jm.render_prometheus(merged_b)
    text = tm.render_prometheus(merged_a)
    assert 'x_seconds_bucket{le="+Inf",replica="1"} 7' in text
    assert text.count("# TYPE x_seconds histogram") == 1


def _observe(m):
    """The same observations, through every observer both packages
    share."""
    for i in range(40):
        m.observe_ttft(0.001 * i, under_load=i % 3 == 0)
        m.observe_step_latency(0.002 * (i % 7))
        m.observe_queue_wait(0.0005 * i)
        m.observe_host_gap(0.0001 * i)
    m.observe_prefill(12, 0.05)
    for n in (8, 8, 3):
        m.observe_prefill_chunk(n)
    m.observe_prefix_lookup(8, 12)
    m.observe_prefix_lookup(0, 5)
    m.observe_prefix_cow()
    m.observe_mixed_step(6, 8)
    m.observe_decode_stall(0.02)
    m.observe_overlap_rebuild()
    m.observe_spec(4, 3, 4, rows=2)
    m.observe_gauges(3, 0.25, 512.0, tier_blocks=2, tier_bytes=4096.0)
    m.observe_replicas(2)
    for fn in ("observe_tier_corrupt", "observe_handoff_corrupt",
               "observe_boundary_handoff", "observe_handoff_fallback",
               "observe_fleet_prefix_pull", "observe_shed",
               "observe_restart", "observe_router_retry",
               "observe_hedge_fired", "observe_hedge_won",
               "observe_hedge_cancelled", "observe_ejection",
               "observe_proactive_migration", "observe_publish_suspended",
               "observe_rejected", "observe_cancelled", "observe_timeout",
               "observe_failed", "observe_step_retry"):
        getattr(m, fn)()
    m.observe_tier_hit(3)
    m.observe_handoff_export(4)
    m.observe_handoff_adopt(2)
    m.observe_migration(17)
    m.observe_preemption(5)
    m.observe_preemption(5)
    m.observe_drain(0.5)
    m.observe_finish(0.01)


def _comparable(fams):
    return [(f["name"], f["type"], f["help"],
             None if f["name"] == "tnn_serve_uptime_seconds"
             else f["samples"]) for f in fams]


def test_prometheus_series_and_summary_match_jax():
    a, b = tm.ServingMetrics(), jm.ServingMetrics()
    for m in (a, b):
        _observe(m)
    # the decode observer: the port counts steps at observe_step_latency
    a.observe_decode(4, 0.01, 8)
    b.observe_decode(4, 0.01, 8)
    fa, fb = a.prometheus_series(), b.prometheus_series()
    assert [f["name"] for f in fa] == [f["name"] for f in fb]
    ca, cb = _comparable(fa), _comparable(fb)
    steps = "tnn_serve_steps_total"
    assert [c for c in ca if c[0] != steps] == \
        [c for c in cb if c[0] != steps]
    sa, sb = a.summary(), b.summary()
    assert set(sb) <= set(sa)
    for k in ("requests_finished", "decode_tokens", "prefill_tokens",
              "preemptions", "preemptions_max_per_request", "tier_hits",
              "handoff_exported_blocks", "handoff_adopted_blocks",
              "prefix_hit_rate", "spec_acceptance_rate", "replicas",
              "tier_blocks", "tier_bytes", "kv_bytes_per_token",
              "router_retries", "hedges_fired", "fleet_prefix_pulls",
              "token_latency_ms_p50", "decode_stall_ms_max",
              "mixed_step_fill_mean", "batch_fill_mean", "ttft_ms_mean",
              "migration_resume_tokens", "stall_slo_violations"):
        assert sa[k] == sb[k], k
    # the port's own keys keep their meaning
    assert sa["finished"] == 1 and sa["prefills"] == 1
    assert sa["steps"] == 40            # committed steps of any kind
    assert all(not isinstance(v, float) or math.isfinite(v)
               for v in sa.values() if v is not None)


def test_empty_metrics_summarize_and_render():
    m = tm.ServingMetrics()
    s = m.summary()
    assert set(jm.ServingMetrics().summary()) <= set(s)
    text = tm.render_prometheus(m.prometheus_series())
    assert "tnn_serve_replicas 0" in text
    assert 'tnn_serve_ttft_seconds_bucket{le="+Inf"} 0' in text


def test_engine_exposition_follows_the_engine():
    model = GPT2(vocab_size=128, max_len=64, num_layers=2, d_model=32,
                 num_heads=2, policy=tdt.FP32, device="cpu", seed=0)
    eng = InferenceEngine(model, device="cpu", num_blocks=32, block_size=4,
                          max_batch_size=4, max_seq_len=32)
    rng = np.random.default_rng(0)
    for _ in range(3):
        eng.submit(rng.integers(0, 128, 6), 5)
    eng.run_until_complete()
    fams = {f["name"]: f for f in eng.metrics.prometheus_series()}
    val = {n: f["samples"][0][-1] for n, f in fams.items()
           if f["type"] != "histogram"}
    assert val["tnn_serve_requests_finished_total"] == 3
    assert val["tnn_serve_decode_tokens_total"] == eng.stats()[
        "decode_tokens"]
    assert val["tnn_serve_kv_bytes_per_token"] == \
        eng.pool.kv_bytes_per_token
    ttft = fams["tnn_serve_ttft_seconds"]["samples"]
    assert ttft[-1] == ("_count", {}, 3.0)
    assert ttft[-3][1] == {"le": "+Inf"} and ttft[-3][2] == 3.0
    text = tm.render_prometheus(eng.metrics.prometheus_series())
    assert text.endswith("\n") and "# TYPE tnn_serve_ttft_seconds " \
        "histogram" in text
