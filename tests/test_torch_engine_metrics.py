"""Port parity: the serving engine feeds the metric series the JAX engine
feeds, on the same staggered traffic.

Both engines serve the tiny FP32 GPT-2 of ``tests/test_overlap.py``: four
requests, two of them submitted after four steps, on the paged
(chunked-prefill) path, the whole-prompt path, the overlapped loop and
the n-gram spec path. The sample counts of the five reservoirs (token
latency, decode stall, TTFT under load, mixed-step fill, batch fill),
the two fill means and the histogram counts of the exposition must be
equal; none of them depends on the clock. The gauge keys and the
``stats()`` keys must equal the JAX engine's (the port's ``stats()``
carries the extra keys listed in ``PORT_ONLY_STATS`` beside them).

Left out: ``tnn_serve_steps_total`` and the step-latency histogram. The
port counts a step at every committed step, the JAX engine at every
step it records a latency for (12 against 11 on this traffic): a
deliberate difference, which README states.
"""
import jax
import numpy as np
import pytest

from tnn_tpu.core import dtypes as jdt
from tnn_tpu.models.gpt2 import GPT2 as JGPT2
from tnn_tpu.serving import InferenceEngine as JEngine
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.serving.engine import InferenceEngine

TINY = dict(vocab_size=128, max_len=64, num_layers=2, d_model=32,
            num_heads=2)
KW = dict(num_blocks=32, block_size=4, max_batch_size=4, max_seq_len=32)
RESERVOIRS = ("token_latency_s", "decode_stall_s", "ttft_under_load_s",
              "mixed_step_fill", "batch_fill", "ttft_s")
# the F3 families, which the port left empty before
F3_FAMILIES = ("tnn_serve_token_latency_seconds",
               "tnn_serve_decode_stall_seconds_total",
               "tnn_serve_mixed_step_fill_total",
               "tnn_serve_decode_seconds_total")
STEP_FAMILIES = ("tnn_serve_steps_total", "tnn_serve_step_latency_seconds")
# keys only the port's stats() has: its program counters, graphs and the
# summary's extra means
PORT_ONLY_STATS = {"chunked_prefill", "finished", "graph_replays",
                   "model_steps", "overlap", "overlap_adopted",
                   "prefill_ms_mean", "prefills", "program_steps",
                   "step_graphs", "step_latency_ms_mean"}
PATHS = {"paged": {}, "whole_prompt": {"chunked_prefill": False},
         "overlapped": {"overlap": True}, "ngram": {"spec": "ngram"}}


@pytest.fixture(scope="module")
def tiny():
    jm = JGPT2(**TINY, policy=jdt.FP32)
    params = jm.init(jax.random.PRNGKey(0), (1, 8))["params"]
    tm = GPT2(**TINY, policy=tdt.FP32, device="cpu", seed=None)
    tm.load_jax_params(jax.tree.map(np.asarray, params))
    return jm, params, tm


def _prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 128, n).astype(np.int32) for n in (9, 6, 11, 5)]


def _one_step(eng, overlap):
    if not overlap:
        eng.step()
        return
    if eng.in_flight is None:
        eng.begin_step()
    eng.try_speculate()
    eng.run_deferred()
    eng.finish_step()


def _drive(eng, overlap):
    prompts = _prompts()
    for p in prompts[:2]:
        eng.submit(p, 6)
    for _ in range(4):
        _one_step(eng, overlap)
    for p in prompts[2:]:
        eng.submit(p, 6)
    eng.run_until_complete()
    return eng


def _counts(families):
    """{family: _count} of the histograms, {family: value} of the rest,
    and the names of the histograms."""
    out, hists = {}, set()
    for fam in families:
        if fam["type"] == "histogram":
            hists.add(fam["name"])
            out[fam["name"]] = [s[-1] for s in fam["samples"]
                                if s[0] == "_count"][0]
        else:
            out[fam["name"]] = fam["samples"][0][-1]
    return out, hists


@pytest.fixture(scope="module", params=sorted(PATHS))
def engines(request, tiny):
    jm, params, tm = tiny
    kw = PATHS[request.param]
    overlap = kw.get("overlap", False)
    je = _drive(JEngine(jm, params, **KW, **kw), overlap)
    te = _drive(InferenceEngine(tm, device="cpu", **KW, **kw), overlap)
    te.check_invariants()
    return request.param, je, te


def test_reservoirs_and_fill_means_match_jax(engines):
    path, je, te = engines
    for name in RESERVOIRS:
        assert len(getattr(te.metrics, name)) == \
            len(getattr(je.metrics, name)), (path, name)
    # a path that decodes fills the latency and stall series
    assert len(te.metrics.token_latency_s) > 0
    assert len(te.metrics.decode_stall_s) > 0
    js, ts = je.stats(), te.stats()
    for key in ("mixed_step_fill_mean", "batch_fill_mean"):
        assert ts[key] == pytest.approx(js[key], abs=1e-12), (path, key)
    if path != "whole_prompt":
        # chunked paths run mixed steps with arrivals under load
        assert ts["mixed_step_fill_mean"] > 0
        assert ts["ttft_under_load_ms_p50"] > 0


def test_exposition_counts_match_jax(engines):
    path, je, te = engines
    jc, hists = _counts(je.metrics.prometheus_series())
    tc, _ = _counts(te.metrics.prometheus_series())
    assert set(tc) == set(jc)
    for name in F3_FAMILIES:
        assert (tc[name] > 0) == (jc[name] > 0), (path, name)
    for name in sorted(hists - set(STEP_FAMILIES)):
        assert tc[name] == jc[name], (path, name)
    assert tc["tnn_serve_mixed_step_fill_total"] == pytest.approx(
        jc["tnn_serve_mixed_step_fill_total"], abs=1e-12)


def test_gauge_and_stats_keys_match_jax(engines):
    path, je, te = engines
    assert set(te._health_gauges) == set(je._health_gauges)
    js, ts = je.stats(), te.stats()
    assert set(ts) - PORT_ONLY_STATS == set(js)
    for key in ("tp_degree", "kv_bytes_per_token_per_shard",
                "compiled_step_signatures"):
        assert ts[key] == js[key], (path, key)
    for key in ("tp_degree", "kv_bytes_per_token_per_shard",
                "host_tier_max_bytes"):
        assert te._health_gauges[key] == je._health_gauges[key]


def test_host_tier_bound_in_gauges(tiny):
    _, _, tm = tiny
    eng = InferenceEngine(tm, device="cpu", host_tier_bytes=1 << 20, **KW)
    assert eng._health_gauges["host_tier_max_bytes"] == 1 << 20
    assert eng.stats()["kv_bytes_per_token_per_shard"] == \
        eng.pool.kv_bytes_per_token + eng.pool.kv_scale_bytes_per_token
