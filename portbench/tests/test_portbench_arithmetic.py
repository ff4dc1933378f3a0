"""The metric arithmetic against hand values."""
from __future__ import annotations

import math
from types import SimpleNamespace

import pytest

from portbench import devtrace, harness, yardstick
from portbench.drivers.serve import Rec
from portbench.tests.tiny import REPO

BASE = REPO / "portbench"


def _reader(name):
    return harness.load_module("metrics", name, BASE)


def test_percentile_nearest_rank():
    vals = list(range(1, 101))
    assert yardstick.percentile(vals, 95) == 95
    assert yardstick.percentile(vals, 50) == 50
    assert yardstick.percentile([3.0, 1.0, 2.0], 95) == 3.0
    assert yardstick.percentile([5.0], 95) == 5.0
    assert yardstick.percentile([], 95) is None


def test_spread_quartiles():
    # statistics.quantiles(n=4) of 1..9 (exclusive method): 2.5, 5, 7.5
    assert yardstick.spread(range(1, 10)) == pytest.approx(5.0 / 5.0)


def test_train_step_flops():
    f = yardstick.model_flops_per_step(12, 768, 50257, 32, 1024)
    n = 12 * 12 * 768 ** 2 + 50257 * 768
    assert f == (6 * n + 6 * 12 * 1024 * 768) * 32 * 1024
    assert f == pytest.approx(2.614e13, rel=1e-3)


def test_flash_work_at_the_train_shape():
    (fb, fo), (bb, bo) = yardstick.flash_work(32, 12, 1024, 64, 2)
    pairs = 32 * 12 * 1024 * 1025 // 2
    assert pairs == 201_523_200
    qo = 32 * 12 * 1024 * 64 * 2
    rows = 32 * 12 * 1024
    assert fo == 4 * 64 * pairs and bo == 10 * 64 * pairs
    assert fb == 4 * qo + 4 * rows == 202_899_456
    assert bb == 8 * qo + 4 * rows
    # K4 is bound by bytes, K7 by operations at this shape
    assert yardstick.least_time_s(fb, fo) == pytest.approx(fb / 3.35e12)
    assert yardstick.least_time_s(bb, bo) == pytest.approx(bo / 989e12)


def test_serve_request_flops_by_hand():
    L, d, V = 2, 4, 10
    blocks, head = 2 * 12 * L * d * d, 2 * V * d

    def attn(keys):
        return 4 * L * d * keys

    # a 3-token prompt, tokens 0..1: prefill of positions 0, 1 (1 + 2
    # keys), then positions 2 and 3 with the head (3 and 4 keys)
    want = 2 * blocks + attn(3) + 2 * (blocks + head) + attn(3 + 4)
    assert yardstick.serve_request_flops(L, d, V, 3, 0, 2) == want
    # tokens 1..2 only: positions 3 and 4, no prefill
    assert yardstick.serve_request_flops(L, d, V, 3, 1, 3) == \
        2 * (blocks + head) + attn(4 + 5)
    assert yardstick.serve_request_flops(L, d, V, 3, 2, 2) == 0.0


def test_kernel_label():
    assert yardstick.kernel_label(
        "void flash_bwd_wgmma_kernel<64, false>(CUtensorMap, int)") == \
        "flash_bwd_wgmma_kernel<64, false>"
    assert yardstick.kernel_base(
        "void (anonymous namespace)::paged_attention_kernel<bf16>(Params)") \
        == "paged_attention_kernel"


def _serve_run(recs, seconds=10.0, **data):
    bench = harness.load_benchmark(REPO)
    cell = harness.resolve(bench, "serve-gpt2s-r80", REPO)
    run = harness.Run(cell=cell, seed=1, seconds=seconds, traced=False,
                      device=None)
    run.data.update(requests=recs, t0=0.0, t1=20.0, window_end=seconds,
                    counters_end=seconds,
                    **data)
    return run


def _rec(t_sched, t_first, t_last, n, state="done"):
    r = Rec(prompt=[1, 2], out_len=n, t_sched=t_sched)
    r.t_first, r.t_last, r.n, r.state = t_first, t_last, n, state
    return r


def test_latency_tails_over_all_requests():
    recs = [_rec(0.0, 0.001 * (i + 1), 0.001 * (i + 1) + 0.1, 11)
            for i in range(19)]
    recs.append(_rec(5.0, None, None, 0, state="error"))
    run = _serve_run(recs)
    # 20 requests: the 95th percentile is the 19th, the slowest answered
    assert _reader("ttft_p95_ms").read(run) == pytest.approx(19.0)
    assert _reader("tpot_p95_ms").read(run) == pytest.approx(10.0)
    # a second missing request moves the 95th to the first missing one:
    # its wait until the run's end (t1 = 20) stands for it
    recs[0] = _rec(2.0, None, None, 0, state="timeout")
    assert _reader("ttft_p95_ms").read(_serve_run(recs)) == \
        pytest.approx(15.0 * 1e3)


def test_rates_over_the_window():
    run = _serve_run([], seconds=10.0, window_tokens=12345)
    assert _reader("serve_tokens_per_s").read(run) == pytest.approx(1234.5)
    bench = harness.load_benchmark(REPO)
    cell = harness.resolve(bench, "train-gpt2s-b32", REPO)
    run = harness.Run(cell=cell, seed=1, seconds=30, traced=False,
                      device=None)
    run.data.update(steps=100, window_s=31.0, data_wait_s=0.05, batch=32,
                    seq=1024)
    assert _reader("train_step_ms").read(run) == pytest.approx(310.0)
    assert _reader("data_wait_ms.train").read(run) == pytest.approx(0.5)
    assert _reader("mfu.train").read(run) == pytest.approx(
        100 * 2.614e13 / 0.31 / 989e12, rel=1e-3)


def test_trace_reduction_by_hand():
    ns = 1_000_000
    ev = [("win", "user_annotation", 0, 10 * ns),
          ("step", "cpu_op", 0, 9 * ns),
          ("cudaStreamSynchronize", "cuda_runtime", 6 * ns, 8 * ns),
          ("void a_kernel<1>(int)", "kernel", 1 * ns, 3 * ns),
          ("void a_kernel<1>(int)", "kernel", 2 * ns, 4 * ns),
          ("Memcpy HtoD", "gpu_memcpy", 7 * ns, 8 * ns)]
    t = devtrace.reduce_events(ev)
    assert t.window_s == pytest.approx(0.010)
    assert t.busy_s == pytest.approx(0.004)      # [1, 4] and [7, 8]
    assert t.idle_share == pytest.approx(0.6)
    assert t.by_label["a_kernel<1>"] == (pytest.approx(0.004), 2)
    # [0, 1], [4, 7] and [8, 10]: inside "step" (the sync ends at 8)
    assert dict(t.idle_gaps) == {"step": pytest.approx(0.006)}


def test_roofline_share_from_a_trace():
    bench = harness.load_benchmark(REPO)
    cell = harness.resolve(bench, "train-gpt2s-b32", REPO)
    run = harness.Run(cell=cell, seed=1, seconds=30, traced=True,
                      device=None)
    run.data.update(batch=32, seq=1024)
    (fb, fo), _ = yardstick.flash_work(32, 12, 1024, 64, 2)
    least = yardstick.least_time_s(fb, fo)
    run.trace = devtrace.TraceSummary(
        window_s=1.0, busy_s=0.5,
        by_label={"flash_fwd_wgmma_kernel<64>": (24 * 4 * least, 24)},
        device_events=24)
    assert _reader("k4_roofline").read(run) == pytest.approx(25.0)
    assert _reader("k7_roofline").read(run) is None
    assert _reader("idle_share.train").read(run) == pytest.approx(50.0)
    assert not math.isnan(_reader("k4_roofline").read(run))


def test_readers_find_nothing_outside_their_cells():
    run = _serve_run([], window_tokens=0)
    assert _reader("train_step_ms").read(run) is None
    assert _reader("k1_ms_per_step.tpot").read(run) is None
    assert _reader("queue_wait_p95_ms").read(run) is None
    run = SimpleNamespace(data={}, trace=None)
    assert _reader("mixed_step_share.tpot").read(run) is None
