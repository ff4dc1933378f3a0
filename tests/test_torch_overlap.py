"""Port parity: the overlapped engine loop (``begin_step`` /
``finish_step`` / ``run_deferred`` / ``try_speculate``), cancel and the
deadlines, at the tiny size of ``tests/test_overlap.py``.

- Overlap on is token-exact against the port with overlap off and against
  the JAX engine's overlapped loop (FP32, greedy), on the paged path with
  and without n-gram drafts and on the standard path, with staggered
  arrivals and preemption, with speculative steps adopted and rolled back.
  Prompts and weights are tie-free: every emitted token beats the
  runner-up logit by more than 1e-3 in the port model's own logits.
- Stochastic rows through a rollback: the restored generator state makes
  overlap on draw what overlap off draws, token for token.
- A prefix publish queued by a commit is dropped when its request is
  cancelled before ``run_deferred``.
- Cancel and the deadlines (clock monkeypatched) reach the JAX engine's
  final states on the same scripts.
- On the card (``cuda`` marker, skipped here): a pdecode graph replay
  equals the eager program bit for bit, and each replay adds the captured
  launches to the kernel counters.
"""
import time

import jax
import numpy as np
import pytest
import torch

from tnn_tpu.core import dtypes as jdt
from tnn_tpu.models.gpt2 import GPT2 as JGPT2
from tnn_tpu.serving import InferenceEngine as JEngine
from tnn_tpu.serving import step_build as jstep_build
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.serving import step_build
from tnn_tpu_torch.serving.engine import InferenceEngine
from tnn_tpu_torch.serving.kv_pool import PagedKVPool
from tnn_tpu_torch.serving.scheduler import RequestState

TINY = dict(vocab_size=128, max_len=64, num_layers=2, d_model=32,
            num_heads=2)
KW = dict(num_blocks=32, block_size=4, max_batch_size=4, max_seq_len=32)
MARGIN = 1e-3


@pytest.fixture(scope="module")
def tiny():
    jm = JGPT2(**TINY, policy=jdt.FP32)
    params = jm.init(jax.random.PRNGKey(0), (1, 8))["params"]
    tm = GPT2(**TINY, policy=tdt.FP32, device="cpu", seed=None)
    tm.load_jax_params(jax.tree.map(np.asarray, params))
    return jm, params, tm


def _prompts():
    # test_overlap.py's: a shared 8-token prefix, so the prefix cache
    # publishes and matches
    base = (np.arange(16) * 5 % 128).astype(np.int32)
    return [base[:12], base[:9],
            np.concatenate([base[:8], base[:4] + 1]).astype(np.int32)]


def _tie_free(tm, prompts, outs):
    for prompt, out in zip(prompts, outs):
        seq = np.concatenate([prompt, out[:-1]]).astype(np.int64)
        with torch.inference_mode():
            logits = tm(torch.from_numpy(seq)[None])[0, len(prompt) - 1:]
        top2 = logits.topk(2, dim=-1).values
        assert (top2[:, 0] - top2[:, 1]).min() > MARGIN
        assert logits.argmax(-1).tolist() == list(out)


def _port(tm, overlap, **kw):
    return InferenceEngine(tm, device="cpu", overlap=overlap, **{**KW, **kw})


def _run(eng, prompts, max_new=8, **sub):
    rids = [eng.submit(p, max_new, **sub) for p in prompts]
    out = eng.run_until_complete()
    eng.check_invariants()
    return [out[r] for r in rids]


def _drain(eng):
    """The overlapped drive loop, counting adopted speculative steps."""
    while eng.has_work or eng.in_flight is not None:
        if eng.in_flight is None:
            eng.begin_step()
        eng.try_speculate()
        eng.run_deferred()
        eng.finish_step()
        eng.check_invariants()
    eng.run_deferred()


# -- token exactness ----------------------------------------------------------

@pytest.mark.parametrize("path,spec", [("paged", "off"), ("paged", "ngram"),
                                       ("standard", "off")])
def test_matrix_exact_vs_overlap_off_and_jax(tiny, path, spec):
    jm, params, tm = tiny
    kw = dict(decode_path=path)
    if spec != "off":
        kw["spec"] = spec
    prompts = _prompts()
    eng_off = _port(tm, False, **kw)
    off = _run(eng_off, prompts)
    eng = _port(tm, True, **kw)
    on = _run(eng, prompts)
    jeng = JEngine(jm, params, **KW, overlap=True, **kw)
    jout = _run(jeng, prompts)
    assert on == off == jout
    _tie_free(tm, prompts, on)
    s = eng.stats()
    assert s["program_steps"] == eng_off.stats()["program_steps"]
    assert len(eng.metrics.host_gap_s) > 0
    assert eng.in_flight is None and not eng._deferred
    assert eng.pool.num_allocated == 0
    if spec == "off":
        # a steady pure-decode batch speculates, and every dispatch held
        assert s["overlap_adopted"] > 0 and s["overlap_rebuilds"] == 0
    else:
        assert s["overlap_adopted"] == 0     # a drafter never speculates
        assert s["spec_draft_tokens"] == \
            jeng.metrics.summary()["spec_draft_tokens"]


def test_staggered_preempted_exact(tiny):
    """Arrivals while a step is in flight, on a pool small enough to
    preempt, commit the synchronous loop's tokens and the JAX engine's."""
    jm, params, tm = tiny
    rng = np.random.default_rng(8)     # tie-free (test_overlap's 1 is not)
    prompts = [rng.integers(0, 128, n).astype(np.int32)
               for n in (5, 9, 16, 7)]
    small = dict(num_blocks=9)

    eng_off = _port(tm, False, **small)
    rids_off = [eng_off.submit(prompts[0], 10)]
    eng_off.step()
    eng_off.step()
    rids_off += [eng_off.submit(p, 10) for p in prompts[1:]]
    off = eng_off.run_until_complete()

    def overlapped(eng):
        rids = [eng.submit(prompts[0], 10)]
        eng.begin_step()
        eng.finish_step()
        eng.begin_step()
        # mid-flight arrivals: scheduled at the next build, as a
        # between-steps arrival in the synchronous loop
        rids += [eng.submit(p, 10) for p in prompts[1:]]
        eng.finish_step()
        return rids, eng.run_until_complete()

    eng = _port(tm, True, **small)
    rids, on = overlapped(eng)
    jeng = JEngine(jm, params, **{**KW, **small}, overlap=True)
    jrids, jout = overlapped(jeng)
    assert eng.metrics.preemptions > 0, "the pool was never exhausted"
    assert eng.metrics.preemptions == jeng.metrics.preemptions
    got = [on[r] for r in rids]
    assert got == [off[r] for r in rids_off] == [jout[r] for r in jrids]
    _tie_free(tm, prompts, got)
    assert eng.pool.num_allocated == 0


def test_speculation_adopted_on_steady_batch(tiny):
    _, _, tm = tiny
    prompts = _prompts()
    off = _run(_port(tm, False), prompts)
    eng = _port(tm, True)
    rids = [eng.submit(p, 8) for p in prompts]
    adopted = 0
    while eng.has_work or eng.in_flight is not None:
        if eng.in_flight is None:
            eng.begin_step()
        eng.try_speculate()
        eng.run_deferred()
        before = eng.metrics.overlap_adopted
        eng.finish_step()
        if eng.metrics.overlap_adopted > before:
            adopted += 1
            assert eng.in_flight is not None   # the adopted step is next
    eng.run_deferred()
    assert adopted > 0, "speculation never fired on a steady batch"
    assert adopted == eng.stats()["overlap_adopted"]
    assert eng.stats()["host_gap_ms_p50"] == 0.0   # adoptions gap 0
    assert [eng.result(r).out_tokens for r in rids] == off


def test_mispredict_rolls_back_and_counts(tiny):
    """An arrival between dispatch and commit invalidates the speculative
    step: it is rolled back (its blocks freed, counted) and the rebuilt
    step commits the synchronous loop's tokens, as in the JAX engine."""
    jm, params, tm = tiny
    prompts = _prompts()

    def script(eng):
        rids = [eng.submit(p, 8) for p in prompts[:2]]
        for _ in range(3):
            eng.begin_step()
            eng.finish_step()
        eng.begin_step()
        allocated = eng.pool.num_allocated
        assert eng.try_speculate(), "the speculation gate is closed"
        rids.append(eng.submit(prompts[2], 8))   # breaks the prediction
        eng.finish_step()
        return rids, allocated, eng.run_until_complete()

    eng = _port(tm, True)
    rids, allocated, on = script(eng)
    assert eng.metrics.overlap_rebuilds == 1
    assert eng.metrics.overlap_adopted >= 1      # later steady steps
    jeng = JEngine(jm, params, **KW, overlap=True)
    jrids, _, jout = script(jeng)
    assert jeng.metrics.overlap_rebuilds == 1
    eng_off = _port(tm, False)
    orids = [eng_off.submit(p, 8) for p in prompts[:2]]
    for _ in range(4):
        eng_off.step()
    orids.append(eng_off.submit(prompts[2], 8))
    off = eng_off.run_until_complete()
    got = [on[r] for r in rids]
    assert got == [off[r] for r in orids] == [jout[r] for r in jrids]
    assert eng.pool.num_allocated == 0


def test_rollback_freed_the_pregrown_blocks(tiny):
    _, _, tm = tiny
    eng = _port(tm, True)
    # 7-token prompts: after the first decode the next token opens a block
    rids = [eng.submit(np.arange(7, dtype=np.int32) + i, 8)
            for i in range(2)]
    eng.begin_step()
    eng.finish_step()
    eng.begin_step()
    tables = [list(eng.result(r).block_table) for r in rids]
    free = eng.pool.num_free
    assert eng.try_speculate()
    assert eng.pool.num_free < free               # grown for N+1
    eng.submit(np.arange(3, dtype=np.int32), 4)
    eng.finish_step()
    assert eng.metrics.overlap_rebuilds == 1
    assert [eng.result(r).block_table for r in rids] == tables
    eng.check_invariants()


@pytest.mark.parametrize("mispredict", [False, True])
def test_stochastic_rows_through_speculation(tiny, mispredict):
    """Stochastic rows draw from the engine's generator: an adopted
    speculative step draws where overlap off's next step would, and a
    rolled-back one restores the generator's state, so overlap on matches
    overlap off token for token on every row."""
    _, _, tm = tiny
    prompts = _prompts()
    sub = [dict(temperature=0.9, top_k=20, top_p=0.9), dict(),
           dict(temperature=1.2)]

    def run(overlap):
        eng = _port(tm, overlap, seed=3)
        rids = [eng.submit(p, 10, **s) for p, s in zip(prompts[:2], sub)]
        for _ in range(3):
            eng.step()
        if overlap:
            eng.begin_step()
            assert eng.try_speculate()
            if mispredict:
                rids.append(eng.submit(prompts[2], 10, **sub[2]))
            eng.finish_step()
        else:
            eng.step()
            if mispredict:
                rids.append(eng.submit(prompts[2], 10, **sub[2]))
        if overlap:
            _drain(eng)
        else:
            eng.run_until_complete()
        return eng, [eng.result(r).out_tokens for r in rids]

    eng, on = run(True)
    _, off = run(False)
    assert on == off
    assert eng.metrics.overlap_rebuilds == (1 if mispredict else 0)
    assert eng.metrics.overlap_adopted > 0


def test_rollback_restores_the_generator(tiny):
    _, _, tm = tiny
    eng = _port(tm, True, seed=5)
    eng.submit(_prompts()[0], 8, temperature=1.0)
    for _ in range(2):
        eng.step()
    eng.begin_step()
    state = eng.generator.get_state()
    assert eng.try_speculate()
    assert not torch.equal(eng.generator.get_state(), state)   # it drew
    eng.submit(_prompts()[1], 4)
    eng.finish_step()
    assert torch.equal(eng.generator.get_state(), state)


def test_pack_decode_speculative_matches_jax():
    rows = [type("R", (), dict(next_token=7 + i, cache_len=5 + 3 * i,
                               block_table=[1 + i, 4 + i], temperature=0.5,
                               top_k=3, top_p=0.9))() for i in range(2)]
    for spec in (False, True):
        mine = step_build.pack_decode(rows, b=4, nb=3, scratch=0,
                                      paged=True, fused_available=False,
                                      speculative=spec)
        ref = jstep_build.pack_decode(rows, b=4, nb=3, scratch=0,
                                      kv_key=(), paged=True,
                                      fused_available=False,
                                      speculative=spec)
        for name in ("toks", "offsets", "tables", "temps", "topks", "topps"):
            np.testing.assert_array_equal(getattr(mine, name),
                                          getattr(ref, name))
        assert not mine.lockstep
    lock = step_build.pack_decode(rows[:1], b=2, nb=3, scratch=0,
                                  paged=False, fused_available=True,
                                  speculative=True)
    assert not lock.lockstep and lock.program == "decode"


# -- the deferred phase -------------------------------------------------------

def test_publish_never_lands_for_cancelled(tiny):
    """A publish queued at commit checks its request when it runs:
    cancelled before ``run_deferred``, the publish is dropped."""
    _, _, tm = tiny
    eng = _port(tm, True)
    published = []
    real = eng.prefix_cache.publish
    eng.prefix_cache.publish = (
        lambda *a, **k: (published.append(a), real(*a, **k)))
    rid = eng.submit(_prompts()[0], 8)
    for _ in range(12):
        if eng.in_flight is None:
            eng.begin_step()
        eng.finish_step()          # commits queue publishes, not run yet
        if eng._deferred:
            break
    assert eng._deferred, "no publish was queued"
    assert eng.cancel(rid, "test cancel")
    eng.run_deferred()
    assert published == [], "a publish landed for a cancelled request"
    assert eng.result(rid).state is RequestState.CANCELLED
    assert eng.result(rid).error == "test cancel"
    rid2 = eng.submit(_prompts()[1], 8)      # left alone, it lands
    eng.run_until_complete()
    assert published
    assert eng.result(rid2).state is RequestState.FINISHED


def test_summary_keys_and_host_gap(tiny):
    _, _, tm = tiny
    eng = _port(tm, True)
    _run(eng, _prompts()[:1])
    s = eng.metrics.summary()
    assert {"host_gap_ms_mean", "host_gap_ms_p50", "host_gap_ms_p99",
            "overlap_rebuilds", "overlap_adopted", "cancelled",
            "timed_out"} <= set(s)
    assert s["host_gap_ms_p99"] >= s["host_gap_ms_p50"] >= 0.0
    assert eng.stats()["overlap"] is True
    # on the CPU no step is captured
    assert eng.stats()["step_graphs"] == eng.stats()["graph_replays"] == 0


def test_step_stays_synchronous_and_refuses_double_begin(tiny):
    _, _, tm = tiny
    eng = _port(tm, True)
    eng.submit(_prompts()[0], 4)
    eng.begin_step()
    with pytest.raises(RuntimeError, match="in flight"):
        eng.begin_step()
    events = eng.step()              # finishes the step in flight
    assert eng.in_flight is None and set(events) == {
        "tokens", "finished", "failed", "timed_out"}
    with pytest.raises(RuntimeError, match="no step"):
        eng.finish_step()


# -- cancel and deadlines -----------------------------------------------------

class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


P = np.arange(5, dtype=np.int32)


def _cancel_queued(eng, clock):
    r0 = eng.submit(P, 6)
    eng.step()                                # r0 admitted
    r1 = eng.submit(P, 6)                     # behind r0 at batch 1
    assert eng.cancel(r1)
    return [r0, r1]


def _cancel_running(eng, clock):
    rid = eng.submit(P, 20)
    eng.step()
    assert eng.pool.num_allocated > 0
    assert eng.cancel(rid, "client disconnected")
    return [rid]


def _cancel_in_flight(eng, clock):
    """Cancelled while its step is on the card: the commit skips it."""
    r0, r1 = eng.submit(P, 10), eng.submit(P + 1, 10)
    eng.step()
    eng.begin_step()
    assert eng.cancel(r0)
    events = eng.finish_step()
    assert r0 not in [r for r, _ in events["tokens"]]
    return [r0, r1]


def _deadline_queued(eng, clock):
    rid = eng.submit(P[:4], 4, deadline_s=0.0)
    clock.t += 0.5
    events = eng.step()
    assert [r for r, _ in events["timed_out"]] == [rid]
    return [rid]


def _deadline_running(eng, clock):
    rid = eng.submit(P[:4], 25, deadline_s=1.0)
    eng.step()
    eng.step()
    assert eng.result(rid).state.value == "running"
    clock.t += 2.0
    events = eng.step()
    assert [r for r, _ in events["timed_out"]] == [rid]
    return [rid]


def _max_queue(eng, clock):
    r0 = eng.submit(P[:4], 6)
    eng.step()                                # r0 running
    r1 = eng.submit(P[:4], 6, max_queue_s=0.25)
    clock.t += 0.5
    eng.step()                                # r1 expires, r0 goes on
    return [r0, r1]


SCRIPTS = {"cancel_queued": (_cancel_queued, dict(max_batch_size=1)),
           "cancel_running": (_cancel_running, {}),
           "cancel_in_flight": (_cancel_in_flight, {}),
           "deadline_queued": (_deadline_queued, {}),
           "deadline_running": (_deadline_running, {}),
           "max_queue": (_max_queue, dict(max_batch_size=1))}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_lifecycle_matches_jax(tiny, monkeypatch, name):
    """The JAX engine's lifecycle scripts (``tests/test_serving.py``'s
    TestLifecycle) on both engines under one fake clock: the same final
    states, errors, tokens and counters, and every block back."""
    jm, params, tm = tiny
    script, kw = SCRIPTS[name]
    clock = Clock()
    monkeypatch.setattr(time, "perf_counter", clock)
    results = []
    for eng in (_port(tm, True, **kw), JEngine(jm, params,
                                               **{**KW, **kw}, overlap=True)):
        rids = script(eng, clock)
        eng.run_until_complete()
        reqs = [eng.result(r) for r in rids]
        results.append(([(r.state.value, r.error, list(r.out_tokens))
                         for r in reqs],
                        eng.metrics.cancelled, eng.metrics.timed_out))
        assert eng.pool.num_allocated == 0
        assert not eng.scheduler.running and not eng.scheduler.waiting
    assert results[0] == results[1]
    states = {s for s, _, _ in results[0][0]}
    assert states & {"cancelled", "timed_out"}


def test_cancel_unknown_or_terminal_is_false(tiny):
    _, _, tm = tiny
    eng = _port(tm, False)
    rid = eng.submit(P[:4], 2)
    eng.run_until_complete()
    assert not eng.cancel(rid)                  # FINISHED
    assert not eng.cancel(12345)                # never existed
    assert eng.result(rid).state is RequestState.FINISHED
    rid = eng.submit(P[:4], 2)
    assert eng.cancel(rid) and not eng.cancel(rid)
    assert eng.stats()["requests_cancelled"] == 1


def test_speculation_refuses_deadline_rows(tiny):
    _, _, tm = tiny
    eng = _port(tm, True)
    eng.submit(P, 8, deadline_s=60.0)
    eng.step()
    eng.step()
    eng.begin_step()
    assert not eng.try_speculate()
    eng.finish_step()


# -- on the card --------------------------------------------------------------

CARD = dict(vocab_size=128, max_len=64, num_layers=2, d_model=128,
            num_heads=2)            # head_dim 64: the kernel's width


def _card_engine(**kw):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    tm = GPT2(**CARD, device="cuda", seed=0)
    eng = InferenceEngine(tm, device="cuda", **{**KW, **kw})
    for i, p in enumerate(_prompts()):
        eng.submit(p, 16, temperature=0.8 if i == 1 else 0.0, top_k=20)
    while any(r.cache_len < r.prefill_len or not r.out_tokens
              for r in eng.requests.values()):
        eng.step()
    return tm, eng


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_graph_replay_equals_eager_bit_for_bit(kv_dtype):
    from tnn_tpu_torch.serving import step_graph

    tm, eng = _card_engine(kv_dtype=kv_dtype)
    eng.step()                                  # captures and replays
    graph = eng._decode_graph()
    live = list(eng.scheduler.running)
    step = step_build.pack_decode(live, b=4, nb=eng.blocks_per_seq,
                                  scratch=PagedKVPool.SCRATCH, paged=True,
                                  fused_available=False)
    arrays = step_graph.decode_arrays(step)
    state = eng.generator.get_state()
    with torch.inference_mode():
        views = step_build.split_inputs(
            step_graph.stage(arrays).to("cuda"), arrays)
        logits, bundle = eng._pdecode(*views)
        logits, bundle = logits.clone(), bundle.clone()
        drawn = eng.generator.get_state()
        eng.generator.set_state(state)
        graph.run(step_graph.stage(arrays))
        torch.cuda.synchronize()
    assert torch.equal(graph.logits, logits)
    assert torch.equal(graph.bundle, bundle)
    # a replay advances the generator as the eager program does
    assert torch.equal(eng.generator.get_state(), drawn)


@pytest.mark.cuda
def test_replays_tick_the_launch_counters():
    from tnn_tpu_torch.ops import paged_attention as pa

    tm, eng = _card_engine()
    eng.step()
    graph = eng._decode_graph()
    before, replays = pa.paged_attention.launches, graph.replays
    for _ in range(3):
        eng.step()
    assert graph.replays == replays + 3
    assert pa.paged_attention.launches == before + 3 * tm.num_layers
    assert eng.stats()["program_steps"]["pdecode"] >= 4
