"""Port parity: the reference engine's request controls and its
whole-prompt prefill path.

- ``kv_pool.scatter_prefill`` against JAX's on plain and int8 pages and
  under SP (-1 blocks to the shard's scratch row), bit for bit.
- The whole-prompt ``Scheduler.schedule`` (``chunk_size=0``) against
  JAX's on the cases of ``tests/test_serving.py::TestScheduler`` and a
  scripted run with preemption; ``shed_victim`` likewise.
- ``InferenceEngine(chunked_prefill=False)`` greedy streams token-exact
  against the JAX engine under ``FP32``: paged and standard paths, overlap
  off and on, f32 and int8 pools, a pool small enough to force recompute
  preemption (a preempted row re-prefills its resume sequence), the tiny
  model's seed checked tie-free at a top-2 gap of 1e-3 on the port's own
  logits; SP and the fused path as the JAX engine serves them.
- Bounded admission (reject, shed by priority, block), ``logit_guard``
  off with NaN weights in both models, ``output_tokens`` and
  ``abort_all``, each against the JAX engine on the same script.
"""
import jax
import numpy as np
import pytest
import torch

from tnn_tpu.core import dtypes as jdt
from tnn_tpu.models.gpt2 import GPT2 as JGPT2
from tnn_tpu.ops.pallas.paged_attention import QuantPages as JQuantPages
from tnn_tpu.serving import InferenceEngine as JEngine
from tnn_tpu.serving import kv_pool as jkv
from tnn_tpu.serving import scheduler as jsched
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.ops.paged_attention import QuantPages
from tnn_tpu_torch.serving import kv_pool, step_build
from tnn_tpu_torch.serving import scheduler as tsched
from tnn_tpu_torch.serving.engine import InferenceEngine

TINY = dict(vocab_size=128, max_len=64, num_layers=2, d_model=32,
            num_heads=2)
WIDE = dict(vocab_size=128, max_len=64, num_layers=2, d_model=256,
            num_heads=2)
ENGINE = dict(num_blocks=14, block_size=4, max_batch_size=4)
TIE_GAP = 1e-3


def _models(arch=TINY, seed=0):
    jm = JGPT2(**arch, policy=jdt.FP32)
    params = jm.init(jax.random.PRNGKey(seed), (1, 8))["params"]
    tm = GPT2(**arch, policy=tdt.FP32, device="cpu", seed=None)
    tm.load_jax_params(jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.fixture(scope="module")
def tiny():
    return _models()


def _prompts(seed=1, lens=(5, 13, 22, 9, 17, 30)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, n).astype(np.int32) for n in lens]


def _assert_tie_free(tm, prompts, outs, margin=TIE_GAP):
    for prompt, out in zip(prompts, outs):
        seq = np.concatenate([prompt, out[:-1]]).astype(np.int64)
        with torch.no_grad():
            logits = tm(torch.from_numpy(seq)[None])[0, len(prompt) - 1:]
        top2 = logits.topk(2, dim=-1).values
        assert (top2[:, 0] - top2[:, 1]).min() > margin
        assert logits.argmax(-1).tolist() == list(out)


def _run_both(jm, params, tm, prompts, new=10, jkw=None, tkw=None, **kw):
    jeng = JEngine(jm, params, **kw, **(jkw or {}))
    jr = [jeng.submit(p, new) for p in prompts]
    jout = jeng.run_until_complete()
    eng = InferenceEngine(tm, device="cpu", **kw, **(tkw or {}))
    tr = [eng.submit(p, new) for p in prompts]
    out = eng.run_until_complete()
    eng.check_invariants()
    return jeng, [jout.get(r) for r in jr], eng, [out.get(r) for r in tr]


# -- scatter_prefill ----------------------------------------------------------

@pytest.mark.parametrize("kind", ["plain", "int8"])
def test_scatter_prefill_matches_jax(kind):
    rng = np.random.default_rng(0)
    L, N, H, bs, dh = 2, 9, 2, 4, 8
    blocks = np.array([3, 7, 1, 0], np.int32)      # a scratch-padded tail
    kv = rng.normal(size=(L, H, len(blocks) * bs, dh)).astype(np.float32)
    kv[0, 1, 5] = 0.0                              # an all-zero row
    if kind == "plain":
        pages = rng.normal(size=(L, N, H, bs, dh)).astype(np.float32)
        ref = np.asarray(jkv.scatter_prefill(jax.numpy.asarray(pages),
                                             jax.numpy.asarray(blocks),
                                             jax.numpy.asarray(kv)))
        got = kv_pool.scatter_prefill(torch.from_numpy(pages.copy()),
                                      torch.from_numpy(blocks),
                                      torch.from_numpy(kv))
        # block 0 is scratch: what lands there is not defined
        assert np.array_equal(got.numpy()[:, 1:], ref[:, 1:])
        return
    data = np.zeros((L, N, H, bs, dh), np.int8)
    scale = np.ones((L, N, H, bs, 1), np.float32)
    jpages = JQuantPages(jax.numpy.asarray(data), jax.numpy.asarray(scale))
    ref = jkv.scatter_prefill(jpages, jax.numpy.asarray(blocks),
                              jax.numpy.asarray(kv))
    got = kv_pool.scatter_prefill(
        QuantPages(torch.from_numpy(data.copy()),
                   torch.from_numpy(scale.copy())),
        torch.from_numpy(blocks), torch.from_numpy(kv))
    assert np.array_equal(got.data.numpy()[:, 1:],
                          np.asarray(ref.data)[:, 1:])
    assert np.array_equal(got.scale.numpy()[:, 1:],
                          np.asarray(ref.scale)[:, 1:])
    assert got.scale.numpy()[0, 7, 1, 1, 0] == np.float32(1e-8 / 127.0)


def test_scatter_prefill_sp_sends_holes_to_each_shards_scratch():
    rng = np.random.default_rng(1)
    L, H, bs, dh, nl = 2, 2, 4, 8, 5                # 2 shards of 5 blocks
    table = np.array([[3, 7, 2, 9, 0]], np.int32)   # global ids, scratch 0
    kv = rng.normal(size=(L, H, table.shape[1] * bs, dh)).astype(np.float32)
    local = step_build.shard_tables(table, 2, nl)[:, 0]     # (2, nb)
    shards = [rng.normal(size=(L, nl, H, bs, dh)).astype(np.float32)
              for _ in range(2)]
    got = kv_pool.scatter_prefill([torch.from_numpy(s.copy())
                                   for s in shards],
                                  [torch.from_numpy(t) for t in local],
                                  torch.from_numpy(kv))
    for s in range(2):
        ref = np.asarray(jkv.scatter_prefill(jax.numpy.asarray(shards[s]),
                                             jax.numpy.asarray(local[s]),
                                             jax.numpy.asarray(kv)))
        assert np.array_equal(got[s].numpy()[:, 1:], ref[:, 1:]), s
    # shard 1 owns global 7 and 9 (local 2 and 4): position 1's and 3's
    assert np.array_equal(got[1].numpy()[:, 2],
                          kv.reshape(L, H, 5, bs, dh)[:, :, 1])


# -- the whole-prompt scheduler -----------------------------------------------

class _Pool:
    def __init__(self, free, bs=4):
        self.num_allocatable, self.bs = free, bs

    def blocks_for(self, n):
        return max(1, -(-n // self.bs))


def _both(**kw):
    return [(m, m.Scheduler(chunk_size=0, **kw)) for m in (jsched, tsched)]


def _plan(plan):
    return ([r.rid for r in plan.prefills], [r.rid for r in plan.decodes],
            dict(plan.chunks))


def _req(m, rid, plen, prio=0):
    return m.Request(rid=rid, prompt=np.zeros(plen, np.int32),
                     max_new_tokens=4, priority=prio)


SCHEDULE_CASES = {
    # (scheduler kwargs, prompt lengths, free blocks per step)
    "fcfs_batch_cap": (dict(max_batch_size=2, token_budget=100),
                       (4, 4, 4), (8, 8)),
    "head_of_line": (dict(max_batch_size=4, token_budget=100),
                     (12, 4), (2, 2, 8)),
    "token_budget": (dict(max_batch_size=4, token_budget=10),
                     (8, 8, 3), (8, 8, 8)),
    "sole_over_budget": (dict(max_batch_size=4, token_budget=4),
                         (8, 9), (8, 8, 8)),
}


@pytest.mark.parametrize("case", sorted(SCHEDULE_CASES))
def test_whole_prompt_schedule_matches_jax(case):
    kw, lens, frees = SCHEDULE_CASES[case]
    scheds = _both(**kw)
    for m, s in scheds:
        for i, n in enumerate(lens):
            s.submit(_req(m, i, n))
    for free in frees:
        plans = []
        for m, s in scheds:
            plan = s.schedule(_Pool(free))
            for r in plan.prefills:
                r.cache_len = r.prefill_len
                s.admit(r)
            plans.append(_plan(plan))
        assert plans[0] == plans[1], (case, plans)


def test_whole_prompt_schedule_with_preemption_matches_jax():
    """A scripted run: admissions, decode progress, a LIFO preemption whose
    victim re-queues at the front with its generated tokens, finishes."""
    scheds = _both(max_batch_size=3, token_budget=24)
    for m, s in scheds:
        for i, n in enumerate((10, 3, 12, 20, 7)):
            s.submit(_req(m, i, n))
    for step, free in enumerate([10, 10, 2, 10, 0, 10, 10, 10]):
        plans = []
        for m, s in scheds:
            plan = s.schedule(_Pool(free))
            for r in plan.prefills:
                r.cache_len = r.prefill_len
                s.admit(r)
            for r in s.running:
                r.out_tokens.append(7)
            if step == 2:
                v = s.preempt_victim()
                v.block_table, v.cache_len = [], 0
                s.requeue(v)
            if step == 5:
                s.finish(s.running[0])
            plans.append(_plan(plan))
            plans.append([(r.rid, r.preemptions) for r in s.waiting])
        assert plans[:2] == plans[2:], (step, plans)


def test_shed_victim_matches_jax():
    scheds = _both()
    for m, s in scheds:
        for rid, prio in enumerate((5, 0, 5, 3, 7, 7)):
            s.submit(_req(m, rid, 4, prio))
    for arrival in (-1, 0, 3, 5, 6, 7, 9):
        got = [s.shed_victim(arrival) for _, s in scheds]
        assert [v.rid if v else None for v in got[:1]] == \
            [v.rid if v else None for v in got[1:]], arrival
    assert scheds[1][1].shed_victim(0).rid == 5     # largest value, newest


# -- the whole-prompt engine --------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
@pytest.mark.parametrize("path", ["paged", "standard"])
def test_whole_prompt_engine_token_exact_vs_jax(tiny, path, overlap,
                                                kv_dtype):
    jm, params, tm = tiny
    prompts = _prompts(seed=2)       # seed 1's streams have a 9e-4 gap
    jeng, ref, eng, mine = _run_both(
        jm, params, tm, prompts, chunked_prefill=False, decode_path=path,
        overlap=overlap, kv_dtype=kv_dtype, **ENGINE)
    assert mine == ref and all(len(t) == 10 for t in mine)
    st = eng.stats()
    assert st["preemptions"] == jeng.metrics.summary()["preemptions"] > 0
    assert st["prefills"] == eng.program_steps["prefill"] >= len(prompts)
    assert st["prefix_cache_enabled"] is False and not st["chunked_prefill"]
    assert "mixed" not in eng.program_steps
    if overlap:
        assert st["overlap_adopted"] > 0
    if kv_dtype == "f32":
        _assert_tie_free(tm, prompts, mine)
    assert eng.pool.num_allocated == 0 and not eng.has_work


def test_whole_prompt_first_decode_token_comes_next_step(tiny):
    """A row admitted by a whole-prompt prefill emits its first token from
    the prefill and takes its first decode token in the next step, as in
    the JAX engine; staggered arrivals join a running batch."""
    jm, params, tm = tiny
    p = _prompts(lens=(6, 11, 7))
    logs = []
    for eng in (JEngine(jm, params, chunked_prefill=False, **ENGINE),
                InferenceEngine(tm, device="cpu", chunked_prefill=False,
                                **ENGINE)):
        rids = [eng.submit(p[0], 5)]
        log = [eng.step()["tokens"]]
        rids += [eng.submit(q, 5) for q in p[1:]]
        while eng.has_work:
            log.append(eng.step()["tokens"])
        logs.append([[(rids.index(r), t) for r, t in ev] for ev in log])
        assert [len(eng.output_tokens(r)) for r in rids] == [5, 5, 5]
    assert logs[0] == logs[1]
    assert logs[1][0] == [(0, logs[1][0][0][1])]     # the prefill's token
    assert [r for r, _ in logs[1][1]] == [1, 2, 0]   # prefills, then decode


def test_whole_prompt_sp2_token_exact_vs_jax(tiny):
    jm, params, tm = tiny
    prompts = _prompts(lens=(5, 13, 22, 9))
    kw = dict(num_blocks=16, block_size=4, max_batch_size=4, sp=2,
              chunked_prefill=False)
    _, ref, eng, mine = _run_both(jm, params, tm, prompts, **kw)
    assert mine == ref
    assert eng.stats()["sp_degree"] == 2 and eng.program_steps["prefill"]


def test_whole_prompt_fused_path_token_exact_vs_jax():
    """2L/256d quantizes every matmul, so the fused probe accepts it;
    lockstep decode steps run the fused program after whole prompts."""
    jm, params, tm = _models(WIDE, seed=1)
    prompts = _prompts(seed=3, lens=(6, 6, 9))
    kw = dict(num_blocks=16, block_size=4, max_batch_size=2,
              chunked_prefill=False, decode_path="fused",
              quant_weights=True)
    _, ref, eng, mine = _run_both(jm, params, tm, prompts, new=6, **kw)
    assert mine == ref
    assert eng.stats()["decode_path"] == "fused"
    assert eng.program_steps["fdecode"] > 0


def test_whole_prompt_refusals(tiny):
    _, _, tm = tiny
    with pytest.raises(ValueError, match="requires chunked_prefill"):
        InferenceEngine(tm, device="cpu", chunked_prefill=False,
                        spec="ngram", **ENGINE)
    with pytest.raises(ValueError, match="chunk_size"):
        InferenceEngine(tm, device="cpu", chunk_size=0, **ENGINE)
    with pytest.raises(ValueError, match="admission_policy"):
        InferenceEngine(tm, device="cpu", admission_policy="drop", **ENGINE)
    with pytest.raises(ValueError, match="max_queue_depth"):
        InferenceEngine(tm, device="cpu", max_queue_depth=-1, **ENGINE)
    with pytest.raises(ValueError, match="chunk_size"):
        tsched.Scheduler(chunk_size=-1)


def test_failing_prefill_program_loses_no_request(tiny):
    """A prefill program that raises propagates out of the step; the
    requests the step was to admit (the one whose program raised and the
    one behind it, never launched) FAIL with their blocks freed."""
    _, _, tm = tiny
    eng = InferenceEngine(tm, device="cpu", chunked_prefill=False, **ENGINE)
    rid, behind = eng.submit([1, 2, 3], 4), eng.submit([4, 5], 4)

    def boom(*a, **kw):
        raise RuntimeError("kernel launch failed")

    tm.apply_cached = boom
    try:
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            eng.step()
    finally:
        del tm.apply_cached
    for r in (rid, behind):
        req = eng.result(r)
        assert req.state is tsched.RequestState.FAILED
        assert "kernel launch failed" in req.error and not req.block_table
    assert eng.pool.num_allocated == 0 and not eng.has_work


# -- bounded admission --------------------------------------------------------

def _admission_both(tiny, **kw):
    jm, params, tm = tiny
    return (JEngine(jm, params, **kw, **ENGINE),
            InferenceEngine(tm, device="cpu", **kw, **ENGINE))


def test_admission_reject_matches_jax(tiny):
    p = np.arange(4, dtype=np.int32)
    for eng, exc in zip(_admission_both(tiny, max_queue_depth=2),
                        (jsched.AdmissionRejected,
                         tsched.AdmissionRejected)):
        eng.submit(p, 4)
        eng.submit(p, 4)
        with pytest.raises(exc) as ei:
            eng.submit(p, 4)
        assert (ei.value.queue_depth, ei.value.max_queue_depth) == (2, 2)
        assert "queue full: 2 waiting >= max_queue_depth 2" in str(ei.value)
        assert eng.metrics.rejected == 1 and len(eng.requests) == 2
        eng.run_until_complete()
        assert eng.pool.num_allocated == 0
    assert eng.stats()["rejected"] == 1


def test_admission_shed_by_priority_matches_jax(tiny):
    """A full queue sheds its least important (largest value, newest)
    member for a more important arrival; equal priority still rejects."""
    p = np.arange(5, dtype=np.int32)
    results = []
    for eng, exc in zip(_admission_both(tiny, max_queue_depth=2),
                        (jsched.AdmissionRejected,
                         tsched.AdmissionRejected)):
        bg1 = eng.submit(p, 4, priority=5)
        bg2 = eng.submit(p + 1, 4, priority=5)
        fg = eng.submit(p + 2, 4, priority=0)
        with pytest.raises(exc):
            eng.submit(p + 3, 4, priority=5)
        out = eng.run_until_complete()
        shed = eng.result(bg2)
        results.append((shed.state.value, shed.error, sorted(out),
                        out[bg1], out[fg], eng.metrics.shed,
                        eng.metrics.rejected))
    assert results[0] == results[1]
    assert results[1][0] == "failed" and "priority 5" in results[1][1]
    assert eng.stats()["shed_requests"] == 1


def test_shed_reported_in_next_step_events(tiny):
    """A request shed by a submit appears once, in the next step's
    "failed" events, with its error; later steps do not repeat it."""
    _, _, tm = tiny
    p = np.arange(5, dtype=np.int32)
    eng = InferenceEngine(tm, device="cpu", max_queue_depth=1, **ENGINE)
    bg = eng.submit(p, 4, priority=5)
    eng.submit(p + 1, 4, priority=0)
    ev = eng.step()
    assert ev["failed"] == [(bg, eng.result(bg).error)]
    assert "shed under overload" in ev["failed"][0][1]
    assert all(bg not in dict(eng.step()["failed"]) for _ in range(3))


def test_admission_block_drains_then_accepts(tiny):
    p = np.arange(4, dtype=np.int32)
    outs = []
    for eng in _admission_both(tiny, max_queue_depth=1,
                               admission_policy="block"):
        rids = [eng.submit(p, 6) for _ in range(4)]    # blocks, never raises
        out = eng.run_until_complete()
        outs.append([out[r] for r in rids])
        assert eng.metrics.rejected == 0
    assert outs[0] == outs[1] and outs[1] == [outs[1][0]] * 4


# -- logit guard, output_tokens, abort_all -------------------------------------

@pytest.mark.parametrize("guard", [True, False], ids=["guard", "no_guard"])
def test_logit_guard_with_nan_weights_matches_jax(guard):
    jm, params, _ = _models()
    params = jax.tree.map(np.asarray, params)
    params["h1"]["fc"]["bias"] = params["h1"]["fc"]["bias"].copy()
    params["h1"]["fc"]["bias"][3] = np.nan
    tm = GPT2(**TINY, policy=tdt.FP32, device="cpu", seed=None)
    tm.load_jax_params(params)
    prompts = _prompts(lens=(5, 9))
    for chunked in (True, False):
        jeng, ref, eng, mine = _run_both(
            jm, params, tm, prompts, new=4, logit_guard=guard,
            chunked_prefill=chunked, **ENGINE)
        assert mine == ref
        states = [[e.result(r).state.value for r in sorted(e.requests)]
                  for e in (jeng, eng)]
        assert states[0] == states[1]
        assert set(states[1]) == ({"failed"} if guard else {"finished"})
        if guard:
            assert "non-finite logits" in eng.result(0).error


def test_output_tokens_and_abort_all_match_jax(tiny):
    jm, params, tm = tiny
    prompts = _prompts(lens=(5, 13, 22, 9, 17, 30))
    for include_queued in (False, True):
        seen = []
        for eng in (JEngine(jm, params, **ENGINE),
                    InferenceEngine(tm, device="cpu", **ENGINE)):
            rids = [eng.submit(p, 8) for p in prompts]
            for _ in range(4):
                eng.step()
            outs = [eng.output_tokens(r) for r in rids]
            assert outs[0] == list(eng.result(rids[0]).out_tokens)
            assert eng.prefix_cache is not None
            ev = eng.abort_all("operator abort",
                               include_queued=include_queued)
            states = [eng.result(r).state.value for r in rids]
            errors = [eng.result(r).error for r in rids]
            seen.append((outs, sorted(ev["failed"]), states, errors,
                         eng.scheduler.queue_depth,
                         len(eng.prefix_cache)))
            assert eng.pool.num_allocated == 0
            assert not eng.scheduler.running
        assert seen[0] == seen[1], include_queued
        assert seen[1][5] == 0                  # the index was dropped
        pages = eng.pool.pages_k
        assert not pages.any()                  # zeroed in place
        if not include_queued:
            assert seen[1][4] > 0
            eng.run_until_complete()            # queued work still serves
            assert eng.stats()["requests_finished"] > 0
