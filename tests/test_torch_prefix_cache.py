"""Port parity: the prefix cache with copy-on-write (``serving/
prefix_cache.py``, the pool's fork / evictable LRU / ``copy_blocks``, the
scheduler's probe, the engine's match and publishes).

- Chain keys are byte-equal to the JAX package's.
- The index, the evictable pool and ``truncate`` run the JAX tests' cases
  on both packages and give equal results, SP shards included.
- Scheduler plans with the cache (and with ``spec_tokens``) equal JAX's.
- Engines under FP32, greedy, staggered so that later requests find the
  first one's published blocks: the port with the cache on is token-exact
  against the port with it off and against JAX's cache-on engine, with
  equal ``prefill_tokens_saved``, on the paged, standard and fused paths,
  both pool dtypes and sp=2. Seeds are tie-free: every emitted token beats
  the runner-up logit by more than 1e-3 in the port model's own logits.
"""
import json
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tnn_tpu.core import dtypes as jdt
from tnn_tpu.models.gpt2 import GPT2 as JGPT2
from tnn_tpu.serving import InferenceEngine as JEngine
from tnn_tpu.serving import kv_pool as jkv
from tnn_tpu.serving import prefix_cache as jpc
from tnn_tpu.serving import scheduler as jsched
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.ops.paged_attention import QuantPages
from tnn_tpu_torch.serving import kv_pool as tkv
from tnn_tpu_torch.serving import prefix_cache as tpc
from tnn_tpu_torch.serving import scheduler as tsched
from tnn_tpu_torch.serving.engine import InferenceEngine

TINY = dict(vocab_size=128, max_len=64, num_layers=2, d_model=32,
            num_heads=2)
SMALL = dict(vocab_size=512, max_len=64, num_layers=2, d_model=256,
             num_heads=4)
KW = dict(num_blocks=32, block_size=4, max_batch_size=4, max_seq_len=32)
MARGIN = 1e-3


def _pair(cfg):
    jm = JGPT2(**cfg, policy=jdt.FP32)
    params = jm.init(jax.random.PRNGKey(0), (1, 8))["params"]
    tm = GPT2(**cfg, policy=tdt.FP32, device="cpu", seed=None)
    tm.load_jax_params(jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.fixture(scope="module")
def tiny():
    return _pair(TINY)


@pytest.fixture(scope="module")
def small():
    return _pair(SMALL)


def _assert_tie_free(tm, prompts, outs, margin=MARGIN):
    """Every emitted token is its position's argmax in the port model's
    own logits, beating the runner-up by more than ``margin``."""
    with torch.inference_mode():
        for prompt, out in zip(prompts, outs):
            seq = np.concatenate([prompt, out[:-1]]).astype(np.int64)
            logits = tm(torch.from_numpy(seq)[None])[0, len(prompt) - 1:]
            top2 = logits.topk(2, dim=-1).values
            assert (top2[:, 0] - top2[:, 1]).min() > margin
            assert logits.argmax(-1).tolist() == list(out)


def _shared_prompts(seed, n=4, prefix_len=12, tail_len=5, vocab=128):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, prefix_len).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(0, vocab, tail_len)
                            .astype(np.int32)]) for _ in range(n)]


def _staggered(eng, prompts, new=8, check=False):
    """The first request, two steps (its prefill publishes), then the
    rest; with ``check`` the pool's invariants after every step."""
    rids = [eng.submit(prompts[0], new)]
    for _ in range(2):
        eng.step()
    rids += [eng.submit(p, new) for p in prompts[1:]]
    while eng.has_work:
        eng.step()
        if check:
            eng.check_invariants()
    return [list(eng.result(r).out_tokens) for r in rids]


# -- the index ----------------------------------------------------------------

def test_chain_keys_byte_equal_to_jax():
    rng = np.random.default_rng(0)
    assert tpc.ROOT_KEY == jpc.ROOT_KEY
    for bs in (1, 4, 16):
        toks = rng.integers(0, 50257, 70).astype(np.int32)
        keys = tpc.chain_keys(toks, bs)
        assert keys == jpc.chain_keys(toks, bs)
        assert len(keys) == 70 // bs and len(set(keys)) == len(keys)
    assert tpc.block_key(b"x", [1, 2]) == jpc.block_key(b"x", np.array([1, 2]))


def _index_chain(m):
    pc = m.PrefixCache(block_size=4)
    a = np.arange(8, dtype=np.int32)
    b = a.copy()
    b[0] ^= 1
    pc.publish(np.arange(12, dtype=np.int32), [3, 4, 5], 8)
    return m.chain_keys(a, 4)[1] != m.chain_keys(b, 4)[1], pc.probe(b)


def _index_longest(m):
    pc = m.PrefixCache(block_size=4)
    toks = np.arange(12, dtype=np.int32)
    empty = pc.probe(toks)
    pc.publish(toks, [5, 6, 7], 12)
    ext = np.concatenate([toks, np.asarray([99], np.int32)])
    div = ext.copy()
    div[9] ^= 1
    return empty, pc.probe(ext), pc.probe(div)


def _index_cow(m):
    pc = m.PrefixCache(block_size=4)
    toks = np.arange(8, dtype=np.int32)
    pc.publish(toks, [3, 4], 8)
    return pc.probe(toks)


def _index_min_hit(m):
    pc = m.PrefixCache(block_size=4, min_hit_blocks=2)
    toks = np.arange(12, dtype=np.int32)
    pc.publish(toks, [3, 4], 4)
    short = pc.probe(toks)
    pc.publish(toks, [3, 4], 8)
    return short, pc.probe(toks)


def _index_first_wins(m):
    pc = m.PrefixCache(block_size=4)
    toks = np.arange(10, dtype=np.int32)
    return (pc.publish(toks, [3, 4, 5], 10), pc.publish(toks, [8, 9, 10], 10),
            pc.probe(toks), pc.adopt(m.chain_keys(toks, 4)[0], 11),
            pc.adopt(b"other", 11))


def _index_drop(m):
    pc = m.PrefixCache(block_size=4)
    toks = np.arange(8, dtype=np.int32)
    pc.publish(toks, [3, 4], 8)
    pc.drop_blocks([3])
    ext = np.concatenate([toks, np.asarray([9], np.int32)])
    out = [pc.probe(ext), len(pc), pc.contains_block(4)]
    pc.drop_blocks([4, 99])
    out += [len(pc), pc.contains_block(4)]
    pc.publish(toks, [3, 4], 8)
    pc.clear()
    return out + [len(pc), pc.probe(toks)]


@pytest.mark.parametrize("case", [_index_chain, _index_longest, _index_cow,
                                  _index_min_hit, _index_first_wins,
                                  _index_drop],
                         ids=lambda f: f.__name__[7:])
def test_index_cases_match_jax(case):
    assert case(tpc) == case(jpc)


def test_index_expected_values():
    assert _index_cow(tpc) == ([3, 4], 7, True)
    assert _index_longest(tpc) == (([], 0, False), ([5, 6, 7], 12, False),
                                   ([5, 6], 8, False))
    assert _index_first_wins(tpc)[:3] == (2, 0, ([3, 4], 8, False))
    assert _index_chain(tpc) == (True, ([], 0, False))


# -- the pool -----------------------------------------------------------------

def _tpool(**kw):
    return tkv.PagedKVPool(kw.pop("num_layers", 1), 1, 2,
                           kw.pop("num_blocks", 8), 4, device="cpu", **kw)


def _jpool(**kw):
    return jkv.PagedKVPool(num_layers=kw.pop("num_layers", 1),
                           num_kv_heads=1, head_dim=2,
                           num_blocks=kw.pop("num_blocks", 8), block_size=4,
                           **kw)


def _counts(pool):
    return (pool.num_free, pool.num_evictable, pool.num_allocated,
            pool.num_allocatable)


def _pool_reclaim_lru(pool):
    pool.evictable_filter = lambda b: True
    a = pool.alloc(3)
    pool.free(a)
    out = [_counts(pool)]
    pool.check_invariants([])
    reclaimed = []
    pool.reclaim_hook = reclaimed.extend
    got = pool.alloc(6)
    pool.check_invariants([got])
    return out + [reclaimed, sorted(got), _counts(pool)]


def _pool_fork_revives(pool):
    pool.evictable_filter = lambda b: True
    a = pool.alloc(2)
    pool.free(a)
    out = [pool.is_evictable(a[0]), pool.is_evictable(a[1])]
    table = pool.fork(a)
    pool.check_invariants([table])
    out.append(_counts(pool))
    table2 = pool.fork(table)           # a second sharer
    pool.free(table)
    pool.check_invariants([table2])
    pool.free(table2)
    pool.check_invariants([])
    return out + [_counts(pool)]


def _pool_filter(pool):
    a = pool.alloc(4)
    indexed = {a[1], a[3]}
    pool.evictable_filter = indexed.__contains__
    pool.free(a)
    pool.check_invariants([])
    return _counts(pool), [pool.is_evictable(b) for b in a]


def _pool_exhaustion(pool):
    pool.evictable_filter = lambda b: True
    a = pool.alloc(7)
    pool.free(a[:3])
    out = [_counts(pool), pool.can_alloc(3), pool.can_alloc(4)]
    with pytest.raises(jkv.PoolExhausted if isinstance(pool, jkv.PagedKVPool)
                       else tkv.PoolExhausted):
        pool.alloc(4)
    out.append(pool.num_evictable)
    got = pool.alloc(3)
    pool.check_invariants([a[3:], got])
    return out + [set(got) == set(a[:3])]


def _pool_purge(pool):
    pool.evictable_filter = lambda b: True
    dropped = []
    pool.reclaim_hook = dropped.extend
    a = pool.alloc(3)
    pool.free(a)
    purged = sorted(pool.purge_evictable())
    pool.check_invariants([])
    return purged == sorted(a) == sorted(dropped), _counts(pool)


def _pool_truncate(pool):
    table = pool.alloc(4)
    kept = pool.truncate(table, 9)
    pool.check_invariants([kept], [9])
    out = [kept == table[:3], _counts(pool), pool.truncate(kept, 12) == kept]
    cached = set(kept[1:])
    pool.evictable_filter = cached.__contains__
    kept2 = pool.truncate(kept, 3)
    pool.check_invariants([kept2], [3])
    out += [kept2 == kept[:1], _counts(pool), pool.truncate(kept2, 0)]
    return out + [_counts(pool)]


def _pool_sp_shards(pool):
    """SP: reclaim and revival stay on the block's own shard."""
    pool.evictable_filter = lambda b: True
    a = pool.alloc(6)                   # positions 0..5 round-robin
    owners = [pool.owner(b) for b in a]
    pool.free(a[:4])
    pool.check_invariants([a[4:]])
    out = [owners, _counts(pool)]
    reclaimed = []
    pool.reclaim_hook = reclaimed.extend
    b = pool.alloc(6, start=1)          # two free and one reclaimed each
    out += [[pool.owner(x) for x in b], [pool.owner(x) for x in reclaimed],
            _counts(pool)]
    revived = pool.fork([x for x in a[:4] if pool.is_evictable(x)])
    out.append([pool.owner(x) for x in revived])
    pool.check_invariants([a[4:], b, revived])
    return out


POOL_CASES = [_pool_reclaim_lru, _pool_fork_revives, _pool_filter,
              _pool_exhaustion, _pool_purge, _pool_truncate]


@pytest.mark.parametrize("case", POOL_CASES + [_pool_sp_shards],
                         ids=lambda f: f.__name__[6:])
def test_pool_cases_match_jax(case):
    kw = dict(num_blocks=12, sp=2) if case is _pool_sp_shards else {}
    assert case(_tpool(**kw)) == case(_jpool(**kw))


def test_pool_expected_values():
    # free() parks deepest first: the LRU-oldest are the chain's tail
    out = _pool_reclaim_lru(_tpool())
    assert out[0] == (4, 3, 0, 7) and out[-1] == (0, 1, 6, 1)
    assert _pool_fork_revives(_tpool())[-1] == (5, 2, 0, 7)
    assert _pool_exhaustion(_tpool())[:4] == [(0, 3, 4, 3), True, False, 3]
    owners, _, shards, reclaimed, *_ = _pool_sp_shards(_tpool(num_blocks=12,
                                                              sp=2))
    assert owners == [0, 1] * 3 and shards == [1, 0] * 3
    assert reclaimed == [1, 0]


def test_invariants_catch_partition_faults():
    pool = _tpool()
    pool.evictable_filter = lambda b: True
    a = pool.alloc(2)
    pool.free(a)
    with pytest.raises(ValueError, match="use-after-free"):
        pool.check_invariants([a])
    pool._free.append(a[0])
    with pytest.raises(ValueError, match="evictable and free"):
        pool.check_invariants()
    pool = _tpool()
    b = pool.alloc(1)
    pool._evictable[b[0]] = None
    with pytest.raises(ValueError, match="evictable and allocated"):
        pool.check_invariants()
    pool = _tpool()
    t = pool.alloc(4)
    with pytest.raises(ValueError, match="stale tail"):
        pool.check_invariants([t], [4])
    with pytest.raises(ValueError, match="exceed"):
        pool.check_invariants([t[:1]], [9])
    with pytest.raises(KeyError):
        pool.fork([7])


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_copy_blocks_clones_pages_and_scales(kv_dtype):
    pool = tkv.PagedKVPool(2, 2, 4, 6, 4, device="cpu", kv_dtype=kv_dtype)
    gen = torch.Generator().manual_seed(0)
    for p in (pool.pages_k, pool.pages_v):
        if kv_dtype == "int8":
            p.data.copy_(torch.randint(-127, 128, p.data.shape,
                                       generator=gen))
            p.scale.copy_(torch.rand(p.scale.shape, generator=gen))
        else:
            p.copy_(torch.randn(p.shape, generator=gen))
    before = [x.clone() for p in (pool.pages_k, pool.pages_v)
              for x in ((p.data, p.scale) if kv_dtype == "int8" else (p,))]
    tkv.copy_blocks(pool.pages_k, [2], [5])
    tkv.copy_blocks(pool.pages_v, [2], [5])
    after = [x for p in (pool.pages_k, pool.pages_v)
             for x in ((p.data, p.scale) if kv_dtype == "int8" else (p,))]
    for x, y in zip(before, after):
        assert torch.equal(y[:, 5], x[:, 2])               # the clone
        keep = [i for i in range(6) if i != 5]
        assert torch.equal(y[:, keep], x[:, keep])         # nothing else
    assert isinstance(pool.pages_k, QuantPages) == (kv_dtype == "int8")


# -- the scheduler ------------------------------------------------------------

def test_scheduler_with_cache_and_spec_matches_jax():
    """One script through both packages' scheduler, real pool and cache:
    a published prefix (part of it parked evictable) and a decode row
    reserving draft budget. Plans and block demand agree at every step."""
    plans = []
    for sched_m, pool_m, cache_m in ((jsched, jkv, jpc), (tsched, tkv, tpc)):
        pool = (_jpool if pool_m is jkv else _tpool)(num_blocks=12)
        cache = cache_m.PrefixCache(block_size=4)
        pool.evictable_filter = cache.contains_block
        pool.reclaim_hook = cache.drop_blocks
        s = sched_m.Scheduler(max_batch_size=4, token_budget=14,
                              chunk_size=8, spec_tokens=2)
        s.prefix_cache = cache
        shared = np.arange(100, 113, dtype=np.int32)         # 3 full blocks
        owner = pool.alloc(4)
        cache.publish(shared, owner, 12)
        pool.free(owner[2:])            # block 2 parks evictable, 3 frees
        reqs = [sched_m.Request(rid=i, prompt=p, max_new_tokens=4)
                for i, p in enumerate((shared, np.concatenate(
                    [shared[:8], [5, 6, 7]]).astype(np.int32),
                    np.arange(30, dtype=np.int32), shared[:12]))]
        dec = sched_m.Request(rid=9, prompt=np.arange(3, dtype=np.int32),
                              max_new_tokens=4)
        dec.prefill_len = dec.cache_len = 3
        s.admit(dec)
        for r in reqs:
            s.submit(r)
        trace = []
        for _ in range(4):
            plan = s.schedule(pool)
            for r in plan.prefills:
                r.cache_len = cache.probe(r.resume_tokens)[1]
                s.admit(r)
            trace.append(([r.rid for r in plan.prefills], dict(plan.chunks),
                          pool.num_allocatable))
            for r in s.running:
                if r.cache_len < r.prefill_len:
                    r.cache_len += plan.chunks.get(r.rid, 0)
        plans.append(trace)
    assert plans[0] == plans[1]
    assert plans[1][0][1][0] == 1       # 12 of 13 tokens cached: one to go


# -- the engine ---------------------------------------------------------------

# (model, prompt seed: tie-free, extra engine arguments)
ENGINE_CASES = {
    "paged_f32": (TINY, 2, dict(decode_path="paged")),
    "paged_int8": (TINY, 2, dict(decode_path="paged", kv_dtype="int8")),
    "standard_f32": (TINY, 2, dict(decode_path="standard")),
    "standard_int8": (TINY, 2, dict(decode_path="standard",
                                    kv_dtype="int8")),
    "fused": (SMALL, 1, dict(decode_path="fused", quant_weights=True,
                             num_blocks=16, block_size=8, max_batch_size=2,
                             chunk_size=8)),
    "paged_sp2": (TINY, 2, dict(decode_path="paged", sp=2)),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_cache_on_token_exact_vs_off_and_jax(case, tiny, small):
    cfg, seed, kw = ENGINE_CASES[case]
    jm, params, tm = tiny if cfg is TINY else small
    kw = {**KW, **kw}
    prompts = _shared_prompts(seed, n=3 if case == "fused" else 4,
                              prefix_len=16 if case == "fused" else 12,
                              vocab=cfg["vocab_size"])
    prompts.append(prompts[0][:16 if case == "fused" else 12].copy())
    jeng = JEngine(jm, params, **kw)
    want = _staggered(jeng, prompts)
    on = InferenceEngine(tm, device="cpu", **kw)
    got = _staggered(on, prompts, check=True)
    off = InferenceEngine(tm, device="cpu", prefix_cache=False, **kw)
    assert got == want == _staggered(off, prompts)
    _assert_tie_free(on.model, prompts, got)
    saved = on.stats()["prefill_tokens_saved"]
    assert saved == jeng.metrics.summary()["prefill_tokens_saved"] > 0
    assert on.stats()["prefix_cows"] == jeng.metrics.prefix_cows == 1
    assert off.stats()["prefill_tokens_saved"] == 0
    assert on.stats()["prefill_tokens"] + saved == \
        off.stats()["prefill_tokens"]
    assert on.pool.num_allocated == 0 and on.pool.num_evictable > 0
    assert on.stats()["pool_evictable_blocks"] == jeng.pool.num_evictable


def test_cow_at_partial_block_boundary(tiny):
    """An identical prompt resubmitted is a full-cover hit: its last token
    recomputes into a clone of the last matched block, and the published
    original stays intact for the next twin."""
    jm, params, tm = tiny
    p = np.arange(8, dtype=np.int32)           # exactly 2 full blocks
    eng = InferenceEngine(tm, device="cpu", **KW)
    jeng = JEngine(jm, params, **KW)
    seen = []
    for e in (eng, jeng):
        outs = []
        for _ in range(3):
            rid = e.submit(p, 8)
            outs.append(e.run_until_complete()[rid])
            s = e.metrics.summary()
            outs.append((s["prefix_cows"], s["prefill_tokens_saved"]))
        seen.append(outs)
    assert seen[0] == seen[1]
    assert seen[0][1::2] == [(0, 0), (1, 7), (2, 14)]
    assert seen[0][0] == seen[0][2] == seen[0][4]
    eng.check_invariants()


def test_eviction_under_pressure(tiny):
    """Distinct prompts through a small pool: cached blocks are reclaimed
    (oldest first) to serve new allocations, and never leak."""
    _, _, tm = tiny
    eng = InferenceEngine(tm, device="cpu", num_blocks=9, block_size=4,
                          max_batch_size=2, max_seq_len=32)
    off = InferenceEngine(tm, device="cpu", num_blocks=9, block_size=4,
                          max_batch_size=2, max_seq_len=32,
                          prefix_cache=False)
    dropped = []
    inner = eng.pool.reclaim_hook
    eng.pool.reclaim_hook = lambda bs: (dropped.extend(bs), inner(bs))
    rng = np.random.default_rng(5)
    for _ in range(4):
        p = rng.integers(0, 128, 12).astype(np.int32)
        rid, rid_off = eng.submit(p, 6), off.submit(p, 6)
        assert eng.run_until_complete()[rid] == \
            off.run_until_complete()[rid_off]
        eng.check_invariants()
    assert dropped and len(eng.prefix_cache) <= eng.pool.capacity
    assert eng.pool.num_allocated == 0


def test_preemption_and_failure_park_published_blocks(tiny):
    """Preemption and a failed row free through ``pool.free``: their
    published blocks park in the evictable LRU, and the preempted
    request's re-admission forks them back."""
    jm, params, tm = tiny
    prompts = _shared_prompts(2)
    kw = dict(num_blocks=9, block_size=4, max_batch_size=4, max_seq_len=32)
    eng = InferenceEngine(tm, device="cpu", **kw)
    parked = []
    real_preempt = eng._preempt

    def preempt(req):
        published = [b for b in req.block_table
                     if eng.prefix_cache.contains_block(b)]
        real_preempt(req)
        parked.append(all(eng.pool.is_evictable(b) or b in eng.pool._ref
                          for b in published) and bool(published))

    eng._preempt = preempt
    rids = [eng.submit(p, 8) for p in prompts]
    out = eng.run_until_complete()
    eng.check_invariants()
    assert parked and all(parked)
    jeng = JEngine(jm, params, **kw)
    jrids = [jeng.submit(p, 8) for p in prompts]
    jout = jeng.run_until_complete()
    assert [out[r] for r in rids] == [jout[r] for r in jrids]
    assert eng.stats()["preemptions"] == jeng.metrics.preemptions > 0
    assert eng.stats()["prefill_tokens_saved"] == \
        jeng.metrics.prefill_tokens_saved

    # a poisoned row fails; its published blocks park
    eng = InferenceEngine(tm, device="cpu", **KW)
    rid = eng.submit(prompts[0], 8)
    eng.step()                          # the whole prompt: 4 blocks publish
    real = tm.apply_decode_paged

    def poisoned(*a):
        logits = real(*a)
        logits[0] = float("nan")
        return logits

    tm.apply_decode_paged = poisoned
    try:
        events = eng.step()
    finally:
        del tm.apply_decode_paged
    assert [r for r, _ in events["failed"]] == [rid]
    assert eng.pool.num_evictable == 4 and eng.pool.num_allocated == 0
    eng.check_invariants()


def test_short_request_publishes_before_it_finishes(tiny):
    """A request that fills its last block and finishes in the same commit
    still publishes: its publish runs before its table is freed."""
    _, _, tm = tiny
    eng = InferenceEngine(tm, device="cpu", **KW)
    p = np.arange(40, 48, dtype=np.int32)
    eng.submit(p, 1)
    eng.run_until_complete()
    assert len(eng.prefix_cache) == 2 and eng.pool.num_evictable == 2
    rid = eng.submit(p, 1)
    eng.run_until_complete()
    assert eng.stats()["prefill_tokens_saved"] == 7
    assert eng.result(rid).finish_reason == "length"


def test_min_hit_blocks_and_publish_suspension(tiny):
    _, _, tm = tiny
    prompts = _shared_prompts(3, n=2, prefix_len=8)
    eng = InferenceEngine(tm, device="cpu", prefix_cache_min_hit_blocks=3,
                          **KW)
    _staggered(eng, prompts)
    assert eng.stats()["prefix_hits"] == 0 and \
        eng.stats()["prefill_tokens_saved"] == 0
    eng = InferenceEngine(tm, device="cpu", prefix_publish_max_occupancy=0.0,
                          **KW)
    _staggered(eng, prompts)
    s = eng.stats()
    assert s["publish_suspended"] > 0 and s["prefix_indexed_blocks"] == 0
    assert s["prefill_tokens_saved"] == 0 and s["pool_evictable_blocks"] == 0
    with pytest.raises(ValueError, match="min_hit_blocks"):
        InferenceEngine(tm, device="cpu", prefix_cache_min_hit_blocks=0, **KW)


def test_cli_prefix_cache_gauges():
    line = json.dumps({"tokens": list(range(1, 21)), "max_new_tokens": 3})
    summaries = []
    for flags in ([], ["--no-prefix-cache"]):
        proc = subprocess.run(
            [sys.executable, "-m", "tnn_tpu_torch.cli.serve", "--model",
             "gpt2_tiny", "--device", "cpu", "--num-blocks", "16",
             "--block-size", "4", *flags],
            input=line + "\n" + line + "\n", capture_output=True, text=True,
            timeout=120)
        assert proc.returncode == 0, proc.stderr
        done = [json.loads(x) for x in proc.stdout.splitlines()]
        done = [e for e in done if e["event"] == "done"]
        assert len(done) == 2 and done[0]["tokens"] == done[1]["tokens"]
        summaries.append(json.loads(proc.stderr.split("serve summary: ")[1]))
    on, off = summaries
    assert on["prefix_cache_enabled"] and not off["prefix_cache_enabled"]
    assert on["prefix_indexed_blocks"] == on["pool_evictable_blocks"] == 5
    assert off["pool_evictable_blocks"] == 0
    for key in ("prefill_tokens_saved", "prefix_hit_rate", "prefix_cows"):
        assert key in on


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_copy_blocks_on_card_and_attention_reads_the_clone(kv_dtype):
    """On the card: ``copy_blocks`` clones data (and scales) of every layer,
    and the paged kernel (K1 or K2) reads the clone's table to the same
    bits as the source's."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a card")
    from tnn_tpu_torch.ops import paged_attention as tpa

    pool = tkv.PagedKVPool(2, 4, 64, 40, 16, dtype=torch.bfloat16,
                           device="cuda", kv_dtype=kv_dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for pages in (pool.pages_k, pool.pages_v):
        x = torch.randn((2, 40, 4, 16, 64), generator=gen, device="cuda")
        if kv_dtype == "int8":
            data, scale = tpa.quantize_kv_rows(x)
            pages.data.copy_(data)
            pages.scale.copy_(scale)
        else:
            pages.copy_(x)
    src, dst = list(range(1, 9)), list(range(30, 38))
    for pages in (pool.pages_k, pool.pages_v):
        tkv.copy_blocks(pages, src, dst)
        for x in ((pages.data, pages.scale) if kv_dtype == "int8"
                  else (pages,)):
            assert torch.equal(x[:, dst], x[:, src])
    q = torch.randn((2, 5, 8, 64), generator=gen, device="cuda").to(
        torch.bfloat16)
    kw = dict(kv_lens=torch.tensor([128, 77], dtype=torch.int32,
                                   device="cuda"),
              q_lens=torch.tensor([5, 5], dtype=torch.int32, device="cuda"),
              layer=1)
    tables = torch.tensor([src, src[::-1]], dtype=torch.int32, device="cuda")
    clones = torch.tensor([dst, dst[::-1]], dtype=torch.int32, device="cuda")
    a = tpa.paged_attention(q, pool.pages_k, pool.pages_v, tables, **kw)
    b = tpa.paged_attention(q, pool.pages_k, pool.pages_v, clones, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
