"""Port parity: the host KV tier (``serving/kv_tier.py``) and the engine's
demote / re-admit path, against the JAX package's.

- ``tier_digest`` is bit-equal to JAX's on f32, int8 and bf16 leaves (the
  JAX side an ``ml_dtypes`` bfloat16 array, the port's the same raw 16 bits
  as ``BF16_WIRE``), and differs when the dtype name, shape or a byte
  does.
- ``HostKVTier``: the same LRU order, byte accounting, evictions, refusals
  and fault sites (``tier.demote_fail``, ``tier.corrupt``,
  ``tier.slow_readmit``) as JAX's over one scripted sequence.
- An engine with ``host_tier_bytes`` serves a prompt set twice, one
  request at a time, on a 10-block pool (JAX's ``TestTierEngine``): the
  tokens equal the JAX engine's token for token (FP32), on the paged and
  standard paths, with equal tier counters (demotions, readmits, hits);
  int8 pages and the overlapped loop compose, token-exact against the tier
  off; a planted ``tier.corrupt`` degrades to a miss and stays exact.
- A crash restart clears the tier; the refusals (sp > 1, the prefix cache
  off, a negative bound) carry JAX's texts.

Tie-free prompts: ``_prompts`` seeds 1 and 3 (checked below at a 1e-3
top-2 margin on the tiny FP32 model; seed 0 has a 2e-4 gap).
"""
import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from tnn_tpu.core import dtypes as jdt
from tnn_tpu.models.gpt2 import GPT2 as JGPT2
from tnn_tpu.serving import InferenceEngine as JEngine
from tnn_tpu.serving.faults import FaultPlan as JPlan
from tnn_tpu.serving.kv_tier import HostKVTier as JTier
from tnn_tpu.serving.kv_tier import tier_digest as j_digest
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.serving.engine import InferenceEngine
from tnn_tpu_torch.serving.faults import FaultPlan
from tnn_tpu_torch.serving.kv_pool import PagedKVPool
from tnn_tpu_torch.serving.kv_tier import BF16_WIRE, HostKVTier, tier_digest
from tnn_tpu_torch.serving.scheduler import TERMINAL_STATES
from tnn_tpu_torch.serving.supervisor import EngineSupervisor

TINY = dict(vocab_size=128, max_len=64, num_layers=2, d_model=32,
            num_heads=2)
KW = dict(num_blocks=10, block_size=4, max_batch_size=2, max_seq_len=32,
          chunk_size=8)
MARGIN = 1e-3


@pytest.fixture(scope="module")
def tiny():
    jm = JGPT2(**TINY, policy=jdt.FP32)
    params = jm.init(jax.random.PRNGKey(0), (1, 8))["params"]
    tm = GPT2(**TINY, policy=tdt.FP32, device="cpu", seed=None)
    tm.load_jax_params(jax.tree.map(np.asarray, params))
    return jm, params, tm


def _prompts(n=6, seed=0):
    """Prompts sharing a cyclic 8-token prefix, each with its own tail."""
    rng = np.random.default_rng(seed)
    prefix = np.tile(rng.integers(0, 128, 4), 2).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(0, 128, 4).astype(np.int32)])
            for _ in range(n)]


def _serve_serially(eng, prompts, max_new=6):
    out = []
    for p in prompts:
        rid = eng.submit(p, max_new)
        res = eng.run_until_complete()
        out.append(list(res[rid]))
        del eng.requests[rid]
    return out


def _tie_free(tm, prompts, outs):
    for prompt, out in zip(prompts, outs):
        seq = np.concatenate([prompt, out[:-1]]).astype(np.int64)
        with torch.inference_mode():
            logits = tm(torch.from_numpy(seq)[None])[0, len(prompt) - 1:]
        top2 = logits.topk(2, dim=-1).values
        assert (top2[:, 0] - top2[:, 1]).min() > MARGIN
        assert logits.argmax(-1).tolist() == list(out)


# -- the digest ---------------------------------------------------------------

def test_tier_digest_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((2, 2, 4, 16)).astype(np.float32)
    i8 = rng.integers(-127, 128, (2, 2, 4, 16)).astype(np.int8)
    sc = rng.random((2, 2, 4, 1)).astype(np.float32)
    bf = rng.standard_normal((2, 2, 4, 16)).astype(ml_dtypes.bfloat16)
    raw = bf.view(np.uint16).view(BF16_WIRE)
    key = b"\x01" * 16
    assert tier_digest(key, (f32, f32)) == j_digest(key, (f32, f32))
    assert tier_digest(key, (i8, sc, i8, sc)) == j_digest(key,
                                                          (i8, sc, i8, sc))
    assert tier_digest(key, (raw, raw)) == j_digest(key, (bf, bf))
    # an ml_dtypes array hashes alike in the port too
    assert tier_digest(key, (bf, bf)) == j_digest(key, (bf, bf))
    # the dtype name, the shape and every byte are bound
    assert tier_digest(key, (raw.view(np.uint16),) * 2) \
        != tier_digest(key, (raw, raw))
    assert tier_digest(key, (f32.reshape(2, 2, 64),) * 2) \
        != tier_digest(key, (f32, f32))
    flipped = f32.copy()
    flipped.reshape(-1).view(np.uint8)[0] ^= 1
    assert tier_digest(key, (flipped, f32)) != tier_digest(key, (f32, f32))
    assert tier_digest(b"\x02" * 16, (f32, f32)) != tier_digest(key,
                                                                (f32, f32))


def test_pool_export_leaves_hash_like_jax_bf16():
    """The pool's bf16 export carries the pages' raw bits; their digest is
    JAX's digest of the same values as ml_dtypes bfloat16."""
    pool = PagedKVPool(2, 2, 4, 8, block_size=4, dtype=torch.bfloat16,
                       device="cpu")
    pool.pages_k.normal_(generator=torch.Generator().manual_seed(0))
    pool.pages_v.normal_(generator=torch.Generator().manual_seed(1))
    (k, v), = pool.export_blocks([3])
    jk = pool.pages_k[:, 3].float().numpy().astype(ml_dtypes.bfloat16)
    jv = pool.pages_v[:, 3].float().numpy().astype(ml_dtypes.bfloat16)
    assert tier_digest(b"k", (k, v)) == j_digest(b"k", (jk, jv))
    # and it writes back bit for bit
    blk = pool.alloc(1)[0]
    pool.adopt_blocks([(blk, *pool.host_payload((k, v), blk))])
    assert torch.equal(pool.pages_k[:, blk], pool.pages_k[:, 3])
    assert torch.equal(pool.pages_v[:, blk], pool.pages_v[:, 3])


# -- the tier alone -----------------------------------------------------------

def _leaves(seed, n=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


def _script(tier_cls, plan):
    """One scripted sequence of demotes, peeks and readmits; returns
    everything observable."""
    tier = tier_cls(400, fault_plan=plan)
    log = []
    for i in range(6):                       # 128 B each: the 4th evicts
        log.append(("demote", i, tier.demote(bytes([i]) * 4, _leaves(i))))
        log.append(("keys", list(tier.keys()), tier.bytes_used))
    log.append(("big", tier.demote(b"big!", _leaves(9, n=200))))
    log.append(("dup", tier.demote(bytes([5]) * 4, _leaves(7))))
    for i in range(6):
        got = tier.peek(bytes([i]) * 4)
        log.append(("peek", i, None if got is None else
                    [x.tolist() for x in got]))
    for i in range(6):
        got = tier.verify_readmit(bytes([i]) * 4)
        log.append(("readmit", i, None if got is None else
                    [x.tolist() for x in got], len(tier)))
    tier.check_invariants()
    log.append(("stats", tier.stats()))
    if plan is not None:
        log.append(("fired", dict(plan.fired)))
    return log


@pytest.mark.parametrize("faults", [
    None,
    dict(tier_demote_fail_calls=(2,), tier_corrupt_calls=(1,),
         tier_slow_readmit_calls=(2,), tier_slow_readmit_s=0.0),
])
def test_host_tier_matches_jax(faults):
    jplan = JPlan(**faults) if faults else None
    tplan = FaultPlan(**faults) if faults else None
    assert _script(HostKVTier, tplan) == _script(JTier, jplan)


def test_host_tier_refusals():
    with pytest.raises(ValueError, match="max_bytes"):
        HostKVTier(0)


# -- the engine ---------------------------------------------------------------

@pytest.mark.parametrize("path", ["paged", "standard"])
def test_engine_tier_token_exact_against_jax(tiny, path):
    jm, params, tm = tiny
    prompts = _prompts(seed=1)
    jeng = JEngine(jm, params, decode_path=path, host_tier_bytes=1 << 20,
                   **KW)
    teng = InferenceEngine(tm, device="cpu", decode_path=path,
                           host_tier_bytes=1 << 20, **KW)
    j = [_serve_serially(jeng, prompts) for _ in range(2)]
    t = [_serve_serially(teng, prompts) for _ in range(2)]
    assert t == j
    _tie_free(tm, prompts, t[1])
    js, ts = jeng.stats(), teng.stats()
    for k in ("tier_demotions", "tier_readmits", "tier_blocks",
              "tier_corrupt_dropped", "tier_evictions", "tier_hits",
              "prefill_tokens_saved", "prefix_hits", "host_tier_enabled"):
        assert ts[k] == js[k], k
    assert ts["tier_demotions"] > 0 and ts["tier_readmits"] > 0
    assert ts["tier_bytes"] == js["tier_bytes"]
    assert teng.pool.num_allocated == 0
    teng.check_invariants()


def test_engine_tier_composed_int8_overlap(tiny):
    """int8 pages (data + scales demoted and written back together) with
    the overlapped loop and ngram speculation: tier on equals tier off."""
    _, _, tm = tiny
    prompts = _prompts(seed=3)
    kw = dict(KW, kv_dtype="int8", overlap=True, spec="ngram", spec_k=3)
    on = InferenceEngine(tm, device="cpu", host_tier_bytes=1 << 20, **kw)
    off = InferenceEngine(tm, device="cpu", **kw)
    got = [_serve_serially(on, prompts) for _ in range(2)]
    want = [_serve_serially(off, prompts) for _ in range(2)]
    assert got == want
    s = on.stats()
    assert s["tier_demotions"] > 0 and s["tier_readmits"] > 0
    assert on.metrics.summary()["tier_hits"] >= s["tier_readmits"]
    assert s["tier_bytes"] <= s["tier_max_bytes"] == 1 << 20
    on.check_invariants()


def test_planted_corruption_degrades_to_miss(tiny):
    jm, params, tm = tiny
    prompts = _prompts(seed=3)
    plan = FaultPlan(tier_corrupt_calls=(1,))
    eng = InferenceEngine(tm, device="cpu", host_tier_bytes=1 << 20,
                          faults=plan, **KW)
    ref = JEngine(jm, params, **KW)
    got = [_serve_serially(eng, prompts) for _ in range(2)]
    want = [_serve_serially(ref, prompts) for _ in range(2)]
    assert got == want
    assert plan.fired["tier.corrupt"] == 1
    assert eng.stats()["tier_corrupt_dropped"] == 1
    assert eng.metrics.tier_corrupt == 1


def test_tier_cleared_by_crash_restart(tiny):
    _, _, tm = tiny
    prompts = _prompts(seed=0)
    eng = InferenceEngine(tm, device="cpu", host_tier_bytes=1 << 20, **KW)
    _serve_serially(eng, prompts)
    assert len(eng.kv_tier) > 0
    events = []
    sup = EngineSupervisor(eng, event_sink=events.append,
                           restart_backoff_s=0.0)
    sup.submit(prompts[0], 4)
    eng.faults = FaultPlan(step_crash_calls=(1,))
    sup.pump(1)
    assert sup.restarts == 1
    assert len(eng.kv_tier) == 0 and eng.kv_tier.bytes_used == 0
    sup.run_sync()
    assert all(r.state in TERMINAL_STATES for r in eng.requests.values())
    assert eng.pool.num_allocated == 0


def test_engine_refusals_match_jax(tiny):
    jm, params, tm = tiny
    cases = [dict(host_tier_bytes=-5),
             dict(host_tier_bytes=1024, prefix_cache=False),
             dict(host_tier_bytes=1024, chunked_prefill=False)]
    for kw in cases:
        with pytest.raises(ValueError) as je:
            JEngine(jm, params, **KW, **kw)
        with pytest.raises(ValueError) as te:
            InferenceEngine(tm, device="cpu", **KW, **kw)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="host_tier_bytes with sp>1"):
        InferenceEngine(tm, device="cpu", sp=2, host_tier_bytes=1024,
                        **dict(KW, num_blocks=16))
