"""Port parity: disaggregated serving, the cross-replica KV handoff
(``engine.export_prefix`` / ``adopt_prefix``) and the fleet prefix
directory, against the JAX package's (``tests/test_serving.py::
TestDisagg`` and ``TestPrefixCacheAdoptEdges``), at the tiny size, FP32.

Twin scenarios run one action script on a JAX fleet and a port fleet
(roles ``prefill`` + ``decode``, threshold 16) and compare the client's
event sequence (kind, id, token, final tokens, reason) and the handoff
counters (boundary handoffs, fallbacks, blocks adopted, tokens saved,
corrupt blocks): the boundary handoff with and without KV on the paged
and standard paths, a single-chunk prompt under the overlapped loop (the
export drains the deferred publishes), a corrupt and a slow wire block, a
receiver out of blocks, and the fleet prefix pull followed by a local hit.

Port-only: an int8 pool's exported block adopts byte-equal (data and
scales) into another engine; wire blocks of another geometry or page
width are refused without a corrupt count; sp = 2 exports the 4-tuple
form (the owner shard) and adopts onto the same shards, with the resumed
stream equal to sp = 1; the prefix index's adopt edges.

Tie-free prompts: ``_long`` seeds 6, 8, 11, 13 and 14 and the
fleet-prefix prompts of seed 7, checked at a 1e-3 top-2 margin (seeds 12
and 23 of the JAX file have gaps under 1e-3 here).
"""
import jax
import numpy as np
import pytest
import torch

from tnn_tpu.core import dtypes as jdt
from tnn_tpu.models.gpt2 import GPT2 as JGPT2
from tnn_tpu.serving import EngineSupervisor as JSupervisor
from tnn_tpu.serving import InferenceEngine as JEngine
from tnn_tpu.serving import Router as JRouter
from tnn_tpu.serving.faults import FaultPlan as JPlan
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.serving import (EngineSupervisor, InferenceEngine,
                                   PrefixCache, Router)
from tnn_tpu_torch.serving.faults import FaultPlan
from tnn_tpu_torch.serving.kv_tier import tier_digest

TINY = dict(vocab_size=128, max_len=64, num_layers=2, d_model=32,
            num_heads=2)
KW = dict(num_blocks=64, block_size=4, max_batch_size=4, max_seq_len=64,
          chunk_size=8, decode_path="paged")
THRESH = 16
KEEP = ("event", "id", "token", "tokens", "reason")
MARGIN = 1e-3


@pytest.fixture(scope="module")
def tiny():
    jm = JGPT2(**TINY, policy=jdt.FP32)
    params = jm.init(jax.random.PRNGKey(0), (1, 8))["params"]
    tm = GPT2(**TINY, policy=tdt.FP32, device="cpu", seed=None)
    tm.load_jax_params(jax.tree.map(np.asarray, params))
    return jm, params, tm


def _fleet(tiny, jax_side, n=2, *, plans=None, router_kw=None,
           engine_kw=None):
    jm, params, tm = tiny
    ekw = dict(KW, **(engine_kw or {}))
    plans = plans or [None] * n
    sups = []
    for i in range(n):
        if jax_side:
            p = None if plans[i] is None else JPlan(**plans[i])
            sups.append(JSupervisor(JEngine(jm, params, faults=p, **ekw),
                                    restart_backoff_s=0.0))
        else:
            p = None if plans[i] is None else FaultPlan(**plans[i])
            sups.append(EngineSupervisor(
                InferenceEngine(tm, device="cpu", faults=p, **ekw),
                restart_backoff_s=0.0))
    # placement by queue length alone: health scores and ejection read
    # step times, which differ between the packages and between runs
    rkw = dict(roles=["prefill"] + ["decode"] * (n - 1),
               disagg_prompt_threshold=THRESH, degrade_factor=0.0,
               hedge_budget=0.0, score_tolerance=1e9)
    rkw.update(router_kw or {})
    events = []
    cls = JRouter if jax_side else Router
    return cls(sups, event_sink=events.append, seed=0, **rkw), sups, events


def _long(seed, max_new=6):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 128, THRESH + 8).astype(np.int32), max_new, rng


def _tie_free(tm, prompts, outs):
    for prompt, out in zip(prompts, outs):
        seq = np.concatenate([prompt, out[:-1]]).astype(np.int64)
        with torch.inference_mode():
            logits = tm(torch.from_numpy(seq)[None])[0, len(prompt) - 1:]
        top2 = logits.topk(2, dim=-1).values
        assert (top2[:, 0] - top2[:, 1]).min() > MARGIN
        assert logits.argmax(-1).tolist() == list(out)


def _counters(router, sups):
    st = router.stats()
    recv = sups[1].engine.metrics.summary()
    return {k: st[k] for k in ("boundary_handoffs", "handoff_fallbacks",
                               "fleet_prefix_pulls")} | {
        k: recv[k] for k in ("handoff_adopted_blocks",
                             "prefill_tokens_saved", "handoff_corrupt")}


def _no_leaks(router, skip=()):
    for h in router.replicas:
        if h.idx not in skip:
            assert h.sup.engine.pool.num_allocated == 0
            h.sup.engine.check_invariants()


def sc_handoff(seed, short=True):
    """A long prompt (to the prefill replica, handed to the decode one at
    its first token) and, with ``short``, a short one (to the decode
    replica)."""
    def run(router, sups, events):
        lp, ln, rng = _long(seed)
        glong = router.submit(lp, ln)
        if not short:
            router.run_sync()
            _no_leaks(router)
            return {}, [glong], [lp]
        sp = rng.integers(0, 128, 6).astype(np.int32)
        gshort = router.submit(sp, 5)
        placed = (glong in router.replicas[0].live,
                  gshort in router.replicas[1].live)
        router.run_sync()
        _no_leaks(router)
        return {"placed": placed}, [glong, gshort], [lp, sp]
    return run


def sc_fleet_prefix(router, sups, events):
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, 128, 8).astype(np.int32)
    seeder = np.concatenate([prefix, rng.integers(0, 128, 4).astype(np.int32)])
    shorts = [np.concatenate([prefix,
                              rng.integers(0, 128, 3).astype(np.int32)])
              for _ in range(2)]
    g1 = router.submit(seeder, 1)
    router.run_sync()
    router._refresh_prefix_dir()
    g2 = router.submit(shorts[0], 4)
    router.run_sync()
    pulls = router.stats()["fleet_prefix_pulls"]
    router._refresh_prefix_dir()
    g3 = router.submit(shorts[1], 4)
    router.run_sync()
    _no_leaks(router)
    return {"pulls_after_first": pulls}, [g1, g2, g3], \
        [seeder, shorts[0], shorts[1]]


def sc_hedge_exempt(router, sups, events):
    lp, ln, _ = _long(18)
    gid = router.submit(lp, ln)
    router._maybe_hedge()
    fired = router.stats()["hedges_fired"]
    router.run_sync()
    _no_leaks(router)
    return {"fired": fired}, [], []


SCENARIOS = {
    "kv_paged": (sc_handoff(11), dict()),
    "kv_standard": (sc_handoff(11),
                    dict(engine_kw=dict(decode_path="standard"))),
    "recompute_paged": (sc_handoff(11),
                        dict(router_kw=dict(handoff_kv=False))),
    "recompute_standard": (sc_handoff(11), dict(
        router_kw=dict(handoff_kv=False),
        engine_kw=dict(decode_path="standard"))),
    "overlap_single_chunk": (sc_handoff(6), dict(
        engine_kw=dict(overlap=True, chunk_size=64))),
    "corrupt_wire": (sc_handoff(8), dict(
        plans=[None, dict(handoff_corrupt_calls=(1,))])),
    "slow_wire": (sc_handoff(13), dict(
        plans=[None, dict(handoff_slow_calls=(1,), handoff_slow_s=0.005)])),
    "receiver_full": (sc_handoff(14, short=False), dict(
        plans=[None, dict(alloc_fail_calls=(1,))])),
    "fleet_prefix": (sc_fleet_prefix, dict(router_kw=dict(
        disagg_prompt_threshold=12, fleet_prefix=True))),
    "hedge_exempt": (sc_hedge_exempt, dict(router_kw=dict(
        hedge_ttft_s=0.0, hedge_budget=1.0))),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_disagg_twin_matches_jax(tiny, name):
    fn, kw = SCENARIOS[name]
    out = {}
    for side in (True, False):
        router, sups, events = _fleet(tiny, side, **kw)
        facts, gids, prompts = fn(router, sups, events)
        facts |= _counters(router, sups)
        view = [{k: e[k] for k in KEEP if k in e} for e in events]
        terms = {e["id"]: e for e in view if e["event"] != "token"}
        assert len(terms) == len([e for e in view if e["event"] != "token"])
        out[side] = (facts, view, [terms[g]["tokens"] for g in gids],
                     prompts)
    (jf, jv, jt, _), (tf, tv, tt, prompts) = out[True], out[False]
    assert tf == jf
    assert tv == jv
    assert tt == jt
    _tie_free(tiny[2], prompts, tt)
    if name.startswith("kv_") or name in ("overlap_single_chunk",
                                           "slow_wire"):
        assert tf["boundary_handoffs"] == 1 and tf["handoff_fallbacks"] == 0
        assert tf["handoff_adopted_blocks"] > 0
        assert tf["prefill_tokens_saved"] > 0
    if name in ("corrupt_wire", "receiver_full"):
        assert tf["handoff_fallbacks"] == 1
        assert tf["handoff_adopted_blocks"] == 0
    if name == "fleet_prefix":
        assert tf["fleet_prefix_pulls"] == tf["pulls_after_first"] == 1


def test_roles_validation_matches_jax(tiny):
    jm, params, tm = tiny
    jsups = [JSupervisor(JEngine(jm, params, **KW)) for _ in range(2)]
    tsups = [EngineSupervisor(InferenceEngine(tm, device="cpu", **KW))
             for _ in range(2)]
    for roles in (["prefill"], ["prefill", "gpu"], ["prefill", "prefill"]):
        with pytest.raises(ValueError) as je:
            JRouter(jsups, roles=roles)
        with pytest.raises(ValueError) as te:
            Router(tsups, roles=roles)
        assert str(te.value) == str(je.value)


def _served(eng, prompt, n):
    rid = eng.submit(prompt, n)
    out = eng.run_until_complete()[rid]
    return out


def test_int8_round_trip_byte_equal(tiny):
    """An int8 pool's exported chain adopts byte-equal, data and scales,
    and the adopted prefix serves a hit with the same tokens."""
    _, _, tm = tiny
    kw = dict(KW, kv_dtype="int8")
    src = InferenceEngine(tm, device="cpu", **kw)
    dst = InferenceEngine(tm, device="cpu", **kw)
    lp, _, _ = _long(11)
    want = _served(src, lp, 4)
    ex = src.export_prefix(lp)
    assert len(ex) == len(lp) // 4 and all(len(e) == 3 for e in ex)
    leaves = ex[0][1]
    assert [x.dtype for x in leaves] == [np.int8, np.float32] * 2
    assert sum(x.nbytes for x in leaves) == 2 * (2 * 2 * 4 * 16 + 2 * 2 * 4
                                                 * 4)
    assert dst.adopt_prefix(ex) == len(ex)
    for key, lv, digest in ex:
        blk = dst.prefix_cache.block_of(key)
        back, = dst.pool.export_blocks([blk])
        assert all(np.array_equal(a, b) for a, b in zip(back, lv))
        assert tier_digest(key, back) == digest
    assert _served(dst, lp, 4) == want
    # a full-cover hit: every prompt position but the last comes from KV
    assert dst.stats()["prefill_tokens_saved"] == len(lp) - 1
    # adopting again is a dedupe: resident, nothing written
    assert dst.adopt_prefix(ex) == len(ex)
    assert dst.metrics.handoff_adopted_blocks == len(ex)


def test_geometry_guard_refuses_foreign_wire(tiny):
    _, _, tm = tiny
    src = InferenceEngine(tm, device="cpu", **KW)
    lp, _, _ = _long(11)
    _served(src, lp, 2)
    ex = src.export_prefix(lp)
    int8 = InferenceEngine(tm, device="cpu", **dict(KW, kv_dtype="int8"))
    assert int8.adopt_prefix(ex) == 0              # f32 leaves, int8 pool
    other = InferenceEngine(tm, device="cpu", **dict(KW, block_size=8,
                                                     num_blocks=32))
    assert other.adopt_prefix(ex) == 0             # another block size
    wide = [(k, tuple(x.astype(np.float64) for x in lv), None)
            for k, lv, _ in ex]
    wide = [(k, lv, tier_digest(k, lv)) for k, lv, _ in wide]
    same = InferenceEngine(tm, device="cpu", **KW)
    assert same.adopt_prefix(wide) == 0            # another page width
    for e in (int8, other, same):
        assert e.metrics.handoff_corrupt == 0
        assert e.pool.num_allocated == 0 and len(e.prefix_cache) == 0


def test_sp2_exports_owner_shard_and_adopts(tiny):
    _, _, tm = tiny
    kw = dict(KW, sp=2)
    src = InferenceEngine(tm, device="cpu", **kw)
    dst = InferenceEngine(tm, device="cpu", **kw)
    ref = InferenceEngine(tm, device="cpu", **KW)
    lp, _, _ = _long(11)
    _served(src, lp, 2)
    ex = src.export_prefix(lp)
    assert ex and all(len(e) == 4 for e in ex)
    for i, (key, _, _, shard) in enumerate(ex):
        assert shard == src.pool.owner(src.prefix_cache.block_of(key))
        assert shard == i % 2
    assert dst.adopt_prefix(ex) == len(ex)
    for key, _, _, shard in ex:
        assert dst.pool.owner(dst.prefix_cache.block_of(key)) == shard
    cont = np.concatenate([lp, np.asarray([5, 6], np.int32)])
    assert _served(dst, cont, 4) == _served(ref, cont, 4)
    assert dst.stats()["prefill_tokens_saved"] > 0
    # a 3-tuple (sp = 1 sender) adopts round-robin by chain position
    dst3 = InferenceEngine(tm, device="cpu", **kw)
    assert dst3.adopt_prefix([e[:3] for e in ex]) == len(ex)


def test_prefix_cache_adopt_edges():
    pc = PrefixCache(block_size=4)
    assert pc.adopt(b"k1", 3)
    assert not pc.adopt(b"k1", 9)
    assert not pc.adopt(b"k2", 3)
    assert pc.block_of(b"k1") == 3 and pc.block_of(b"k2") is None
    assert pc.key_of(3) == b"k1" and pc.contains_key(b"k1")
    pc.drop_blocks([3])
    assert pc.block_of(b"k1") is None and len(pc) == 0
    assert not pc.contains_block(3) and pc.keys() == []
    assert pc.adopt(b"k1", 7) and pc.block_of(b"k1") == 7
