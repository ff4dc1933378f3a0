"""Port parity: ``serving/router.py`` (``Router``, ``CircuitBreaker``,
``HealthScore``) over the port's supervised engines, against the JAX
router over the JAX package's, at the tiny size of ``tests/
test_serving.py`` (FP32, sync harness unless stated).

Each twin scenario runs the same actions on a JAX fleet and a port fleet
and compares what a client sees: the event sequence (kind, id, token,
final tokens, reason), the placements, and the router's counters. Tokens
are compared exactly (greedy, tie-free prompts); only wall-clock fields
(latency breakdowns, TTFT) are left out. Scenarios: join-shortest-queue
placement, a kill mid-stream (migration, no token duplicated or dropped),
the router migration budget, every replica dead, an inner restart that
the router never sees, the restart budget failing over, hedging (dedupe,
promotion when the primary dies, the budget), ejection with proactive
migration and re-admission, and add/retire (zero-loss scale-down).

Port-only: the breaker and health score hold JAX's state machines and
numbers, a threaded router serves and drains, a retired replica's pages
are released once its worker exits (the card returns that memory), and
the Prometheus exposition carries one ``replica`` label per replica.

Tie-free prompts: the ``np.arange`` ramps and ``_prompts`` seeds 4, 5, 6,
7 and 10 below, each checked at a 1e-3 top-2 margin (seed 6 at four
prompts and 8 new tokens has a 3e-4 gap).
"""
import queue
import time

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
from tnn_tpu.serving.router import CircuitBreaker as JBreaker
from tnn_tpu.serving.router import HealthScore as JHealth
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.serving import (BreakerState, CircuitBreaker,
                                   EngineSupervisor, HealthScore,
                                   InferenceEngine, Router, ShuttingDown,
                                   SupervisorState)
from tnn_tpu_torch.serving.faults import FaultPlan
from tnn_tpu_torch.serving.metrics import render_prometheus

TINY = dict(vocab_size=128, max_len=64, num_layers=2, d_model=32,
            num_heads=2)
KW = dict(num_blocks=32, block_size=4, max_batch_size=4, max_seq_len=32)
KEEP = ("event", "id", "token", "tokens", "reason")
MARGIN = 1e-3
# the twins route by wall-clock health only where a scenario asks: health
# scores, ejection and adaptive hedging read step times, which differ
# between the packages and from run to run on a loaded host
STEADY = dict(degrade_factor=0.0, hedge_budget=0.0, score_tolerance=1e9)


@pytest.fixture(scope="module")
def tiny():
    jm = JGPT2(**TINY, policy=jdt.FP32)
    params = jm.init(jax.random.PRNGKey(0), (1, 8))["params"]
    tm = GPT2(**TINY, policy=tdt.FP32, device="cpu", seed=None)
    tm.load_jax_params(jax.tree.map(np.asarray, params))
    return jm, params, tm


def _fleet(tiny, jax_side, n, *, plans=None, router_kw=None,
           sup_kw=None):
    jm, params, tm = tiny
    plans = plans or [None] * n
    skw = dict(restart_backoff_s=0.0, **(sup_kw or {}))
    sups = []
    for i in range(n):
        if jax_side:
            p = None if plans[i] is None else JPlan(**plans[i])
            sups.append(JSupervisor(JEngine(jm, params, faults=p, **KW),
                                    **skw))
        else:
            p = None if plans[i] is None else FaultPlan(**plans[i])
            sups.append(EngineSupervisor(
                InferenceEngine(tm, device="cpu", faults=p, **KW), **skw))
    events = []
    rkw = dict(STEADY, **(router_kw or {}))
    if "faults" in rkw:
        rkw["faults"] = (JPlan if jax_side else FaultPlan)(**rkw["faults"])
    cls = JRouter if jax_side else Router
    return cls(sups, event_sink=events.append, seed=0, **rkw), sups, events


def _client_view(events):
    return [{k: e[k] for k in KEEP if k in e} for e in events]


def _ramps(n, lens=(5, 6, 7, 8)):
    return [np.arange(k, dtype=np.int32) + i for i, k in
            zip(range(n), lens * 4)]


def _prompts(seed, lens=(5, 6, 7, 8)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, k).astype(np.int32) for k in lens]


def _tie_free(tm, prompts, outs):
    for prompt, out in zip(prompts, outs):
        seq = np.concatenate([prompt, out[:-1]]).astype(np.int64)
        with torch.inference_mode():
            logits = tm(torch.from_numpy(seq)[None])[0, len(prompt) - 1:]
        top2 = logits.topk(2, dim=-1).values
        assert (top2[:, 0] - top2[:, 1]).min() > MARGIN
        assert logits.argmax(-1).tolist() == list(out)


def _done_tokens(events, gids):
    term = {e["id"]: e for e in events if e["event"] != "token"}
    return [term[g]["tokens"] for g in gids]


# -- twin scenarios: each returns (what to compare, gids, prompts) -----------

def sc_jsq(router, sups, events):
    prompts = _prompts(5)
    gids = [router.submit(p, 5) for p in prompts]
    placed = [len(h.live) for h in router.replicas]
    router.run_sync()
    return {"placed": placed,
            "retries": router.stats()["router_retries"]}, gids, prompts


def sc_kill(router, sups, events):
    prompts = _prompts(4)
    gids = [router.submit(p, 8) for p in prompts]
    router.pump(3)
    victim = max(router.replicas, key=lambda h: len(h.live)).idx
    router.kill_replica(victim)
    router.run_sync()
    st = router.stats()
    for h in router.replicas:
        if h.idx != victim:
            assert h.sup.engine.pool.num_allocated == 0
            h.sup.engine.check_invariants()
    return {"victim": victim, "migrated": router.metrics.migrated_requests,
            "breaker": st["replicas"][victim]["breaker_state"]}, gids, \
        prompts


def sc_budget(router, sups, events):
    gid = router.submit(np.arange(5, dtype=np.int32), 8)
    router.pump(2)
    router.kill_replica(next(h.idx for h in router.replicas if h.live))
    router.run_sync()
    return {}, [], []


def sc_all_dead(router, sups, events):
    for i in range(2):
        router.submit(np.arange(5, dtype=np.int32) + i, 8)
    router.pump(1)
    router.kill_replica(0)
    router.kill_replica(1)
    router.run_sync()
    with pytest.raises(Exception) as e:
        router.submit(np.arange(5, dtype=np.int32), 2)
    return {"state": router.state.value, "exit": router.exit_code,
            "raised": type(e.value).__name__}, [], []


def sc_inner_restart(router, sups, events):
    prompts = _prompts(7)
    gids = [router.submit(p, 5) for p in prompts]
    router.run_sync()
    st = router.stats()
    return {"migrated": router.metrics.migrated_requests,
            "restarts": st["replica_restarts"]}, gids, prompts


def sc_restart_budget(router, sups, events):
    prompts = _prompts(6, lens=(5, 6))
    gids = [router.submit(p, 5) for p in prompts]
    router.run_sync()
    return {"state0": sups[0].state.value,
            "migrated": router.metrics.migrated_requests >= 1}, gids, \
        prompts


def sc_hedge(router, sups, events):
    p = np.arange(6, dtype=np.int32)
    gid = router.submit(p, 5)
    router._probe()
    rec = router._open[gid]
    live = [len(h.live) for h in router.replicas]
    hedge_replica = rec.hedge_replica
    router.run_sync()
    for h in router.replicas:
        assert not h.live and h.sup.engine.pool.num_allocated == 0
    return {"fired": router.metrics.hedges_fired,
            "cancelled": router.metrics.hedges_cancelled,
            "live": live, "hedge_replica": hedge_replica,
            "breakers": [h.breaker.state.value for h in router.replicas]}, \
        [gid], [p]


def sc_hedge_promoted(router, sups, events):
    p = np.arange(6, dtype=np.int32)
    gid = router.submit(p, 5)
    router._probe()
    router.kill_replica(0)
    replica = router._open[gid].replica
    router.run_sync()
    return {"replica": replica, "won": router.metrics.hedges_won,
            "migrated": router.metrics.migrated_requests}, [gid], [p]


def sc_hedge_budget(router, sups, events):
    for i in range(5):
        router.submit(np.arange(5, dtype=np.int32) + i, 4)
    router._probe()
    fired = router.metrics.hedges_fired
    router.run_sync()
    return {"fired": fired}, [], []


def sc_eject(router, sups, events):
    p = np.arange(6, dtype=np.int32)
    gid = router.submit(p, 8)
    router.pump(2)
    router.replicas[0].health.step_latency_s = 1.0
    router._probe()
    router._probe()
    moved = router._open[gid].replica
    router.run_sync()
    return {"ejections": router.metrics.degraded_ejections,
            "proactive": router.metrics.proactive_migrations,
            "moved": moved,
            "breaker0": router.replicas[0].breaker.state.value}, [gid], [p]


def sc_readmit(router, sups, events):
    """Ejected, then back under the readmit factor for the window:
    readmitted, and placement spreads over all three again."""
    router.pump(1)
    router.replicas[0].health.step_latency_s = 1.0
    router._probe()
    router._probe()
    ejected = router.replicas[0].degraded
    router.replicas[0].health.step_latency_s = 0.0
    for h in router.replicas[1:]:
        h.health.step_latency_s = 0.0
    router._probe()
    router._probe()
    gids = [router.submit(np.arange(5, dtype=np.int32) + i, 4)
            for i in range(3)]
    placed = sorted(router._open[g].replica for g in gids)
    router.run_sync()
    return {"ejected": ejected, "readmitted": not router.replicas[0].degraded,
            "available": router.replicas[0].available, "placed": placed}, \
        [], []


def sc_retire(router, sups, events):
    prompts = _prompts(10)
    gids = [router.submit(p, 8) for p in prompts]
    router.pump(3)
    victim = max(router.replicas, key=lambda h: len(h.live)).idx
    ok = router.retire_replica(victim)
    extra = router.submit(prompts[0], 8)
    router.run_sync()
    for h in router.replicas:
        assert h.sup.engine.pool.num_allocated == 0
    return {"ok": ok, "active": router.num_active_replicas(),
            "extra_on_victim": extra in router.replicas[victim].live,
            "proactive": router.metrics.proactive_migrations > 0}, \
        gids + [extra], prompts + [prompts[0]]


HEDGE_KW = dict(hedge_ttft_s=0.0, hedge_budget=1.0, degrade_factor=0.0)
GRAY_KW = dict(hedge_budget=0.0, degrade_factor=2.0, degrade_window_s=0.0,
               degrade_cooldown_s=1000.0, migration_budget=3)

SCENARIOS = {
    "jsq": (sc_jsq, dict(n=2)),
    "kill": (sc_kill, dict(n=3)),
    "migration_budget": (sc_budget,
                         dict(n=2, router_kw=dict(migration_budget=0))),
    "all_dead": (sc_all_dead, dict(n=2, router_kw=dict(
        retry_backoff_s=0.0, retry_jitter_s=0.0))),
    "inner_restart": (sc_inner_restart, dict(
        n=2, plans=[dict(step_crash_calls=(2,)), None])),
    "restart_budget": (sc_restart_budget, dict(
        n=2, plans=[dict(step_crash_calls=(1, 2, 3, 4, 5, 6)), None],
        sup_kw=dict(max_restarts=1))),
    "hedge": (sc_hedge, dict(n=2, router_kw=HEDGE_KW)),
    "hedge_promoted": (sc_hedge_promoted, dict(n=2, router_kw=HEDGE_KW)),
    "hedge_budget": (sc_hedge_budget, dict(
        n=3, router_kw=dict(HEDGE_KW, hedge_budget=0.4))),
    "eject": (sc_eject, dict(n=3, router_kw=GRAY_KW)),
    "readmit": (sc_readmit, dict(n=3, router_kw=GRAY_KW)),
    "retire": (sc_retire, dict(n=2)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_router_twin_matches_jax(tiny, name):
    fn, kw = SCENARIOS[name]
    out = {}
    for side in (True, False):
        router, sups, events = _fleet(tiny, side, **kw)
        facts, gids, prompts = fn(router, sups, events)
        view = _client_view(events)
        # exactly one terminal event per routed request
        terms = [e["id"] for e in view if e["event"] != "token"]
        assert len(terms) == len(set(terms))
        out[side] = (facts, view, _done_tokens(events, gids), prompts)
    (jf, jv, jt, _), (tf, tv, tt, prompts) = out[True], out[False]
    assert tf == jf
    assert tv == jv
    assert tt == jt
    if prompts:
        _tie_free(tiny[2], prompts, tt)
    if name == "readmit":
        assert tf["ejected"] and tf["readmitted"] and tf["available"]
        assert tf["placed"] == [0, 1, 2]


def test_router_twin_jsq_placement_order(tiny):
    """Uniform scores route byte-identical to JSQ, down to tie-breaks."""
    placed = {}
    for side in (True, False):
        router, _, _ = _fleet(tiny, side, 3)
        gids = [router.submit(np.arange(5, dtype=np.int32) + i, 4)
                for i in range(7)]
        placed[side] = [router._open[g].replica for g in gids]
        router.run_sync()
    assert placed[False] == placed[True] == [0, 1, 2, 0, 1, 2, 0]


def test_add_replica_and_join_fault(tiny):
    _, _, tm = tiny

    def make():
        return EngineSupervisor(InferenceEngine(tm, device="cpu", **KW),
                                restart_backoff_s=0.0)

    plan = FaultPlan(scale_join_fail_calls=(1,))
    events = []
    router = Router([make()], event_sink=events.append, seed=0,
                    faults=plan, **STEADY)
    built = []
    with pytest.raises(ConnectionError):
        router.add_replica(lambda: built.append(1) or make())
    assert built == [] and router.num_active_replicas() == 1
    prompts = _prompts(30)
    gids = [router.submit(p, 5) for p in prompts[:2]]
    router.pump(2)
    assert router.add_replica(make) == 1
    gids += [router.submit(p, 5) for p in prompts[2:]]
    assert len(router.replicas[1].live) > 0
    router.run_sync()
    ref = InferenceEngine(tm, device="cpu", **KW)
    rids = [ref.submit(p, 5) for p in prompts]
    want = ref.run_until_complete()
    assert _done_tokens(events, gids) == [want[r] for r in rids]
    assert router.retire_replica(0)
    assert not router.retire_replica(1), "retired the last replica"
    assert not router.retire_replica(0)
    router.run_sync()


# -- the state machines -------------------------------------------------------

def test_breaker_and_health_score_match_jax():
    trace = {}
    for side, (B, H) in {True: (JBreaker, JHealth),
                         False: (CircuitBreaker, HealthScore)}.items():
        b = B(threshold=2, cooldown_s=0.0)
        log = []
        for op in ("f", "s", "f", "f", "a", "d", "a", "s", "f", "f", "a",
                   "d", "f"):
            if op == "f":
                b.record_failure()
            elif op == "s":
                b.record_success()
            elif op == "d":
                b.on_dispatch()
            else:
                log.append(b.allows())
            log.append((b.state.value, b.failures))
        h = H()
        for i in range(5):
            h.observe_dispatch(0.01 * i)
            h.observe_outcome(i % 2 == 0)
            h.observe_gauges(0.002 * i, i, 1.5 * i)
            log.append(h.score())
        trace[side] = log
    assert trace[False] == trace[True]
    with pytest.raises(ValueError, match="threshold"):
        CircuitBreaker(threshold=0)


# -- threads, release and the exposition --------------------------------------

def test_threaded_router_serves_drains_and_releases(tiny):
    _, _, tm = tiny
    sups = [EngineSupervisor(InferenceEngine(tm, device="cpu", **KW),
                             restart_backoff_s=0.0) for _ in range(2)]
    events = []
    router = Router(sups, event_sink=events.append, seed=0,
                    probe_interval_s=0.01)
    p = np.arange(6, dtype=np.int32)
    ref = InferenceEngine(tm, device="cpu", **KW)
    rid = ref.submit(p, 5)
    want = ref.run_until_complete()[rid]
    router.start()
    got = queue.Queue()
    gid = router.submit(p, 5, listener=got.put)
    seen = [got.get(timeout=60)]
    while seen[-1]["event"] == "token":
        seen.append(got.get(timeout=60))
    assert seen[-1]["event"] == "done" and seen[-1]["tokens"] == want
    assert [e["token"] for e in seen[:-1]] == want
    # a retired replica gives its pages back once its worker exits
    assert router.retire_replica(1)
    for _ in range(600):
        if router.replicas[1].released:
            break
        router._wake.set()
        time.sleep(0.01)
    assert router.replicas[1].released
    assert sups[1].engine.pool.pages_k.numel() == 0
    assert sups[0].engine.pool.pages_k.numel() > 0
    router.request_drain("test over")
    assert router.join(timeout=30)
    assert router.state is SupervisorState.STOPPED
    assert router.exit_code == 0
    assert gid in {e["id"] for e in events}
    with pytest.raises(ShuttingDown):
        router.submit(p, 2)


def test_prometheus_series_labels_every_replica(tiny):
    _, _, tm = tiny
    sups = [EngineSupervisor(InferenceEngine(tm, device="cpu", **KW),
                             restart_backoff_s=0.0) for _ in range(3)]
    router = Router(sups, seed=0, **STEADY)
    router.submit(np.arange(5, dtype=np.int32), 4)
    router.run_sync()
    fams = {f["name"]: f for f in router.prometheus_series()}
    fam = fams["tnn_serve_replica_health_score"]
    assert sorted(l["replica"] for _, l, _ in fam["samples"]) == \
        ["0", "1", "2"]
    fin = fams["tnn_serve_requests_finished_total"]
    by = {l["replica"]: v for _, l, v in fin["samples"]}
    assert set(by) == {"router", "0", "1", "2"} and sum(by.values()) == 1
    text = render_prometheus(router.prometheus_series())
    assert 'tnn_serve_ttft_seconds_bucket{le="+Inf",replica="0"}' in text
    g = router.health_gauges()
    assert g["replicas_total"] == 3 and g["replicas_healthy"] == 3
    assert router.stats()["requests_finished"] == 1
    assert all(r["breaker_state"] == BreakerState.CLOSED.value
               for r in router.stats()["replicas"])
