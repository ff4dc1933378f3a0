"""Port parity: the seeded fault plan (``serving/faults.py``) and the
engine's fault isolation, at the tiny size of ``tests/test_serving.py``'s
chaos suite.

- ``FaultPlan`` fires the same sites at the same calls as the JAX package's
  for the same seed, over a few hundred calls of every site in one seeded
  order (probabilistic and scheduled hits, the partition window, the flaky
  replica filter), with the same exceptions.
- Engine chaos on one plan (allocation failures, NaN rows in decode and
  prefill, a transient and a persistent decode fault): every request ends
  terminal, in the same state as in the JAX engine, the survivors
  token-identical (FP32, greedy, tie-free prompts), no block leaked.
- The transient retry is token-exact against a fault-free run, sampled
  rows included, and consumes no draws: the sampling generator's state
  after every step equals the fault-free engine's.
- A NaN row fails only its request (decode and prefill sites, the paged
  and standard paths).
"""
import jax
import numpy as np
import pytest
import torch

from tnn_tpu.core import dtypes as jdt
from tnn_tpu.models.gpt2 import GPT2 as JGPT2
from tnn_tpu.serving import InferenceEngine as JEngine
from tnn_tpu.serving import faults as jfaults
from tnn_tpu.serving import kv_pool as jkv
from tnn_tpu.serving.scheduler import RequestState as JState
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.serving import faults
from tnn_tpu_torch.serving import kv_pool as tkv
from tnn_tpu_torch.serving.engine import InferenceEngine
from tnn_tpu_torch.serving.scheduler import TERMINAL_STATES, RequestState

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


def _prompts(n, seed):
    # test_serving.py's TestChaos._prompts
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, int(n_)).astype(np.int32)
            for n_ in rng.integers(4, 14, n)]


def _tie_free(tm, prompts, outs):
    for prompt, out in zip(prompts, outs):
        seq = np.concatenate([prompt, out[:-1]]).astype(np.int64)
        with torch.inference_mode():
            logits = tm(torch.from_numpy(seq)[None])[0, len(prompt) - 1:]
        top2 = logits.topk(2, dim=-1).values
        assert (top2[:, 0] - top2[:, 1]).min() > MARGIN
        assert logits.argmax(-1).tolist() == list(out)


def _assert_drained(eng):
    assert all(r.state in TERMINAL_STATES for r in eng.requests.values())
    assert not eng.has_work
    assert eng.pool.num_allocated == 0
    assert eng.pool.num_free + eng.pool.num_evictable == eng.pool.capacity
    eng.check_invariants()


# -- the plan itself ----------------------------------------------------------

PLAN = dict(seed=5, alloc_fail_prob=0.2, alloc_fail_calls=(3,),
            prefill_exc_prob=0.1, prefill_exc_calls=(2,),
            decode_exc_prob=0.1, decode_exc_calls=(4,),
            nan_logit_prob=0.05, nan_logit_calls=(3,),
            nan_prefill_calls=(2, 7), draft_poison_prob=0.2,
            draft_poison_calls=(1,), step_crash_calls=(5, 9),
            client_disconnect_prob=0.1, client_disconnect_calls=(2,),
            slow_consumer_prob=0.1, malformed_request_calls=(3,),
            replica_kill_prob=0.05, net_delay_prob=0.1, net_drop_calls=(4,),
            replica_slow_prob=0.1, net_partition_prob=0.05,
            net_partition_rounds=3, flaky_replica=1, flaky_drop_prob=0.3,
            tier_demote_fail_prob=0.1, tier_corrupt_calls=(2,),
            tier_slow_readmit_prob=0.1, handoff_corrupt_prob=0.1,
            handoff_slow_calls=(1,), scale_join_fail_prob=0.2)

SITES = ("on_alloc", "on_prefill", "on_decode", "poison_prefill",
         "poison_draft", "poison_rows", "on_step", "client_disconnect",
         "slow_consumer", "malformed_request", "replica_kill", "net_delay",
         "net_drop", "replica_slow", "net_partition", "partition_active",
         "flaky_drop", "tier_demote_fail", "tier_corrupt",
         "tier_slow_readmit", "handoff_corrupt", "handoff_slow",
         "scale_join_fail", "prefill_delay")


def _consult(plan, site, arg, pkg):
    """One call of ``site``; returns what it gave (a value or the name of
    the exception it raised)."""
    fi, crash, exhausted = pkg
    fn = getattr(plan, site)
    try:
        if site == "on_alloc":
            return fn(arg % 5 + 1, 7)
        if site == "poison_rows":
            return fn(arg % 4).tolist()
        if site == "flaky_drop":
            return fn(arg % 3)
        if site == "prefill_delay":
            return fn(arg)
        if site == "partition_active":
            return fn
        return fn()
    except fi as e:
        return ("FaultInjected", e.site, e.call, e.transient)
    except crash as e:
        return ("EngineCrash", str(e))
    except exhausted as e:
        return ("PoolExhausted", str(e))


def test_fault_plan_fires_what_jax_fires():
    ours = faults.FaultPlan(**PLAN)
    ref = jfaults.FaultPlan(**PLAN)
    rng = np.random.default_rng(0)
    order = rng.integers(0, len(SITES), 2400)
    args = rng.integers(0, 100, 2400)
    mine, theirs = [], []
    for i, a in zip(order, args):
        site = SITES[i]
        mine.append(_consult(ours, site, int(a), (
            faults.FaultInjected, faults.EngineCrash, tkv.PoolExhausted)))
        theirs.append(_consult(ref, site, int(a), (
            jfaults.FaultInjected, jfaults.EngineCrash, jkv.PoolExhausted)))
    assert mine == theirs
    assert dict(ours.calls) == dict(ref.calls)
    assert dict(ours.fired) == dict(ref.fired)
    # every site ran a few hundred times... well, ~100; and most fired
    assert min(ours.calls[s] for s in ("pool.alloc", "decode", "prefill",
                                       "engine.step")) >= 50
    assert len(ours.fired) >= 15
    assert not isinstance(faults.EngineCrash("x"), faults.FaultInjected)


def test_pool_alloc_fault_fires_before_bookkeeping():
    pool = tkv.PagedKVPool(num_layers=1, num_kv_heads=1, head_dim=4,
                           num_blocks=8, block_size=4, dtype=torch.float32,
                           device="cpu")
    pool.fault_plan = faults.FaultPlan(alloc_fail_calls=(2,))
    pool.alloc(2)
    free = pool.num_free
    with pytest.raises(tkv.PoolExhausted, match="injected"):
        pool.alloc(3)
    assert pool.num_free == free and pool.num_allocated == 2
    pool.alloc(3)
    assert pool.fault_plan.fired["pool.alloc"] == 1


# -- engine chaos against the JAX engine --------------------------------------

def _both(tiny, prompts, plan_kw=None, max_new=8, **kw):
    """The JAX and the port engine over ``prompts`` (FP32, greedy), each
    with its own package's plan of ``plan_kw`` (None: no plan)."""
    jm, params, tm = tiny
    out = []
    for eng_cls, plan_cls, extra in (
            (JEngine, jfaults.FaultPlan, dict(model=jm, params=params)),
            (InferenceEngine, faults.FaultPlan, dict(model=tm,
                                                     device="cpu"))):
        plan = None if plan_kw is None else plan_cls(**plan_kw)
        model = extra.pop("model")
        eng = eng_cls(model, faults=plan, **extra, **{**KW, **kw})
        rids = [eng.submit(p, max_new) for p in prompts]
        eng.run_until_complete()
        out.append((eng, rids, plan))
    return out


def _states(eng, rids):
    return [eng.result(r).state.value for r in rids]


@pytest.mark.parametrize("path", ["paged", "standard"])
def test_chaos_plan_matches_jax_engine(tiny, path):
    """One seeded plan: allocation failures (10%), a NaN decode row, a NaN
    prefill chunk and a persistent decode fault. Same terminal states as
    the JAX engine, survivors token-identical to the fault-free run."""
    # tie-free seeds under the suite's XLA flags: 8 prompts seed 14, 5
    # prompts seed 7, 3 prompts seed 5 (the tiny model's gaps run near
    # 1e-3 on most others)
    prompts = _prompts(8, seed=14)
    kw = dict(num_blocks=16, decode_path=path)
    (jref, jrids, _), (tref, trids, _) = _both(tiny, prompts, **kw)
    _tie_free(tiny[2], prompts, [tref.result(r).out_tokens for r in trids])
    plan = dict(seed=9, alloc_fail_prob=0.1, nan_logit_calls=(5,),
                nan_prefill_calls=(3,), decode_exc_calls=(15,),
                transient_exc=False)
    (jeng, jr, jplan), (teng, tr, tplan) = _both(tiny, prompts, plan, **kw)
    assert dict(tplan.fired) == dict(jplan.fired)
    assert tplan.fired["pool.alloc"] >= 1 and tplan.fired["decode"] == 1
    assert _states(teng, tr) == _states(jeng, jr)
    states = _states(teng, tr)
    assert "failed" in states and "finished" in states
    for t, j, ref in zip(tr, jr, trids):
        got = teng.result(t)
        assert got.error == jeng.result(j).error
        if got.state is RequestState.FINISHED:
            assert got.out_tokens == tref.result(ref).out_tokens
            assert got.out_tokens == list(jeng.result(j).out_tokens)
    _assert_drained(teng)


def test_chaos_whole_prompt_isolation(tiny):
    """Whole-prompt prefill: an injected prefill fault and a NaN prefill
    fail only their requests, as in the JAX engine."""
    prompts = _prompts(5, seed=7)
    kw = dict(chunked_prefill=False)
    (_, _, _), (tref, trids, _) = _both(tiny, prompts, **kw)
    _tie_free(tiny[2], prompts, [tref.result(r).out_tokens for r in trids])
    plan = dict(prefill_exc_calls=(2,), nan_prefill_calls=(4,))
    (jeng, jr, jplan), (teng, tr, tplan) = _both(tiny, prompts, plan, **kw)
    assert dict(tplan.fired) == dict(jplan.fired)
    assert _states(teng, tr) == _states(jeng, jr)
    assert _states(teng, tr).count("failed") == 2
    for t, ref in zip(tr, trids):
        if teng.result(t).state is RequestState.FINISHED:
            assert teng.result(t).out_tokens == tref.result(ref).out_tokens
    _assert_drained(teng)


@pytest.mark.parametrize("overlap", [False, True])
def test_transient_retry_is_exact_and_draws_nothing(tiny, overlap):
    """A transient decode fault is retried with the same inputs and the
    same sampling state: every stream (sampled ones too) equals the
    fault-free run's, and after every step the generator's state equals
    the fault-free engine's."""
    _, _, tm = tiny
    prompts = _prompts(4, seed=5)

    def run(plan):
        eng = InferenceEngine(tm, device="cpu", faults=plan, seed=3,
                              overlap=overlap, **KW)
        rids = [eng.submit(p, 8, temperature=0.9 if i % 2 else 0.0,
                           top_k=20) for i, p in enumerate(prompts)]
        states = []
        while eng.has_work or eng.in_flight is not None:
            eng.step()
            states.append(eng.generator.get_state().clone())
        return eng, rids, states

    ref, ref_rids, ref_states = run(None)
    plan = faults.FaultPlan(decode_exc_calls=(2, 5), transient_exc=True)
    eng, rids, states = run(plan)
    assert plan.fired["decode"] == 2 and eng.metrics.step_retries == 2
    assert [eng.result(r).out_tokens for r in rids] == \
        [ref.result(r).out_tokens for r in ref_rids]
    assert len(states) == len(ref_states)
    assert all(torch.equal(a, b) for a, b in zip(states, ref_states))
    # the retried steps show in the flight notes, nothing else does
    assert eng.stats()["step_retries"] == 2
    _assert_drained(eng)


@pytest.mark.parametrize("site", ["decode", "prefill"])
@pytest.mark.parametrize("path", ["paged", "standard"])
def test_nan_row_fails_only_its_request(tiny, site, path):
    prompts = _prompts(3, seed=5)
    (_, _, _), (tref, trids, _) = _both(tiny, prompts, decode_path=path)
    _tie_free(tiny[2], prompts, [tref.result(r).out_tokens for r in trids])
    plan = dict(nan_logit_calls=(2,)) if site == "decode" \
        else dict(nan_prefill_calls=(2,))
    (jeng, jr, _), (teng, tr, _) = _both(tiny, prompts, plan,
                                         decode_path=path)
    victim = 0 if site == "decode" else 1
    states = _states(teng, tr)
    assert states == _states(jeng, jr)
    assert states[victim] == "failed"
    assert states.count("failed") == 1
    assert "non-finite logits" in teng.result(tr[victim]).error
    for i, (t, ref) in enumerate(zip(tr, trids)):
        if i != victim:
            assert teng.result(t).out_tokens == tref.result(ref).out_tokens
    _assert_drained(teng)
    assert JState.FAILED.value == "failed"
