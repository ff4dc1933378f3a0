"""The engine's debug guards in the port: ``TNN_POOL_DEBUG`` (the pool's
partition self-check after every bookkeeping mutation), ``TNN_DEBUG_SYNC``
(the step under torch's sync-debug mode, ``serving/sync_guard.py``) and
``TNN_DEBUG_THREADS`` (``serving/ownership.py``).

- Both knobs are off by default.
- The pool's knob on both packages: the same alloc / fork / free
  sequences, then the same corruption behind the pool's back, raise
  ``ValueError`` at the same call; clean sequences (sequence-parallel
  shards and evictable reclaims included) raise nowhere and leave equal
  bookkeeping.
- A port engine under ``TNN_POOL_DEBUG=1`` with prefix sharing and
  n-gram speculation is token-exact against the knob off.
- The sync guard's wiring on the CPU, where torch has no sync-debug mode:
  the module's mode setter is replaced by a recorder and the engine
  armed. The mode is "error" around the step's build, its commit and the
  speculative dispatch and "default" inside the input put and the fetch;
  the state is counted across threads and two engines on two threads;
  a planted synchronizing put (c10's check simulated from the recorded
  mode) fails the request with a "synchroniz" error naming its line, and
  without the knob the same plant decodes token-exact.
- A CPU engine under ``TNN_DEBUG_SYNC=1`` is not armed and is
  token-exact against the knob off.
- ``TNN_DEBUG_THREADS=1`` arms ``worker_only``'s owning-thread assert
  (the JAX package's ``TestWorkerOnlyRuntime``).

The tiny model is the JAX guard tests' (``GPT2(vocab 128, max_len 64, 2
layers, d_model 32, 2 heads)`` with their engine geometry), in FP32.
"""
import importlib
import sys
import threading

import numpy as np
import pytest
import torch

from tnn_tpu.serving import kv_pool as jkv
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.serving import kv_pool as tkv
from tnn_tpu_torch.serving import sync_guard
from tnn_tpu_torch.serving.engine import InferenceEngine
from tnn_tpu_torch.serving.scheduler import RequestState

KW = dict(num_blocks=32, block_size=4, max_batch_size=4, max_seq_len=32)
POOL = dict(num_layers=2, num_kv_heads=2, head_dim=4, num_blocks=8,
            block_size=4)


@pytest.fixture(scope="module")
def tiny():
    return GPT2(vocab_size=128, max_len=64, num_layers=2, d_model=32,
                num_heads=2, policy=tdt.FP32, device="cpu", seed=0)


@pytest.fixture(autouse=True)
def fresh_guard():
    """Every test starts and ends with the guard's counts at zero."""
    def reset():
        sync_guard._guarded = sync_guard._exempt = 0
        sync_guard._mode = "default"
    reset()
    yield
    reset()


def _prompts(seed=7, lens=(5, 9, 12)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, n).astype(np.int32) for n in lens]


def _run(model, prompts=None, new=8, armed=False, **kw):
    eng = InferenceEngine(model, **{**KW, **kw}, device="cpu")
    eng._sync_armed = armed
    rids = [eng.submit(p, new) for p in (prompts or _prompts())]
    eng.run_until_complete()
    return eng, [list(eng.result(r).out_tokens) for r in rids]


@pytest.fixture(scope="module")
def baseline(tiny):
    return _run(tiny)[1]


# -- the knobs' defaults --------------------------------------------------------

def test_knobs_off_by_default(tiny, monkeypatch):
    monkeypatch.delenv("TNN_DEBUG_SYNC", raising=False)
    monkeypatch.delenv("TNN_POOL_DEBUG", raising=False)
    eng = InferenceEngine(tiny, **KW, device="cpu")
    assert eng.debug_sync is False and eng._sync_armed is False
    assert eng.pool.debug is False
    assert tkv.PagedKVPool(**POOL, device="cpu").debug is False
    assert sync_guard.mode() == "default"


# -- TNN_POOL_DEBUG on both packages ------------------------------------------

def _ops_after(corrupt):
    """A clean prefix of mutations, ``corrupt`` behind the pool's back,
    then the mutations that must raise at the first one. Returns a
    script: pool -> index of the op that raised (None: none did)."""
    def script(pool):
        a = pool.alloc(2)
        pool.free(a)
        b = pool.alloc(1)
        c = pool.alloc(2)
        pool.fork(c)
        corrupt(pool, b, c)
        ops = [lambda: pool.fork(b), lambda: pool.free(c),
               lambda: pool.alloc(1), lambda: pool.free(b)]
        for i, op in enumerate(ops):
            try:
                op()
            except ValueError:
                return i
        return None
    return script


CORRUPTIONS = {
    # the JAX test's: an allocated block also on the free list
    "allocated_on_free_list": lambda p, b, c: p._free.append(b[0]),
    "free_block_vanishes": lambda p, b, c: p._free.pop(0),
    "allocated_and_evictable": lambda p, b, c: p._evictable.__setitem__(
        c[0], None),
    "refcount_zero": lambda p, b, c: p._ref.__setitem__(c[0], 0),
    "scratch_circulates": lambda p, b, c: p._free.append(0),
}


@pytest.mark.parametrize("name", sorted(CORRUPTIONS))
def test_pool_debug_raises_at_the_same_call_as_jax(name, monkeypatch):
    monkeypatch.setenv("TNN_POOL_DEBUG", "1")
    script = _ops_after(CORRUPTIONS[name])
    jpool = jkv.PagedKVPool(**POOL)
    tpool = tkv.PagedKVPool(**POOL, device="cpu")
    assert jpool.debug and tpool.debug
    at = script(tpool)
    assert at is not None and at == script(jpool)


def test_pool_debug_silent_without_the_knob(monkeypatch):
    monkeypatch.delenv("TNN_POOL_DEBUG", raising=False)
    script = _ops_after(CORRUPTIONS["allocated_on_free_list"])
    assert script(tkv.PagedKVPool(**POOL, device="cpu")) is None


def _clean_script(pool, seed):
    """Seeded alloc / fork / free / truncate traffic with the prefix
    cache's evictable parking (every third block stays indexed), so that
    allocations reclaim: per shard under SP, one at a time inside
    ``alloc``'s shard loop."""
    rng = np.random.default_rng(seed)
    pool.evictable_filter = lambda b: b % 3 == 0
    reclaimed = []
    pool.reclaim_hook = reclaimed.extend
    tables = []
    for _ in range(60):
        op = rng.choice(4, p=[0.45, 0.15, 0.25, 0.15])
        if op == 0 or not tables:
            n = int(rng.integers(1, 5))
            if pool.can_alloc(n, start=len(tables)):
                tables.append(pool.alloc(n, start=len(tables)))
        elif op == 1:
            tables.append(pool.fork(tables[int(rng.integers(len(tables)))]))
        elif op == 2:
            pool.free(tables.pop(int(rng.integers(len(tables)))))
        else:
            i = int(rng.integers(len(tables)))
            tables[i] = pool.truncate(tables[i], int(rng.integers(
                0, len(tables[i]) * pool.block_size + 1)))
        pool.check_invariants(tables)
    return (sorted(pool._free), dict(sorted(pool._ref.items())),
            list(pool._evictable), reclaimed)


@pytest.mark.parametrize("sp", [1, 2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_debug_clean_traffic_matches_jax(sp, seed, monkeypatch):
    monkeypatch.setenv("TNN_POOL_DEBUG", "1")
    kw = dict(POOL, num_blocks=12, sp=sp)
    got = _clean_script(tkv.PagedKVPool(**kw, device="cpu"), seed)
    assert got == _clean_script(jkv.PagedKVPool(**kw), seed)
    assert got[3], "the traffic never reclaimed an evictable block"


def test_engine_pool_debug_token_exact_with_prefix_and_spec(tiny,
                                                            monkeypatch):
    """Prefix sharing (staggered: the first request publishes before the
    rest probe) and n-gram speculation on cyclic tails, knob on against
    off; the knob really checks (``check_invariants`` runs)."""
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 128, 8).astype(np.int32)
    prompts = [np.concatenate([prefix, np.tile(rng.integers(0, 128, 3), 3)
                               .astype(np.int32)]) for _ in range(4)]
    calls = []
    check = tkv.PagedKVPool.check_invariants

    def counted(self, *a, **k):
        calls.append(1)
        return check(self, *a, **k)

    monkeypatch.setattr(tkv.PagedKVPool, "check_invariants", counted)

    def run():
        eng = InferenceEngine(tiny, **KW, spec="ngram", spec_k=3,
                              device="cpu")
        rids = [eng.submit(prompts[0], 10)]
        for _ in range(2):
            eng.step()
        rids += [eng.submit(p, 10) for p in prompts[1:]]
        eng.run_until_complete()
        return eng, [list(eng.result(r).out_tokens) for r in rids]

    monkeypatch.delenv("TNN_POOL_DEBUG", raising=False)
    off_eng, off = run()
    assert not calls
    monkeypatch.setenv("TNN_POOL_DEBUG", "1")
    on_eng, on = run()
    assert on_eng.pool.debug and len(calls) > 20
    assert on == off and all(len(t) == 10 for t in on)
    on_stats, off_stats = on_eng.stats(), off_eng.stats()
    assert on_stats["prefill_tokens_saved"] > 0
    assert on_stats["spec_acceptance_rate"] > 0
    for key in ("prefill_tokens_saved", "spec_acceptance_rate",
                "model_steps", "program_steps"):
        assert on_stats[key] == off_stats[key], key


# -- TNN_DEBUG_SYNC: the guard's wiring ------------------------------------------

WATCHED = ("begin_step", "finish_step", "try_speculate", "_put_step",
           "_fetch_bundle")


class Recorder:
    """The mode setter's stand-in: each call's mode and the engine
    methods (of ``WATCHED``) on the stack, innermost first."""

    def __init__(self):
        self.calls = []

    def __call__(self, mode):
        names, f = [], sys._getframe(1)
        while f is not None:
            if f.f_code.co_name in WATCHED:
                names.append(f.f_code.co_name)
            f = f.f_back
        self.calls.append((mode, names))


def test_guard_counts_across_threads(monkeypatch):
    """"error" while a thread is inside a guarded region and none inside
    an exempt point; one thread's exempt point disarms every thread's
    region (the allowed false negative); the last exit disarms."""
    rec = Recorder()
    monkeypatch.setattr(sync_guard, "set_mode", rec)
    inside, release, done = (threading.Event() for _ in range(3))

    def other():
        with sync_guard.guarded():
            inside.set()
            release.wait(30)
        done.set()

    t = threading.Thread(target=other)
    t.start()
    assert inside.wait(30) and sync_guard.mode() == "error"
    with sync_guard.guarded():
        with sync_guard.exempt():
            assert sync_guard.mode() == "default"
        assert sync_guard.mode() == "error"
        release.set()
        assert done.wait(30)
        assert sync_guard.mode() == "error"      # this thread still inside
    t.join(30)
    assert sync_guard.mode() == "default"
    assert [m for m, _ in rec.calls] == ["error", "default", "error",
                                         "default"]
    with sync_guard.exempt():                   # outside any region
        assert sync_guard.mode() == "default"
    assert len(rec.calls) == 4


def test_guard_converts_only_the_sync_error(monkeypatch):
    monkeypatch.setattr(sync_guard, "set_mode", Recorder())
    with pytest.raises(ValueError):
        with sync_guard.guarded():
            raise ValueError("called a synchronizing CUDA operation")
    with pytest.raises(RuntimeError) as e:
        with sync_guard.guarded():
            raise RuntimeError("something else")
    assert not isinstance(e.value, sync_guard.SyncTripped)
    with pytest.raises(sync_guard.SyncTripped, match="synchroniz"):
        with sync_guard.guarded():
            raise RuntimeError(sync_guard.SYNC_ERROR)
    assert sync_guard._guarded == 0 and sync_guard.mode() == "default"


def test_engine_guard_wiring(tiny, baseline, monkeypatch):
    """Armed around build, commit and speculate; disarmed inside put and
    fetch. The overlapped loop's decode stretch speculates."""
    rec = Recorder()
    monkeypatch.setattr(sync_guard, "set_mode", rec)
    seen = {}
    for name in ("_build_step", "_commit_step", "_decode_launch"):
        orig = getattr(InferenceEngine, name)

        def spy(self, *a, _orig=orig, _name=name, **k):
            seen.setdefault(_name, set()).add(sync_guard.mode())
            return _orig(self, *a, **k)
        monkeypatch.setattr(InferenceEngine, name, spy)
    eng, got = _run(tiny, armed=True, overlap=True)
    assert got == baseline
    assert eng.metrics.overlap_adopted > 0
    assert seen == {"_build_step": {"error"}, "_commit_step": {"error"},
                    "_decode_launch": {"error"}}
    arms = {names[0] for mode, names in rec.calls if mode == "error"
            and names and names[0] in ("begin_step", "finish_step",
                                       "try_speculate")}
    assert arms == {"begin_step", "finish_step", "try_speculate"}
    exempts = {names[0] for mode, names in rec.calls
               if mode == "default" and names
               and names[0] in ("_put_step", "_fetch_bundle")}
    assert exempts == {"_put_step", "_fetch_bundle"}
    # every exempt point sits inside a guarded step: the mode comes back
    modes = [m for m, _ in rec.calls]
    assert all(a != b for a, b in zip(modes, modes[1:]))
    assert modes[-1] == "default" and sync_guard._guarded == 0


def test_engine_guard_two_engines_two_threads(tiny, baseline, monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(sync_guard, "set_mode", rec)
    out = {}

    def drive(i):
        out[i] = _run(tiny, armed=True, overlap=bool(i))[1]

    threads = [threading.Thread(target=drive, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert out == {0: baseline, 1: baseline}
    assert sync_guard._guarded == sync_guard._exempt == 0
    assert sync_guard.mode() == "default" and rec.calls


def _fake_sync():
    """c10's check in "error" mode, from the mode the guard set: what a
    blocking copy from pageable memory runs into on a card."""
    if sync_guard.mode() == "error":
        raise RuntimeError(sync_guard.SYNC_ERROR)


def _planted_put(self, arrays, tables=None):
    arrays = list(arrays) + ([tables] if tables is not None else [])
    _fake_sync()
    return [torch.from_numpy(a).to(self.device) for a in arrays]


def test_planted_sync_fails_the_request(tiny, monkeypatch):
    monkeypatch.setattr(sync_guard, "set_mode", Recorder())
    put = InferenceEngine._put_step
    monkeypatch.setattr(InferenceEngine, "_put_step", _planted_put)
    eng = InferenceEngine(tiny, **KW, device="cpu")
    eng._sync_armed = True
    rid = eng.submit(np.arange(5, dtype=np.int32), 4)
    eng.run_until_complete()
    res = eng.result(rid)
    assert res.state is RequestState.FAILED
    assert "synchroniz" in res.error.lower()
    assert "_fake_sync" in res.error     # the trip names its line
    eng.check_invariants()
    assert eng.pool.num_allocated == 0
    # the engine serves on: an unplanted request afterwards decodes
    monkeypatch.setattr(InferenceEngine, "_put_step", put)
    rid = eng.submit(np.arange(5, dtype=np.int32), 4)
    eng.run_until_complete()
    assert eng.result(rid).state is RequestState.FINISHED


def test_planted_sync_harmless_without_the_guard(tiny, baseline,
                                                 monkeypatch):
    monkeypatch.setattr(InferenceEngine, "_put_step", _planted_put)
    assert _run(tiny)[1] == baseline


def test_cpu_engine_under_debug_sync_token_exact(tiny, baseline,
                                                 monkeypatch):
    monkeypatch.setenv("TNN_DEBUG_SYNC", "1")
    eng, got = _run(tiny)
    assert eng.debug_sync is True and eng._sync_armed is False
    assert got == baseline
    eng, got = _run(tiny, spec="ngram", spec_k=3, overlap=True)
    assert got == baseline


# -- TNN_DEBUG_THREADS -----------------------------------------------------------

class TestWorkerOnlyRuntime:
    """TNN_DEBUG_THREADS=1 arms ``worker_only``'s owning-thread assert."""

    def test_assert_fires_only_cross_thread(self, monkeypatch):
        from tnn_tpu_torch.serving import ownership

        monkeypatch.setenv("TNN_DEBUG_THREADS", "1")
        mod = importlib.reload(ownership)  # the knob is read at import
        try:
            class Owner:
                _thread = None

                @mod.worker_only
                def poke(self):
                    return 1

            o = Owner()
            assert o.poke() == 1                  # no worker: caller owns
            o._thread = threading.current_thread()
            assert o.poke() == 1                  # on the owning thread
            o._thread = threading.Thread(name="worker-0")
            with pytest.raises(AssertionError, match="owned by"):
                o.poke()
            assert Owner.poke._worker_only
        finally:
            monkeypatch.delenv("TNN_DEBUG_THREADS")
            importlib.reload(mod)

    def test_unarmed_marker_only(self, monkeypatch):
        from tnn_tpu_torch.serving import ownership

        monkeypatch.delenv("TNN_DEBUG_THREADS", raising=False)
        mod = importlib.reload(ownership)

        def poke(self):
            return 1

        assert mod.worker_only(poke) is poke and poke._worker_only
