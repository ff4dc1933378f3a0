"""Port parity: tensor-parallel serving (``InferenceEngine(tp=N)``),
mirroring ``tests/test_tp_serving.py``.

TP splits attention heads, the MLP's columns and the pool's KV heads over
shards; every shard holds every block, and two all-reduces a layer
rebuild the residual stream. On the CPU the shards are copies of the
"cpu" device, the counterpart of the JAX suite's virtual devices.

The gate is token-exactness of greedy streams under FP32: the port at
tp=2 (and tp=4 on a GQA model) against the port at tp=1 and the JAX
engine at tp=1 on the paged, standard and whole-prompt paths, and
against the JAX engine at tp=2 (on the suite's 8 virtual CPU devices) in
the scenarios where the JAX suite's own tp=2 gate passes: the full
composition (int8 pool + ngram drafts + prefix cache + the overlapped
loop), preemption, sampled rows, a supervisor crash and the chaos gate.
JAX's tp=2 paged path on the staggered scenario is left out: its own
test fails there (ROADMAP.md section 3).

Tie-free seeds, each checked under the suite's XLA flags (every emitted
greedy token beats the runner-up by more than 1e-3 in the port's FP32
logits): staggered seed 11, the GQA model seed 3, the composition seed
18 (int8 pool), preemption seed 20, the crash seed 32, the chaos seed 18.
"""
import jax
import numpy as np
import pytest
import torch

from tnn_tpu.core import dtypes as jdt
from tnn_tpu.models.gpt2 import GPT2 as JGPT2
from tnn_tpu.serving import EngineSupervisor as JSupervisor
from tnn_tpu.serving import InferenceEngine as JEngine
from tnn_tpu.serving import faults as jfaults
from tnn_tpu.serving import tp as jtp
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.ops.paged_attention import QuantPages
from tnn_tpu_torch.profiling.profiler import Profiler
from tnn_tpu_torch.serving import faults, tp as tp_mod
from tnn_tpu_torch.serving.engine import InferenceEngine
from tnn_tpu_torch.serving.kv_pool import PagedKVPool
from tnn_tpu_torch.serving.scheduler import TERMINAL_STATES, RequestState
from tnn_tpu_torch.serving.supervisor import EngineSupervisor

TINY = dict(vocab_size=128, max_len=64, num_layers=2, d_model=32,
            num_heads=2)
GQA = dict(vocab_size=128, max_len=64, num_layers=2, d_model=64,
           num_heads=8, num_kv_heads=4)
KW = dict(num_blocks=32, block_size=4, max_batch_size=4, max_seq_len=32)
MARGIN = 1e-3


def _models(cfg):
    jm = JGPT2(**cfg, policy=jdt.FP32)
    params = jm.init(jax.random.PRNGKey(0), (1, 8))["params"]
    tm = GPT2(**cfg, policy=tdt.FP32, device="cpu", seed=None)
    tm.load_jax_params(jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.fixture(scope="module")
def tiny():
    return _models(TINY)


@pytest.fixture(scope="module")
def gqa():
    return _models(GQA)


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, int(n_)).astype(np.int32)
            for n_ in rng.integers(5, 14, n)]


def _serve(eng, prompts, max_new=8, stagger=0):
    rids = []
    for i, p in enumerate(prompts):
        rids.append(eng.submit(p, max_new))
        if stagger and i % stagger == stagger - 1:
            eng.step()
    out = eng.run_until_complete()
    return [list(out[r]) for r in rids]


def _port(tm, **kw):
    return InferenceEngine(tm, device="cpu", **{**KW, **kw})


def _jax(jm, params, **kw):
    return JEngine(jm, params, **{**KW, **kw})


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
    assert not eng.has_work and eng.pool.num_allocated == 0
    assert eng.pool.num_free + eng.pool.num_evictable == eng.pool.capacity
    eng.check_invariants()


def _shard_heads(eng):
    """Each shard's page tensor's head count, in shard order."""
    return [(p.data if isinstance(p, QuantPages) else p).shape[2]
            for p in eng.pool.pages_k]


# -- refusals -----------------------------------------------------------------

def test_refusals_match_jax(tiny):
    """What the JAX engine refuses at tp > 1, with its conditions; auto
    falls back from the fused path, as there."""
    _, _, tm = tiny
    odd = GPT2(vocab_size=128, max_len=64, num_layers=1, d_model=48,
               num_heads=3, device="cpu", seed=0)
    with pytest.raises(ValueError, match="divisible"):
        _port(odd, tp=2)
    with pytest.raises(ValueError, match="devices"):
        _port(tm, tp=2, tp_devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="quant"):
        _port(tm, tp=2, quant_weights=True)
    with pytest.raises(ValueError, match="host_tier_bytes with tp>1"):
        _port(tm, tp=2, host_tier_bytes=1 << 20)
    with pytest.raises(ValueError, match="sp>1 with tp>1"):
        _port(tm, tp=2, sp=2)
    with pytest.raises(ValueError, match="tp must be >= 1"):
        _port(tm, tp=0)
    moe = GPT2(**TINY, moe_experts=2, device="cpu", seed=0)
    with pytest.raises(ValueError, match="MoE"):
        _port(moe, tp=2)
    with pytest.raises(ValueError, match="MoE"):
        _port(moe, sp=2)
    with pytest.raises(ValueError, match="fused"):
        _port(tm, tp=2, decode_path="fused")
    eng = _port(tm, tp=2, decode_path="standard")
    assert eng._fused is None and eng.stats()["decode_path"] == "standard"
    auto = _port(tm, tp=2, decode_path="auto")
    assert auto.stats()["decode_path"] == "paged"


@pytest.mark.parametrize("argv,message", [
    (["--tp", "3"], "does not divide the model's 2 KV head(s)"),
    (["--tp", "2", "--quant-weights"], "--quant-weights is incompatible"),
    (["--tp", "2", "--decode-path", "fused"], "--decode-path fused"),
    (["--tp", "2", "--sp", "2"], "pick ONE of --sp / --tp"),
    (["--tp", "2", "--host-tier-bytes", "1024"], "incompatible with --tp"),
    (["--tp", "2", "--tp-devices", "cpu"], "names 1 device"),
])
def test_cli_preflight(argv, message, capsys):
    """The front end dies with the JAX front end's one-liner before it
    builds a weight."""
    from tnn_tpu_torch.cli import serve as serve_cli

    with pytest.raises(SystemExit):
        serve_cli.main(["--device", "cpu", "--model", "gpt2_tiny", *argv])
    assert message in capsys.readouterr().err


# -- the weight split ---------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
def test_qkv_permutation_and_slices_match_jax(gqa, tp):
    """``_permute_qkv`` equals the JAX package's, and every shard's slice
    of every split leaf is the JAX layout's chunk under its spec."""
    jm, params, tm = gqa
    dh = jm.d_model // jm.num_heads
    w = np.random.default_rng(0).normal(size=(64, 64 + 2 * 32))
    want = jtp._permute_qkv(w, 8, 4, dh, tp)
    got = tp_mod._permute_qkv(torch.from_numpy(w), 8, 4, dh, tp).numpy()
    assert np.array_equal(got, want)
    ctx = tp_mod.TPContext(tm, tp, devices=["cpu"] * tp)
    for path, leaf in tm.jax_param_paths():
        spec = jtp._spec_for(path, None)
        ours = tp_mod._spec_for(path)
        assert ours == ({(None, "model"): "columns", ("model",): "columns",
                         ("model", None): "rows"}.get(tuple(spec)))
        if ours is None:
            continue
        ref = leaf.detach().numpy()
        if path[-1] in ("qkv_kernel", "qkv_bias"):
            ref = jtp._permute_qkv(ref, 8, 4, dh, tp)
        parts = np.split(ref, tp, axis=-1 if ours == "columns" else 0)
        layer = int(path[0][1:])
        for s in range(tp):
            shard = ctx.model.blocks[layer].weights[s]["/".join(path[1:])]
            assert np.array_equal(shard.numpy(), parts[s])


def test_all_reduce_runs_twice_a_layer(tiny, monkeypatch):
    """Exactly 2 x num_layers sums a dispatched program, in shard order."""
    _, _, tm = tiny
    calls = []
    real = tp_mod.all_reduce

    def counting(parts, device):
        calls.append(len(parts))
        return real(parts, device)

    monkeypatch.setattr(tp_mod, "all_reduce", counting)
    eng = _port(tm, tp=2)
    _serve(eng, _prompts(2, seed=11), max_new=4)
    dispatches = sum(eng.stats()["program_steps"].values())
    assert len(calls) == 2 * tm.num_layers * dispatches
    assert set(calls) == {2}


# -- exactness: tp=2 == tp=1 == the JAX engine at tp=1 ------------------------

@pytest.mark.parametrize("path", ["paged", "standard", "whole_prompt"])
def test_staggered_parity(tiny, path):
    jm, params, tm = tiny
    prompts = _prompts(4, seed=11)
    kw = dict(chunked_prefill=False) if path == "whole_prompt" \
        else dict(decode_path=path)
    base = _serve(_port(tm, **kw), prompts, stagger=2)
    eng = _port(tm, tp=2, **kw)
    sharded = _serve(eng, prompts, stagger=2)
    want = _serve(_jax(jm, params, **kw), prompts, stagger=2)
    assert sharded == base == want
    _tie_free(tm, prompts, sharded)
    steps = eng.stats()["program_steps"]
    assert ("prefill" in steps) == (path == "whole_prompt")
    assert eng.stats()["tp_degree"] == 2
    assert _shard_heads(eng) == [1, 1]
    _assert_drained(eng)


@pytest.mark.parametrize("path", ["paged", "standard"])
def test_gqa_tp4_parity(gqa, path):
    """A GQA model (8 query, 4 KV heads) at tp=2 and tp=4: one KV head and
    two query heads a shard at tp=4."""
    jm, params, tm = gqa
    prompts = _prompts(4, seed=3)
    base = _serve(_port(tm, decode_path=path), prompts, stagger=2)
    want = _serve(_jax(jm, params, decode_path=path), prompts, stagger=2)
    assert base == want
    _tie_free(tm, prompts, base)
    for tp in (2, 4):
        eng = _port(tm, tp=tp, decode_path=path)
        assert _serve(eng, prompts, stagger=2) == base
        assert _shard_heads(eng) == [4 // tp] * tp
        assert eng.stats()["kv_bytes_per_token_per_shard"] * tp == \
            eng.pool.kv_bytes_per_token
        _assert_drained(eng)


# -- against the JAX engine at tp=2 -------------------------------------------

def test_full_composition_matches_jax_tp2(tiny):
    """int8 pool + ngram drafts + prefix cache + the overlapped loop on the
    paged path: the port at tp=2 equals itself at tp=1 and the JAX engine
    at tp=2."""
    jm, params, tm = tiny
    prompts = _prompts(4, seed=18)
    prompts.append(prompts[0])          # a repeat: the prefix cache hits
    kw = dict(decode_path="paged", kv_dtype="int8", spec="ngram",
              prefix_cache=True, overlap=True)
    # staggered, so that the repeat finds its first copy published
    base = _serve(_port(tm, **kw), prompts, stagger=2)
    eng = _port(tm, tp=2, **kw)
    sharded = _serve(eng, prompts, stagger=2)
    jeng = _jax(jm, params, tp=2, **kw)
    assert sharded == base == _serve(jeng, prompts, stagger=2)
    assert eng.stats()["prefill_tokens_saved"] == \
        jeng.stats()["prefill_tokens_saved"] > 0
    assert all(isinstance(p, QuantPages) for p in eng.pool.pages_k)
    _assert_drained(eng)


def test_preemption_matches_jax_tp2(tiny):
    jm, params, tm = tiny
    prompts = _prompts(4, seed=20)
    kw = dict(num_blocks=9, decode_path="paged", prefix_cache=False)
    base = _serve(_port(tm, **kw), prompts, max_new=10)
    eng = _port(tm, tp=2, **kw)
    sharded = _serve(eng, prompts, max_new=10)
    jeng = _jax(jm, params, tp=2, **kw)
    assert sharded == base == _serve(jeng, prompts, max_new=10)
    assert eng.metrics.preemptions == jeng.metrics.preemptions > 0
    _tie_free(tm, prompts, sharded)
    _assert_drained(eng)


def test_sampled_rows(tiny):
    """A greedy and a sampled row together: the sampled row draws at tp=2
    what it draws at tp=1 (one generator, replicated math), and the greedy
    row equals the JAX engine's at tp=2."""
    jm, params, tm = tiny
    p = np.arange(6, dtype=np.int32)

    def run(eng):
        g = eng.submit(p, 8)
        s = eng.submit(p, 8, temperature=0.9, top_k=16, top_p=0.9)
        out = eng.run_until_complete()
        return out[g], out[s]

    g1, s1 = run(InferenceEngine(tm, device="cpu", seed=3, **KW))
    g2, s2 = run(InferenceEngine(tm, device="cpu", seed=3, tp=2, **KW))
    jg, _ = run(JEngine(jm, params, seed=3, tp=2, **KW))
    assert g2 == g1 == list(jg)
    assert s2 == s1
    _tie_free(tm, [p], [g2])


def test_supervisor_crash_purges_every_shard(tiny, monkeypatch):
    """A mid-run crash at tp=2: the restart zeroes every shard's pages,
    and the migrated streams equal the JAX supervisor's at tp=2."""
    jm, params, tm = tiny
    prompts = _prompts(4, seed=32)
    kw = dict(decode_path="paged", max_batch_size=2)
    zeroed = []
    real = PagedKVPool.reset_pages

    def checked(pool):
        real(pool)
        zeroed.append([bool((t == 0).all()) for t in pool.pages_k
                       + pool.pages_v])

    monkeypatch.setattr(PagedKVPool, "reset_pages", checked)

    def run(eng, sup_cls):
        events = []
        sup = sup_cls(eng, event_sink=events.append, restart_backoff_s=0.0,
                      max_restarts=2)
        rids = [sup.submit(q, 5) for q in prompts]
        sup.run_sync()
        term = {e["id"]: e for e in events if e["event"] != "token"}
        assert sup.restarts == 1
        return [list(term[r]["tokens"]) for r in rids]

    eng = _port(tm, tp=2, faults=faults.FaultPlan(step_crash_calls=(2,)),
                **kw)
    got = run(eng, EngineSupervisor)
    want = run(_jax(jm, params, tp=2, **kw,
                    faults=jfaults.FaultPlan(step_crash_calls=(2,))),
               JSupervisor)
    assert got == want
    assert zeroed == [[True] * 4]
    _tie_free(tm, prompts, got)
    _assert_drained(eng)


def test_chaos_gate_per_shard(tiny):
    """Allocation faults and a NaN row at tp=2: the same plan fires what
    it fires in the JAX engine at tp=2, every request ends in the same
    state, survivors equal the fault-free run, no shard leaks a block."""
    jm, params, tm = tiny
    prompts = _prompts(8, seed=18)
    kw = dict(num_blocks=16, decode_path="paged", tp=2, prefix_cache=False)
    ref = _port(tm, **kw)
    ref_out = _serve(ref, prompts)
    plan = dict(seed=9, alloc_fail_prob=0.12, nan_logit_calls=(5,))
    eng = _port(tm, faults=faults.FaultPlan(**plan), **kw)
    jeng = _jax(jm, params, faults=jfaults.FaultPlan(**plan), **kw)
    rids = [eng.submit(p, 8) for p in prompts]
    jrids = [jeng.submit(p, 8) for p in prompts]
    eng.run_until_complete()
    jeng.run_until_complete()
    assert eng.faults.fired["pool.alloc"] >= 1
    assert dict(eng.faults.fired) == dict(jeng.faults.fired)
    states = [eng.result(r).state.value for r in rids]
    assert states == [jeng.result(r).state.value for r in jrids]
    assert "finished" in states and "failed" in states
    for rid, jrid, want in zip(rids, jrids, ref_out):
        if eng.result(rid).state is RequestState.FINISHED:
            assert eng.result(rid).out_tokens == want == \
                list(jeng.result(jrid).out_tokens)
    _assert_drained(eng)


# -- observability ------------------------------------------------------------

def test_gauges_stats_and_exposition_match_jax(tiny):
    from tnn_tpu_torch.serving.metrics import render_prometheus

    jm, params, tm = tiny
    prompts = _prompts(2, seed=11)
    kw = dict(kv_dtype="int8", decode_path="paged", tp=2)
    eng, jeng = _port(tm, **kw), _jax(jm, params, **kw)
    _serve(eng, prompts)
    _serve(jeng, prompts)
    ts, js = eng.stats(), jeng.stats()
    for key in ("tp_degree", "kv_bytes_per_token_per_shard",
                "kv_bytes_per_token", "kv_scale_bytes_per_token",
                "compiled_step_signatures"):
        assert ts[key] == js[key], key
    assert ts["kv_bytes_per_token_per_shard"] == \
        (eng.pool.kv_bytes_per_token
         + eng.pool.kv_scale_bytes_per_token) // 2
    for key in ("tp_degree", "kv_bytes_per_token_per_shard"):
        assert eng._health_gauges[key] == jeng._health_gauges[key]
    fams = {f["name"]: f for f in eng.metrics.prometheus_series()}
    jfams = {f["name"]: f for f in jeng.metrics.prometheus_series()}
    assert set(fams) == set(jfams)
    assert fams["tnn_serve_tp_degree"]["samples"][0][-1] == 2.0
    assert "tnn_serve_tp_degree 2" in render_prometheus(
        eng.metrics.prometheus_series())
    assert eng.metrics.summary()["tp_degree"] == 2
    record = eng.last_finished_record()
    assert all(p["compile_key"][-2:] == ["int8", "tp2"]
               for p in record["programs"])


def test_allreduce_span_per_dispatch(tiny):
    _, _, tm = tiny
    prof = Profiler(source="tp-test")
    eng = _port(tm, tp=2, profiler=prof, trace=True,
                chunked_prefill=False)
    _serve(eng, _prompts(2, seed=11))
    spans = [e.name for e in prof.events
             if e.name.startswith("serve.allreduce")]
    assert len(spans) == sum(eng.stats()["program_steps"].values())
    assert set(spans) == {f"serve.allreduce tp=2 count="
                          f"{2 * tm.num_layers}"}


# -- the pool: per-shard pages, copy-on-write, handoff ------------------------

@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_export_from_tp2_equals_tp1_and_adopts(tiny, kv_dtype):
    """The wire format of tp=2 is tp=1's: a tp=2 engine adopts a tp=1
    export (splitting the head axis) and exports it back byte for byte
    (joining it); what tp=2 exports of its own prefill has tp=1's keys,
    shapes and dtypes, and its values but for the all-reduce's ulps.
    The adopting engine's resumed stream is token-exact."""
    _, _, tm = tiny
    prompt = _prompts(1, seed=11)[0]
    seq = np.concatenate([prompt, prompt]).astype(np.int32)
    one, two = (_port(tm, tp=n, kv_dtype=kv_dtype) for n in (1, 2))
    for eng in (one, two):
        _serve(eng, [seq], max_new=2)
    ex1, ex2 = one.export_prefix(seq), two.export_prefix(seq)
    assert len(ex1) == len(ex2) == len(seq) // 4
    for a, b in zip(ex1, ex2):
        assert a[0] == b[0] and len(a[1]) == len(b[1])
        for x, y in zip(a[1], b[1]):
            assert x.shape == y.shape and x.dtype == y.dtype
            if x.dtype == np.int8:
                assert np.abs(x.astype(int) - y.astype(int)).max() <= 1
            else:
                assert np.allclose(x, y, rtol=1e-5, atol=1e-6)
    fresh = _port(tm, tp=2, kv_dtype=kv_dtype)
    assert fresh.adopt_prefix(ex1) == len(ex1)
    back = fresh.export_prefix(seq)
    assert [(e[0], e[2]) for e in back] == [(e[0], e[2]) for e in ex1]
    assert [[x.tobytes() for x in e[1]] for e in back] \
        == [[x.tobytes() for x in e[1]] for e in ex1]
    want = _serve(_port(tm, kv_dtype=kv_dtype, prefix_cache=False), [seq])
    assert _serve(fresh, [seq]) == want
    assert fresh.stats()["prefill_tokens_saved"] > 0
    _assert_drained(fresh)


def test_copy_on_write_on_every_shard(tiny):
    """A full-cover prefix hit clones its last block on every shard's
    heads: the streams equal tp=1's, which equal the cache-off run's."""
    _, _, tm = tiny
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, 128, 12).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, 128, 5)])
               for _ in range(2)] + [prefix]

    def run(**kw):
        eng = _port(tm, **kw)
        rids = [eng.submit(prompts[0], 8)]
        eng.step()
        eng.step()                     # the publisher first
        rids += [eng.submit(p, 8) for p in prompts[1:]]
        eng.run_until_complete()
        return eng, [eng.result(r).out_tokens for r in rids]

    eng, got = run(tp=2)
    assert eng.stats()["prefix_cows"] == 1
    assert got == run()[1] == run(prefix_cache=False)[1]
    _tie_free(tm, prompts, got)
    _assert_drained(eng)
