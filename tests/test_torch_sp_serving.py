"""Port parity: sequence-parallel serving (``InferenceEngine(sp=N)``),
mirroring ``tests/test_sp_serving.py``.

SP splits the pool's blocks over shards; a request's table positions take
their blocks round-robin, every shard sweeps its own pages with the paged
kernel's stats form, and the partials merge once per layer. On the CPU
the shards are copies of the "cpu" device, the counterpart of the JAX
suite's virtual devices.

The gate is token-exactness of greedy streams under FP32 on the tiny GPT-2
(``prefix_cache=False``): the port at sp=2 against the port at sp=1 and
against the JAX engine at sp=2 (on the suite's 8 virtual CPU devices), on
the paged and standard paths, both pool dtypes, staggered admission and
through preemption. The seeds are checked free of near-ties: every
emitted greedy token beats the runner-up logit by more than 1e-3 in the
port's own logits at sp=2 (summation order moves an f32 logit by about
1e-6; the JAX suite's seed 7 has a gap of 4.9e-4 and is not used). Then
the capability gate: a prompt whose KV exceeds one shard's pool is refused
at sp=1 and serves at sp=2.
"""
import jax
import numpy as np
import pytest
import torch

from tnn_tpu.core import dtypes as jdt
from tnn_tpu.models.gpt2 import GPT2 as JGPT2
from tnn_tpu.serving import InferenceEngine as JEngine
from tnn_tpu.serving.step_build import shard_tables as jshard_tables
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.models.gpt2 import GPT2, generate
from tnn_tpu_torch.ops.paged_attention import QuantPages
from tnn_tpu_torch.serving import kv_pool, sp as sp_mod
from tnn_tpu_torch.serving.engine import InferenceEngine
from tnn_tpu_torch.serving.kv_pool import PagedKVPool, PoolExhausted
from tnn_tpu_torch.serving.scheduler import RequestState
from tnn_tpu_torch.serving.step_build import shard_tables

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


def _prompts(n=4, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, int(n_)).astype(np.int32)
            for n_ in rng.integers(5, 14, n)]


class GapEngine(InferenceEngine):
    """Keeps every emitted greedy token's top-2 logit gap."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.gaps = []

    def _build(self, chunks, events):
        rec = super()._build(chunks, events)
        if rec is not None:
            self._rows = [r.rid for r in rec.get("rows", rec.get("live"))]
        return rec

    def _sample(self, logits, step):
        self._logits = logits.float()
        return super()._sample(logits, step)

    def step(self):
        events = super().step()
        for rid, tok in events["tokens"]:
            if self.requests[rid].temperature <= 0:
                row = self._logits[self._rows.index(rid)]
                top2 = row.topk(2).values
                assert int(row.argmax()) == tok
                self.gaps.append(float(top2[0] - top2[1]))
        return events


def _serve(eng, prompts, max_new=8, stagger=0):
    rids = []
    for i, p in enumerate(prompts):
        rids.append(eng.submit(p, max_new))
        if stagger and i % stagger == stagger - 1:
            eng.step()
    out = eng.run_until_complete()
    return [list(out[r]) for r in rids]


def _port(tm, **kw):
    merged = dict(KW)
    merged.update(kw)
    return GapEngine(tm, device="cpu", **merged)


def _jax(jm, params, **kw):
    merged = dict(KW)
    merged.update(kw)
    return JEngine(jm, params, prefix_cache=False, **merged)


def _assert_drained(eng):
    assert all(r.state in (RequestState.FINISHED, RequestState.FAILED)
               for r in eng.requests.values())
    assert not eng.has_work and eng.pool.num_allocated == 0
    assert eng.pool.num_allocatable == eng.pool.capacity
    eng.check_invariants()


# -- pool: round-robin placement and bottleneck capacity ----------------------

def _pool(sp=2, num_blocks=16, **kw):
    return PagedKVPool(num_layers=1, num_kv_heads=1, head_dim=4,
                       num_blocks=num_blocks, block_size=4, device="cpu",
                       sp=sp, **kw)


def test_round_robin_ownership_and_page_layout():
    pool = _pool()
    blocks = pool.alloc(6)
    assert [pool.owner(g) for g in blocks] == [0, 1, 0, 1, 0, 1]
    # one contiguous (L, N / sp, ...) tensor per shard
    assert len(pool.pages_k) == 2 and len(pool.shard_pages()) == 2
    for p in pool.pages_k + pool.pages_v:
        assert p.shape == (1, 8, 1, 4, 4) and p.is_contiguous()
    pool.check_invariants([blocks], [24])
    pool.free(blocks)
    pool.check_invariants()
    q = _pool(kv_dtype="int8")
    assert all(isinstance(p, QuantPages) and p.data.shape == (1, 8, 1, 4, 4)
               for p in q.pages_k)
    assert not isinstance(_pool(sp=1).pages_k, list)


def test_alloc_matches_jax_pool_block_for_block():
    from tnn_tpu.serving.kv_pool import PagedKVPool as JPool

    pools = [_pool(), JPool(num_layers=1, num_kv_heads=1, head_dim=4,
                            num_blocks=16, block_size=4, sp=2)]
    script = [(3, 0), (2, 3), (1, 0), (4, 1)]
    got = [[p.alloc(n, start=s) for n, s in script] for p in pools]
    assert got[0] == got[1]
    for p in pools:
        p.free(got[0][1])
    again = [p.alloc(3, start=1) for p in pools]
    assert again[0] == again[1]
    assert pools[0].num_allocatable == pools[1].num_allocatable


def test_num_allocatable_is_bottleneck():
    pool = _pool()
    assert pool.capacity == 14              # 16 - one scratch per shard
    held = pool.alloc(4, start=0)           # balanced: 2 + 2
    assert pool.num_allocatable == 10
    skew = [pool.alloc(1, start=0)[0] for _ in range(3)]   # shard 0 only
    assert all(pool.owner(g) == 0 for g in skew)
    assert pool.num_allocatable == 4        # shard 0 has 2 free, 1 has 5
    assert pool.can_alloc(2, start=1) and not pool.can_alloc(5, start=0)
    pool.free(held + skew)
    assert pool.num_allocatable == pool.capacity


def test_exhaustion_names_the_shard_and_validation():
    pool = _pool(num_blocks=4)              # one usable block per shard
    pool.alloc(1, start=0)
    with pytest.raises(PoolExhausted, match="shard 0"):
        pool.alloc(1, start=0)
    assert pool.alloc(1, start=1)           # shard 1 still has its block
    with pytest.raises(ValueError, match="divide"):
        _pool(num_blocks=17)
    with pytest.raises(ValueError, match="per shard"):
        _pool(sp=4, num_blocks=4)
    with pytest.raises(ValueError, match="sp must"):
        _pool(sp=0)


def test_check_invariants_catches_a_scratch_block_in_circulation():
    pool = _pool()
    pool._free.append(8)                    # shard 1's scratch page
    with pytest.raises(ValueError, match="scratch"):
        pool.check_invariants()


def test_shard_tables_by_id_range_match_jax():
    tables = np.array([[0, 9, 3, 12]], np.int32)    # blocks_per_shard=8
    out = shard_tables(tables, 2, 8)
    assert out.shape == (2, 1, 4) and out.dtype == np.int32
    np.testing.assert_array_equal(out[0, 0], [0, -1, 3, -1])
    np.testing.assert_array_equal(out[1, 0], [-1, 1, -1, 4])
    rng = np.random.default_rng(0)
    big = rng.integers(0, 32, (3, 6)).astype(np.int32)
    for sp in (2, 4):
        np.testing.assert_array_equal(shard_tables(big, sp, 32 // sp),
                                      np.asarray(jshard_tables(big, sp,
                                                               32 // sp)))


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_sharded_gather_and_scatters_equal_one_pool(kv_dtype):
    """The assembled-cache helpers over per-shard pages and local tables
    equal the same helpers over one pool holding the shards' pages side by
    side (global id = shard * N_l + local row)."""
    pool = _pool(kv_dtype=kv_dtype, num_blocks=16)
    gen = torch.Generator().manual_seed(0)
    for p in pool.pages_k + pool.pages_v:
        if kv_dtype == "int8":
            d, s = kv_pool.quantize_kv_rows(torch.randn(p.data.shape,
                                                        generator=gen))
            p.data.copy_(d)
            p.scale.copy_(s)
        else:
            p.copy_(torch.randn(p.shape, generator=gen))

    def joined(side):
        if kv_dtype == "int8":
            return QuantPages(torch.cat([p.data for p in side], 1),
                              torch.cat([p.scale for p in side], 1))
        return torch.cat(side, 1)

    one_k, one_v = joined(pool.pages_k), joined(pool.pages_v)
    tables = np.array([pool.alloc(4), pool.alloc(3) + [0]], np.int32)
    local = [torch.from_numpy(t) for t in shard_tables(tables, 2, 8)]
    whole = torch.from_numpy(tables)
    k, v = kv_pool.gather_kv(pool.pages_k, pool.pages_v, local)
    k1, v1 = kv_pool.gather_kv(one_k, one_v, whole)
    assert torch.equal(k, k1) and torch.equal(v, v1)
    offsets = torch.tensor([13, 9], dtype=torch.int32)
    rows = torch.randn((1, 2, 1, 4), generator=gen)
    kv_pool.scatter_token(pool.pages_k, local, offsets, rows)
    kv_pool.scatter_token(one_k, whole, offsets, rows)
    starts = torch.tensor([2, 4], dtype=torch.int32)
    chunk = torch.randn((1, 2, 4, 1, 4), generator=gen)
    q_lens = torch.tensor([4, 3], dtype=torch.int32)
    kv_pool.scatter_chunk(pool.pages_v, local, starts, chunk, q_lens)
    kv_pool.scatter_chunk(one_v, whole, starts, chunk, q_lens)
    k, v = kv_pool.gather_kv(pool.pages_k, pool.pages_v, local)
    k1, v1 = kv_pool.gather_kv(one_k, one_v, whole)
    live = [16, 12]                      # each row's live positions
    for b, n in enumerate(live):
        assert torch.equal(k[:, b, :, :n], k1[:, b, :, :n])
        assert torch.equal(v[:, b, :, :n], v1[:, b, :, :n])


# -- validation ---------------------------------------------------------------

def test_sp_device_placement_rules(tiny, monkeypatch):
    _, _, tm = tiny
    ctx = sp_mod.SPContext(tm, 2)
    assert ctx.devices == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="2 devices"):
        sp_mod.SPContext(tm, 2, devices=["cpu"])
    with pytest.raises(ValueError, match="model's"):
        sp_mod.SPContext(tm, 2, devices=["meta", "cpu"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="device"):
        sp_mod.default_devices(torch.device("cuda", 0), 2)
    with pytest.raises(ValueError, match="sp must"):
        InferenceEngine(tm, device="cpu", sp=0, **KW)


def test_engine_refusals(tiny):
    _, _, tm = tiny
    with pytest.raises(ValueError, match="quant"):
        InferenceEngine(tm, device="cpu", sp=2, quant_weights=True, **KW)
    with pytest.raises(ValueError, match="divide"):
        InferenceEngine(tm, device="cpu", sp=2,
                        **{**KW, "num_blocks": 33})
    # ceil(12 / 4) = 3 blocks a row, 3 % 2 != 0
    with pytest.raises(ValueError, match="blocks_per_seq"):
        InferenceEngine(tm, device="cpu", sp=2, **{**KW, "max_seq_len": 12})
    with pytest.raises(ValueError, match="fused"):
        InferenceEngine(tm, device="cpu", sp=2, decode_path="fused", **KW)
    eng = InferenceEngine(tm, device="cpu", sp=2, decode_path="standard",
                          **KW)
    assert eng._fused is None and eng.stats()["decode_path"] == "standard"


@pytest.mark.parametrize("argv,message", [
    (["--sp", "2", "--quant-weights"], "--quant-weights is incompatible"),
    (["--sp", "2", "--decode-path", "fused"], "--decode-path fused"),
    (["--sp", "3", "--num-blocks", "64"], "does not divide evenly"),
    (["--sp", "2", "--max-seq-len", "40"], "does not divide the assembly"),
    (["--sp", "2", "--sp-devices", "cpu"], "names 1 device"),
])
def test_cli_preflight(argv, message, capsys):
    """The front end dies with a pointed one-liner before it builds a
    weight."""
    from tnn_tpu_torch.cli import serve as serve_cli

    with pytest.raises(SystemExit):
        serve_cli.main(["--device", "cpu", "--model", "gpt2_tiny",
                        "--block-size", "16", *argv])
    assert message in capsys.readouterr().err


# -- exactness: sp=2 == sp=1 == the JAX engine at sp=2 -----------------------

@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
@pytest.mark.parametrize("path", ["paged", "standard"])
def test_staggered_parity_with_jax(tiny, path, kv_dtype):
    jm, params, tm = tiny
    prompts = _prompts(4, seed=1)
    kw = dict(decode_path=path, kv_dtype=kv_dtype)
    base = _serve(_port(tm, **kw), prompts, stagger=2)
    eng = _port(tm, sp=2, **kw)
    sharded = _serve(eng, prompts, stagger=2)
    want = _serve(_jax(jm, params, sp=2, **kw), prompts, stagger=2)
    assert sharded == base == want
    assert min(eng.gaps) > MARGIN
    assert eng.stats()["sp_degree"] == 2
    assert eng.stats()["decode_path"] == path
    assert eng.stats()["pool_blocks_per_shard"] == 16
    _assert_drained(eng)


def test_preemption_parity_with_jax(tiny):
    """A starved pool preempts under SP as at sp=1 and in the JAX engine:
    the same tokens, and no shard leaks a block."""
    jm, params, tm = tiny
    prompts = _prompts(4, seed=2)
    kw = dict(num_blocks=10, decode_path="paged")
    base = _serve(_port(tm, **kw), prompts, max_new=10)
    eng = _port(tm, sp=2, **kw)
    sharded = _serve(eng, prompts, max_new=10)
    want = _serve(_jax(jm, params, sp=2, **kw), prompts, max_new=10)
    assert eng.metrics.preemptions > 0, "pool was never exhausted"
    assert sharded == base == want
    assert min(eng.gaps) > MARGIN
    _assert_drained(eng)


def test_sampled_rows_match_sp1(tiny):
    """Sampling draws from the engine's generator: the same seed gives the
    same tokens at sp=1 and sp=2 (the merged logits agree to rounding)."""
    _, _, tm = tiny
    p = np.arange(5, dtype=np.int32)

    def run(**kw):
        eng = _port(tm, seed=3, **kw)
        g = eng.submit(p, 8)
        s = eng.submit(p, 8, temperature=0.9, top_k=16, top_p=0.9)
        out = eng.run_until_complete()
        return eng, out[g], out[s]

    _, g1, s1 = run()
    eng, g2, s2 = run(sp=2)
    assert g2 == g1 and s2 == s1
    assert all(0 <= t < TINY["vocab_size"] for t in s2)
    assert min(eng.gaps) > MARGIN


# -- the capability gate: context beyond one shard's pool ---------------------

def test_long_prompt_needs_the_second_shard(tiny):
    _, _, tm = tiny
    long_p = (np.arange(40, dtype=np.int32) * 7 + 3) % 128
    per_shard = dict(num_blocks=8, block_size=4, max_batch_size=2)
    eng1 = InferenceEngine(tm, device="cpu", **per_shard)
    with pytest.raises(ValueError, match="exceeds"):
        eng1.submit(long_p, 4)
    eng2 = GapEngine(tm, device="cpu", sp=2, **{**per_shard,
                                                "num_blocks": 16})
    assert eng2.pool.blocks_per_shard == 8 and eng2.max_seq_len == 56
    r = eng2.submit(long_p, 4)
    out = eng2.run_until_complete()[r]
    ref = generate(tm, torch.from_numpy(long_p), 4,
                   max_len=eng2.assembly_len)[0].tolist()
    assert out == ref
    assert min(eng2.gaps) > MARGIN
    _assert_drained(eng2)


def test_stats_and_shard_devices(tiny):
    _, _, tm = tiny
    eng = InferenceEngine(tm, device="cpu", sp=2, sp_devices=["cpu", "cpu"],
                          **KW)
    _serve(eng, _prompts(2, seed=3))
    s = eng.stats()
    assert s["sp_degree"] == 2
    assert s["pool_blocks_per_shard"] * 2 == KW["num_blocks"]
    assert [p.device for p in eng.pool.pages_k] == [torch.device("cpu")] * 2
    assert eng.pool.devices == [torch.device("cpu")] * 2
    assert InferenceEngine(tm, device="cpu", **KW).stats()["sp_degree"] == 1
