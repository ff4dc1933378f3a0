"""Port parity: the int8 serving slice (int8 KV pool and int8 weights).

- The int8 pool: ``QuantPages`` layout, byte accounting as the JAX pool's,
  lifecycle, and the bundle audit of ``check_invariants``.
- ``paged_attention``'s plain version over ``QuantPages`` against the JAX
  package's reference and its Pallas kernel in interpret mode on the same
  int8 pages and scales: both dequantize to f32 and compute in f32, so
  they differ in summation order only: 1e-5 absolute on O(1) outputs.
- The scatters quantize at write time bit for bit as JAX's do.
- Engines under FP32 against the JAX engines (``prefix_cache=False,
  decode_path="paged"``): greedy streams token-exact with the int8 pool on
  the tiny model, and with int8 weights on a 2L/256d model whose 64-token
  chunks make the mixed steps' matmuls take the weight-only int8 kernel
  (8 rows x 64 > 256). The seeds are checked free of near-ties in the
  port engine's own logits: every emitted greedy token beats the runner-up
  by more than 1e-3. Summation order moves an f32 logit by about 1e-6, and
  one activation element that rounds to the other int8 neighbour in w8a8
  moves a logit by about 1e-4 on these models.
- A mixed step whose head runs on the B last rows takes the branch of
  JAX's head over all B*Q positions: equal to its full logits at 1e-5.
"""
import json
import math
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnn_tpu.core import dtypes as jdt
from tnn_tpu.models.gpt2 import GPT2 as JGPT2
from tnn_tpu.nn import quant as jquant
from tnn_tpu.ops.pallas import paged_attention as jpa
from tnn_tpu.serving import InferenceEngine as JEngine
from tnn_tpu.serving import PagedKVPool as JPool
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.nn import quant as tquant
from tnn_tpu_torch.ops import paged_attention as tpa
from tnn_tpu_torch.ops import quant_matmul as tqm
from tnn_tpu_torch.serving.engine import InferenceEngine
from tnn_tpu_torch.serving.kv_pool import PagedKVPool
from test_torch_paged_attention import force_splits

TINY = dict(vocab_size=128, max_len=64, num_layers=2, d_model=32,
            num_heads=2)
QMODEL = dict(vocab_size=512, max_len=160, num_layers=2, d_model=256,
              num_heads=4)
ENGINE = dict(num_blocks=14, block_size=4, max_batch_size=4, chunk_size=8)
QENGINE = dict(num_blocks=48, block_size=8, max_batch_size=8, chunk_size=64)
ATOL = 1e-5
MARGIN = 1e-3


# -- the int8 pool ------------------------------------------------------------

def _pool(**kw):
    kw = dict(dict(num_layers=2, num_kv_heads=2, head_dim=8, num_blocks=8,
                   block_size=4, kv_dtype="int8"), **kw)
    return PagedKVPool(**kw, device="cpu")


def test_int8_pool_layout_and_byte_accounting_match_jax():
    pool = _pool(dtype=torch.bfloat16)
    assert isinstance(pool.pages_k, tpa.QuantPages)
    assert pool.pages_k.data.dtype == torch.int8
    assert pool.pages_k.scale.dtype == torch.float32
    assert tuple(pool.pages_k.data.shape) == (2, 8, 2, 4, 8)
    assert tuple(pool.pages_k.scale.shape) == (2, 8, 2, 4, 1)
    jpool = JPool(num_layers=2, num_kv_heads=2, head_dim=8, num_blocks=8,
                  block_size=4, dtype=jnp.bfloat16, kv_dtype="int8")
    bf16 = _pool(dtype=torch.bfloat16, kv_dtype="f32")
    jbf16 = JPool(num_layers=2, num_kv_heads=2, head_dim=8, num_blocks=8,
                  block_size=4, dtype=jnp.bfloat16)
    for mine, theirs in ((pool, jpool), (bf16, jbf16)):
        assert (mine.page_itemsize, mine.kv_bytes_per_token,
                mine.kv_scale_bytes_per_token) == (
            theirs.page_itemsize, theirs.kv_bytes_per_token,
            theirs.kv_scale_bytes_per_token)
    assert pool.kv_bytes_per_token == 2 * 2 * 2 * 8
    assert bf16.kv_bytes_per_token == 2 * pool.kv_bytes_per_token
    with pytest.raises(ValueError, match="kv_dtype"):
        _pool(kv_dtype="fp8")


def test_int8_pool_lifecycle_and_bundle_audit():
    pool = _pool()
    blocks = pool.alloc(3)
    pool.check_invariants([blocks], [9])
    pool.free(blocks)
    pool.check_invariants([])
    good = pool.pages_k
    for bad, match in (
            (tpa.QuantPages(good.data, good.scale[..., 0]), "scale"),
            (tpa.QuantPages(good.data.float(), good.scale), "dtype"),
            (good.data, "QuantPages")):
        pool.pages_k = bad
        with pytest.raises(ValueError, match=match):
            pool.check_invariants([])
    pool.pages_k = good
    pool.check_invariants([])


def test_scatters_quantize_bit_exact_with_jax():
    rng = np.random.default_rng(7)
    shape = (2, 10, 2, 4, 8)
    tables = np.array([[3, 5, 0], [7, -1, 2], [0, 0, 0]], np.int32)
    offsets = np.array([5, 4, 3], np.int32)
    rows = rng.normal(size=(3, 2, 8)).astype(np.float32)
    starts = np.array([2, 0, 9], np.int32)
    q_lens = np.array([5, 3, 0], np.int32)
    chunk = rng.normal(size=(3, 6, 2, 8)).astype(np.float32)

    def fresh():
        return tpa.QuantPages(torch.zeros(shape, dtype=torch.int8),
                              torch.zeros(shape[:-1] + (1,)))

    def jfresh():
        return jpa.QuantPages(jnp.zeros(shape, jnp.int8),
                              jnp.zeros(shape[:-1] + (1,), jnp.float32))

    mine = tpa.scatter_kv_rows(fresh(), *map(torch.from_numpy,
                                             (tables, offsets, rows)),
                               layer=1)
    theirs = jpa.scatter_kv_rows(jfresh(), *map(jnp.asarray,
                                                (tables, offsets, rows)),
                                 layer=1)
    mine = tpa.scatter_kv_chunk(mine, *map(torch.from_numpy,
                                           (tables, starts, chunk, q_lens)),
                                layer=0)
    theirs = jpa.scatter_kv_chunk(theirs, *map(jnp.asarray,
                                               (tables, starts, chunk,
                                                q_lens)), layer=0)
    live = list(range(1, 10))   # which padding token wins scratch: either
    for m, t in zip(mine, theirs):
        np.testing.assert_array_equal(m.numpy()[:, live],
                                      np.asarray(t)[:, live])
    assert mine.data[1, 0].any()          # the -1 hole wrote to scratch


# -- paged attention over int8 pages ------------------------------------------

def _quant_case(seed, *, heads, q_width, block_size=4, batch=4, layers=2,
                num_blocks=24, head_dim=16, blocks_per_row=4, holes=False):
    """Int8 pages with positive scales (dequantized |K|, |V| <= 2.5), ragged
    tables with scratch-padded tails, a dead row, a full row, a one-token
    row; optional -1 holes."""
    h, hkv = heads
    rng = np.random.default_rng(seed)
    shape = (layers, num_blocks, hkv, block_size, head_dim)

    def pages():
        data = rng.integers(-127, 128, shape).astype(np.int8)
        scale = rng.uniform(0.005, 0.02, shape[:-1] + (1,)).astype(np.float32)
        return data, scale

    (kd, ks), (vd, vs) = pages(), pages()
    perm = rng.permutation(np.arange(1, num_blocks))[:batch * blocks_per_row]
    tables = perm.reshape(batch, blocks_per_row).astype(np.int32)
    cap = blocks_per_row * block_size
    kv_lens = rng.integers(q_width, cap + 1, size=batch).astype(np.int32)
    q_lens = rng.integers(1, q_width + 1, size=batch).astype(np.int32)
    kv_lens[0], q_lens[0] = 0, 0
    kv_lens[1] = cap
    kv_lens[2], q_lens[2] = 1, 1
    for i in range(batch):
        tables[i, math.ceil(kv_lens[i] / block_size):] = 0
    if holes:
        tables[1, 1] = -1
    q = rng.normal(size=(batch, q_width, h, head_dim)).astype(np.float32)
    return q, (kd, ks), (vd, vs), tables, kv_lens, q_lens


def _bundles(k, v):
    mine = [tpa.QuantPages(torch.from_numpy(d), torch.from_numpy(s))
            for d, s in (k, v)]
    theirs = [jpa.QuantPages(jnp.asarray(d), jnp.asarray(s))
              for d, s in (k, v)]
    return mine, theirs


@pytest.mark.parametrize("q_width", [1, 4])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (4, 1)],
                         ids=["mha", "gqa2", "mqa"])
@pytest.mark.parametrize("holes", [False, True], ids=["dense", "holes"])
def test_int8_plain_matches_jax_kernel_and_reference(q_width, heads, holes):
    q, k, v, tables, kv_lens, q_lens = _quant_case(
        q_width * 10 + heads[1] + 100 * holes, heads=heads, q_width=q_width,
        holes=holes)
    (tk, tv), (jk, jv) = _bundles(k, v)
    jargs = (jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(kv_lens))
    kernel = np.asarray(jpa.paged_attention(
        *jargs, q_lens=jnp.asarray(q_lens), layer=1, backend="pallas",
        interpret=True))
    ref = np.asarray(jpa.paged_attention_reference(
        *jargs, q_lens=jnp.asarray(q_lens), layer=1))
    t = [torch.from_numpy(a) for a in (q, tables, kv_lens, q_lens)]
    before = (tpa.paged_attention.launches, tpa.paged_attention.int8_launches)
    out = tpa.paged_attention(t[0], tk, tv, t[1], t[2], q_lens=t[3], layer=1)
    assert (tpa.paged_attention.launches,
            tpa.paged_attention.int8_launches) == before
    plain = tpa.paged_attention_reference(t[0], tk, tv, t[1], t[2],
                                          q_lens=t[3], layer=1)
    assert torch.equal(out, plain)
    np.testing.assert_allclose(out.numpy(), kernel, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    for i, n in enumerate(q_lens):
        assert not out[i, n:].any()       # padding tokens output exactly 0
    assert not out[0].any()


@pytest.mark.parametrize("heads", [(4, 4), (4, 2)], ids=["mha", "gqa2"])
def test_int8_decode_form_and_bf16_q_match_jax(heads):
    q, k, v, tables, kv_lens, _ = _quant_case(3, heads=heads, q_width=1,
                                              block_size=8)
    (tk, tv), (jk, jv) = _bundles(k, v)
    jout = np.asarray(jpa.paged_attention(
        jnp.asarray(q[:, 0]), jk, jv, jnp.asarray(tables),
        jnp.asarray(kv_lens), layer=0, backend="pallas", interpret=True))
    tq = torch.from_numpy(q[:, 0])
    t = [torch.from_numpy(a) for a in (tables, kv_lens)]
    out = tpa.paged_attention(tq, tk, tv, *t, layer=0)
    assert out.shape == tq.shape
    np.testing.assert_allclose(out.numpy(), jout, atol=ATOL, rtol=0)
    # bf16 q: promoted to f32 against f32 K/V, only the output is rounded
    qb = tq.bfloat16()
    ref = np.asarray(jpa.paged_attention_reference(
        jnp.asarray(qb.float().numpy()), jk, jv, jnp.asarray(tables),
        jnp.asarray(kv_lens), layer=0))
    outb = tpa.paged_attention(qb, tk, tv, *t, layer=0)
    assert outb.dtype == torch.bfloat16
    np.testing.assert_allclose(outb.float().numpy(), ref,
                               atol=ATOL, rtol=2 ** -8)


def test_int8_wrapper_rejects_mixed_bundles_and_bad_scales():
    q, k, v, tables, kv_lens, q_lens = _quant_case(1, heads=(4, 4),
                                                   q_width=4)
    (tk, tv), _ = _bundles(k, v)
    t = [torch.from_numpy(a) for a in (q, tables, kv_lens, q_lens)]
    with pytest.raises(ValueError, match="both"):
        tpa.paged_attention(t[0], tk, tv.data, t[1], t[2], q_lens=t[3])
    with pytest.raises(ValueError, match="collapsed"):
        tpa.paged_attention(t[0], tk, tpa.QuantPages(tv.data, tv.scale[0]),
                            t[1], t[2], q_lens=t[3])


# -- engines ------------------------------------------------------------------

class RecordingEngine(InferenceEngine):
    """Keeps every emitted greedy token's top-2 logit gap and checks the
    token is the row's argmax."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.gaps = []
        self.wide_steps = 0

    def _build(self, chunks, events):
        rec = super()._build(chunks, events)
        if rec is not None:
            self._rows = [r.rid for r in rec.get("rows", rec.get("live"))]
            if rec["kind"] == "mixed" and self._step_rows > tqm.W8A8_MAX_ROWS:
                self.wide_steps += 1
        return rec

    def _sample(self, logits, step):
        self._logits = logits.float()
        self._step_rows = int(np.prod(step.toks.shape))
        return super()._sample(logits, step)

    def step(self):
        events = super().step()
        for rid, tok in events["tokens"]:
            row = self._logits[self._rows.index(rid)]
            top2 = row.topk(2).values
            assert int(row.argmax()) == tok
            self.gaps.append(float(top2[0] - top2[1]))
        return events


def _prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _serve(make_engine, prompts, new):
    eng = make_engine()
    rids = [eng.submit(p, new) for p in prompts]
    out = eng.run_until_complete()
    return eng, [out[r] for r in rids]


def _tiny():
    jm = JGPT2(**TINY, policy=jdt.FP32)
    params = jm.init(jax.random.PRNGKey(0), (1, 8))["params"]
    tm = GPT2(**TINY, policy=tdt.FP32, device="cpu", seed=None)
    tm.load_jax_params(jax.tree.map(np.asarray, params))
    return jm, params, tm


def test_int8_kv_engine_token_exact_vs_jax():
    jm, params, tm = _tiny()
    prompts = _prompts(2, (5, 13, 22, 9, 17, 30), 128)
    _, jout = _serve(lambda: JEngine(jm, params, prefix_cache=False,
                                     decode_path="paged", kv_dtype="int8",
                                     **ENGINE), prompts, 10)
    eng, out = _serve(lambda: RecordingEngine(tm, device="cpu",
                                              kv_dtype="int8", **ENGINE),
                      prompts, 10)
    assert out == jout
    assert min(eng.gaps) > MARGIN, min(eng.gaps)
    stats = eng.stats()
    assert stats["kv_dtype"] == "int8" and stats["preemptions"] > 0
    assert stats["kv_bytes_per_token"] == 2 * 2 * 2 * 16
    assert stats["kv_scale_bytes_per_token"] == 2 * 2 * 2 * 4
    assert eng.metrics.summary()["kv_bytes_per_token"] == 128
    eng.check_invariants()
    assert eng.pool.num_allocated == 0


@pytest.fixture(scope="module")
def qmodels():
    jm = JGPT2(**QMODEL, policy=jdt.FP32)
    params = jm.init(jax.random.PRNGKey(0), (1, 8))["params"]
    tm = GPT2(**QMODEL, policy=tdt.FP32, device="cpu", seed=None)
    tm.load_jax_params(jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_quant_weights_engine_token_exact_vs_jax(qmodels, kv_dtype):
    jm, params, tm = qmodels
    prompts = _prompts(3, (40, 70, 100, 20, 55, 9), QMODEL["vocab_size"])
    _, jout = _serve(lambda: JEngine(jm, params, prefix_cache=False,
                                     decode_path="paged", kv_dtype=kv_dtype,
                                     quant_weights=True, **QENGINE),
                     prompts, 8)
    eng, out = _serve(lambda: RecordingEngine(
        tm, device="cpu", kv_dtype=kv_dtype, quant_weights=True, **QENGINE),
        prompts, 8)
    assert out == jout
    assert min(eng.gaps) > MARGIN, min(eng.gaps)
    assert eng.wide_steps > 0          # mixed steps took the int8 kernel
    assert eng.stats()["quant_weights"] is True
    # the engine quantized a copy: the caller's model is still float
    assert isinstance(tm.blocks[0].fc.kernel, torch.nn.Parameter)
    assert isinstance(eng.model.blocks[0].fc.kernel, tqm.Int8Weight)
    eng.check_invariants()


def _agreement(a, b):
    pairs = [(x, y) for ra, rb in zip(a, b) for x, y in zip(ra, rb)]
    assert len(pairs) == sum(len(r) for r in a)
    return sum(x == y for x, y in pairs) / len(pairs)


def test_int8_engines_agree_with_float_engine(qmodels):
    """JAX's closeness gate (tests/test_quant_serving.py): int8 outputs
    agree with the float engine at >= 0.8 of positions."""
    tiny = GPT2(**TINY, device="cpu", seed=0)       # MIXED_BF16
    prompts = _prompts(0, (5, 9, 13, 7), 128)
    _, ref = _serve(lambda: InferenceEngine(tiny, device="cpu", **ENGINE),
                    prompts, 8)
    _, out = _serve(lambda: InferenceEngine(tiny, device="cpu",
                                            kv_dtype="int8", **ENGINE),
                    prompts, 8)
    assert _agreement(out, ref) >= 0.8
    _, _, tm = qmodels
    prompts = _prompts(2, (40, 12, 70), QMODEL["vocab_size"])
    _, ref = _serve(lambda: InferenceEngine(tm, device="cpu", **QENGINE),
                    prompts, 8)
    _, out = _serve(lambda: InferenceEngine(tm, device="cpu",
                                            kv_dtype="int8",
                                            quant_weights=True, **QENGINE),
                    prompts, 8)
    assert _agreement(out, ref) >= 0.8


def test_last_only_head_takes_jax_full_logits_branch(qmodels, monkeypatch):
    """B=8, Q=64: JAX's head sees 512 rows and takes the weight-only kernel;
    the port's head sees 8 and, told the row count, takes the same."""
    jm, params, tm = qmodels
    jq = jquant.quantize_for_decode(params)
    qm = tquant.quantize_for_decode(tm)
    rng = np.random.default_rng(5)
    b, qw, bs, nb = 8, 64, 8, 12
    hkv, dh = QMODEL["num_heads"], QMODEL["d_model"] // QMODEL["num_heads"]
    shape = (QMODEL["num_layers"], 1 + b * nb, hkv, bs, dh)
    tables = (1 + np.arange(b * nb, dtype=np.int32)).reshape(b, nb)
    q_lens = np.array([64, 1, 1, 40, 64, 1, 17, 0], np.int32)
    starts = np.array([0, 30, 5, 8, 20, 0, 1, 0], np.int32)
    toks = rng.integers(0, QMODEL["vocab_size"], (b, qw)).astype(np.int32)
    pages = rng.normal(size=shape).astype(np.float32) * 0.5
    ref, _, _ = jm.apply_paged(jq, *map(jnp.asarray, (
        toks, pages, pages[::-1].copy(), tables, starts, q_lens)))
    ref = np.asarray(ref)[np.arange(b), np.maximum(q_lens - 1, 0)]

    calls = {"int8": 0, "w8a8": 0}
    real = (tqm.int8_matmul, tqm.w8a8_matmul)

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tqm, "int8_matmul", count("int8", real[0]))
    monkeypatch.setattr(tqm, "w8a8_matmul", count("w8a8", real[1]))
    t = [torch.from_numpy(a) for a in (toks, tables, starts, q_lens)]
    with torch.inference_mode():
        out = qm.apply_paged(t[0], torch.from_numpy(pages),
                             torch.from_numpy(pages[::-1].copy()), t[1],
                             t[2], t[3], last_only=True)
    assert calls == {"int8": 4 * QMODEL["num_layers"] + 1, "w8a8": 0}
    live = q_lens > 0
    err = np.abs(out.numpy()[live] - ref[live]).max()
    assert err <= 1e-5 * np.abs(ref[live]).max(), err


def test_cli_serves_int8_on_cpu():
    lines = [{"id": "a", "tokens": [1, 2, 3, 4], "max_new_tokens": 3},
             {"tokens": list(range(40)), "max_new_tokens": 2}]
    proc = subprocess.run(
        [sys.executable, "-m", "tnn_tpu_torch.cli.serve", "--model",
         "gpt2_tiny", "--device", "cpu", "--num-blocks", "32",
         "--kv-dtype", "int8", "--quant-weights"],
        input="".join(json.dumps(x) + "\n" for x in lines),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    events = [json.loads(x) for x in proc.stdout.splitlines()]
    done = {e["id"]: e for e in events if e["event"] == "done"}
    assert set(done) == {"a", 1} and len(done["a"]["tokens"]) == 3
    summary = json.loads(proc.stderr.split("serve summary: ")[1])
    assert summary["kv_dtype"] == "int8" and summary["quant_weights"] is True
    assert summary["kv_bytes_per_token"] == 2 * 2 * 128 * 1


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 3, 8],
                         ids=["rule", "split3", "split8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_int8_attention_kernel_matches_plain_on_card(dtype, head_dim, splits,
                                                     monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a card")
    force_splits(monkeypatch, splits)   # K1's split-KV, over int8 pages
    q, k, v, tables, kv_lens, q_lens = _quant_case(
        2, heads=(4, 2), q_width=8, block_size=16, blocks_per_row=8,
        num_blocks=40, head_dim=head_dim, holes=True)
    (tk, tv), _ = _bundles(k, v)
    tk = tpa.QuantPages(*(x.cuda() for x in tk))
    tv = tpa.QuantPages(*(x.cuda() for x in tv))
    t = [torch.from_numpy(a).cuda() for a in (q, tables, kv_lens, q_lens)]
    tq = t[0].to(getattr(torch, dtype))
    before = tpa.paged_attention.int8_launches
    out = tpa.paged_attention(tq, tk, tv, t[1], t[2], q_lens=t[3], layer=1)
    torch.cuda.synchronize()
    assert tpa.paged_attention.int8_launches == before + 1
    plain = tpa.paged_attention_reference(tq, tk, tv, t[1], t[2],
                                          q_lens=t[3], layer=1).float()
    # f32 in both: summation order; bf16 q adds the output's two roundings
    rtol = 1e-5 if dtype == "float32" else 2 ** -7
    abs_v = tpa.paged_attention_reference(
        tq, tk, tpa.QuantPages(tv.data.abs(), tv.scale), t[1], t[2],
        q_lens=t[3], layer=1).float()
    limit = 1e-5 + rtol * plain.abs() + 1e-5 * abs_v
    assert ((out.float() - plain).abs() <= limit).all()


# K3's launch plan: the fixed rule that picks the body and the tile
GPT2_SMALL_MATMULS = {"qkv": (768, 2304), "out": (768, 768),
                      "fc": (768, 3072), "proj": (3072, 768),
                      "head": (768, 50257)}


@pytest.mark.parametrize("rows", [8, 257, 512, 2048])
@pytest.mark.parametrize("shape", sorted(GPT2_SMALL_MATMULS))
def test_int8_matmul_plan_puts_bf16_gpt2_on_the_tensor_cores(shape, rows):
    k, n = GPT2_SMALL_MATMULS[shape]
    plan = tqm.plan_int8_matmul(rows, n, k, torch.bfloat16)
    assert plan == tqm.plan_int8_matmul(rows, n, k, torch.bfloat16)
    assert plan.body == "wgmma"
    assert plan.tile_m in tqm.TC_TILES_M
    if rows <= 64:   # the serving head's 8 rows: the smallest wgmma N
        assert plan.tile_m == min(t for t in tqm.TC_TILES_M if t >= rows)
    if rows == 512:
        # every wide-step shape gives at least a block for every two of the
        # H100's 132 SMs
        assert plan.blocks(rows, n) >= 132 // 2


@pytest.mark.parametrize("m,k,n,xdtype", [
    (512, 768, 2304, torch.float32), (512, 3072, 768, torch.float32),
    (8, 768, 50257, torch.float32), (300, 300, 130, torch.bfloat16),
    (64, 12, 256, torch.bfloat16), (16, 0, 16, torch.bfloat16)])
def test_int8_matmul_plan_keeps_f32_and_unaligned_k_on_simt(m, k, n, xdtype):
    plan = tqm.plan_int8_matmul(m, n, k, xdtype)
    assert plan == tqm.MatmulPlan("simt", tqm.SIMT_TILE_M)


def test_int8_matmul_plan_reads_the_sm_count():
    # a smaller card fills with fewer blocks: larger tiles
    big = tqm.plan_int8_matmul(512, 768, 3072, torch.bfloat16, sms=132)
    small = tqm.plan_int8_matmul(512, 768, 3072, torch.bfloat16, sms=24)
    assert small.tile_m == 128 and big.tile_m == 64
    assert small.blocks(512, 768) == 48 and big.blocks(512, 768) == 96


@pytest.mark.parametrize("rows,n,tile_m", [
    (1, 768, 8), (8, 50257, 8), (9, 768, 16), (17, 768, 32), (33, 768, 64),
    (64, 2304, 64), (65, 768, 64), (65, 50257, 128), (300, 768, 64),
    (512, 2304, 128)])
def test_int8_matmul_plan_tile_follows_rows(rows, n, tile_m):
    # up to 64 rows the smallest wgmma N that holds them; above, 128 where
    # that still gives half the SMs a block
    assert tqm.plan_int8_matmul(rows, n, 768, torch.bfloat16) \
        == tqm.MatmulPlan("wgmma", tile_m)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(512, 768, 2304), (300, 300, 130),
                                   (8, 768, 50257), (512, 768, 768),
                                   (512, 768, 3072), (512, 3072, 768),
                                   (512, 768, 50257), (40, 2056, 200)],
                         ids=["qkv", "ragged", "head8", "out", "fc", "proj",
                              "head512", "edges"])
@pytest.mark.parametrize("xdtype,out", [("bfloat16", None),
                                        ("bfloat16", "float32"),
                                        ("float32", None)])
def test_int8_matmul_kernel_matches_plain_on_card(m, k, n, xdtype, out):
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a card")
    gen = torch.Generator(device="cuda").manual_seed(m + n)
    w = torch.randn((k, n), generator=gen, device="cuda")
    x = torch.randn((m, k), generator=gen, device="cuda") \
        .to(getattr(torch, xdtype))
    iw = tqm.quantize_int8(w)
    odt = None if out is None else getattr(torch, out)
    before = tqm.int8_matmul.launches
    got = tqm.int8_matmul(x, iw.q, iw.scale, n=n, k=k, out_dtype=odt)
    torch.cuda.synchronize()
    assert tqm.int8_matmul.launches == before + 1
    # the same bits on every run: each output's K sum in a fixed order
    again = tqm.int8_matmul(x, iw.q, iw.scale, n=n, k=k, out_dtype=odt)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ref = tqm.int8_matmul_reference(x, iw.q, iw.scale, n=n, k=k,
                                    out_dtype=odt).float()
    # f32 sums in another order (|err| <= 1e-5 of sum |x| |w| s); a bf16
    # result may round the two f32 sums to neighbouring values
    mag = (x.float().abs() @ iw.dequant().abs())
    rtol = 0.0 if got.dtype == torch.float32 else 2 ** -7
    assert ((got.float() - ref).abs() <= 1e-5 * mag + rtol * ref.abs()).all()
