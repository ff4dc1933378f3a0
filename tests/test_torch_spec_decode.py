"""Port parity: speculative decoding (``serving/spec_decode.py``, the
scheduler's ``spec_tokens``, ``pack_mixed``'s drafts, the engine's
verification and rollback).

- The drafters propose what JAX's propose on the same contexts.
- Engines under FP32, greedy, on cyclic prompts (where the n-gram drafter
  fires): ``spec="ngram"`` and ``spec="draft"`` are token-exact against the
  port with spec off and against JAX's spec engine, with equal drafted and
  accepted counts, and ``pool.check_invariants`` passes after every step.
  Seeds are tie-free: every emitted token beats the runner-up logit by
  more than 1e-3 in the port model's own logits.
- Stochastic verification: a seeded run repeats bit for bit, and over
  many draws the first committed token follows the target softmax (total
  variation below 0.03 at 40,000 draws over 8 tokens, where sampling noise
  gives about 0.005).
"""
import json
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from tnn_tpu.core import dtypes as jdt
from tnn_tpu.models import zoo as jzoo
from tnn_tpu.models.gpt2 import GPT2 as JGPT2
from tnn_tpu.serving import InferenceEngine as JEngine
from tnn_tpu.serving import scheduler as jsched
from tnn_tpu.serving import spec_decode as jspec
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.models import zoo
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.serving import scheduler as tsched
from tnn_tpu_torch.serving import spec_decode as tspec
from tnn_tpu_torch.serving import step_build
from tnn_tpu_torch.serving.engine import InferenceEngine
from tnn_tpu_torch.serving.kv_pool import PagedKVPool

TINY = dict(vocab_size=128, max_len=64, num_layers=2, d_model=32,
            num_heads=2)
SMALL = dict(vocab_size=512, max_len=64, num_layers=2, d_model=256,
             num_heads=4)
KW = dict(num_blocks=32, block_size=4, max_batch_size=4, max_seq_len=32)
MARGIN = 1e-3


def _pair(cfg, key=0, make=JGPT2, tmake=GPT2):
    jm = make(**cfg, policy=jdt.FP32)
    params = jm.init(jax.random.PRNGKey(key), (1, 8))["params"]
    tm = tmake(**cfg, policy=tdt.FP32, device="cpu", seed=None)
    tm.load_jax_params(jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.fixture(scope="module")
def tiny():
    return _pair(TINY)


@pytest.fixture(scope="module")
def small():
    return _pair(SMALL)


@pytest.fixture(scope="module")
def draft():
    """The zoo's draft model, seeded, the target's vocab and positions."""
    cfg = dict(vocab_size=128, max_len=64)
    return _pair(cfg, key=1,
                 make=lambda **kw: jzoo.create("gpt2_tiny", **kw),
                 tmake=lambda **kw: zoo.create("gpt2_tiny", **kw))


def _cyclic(seed, n=4, vocab=128, reps=5):
    rng = np.random.default_rng(seed)
    return [np.tile(rng.integers(0, vocab, 3), reps).astype(np.int32)
            for _ in range(n)]


def _assert_tie_free(tm, prompts, outs, margin=MARGIN):
    with torch.inference_mode():
        for prompt, out in zip(prompts, outs):
            seq = np.concatenate([prompt, out[:-1]]).astype(np.int64)
            logits = tm(torch.from_numpy(seq)[None])[0, len(prompt) - 1:]
            top2 = logits.topk(2, dim=-1).values
            assert (top2[:, 0] - top2[:, 1]).min() > margin
            assert logits.argmax(-1).tolist() == list(out)


def _serve(eng, prompts, new=10, stagger=True, check=False):
    """The first prompt, two steps, then the rest (or all at once); with
    ``check`` the pool's invariants after every step."""
    rids = [eng.submit(prompts[0], new)]
    if stagger:
        eng.step()
        eng.step()
    rids += [eng.submit(p, new) for p in prompts[1:]]
    while eng.has_work:
        eng.step()
        if check:
            eng.check_invariants()
    return [list(eng.result(r).out_tokens) for r in rids]


def _spec_counts(summary):
    return (summary["spec_draft_tokens"], summary["spec_accepted_tokens"])


# -- drafters -----------------------------------------------------------------

def _req(prompt, out=()):
    return types.SimpleNamespace(prompt=np.asarray(prompt, np.int32),
                                 out_tokens=list(out))


@pytest.mark.parametrize("ctx,k", [
    (([1, 2, 3, 1, 2, 3, 1, 2], ()), 3), (([1, 2, 3, 1, 2, 3, 1, 2], ()), 1),
    ((np.arange(8), ()), 4), (([7, 8], [9, 7, 8]), 2),
    (([5, 5, 5, 5], [5]), 4), (([3], ()), 2)])
def test_ngram_drafts_match_jax(ctx, k):
    req = _req(*ctx)
    assert tspec.NGramDrafter().draft(req, k) == \
        jspec.NGramDrafter().draft(req, k)
    assert tspec.NGramDrafter(max_n=1).draft(req, k) == \
        jspec.NGramDrafter(max_n=1).draft(req, k)
    with pytest.raises(ValueError, match="min_n"):
        tspec.NGramDrafter(max_n=2, min_n=3)


def test_draft_model_drafts_match_jax(draft):
    jd, dparams, td = draft
    t, j = tspec.DraftModelDrafter(td), jspec.DraftModelDrafter(jd, dparams)
    for ctx in (np.arange(8) % 128, np.arange(37) * 5 % 128, [3]):
        got = t.draft(_req(ctx), 4)
        assert isinstance(got, tspec.DeviceDraft) and len(got) == 4
        assert got.tolist() == t.draft(_req(ctx), 4).tolist() \
            == j.draft(_req(ctx), 4).tolist()
        assert got.toks.dtype == torch.int32
    # at the draft model's position cap the proposal shrinks, then vanishes
    assert t.draft(_req(np.zeros(64, np.int32)), 4) == []
    assert len(t.draft(_req(np.zeros(62, np.int32)), 4)) == 2


# -- scheduler and packing ------------------------------------------------------

def test_scheduler_spec_budget_matches_jax():
    plans = []
    for m in (jsched, tsched):
        for spec in (0, 4):
            s = m.Scheduler(max_batch_size=4, token_budget=10, chunk_size=8,
                            spec_tokens=spec)
            dec = m.Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                            max_new_tokens=8)
            dec.prefill_len = dec.cache_len = 4
            pre = m.Request(rid=1, prompt=np.arange(12, dtype=np.int32),
                            max_new_tokens=8)
            pre.prefill_len, pre.cache_len = 12, 4
            s.admit(dec)
            s.admit(pre)
            pool = PagedKVPool(1, 1, 2, 9, 4, device="cpu")
            plans.append(dict(s.schedule(pool).chunks))
    assert plans[:2] == plans[2:] == [{1: 8}, {1: 5}]
    with pytest.raises(ValueError, match="spec_tokens"):
        tsched.Scheduler(spec_tokens=-1)


def test_pack_mixed_places_host_and_device_drafts():
    def req(rid, cache_len, next_token=None, prompt=()):
        return types.SimpleNamespace(
            rid=rid, cache_len=cache_len, next_token=next_token,
            block_table=[rid + 1], temperature=0.0, top_k=0, top_p=0.0,
            resume_tokens=np.asarray(prompt, np.int32))

    dd = tspec.DeviceDraft(torch.tensor([7, 8, 9], dtype=torch.int32))
    rows = [req(0, 5, 11), req(1, 6, 12), req(2, 3, 13),
            req(3, 0, prompt=range(20, 26))]
    step = step_build.pack_mixed(rows, 3, {0: [4, 5], 1: dd}, {3: 6}, b=5,
                                 nb=2, scratch=0)
    assert step.toks.shape == (5, 8)              # pow2 of the 6-token chunk
    assert step.toks[0, :3].tolist() == [11, 4, 5]
    assert step.toks[1, :4].tolist() == [12, 0, 0, 0]   # spliced later
    assert step.dev_drafts == [(1, dd)]
    assert step.q_lens.tolist() == [3, 4, 1, 6, 0]
    assert step.n_draft.tolist() == [2, 3, 0, 0, 0]
    assert step.toks[3, :6].tolist() == list(range(20, 26))


# -- the engine -----------------------------------------------------------------

SPEC_CASES = {
    # name: (model, prompt seed, engine arguments)
    "ngram_paged": (TINY, 2, dict(spec="ngram", decode_path="paged")),
    "ngram_standard": (TINY, 2, dict(spec="ngram", decode_path="standard")),
    "ngram_int8": (TINY, 2, dict(spec="ngram", kv_dtype="int8")),
    "ngram_fused": (SMALL, 1, dict(spec="ngram", decode_path="fused",
                                   quant_weights=True, num_blocks=16,
                                   block_size=8, max_batch_size=2)),
    "ngram_sp2": (TINY, 2, dict(spec="ngram", sp=2)),
    "draft_paged": (TINY, 2, dict(spec="draft", decode_path="paged")),
    "draft_standard": (TINY, 2, dict(spec="draft",
                                     decode_path="standard")),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_spec_token_exact_vs_off_and_jax(case, tiny, small, draft):
    cfg, seed, kw = SPEC_CASES[case]
    jm, params, tm = tiny if cfg is TINY else small
    kw = {**KW, **kw}
    prompts = _cyclic(seed, n=4 if case.startswith("ngram_")
                      and case != "ngram_fused" else 2,
                      vocab=cfg["vocab_size"])
    jkw, tkw = dict(kw), dict(kw)
    if kw["spec"] == "draft":
        jkw.update(draft_model=draft[0], draft_params=draft[1])
        tkw.update(draft_model=draft[2])
    jeng = JEngine(jm, params, **jkw)
    want = _serve(jeng, prompts)
    eng = InferenceEngine(tm, device="cpu", **tkw)
    got = _serve(eng, prompts, check=True)
    off = InferenceEngine(tm, device="cpu", **{**kw, "spec": "off"})
    assert got == want == _serve(off, prompts)
    _assert_tie_free(eng.model, prompts, got)
    s = eng.stats()
    assert _spec_counts(s) == _spec_counts(jeng.metrics.summary())
    assert s["spec_draft_tokens"] > 0 and s["spec"] == kw["spec"]
    assert s["mean_accepted_per_step"] == \
        jeng.metrics.summary()["mean_accepted_per_step"]
    steps = s["program_steps"]
    assert steps.get("spec" if eng._paged else "spec_standard", 0) > 0
    if kw["spec"] == "ngram":
        assert s["spec_acceptance_rate"] > 0
        assert eng.model_steps < off.model_steps
    assert eng.pool.num_allocated == 0


def test_fused_spec_runs_k8_on_draft_free_lockstep_steps(small):
    """On the fused path a step with drafts runs the standard spec program
    and a draft-free lockstep step still runs the fused kernel's."""
    jm, params, tm = small
    kw = dict(KW, spec="ngram", decode_path="fused", quant_weights=True,
              num_blocks=16, block_size=8, max_batch_size=2)
    prompts = [np.arange(40, 52, dtype=np.int32)] * 2
    want = _serve(JEngine(jm, params, **kw), prompts, stagger=False)
    eng = InferenceEngine(tm, device="cpu", **kw)
    assert _serve(eng, prompts, stagger=False, check=True) == want
    steps = eng.stats()["program_steps"]
    assert steps.get("fdecode", 0) > 0 and eng.stats()["spec"] == "ngram"


def test_self_draft_accepts_and_matches_jax(tiny):
    """The target as its own draft model: drafts are the target's greedy
    tokens, so nearly every one is accepted, in both packages alike."""
    jm, params, tm = tiny
    prompts = [np.arange(i, i + 9, dtype=np.int32) for i in (3, 40, 90)]
    jeng = JEngine(jm, params, spec="draft", draft_model=jm,
                   draft_params=params, **KW)
    want = _serve(jeng, prompts, stagger=False)
    eng = InferenceEngine(tm, device="cpu", spec="draft", draft_model=tm,
                          **KW)
    assert _serve(eng, prompts, stagger=False, check=True) == want
    s = eng.stats()
    assert _spec_counts(s) == _spec_counts(jeng.metrics.summary())
    assert s["spec_acceptance_rate"] > 0.9 and \
        s["mean_accepted_per_step"] > 3


def _stop_inside_a_draft(tm, prompts):
    """A prompt and a stream position whose token a self-drafting engine
    commits as an accepted draft (not the step's last token) and emits
    there first; None when no prompt has one."""
    for p in prompts:
        eng = InferenceEngine(tm, device="cpu", spec="draft", draft_model=tm,
                              **KW)
        rid = eng.submit(p, 10)
        commits = []
        while eng.has_work:
            toks = [t for r, t in eng.step()["tokens"] if r == rid]
            commits.append(toks)
        stream = sum(commits, [])
        pos = 0
        for c in commits:
            for j, t in enumerate(c[:-1]):
                if stream.index(t) == pos + j:
                    return p, stream, pos + j
            pos += len(c)
    return None


def test_stop_token_mid_draft_cuts_the_commit(tiny):
    """A stop token inside an accepted draft ends the commit there: the
    accepted tokens after it are dropped, as sequential decode would never
    have produced them. The target drafts for itself, so drafts are
    accepted."""
    _, _, tm = tiny
    found = _stop_inside_a_draft(
        tm, [np.arange(i, i + 9, dtype=np.int32) for i in (3, 40, 90)])
    assert found is not None
    p, stream, i = found
    ref = _serve(InferenceEngine(tm, device="cpu", **KW), [p])[0]
    assert stream == ref
    eng = InferenceEngine(tm, device="cpu", spec="draft", draft_model=tm,
                          **KW)
    rid = eng.submit(p, 10, stop_token=stream[i])
    out = eng.run_until_complete()
    assert out[rid] == ref[:i + 1]
    assert eng.result(rid).finish_reason == "stop_token"
    eng.check_invariants()
    assert eng.pool.num_allocated == 0


def test_spec_with_prefix_hits_stays_exact(tiny):
    jm, params, tm = tiny
    rng = np.random.default_rng(3)
    prefix = np.tile(rng.integers(0, 128, 3), 4).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, 128, 4)
                               .astype(np.int32)]) for _ in range(3)]
    prompts.append(prefix.copy())                       # a full-cover hit

    def run(eng):
        rids = []
        for p in prompts:
            rids.append(eng.submit(p, 8))
            eng.step()
        while eng.has_work:
            eng.step()
            eng.check_invariants()
        return eng, [eng.result(r).out_tokens for r in rids]

    eng, got = run(InferenceEngine(tm, device="cpu", spec="ngram", **KW))
    jeng, want = run(JEngine(jm, params, spec="ngram", **KW))
    _, off = run(InferenceEngine(tm, device="cpu", prefix_cache=False, **KW))
    assert got == want == off
    s = eng.stats()
    assert s["prefill_tokens_saved"] == jeng.metrics.prefill_tokens_saved > 0
    assert s["prefix_cows"] == 1 and s["spec_accepted_tokens"] > 0
    assert _spec_counts(s) == _spec_counts(jeng.metrics.summary())


def test_stochastic_spec_repeats_bit_for_bit(tiny):
    _, _, tm = tiny
    prompts = _cyclic(6, n=3)

    def run():
        eng = InferenceEngine(tm, device="cpu", spec="ngram", seed=3, **KW)
        rids = [eng.submit(p, 10, temperature=0.9, top_k=16, top_p=0.9)
                for p in prompts]
        rids.append(eng.submit(prompts[0], 10))            # greedy beside
        out = eng.run_until_complete()
        eng.check_invariants()
        return [out[r] for r in rids], eng.stats()

    a, sa = run()
    b, sb = run()
    assert a == b and _spec_counts(sa) == _spec_counts(sb)
    assert sa["spec_draft_tokens"] > 0
    assert all(len(t) == 10 and all(0 <= x < 128 for x in t) for t in a)
    greedy = InferenceEngine(tm, device="cpu", **KW)
    rid = greedy.submit(prompts[0], 10)
    assert greedy.run_until_complete()[rid] == a[-1]


@pytest.mark.parametrize("draft_tok", [1, 5])
def test_rejection_sampling_follows_target_softmax(tiny, draft_tok):
    """Many decode rows, one step each, drafting one token: the committed
    token (the draft if accepted, else the redraw) is distributed as the
    target softmax at temperature 1."""
    _, _, tm = tiny
    eng = InferenceEngine(tm, device="cpu", spec="ngram", seed=11, **KW)
    v, rows = 8, 40000
    target = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, 1.5, -1.0, 0.3])
    logits = target.expand(rows, 2, v).clone()
    toks = torch.zeros(rows, 2, dtype=torch.int32)
    toks[:, 1] = draft_tok
    step = types.SimpleNamespace(
        temps=np.ones(rows, np.float32), topks=np.zeros(rows, np.int32),
        topps=np.zeros(rows, np.float32))
    accepts, newtok, ok = eng._spec_verify(
        logits, toks, torch.full((rows,), 2), torch.ones(rows,
                                                         dtype=torch.long),
        step)
    first = torch.where(accepts > 0, torch.tensor(draft_tok), newtok)
    freq = torch.bincount(first, minlength=v).float() / rows
    want = torch.softmax(target, 0)
    assert bool(ok.all())
    assert 0.5 * (freq - want).abs().sum().item() < 0.03
    # accepted as often as the target gives the draft
    assert abs(accepts.float().mean().item() - want[draft_tok].item()) < 0.01


def test_constructor_refusals(tiny, draft):
    _, _, tm = tiny
    with pytest.raises(ValueError, match="unknown spec"):
        InferenceEngine(tm, device="cpu", spec="turbo", **KW)
    with pytest.raises(ValueError, match="draft_model"):
        InferenceEngine(tm, device="cpu", spec="draft", **KW)
    with pytest.raises(ValueError, match="spec_k"):
        InferenceEngine(tm, device="cpu", spec="ngram", spec_k=0, **KW)
    wrong = zoo.create("gpt2_tiny", vocab_size=64, device="cpu", seed=2)
    with pytest.raises(ValueError, match="vocab"):
        InferenceEngine(tm, device="cpu", spec="draft", draft_model=wrong,
                        **KW)
    meta = zoo.create("gpt2_tiny", vocab_size=128, device="meta", seed=None)
    with pytest.raises(ValueError, match="draft model parameters"):
        InferenceEngine(tm, device="cpu", spec="draft", draft_model=meta,
                        **KW)
    eng = InferenceEngine(tm, device="cpu", spec=tspec.NGramDrafter(max_n=2),
                          **KW)
    assert eng.stats()["spec"] == "ngram" and eng.stats()["spec_k"] == 4
    assert InferenceEngine(tm, device="cpu", **KW).stats()["spec_k"] == 0


def test_cli_spec_ngram():
    line = json.dumps({"tokens": [5, 9, 2] * 6, "max_new_tokens": 12})
    proc = subprocess.run(
        [sys.executable, "-m", "tnn_tpu_torch.cli.serve", "--model",
         "gpt2_tiny", "--device", "cpu", "--num-blocks", "16",
         "--block-size", "4", "--spec", "ngram", "--spec-k", "4"],
        input=line + "\n", capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    done = [json.loads(x) for x in proc.stdout.splitlines()]
    assert [len(e["tokens"]) for e in done if e["event"] == "done"] == [12]
    summary = json.loads(proc.stderr.split("serve summary: ")[1])
    assert summary["spec"] == "ngram" and summary["spec_k"] == 4
    assert summary["spec_draft_tokens"] > 0
    for key in ("spec_acceptance_rate", "mean_accepted_per_step",
                "prefill_tokens_saved"):
        assert key in summary


@pytest.mark.cuda
@pytest.mark.parametrize("kv_heads", [12, 4], ids=["mha", "gqa4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_at_the_verify_shape_matches_plain_on_card(dtype, kv_heads):
    """The verify rows' traffic for K1: 8 rows of q_len 5 (spec_k 4) over
    100-1000 cached positions, Dh 64, against the plain version, with the
    tolerance of chip_smoke.TOLERANCE."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a card")
    from tnn_tpu_torch.ops import paged_attention as tpa

    rng = np.random.default_rng(5)
    kv = np.array([100, 1000, 517, 333, 768, 250, 904, 640], np.int32)
    nb = -(-kv // 16)
    blocks = rng.permutation(np.arange(1, nb.sum() + 1))
    tables = np.zeros((8, nb.max()), np.int32)
    for i, n in enumerate(nb):
        tables[i, :n], blocks = blocks[:n], blocks[n:]
    dt = getattr(torch, dtype)
    shape = (2, int(nb.sum()) + 1, kv_heads, 16, 64)
    pk, pv = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
              .cuda().to(dt) for _ in range(2))
    q = torch.from_numpy(rng.normal(size=(8, 5, 12, 64)).astype(
        np.float32)).cuda().to(dt)
    args = dict(block_tables=torch.from_numpy(tables).cuda(),
                kv_lens=torch.from_numpy(kv).cuda(),
                q_lens=torch.full((8,), 5, dtype=torch.int32, device="cuda"),
                layer=1)
    before = tpa.paged_attention.launches
    out = tpa.paged_attention(q, pk, pv, **args)
    torch.cuda.synchronize()
    assert tpa.paged_attention.launches == before + 1
    plain = tpa.paged_attention_reference(q, pk, pv, **args).float()
    abs_v = tpa.paged_attention_reference(q, pk, pv.abs(), **args).float()
    atol, rtol = (1e-5, 1e-5) if dtype == "float32" else (1e-4, 2 ** -7)
    assert ((out.float() - plain).abs()
            <= atol + rtol * (plain.abs() + abs_v)).all()
