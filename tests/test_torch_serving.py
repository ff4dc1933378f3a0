"""Port parity: the serving slice (pool, scheduler, engine, CLI).

The headline gate: under FP32 the port's ``InferenceEngine`` emits the same
greedy tokens as the JAX engine, both with ``prefix_cache=False`` (the
cached engines are held in ``test_torch_prefix_cache.py``), on the tiny
GPT-2, over a workload with chunked prefill, decode and a pool small enough
to force recompute preemption. The seed is checked free of greedy near-ties: every emitted token beats the
runner-up logit by more than 1e-4, a hundred times the ~1e-6 that summation
order moves an f32 logit, so the comparison tests the engine, not rounding.
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
from tnn_tpu.serving import scheduler as jsched
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.serving import scheduler as tsched
from tnn_tpu_torch.serving.engine import InferenceEngine
from tnn_tpu_torch.serving.kv_pool import PagedKVPool, PoolExhausted

TINY = dict(vocab_size=128, max_len=64, num_layers=2, d_model=32,
            num_heads=2)
ENGINE = dict(num_blocks=14, block_size=4, max_batch_size=4, chunk_size=8)


def _models(policy=jdt.FP32, tpolicy=tdt.FP32, seed=0):
    jm = JGPT2(**TINY, policy=policy)
    params = jm.init(jax.random.PRNGKey(seed), (1, 8))["params"]
    tm = GPT2(**TINY, policy=tpolicy, device="cpu", seed=None)
    tm.load_jax_params(jax.tree.map(np.asarray, params))
    return jm, params, tm


def _prompts(seed=1, lens=(5, 13, 22, 9, 17, 30)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, n).astype(np.int32) for n in lens]


# -- pool ---------------------------------------------------------------------

def test_pool_alloc_free_and_invariants():
    pool = PagedKVPool(2, 2, 8, num_blocks=6, block_size=4, device="cpu")
    assert pool.capacity == 5 and pool.pages_k.shape == (2, 6, 2, 4, 8)
    a = pool.alloc(2)
    assert a == [1, 2]                        # LIFO order of the JAX pool
    b = pool.alloc(3)
    assert not pool.can_alloc(1)
    with pytest.raises(PoolExhausted):
        pool.alloc(1)
    pool.check_invariants([a, b], [8, 9])
    with pytest.raises(ValueError, match="mismatch"):
        pool.check_invariants([a])            # b leaked
    with pytest.raises(ValueError, match="stale tail"):
        pool.check_invariants([a, b], [1, 9])
    pool.free(a)
    with pytest.raises(KeyError):
        pool.free(a)                          # double free
    with pytest.raises(ValueError, match="free blocks"):
        pool.check_invariants([a, b])         # use after free
    assert pool.alloc(1) == [1]
    assert pool.blocks_for(0) == 1 and pool.blocks_for(9) == 3


# -- scheduler ----------------------------------------------------------------

class _Pool:
    def __init__(self, free, bs=4):
        self.num_allocatable, self.bs = free, bs

    def blocks_for(self, n):
        return max(1, -(-n // self.bs))


def _plan(plan):
    return ([r.rid for r in plan.prefills], [r.rid for r in plan.decodes],
            dict(plan.chunks))


def test_scheduler_decisions_match_jax():
    """The same script of submissions, progress and preemptions through
    both schedulers gives identical plans at every step."""
    scheds = (jsched.Scheduler(max_batch_size=3, token_budget=20,
                               chunk_size=8),
              tsched.Scheduler(max_batch_size=3, token_budget=20,
                               chunk_size=8))
    mods = (jsched, tsched)
    reqs = [[m.Request(rid=i, prompt=np.arange(n, dtype=np.int32),
                       max_new_tokens=4) for i, n in enumerate(
        (30, 3, 12, 40, 7))] for m in mods]
    for s, rs in zip(scheds, reqs):
        for r in rs:
            s.submit(r)
    frees = [10, 10, 1, 10, 0, 10, 10, 10]
    for step, free in enumerate(frees):
        plans = []
        for s in scheds:
            plan = s.schedule(_Pool(free))
            for r in plan.prefills:
                r.cache_len = 0
                s.admit(r)
            for r in s.running:                 # commit this step's work
                r.cache_len += plan.chunks.get(r.rid, 0) or (
                    1 if r.cache_len >= r.prefill_len else 0)
            if step == 3:                       # preempt the LIFO victim
                v = s.preempt_victim()
                v.block_table, v.cache_len = [], 0
                v.out_tokens.append(5)
                s.requeue(v)
            plans.append(_plan(plan))
        assert plans[0] == plans[1], (step, plans)


# -- engine -------------------------------------------------------------------

def _assert_tie_free(tm, prompts, outs, margin=1e-4):
    for prompt, out in zip(prompts, outs):
        seq = np.concatenate([prompt, out[:-1]]).astype(np.int64)
        logits = tm(torch.from_numpy(seq)[None])[0, len(prompt) - 1:]
        top2 = logits.topk(2, dim=-1).values
        assert (top2[:, 0] - top2[:, 1]).min() > margin
        assert logits.argmax(-1).tolist() == list(out)


def test_engine_greedy_token_exact_vs_jax_with_preemption():
    jm, params, tm = _models()
    prompts = _prompts()
    jeng = JEngine(jm, params, prefix_cache=False, decode_path="paged",
                   **ENGINE)
    jrids = [jeng.submit(p, 10) for p in prompts]
    jout = jeng.run_until_complete()
    eng = InferenceEngine(tm, device="cpu", prefix_cache=False, **ENGINE)
    rids = [eng.submit(p, 10) for p in prompts]
    out = eng.run_until_complete()
    eng.check_invariants()
    stats = eng.stats()
    assert stats["preemptions"] > 0
    assert stats["preemptions"] == jeng.metrics.summary()["preemptions"]
    assert stats["requests_finished"] == len(prompts)
    mine = [out[r] for r in rids]
    assert mine == [jout[r] for r in jrids]
    _assert_tie_free(tm, prompts, mine)
    assert eng.pool.num_allocated == 0


def test_engine_mixed_sampling_bf16_completes_and_repeats():
    tm = GPT2(**TINY, device="cpu", seed=5)   # default bf16 policy
    prompts = _prompts(seed=2, lens=(3, 11, 26, 8, 19))

    def run():
        eng = InferenceEngine(tm, device="cpu", seed=7, **ENGINE)
        rids = [eng.submit(p, 6, temperature=0.8 if i % 2 else 0.0,
                           top_k=20, top_p=0.9)
                for i, p in enumerate(prompts)]
        out = eng.run_until_complete()
        eng.check_invariants()
        return [out[r] for r in rids], eng

    a, eng = run()
    b, _ = run()
    assert a == b and all(len(t) == 6 for t in a)
    assert eng.model_steps > 0
    assert eng.stats()["ttft_ms_p50"] > 0


def test_engine_stop_token_and_submit_validation():
    tm = GPT2(**TINY, policy=tdt.FP32, device="cpu", seed=1)
    eng = InferenceEngine(tm, device="cpu", **ENGINE)
    probe = InferenceEngine(tm, device="cpu", **ENGINE)
    rid = probe.submit([1, 2, 3], 5)
    tok = probe.run_until_complete()[rid][1]
    rid = eng.submit([1, 2, 3], 5, stop_token=tok)
    eng.run_until_complete()
    req = eng.result(rid)
    assert req.finish_reason == "stop_token" and req.out_tokens[-1] == tok
    for bad in (dict(prompt_ids=[], max_new_tokens=2),
                dict(prompt_ids=[1], max_new_tokens=0),
                dict(prompt_ids=[200], max_new_tokens=2),
                dict(prompt_ids=[1] * 60, max_new_tokens=10)):
        with pytest.raises(ValueError):
            eng.submit(**bad)


def test_logit_guard_fails_only_the_poisoned_row():
    tm = GPT2(**TINY, policy=tdt.FP32, device="cpu", seed=1)
    eng = InferenceEngine(tm, device="cpu", **ENGINE)
    rids = [eng.submit(p, 4) for p in _prompts(lens=(4, 6))]
    eng.step()                                  # both prefill
    real = tm.apply_decode_paged

    def poisoned(*args):
        logits = real(*args)
        logits[0] = float("nan")
        return logits

    tm.apply_decode_paged = poisoned
    try:
        events = eng.step()
    finally:
        del tm.apply_decode_paged
    assert [r for r, _ in events["failed"]] == [rids[0]]
    eng.run_until_complete()
    assert eng.result(rids[1]).state is tsched.RequestState.FINISHED
    eng.check_invariants()


def test_step_failure_propagates():
    """A failing forward (a kernel error on the card) raises out of step():
    the engine does not turn it into failed requests."""
    tm = GPT2(**TINY, policy=tdt.FP32, device="cpu", seed=1)
    eng = InferenceEngine(tm, device="cpu", **ENGINE)
    rid = eng.submit([1, 2, 3], 4)

    def boom(*args, **kw):
        raise RuntimeError("kernel launch failed")

    tm.apply_paged = boom
    try:
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            eng.step()
    finally:
        del tm.apply_paged
    assert eng.result(rid).state is tsched.RequestState.RUNNING


def test_cli_serves_json_lines_on_cpu():
    lines = [{"id": "a", "tokens": [1, 2, 3, 4], "max_new_tokens": 3},
             {"tokens": [9, 8], "max_new_tokens": 2, "temperature": 0.8,
              "top_k": 10}, "not json"]
    proc = subprocess.run(
        [sys.executable, "-m", "tnn_tpu_torch.cli.serve", "--model",
         "gpt2_tiny", "--device", "cpu", "--num-blocks", "16"],
        input="\n".join(x if isinstance(x, str) else json.dumps(x)
                        for x in lines) + "\n",
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    events = [json.loads(x) for x in proc.stdout.splitlines()]
    done = {e["id"]: e for e in events if e["event"] == "done"}
    assert set(done) == {"a", 1}
    assert len(done["a"]["tokens"]) == 3 and len(done[1]["tokens"]) == 2
    assert done["a"]["finish_reason"] == "length"
    tokens_a = [e["token"] for e in events
                if e["event"] == "token" and e["id"] == "a"]
    assert tokens_a == done["a"]["tokens"]
    assert sum(e["event"] == "error" for e in events) == 1
    assert "serve summary" in proc.stderr


def test_engine_requires_model_on_its_device():
    tm = GPT2(**TINY, device="cpu", seed=1)
    with pytest.raises(ValueError, match="live on"):
        InferenceEngine(tm, device=torch.device("meta"), **ENGINE)


def _cli(lines, *flags):
    proc = subprocess.run(
        [sys.executable, "-m", "tnn_tpu_torch.cli.serve", "--model",
         "gpt2_tiny", "--device", "cpu", "--num-blocks", "16", *flags],
        input="".join(json.dumps(x) + "\n" for x in lines),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return [json.loads(x) for x in proc.stdout.splitlines()], proc.stderr


def test_cli_no_overlap_gives_the_same_tokens():
    """The CLI serves with the overlapped loop by default; --no-overlap
    runs each step synchronously and streams the same tokens."""
    lines = [{"id": "g", "tokens": [1, 2, 3, 4], "max_new_tokens": 6},
             {"id": "s", "tokens": [9, 8, 7], "max_new_tokens": 5,
              "temperature": 0.8, "top_k": 10}]
    runs = [_cli(lines), _cli(lines, "--no-overlap")]
    streams = []
    for events, err in runs:
        streams.append([(e["event"], e["id"], e.get("token"),
                         e.get("tokens")) for e in events])
        assert sum(e["event"] == "done" for e in events) == 2
    assert streams[0] == streams[1]
    assert '"overlap": true' in runs[0][1]
    assert '"overlap": false' in runs[1][1]


def test_cli_deadline_line_times_out():
    lines = [{"id": "late", "tokens": [1, 2, 3], "max_new_tokens": 8,
              "deadline_s": 1e-9},
             {"id": "fine", "tokens": [4, 5], "max_new_tokens": 3}]
    events, err = _cli(lines)
    timeouts = [e for e in events if e["event"] == "timeout"]
    assert [e["id"] for e in timeouts] == ["late"]
    assert "deadline" in timeouts[0]["reason"]
    assert [e["id"] for e in events if e["event"] == "done"] == ["fine"]
    assert '"requests_timed_out": 1' in err
    # --deadline-s is every line's default
    events, _ = _cli(lines[1:], "--deadline-s", "1e-9")
    assert [e["event"] for e in events] == ["timeout"]


def test_cli_cancel_line():
    lines = [{"id": "x", "tokens": [1, 2, 3], "max_new_tokens": 20},
             {"op": "cancel", "id": "x"}, {"op": "cancel", "id": "x"},
             {"op": "cancel", "id": "never"},
             {"id": 7, "tokens": [3, 2], "max_new_tokens": 2}]
    events, err = _cli(lines)
    # the supervisor's terminal events also carry the trace id and the
    # latency breakdown
    assert [{k: e[k] for k in ("event", "id", "reason")}
            for e in events if e["event"] == "cancelled"] == [
        {"event": "cancelled", "id": "x", "reason": "cancelled by client"}]
    errors = [e["id"] for e in events if e["event"] == "error"]
    assert errors == ["x", "never"]         # already terminal; unknown
    assert [e["id"] for e in events if e["event"] == "done"] == [7]
    assert not [e for e in events if e["id"] == "x"
                and e["event"] == "token"]
    assert '"requests_cancelled": 1' in err


# -- a .tnn model file, a vocab, whole-prompt prefill, bounded admission ------

@pytest.fixture(scope="module")
def model_and_vocab(tmp_path_factory):
    """A seeded 2L/32d GPT-2 written by the port's ``save_model`` with a
    vocabulary the size of a BPE vocab trained on a little text."""
    from tnn_tpu_torch import checkpoint
    from tnn_tpu_torch.data.tokenizer import train_bpe

    d = tmp_path_factory.mktemp("served")
    tok = train_bpe(["the cat sat on the mat. " * 4,
                     "a dog ran to the park and sat down. " * 3], 300)
    tok.save(str(d / "vocab.bin"))
    model = GPT2(vocab_size=tok.vocab_size, max_len=64, num_layers=2,
                 d_model=32, num_heads=2, policy=tdt.FP32, device="cpu",
                 seed=4)
    checkpoint.save_model(str(d / "model.tnn"), model)
    return d, tok


def test_cli_serves_text_lines_from_a_model_file(model_and_vocab):
    """``--model-file`` + ``--vocab`` + ``--no-chunked-prefill``: "prompt"
    lines are BPE-encoded, done events carry the decoded text, and the
    tokens are the in-process whole-prompt engine's on the same file."""
    from tnn_tpu_torch import checkpoint

    d, tok = model_and_vocab
    lines = [{"id": "t", "prompt": "the cat sat on the", "max_new_tokens": 5},
             {"id": "ids", "tokens": tok.encode("a dog ran"),
              "max_new_tokens": 4}]
    events, err = _cli(lines, "--model-file", str(d / "model.tnn"),
                       "--vocab", str(d / "vocab.bin"),
                       "--no-chunked-prefill", "--no-logit-guard",
                       "--preemption-budget", "-1")
    done = {e["id"]: e for e in events if e["event"] == "done"}
    assert set(done) == {"t", "ids"}
    for e in done.values():
        assert e["text"] == tok.decode(e["tokens"])
    model = checkpoint.load_model(str(d / "model.tnn"), device="cpu")
    eng = InferenceEngine(model, device="cpu", num_blocks=16,
                          chunked_prefill=False)
    rids = [eng.submit(tok.encode("the cat sat on the"), 5),
            eng.submit(tok.encode("a dog ran"), 4)]
    out = eng.run_until_complete()
    assert [done["t"]["tokens"], done["ids"]["tokens"]] == \
        [out[r] for r in rids]
    assert '"chunked_prefill": false' in err and '"prefills": 2' in err


def test_cli_rejected_and_shed_lines_keep_serving():
    """``--max-queue-depth 1``: an important line sheds the queued
    background one (an error event naming the shed), an equal one is
    rejected with ``"rejected": true``; serving goes on, and a byte-level
    "prompt" line (no vocab) is served."""
    lines = [{"id": "bg", "tokens": [1, 2, 3], "max_new_tokens": 3,
              "priority": 5},
             {"id": "fg", "prompt": "hi there", "max_new_tokens": 3},
             {"id": "late", "tokens": [4, 5], "max_new_tokens": 3}]
    events, err = _cli(lines, "--max-queue-depth", "1")
    errors = {e["id"]: e for e in events if e["event"] == "error"}
    assert set(errors) == {"bg", "late"}
    assert "shed under overload" in errors["bg"]["reason"]
    assert errors["late"]["rejected"] is True
    assert "queue full" in errors["late"]["reason"]
    assert [e["id"] for e in events if e["event"] == "done"] == ["fg"]
    assert '"rejected": 1' in err and '"shed_requests": 1' in err
