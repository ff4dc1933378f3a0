"""Port parity: the engine's assembled-cache decode paths ("standard" and
"fused") and its decode-path selection.

Under FP32 against the JAX engine (``prefix_cache=False``), greedy streams
token for token, on seeds checked free of near-ties (every emitted token
beats the runner-up by more than 1e-3 in the port engine's own logits):

- ``decode_path="standard"`` on the tiny model, staggered submissions
  (ragged offsets) and a pool small enough to force recompute
  preemption, with the bf16/f32 pool and the int8 pool;
- ``decode_path="fused"`` with ``quant_weights=True`` on a 2L/256d model:
  equal prompts admitted together decode in lockstep, so every pure-decode
  step runs the fused kernel's program (on the CPU its plain version: the
  calls are counted and equal the lockstep steps); a staggered run drops
  its ragged decode steps to the standard program within the same run.

The fused and standard paths differ in numerics (the kernel's residual
stays f32 and it quantizes the GELU output per chunk), so each is held
against its own JAX counterpart, never against the other.
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
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.ops import decode_stack as ds
from tnn_tpu_torch.serving import engine as engine_mod
from tnn_tpu_torch.serving import step_build
from tnn_tpu_torch.serving.engine import InferenceEngine

TINY = dict(vocab_size=128, max_len=64, num_layers=2, d_model=32,
            num_heads=2)
ENGINE = dict(num_blocks=14, block_size=4, max_batch_size=4, chunk_size=8)
SMALL = dict(vocab_size=512, max_len=64, num_layers=2, d_model=256,
             num_heads=4)
FUSED = dict(num_blocks=16, block_size=8, max_batch_size=2, chunk_size=8,
             quant_weights=True)
MARGIN = 1e-3


def _pair(cfg):
    jm = JGPT2(**cfg, policy=jdt.FP32)
    params = jm.init(jax.random.PRNGKey(0), (1, 8))["params"]
    tm = GPT2(**cfg, policy=tdt.FP32, device="cpu", seed=None)
    tm.load_jax_params(jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.fixture(scope="module")
def tiny():
    return _pair(TINY)


@pytest.fixture(scope="module")
def small():
    return _pair(SMALL)


class RecordingEngine(InferenceEngine):
    """Keeps every emitted greedy token's top-2 logit gap and checks that
    the token is its row's argmax."""

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
            row = self._logits[self._rows.index(rid)]
            top2 = row.topk(2).values
            assert int(row.argmax()) == tok
            self.gaps.append(float(top2[0] - top2[1]))
        return events


def _serve(eng, prompts, new, stagger=0):
    """Submit the prompts, ``stagger`` engine steps apart; drain."""
    rids = []
    for p in prompts:
        rids.append(eng.submit(p, new))
        for _ in range(stagger):
            eng.step()
    out = eng.run_until_complete()
    return [out[r] for r in rids]


def _prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_standard_path_token_exact_vs_jax(tiny, kv_dtype):
    jm, params, tm = tiny
    prompts = _prompts(2, (5, 13, 22, 9, 17, 30), 128)
    want = _serve(JEngine(jm, params, prefix_cache=False,
                          decode_path="standard", kv_dtype=kv_dtype,
                          **ENGINE), prompts, 10, stagger=1)
    eng = RecordingEngine(tm, device="cpu", decode_path="standard",
                          kv_dtype=kv_dtype, **ENGINE)
    assert _serve(eng, prompts, 10, stagger=1) == want
    assert min(eng.gaps) > MARGIN, min(eng.gaps)
    stats = eng.stats()
    assert stats["decode_path"] == "standard" and stats["preemptions"] > 0
    assert set(stats["program_steps"]) == {"mixed_standard", "decode"}
    assert eng.paged_fallback_reason == "disabled (decode_path='standard')"
    assert eng.fused_fallback_reason == "disabled (decode_path='standard')"
    eng.check_invariants()
    assert eng.pool.num_allocated == 0


def _count_fused(monkeypatch):
    calls = []
    real = engine_mod.fused_decode_stack

    def counted(*a, **kw):
        calls.append(a[1])
        return real(*a, **kw)

    monkeypatch.setattr(engine_mod, "fused_decode_stack", counted)
    return calls


@pytest.mark.parametrize("stagger", [0, 2], ids=["lockstep", "staggered"])
def test_fused_path_token_exact_vs_jax(small, monkeypatch, stagger):
    jm, params, tm = small
    prompts = _prompts(1, (12, 12), 512)
    want = _serve(JEngine(jm, params, prefix_cache=False,
                          decode_path="fused", **FUSED), prompts, 6,
                  stagger=stagger)
    calls = _count_fused(monkeypatch)
    eng = RecordingEngine(tm, device="cpu", decode_path="fused", **FUSED)
    assert _serve(eng, prompts, 6, stagger=stagger) == want
    assert min(eng.gaps) > MARGIN, min(eng.gaps)
    steps = eng.stats()["program_steps"]
    assert eng.stats()["decode_path"] == "fused"
    assert len(calls) == steps["fdecode"] > 0
    assert ds.fused_decode_stack.launches == 0     # CPU: the plain version
    if stagger:
        assert steps["decode"] > 0     # ragged steps ran standard
    else:
        assert "decode" not in steps
    assert eng._fused["chunks"] == 1 and eng.assembly_len == 64
    eng.check_invariants()
    assert eng.pool.num_allocated == 0


def test_pack_decode_lockstep_and_program_keys():
    class Req:
        def __init__(self, cache_len):
            self.cache_len, self.next_token = cache_len, 7
            self.block_table = [3]
            self.temperature = self.top_p = 0.0
            self.top_k = 0

    same = [Req(5), Req(5)]
    kw = dict(b=4, nb=2, scratch=0)
    step = step_build.pack_decode(same, paged=False, fused_available=True,
                                  **kw)
    assert step.lockstep and step.program == "fdecode"
    assert step.offsets.tolist() == [5, 5, 5, 5]   # padded rows share it
    step = step_build.pack_decode([Req(5), Req(6)], paged=False,
                                  fused_available=True, **kw)
    assert not step.lockstep and step.program == "decode"
    assert step.offsets.tolist() == [5, 6, 0, 0]
    step = step_build.pack_decode(same, paged=False, fused_available=False,
                                  **kw)
    assert step.program == "decode"
    step = step_build.pack_decode(same, paged=True, fused_available=True,
                                  **kw)
    assert not step.lockstep and step.program == "pdecode"


def test_decode_path_selection_and_refusals(tiny, small):
    _, _, tm = tiny
    eng = InferenceEngine(tm, device="cpu", **ENGINE)
    assert eng.stats()["decode_path"] == "paged"
    assert eng.paged_fallback_reason is None
    assert eng.fused_fallback_reason == "unused (paged decode path selected)"
    eng = InferenceEngine(tm, device="cpu", decode_path="paged", **ENGINE)
    assert eng.stats()["decode_path"] == "paged"
    with pytest.raises(ValueError, match="decode_path"):
        InferenceEngine(tm, device="cpu", decode_path="ragged", **ENGINE)
    _, _, sm = small
    with pytest.raises(ValueError, match="int8 pools"):
        InferenceEngine(sm, device="cpu", decode_path="fused",
                        kv_dtype="int8", **FUSED)
    with pytest.raises(ValueError, match="int8 params"):
        InferenceEngine(sm, device="cpu", decode_path="fused",
                        **{**FUSED, "quant_weights": False})
    # B = 4 at a 1024-token assembly: the reference's budget refuses
    big = GPT2(vocab_size=512, max_len=1024, num_layers=1, d_model=768,
               num_heads=12, device="cpu")
    with pytest.raises(ValueError, match="budget"):
        InferenceEngine(big, device="cpu", decode_path="fused",
                        quant_weights=True, num_blocks=65, block_size=16,
                        max_batch_size=4)


def test_cli_serves_fused_on_cpu():
    lines = [{"id": "a", "tokens": [1, 2, 3, 4], "max_new_tokens": 3},
             {"id": "b", "tokens": [5, 6, 7, 8], "max_new_tokens": 3}]
    proc = subprocess.run(
        [sys.executable, "-m", "tnn_tpu_torch.cli.serve", "--model",
         "gpt2_tiny", "--device", "cpu", "--num-blocks", "16",
         "--max-batch-size", "2", "--quant-weights", "--decode-path",
         "fused"],
        input="".join(json.dumps(x) + "\n" for x in lines),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    events = [json.loads(x) for x in proc.stdout.splitlines()]
    done = {e["id"]: e for e in events if e["event"] == "done"}
    assert set(done) == {"a", "b"} and len(done["a"]["tokens"]) == 3
    summary = json.loads(proc.stderr.split("serve summary: ")[1])
    assert summary["decode_path"] == "fused"
    assert summary["program_steps"]["fdecode"] > 0


def test_k8_geometry_refusals_are_one_function(small):
    """K8's static limits live in ``check_kernel_geometry``, which the
    kernel's launch and the engine's fused-path probe (on CUDA) both
    call. 17 rows at gpt2_small's width pass the reference's chunk rule
    (``pick_chunks(768, 3072, 17, 128)`` = 8) but not the kernel."""
    from tnn_tpu_torch.models import fused_decode
    from tnn_tpu_torch.ops.decode_stack import check_kernel_geometry

    chunks = fused_decode.pick_chunks(768, 3072, 17, 128)
    assert chunks == 8
    bf16 = torch.bfloat16
    with pytest.raises(ValueError, match="at most 16 rows; got 17"):
        check_kernel_geometry(17, 768, 3072, chunks, 64, bf16)
    assert check_kernel_geometry(16, 768, 3072, chunks, 64, bf16) \
        <= 227 * 1024
    with pytest.raises(ValueError, match="multiples of 16"):
        check_kernel_geometry(2, 776, 3072, 8, 8, bf16)
    with pytest.raises(ValueError, match="head dim"):
        check_kernel_geometry(2, 768, 3072, 8, 48, bf16)
    # the cache length no longer bounds shared memory (attention's splits
    # hold at most MAX_SPLIT_LEN scores); 16 rows of a 2560-wide model do:
    # their LayerNorm staging and GELU codes leave no room for the ring
    with pytest.raises(ValueError, match="shared memory"):
        check_kernel_geometry(16, 2560, 10240, 8, 64, bf16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        check_kernel_geometry(2, 768, 3072, 8, 64, torch.float16)
    # on the CPU the plain version serves any geometry, as JAX's does
    _, _, sm = small
    eng = InferenceEngine(sm, device="cpu", decode_path="fused",
                          **{**FUSED, "max_batch_size": 17})
    assert eng._fused is not None and eng.fused_fallback_reason is None


@pytest.mark.cuda
def test_fused_probe_refuses_k8_geometry_at_construction_on_card(
        monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("the probe checks K8's limits only on a card")
    model = GPT2(vocab_size=512, max_len=128, num_layers=1, d_model=768,
                 num_heads=12, device="cuda")
    kw = dict(quant_weights=True, max_batch_size=17, num_blocks=9,
              block_size=16, device="cuda")
    with pytest.raises(ValueError, match="at most 16 rows"):
        InferenceEngine(model, decode_path="fused", **kw)

    def no_paged(self):
        raise ValueError("paged path off for this test")

    monkeypatch.setattr(InferenceEngine, "_probe_paged", no_paged)
    eng = InferenceEngine(model, decode_path="auto", **kw)
    assert eng._fused is None
    assert "at most 16 rows" in eng.fused_fallback_reason
    assert eng.stats()["decode_path"] == "standard"
