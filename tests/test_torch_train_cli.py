"""Port parity: the LM training entry points.

``cli.prepare_corpus`` (byte mode) writes the same files as the JAX
package's; ``cli.train_gpt2 --device cpu`` runs a few tiny steps through
the flash backend, for GPT-2 and for ``--arch llama``, and writes the
results JSON with the JAX CLI's fields;
``generate`` (greedy, KV cache, the flash kernel's ``kv_offset`` form)
gives the JAX package's tokens on the same weights under FP32, where both
sides compute in float32 and greedy argmax is exact.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnn_tpu.cli import prepare_corpus as jprep
from tnn_tpu.core import dtypes as jdt
from tnn_tpu.models.gpt2 import GPT2 as JGPT2
from tnn_tpu.models.gpt2 import generate as jgenerate
from tnn_tpu_torch.cli import prepare_corpus, train_gpt2
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.models.gpt2 import GPT2, generate
from tnn_tpu_torch.ops import flash_attention as fa

JAX_CLI_FIELDS = {"metric", "backend", "platform", "model", "steps",
                  "steps_per_call", "train_tok_per_s", "final_train_loss",
                  "final_train_ppl", "curve", "val_loss", "val_ppl",
                  "decode_tok_per_s", "sample"}


@pytest.fixture
def sources(tmp_path):
    src = tmp_path / "src"
    (src / "pkg").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(4):
        text = "".join(chr(c) for c in rng.integers(32, 127, 3000))
        (src / "pkg" / f"m{i}.py").write_text(f"def f{i}():\n    {text}\n")
    (src / "notes.txt").write_text("not matched by the glob")
    return src


def test_prepare_corpus_byte_mode_matches_jax(sources, tmp_path, capsys):
    args = ["--source", str(sources), "--val-fraction", "0.1"]
    jprep.main(["--out", str(tmp_path / "jax")] + args)
    meta = prepare_corpus.main(["--out", str(tmp_path / "port")] + args)
    for name in ("train.bin", "val.bin", "meta.json"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    assert meta["vocab_size"] == 257 and meta["files"] == 4
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        prepare_corpus.main(["--out", str(tmp_path / "b"), "--mode", "bpe",
                             "--source", str(sources)])


def test_train_gpt2_cli_on_cpu(sources, tmp_path):
    corpus, results = tmp_path / "corpus", tmp_path / "results"
    prepare_corpus.main(["--out", str(corpus), "--source", str(sources),
                         "--val-fraction", "0.2"])
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches)
    out = train_gpt2.main([
        "--tokens", str(corpus), "--steps", "5", "--steps-per-call", "2",
        "--batch", "2", "--seq", "32", "--layers", "2", "--d-model", "64",
        "--heads", "2", "--kv-heads", "1", "--backend", "pallas",
        "--sample", "12", "--device", "cpu", "--results", str(results)])
    saved = json.loads((results / "lm_gpt2_byte_pallas.json").read_text())
    assert saved == out and set(out) == JAX_CLI_FIELDS
    assert out["platform"] == "cpu" and out["steps"] == 5
    assert [c["step"] for c in out["curve"]] == [1, 4]   # first, last
    assert all(np.isfinite(c["loss"]) for c in out["curve"])
    assert np.isfinite(out["val_loss"]) and isinstance(out["sample"], str)
    # CPU tensors run the plain versions: nothing launched
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd.launches) == before
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_gpt2.main(["--tokens", str(corpus), "--fused-head-loss", "64",
                         "--device", "cpu"])


def test_train_llama_cli_on_cpu(sources, tmp_path, monkeypatch):
    """``--arch llama`` trains a few CPU steps through the flash backend,
    its backward on the split path (forced: the tiny sequence is far below
    the rule's length), samples in byte mode and writes its results."""
    corpus, results = tmp_path / "corpus", tmp_path / "results"
    prepare_corpus.main(["--out", str(corpus), "--source", str(sources),
                         "--val-fraction", "0.2"])
    monkeypatch.setenv("TNN_FLASH_FUSED_BWD", "0")
    calls = []
    real = fa.flash_attention_bwd_dq
    monkeypatch.setattr(fa, "flash_attention_bwd_dq",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    out = train_gpt2.main([
        "--tokens", str(corpus), "--arch", "llama", "--steps", "3",
        "--batch", "2", "--seq", "32", "--layers", "2", "--d-model", "64",
        "--heads", "4", "--kv-heads", "2", "--backend", "pallas",
        "--sample", "8", "--device", "cpu", "--results", str(results)])
    saved = json.loads((results / "lm_llama_byte_pallas.json").read_text())
    assert saved == out and set(out) == JAX_CLI_FIELDS
    assert out["metric"] == "llama_bytes_lm" and out["platform"] == "cpu"
    assert out["steps"] == 3 and len(calls) == 2 * 3   # layers x steps
    assert all(np.isfinite(c["loss"]) for c in out["curve"])
    assert np.isfinite(out["val_loss"]) and isinstance(out["sample"], str)


@pytest.mark.parametrize("kv_heads", [None, 1], ids=["mha", "gqa"])
def test_generate_greedy_matches_jax(kv_heads):
    kw = dict(vocab_size=257, max_len=32, num_layers=2, d_model=64,
              num_heads=2, num_kv_heads=kv_heads, backend="pallas")
    jm = JGPT2(**kw, policy=jdt.FP32)
    params = jm.init(jax.random.PRNGKey(3), (1, 8))["params"]
    tm = GPT2(**kw, policy=tdt.FP32, device="cpu", seed=None)
    tm.load_jax_params(jax.tree.map(np.asarray, params))
    prompt = np.random.default_rng(1).integers(0, 257, (2, 9)).astype(np.int32)
    ref = np.asarray(jgenerate(jm, params, jnp.asarray(prompt), 10,
                               max_len=24))
    got = generate(tm, torch.from_numpy(prompt), 10, max_len=24)
    assert got.dtype == torch.int64 and tuple(got.shape) == (2, 10)
    np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(ValueError, match="exceeds max_len"):
        generate(tm, torch.from_numpy(prompt), 20, max_len=24)
