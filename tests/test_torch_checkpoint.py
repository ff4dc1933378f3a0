"""Port parity: the ``.tnn`` model file (``tnn_tpu_torch.checkpoint``) and
the config round trip (``tnn_tpu_torch.core.module``).

Files cross both ways: one written by the JAX package's ``save_model``
loads in the port (the model rebuilt from its config, its weights bit for
bit), and one written by the port loads in JAX. Under ``FP32`` the
loaded model's logits are held against the JAX model's at 1e-5 of the
largest logit; a bf16-policy file is held through its weights (equal bit
for bit) and its config, which keeps the JAX forward (bf16 dots) off this
CPU. Re-saving a JAX file from the port gives the same bytes. The refusals
(a bad magic, a key or shape mismatch, an ``Int8Weight`` leaf, an MoE or
int8-cache config) raise.
"""
import jax
import numpy as np
import pytest
import torch

from tnn_tpu import checkpoint as jck
from tnn_tpu.core import dtypes as jdt
from tnn_tpu.models.gpt2 import GPT2 as JGPT2
from tnn_tpu.models.llama import Llama as JLlama
from tnn_tpu_torch import checkpoint as ck
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.core.module import module_from_config
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.models.llama import Llama
from tnn_tpu_torch.nn.quant import quantize_for_decode

GPT_TINY = dict(vocab_size=128, max_len=32, num_layers=2, d_model=32,
                num_heads=2)
LLAMA_TINY = dict(vocab_size=128, max_len=32, num_layers=2, d_model=32,
                  num_heads=4, num_kv_heads=2)
POLICIES = {"fp32": (jdt.FP32, tdt.FP32),
            "bf16": (jdt.MIXED_BF16, tdt.MIXED_BF16)}


def _jax_model(arch, policy, **extra):
    cls, kw = (JGPT2, GPT_TINY) if arch == "gpt2" else (JLlama, LLAMA_TINY)
    model = cls(**kw, **extra, policy=policy)
    params = model.init(jax.random.PRNGKey(3), (1, 8))["params"]
    return model, params


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _ids():
    return np.random.default_rng(4).integers(0, 128, (2, 12)).astype(
        np.int32)


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("arch", ["gpt2", "llama"])
def test_jax_file_loads_in_the_port(tmp_path, arch, policy):
    jpol, tpol = POLICIES[policy]
    jm, params = _jax_model(arch, jpol)
    path = str(tmp_path / "m.tnn")
    jck.save_model(path, jm, params)
    tm = ck.load_model(path, device="cpu")
    assert type(tm) is (GPT2 if arch == "gpt2" else Llama)
    assert tm.get_config() == jm.get_config()
    assert tm.policy == tpol
    mine = dict(_leaves(tm.jax_param_tree()))
    ref = dict(_leaves(jax.tree.map(np.asarray, params)))
    assert mine.keys() == ref.keys()
    for k in ref:
        assert np.array_equal(mine[k], ref[k]), k
    # the loaded model is the model the parity path builds
    built = module_from_config(jm.get_config(), device="cpu")
    built.load_jax_params(jax.tree.map(np.asarray, params))
    ids = torch.from_numpy(_ids()).long()
    with torch.no_grad():
        got = tm(ids).float()
        assert torch.equal(got, built(ids).float())
    if policy == "fp32":
        want = np.asarray(jm({"params": params}, _ids()), np.float32)
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max(), err


@pytest.mark.parametrize("arch", ["gpt2", "llama"])
def test_port_file_loads_in_jax_and_rewrites_byte_for_byte(tmp_path, arch):
    jm, params = _jax_model(arch, jdt.FP32)
    jpath = str(tmp_path / "jax.tnn")
    jck.save_model(jpath, jm, params)
    tm = ck.load_model(jpath, device="cpu")
    ppath = str(tmp_path / "port.tnn")
    ck.save_model(ppath, tm)
    assert open(ppath, "rb").read() == open(jpath, "rb").read()
    # a port model with its own weights: JAX reads them back unchanged
    own = (GPT2(**GPT_TINY, policy=tdt.FP32, device="cpu", seed=9)
           if arch == "gpt2" else
           Llama(**LLAMA_TINY, policy=tdt.FP32, device="cpu", seed=9))
    ck.save_model(ppath, own)
    jm2, variables = jck.load_model(ppath)
    assert jm2.get_config() == own.get_config()
    ref = dict(_leaves(own.jax_param_tree()))
    got = dict(_leaves(variables["params"]))
    assert got.keys() == ref.keys()
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k
    want = np.asarray(jm2({"params": variables["params"]}, _ids()))
    with torch.no_grad():
        mine = own(torch.from_numpy(_ids()).long()).numpy()
    assert np.abs(mine - want).max() <= 1e-5 * np.abs(want).max()


def test_tensor_file_entries_and_bfloat16_match_jax(tmp_path):
    """``save_tensors`` / ``read_tensor_file`` against JAX's on a tree of
    several dtypes, bfloat16 included (read without ml_dtypes)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    tree = {"b": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                  "i": np.arange(6, dtype=np.int32).reshape(2, 3)},
            "a": {"h": np.asarray(jnp.asarray(rng.normal(size=(5,)),
                                              jnp.bfloat16)),
                  "q": rng.integers(-127, 127, (2, 2)).astype(np.int8)},
            "s": np.float32(2.5)}
    jpath, ppath = str(tmp_path / "j.tnn"), str(tmp_path / "p.tnn")
    jck.save_tensors(jpath, {"x": tree}, meta={"k": 1})
    flat, meta = ck.read_tensor_file(jpath)
    ref, jmeta = jck.read_tensor_file(jpath)
    assert meta == jmeta == {"k": 1} and list(flat) == list(ref)
    for k, arr in ref.items():
        got = flat[k]
        assert tuple(got.shape) == arr.shape, k
        if str(arr.dtype) == "bfloat16":
            assert got.dtype == torch.bfloat16
            assert np.array_equal(got.float().numpy(),
                                  np.asarray(arr, np.float32))
        else:
            assert np.array_equal(got.numpy(), arr), k
    # the port writes the tensors it read back to the same bytes
    ck.save_tensors(ppath, {"x": {"a": {"h": flat["x/a/h"],
                                        "q": flat["x/a/q"]},
                                  "b": {"i": flat["x/b/i"],
                                        "w": flat["x/b/w"]},
                                  "s": flat["x/s"]}}, meta={"k": 1})
    assert open(ppath, "rb").read() == open(jpath, "rb").read()


def test_refusals(tmp_path):
    tm = GPT2(**GPT_TINY, device="cpu", seed=1)
    good = str(tmp_path / "good.tnn")
    ck.save_model(good, tm)
    bad = tmp_path / "bad.tnn"
    bad.write_bytes(b"NOTATNN\n" + open(good, "rb").read()[8:])
    with pytest.raises(ValueError, match="not a TNNTPU tensor file"):
        ck.load_model(str(bad), device="cpu")
    tree = tm.jax_param_tree()
    del tree["h1"]["fc"]["bias"]
    missing = str(tmp_path / "missing.tnn")
    ck.save_tensors(missing, {"params": tree},
                    meta={"model_config": tm.get_config()})
    with pytest.raises(KeyError, match="missing=.*h1/fc/bias"):
        ck.load_model(missing, device="cpu")
    tree = tm.jax_param_tree()
    tree["h0"]["fc"]["bias"] = np.zeros(3, np.float32)
    shaped = str(tmp_path / "shaped.tnn")
    ck.save_tensors(shaped, {"params": tree},
                    meta={"model_config": tm.get_config()})
    with pytest.raises(ValueError, match="shape"):
        ck.load_model(shaped, device="cpu")
    wide = GPT2(vocab_size=256, max_len=16, num_layers=1, d_model=128,
                num_heads=2, device="cpu", seed=0)
    with pytest.raises(ValueError, match="Int8Weight"):
        ck.save_model(str(tmp_path / "q.tnn"), quantize_for_decode(wide))
    # ported since: an untied head loads, its config that of JAX's model
    # (tests/test_torch_moe.py holds its logits against JAX)
    jm, params = _jax_model("gpt2", jdt.FP32, tie_embeddings=False)
    untied = str(tmp_path / "untied.tnn")
    jck.save_model(untied, jm, params)
    model = ck.load_model(untied, device="cpu")
    assert model.get_config() == jm.get_config()
    assert np.array_equal(model.head.kernel.detach().numpy(),
                          np.asarray(params["head"]["kernel"]))


@pytest.mark.parametrize("extra,item", [(dict(moe_experts=2), "item 11"),
                                        (dict(kv_cache_dtype="int8"),
                                         "item 4")])
def test_unported_configs_refuse_to_load(tmp_path, extra, item):
    jm, params = _jax_model("gpt2", jdt.FP32, **extra)
    path = str(tmp_path / "m.tnn")
    jck.save_model(path, jm, params)
    # both ported since: each loads, its config that of JAX's model (the
    # int8 cache is held against JAX in tests/test_torch_attention_int8_
    # rope.py, the MoE blocks in tests/test_torch_moe.py)
    model = ck.load_model(path, device="cpu")
    assert model.get_config() == jm.get_config()
    if item == "item 4":
        assert model.blocks[0].attn.kv_cache_dtype == "int8"
    else:
        assert all(blk.moe is not None and blk.moe.num_experts == 2
                   for blk in model.blocks)


def test_load_model_places_weights_on_the_default_card(tmp_path):
    """``load_model`` defaults to "cuda": without a card it raises before
    it builds anything (on one, every weight lands there)."""
    path = str(tmp_path / "m.tnn")
    ck.save_model(path, GPT2(**GPT_TINY, device="cpu", seed=2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            ck.load_model(path)
        return
    model = ck.load_model(path)
    assert all(p.device.type == "cuda" for p in model.parameters())
