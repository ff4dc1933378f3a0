"""Port parity: the seven transformer-family layer types as registered
``Sequential`` children, ``nn.graph`` and the ``LayerBuilder`` DSL
(``tnn_tpu_torch.nn``).

Each model is built by both packages under FP32 at a tiny size; the
port's is sized by ``init`` and gets the JAX model's parameters and state
(``load_jax_params`` / ``load_jax_state``). Forward outputs agree to
``TOL`` of their magnitude, the builders' running ``shape``s and the
parameter trees' keys exactly, configs exactly, and ``.tnn`` model files
written by either package are read by the other. "pallas" layers run the
JAX flash kernel in interpret mode and the port's plain versions of K4 /
K7 on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnn_tpu import checkpoint as jckpt
from tnn_tpu import nn as jnn
from tnn_tpu.core import dtypes as jdt
from tnn_tpu.core.module import module_from_config as jfrom_config
from tnn_tpu.models.llama import LlamaBlock as JLlamaBlock
from tnn_tpu.nn.builder import LayerBuilder as JBuilder
from tnn_tpu_torch import checkpoint as tckpt
from tnn_tpu_torch import nn as tnn
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.core.module import config_module
from tnn_tpu_torch.nn.builder import LayerBuilder as TBuilder

TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _keys(tree, prefix=()):
    if isinstance(tree, dict):
        return sorted(k for key, v in tree.items()
                      for k in _keys(v, prefix + (key,)))
    return [prefix]


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= tol * scale, \
        float(np.abs(got - want).max()) / scale


def _pair(jmodel, sample_shape, seed=0, int_input=None):
    """The JAX model's variables and the port model carrying them."""
    batch = (2,) + tuple(sample_shape)
    if int_input is not None:
        v = jmodel.init(jax.random.PRNGKey(seed), batch,
                        input_dtype=jnp.int32)
    else:
        v = jmodel.init(jax.random.PRNGKey(seed), batch)
    tmodel = config_module(jmodel.get_config())
    tmodel.init(sample_shape, device="cpu", seed=None)
    tmodel.load_jax_params(_np(v["params"]))
    if v["state"]:
        tmodel.load_jax_state(_np(v["state"]))
    return v, tmodel


def _inputs(sample_shape, seed=1, vocab=None):
    rng = np.random.default_rng(seed)
    if vocab is not None:
        return rng.integers(0, vocab, (2,) + tuple(sample_shape)) \
            .astype(np.int32)
    return rng.normal(size=(2,) + tuple(sample_shape)).astype(np.float32)


def _forward_pair(jmodel, sample_shape, vocab=None, train=False):
    v, tmodel = _pair(jmodel, sample_shape, int_input=vocab)
    x = _inputs(sample_shape, vocab=vocab)
    want, new_state = jmodel.apply(v, jnp.asarray(x), train=train)
    gen = torch.Generator().manual_seed(0)
    got = tmodel(torch.from_numpy(x).long() if vocab else
                 torch.from_numpy(x), train=train, generator=gen)
    return v, tmodel, got, want, new_state


# -- the seven layer types ------------------------------------------------

F32 = jdt.FP32


def _layer_models():
    """(name, JAX Sequential over the layer, sample shape, vocab)."""
    return {
        "multihead_attention": (jnn.Sequential([jnn.MultiHeadAttention(
            4, causal=True, num_kv_heads=2, policy=F32)], policy=F32),
            (6, 16), None),
        "flash_attention": (jnn.Sequential([jnn.MultiHeadAttention(
            2, causal=False, backend="pallas", policy=F32)], policy=F32),
            (8, 16), None),
        "gpt_block": (jnn.Sequential([jnn.GPTBlock(
            2, mlp_ratio=2, policy=F32)], policy=F32), (6, 16), None),
        "encoder_block": (jnn.Sequential([jnn.EncoderBlock(
            2, policy=F32)], policy=F32), (6, 16), None),
        "llama_block": (jnn.Sequential([JLlamaBlock(
            4, 24, num_kv_heads=2, policy=F32)], policy=F32), (6, 16),
            None),
        "embedding_rmsnorm": (jnn.Sequential([
            jnn.Embedding(40, 16, policy=F32), jnn.RMSNorm(policy=F32)],
            policy=F32), (6,), 40),
        "moe": (jnn.Sequential([jnn.MoE(4, top_k=2, policy=F32)],
                               policy=F32), (6, 16), None),
        "moe_gpt_block": (jnn.Sequential([jnn.GPTBlock(
            2, moe_experts=4, policy=F32)], policy=F32), (6, 16), None),
    }


@pytest.mark.parametrize("name", list(_layer_models()))
def test_layer_types_as_sequential_children(name):
    jmodel, shape, vocab = _layer_models()[name]
    v, tmodel, got, want, _ = _forward_pair(jmodel, shape, vocab)
    _close(got, want)
    assert tmodel.get_config() == jmodel.get_config()
    assert _keys(tmodel.jax_param_tree()) == _keys(v["params"])
    assert _keys(tmodel.jax_state_tree()) == _keys(v["state"])


def test_moe_child_state_is_its_aux_loss():
    """A training forward leaves the MoE layer's aux loss in its state, as
    the JAX layer's new state holds it."""
    jmodel, shape, _ = _layer_models()["moe"]
    _, tmodel, _, _, new_state = _forward_pair(jmodel, shape, train=True)
    tmodel.commit_state()
    got = tmodel.jax_state_tree()["00_moe"]["aux_loss"]
    assert abs(float(got) - float(new_state["00_moe"]["aux_loss"])) <= 1e-7


# -- Graph ------------------------------------------------------------------


def _jax_graph():
    return jnn.Graph([
        ("a", jnn.Dense(8, activation="relu", policy=F32), ["x"]),
        ("b", jnn.Dense(8, policy=F32), ["x"]),
        ("sum", jnn.Add(policy=F32), ["a", "b"]),
        ("cat", jnn.Concat(policy=F32), ["sum", "y"]),
        ("head", jnn.Dense(3, policy=F32), ["cat"]),
        ("side", jnn.LayerNorm(policy=F32), ["sum"]),
    ], inputs=["x", "y"], outputs=["head", "side"], policy=F32)


def _graph_pair():
    jg = _jax_graph()
    v = jg.init(jax.random.PRNGKey(0), (2, 5), (2, 4))
    tg = config_module(jg.get_config())
    tg.init([(5,), (4,)], device="cpu", seed=None)
    tg.load_jax_params(_np(v["params"]))
    return jg, v, tg


def test_graph_multi_input_multi_output():
    jg, v, tg = _graph_pair()
    x = _inputs((5,))
    y = _inputs((4,), seed=2)
    (jh, js), _ = jg.apply(v, jnp.asarray(x), jnp.asarray(y))
    th, ts = tg(torch.from_numpy(x), torch.from_numpy(y))
    _close(th, jh)
    _close(ts, js)
    assert tg.output_shape((2, 5), (2, 4)) == jg.output_shape((2, 5),
                                                              (2, 4))
    assert _keys(tg.jax_param_tree()) == _keys(v["params"])
    assert tg.get_config() == jg.get_config()


def test_graph_toposorts_out_of_order_declarations():
    nodes = [("c", "dense3", ["b"]), ("b", "dense8", ["a"]),
             ("a", "dense8", ["input"])]

    def make(pkg, widths):
        d = pkg.Dense

        def dense(units):
            return d(units, policy=F32) if pkg is jnn else \
                d(None, units, policy=tdt.FP32)

        return pkg.Graph([(n, dense(widths[m]), i) for n, m, i in nodes],
                         policy=F32 if pkg is jnn else tdt.FP32)

    widths = {"dense3": 3, "dense8": 8}
    jg, tg = make(jnn, widths), make(tnn, widths)
    assert [n.name for n in tg._order] == [n.name for n in jg._order] \
        == ["a", "b", "c"]
    assert tg.outputs == jg.outputs == ["c"]


@pytest.mark.parametrize("case", ["cycle", "unknown", "duplicate",
                                  "output", "vs_inputs"])
def test_graph_errors_match(case):
    def nodes(pkg, dense):
        return {
            "cycle": [("a", dense(), ["b"]), ("b", dense(), ["a"])],
            "unknown": [("a", dense(), ["nope"])],
            "duplicate": [("a", dense(), ["input"]),
                          ("a", dense(), ["input"])],
            "output": [("a", dense(), ["input"])],
            "vs_inputs": [("input", dense(), ["input"])],
        }[case]

    kw = {"outputs": ["zz"]} if case == "output" else {}
    msgs = []
    for pkg, dense in ((jnn, lambda: jnn.Dense(4, policy=F32)),
                       (tnn, lambda: tnn.Dense(None, 4, policy=tdt.FP32))):
        with pytest.raises(ValueError) as err:
            pkg.Graph(nodes(pkg, dense), **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_graph_trains_like_jax():
    """One SGD step through the graph: the same loss and new weights."""
    from tnn_tpu.train import step as jstep
    from tnn_tpu_torch.nn.optimizers import SGD
    from tnn_tpu_torch.train import step as tstep

    jg = jnn.Graph([("a", jnn.Dense(8, activation="relu", policy=F32),
                     ["input"]),
                    ("b", jnn.Dense(8, policy=F32), ["input"]),
                    ("s", jnn.Add(policy=F32), ["a", "b"]),
                    ("h", jnn.Dense(3, policy=F32), ["s"])], policy=F32)
    jstate = jstep.create_train_state(jg, jnn.SGD(lr=0.1),
                                      jax.random.PRNGKey(0), (4, 5))
    start = _np(jstate.params)
    x = _inputs((5,))
    x = np.concatenate([x, x])
    y = np.array([0, 1, 2, 1], np.int32)
    jstate, jm = jstep.make_train_step(jg, jnn.SGD(lr=0.1), donate=False)(
        jstate, jnp.asarray(x), jnp.asarray(y))
    tg = config_module(jg.get_config()).init((5,), device="cpu", seed=None)
    tg.load_jax_params(start)
    opt = SGD(lr=0.1)
    tstate = tstep.create_train_state(tg, opt)
    tstate, tm = tstep.make_train_step(tg, opt)(
        tstate, torch.from_numpy(x), torch.from_numpy(y).long())
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(
        float(jm["loss"]))
    want = _np(jstate.params)
    for path, p in tg.jax_param_paths():
        ref = want
        for k in path:
            ref = ref[k]
        _close(p, ref, 1e-5)


# -- LayerBuilder ------------------------------------------------------------


def _image_build(B):
    return (B((12, 12, 3), policy=F32 if B is JBuilder else tdt.FP32)
            .conv2d(8, 3).batchnorm().activation("relu")
            .basic_residual_block(8).wide_residual_block(16, strides=2)
            .bottleneck_residual_block(4).groupnorm(groups=4)
            .maxpool(2).conv2d(8, 1, use_bias=False)
            .avgpool(1).dropout(0.2).global_avgpool().dense(5))


def _residual_build(B):
    p = F32 if B is JBuilder else tdt.FP32
    if B is JBuilder:
        main = [jnn.Dense(6, activation="relu", policy=p)]
        short = [jnn.Dense(6, policy=p)]
    else:
        main = [tnn.Dense(None, 6, activation="relu", policy=p)]
        short = [tnn.Dense(None, 6, policy=p)]
    return (B((4, 5), policy=p).dense(6).residual(main, short,
                                                  activation="relu")
            .flatten().reshape((4, 6)).transpose((1, 0))
            .slice(1, 1, 3).layernorm().rmsnorm().dense(2))


def _token_build(B):
    return (B((8,), policy=F32 if B is JBuilder else tdt.FP32)
            .embedding(50, 16).positional_embedding()
            .gpt_block(2, mlp_ratio=2).flash_gpt_block(2)
            .attention(4, causal=True).flash_attention(2, causal=True)
            .encoder_block(2).llama_block(4, 24, num_kv_heads=2)
            .layernorm().dense(50))


def _vit_build(B):
    return (B((16, 16, 3), policy=F32 if B is JBuilder else tdt.FP32)
            .conv2d(16, 8, strides=8, padding="valid")
            .reshape((4, 16)).class_token().positional_embedding()
            .encoder_block(2).slice(1, 0, 1).flatten().dense(10))


BUILDS = {"image": (_image_build, (12, 12, 3), None),
          "residual": (_residual_build, (4, 5), None),
          "tokens": (_token_build, (8,), 50),
          "vit": (_vit_build, (16, 16, 3), None)}


@pytest.mark.parametrize("name", list(BUILDS))
def test_builder_matches_jax(name):
    build, shape, vocab = BUILDS[name]
    jb, tb = build(JBuilder), build(TBuilder)
    assert tb.shape == jb.shape
    jmodel = jb.build(name="m")
    tmodel = tb.build(name="m")
    assert tmodel.get_config() == jmodel.get_config()
    v, tport, got, want, _ = _forward_pair(jmodel, shape, vocab)
    _close(got, want)
    tmodel.init(shape, device="cpu", seed=0)
    assert _keys(tmodel.jax_param_tree()) == _keys(v["params"])
    assert _keys(tmodel.jax_state_tree()) == _keys(v["state"])


def test_builder_flash_methods_select_pallas():
    b = TBuilder((8, 16)).flash_attention(2).flash_gpt_block(2)
    seq = b.build()
    assert [c.backend for c in seq.layers] == ["pallas", "pallas"]
    assert b.shape == (8, 16)


# -- .tnn files both ways -------------------------------------------------


def _file_models():
    moe_seq = jnn.Sequential([
        jnn.Embedding(40, 16, policy=F32), jnn.GPTBlock(2, policy=F32),
        JLlamaBlock(4, 24, policy=F32), jnn.MoE(4, policy=F32),
        jnn.GPTBlock(2, moe_experts=2, policy=F32),
        jnn.RMSNorm(policy=F32), jnn.Dense(40, policy=F32)], policy=F32)
    return {"lm_sequential": (moe_seq, (6,), 40),
            "graph": (_jax_graph(), None, None)}


@pytest.mark.parametrize("name", ["lm_sequential", "graph"])
def test_model_files_both_ways(name, tmp_path):
    jmodel, shape, vocab = _file_models()[name]
    if name == "graph":
        _, v, tmodel = _graph_pair()
        v = {"params": v["params"], "state": {}}
        sizing = [(5,), (4,)]
    else:
        v, tmodel = _pair(jmodel, shape, int_input=vocab)
        sizing = shape
    # JAX writes, the port reads
    jpath = str(tmp_path / "jax.tnn")
    jckpt.save_model(jpath, jmodel, v["params"], v["state"] or None)
    loaded = tckpt.load_model(jpath, device="cpu", input_shape=sizing)
    assert loaded.get_config() == jmodel.get_config()
    for (pa, a), (pb, b) in zip(loaded.jax_param_paths(),
                                tmodel.jax_param_paths()):
        assert pa == pb and torch.equal(a, b)
    # the port writes, JAX reads
    tpath = str(tmp_path / "port.tnn")
    tckpt.save_model(tpath, tmodel)
    jm2, flat = jckpt.load_model(tpath)
    assert jm2.get_config() == jmodel.get_config()
    want = jax.tree_util.tree_flatten_with_path(_np(v["params"]))[0]
    for path, leaf in want:
        node = flat["params"]
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(np.asarray(node), leaf)
    assert jfrom_config(tmodel.get_config()).get_config() == \
        jmodel.get_config()
