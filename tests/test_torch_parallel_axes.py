"""Port parity: tensor ("model"), sequence ("seq", ring and Ulysses) and
expert parallelism, MoE under data parallelism and FSDP's parameter
sharding (``tnn_tpu_torch.parallel``), against the JAX package on its 8
virtual CPU devices; the port's mesh is 8 ``"cpu"`` positions. Inputs
come from numpy seeds, every model runs under FP32.

- Ring attention against JAX's plain local attention, causal and not, 1
  and GQA 4 q / 2 kv heads: outputs and dQ / dK / dV within JAX's rtol
  1e-4 / atol 1e-5.
- Ulysses against local, its gradients against the ring's, its three
  refusals; ``ring_context`` routing ``sdpa`` in both methods, and
  ``backend="ring"`` refused outside a context with JAX's two messages.
- ``spec_tree`` equal to JAX's key for key on GPT2, Llama and an MoE GPT2
  (the router gate replicated).
- ``make_dp_train_step`` against JAX's: the conv + BatchNorm net at
  {"data": 4, "model": 2} (no TP leaf: everything replicated), loss and
  parameters after 2 steps within rtol 1e-5 / atol 1e-6.
- JAX's ``test_tp_llama_matches_single_device`` case at {"data": 2,
  "model": 2}: the loss within 1e-5 of JAX's single-device step, the
  port's gradients (one SGD step at lr 1) within rtol 1e-4 / atol 1e-6 of
  ``jax.grad``; each "model" position holds half of every TP leaf.
- Expert parallelism at {"expert": 8} against replicated (JAX's
  ``test_expert_parallel_sharding_matches_replicated`` MoE): loss and
  parameters against JAX's single-device step within 1e-5, each position
  holding one expert.
- An MoE GPT-2 at {"data": 2} and {"data": 2, "expert": 4} against JAX's
  single-device step: loss and aux loss within 1e-5 relative for 2 steps.
- ``lm_head_chunk`` under "model" (a tied GPT-2 at {"model": 2} and
  {"data": 2, "model": 2}, an untied Llama at the latter) against JAX's
  single-device step with the same chunk: losses within 1e-5, each
  leaf's SGD update within 1e-4 of its largest entry.
- JAX's three ``test_config_driven_seq_parallel_gpt`` layouts and
  ``test_config_driven_expert_axis``, each through both packages'
  ``train_model``: the epoch's train loss within 1e-5 relative.
- FSDP's parameter sharding: the bytes each position holds (half of every
  sharded leaf), and losses and parameters bit for bit equal to the
  replicated layout over the same positions ({"data": 4}), whose
  arithmetic the optimizer-state-only FSDP shared.
- A {"data": 2, "model": 2} snapshot resumes in the other package.
- The eval step over sharded logits equals the single-device one; dropout
  0.1 under remat "full" replays its masks bit for bit at data x model x
  seq and under FSDP; ``cli.trainer --seq-parallel-method`` reaches the
  run's config.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnn_tpu import checkpoint as jckpt
from tnn_tpu import models as jmodels
from tnn_tpu import nn as jnn
from tnn_tpu import parallel as jpar
from tnn_tpu.core import dtypes as jdt
from tnn_tpu.data.loader import ArrayDataLoader as JLoader
from tnn_tpu.models.llama import Llama as JLlama
from tnn_tpu.nn.attention import sdpa as jsdpa
from tnn_tpu.train import create_train_state as jcreate
from tnn_tpu.train import make_train_step as jmake_step
from tnn_tpu.train import train_model as jtrain
from tnn_tpu.train.step import aux_loss_sum
from tnn_tpu.utils.config import TrainingConfig as JConfig
from tnn_tpu_torch import parallel as tpar
from tnn_tpu_torch.checkpoint import Checkpoint
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.core.module import config_module
from tnn_tpu_torch.data.loader import ArrayDataLoader
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.models.llama import Llama
from tnn_tpu_torch.nn import attention as tattn
from tnn_tpu_torch.nn import optimizers as topt
from tnn_tpu_torch.train import step as tstep
from tnn_tpu_torch.train import train_model
from tnn_tpu_torch.utils.config import TrainingConfig

F32 = jdt.FP32
CPU8 = ["cpu"] * 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _qkv(seed, b, h, hkv, s, d):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, h, s, d).astype(np.float32),
            rs.randn(b, hkv, s, d).astype(np.float32),
            rs.randn(b, hkv, s, d).astype(np.float32))


def _grads(fn, arrays):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    (out ** 2).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _jgrads(fn, arrays):
    js = [jnp.asarray(a) for a in arrays]
    out = fn(*js)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) ** 2),
                     argnums=(0, 1, 2))(*js)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


# -- ring and Ulysses --------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("heads", [(1, 1), (4, 2)], ids=["mha1", "gqa"])
def test_ring_attention_matches_local(causal, heads):
    arrays = _qkv(2, 1, heads[0], heads[1], 32, 8)
    tmesh = tpar.make_mesh(seq=4, devices=CPU8)
    out, grads = _grads(lambda q, k, v: tpar.ring_attention(
        q, k, v, tmesh, causal=causal), arrays)
    lout, lgrads = _jgrads(lambda q, k, v: jsdpa(q, k, v, causal=causal),
                           arrays)
    _close(out, lout)
    assert grads[1].shape == (1, heads[1], 32, 8)   # dK at H_kv heads
    for g, lg in zip(grads, lgrads):
        _close(g, lg)


def test_ring_attention_batch_axis_and_refusals():
    arrays = _qkv(3, 4, 2, 2, 16, 8)
    tmesh = tpar.make_mesh(data=2, seq=4, devices=CPU8)
    out = tpar.ring_attention(*map(torch.from_numpy, arrays), tmesh,
                              causal=True, batch_axis="data")
    _close(out.numpy(), np.asarray(jsdpa(*map(jnp.asarray, arrays),
                                         causal=True)))
    q = torch.zeros(1, 4, 30, 8)
    with pytest.raises(ValueError, match="not divisible by ring size"):
        tpar.ring_attention(q, q, q, tmesh)
    with pytest.raises(ValueError, match="need H % H_kv == 0"):
        tpar.ring_attention(torch.zeros(1, 3, 32, 8), q[:, :2, :32],
                            q[:, :2, :32], tmesh)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_local_and_ring_grads(causal):
    arrays = _qkv(0, 2, 8, 8, 64, 16)
    tmesh = tpar.make_mesh(seq=8, devices=CPU8)
    out, grads = _grads(lambda q, k, v: tpar.ulysses_attention(
        q, k, v, tmesh, causal=causal), arrays)
    lout = np.asarray(jsdpa(*map(jnp.asarray, arrays), causal=causal))
    _close(out, lout)
    _, rgrads = _grads(lambda q, k, v: tpar.ring_attention(
        q, k, v, tmesh, causal=causal), arrays)
    for g, rg in zip(grads, rgrads):
        _close(g, rg)


def test_ulysses_refusals():
    mesh = tpar.make_mesh(seq=8, devices=CPU8)
    q = torch.zeros(1, 8, 64, 8)
    with pytest.raises(ValueError, match="seq len 60 not divisible"):
        tpar.ulysses_attention(q[:, :, :60], q[:, :, :60], q[:, :, :60],
                               mesh)
    with pytest.raises(ValueError, match="num_heads 4 not divisible"):
        tpar.ulysses_attention(q[:, :4], q[:, :4], q[:, :4], mesh)
    with pytest.raises(ValueError, match="kv heads 4 not divisible"):
        tpar.ulysses_attention(q, q[:, :4], q[:, :4], mesh)


@pytest.mark.parametrize("method", ["ring", "ulysses"])
def test_ring_context_routes_sdpa(method):
    arrays = _qkv(4, 1, 8, 8, 64, 16)
    ref = np.asarray(jsdpa(*map(jnp.asarray, arrays), causal=True))
    tmesh = tpar.make_mesh(seq=8, devices=CPU8)
    with tattn.ring_context(tmesh, method=method):
        out = tattn.sdpa(*map(torch.from_numpy, arrays), causal=True,
                         backend="ring")
    _close(out.numpy(), ref)
    q = torch.from_numpy(arrays[0])
    with pytest.raises(RuntimeError, match="enclosing nn.attention"):
        tattn.sdpa(q, q, q, backend="ring")
    with pytest.raises(RuntimeError, match="does not support mask"):
        tattn.sdpa(q, q, q, backend="ring", kv_offset=0)
    with pytest.raises(ValueError, match="unknown seq-parallel method"):
        tattn.ring_context(tmesh, method="zigzag")


# -- the TP rules ----------------------------------------------------------


def test_spec_tree_matches_jax():
    trees = [
        jmodels.GPT2(vocab_size=64, max_len=16, num_layers=2, d_model=32,
                     num_heads=4, policy=F32),
        JLlama(vocab_size=64, max_len=16, num_layers=2, d_model=32,
               num_heads=4, num_kv_heads=2, policy=F32),
        jmodels.GPT2(vocab_size=64, max_len=16, num_layers=2, d_model=32,
                     num_heads=4, moe_experts=4, policy=F32)]
    from tnn_tpu.nn.moe import ep_rules as jep
    from tnn_tpu_torch.nn.moe import ep_rules as tep

    for jm in trees:
        params = jm.init(jax.random.PRNGKey(0), (1, 16))["params"]
        for jrules, trules in ((None, None), (jep(), tep())):
            want = jpar.tensor_parallel.spec_tree(params, jrules)
            got = tpar.spec_tree(_np(params), trules)
            flat = jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda s: isinstance(
                    s, jax.sharding.PartitionSpec))[0]
            assert len(flat) == len(jax.tree_util.tree_leaves(params))
            for path, spec in flat:
                keys = [k.key for k in path]
                assert _leaf(got, keys) == tuple(spec), keys
                if "moe" in keys and "gate" in keys:
                    assert _leaf(got, keys) == ()
    # a bare tree's top-level gate/kernel stays replicated
    assert tpar.tensor_parallel.spec_for(("gate", "kernel")) == ()
    assert tpar.tensor_parallel.spec_for(("h0", "gate", "kernel")) == (
        None, "model")


# -- make_dp_train_step against JAX's ----------------------------------------


def _jax_dp(jmodel, jopt, axes, x, y, steps=2, **kw):
    floating = np.issubdtype(np.asarray(x).dtype, np.floating)
    jstate = jcreate(jmodel, jopt, jax.random.PRNGKey(0), x.shape,
                     input_dtype=jnp.float32 if floating else None)
    start = _np(jstate.params), _np(jstate.net_state)
    if axes:
        step, place_state, place_batch = jpar.make_dp_train_step(
            jmodel, jopt, jpar.make_mesh(**axes), donate=False, **kw)
        jstate = place_state(jstate)
    else:
        step = jmake_step(jmodel, jopt, donate=False, **kw)

        def place_batch(a, b):
            return a, b
    metrics = []
    for _ in range(steps):
        jstate, m = step(jstate, *place_batch(jnp.asarray(x),
                                              jnp.asarray(y)))
        metrics.append({k: float(v) for k, v in m.items()
                        if np.ndim(v) == 0})
        metrics[-1]["aux_loss"] = float(aux_loss_sum(jstate.net_state))
    return start, jstate, metrics


def _port_dp(model, opt, axes, x, y, steps=2, method="ring", **kw):
    mesh = tpar.make_mesh(**axes, devices=CPU8)
    step, place_state, place_batch = tpar.make_dp_train_step(
        model, opt, mesh, fsdp=axes.get("fsdp", 1) > 1,
        tp=axes.get("model", 1) > 1, ep=axes.get("expert", 1) > 1, **kw)
    state = place_state(tstep.create_train_state(model, opt))
    metrics = []
    with tattn.ring_context(mesh, method=method):
        for _ in range(steps):
            state, m = step(state, *place_batch(x, y))
            metrics.append({k: float(v) for k, v in m.items()
                            if torch.as_tensor(v).ndim == 0})
    return state, metrics


def _params_close(state, jparams, rtol=1e-5, atol=1e-6):
    got = tstep.train_state_trees(state)["params"]
    for path, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        keys = [k.key for k in path]
        np.testing.assert_allclose(_leaf(got, keys).numpy(),
                                   _leaf(jparams, keys), rtol=rtol,
                                   atol=atol, err_msg="/".join(keys))


def _conv():
    return jnn.Sequential([
        jnn.Conv2D(4, 3, padding="same", use_bias=False, policy=F32),
        jnn.BatchNorm(policy=F32), jnn.Activation("relu", policy=F32),
        jnn.GlobalAvgPool(policy=F32), jnn.Dense(10, policy=F32)],
        policy=F32)


def test_conv_model_data4_model2_matches_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(16, 8, 8, 3).astype(np.float32)
    y = rs.randint(0, 10, 16).astype(np.int32)
    jmodel = _conv()
    start, jstate, jm = _jax_dp(jmodel, jnn.SGD(lr=0.1), {"data": 4,
                                                          "model": 2},
                                x, y, tp=True)
    model = config_module(jmodel.get_config())
    model.init((8, 8, 3), device="cpu", seed=None)
    model.load_jax_params(start[0])
    model.load_jax_state(start[1])
    state, tm = _port_dp(model, topt.SGD(lr=0.1), {"data": 4, "model": 2},
                         torch.from_numpy(x), torch.from_numpy(y).long())
    assert state.layout.sharded_names() == []
    for a, b in zip(tm, jm):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
    _params_close(state, _np(jstate.params))


def test_tp_llama_matches_single_device_and_jax_grad():
    kw = dict(vocab_size=64, max_len=16, num_layers=2, d_model=32,
              num_heads=4, num_kv_heads=2)
    jmodel = JLlama(**kw, policy=F32)
    ids = np.random.RandomState(5).randint(0, 64, (4, 16)).astype(np.int32)
    (params, _), _, jm = _jax_dp(jmodel, jnn.SGD(lr=1.0), {}, ids, ids,
                                 steps=1)
    model = Llama(**kw, policy=tdt.FP32, device="cpu", seed=None)
    model.load_jax_params(params)

    def jloss(p):
        logits = jmodel({"params": p, "state": {}}, jnp.asarray(ids))
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        return -jnp.mean(jnp.take_along_axis(
            logp, jnp.asarray(ids)[..., None], -1))

    jgrad = _np(jax.grad(jloss)(jax.tree.map(jnp.asarray, params)))
    state, tm = _port_dp(model, topt.SGD(lr=1.0), {"data": 2, "model": 2},
                         torch.from_numpy(ids).long(),
                         torch.from_numpy(ids).long(), steps=1)
    assert tm[0]["loss"] == pytest.approx(jm[0]["loss"], rel=1e-5)
    after = tstep.train_state_trees(state)["params"]
    for path, _ in jax.tree_util.tree_flatten_with_path(jgrad)[0]:
        keys = [k.key for k in path]
        delta = _leaf(params, keys) - _leaf(after, keys).numpy()
        np.testing.assert_allclose(delta, _leaf(jgrad, keys), rtol=1e-4,
                                   atol=1e-6, err_msg="/".join(keys))
    lay = state.layout
    assert "blocks.0.gate.kernel" in lay.sharded_names()
    for c in lay.coords:
        assert tuple(lay.held[c]["blocks.0.attn.qkv_kernel"].shape) == (
            32, 32)                 # (D, (D + 2 KVD) / 2): 2 q + 1 kv head
        assert tuple(lay.held[c]["wte.table"].shape) == (32, 32)


def test_expert_parallel_matches_replicated():
    moe = jnn.Sequential([jnn.MoE(num_experts=8, hidden=16, top_k=2,
                                  capacity_factor=4.0, policy=F32)],
                         policy=F32)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (2, 16, 8)))
    y = np.random.RandomState(1).randn(2, 16, 8).astype(np.float32)
    start, jstate, jm = _jax_dp(moe, jnn.SGD(lr=0.1), {}, x, y,
                                loss_fn="mse", compute_accuracy=False)
    outs = []
    for axes in ({"expert": 8}, {"data": 1}):
        model = config_module(moe.get_config())
        model.init((16, 8), device="cpu", seed=None)
        model.load_jax_params(start[0])
        state, tm = _port_dp(model, topt.SGD(lr=0.1), axes,
                             torch.from_numpy(x), torch.from_numpy(y),
                             loss_fn="mse", compute_accuracy=False)
        for a, b in zip(tm, jm):
            assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
            assert a["aux_loss"] == pytest.approx(b["aux_loss"], rel=1e-5)
        _params_close(state, _np(jstate.params))
        outs.append(state)
    lay = outs[0].layout
    for c in lay.coords:
        assert tuple(lay.held[c]["layers.0.w_in"].shape) == (1, 8, 16)
        assert tuple(lay.held[c]["layers.0.gate_kernel"].shape) == (8, 8)


@pytest.fixture(scope="module")
def moe_gpt_ref():
    jmodel = jmodels.GPT2(vocab_size=64, max_len=16, num_layers=2,
                          d_model=32, num_heads=4, moe_experts=4,
                          policy=F32)
    ids = np.random.RandomState(3).randint(0, 64, (8, 16)).astype(np.int32)
    labels = np.roll(ids, -1, 1)
    start, _, jm = _jax_dp(jmodel, jnn.AdamW(lr=1e-3), {}, ids, labels,
                           compute_accuracy=False)
    return start, ids, labels, jm


@pytest.mark.parametrize("axes", [{"data": 2}, {"data": 2, "expert": 4}],
                         ids=["data2", "data2_expert4"])
def test_moe_gpt2_under_data_and_expert_matches_jax(moe_gpt_ref, axes):
    start, ids, labels, jm = moe_gpt_ref
    model = GPT2(vocab_size=64, max_len=16, num_layers=2, d_model=32,
                 num_heads=4, moe_experts=4, policy=tdt.FP32, device="cpu",
                 seed=None)
    model.load_jax_params(start[0])
    _, tm = _port_dp(model, topt.AdamW(lr=1e-3), axes,
                     torch.from_numpy(ids).long(),
                     torch.from_numpy(labels).long(),
                     compute_accuracy=False)
    for a, b in zip(tm, jm):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
        assert a["aux_loss"] == pytest.approx(b["aux_loss"], rel=1e-5)


@pytest.mark.parametrize("arch,axes", [
    ("gpt2", {"model": 2}), ("gpt2", {"data": 2, "model": 2}),
    ("llama_untied", {"data": 2, "model": 2})],
    ids=["gpt2_model2", "gpt2_data2_model2", "llama_untied_data2_model2"])
def test_lm_head_chunk_under_model_matches_jax(arch, axes):
    """``lm_head_chunk`` under "model" (JAX's ``make_dp_train_step`` passes
    it through to ``make_train_step``): the tied head's vocab-sharded loss
    (each position's log-sum-exp and label logit over its rows, in tiles
    of 16, merged over the positions) and an untied head's replicated one,
    against JAX's single-device step with the same chunk. Two SGD steps
    at lr 1, so each update is the gradient: losses within 1e-5 relative,
    and each leaf's update (after - before) within 1e-4 of the largest
    entry of JAX's update of that leaf (the port at no mesh is 2.4e-6
    from JAX, the order of its sums)."""
    kw = dict(vocab_size=64, max_len=16, num_layers=2, d_model=32,
              num_heads=4)
    if arch == "gpt2":
        jmodel = jmodels.GPT2(**kw, policy=F32)
    else:
        kw.update(num_kv_heads=2, tie_embeddings=False)
        jmodel = JLlama(**kw, policy=F32)
    ids = np.random.RandomState(7).randint(0, 64, (4, 16)).astype(np.int32)
    labels = np.roll(ids, -1, 1)
    start, jstate, jm = _jax_dp(jmodel, jnn.SGD(lr=1.0), {}, ids, labels,
                                compute_accuracy=False, lm_head_chunk=16)
    cls = GPT2 if arch == "gpt2" else Llama
    model = cls(**kw, policy=tdt.FP32, device="cpu", seed=None)
    model.load_jax_params(start[0])
    state, tm = _port_dp(model, topt.SGD(lr=1.0), axes,
                         torch.from_numpy(ids).long(),
                         torch.from_numpy(labels).long(),
                         compute_accuracy=False, lm_head_chunk=16)
    for a, b in zip(tm, jm):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
    got = tstep.train_state_trees(state)["params"]
    for path, want in jax.tree_util.tree_flatten_with_path(
            _np(jstate.params))[0]:
        keys = [k.key for k in path]
        before = _leaf(start[0], keys)
        update = want - before
        gap = np.abs(_leaf(got, keys).numpy() - before - update).max()
        assert gap <= 1e-4 * np.abs(update).max(), "/".join(keys)
    sharded = state.layout.sharded_names()
    assert "wte.table" in sharded and "head.kernel" not in sharded


# -- train_model in both packages --------------------------------------------


SEQ, BATCH = 32, 8


def _gpt_tokens():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 64, (32, SEQ)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1).astype(np.int32)


def _cfg(tmp, axes, method="ring", **kw):
    return dict(epochs=1, batch_size=BATCH, shuffle=False,
                snapshot_dir=str(tmp), mesh_axes=axes,
                seq_parallel_method=method,
                optimizer={"type": "sgd", "lr": 0.1},
                progress_print_interval=100, io_dtype="float32",
                compute_dtype="float32", **kw)


@pytest.fixture(scope="module")
def jax_seq_runs(tmp_path_factory):
    """JAX's train_model at each layout of
    ``test_config_driven_seq_parallel_gpt``, from one initial state."""
    jmodel = jmodels.GPT2(vocab_size=64, max_len=SEQ, num_layers=2,
                          d_model=32, num_heads=4, dropout=0.0, policy=F32)
    params = _np(jmodel.init(jax.random.PRNGKey(0), (BATCH, SEQ))["params"])
    tokens, labels = _gpt_tokens()
    runs = {}
    for key, axes, method in LAYOUTS:
        tmp = tmp_path_factory.mktemp(key)
        jstate = jcreate(jmodel, jnn.SGD(lr=0.1), jax.random.PRNGKey(0),
                         (BATCH, SEQ))
        jstate = jstate._replace(params=jax.tree.map(jnp.asarray, params))
        jstate, hist = jtrain(jmodel, JConfig().update(_cfg(tmp, axes,
                                                            method)),
                              JLoader(tokens, labels, seed=0), state=jstate)
        runs[key] = (hist, _np(jstate.params), str(tmp))
    return params, runs


LAYOUTS = [("dp_sp_ring", {"data": 2, "seq": 4}, "ring"),
           ("dp_sp_ulysses", {"data": 2, "seq": 4}, "ulysses"),
           ("dp_tp_sp_ring", {"data": 2, "model": 2, "seq": 2}, "ring")]


@pytest.mark.parametrize("key,axes,method", LAYOUTS,
                         ids=[k for k, _, _ in LAYOUTS])
def test_config_driven_seq_parallel_gpt(jax_seq_runs, tmp_path, key, axes,
                                        method):
    params, runs = jax_seq_runs
    jhist, jparams, _ = runs[key]
    model = GPT2(vocab_size=64, max_len=SEQ, num_layers=2, d_model=32,
                 num_heads=4, policy=tdt.FP32, device="cpu", seed=None)
    model.load_jax_params(params)
    tokens, labels = _gpt_tokens()
    state, hist = train_model(model, TrainingConfig().update(
        _cfg(tmp_path, axes, method)),
        ArrayDataLoader(tokens, labels, seed=0), devices=CPU8)
    assert hist[0]["batches"] == jhist[0]["batches"] == 4
    assert hist[0]["train_loss"] == pytest.approx(jhist[0]["train_loss"],
                                                  rel=1e-5)
    for path, p in model.jax_param_paths():
        np.testing.assert_allclose(p.detach().numpy(),
                                   _leaf(jparams, path), rtol=1e-4,
                                   atol=1e-6, err_msg="/".join(path))


def test_config_driven_expert_axis(tmp_path):
    def jmodel():
        return jnn.Sequential([
            jnn.Dense(16, activation="relu", policy=F32),
            jnn.MoE(num_experts=4, hidden=32, top_k=2, policy=F32),
            jnn.Flatten(policy=F32), jnn.Dense(4, policy=F32)], policy=F32)

    rs = np.random.RandomState(0)
    x = rs.randn(64, 6, 8).astype(np.float32)
    y = rs.randint(0, 4, 64).astype(np.int32)
    jm = jmodel()
    jstate = jcreate(jm, jnn.SGD(lr=0.1), jax.random.PRNGKey(0), (16, 6, 8),
                     input_dtype=jnp.float32)
    start = _np(jstate.params)
    cfg = dict(epochs=1, batch_size=16, shuffle=False,
               mesh_axes={"data": 2, "expert": 4},
               optimizer={"type": "sgd", "lr": 0.1},
               progress_print_interval=2, io_dtype="float32",
               compute_dtype="float32")
    _, jhist = jtrain(jm, JConfig().update(dict(
        cfg, snapshot_dir=str(tmp_path / "jax"))), JLoader(x, y, seed=0),
        state=jstate)
    model = config_module(jm.get_config())
    model.init((6, 8), device="cpu", seed=None)
    model.load_jax_params(start)
    state, hist = train_model(model, TrainingConfig().update(dict(
        cfg, snapshot_dir=str(tmp_path / "port"))),
        ArrayDataLoader(x, y, seed=0), devices=CPU8)
    assert hist[0]["train_loss"] == pytest.approx(jhist[0]["train_loss"],
                                                  rel=1e-5)
    assert "layers.1.w_in" in state.layout.sharded_names()


# -- FSDP's parameter sharding ----------------------------------------------


def _fsdp_run(axes, **kw):
    model = GPT2(vocab_size=512, max_len=32, num_layers=2, d_model=128,
                 num_heads=4, policy=tdt.FP32, device="cpu", seed=0)
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, 512, (8, 32))).long()
    state, metrics = _port_dp(model, topt.AdamW(lr=1e-3), axes, ids,
                              torch.roll(ids, -1, 1), steps=3,
                              compute_accuracy=False, **kw)
    return state, [m["loss"] for m in metrics]


@pytest.mark.parametrize("kw", [{}, {"grad_accum": 2, "remat": "full"}],
                         ids=["plain", "accum_remat"])
def test_fsdp_shards_parameters_bit_for_bit(kw):
    rep, rep_losses = _fsdp_run({"data": 4}, **kw)
    sh, sh_losses = _fsdp_run({"data": 2, "fsdp": 2}, **kw)
    assert sh_losses == rep_losses
    a, b = (tstep.train_state_trees(s) for s in (rep, sh))
    for x, y in zip(jax.tree_util.tree_leaves(jax.tree.map(np.asarray, a)),
                    jax.tree_util.tree_leaves(jax.tree.map(np.asarray, b))):
        np.testing.assert_array_equal(x, y)
    lay = sh.layout
    sharded = lay.sharded_names()
    assert "wte.table" in sharded and "blocks.0.fc.kernel" in sharded
    full = sum(4 * int(np.prod(s)) for s in lay.shapes.values())
    half = sum(4 * int(np.prod(lay.shapes[n])) for n in sharded) // 2
    held = lay.position_bytes(sh.opt_state)
    for c in lay.coords:
        assert held[c]["params"] == full - half
        for n in sharded:
            shape = list(lay.shapes[n])
            shape[lay.dim[n]] //= 2
            assert list(lay.held[c][n].shape) == shape
    # AdamW's two moments of each owned piece: position (0, f) owns shard f
    assert held[(0, 1, 0, 0, 0)]["moments"] == 2 * half
    assert held[(1, 0, 0, 0, 0)]["moments"] == 0
    # the model's own tensors of sharded leaves are empty until write_back
    params = dict(sh.layout.model.named_parameters())
    assert params["wte.table"].numel() == 0
    lay.write_back()
    np.testing.assert_array_equal(params["wte.table"].detach().numpy(),
                                  a["params"]["wte"]["table"].numpy())


# -- snapshots across packages ----------------------------------------------


SGDM_KW = dict(lr=0.1, momentum=0.9)
SGDM = {"type": "sgd", **SGDM_KW}


def test_tp_snapshot_resumes_in_the_other_package(tmp_path):
    jmodel = jmodels.GPT2(vocab_size=64, max_len=SEQ, num_layers=2,
                          d_model=32, num_heads=4, policy=F32)
    params = _np(jmodel.init(jax.random.PRNGKey(0), (BATCH, SEQ))["params"])
    tokens, labels = _gpt_tokens()
    axes = {"data": 2, "model": 2}
    cfg = _cfg(tmp_path / "jax", axes)
    cfg["optimizer"] = SGDM
    jstate = jcreate(jmodel, jnn.SGD(**SGDM_KW), jax.random.PRNGKey(0),
                     (BATCH, SEQ))._replace(
                         params=jax.tree.map(jnp.asarray, params))
    jstate, _ = jtrain(jmodel, JConfig().update(cfg),
                       JLoader(tokens, labels, seed=0), state=jstate)
    final = {"params": _np(jstate.params),
             "velocity": _np(jstate.opt_state["velocity"])}
    # JAX's snapshot into the port's TP layout
    model = GPT2(vocab_size=64, max_len=SEQ, num_layers=2, d_model=32,
                 num_heads=4, policy=tdt.FP32, device="cpu", seed=0)
    mesh = tpar.make_mesh(**axes, devices=CPU8)
    opt = topt.SGD(**SGDM_KW)
    _, place_state, _ = tpar.make_dp_train_step(model, opt, mesh, tp=True)
    state = place_state(tstep.create_train_state(model, opt))
    state, _ = Checkpoint(str(tmp_path / "jax")).restore(state)
    trees = tstep.train_state_trees(state)
    for path, _ in jax.tree_util.tree_flatten_with_path(final["params"])[0]:
        keys = [k.key for k in path]
        np.testing.assert_array_equal(_leaf(trees["params"], keys).numpy(),
                                      _leaf(final["params"], keys))
        np.testing.assert_array_equal(
            _leaf(trees["opt_state"]["velocity"], keys).numpy(),
            _leaf(final["velocity"], keys))
    assert state.step == int(jstate.step)
    qkv = state.layout.held[(0, 0, 1, 0, 0)]["blocks.0.attn.qkv_kernel"]
    assert tuple(qkv.shape) == (32, 48)
    # the port's snapshot into JAX's templates
    pcfg = _cfg(tmp_path / "port", axes)
    pcfg["optimizer"] = SGDM
    model = GPT2(vocab_size=64, max_len=SEQ, num_layers=2, d_model=32,
                 num_heads=4, policy=tdt.FP32, device="cpu", seed=None)
    model.load_jax_params(params)
    state, _ = train_model(model, TrainingConfig().update(pcfg),
                           ArrayDataLoader(tokens, labels, seed=0),
                           devices=CPU8)
    path = os.path.join(Checkpoint(str(tmp_path / "port")).latest_path(),
                        "state.tnn")
    templates = {"params": final["params"],
                 "opt_state": {"velocity": final["velocity"],
                               "step": np.zeros((), np.int32)}}
    loaded, _ = jckpt.load_tensors(path, templates)
    mine = tstep.train_state_trees(state)
    for path_, _ in jax.tree_util.tree_flatten_with_path(final["params"])[0]:
        keys = [k.key for k in path_]
        np.testing.assert_array_equal(
            np.asarray(_leaf(loaded["params"], keys)),
            _leaf(mine["params"], keys).numpy())
        np.testing.assert_allclose(_leaf(mine["params"], keys).numpy(),
                                   _leaf(final["params"], keys), rtol=1e-4,
                                   atol=1e-6)


def test_trainer_cli_seq_parallel_method(tmp_path, monkeypatch):
    """``cli.trainer --seq-parallel-method`` reaches the config
    ``train_model`` runs, with the mesh and its devices, on an LM over a
    token file (``--dataset openwebtext``; val.bin beside it)."""
    from tnn_tpu_torch.cli import trainer

    seen = {}

    def fake(model, cfg, train, val, devices=None):
        seen.update(cfg=cfg, devices=devices, shape=train.data_shape,
                    val=val, model=model)
        return None, []

    monkeypatch.setattr(trainer, "train_model", fake)
    rng = np.random.default_rng(0)
    rng.integers(0, 50257, 2048).astype(np.uint16).tofile(
        tmp_path / "train.bin")
    rng.integers(0, 50257, 1028).astype(np.uint16).tofile(
        tmp_path / "val.bin")
    trainer.main(["--model", "gpt2_tiny", "--dataset", "openwebtext",
                  "--data-path", str(tmp_path / "train.bin"), "--mesh",
                  "data=2,seq=2", "--seq-parallel-method", "ulysses",
                  "--mesh-devices", "cpu,cpu,cpu,cpu", "--device", "cpu"])
    assert seen["cfg"].seq_parallel_method == "ulysses"
    assert seen["cfg"].mesh_axes == {"data": 2, "seq": 2}
    assert seen["devices"] == ["cpu"] * 4
    assert seen["shape"] == (1024,) and seen["val"].num_samples == 4
    assert isinstance(seen["model"], GPT2)


def _tiny_gpt(dropout=0.0, seed=0):
    return GPT2(vocab_size=64, max_len=SEQ, num_layers=2, d_model=32,
                num_heads=4, dropout=dropout, policy=tdt.FP32,
                device="cpu", seed=seed)


def test_sharded_eval_step_matches_single_device():
    """The eval step over vocab-sharded logits (tied head under "model")
    and ring attention: loss and corrects equal the single-device eval
    step's."""
    tokens, labels = _gpt_tokens()
    x = torch.from_numpy(tokens[:BATCH]).long()
    y = torch.from_numpy(labels[:BATCH]).long()
    want = tstep.make_eval_step(_tiny_gpt())(None, x, y)
    for axes in ({"data": 2, "model": 2}, {"model": 2, "seq": 2}):
        model = _tiny_gpt()
        mesh = tpar.make_mesh(**axes, devices=CPU8)
        step, place_state, _ = tpar.make_dp_train_step(
            model, topt.SGD(), mesh, tp=True)
        state = place_state(tstep.create_train_state(model, topt.SGD()))
        got = step.eval_step()(state, x, y)
        assert float(got["loss"]) == pytest.approx(float(want["loss"]),
                                                   rel=1e-6)
        assert int(got["corrects"]) == int(want["corrects"])


@pytest.mark.parametrize("axes", [{"data": 2, "model": 2, "seq": 2},
                                  {"data": 2, "fsdp": 2}],
                         ids=["dp_tp_sp", "dp_fsdp"])
def test_remat_replays_dropout_under_tp_seq_and_fsdp(axes):
    """Dropout 0.1 with remat "full" and grad_accum 2 equals the same run
    without remat bit for bit: the recompute (and FSDP's gathers at use)
    replay every stream's masks."""
    tokens, labels = _gpt_tokens()
    x = torch.from_numpy(tokens[:BATCH]).long()
    y = torch.from_numpy(labels[:BATCH]).long()
    runs = []
    for remat in (False, "full"):
        model = GPT2(vocab_size=256, max_len=SEQ, num_layers=2, d_model=256,
                     num_heads=4, dropout=0.1, policy=tdt.FP32,
                     device="cpu", seed=0)
        state, metrics = _port_dp(model, topt.SGD(lr=0.1), axes, x, y,
                                  remat=remat, grad_accum=2,
                                  compute_accuracy=False)
        runs.append(([m["loss"] for m in metrics],
                     tstep.train_state_trees(state)["params"]))
    assert runs[0][0] == runs[1][0]
    if "fsdp" in axes:
        assert "wte.table" in state.layout.sharded_names()
    for a, b in zip(jax.tree_util.tree_leaves(jax.tree.map(np.asarray,
                                                           runs[0][1])),
                    jax.tree_util.tree_leaves(jax.tree.map(np.asarray,
                                                           runs[1][1]))):
        np.testing.assert_array_equal(a, b)
