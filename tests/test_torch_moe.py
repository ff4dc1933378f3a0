"""Port parity: mixture-of-experts blocks (``nn/moe.py``) and the untied
GPT-2 head, held against the JAX package at FP32.

- ``MoE`` against ``tnn_tpu.nn.moe.MoE`` for both dispatches, with and
  without capacity drops, the aux loss included; one expert with top-1
  equals a dense FFN.
- A MoE GPT-2 and an untied GPT-2: forward logits, and one
  ``make_train_step`` step's loss (the aux loss added) and gradients.
- The engine at tp = 1 on a MoE model against the JAX engine on the paged,
  standard and whole-prompt paths. MoE routing reads every row of a step,
  padding included, so this holds only while the port packs the JAX
  engine's (B, Q) shapes; with 8 experts and top-2 the capacity (half a
  step's rows) binds, so padding rows can take a live row's slot.
  Tie-free seed 23: every emitted greedy token
  beats the runner-up by more than 1e-3 in the engine's own logits on the
  paged and standard paths, checked under the suite's XLA flags.
- The untied head under ``quant_weights``: ``head/kernel`` quantizes as
  in JAX, the head equals JAX's on the same int8 tree and hidden states
  at a w8a8 and a weight-only (more than 256 rows) shape, and the whole
  model's logits equal JAX's on the weight-only one.
- ``.tnn`` round trips both ways, and ``moe_gpt2_small``'s config.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnn_tpu import checkpoint as jck
from tnn_tpu.core import dtypes as jdt
from tnn_tpu.models import zoo as jzoo
from tnn_tpu.models.gpt2 import GPT2 as JGPT2
from tnn_tpu.nn import losses as jlosses
from tnn_tpu.nn import optimizers as jopt
from tnn_tpu.nn import quant as jquant
from tnn_tpu.nn.moe import MoE as JMoE
from tnn_tpu.serving import InferenceEngine as JEngine
from tnn_tpu.train import create_train_state as jcreate
from tnn_tpu.train import make_train_step as jmake_step
from tnn_tpu_torch import checkpoint as ck
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.models import zoo
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.nn import optimizers
from tnn_tpu_torch.nn.layers import Dense
from tnn_tpu_torch.nn.moe import MoE
from tnn_tpu_torch.nn.quant import quantize_for_decode
from tnn_tpu_torch.ops import quant_matmul as tqm
from tnn_tpu_torch.serving.engine import InferenceEngine
from tnn_tpu_torch.train.step import aux_loss_sum, create_train_state, \
    make_train_step

TINY = dict(vocab_size=128, max_len=64, num_layers=2, d_model=32,
            num_heads=2)
KW = dict(num_blocks=32, block_size=4, max_batch_size=4, max_seq_len=32,
          prefix_cache=False)
MARGIN = 1e-3


def _load_moe(layer: MoE, params):
    with torch.no_grad():
        layer.gate_kernel.copy_(torch.from_numpy(
            np.asarray(params["gate"]["kernel"])))
        for name in ("w_in", "b_in", "w_out", "b_out"):
            getattr(layer, name).copy_(torch.from_numpy(
                np.asarray(params[name])))


def _jax_moe_params(jl, shape, seed):
    """JAX's init, with random biases so that their adds are held too."""
    params = jl.init(jax.random.PRNGKey(seed), shape)["params"]
    rng = np.random.default_rng(seed)
    for name in ("b_in", "b_out"):
        params[name] = jnp.asarray(
            rng.normal(0, 0.1, params[name].shape).astype(np.float32))
    return params


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
@pytest.mark.parametrize("capacity_factor", [2.0, 0.5],
                         ids=["room", "drops"])
def test_moe_layer_matches_jax(dispatch, capacity_factor):
    d, e, shape = 32, 4, (3, 10, 32)
    jl = JMoE(e, top_k=2, capacity_factor=capacity_factor,
              dispatch=dispatch, policy=jdt.FP32)
    params = _jax_moe_params(jl, shape, seed=1)
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    want, state = jl.apply({"params": params, "state": {}}, jnp.asarray(x),
                           train=False)
    tl = MoE(d, e, top_k=2, capacity_factor=capacity_factor,
             dispatch=dispatch, policy=tdt.FP32, device="cpu")
    _load_moe(tl, params)
    assert tl._capacity(30) == jl._capacity(30)
    with torch.no_grad():
        got, aux = tl(torch.from_numpy(x))
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    assert abs(float(aux) - float(state["aux_loss"])) <= 1e-7
    for key in ("num_experts", "hidden", "top_k", "capacity_factor",
                "activation", "aux_weight", "hidden_ratio", "dispatch"):
        assert getattr(tl, key) == getattr(jl, key), key


def test_moe_capacity_drops_differ_by_dispatch():
    """With drops the dispatches keep different assignments (token order
    against sorted order), as in the JAX package."""
    shape = (2, 12, 32)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=shape).astype(np.float32))
    outs = []
    for dispatch in ("einsum", "sort"):
        tl = MoE(32, 4, top_k=2, capacity_factor=0.25, dispatch=dispatch,
                 policy=tdt.FP32, device="cpu")
        _load_moe(tl, _jax_moe_params(
            JMoE(4, top_k=2, policy=jdt.FP32), shape, seed=3))
        with torch.no_grad():
            outs.append(tl(x)[0])
    assert not torch.equal(outs[0], outs[1])


def test_one_expert_top1_is_a_dense_ffn():
    d, shape = 32, (2, 7, 32)
    jl = JMoE(1, top_k=1, capacity_factor=1.0, policy=jdt.FP32)
    params = _jax_moe_params(jl, shape, seed=5)
    tl = MoE(d, 1, top_k=1, capacity_factor=1.0, policy=tdt.FP32,
             device="cpu")
    _load_moe(tl, params)
    fc = Dense(d, 4 * d, activation="gelu", policy=tdt.FP32, device="cpu")
    proj = Dense(4 * d, d, policy=tdt.FP32, device="cpu")
    with torch.no_grad():
        fc.kernel.copy_(tl.w_in[0])
        fc.bias.copy_(tl.b_in[0])
        proj.kernel.copy_(tl.w_out[0])
        proj.bias.copy_(tl.b_out[0])
        x = torch.from_numpy(np.random.default_rng(6).normal(
            size=shape).astype(np.float32))
        got, _ = tl(x)
        want = proj(fc(x))
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-6)


def _pair(seed=0, **extra):
    cfg = {**TINY, **extra}
    jm = JGPT2(**cfg, policy=jdt.FP32)
    params = jm.init(jax.random.PRNGKey(seed), (2, 16))["params"]
    tm = GPT2(**cfg, policy=tdt.FP32, device="cpu", seed=None)
    tm.load_jax_params(jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.fixture(scope="module")
def moe_pair():
    return _pair(moe_experts=8)


@pytest.mark.parametrize("extra", [dict(moe_experts=4),
                                   dict(tie_embeddings=False),
                                   dict(moe_experts=2, tie_embeddings=False)],
                         ids=["moe", "untied", "moe_untied"])
def test_gpt2_logits_match_jax(extra):
    jm, params, tm = _pair(**extra)
    assert tm.get_config() == jm.get_config()
    ids = np.random.default_rng(0).integers(0, 128, (2, 16))
    want, state = jm.apply({"params": params, "state": {}}, jnp.asarray(ids))
    want = np.asarray(want)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
        cached = tm.apply_cached(torch.from_numpy(ids),
                                 tm.init_cache(2, 16), 0).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert np.abs(cached - want).max() <= 1e-5 * np.abs(want).max()
    if tm.moe_experts:
        assert abs(float(aux_loss_sum(tm.net_state()))
                   - sum(float(v["aux_loss"]) for v in state.values())) \
            <= 1e-7
        assert set(tm.net_state()) == set(state)
    else:
        assert tm.net_state() == {}


@pytest.mark.parametrize("extra", [dict(moe_experts=4),
                                   dict(tie_embeddings=False)],
                         ids=["moe", "untied"])
def test_train_step_loss_and_grads_match_jax(extra):
    """One SGD(lr=1) step: the loss (with ``aux_loss_sum`` for MoE) and
    the update, which is the gradient, against JAX's step."""
    jm, params, tm = _pair(**extra)
    rng = np.random.default_rng(3)
    x = rng.integers(0, 128, (4, 16)).astype(np.int32)
    y = rng.integers(0, 128, (4, 16)).astype(np.int32)
    jstate = jcreate(jm, jopt.SGD(lr=1.0), jax.random.PRNGKey(0), (4, 16))
    jstate = jstate._replace(params=params, opt_state=jopt.SGD(
        lr=1.0).init(params))
    before = jax.tree.map(np.asarray, params)
    jstate, jmetrics = jmake_step(jm, jopt.SGD(lr=1.0), donate=False)(
        jstate, jnp.asarray(x), jnp.asarray(y))
    state = create_train_state(tm, optimizers.SGD(lr=1.0))
    state, metrics = make_train_step(tm, optimizers.SGD(lr=1.0))(
        state, torch.from_numpy(x).long(), torch.from_numpy(y).long())
    assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) <= 1e-5
    if tm.moe_experts:
        aux = sum(float(v["aux_loss"]) for v in jstate.net_state.values())
        assert float(metrics["aux_loss"]) > 0
        assert abs(float(metrics["aux_loss"]) - aux) <= 1e-6
        # the loss holds the aux term: without it the losses part
        plain = float(jlosses.softmax_cross_entropy(
            jm.apply({"params": before, "state": {}}, jnp.asarray(x))[0],
            jnp.asarray(y)))
        assert abs(float(metrics["loss"]) - (plain + aux)) <= 1e-5
    else:
        assert "aux_loss" not in metrics
    after = jax.tree.map(np.asarray, jstate.params)
    num = den = 0.0
    for path, param in tm.jax_param_paths():
        node_b, node_a = before, after
        for key in path:
            node_b, node_a = node_b[key], node_a[key]
        want = node_b - node_a
        got = node_b - param.detach().numpy()
        num += float(((got - want) ** 2).sum())
        den += float((want ** 2).sum())
    assert (num / den) ** 0.5 <= 1e-4


# -- serving at tp = 1 --------------------------------------------------------

def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, int(n_)).astype(np.int32)
            for n_ in rng.integers(5, 14, n)]


def _serve(eng, prompts, max_new=8):
    rids = []
    for i, p in enumerate(prompts):
        rids.append(eng.submit(p, max_new))
        if i % 2 == 1:
            eng.step()
    out = eng.run_until_complete()
    return [list(out[r]) for r in rids]


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
            if self.chunked_prefill:
                row = self._logits[self._rows.index(rid)]
                top2 = row.topk(2).values
                assert int(row.argmax()) == tok
                self.gaps.append(float(top2[0] - top2[1]))
        return events


@pytest.mark.parametrize("path", ["paged", "standard", "whole_prompt"])
def test_moe_engine_matches_jax_engine(moe_pair, path):
    jm, params, tm = moe_pair
    prompts = _prompts(4, seed=23)
    kw = dict(chunked_prefill=False) if path == "whole_prompt" \
        else dict(decode_path=path)
    eng = GapEngine(tm, device="cpu", **KW, **kw)
    got = _serve(eng, prompts)
    assert got == _serve(JEngine(jm, params, **KW, **kw), prompts)
    if path != "whole_prompt":
        assert min(eng.gaps) > MARGIN
    assert eng.stats()["decode_path"] == ("paged" if path == "whole_prompt"
                                          else path)
    assert eng.pool.num_allocated == 0
    eng.check_invariants()


def test_moe_engine_overlap_is_exact(moe_pair):
    """The overlapped loop against synchronous steps, a sampled row beside
    a greedy one and two padding rows: a speculative step's padding rows
    take token 0, as a packed step's do, so the live rows route alike."""
    _, _, tm = moe_pair
    prompts = _prompts(2, seed=23)

    def run(**kw):
        eng = InferenceEngine(tm, device="cpu", seed=2, **KW, **kw)
        rids = [eng.submit(p, 16, temperature=0.8 if i == 1 else 0.0)
                for i, p in enumerate(prompts)]
        out = eng.run_until_complete()
        return eng, [out[r] for r in rids]

    eng, got = run(overlap=True)
    assert eng.stats()["overlap_adopted"] > 0
    assert got == run()[1]


def test_last_writer_scatter_for_moe_blocks(moe_pair):
    """MoE blocks scatter their paged K/V last-writer-wins (padding rows
    that capacity told apart read the slot they all write); dense blocks
    keep the plain scatter. ``_last_writers`` names each write's last
    duplicate, and the scatter with it equals the sequential one."""
    from tnn_tpu_torch.ops import paged_attention as tpa

    _, _, tm = moe_pair
    assert all(blk.attn.last_writer_scatter for blk in tm.blocks)
    assert not any(blk.attn.last_writer_scatter
                   for blk in GPT2(**TINY, device="cpu").blocks)
    dest = torch.tensor([5, 3, 5, 5, 3, 7])
    assert tpa._last_writers(dest).tolist() == [3, 4, 3, 3, 4, 5]
    rows = torch.randn(4, 2, 8)
    tables = torch.tensor([[1, 2], [3, 4], [0, 0], [0, 0]],
                          dtype=torch.int32)
    offs = torch.tensor([5, 2, 0, 0], dtype=torch.int32)
    want = torch.zeros(2, 6, 2, 4, 8)
    for b, blk in enumerate([2, 3, 0, 0]):
        want[1, blk, :, int(offs[b]) % 4] = rows[b]
    got = torch.zeros(2, 6, 2, 4, 8)
    tpa.scatter_kv_rows(got, tables, offs, rows, layer=1, last_writer=True)
    assert torch.equal(got, want)


def test_moe_engine_refusals(moe_pair):
    _, _, tm = moe_pair
    with pytest.raises(ValueError, match="MoE"):
        InferenceEngine(tm, device="cpu", decode_path="fused",
                        quant_weights=True, **KW)


# -- the untied head under quant_weights --------------------------------------

QMODEL = dict(vocab_size=512, max_len=160, num_layers=2, d_model=256,
              num_heads=2, tie_embeddings=False)


@pytest.mark.parametrize("shape", [(2, 16), (3, 96)],
                         ids=["w8a8_32rows", "int8_288rows"])
def test_untied_head_quantized_matches_jax(shape):
    """The head on the same hidden states as JAX's ``_head`` (bit for bit
    on the w8a8 branch, the weight-only branch's f32 sums in another
    order), and the whole model's logits on the weight-only branch. (On
    w8a8 the whole model is not compared: an ulp of difference in a
    hidden state may move one activation code.)"""
    jm = JGPT2(**QMODEL, policy=jdt.FP32)
    params = jm.init(jax.random.PRNGKey(0), (2, 16))["params"]
    jq = jquant.quantize_for_decode(params)
    assert isinstance(jq["head"]["kernel"], jquant.Int8Weight)
    tm = GPT2(**QMODEL, policy=tdt.FP32, device="cpu", seed=None)
    tm.load_jax_params(jax.tree.map(np.asarray, params))
    tq = quantize_for_decode(tm)
    assert isinstance(tq.head.kernel, tqm.Int8Weight)
    assert np.array_equal(tq.head.kernel.q.numpy(),
                          np.asarray(jq["head"]["kernel"].q))
    ids = np.random.default_rng(shape[1]).integers(
        0, QMODEL["vocab_size"], shape).astype(np.int32)
    h = np.random.default_rng(1).normal(
        size=shape + (QMODEL["d_model"],)).astype(np.float32)
    want = np.asarray(jm._head(jq, jnp.asarray(h)))
    with torch.inference_mode():
        got = tq._logits(torch.from_numpy(h)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert isinstance(tm.head.kernel, torch.nn.Parameter)   # untouched
    if shape[0] * shape[1] <= tqm.W8A8_MAX_ROWS:
        assert np.array_equal(got, want)
        return
    want = np.asarray(jm.apply({"params": jq, "state": {}},
                               jnp.asarray(ids))[0])
    with torch.inference_mode():
        got = tq(torch.from_numpy(ids).long()).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# -- files and the zoo --------------------------------------------------------

@pytest.mark.parametrize("extra", [dict(moe_experts=4),
                                   dict(tie_embeddings=False)],
                         ids=["moe", "untied"])
def test_tnn_round_trips_both_ways(tmp_path, extra):
    jm, params, tm = _pair(**extra)
    jpath, ppath = str(tmp_path / "j.tnn"), str(tmp_path / "p.tnn")
    jck.save_model(jpath, jm, params)
    loaded = ck.load_model(jpath, device="cpu")
    assert loaded.get_config() == jm.get_config()
    for (path, a), (_, b) in zip(loaded.jax_param_paths(),
                                 tm.jax_param_paths()):
        assert torch.equal(a, b), path
    ck.save_model(ppath, tm)
    jm2, variables = jck.load_model(ppath)
    assert jm2.get_config() == jm.get_config()
    flat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    got = {tuple(str(getattr(k, "key", k)) for k in p): np.asarray(v)
           for p, v in flat}
    ref = {p: w.detach().numpy() for p, w in tm.jax_param_paths()}
    assert got.keys() == ref.keys()
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k


def test_moe_gpt2_small_config_matches_jax():
    """Built on the meta device: the config without the weights."""
    model = zoo.create("moe_gpt2_small", device="meta", seed=None)
    assert model.get_config() == jzoo.create("moe_gpt2_small").get_config()
    assert model.blocks[0].moe.num_experts == 8
    assert model.blocks[0].moe.top_k == 2
