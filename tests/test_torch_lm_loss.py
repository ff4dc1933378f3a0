"""Port parity: the chunked LM-head loss (``nn.lm_loss.lm_head_loss``)
and the train step's ``lm_head_chunk``, against the JAX package.

Tolerances:
- f32 loss within 1e-6 relative of JAX's ``lm_head_loss`` (both sum each
  tile in f32; the reduction orders differ);
- f32 gradients within 1e-5 relative + 1e-7 absolute of JAX's (tighter
  than JAX's own bound against its reference, 2e-4 / 1e-6,
  ``tests/test_lm_loss.py``), and within JAX's bound of the port's
  materialized loss;
- bf16 inputs: the gradients come back in bf16; the port's product widens
  bf16 exactly, so the loss and gradients equal JAX's f32 function of the
  rounded inputs to f32 rounding (loss 1e-6 relative) and one bf16 step
  (gradients, 2**-7 relative);
- the tied GPT-2 train step with ``lm_head_chunk``: the loss within 1e-5
  relative of the materialized step and of JAX's chunked step, the
  updated parameters within JAX's own 5e-4 / 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tnn_tpu.nn.lm_loss import lm_head_loss as jlm
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.models.llama import Llama
from tnn_tpu_torch.nn.lm_loss import lm_head_loss
from tnn_tpu_torch.nn.optimizers import SGD
from tnn_tpu_torch.train import create_train_state, make_train_step


def _inputs(seed, v, d=64, shape=(4, 8)):
    rs = np.random.RandomState(seed)
    h = rs.randn(*shape, d).astype(np.float32)
    w = (rs.randn(v, d) * 0.1).astype(np.float32)
    y = rs.randint(0, v, shape).astype(np.int32)
    return h, w, y


def _jax(h, w, y, chunk):
    loss, (gh, gw) = jax.value_and_grad(
        lambda a, b: jlm(a, b, jnp.asarray(y), chunk), argnums=(0, 1))(
            jnp.asarray(h), jnp.asarray(w))
    return float(loss), np.asarray(gh), np.asarray(gw)


def _port(h, w, y, chunk, dtype=torch.float32):
    th = torch.tensor(h).to(dtype).requires_grad_(True)
    tw = torch.tensor(w).to(dtype).requires_grad_(True)
    loss = lm_head_loss(th, tw, torch.tensor(y), chunk)
    loss.backward()
    return loss.detach(), th.grad, tw.grad


def _materialized(h, w, y):
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    logits = th.reshape(-1, th.shape[-1]) @ tw.t()
    loss = torch.nn.functional.cross_entropy(
        logits, torch.tensor(y).reshape(-1).long())
    loss.backward()
    return float(loss), th.grad.numpy(), tw.grad.numpy()


@pytest.mark.parametrize("v,chunk", [(1000, 256), (512, 512), (777, 256),
                                     (777, 777), (300, 128)])
def test_loss_and_grads_match_jax_f32(v, chunk):
    h, w, y = _inputs(0, v)
    jl, jgh, jgw = _jax(h, w, y, chunk)
    loss, gh, gw = _port(h, w, y, chunk)
    assert loss.dtype == torch.float32
    assert float(loss) == pytest.approx(jl, rel=1e-6)
    np.testing.assert_allclose(gh.numpy(), jgh, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(gw.numpy(), jgw, rtol=1e-5, atol=1e-7)
    ml, mgh, mgw = _materialized(h, w, y)
    assert float(loss) == pytest.approx(ml, rel=1e-6)
    np.testing.assert_allclose(gh.numpy(), mgh, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(gw.numpy(), mgw, rtol=2e-4, atol=1e-6)


def test_repeated_labels_index_add():
    """Every token has the same label: the table's one-hot correction adds
    up over all of them (an index-add, not an assignment)."""
    h, w, _ = _inputs(5, 300, d=32)
    y = np.full((4, 8), 7, np.int32)
    jl, jgh, jgw = _jax(h, w, y, 128)
    loss, gh, gw = _port(h, w, y, 128)
    assert float(loss) == pytest.approx(jl, rel=1e-6)
    np.testing.assert_allclose(gw.numpy(), jgw, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(gh.numpy(), jgh, rtol=1e-5, atol=1e-7)


def test_bf16_inputs_give_bf16_grads():
    h, w, y = _inputs(2, 200, d=32, shape=(2, 4))
    hb = torch.tensor(h).bfloat16()
    wb = torch.tensor(w).bfloat16()
    loss, gh, gw = _port(h, w, y, 128, dtype=torch.bfloat16)
    assert gh.dtype == torch.bfloat16 and gw.dtype == torch.bfloat16
    assert loss.dtype == torch.float32
    # JAX's f32 function of the bf16-rounded inputs
    jl, jgh, jgw = _jax(hb.float().numpy(), wb.float().numpy(), y, 128)
    assert float(loss) == pytest.approx(jl, rel=1e-6)
    np.testing.assert_allclose(gh.float().numpy(), jgh, rtol=2 ** -7,
                               atol=1e-7)
    np.testing.assert_allclose(gw.float().numpy(), jgw, rtol=2 ** -7,
                               atol=1e-7)


class _Sizes(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else [out]:
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


def test_largest_temporary_is_a_tile():
    """No tensor of the forward or the backward reaches (tokens, vocab):
    the largest is (tokens, chunk) or the (vocab, D) table gradient."""
    m_tok, d, v, chunk = 96, 16, 1000, 128
    h, w, y = _inputs(3, v, d=d, shape=(m_tok,))
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    with _Sizes() as sizes:
        lm_head_loss(th, tw, torch.tensor(y), chunk).backward()
    assert sizes.largest == max(m_tok * chunk, v * d)
    assert sizes.largest < m_tok * v


TINY = dict(vocab_size=300, max_len=16, num_layers=2, d_model=64,
            num_heads=2)


def _jax_step(chunk, data, labels):
    from tnn_tpu import nn as jnn
    from tnn_tpu.core.dtypes import FP32
    from tnn_tpu.models.gpt2 import GPT2 as JGPT2
    from tnn_tpu.train import create_train_state as jcreate
    from tnn_tpu.train import make_train_step as jstep

    model = JGPT2(**TINY, policy=FP32)
    opt = jnn.SGD(lr=0.1)
    state = jcreate(model, opt, jax.random.PRNGKey(0), (2, 8))
    params0 = jax.tree.map(np.asarray, state.params)
    step = jstep(model, opt, compute_accuracy=False, lm_head_chunk=chunk)
    state, m = step(state, jnp.asarray(data), jnp.asarray(labels))
    return params0, float(m["loss"]), jax.tree.map(np.asarray, state.params)


@pytest.fixture(scope="module")
def gpt2_steps():
    rs = np.random.RandomState(4)
    data = rs.randint(0, 300, (2, 8)).astype(np.int32)
    labels = rs.randint(0, 300, (2, 8)).astype(np.int32)
    params0, jloss, jparams = _jax_step(128, data, labels)
    out = {}
    for chunk in (None, 128):
        model = GPT2(**TINY, policy=tdt.FP32, device="cpu", seed=None)
        model.load_jax_params(params0)
        opt = SGD(lr=0.1)
        state = create_train_state(model, opt)
        step = make_train_step(model, opt, compute_accuracy=False,
                               lm_head_chunk=chunk)
        state, m = step(state, torch.tensor(data), torch.tensor(labels))
        out[chunk] = (float(m["loss"]), model.jax_param_tree())
    return jloss, jparams, out


def test_gpt2_chunked_step_matches_materialized(gpt2_steps):
    _, _, out = gpt2_steps
    (l0, p0), (l1, p1) = out[None], out[128]
    assert l1 == pytest.approx(l0, rel=1e-5)
    for a, b in zip(jax.tree.leaves(p0), jax.tree.leaves(p1)):
        np.testing.assert_allclose(b, a, rtol=5e-4, atol=1e-6)


def test_gpt2_chunked_step_matches_jax(gpt2_steps):
    """The tied table's gradient enters ``wte`` through the cast: the
    embedding lookup's gradient and the head's add up as JAX's do."""
    jloss, jparams, out = gpt2_steps
    loss, params = out[128]
    assert loss == pytest.approx(jloss, rel=1e-5)
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(params)):
        np.testing.assert_allclose(b, a, rtol=5e-4, atol=1e-6)


def test_llama_untied_head_chunked_matches_materialized():
    kw = dict(vocab_size=200, max_len=16, num_layers=1, d_model=32,
              num_heads=2, tie_embeddings=False, policy=tdt.FP32,
              device="cpu")
    rs = np.random.RandomState(6)
    data = torch.tensor(rs.randint(0, 200, (2, 8)))
    labels = torch.tensor(rs.randint(0, 200, (2, 8)))
    res = []
    for chunk in (None, 64):
        model = Llama(**kw, seed=1)
        opt = SGD(lr=0.1)
        state = create_train_state(model, opt)
        step = make_train_step(model, opt, compute_accuracy=False,
                               lm_head_chunk=chunk)
        state, m = step(state, data, labels)
        res.append((float(m["loss"]), model.head.kernel.detach().clone()))
    assert res[1][0] == pytest.approx(res[0][0], rel=1e-5)
    torch.testing.assert_close(res[1][1], res[0][1], rtol=5e-4, atol=1e-6)


def test_lm_head_chunk_refusals():
    model = GPT2(**TINY, policy=tdt.FP32, device="cpu")
    opt = SGD(lr=0.1)
    with pytest.raises(ValueError, match="compute_accuracy=False"):
        make_train_step(model, opt, lm_head_chunk=128)
    lin = torch.nn.Linear(4, 4)
    with pytest.raises(ValueError, match="apply_hidden/head_table"):
        make_train_step(lin, opt, compute_accuracy=False, lm_head_chunk=128)
