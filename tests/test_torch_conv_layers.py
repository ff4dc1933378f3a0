"""Port parity: the image stack's layers (``tnn_tpu_torch.nn.layers``,
``nn.norms``, ``nn.activations``) against the JAX package's.

Each port layer gets the JAX layer's parameters (seeded) and the same
numpy inputs. Under the FP32 policy they agree to 1e-5 relative to the
output's magnitude (summation order only): forward, and the input and
kernel gradients of a seeded cotangent against ``jax.grad``. SAME padding
at a stride above 1 is asymmetric (JAX pads (0, 1) at even H); those
cases are here at odd and even sizes. The bf16 case states its bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnn_tpu.core import dtypes as jdt
from tnn_tpu.nn import activations as jact
from tnn_tpu.nn import layers as jl
from tnn_tpu.nn import norms as jn
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.nn import activations as tact
from tnn_tpu_torch.nn import layers as tl
from tnn_tpu_torch.nn import norms as tn

TOL = 1e-5


def _rand(seed, *shape, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale + shift).astype(np.float32)


def _close(got, ref, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * max(1.0, np.abs(ref).max()))


def _pair(jax_layer, torch_layer, x_shape, seed=0):
    """Build both layers for ``x_shape``; the port's gets the JAX
    parameters (and state)."""
    v = jax_layer.init(jax.random.PRNGKey(seed), x_shape)
    torch_layer.build(x_shape, "cpu")
    torch_layer.load_jax_params(jax.tree.map(np.asarray, v["params"]))
    if v["state"]:
        torch_layer.load_jax_state(jax.tree.map(np.asarray, v["state"]))
    return v


CONV_CASES = {
    # name: (padding, strides, H, W, kernel, dilation, groups)
    "same_s1": ("same", 1, 8, 8, 3, 1, 1),
    "same_s2_even": ("same", 2, 8, 8, 3, 1, 1),      # pads (0, 1)
    "same_s2_odd": ("same", 2, 7, 9, 3, 1, 1),
    "same_7x7_s2_even": ("same", 2, 12, 12, 7, 1, 1),  # ResNet stem: (2, 3)
    "valid_s1": ("valid", 1, 8, 8, 3, 1, 1),
    "valid_s2_odd": ("valid", 2, 9, 7, 3, 1, 1),
    "int_pad": (1, 1, 7, 7, 3, 1, 1),
    "pair_pad": ([2, 0], 1, 6, 6, 3, 1, 1),
    "explicit_pairs_s2": ([(0, 1), (2, 1)], 2, 8, 8, 3, 1, 1),
    "dilation2": ("same", 1, 9, 9, 3, 2, 1),
    "groups2": ("same", 1, 8, 8, 3, 1, 2),
    "groups2_s2": ("same", 2, 8, 8, 3, 1, 2),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_forward_and_grads(case):
    pad, s, h, w, k, d, g = CONV_CASES[case]
    x = _rand(1, 2, h, w, 4)
    jm = jl.Conv2D(6, k, strides=s, padding=pad, dilation=d, groups=g,
                   activation="relu", policy=jdt.FP32)
    tm = tl.Conv2D(6, k, strides=s, padding=pad, dilation=d, groups=g,
                   activation="relu", policy=tdt.FP32)
    v = _pair(jm, tm, x.shape)
    params = jax.tree.map(lambda a: a + 0.1, v["params"])  # nonzero bias
    tm.load_jax_params(jax.tree.map(np.asarray, params))
    ref = jm({"params": params}, jnp.asarray(x))
    assert tuple(ref.shape) == tm.output_shape(x.shape)
    ct = _rand(2, *ref.shape)

    def loss(p, xx):
        return jnp.sum(jm({"params": p}, xx) * ct)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt)
    _close(out, ref)
    (out * torch.from_numpy(ct)).sum().backward()
    _close(xt.grad, gx)
    _close(tm.kernel.grad, gp["kernel"])
    _close(tm.bias.grad, gp["bias"])


def test_conv2d_bf16():
    """MIXED_BF16 against the JAX layer in FP32 on the bf16-rounded input
    and kernel: the port's conv rounds its output to bf16 (2^-9 relative)
    and the io cast rounds again, so 2^-7 of max|y| bounds the gap."""
    x = _rand(3, 2, 8, 8, 8)
    jm = jl.Conv2D(16, 3, strides=2, policy=jdt.FP32)
    tm = tl.Conv2D(16, 3, strides=2, policy=tdt.MIXED_BF16)
    v = _pair(jm, tm, x.shape)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    kb = tm.kernel.detach().to(torch.bfloat16).float().numpy()
    ref = jm({"params": {**v["params"], "kernel": kb}},
             jnp.asarray(xb.float().numpy()))
    out = tm(xb)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(ref),
                               atol=2 ** -7 * float(np.abs(ref).max()))


POOL_CASES = {
    # name: (cls, pool, strides, padding, H, W)
    "max_2_valid": ("MaxPool2D", 2, None, "valid", 8, 8),
    "max_3_2_same_even": ("MaxPool2D", 3, 2, "same", 8, 8),   # (0, 1)
    "max_3_2_same_odd": ("MaxPool2D", 3, 2, "same", 7, 9),
    "max_3_1_int": ("MaxPool2D", 3, 1, 1, 6, 6),
    "avg_2_valid": ("AvgPool2D", 2, None, "valid", 8, 8),
    "avg_3_2_same_even": ("AvgPool2D", 3, 2, "same", 8, 8),
    "avg_3_2_same_odd": ("AvgPool2D", 3, 2, "same", 7, 9),
    "avg_3_1_int": ("AvgPool2D", 3, 1, 1, 6, 6),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pools(case):
    """Values and the input gradient; SAME average pooling divides each
    window by its count of real pixels."""
    cls, k, s, pad, h, w = POOL_CASES[case]
    x = _rand(4, 2, h, w, 3)
    jm = getattr(jl, cls)(k, s, padding=pad, policy=jdt.FP32)
    tm = getattr(tl, cls)(k, s, padding=pad, policy=tdt.FP32)
    ref = jm({}, jnp.asarray(x))
    assert tuple(ref.shape) == tm.output_shape(x.shape)
    ct = _rand(5, *ref.shape)
    gx = jax.grad(lambda xx: jnp.sum(jm({}, xx) * ct))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt)
    _close(out, ref)
    (out * torch.from_numpy(ct)).sum().backward()
    _close(xt.grad, gx)


def test_avgpool_same_counts_real_pixels():
    """On ones, SAME average pooling is 1 everywhere (padding does not
    count); the corner window of a 3 x 3 / 2 pool at H=8 holds 4 pixels."""
    x = np.ones((1, 8, 8, 1), np.float32)
    x[0, 7, 7, 0] = 5.0
    out = tl.AvgPool2D(3, 2, padding="same")(torch.from_numpy(x))
    assert out.shape == (1, 4, 4, 1)
    assert float(out[0, 3, 3, 0]) == pytest.approx((3 + 5) / 4)
    assert float(out[0, 0, 0, 0]) == 1.0


SHAPE_CASES = {
    "global_avgpool": (lambda m: m.GlobalAvgPool(), (2, 5, 6, 3)),
    "flatten": (lambda m: m.Flatten(), (2, 5, 6, 3)),
    "reshape": (lambda m: m.Reshape((10, 9)), (2, 5, 6, 3)),
    "transpose": (lambda m: m.Transpose((2, 0, 1)), (2, 5, 6, 3)),
    "slice": (lambda m: m.Slice(1, 2, 3), (2, 5, 6, 3)),
    "identity": (lambda m: m.Identity(), (2, 5, 6, 3)),
}


@pytest.mark.parametrize("case", sorted(SHAPE_CASES))
def test_shape_layers(case):
    make, shape = SHAPE_CASES[case]
    x = _rand(6, *shape)
    jm, tm = make(jl), make(tl)
    ref = jm({}, jnp.asarray(x))
    out = tm(torch.from_numpy(x))
    assert tuple(ref.shape) == tm.output_shape(shape) == tuple(out.shape)
    _close(out, ref)
    assert tm.get_config() == {**jm.get_config(),
                               "policy": tm.policy.to_config()}


@pytest.mark.parametrize("shape", [(4, 5, 6, 3), (8, 7)])
def test_batchnorm_train_eval_and_state(shape):
    """Train mode: the batch's biased statistics, and the running state
    m * running + (1 - m) * batch (written by ``commit_state``, not by the
    forward). Eval mode: the running statistics."""
    x = _rand(7, *shape, scale=2.0, shift=1.5)
    c = shape[-1]
    jm, tm = jn.BatchNorm(policy=jdt.FP32), tn.BatchNorm(policy=tdt.FP32)
    _pair(jm, tm, shape)
    params = {"scale": _rand(8, c, shift=1.0), "bias": _rand(9, c)}
    state = {"mean": _rand(10, c), "var": np.abs(_rand(11, c)) + 0.5}
    tm.load_jax_params(params)
    tm.load_jax_state(state)
    variables = {"params": params, "state": state}
    ref, new_state = jm.apply(variables, jnp.asarray(x), train=True)
    out = tm(torch.from_numpy(x), train=True)
    _close(out, ref)
    _close(tm.mean, state["mean"])          # pending, not yet written
    tm.commit_state()
    _close(tm.mean, new_state["mean"])
    _close(tm.var, new_state["var"])
    ref_eval, _ = jm.apply({"params": params, "state": new_state},
                           jnp.asarray(x), train=False)
    _close(tm(torch.from_numpy(x)), ref_eval)
    assert tm.pending_state is None


def test_groupnorm():
    x = _rand(12, 2, 5, 5, 8, scale=3.0, shift=-1.0)
    jm = jn.GroupNorm(groups=4, policy=jdt.FP32)
    tm = tn.GroupNorm(groups=4, policy=tdt.FP32)
    v = _pair(jm, tm, x.shape)
    params = {"scale": _rand(13, 8, shift=1.0), "bias": _rand(14, 8)}
    tm.load_jax_params(params)
    _close(tm(torch.from_numpy(x)), jm({"params": params}, jnp.asarray(x)))
    assert v["state"] == {}


@pytest.mark.parametrize("fn", jact.names())
def test_activation(fn):
    x = _rand(15, 3, 7, scale=3.0)
    ref = jact.Activation(fn, policy=jdt.FP32)({}, jnp.asarray(x))
    layer = tact.Activation(fn, policy=tdt.FP32)
    _close(layer(torch.from_numpy(x)), ref)
    assert layer.get_config()["fn"] == fn
    assert tact.names() == jact.names()


def test_dense_lazy_build_matches_eager_layout():
    """A Dense sized by ``build`` (an image model's, or one rebuilt from
    its config) has the JAX layer's (in, out) kernel and its config."""
    x = _rand(16, 3, 10)
    jm = jl.Dense(4, activation="relu", policy=jdt.FP32)
    tm = tl.Dense.from_config(jm.get_config())
    _pair(jm, tm, x.shape)
    assert tuple(tm.kernel.shape) == (10, 4)
    assert tm.get_config() == jm.get_config()
    v = jm.init(jax.random.PRNGKey(0), x.shape)
    _close(tm(torch.from_numpy(x)), jm(v, jnp.asarray(x)))
