"""The port's chip tools: ``tools/torch_hbm_fit.py`` against the JAX
package's ``tools/hbm_fit.py`` and ``tools/torch_trace_step.py``'s
aggregation on a CPU trace.

- ``torch_hbm_fit.row`` equals ``hbm_fit.row`` for ``small`` and
  ``llama_small`` at ``--seq 1024``: every column, ``params_M`` and
  ``train_state_GB`` (the exact train-state bytes: the port's from
  ``meta``-device tensors, JAX's from ``jax.eval_shape``) included, at
  the printed rounding; the unrounded train-state bytes agree within the
  JAX state's scalars.
- ``aggregate`` on a CPU trace of two tiny train steps gives a total no
  larger than the window, and names the step's operations.
- Both tools raise without a card unless told ``--device cpu`` /
  ``--hbm-gb``.
"""
import jax
import pytest
import torch

from tools import hbm_fit, torch_hbm_fit, torch_trace_step


@pytest.mark.parametrize("size,batch", [("small", 8), ("llama_small", 8)])
def test_hbm_fit_rows_equal_jax(size, batch):
    assert torch_hbm_fit.row(size, batch, 1024) == hbm_fit.row(size, batch,
                                                                1024)


def test_train_state_bytes_match_jax_eval_shape():
    """The unrounded bytes: the port's parameters and AdamW state against
    JAX's ``create_train_state`` under ``eval_shape``, which also holds
    the step counters and the generator key (a few scalars)."""
    from tnn_tpu import models, nn
    from tnn_tpu.train.step import create_train_state
    from tnn_tpu_torch import nn as tnn
    from tnn_tpu_torch.models import zoo

    jm = models.create("gpt2_small", max_len=1024)
    state = jax.eval_shape(
        lambda rng: create_train_state(jm, nn.AdamW(lr=1e-4), rng, (8, 1024)),
        jax.random.PRNGKey(0))
    want = hbm_fit.tree_bytes(state)
    tm = zoo.create("gpt2_small", max_len=1024, device="meta", seed=None)
    got = torch_hbm_fit.train_state_bytes(tm, tnn.AdamW(lr=1e-4))
    assert next(tm.parameters()).device.type == "meta"
    assert 0 <= want - got <= 64
    assert sum(p.numel() for p in tm.parameters()) == sum(
        x.size for x in jax.tree_util.tree_leaves(state.params))


def test_trace_aggregate_on_a_cpu_trace(tmp_path, capsys):
    from tnn_tpu_torch import nn
    from tnn_tpu_torch.models.gpt2 import GPT2
    from tnn_tpu_torch.train.step import create_train_state, make_train_step

    model = GPT2(vocab_size=64, max_len=16, num_layers=1, d_model=16,
                 num_heads=2, device="cpu")
    opt = nn.AdamW(lr=1e-3)
    state = [create_train_state(model, opt)]
    step = make_train_step(model, opt)
    ids = torch.arange(32).reshape(2, 16) % 64

    def run():
        for _ in range(2):
            state[0], _ = step(state[0], ids, ids)

    path = torch_trace_step.capture(run, str(tmp_path), "cpu")
    ops = torch_trace_step.aggregate(path, top=5, device="cpu")
    total = sum(ops.values())
    assert 0 < total <= ops.window_us and ops.events > 0
    assert any("einsum" in name or "mm" in name for name in ops)
    out = capsys.readouterr().out
    assert "window" in out and "idle share" in out


def test_tools_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="is_available"):
        torch_trace_step.main(["--what", "wrn"])
    with pytest.raises(RuntimeError, match="is_available"):
        torch_hbm_fit.main([])
    rows = torch_hbm_fit.main(["--hbm-gb", "80"])
    assert [r["size"] for r in rows] == ["gpt2_small", "gpt2_medium",
                                         "gpt2_large", "llama_small",
                                         "llama_1b"]
