"""Chunked LM-head softmax cross entropy (``tnn_tpu.nn.lm_loss``):
``loss(hidden, table, labels)`` without the (tokens, vocab) f32 logits.

The forward keeps an online log-sum-exp over vocab tiles of ``chunk``
rows of the table: per token the running max m, the running sum s of
exp(logit - m) and the label's logit (``lm_head_lse``; the loss is the
mean of lse - label logit). The backward recomputes each tile's logits,
forms p = exp(logits - lse) * g_lse, adds p @ tile into dh and writes
that tile's slice of dW = p^T @ h, then applies the one-hot corrections
with the label logit's gradient (-g / M for the loss): dh += table[y] *
g_zl and dW[y] += h * g_zl (an index-add: labels repeat). A vocab slice
(tensor parallelism) gives its own lse and label logits, merged across
slices by the caller. The largest temporary is (tokens, chunk); one extra
head product of compute (the backward's recompute) buys the logits never
existing.

Numerics follow the JAX package's ``preferred_element_type=float32``:
every tile's logits come from ``ops.quant_matmul.matmul_f32`` (the
compute-dtype product with an f32 result), and the backward's products
take p in f32 against the widened operands. The gradients return in the
dtypes of ``hidden`` and ``table``. The last tile is the ragged rest of
the table, where the JAX package pads it with rows masked to -inf: the
same sums. Labels below 0 add no label logit (as in the JAX package) and
no one-hot correction.
"""
from __future__ import annotations

import torch

from ..ops.quant_matmul import matmul_f32


def _tiles(vocab: int, chunk: int):
    for c0 in range(0, vocab, chunk):
        yield c0, min(c0 + chunk, vocab)


def lm_head_loss(hidden: torch.Tensor, table: torch.Tensor,
                 labels: torch.Tensor, chunk: int = 8192) -> torch.Tensor:
    """Mean cross entropy of ``hidden @ table.T`` against ``labels``.

    hidden: (..., D) post-ln_f activations; table: (V, D), the tied
    embedding or the head's transpose, in the compute dtype; labels:
    (...,) integer ids. ``chunk`` is the vocab tile."""
    lse, zl = lm_head_lse(hidden, table, labels, chunk)
    return (lse - zl).mean()


class _LMHeadLSE(torch.autograd.Function):
    """Per token, over one slice of the vocabulary: the log-sum-exp of
    ``hidden @ table.T`` and the label's logit (0 where the label is not
    in the slice), in vocab tiles. The backward takes both gradients."""

    @staticmethod
    def forward(ctx, hidden, table, labels, chunk):
        d = hidden.shape[-1]
        h = hidden.reshape(-1, d)
        y = labels.reshape(-1).long()
        dev = h.device
        m_tok = h.shape[0]
        m = torch.full((m_tok,), -torch.inf, dtype=torch.float32, device=dev)
        s = torch.zeros(m_tok, dtype=torch.float32, device=dev)
        zl = torch.zeros(m_tok, dtype=torch.float32, device=dev)
        for c0, c1 in _tiles(table.shape[0], chunk):
            part = matmul_f32(h, table[c0:c1].t())
            m_new = torch.maximum(m, part.amax(dim=1))
            s = s * torch.exp(m - m_new) + torch.exp(
                part - m_new[:, None]).sum(dim=1)
            in_tile = (y >= c0) & (y < c1)
            col = (y - c0).clamp(0, c1 - c0 - 1)
            zl = zl + torch.where(
                in_tile, part.gather(1, col[:, None])[:, 0], 0.0)
            m = m_new
        lse = m + torch.log(s)
        ctx.chunk = int(chunk)
        ctx.save_for_backward(hidden, table, labels, lse)
        return lse, zl

    @staticmethod
    def backward(ctx, g_lse, g_zl):
        hidden, table, labels, lse = ctx.saved_tensors
        d = hidden.shape[-1]
        h = hidden.reshape(-1, d)
        y = labels.reshape(-1).long()
        hf = h.float()
        dh = torch.zeros(h.shape[0], d, dtype=torch.float32, device=h.device)
        dw = torch.empty(table.shape, dtype=torch.float32, device=h.device)
        g_lse = g_lse.float()
        for c0, c1 in _tiles(table.shape[0], ctx.chunk):
            tile = table[c0:c1]
            p = matmul_f32(h, tile.t())
            p.sub_(lse[:, None]).exp_().mul_(g_lse[:, None])
            dh.addmm_(p, tile.float())
            torch.mm(p.t(), hf, out=dw[c0:c1])
        live = (y >= 0) & (y < table.shape[0])
        yl, gz = y[live], g_zl.float()[live, None]
        dh[live] += table[yl].float() * gz
        dw.index_add_(0, yl, hf[live] * gz)
        return (dh.reshape(hidden.shape).to(hidden.dtype),
                dw.to(table.dtype), None, None)


def lm_head_lse(hidden: torch.Tensor, table: torch.Tensor,
                labels: torch.Tensor, chunk: int = 8192):
    """(lse, label logit) per token of ``hidden @ table.T`` over the rows
    of ``table``, a slice of the vocabulary; ``labels`` are ids within the
    slice (any other value adds no label logit). Both f32, flattened;
    differentiable. A vocab-sharded head (tensor parallelism) merges the
    slices' lse by a log-sum-exp and sums the label logits."""
    return _LMHeadLSE.apply(hidden, table, labels, int(chunk))
