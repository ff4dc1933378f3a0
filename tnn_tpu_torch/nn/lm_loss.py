"""Chunked LM-head softmax cross entropy (``tnn_tpu.nn.lm_loss``):
``loss(hidden, table, labels)`` without the (tokens, vocab) f32 logits.

The forward keeps an online log-sum-exp over vocab tiles of ``chunk``
rows of the table: per token the running max m, the running sum s of
exp(logit - m) and the label's logit. The backward recomputes each tile's
logits, forms p = exp(logits - lse) * g / M, adds p @ tile into dh and
writes that tile's slice of dW = p^T @ h, then applies the one-hot
corrections: dh -= table[y] * g / M and dW[y] -= h * g / M (an index-add:
labels repeat). The largest temporary is (tokens, chunk); one extra head
product of compute (the backward's recompute) buys the logits never
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


class _LMHeadLoss(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hidden, table, labels, chunk):
        d = hidden.shape[-1]
        h = hidden.reshape(-1, d)
        y = labels.reshape(-1).long()
        m_tok = h.shape[0]
        dev = h.device
        m = torch.full((m_tok,), -torch.inf, dtype=torch.float32, device=dev)
        s = torch.zeros(m_tok, dtype=torch.float32, device=dev)
        zl = torch.zeros(m_tok, dtype=torch.float32, device=dev)
        for c0, c1 in _tiles(table.shape[0], chunk):
            part = matmul_f32(h, table[c0:c1].t())            # (M, c)
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
        return (lse - zl).mean()

    @staticmethod
    def backward(ctx, g):
        hidden, table, labels, lse = ctx.saved_tensors
        chunk = ctx.chunk
        d = hidden.shape[-1]
        h = hidden.reshape(-1, d)
        y = labels.reshape(-1).long()
        m_tok = h.shape[0]
        gm = (g / m_tok).float()
        hf = h.float()
        dh = torch.zeros(m_tok, d, dtype=torch.float32, device=h.device)
        dw = torch.empty(table.shape, dtype=torch.float32, device=h.device)
        for c0, c1 in _tiles(table.shape[0], chunk):
            tile = table[c0:c1]
            p = matmul_f32(h, tile.t())                       # (M, c)
            p.sub_(lse[:, None]).exp_().mul_(gm)
            tf = tile.float()
            dh.addmm_(p, tf)
            torch.mm(p.t(), hf, out=dw[c0:c1])
        live = y >= 0
        yl = y[live]
        # the one-hot corrections (labels repeat: an index-add)
        dh[live] -= table[yl].float() * gm
        dw.index_add_(0, yl, -hf[live] * gm)
        return (dh.reshape(hidden.shape).to(hidden.dtype),
                dw.to(table.dtype), None, None)


def lm_head_loss(hidden: torch.Tensor, table: torch.Tensor,
                 labels: torch.Tensor, chunk: int = 8192) -> torch.Tensor:
    """Mean cross entropy of ``hidden @ table.T`` against ``labels``.

    hidden: (..., D) post-ln_f activations; table: (V, D), the tied
    embedding or the head's transpose, in the compute dtype; labels:
    (...,) integer ids. ``chunk`` is the vocab tile."""
    return _LMHeadLoss.apply(hidden, table, labels, int(chunk))
