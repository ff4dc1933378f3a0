"""Online-softmax merge (``tnn_tpu.ops.softmax_merge``): the reassociation
behind every partitioned attention.

softmax(x) @ V over a row split into partitions P_1..P_N can be computed
per partition and combined, because the partial state (m, l, acc)

    m   = max_j x_j                      (running row max)
    l   = sum_j exp(x_j - m)             (normalizer at that max)
    acc = sum_j exp(x_j - m) * v_j       (unnormalized weighted values)

forms a commutative monoid under :func:`merge`. Sequence-parallel serving
(``serving/sp.py``) computes every shard's partial with the paged kernel's
stats form and combines them with :func:`merge_shards`, the port's form of
the JAX package's ``merge_psum``: the port has no device mesh, so the
partials arrive as one tensor per shard and are summed in shard order.

Identity element: ``(m, l, acc) = (NEG_INF, 0, 0)``, a partition that saw
no keys. A row whose every partition is empty yields 0 (the kernels'
``l == 0 -> output 0`` convention).
"""
from __future__ import annotations

from typing import Sequence

import torch

#: finite stand-in for -inf, so exp(m - m) stays defined on empty rows
NEG_INF = -1e30


def block_update(m_prev, l_prev, acc, logits, v_blk):
    """Fold one block of logits into the running (m, l, acc) state.

    ``logits``: (..., S_q, S_kv_blk) scaled, masked scores (dead positions
    at <= NEG_INF); ``v_blk``: (..., S_kv_blk, Dh). ``m_prev`` / ``l_prev``
    are (..., S_q, 1), ``acc`` (..., S_q, Dh) f32. Returns the new
    ``(m, l, acc)``; p is rounded to v's dtype before the product, as in
    JAX's ``p.astype(v_blk.dtype)`` with an f32 accumulation.
    """
    m_cur = logits.amax(dim=-1, keepdim=True)
    m_new = torch.maximum(m_prev, m_cur)
    p = torch.exp(logits - m_new)
    l_cur = p.sum(dim=-1, keepdim=True)
    alpha = torch.exp(m_prev - m_new)
    l_new = alpha * l_prev + l_cur
    acc = acc * alpha + torch.einsum(
        "...qk,...kd->...qd", p.to(v_blk.dtype).float(), v_blk.float())
    return m_new, l_new, acc


def finalize(m, l, acc, dtype=None):  # noqa: E741 -- l is the normalizer
    """(m, l, acc) -> attention output: acc / l, with l == 0 -> 0."""
    del m
    out = acc / torch.where(l == 0, 1.0, l)
    return out.to(dtype) if dtype is not None else out


def merge(a, b):
    """Pairwise merge of two partial states ``(m, l, acc)``; the empty
    state ``(NEG_INF, 0, 0)`` is the identity."""
    m_a, l_a, acc_a = a
    m_b, l_b, acc_b = b
    m = torch.maximum(m_a, m_b)
    alpha_a = torch.exp(m_a - m)
    alpha_b = torch.exp(m_b - m)
    return m, alpha_a * l_a + alpha_b * l_b, alpha_a * acc_a + alpha_b * acc_b


def merge_shards(outs: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                 ls: Sequence[torch.Tensor]) -> torch.Tensor:
    """Combine per-shard NORMALIZED attention outputs into the full-row
    softmax, with ``merge_psum``'s formula:

        m* = max_s m_s,   w_s = l_s * exp(m_s - m*)
        out = (sum_s out_s * w_s) / (sum_s w_s),   a 0 denominator -> 1

    ``outs[s]`` is shard s's ``(..., Dh)`` output, ``ms[s]`` / ``ls[s]`` its
    f32 ``(..., 1)`` stats, all on one device. The sums run in shard order
    (at two shards the same additions as the psum). An empty shard (m =
    NEG_INF, l = 0) adds 0 to both sums; a row empty on every shard
    returns 0. Returns ``outs[0]``'s dtype.
    """
    m_max = ms[0]
    for m in ms[1:]:
        m_max = torch.maximum(m_max, m)
    num = den = None
    for out, m, l in zip(outs, ms, ls):  # noqa: E741
        w = l * torch.exp(m - m_max)
        term = out.float() * w
        num = term if num is None else num + term
        den = w if den is None else den + w
    den = torch.where(den == 0, 1.0, den)
    return (num / den).to(outs[0].dtype)
