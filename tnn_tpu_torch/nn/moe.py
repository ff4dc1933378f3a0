"""Mixture-of-Experts FFN with top-k routing (``tnn_tpu.nn.moe.MoE``).

Routing is top-k softmax gating in f32, renormalized over the k picks,
with a per-expert capacity (``_capacity``); an assignment past its
expert's capacity falls through (its combine weight is zero). The
Switch-style load-balancing loss ``aux_weight * E * sum_e frac_e *
prob_e`` comes back beside the output, and the layer's state carries it
under "aux_loss", which ``train.step.make_train_step`` adds into the loss.

The two dispatches differ only in WHICH assignments an overflowing expert
drops, as in the JAX package: "einsum" ranks an expert's assignments by
(k-slot, token) order, the GShard/Switch one-hot cumsum; "sort" by their
stable sort on the expert id, (token, k-slot) order. Both gather the
kept tokens into the (E, C, D) expert buffers by index, so neither builds
the (T, E, C) one-hot tensors the JAX "einsum" form multiplies through:
every (expert, slot) holds one token at most, so the gather is the
product's exact value. The expert products accumulate in f32
(``matmul_f32``), the bias is added in f32, the activation's output is
rounded to the compute dtype, and the combine weights each kept row in f32.

The capacity reads the token count of the whole call, padding rows
included, so a serving step must hand MoE the (B, Q) shapes the JAX
engine's step bodies hand it. The expert mesh axis (the JAX package's
``ep_rules``) is not ported: every expert lives on the layer's device.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..core import dtypes as dt
from ..ops.quant_matmul import matmul_f32
from . import activations


class MoE(nn.Module):
    """Top-k routed expert FFN over (N, S, D) activations.

    Parameters (the JAX tree's leaves under ``moe``): ``gate_kernel`` (D,
    E), ``w_in`` (E, D, H), ``b_in`` (E, H), ``w_out`` (E, H, D), ``b_out``
    (E, D), kept in the policy's param dtype and cast to the compute dtype
    at use. ``hidden`` defaults to ``hidden_ratio * D``. With one expert,
    top-1 and room for every token this is exactly Dense -> act -> Dense.
    """

    def __init__(self, d_model: int, num_experts: int,
                 hidden: Optional[int] = None, top_k: int = 2,
                 capacity_factor: float = 2.0, activation: str = "gelu",
                 aux_weight: float = 0.01, hidden_ratio: int = 4,
                 dispatch: str = "einsum", policy=None, device="cuda"):
        super().__init__()
        self.num_experts = int(num_experts)
        self.hidden = hidden if hidden is None else int(hidden)
        self.hidden_ratio = int(hidden_ratio)
        self.top_k = int(top_k)
        if not 1 <= self.top_k <= self.num_experts:
            raise ValueError(f"top_k {top_k} not in [1, {num_experts}]")
        self.capacity_factor = float(capacity_factor)
        self.activation = activation
        self.aux_weight = float(aux_weight)
        if dispatch not in ("einsum", "sort"):
            raise ValueError(f"dispatch {dispatch!r} not in (einsum, sort)")
        self.dispatch = dispatch
        self.policy = policy or dt.default_policy()
        d, e = int(d_model), self.num_experts
        h = self.hidden or self.hidden_ratio * d
        pd = self.policy.param_dtype

        def param(*shape):
            return nn.Parameter(torch.zeros(*shape, dtype=pd, device=device))

        self.gate_kernel = param(d, e)
        self.w_in = param(e, d, h)
        self.b_in = param(e, h)
        self.w_out = param(e, h, d)
        self.b_out = param(e, d)

    def _capacity(self, tokens: int) -> int:
        cap = math.ceil(self.top_k * tokens / self.num_experts
                        * self.capacity_factor)
        return max(1, min(int(cap), tokens))

    def _slots(self, top_e: torch.Tensor, t: int, cap: int):
        """Each (token, k-slot) assignment's slot ``e * cap + rank`` in the
        (E * C) expert buffer and whether it is kept (rank < cap)."""
        k, e = self.top_k, self.num_experts
        if self.dispatch == "sort":
            e_flat = top_e.reshape(-1)
            order = torch.argsort(e_flat, stable=True)
            e_sorted = e_flat[order]
            start = torch.searchsorted(e_sorted, e_sorted, side="left")
            rank_sorted = torch.arange(t * k, device=top_e.device) - start
            rank = torch.empty_like(rank_sorted)
            rank[order] = rank_sorted
            rank = rank.reshape(t, k)
        else:
            # cumsum over the (k-slot, token) order of the one-hot picks:
            # the number of earlier assignments to the same expert
            onehot = torch.nn.functional.one_hot(top_e, e)      # (T, k, E)
            flat = onehot.transpose(0, 1).reshape(k * t, e)
            before = (flat.cumsum(0) - flat).reshape(k, t, e).transpose(0, 1)
            rank = (before * onehot).sum(-1)                    # (T, k)
        kept = rank < cap
        return top_e * cap + rank.clamp_max(cap - 1), kept

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (N, S, D) -> (out (N, S, D) in x's dtype, aux loss f32)."""
        n, s, d = x.shape
        t, e, k = n * s, self.num_experts, self.top_k
        cap = self._capacity(t)
        p = self.policy
        cd = p.compute_dtype
        xt = x.reshape(t, d)

        # routing, f32 for a stable softmax
        logits = matmul_f32(xt.to(cd), p.cast_param(self.gate_kernel))
        probs = torch.softmax(logits.float(), dim=-1)          # (T, E)
        top_p, top_e = probs.topk(k, dim=-1)                   # (T, k)
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

        slot, kept = self._slots(top_e, t, cap)
        # a dropped assignment writes a spare row past the buffer: no
        # data-dependent shape, so no host sync (the pdecode graph
        # captures this forward)
        dest = torch.where(kept, slot, e * cap).reshape(-1)
        src = xt.to(cd)[:, None].expand(t, k, d).reshape(t * k, d)
        xe = torch.zeros(e * cap + 1, d, dtype=cd, device=x.device)
        xe = xe.index_put((dest,), src)[:e * cap].reshape(e, cap, d)

        act = activations.get(self.activation)
        w_in, w_out = p.cast_param(self.w_in), p.cast_param(self.w_out)
        b_in = p.cast_param(self.b_in).float()
        b_out = p.cast_param(self.b_out).float()
        ye = []
        for i in range(e):
            hmid = act(matmul_f32(xe[i], w_in[i]) + b_in[i]).to(cd)
            ye.append(matmul_f32(hmid, w_out[i]) + b_out[i])
        back = torch.stack(ye).reshape(e * cap, d)             # f32

        weight = top_p * kept                                  # (T, k)
        out = (back[slot] * weight[..., None]).sum(1)          # (T, D) f32
        out = out.to(x.dtype).reshape(n, s, d)

        ones = torch.ones(t * k, dtype=torch.float32, device=x.device)
        frac = torch.zeros(e, dtype=torch.float32, device=x.device) \
            .index_add(0, top_e.reshape(-1), ones) / (t * k)
        aux = self.aux_weight * e * (frac * probs.mean(0)).sum()
        return out, aux
