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
engine's step bodies hand it. Under data, seq or expert parallelism the
lockstep forward (``parallel.data_parallel``) concatenates every
position's tokens into one call, so top-k, capacity and the aux loss
count the global batch, as the JAX layer's do; ``ep_rules`` shards the
expert stacks over the "expert" positions, which ``_route``'s
``experts`` hook computes slice by slice.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..core.module import Module, register_module
from ..ops.quant_matmul import matmul_f32
from . import activations


@register_module("moe")
class MoE(Module):
    """Top-k routed expert FFN over (N, S, D) activations.

    Parameters (the JAX tree's leaves under ``moe``): ``gate_kernel`` (D,
    E), ``w_in`` (E, D, H), ``b_in`` (E, H), ``w_out`` (E, H, D), ``b_out``
    (E, D), kept in the policy's param dtype and cast to the compute dtype
    at use. ``hidden`` defaults to ``hidden_ratio * D``. With one expert,
    top-1 and room for every token this is exactly Dense -> act -> Dense.

    With ``d_model`` the weights are made at once on ``device``; with None
    ``build`` sizes them from the input. Called bare, ``moe(x)`` returns
    (out, aux); called as a layer (``train=`` given, as a ``Sequential``
    calls it) it returns the output alone and leaves the aux loss pending
    in its state ("aux_loss", the JAX layer's state). Either way
    ``last_aux`` holds the last forward's aux loss, which the train step
    adds into the loss (``train.step.moe_aux_loss``).
    """

    _params = ("gate_kernel", "w_in", "b_in", "w_out", "b_out")
    _state = ("aux_loss",)

    def __init__(self, d_model: Optional[int] = None,
                 num_experts: Optional[int] = None,
                 hidden: Optional[int] = None, top_k: int = 2,
                 capacity_factor: float = 2.0, activation: str = "gelu",
                 aux_weight: float = 0.01, hidden_ratio: int = 4,
                 dispatch: str = "einsum", *, name=None, policy=None,
                 device="cuda"):
        super().__init__(name=name, policy=policy)
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
        self.gate_kernel = self.w_in = self.b_in = None
        self.w_out = self.b_out = None
        self.last_aux: Optional[torch.Tensor] = None
        if d_model is not None:
            self.build((1, int(d_model)), device)

    def _build(self, input_shape, device):
        d, e = int(input_shape[-1]), self.num_experts
        h = self.hidden or self.hidden_ratio * d
        self.gate_kernel = self._new_param((d, e), device)
        self.w_in = self._new_param((e, d, h), device)
        self.b_in = self._new_param((e, h), device)
        self.w_out = self._new_param((e, h, d), device)
        self.b_out = self._new_param((e, d), device)
        self.register_buffer("aux_loss", torch.zeros(
            (), dtype=torch.float32, device=device))

    def _param_slots(self):
        yield ("gate", "kernel"), self, "gate_kernel"
        for name in self._params[1:]:
            yield (name,), self, name

    def param_initializers(self):
        return {"gate_kernel": "xavier_uniform", "w_in": "xavier_uniform",
                "w_out": "xavier_uniform"}

    def _config(self):
        return {"num_experts": self.num_experts, "hidden": self.hidden,
                "top_k": self.top_k, "capacity_factor": self.capacity_factor,
                "activation": self.activation, "aux_weight": self.aux_weight,
                "hidden_ratio": self.hidden_ratio, "dispatch": self.dispatch}

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

    def forward(self, x: torch.Tensor, *, train: Optional[bool] = None,
                generator=None):
        """x (N, S, D) -> (out (N, S, D) in x's dtype, aux loss f32);
        called as a layer, the output alone (the class docstring)."""
        out, aux = self._route(x)
        self.last_aux = aux
        if train is None:
            return out, aux
        if train:
            self.pending_state = {"aux_loss": aux.detach()}
        return out

    def expert_ffn(self, xe: torch.Tensor, w_in, b_in, w_out, b_out
                   ) -> torch.Tensor:
        """The experts of the stacks ``w_in`` (E', D, H), ``b_in`` (E', H),
        ``w_out`` (E', H, D), ``b_out`` (E', D) over their (E', C, D)
        inputs: (E', C, D) f32."""
        p = self.policy
        cd = p.compute_dtype
        act = activations.get(self.activation)
        w_in, w_out = p.cast_param(w_in), p.cast_param(w_out)
        b_in, b_out = p.cast_param(b_in).float(), p.cast_param(b_out).float()
        ye = []
        for i in range(xe.shape[0]):
            hmid = act(matmul_f32(xe[i], w_in[i]) + b_in[i]).to(cd)
            ye.append(matmul_f32(hmid, w_out[i]) + b_out[i])
        return torch.stack(ye)

    def _route(self, x: torch.Tensor, experts=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(out, aux) of ``x``; ``experts(xe)`` maps the (E, C, D) expert
        inputs to their f32 outputs (by default ``expert_ffn`` over the
        layer's own stacks)."""
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

        if experts is None:
            ye = self.expert_ffn(xe, self.w_in, self.b_in, self.w_out,
                                 self.b_out)
        else:
            ye = experts(xe)
        back = ye.reshape(e * cap, d)                           # f32

        weight = top_p * kept                                  # (T, k)
        out = (back[slot] * weight[..., None]).sum(1)          # (T, D) f32
        out = out.to(x.dtype).reshape(n, s, d)

        ones = torch.ones(t * k, dtype=torch.float32, device=x.device)
        frac = torch.zeros(e, dtype=torch.float32, device=x.device) \
            .index_add(0, top_e.reshape(-1), ones) / (t * k)
        aux = self.aux_weight * e * (frac * probs.mean(0)).sum()
        return out, aux


def ep_rules(axis: str = "expert"):
    """Path rules for the expert stacks (``w_in``, ``b_in``, ``w_out``,
    ``b_out`` carry a leading E dim; the router replicates), for
    ``parallel.tensor_parallel.spec_tree``. By path, not shape: a gate
    kernel whose input dim equals E must not shard."""
    return [(r".*(^|/)(w_in|b_in|w_out|b_out)$", (axis,))]


def shard_params_ep(params, mesh, axis: str = "expert"):
    """The expert stacks placed over the expert axis, the rest
    replicated (``place_by_specs``)."""
    from ..parallel.tensor_parallel import shard_params_tp

    return shard_params_tp(params, mesh, rules=ep_rules(axis))
