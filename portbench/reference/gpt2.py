"""Plain GPT-2 in float32: the forward pass, the loss and its gradients,
the global-norm clip and AdamW. It imports torch alone: no kernel, cache
or helper of the program under test.

It follows OpenAI's GPT-2 (Radford et al. 2019; the layout of the
``openai-community/gpt2`` checkpoint): token and learned position
embeddings; per block x + attn(ln_1(x)), then x + mlp(ln_2(x)); causal
multi-head attention with a fused (in, 3 d) q|k|v projection split into
heads of d / n_head and scaled by 1 / sqrt(d / n_head); the MLP's
tanh-approximate GELU ("gelu_new") over 4 d; a final LayerNorm; the
head tied to the token embedding. LayerNorm normalises by the biased
variance with ``layer_norm_epsilon`` inside the root. No dropout.

Matrix products go through ``mm``: exact float32 by default (TF32 off,
see ``exact_float32``), or rounded to fp8 (``fp8_mm``): the control that
the comparison must tell apart from the program.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]


def exact_float32() -> None:
    """Turn TF32 off for matmuls and convolutions: float32 products in
    float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def f32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


class _RoundFp8(torch.autograd.Function):
    """Round to float8 e4m3 with one scale a tensor (its largest magnitude
    maps to 448); the gradient passes through unchanged."""

    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A product of fp8-rounded operands, accumulated in float32."""
    return torch.matmul(_RoundFp8.apply(a), _RoundFp8.apply(b))


def layer_norm(x, scale, bias, eps: float):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def block(x, p: Params, i: int, cfg: dict, mm: Callable):
    """Block ``i`` over (B, S, D)."""
    h = f"h{i}."
    eps = cfg["layer_norm_epsilon"]
    b, s, d = x.shape
    nh = cfg["n_head"]
    dh = d // nh
    a = layer_norm(x, p[h + "ln1.scale"], p[h + "ln1.bias"], eps)
    qkv = mm(a, p[h + "attn.qkv_kernel"]) + p[h + "attn.qkv_bias"]
    q, k, v = (t.reshape(b, s, nh, dh).transpose(1, 2)
               for t in qkv.split(d, dim=-1))
    att = mm(q, k.transpose(-1, -2)) / math.sqrt(dh)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    att = att.masked_fill(~causal, float("-inf")).softmax(dim=-1)
    y = mm(att, v).transpose(1, 2).reshape(b, s, d)
    x = x + mm(y, p[h + "attn.out_kernel"]) + p[h + "attn.out_bias"]
    a = layer_norm(x, p[h + "ln2.scale"], p[h + "ln2.bias"], eps)
    a = gelu_tanh(mm(a, p[h + "fc.kernel"]) + p[h + "fc.bias"])
    return x + mm(a, p[h + "proj.kernel"]) + p[h + "proj.bias"]


def hidden(p: Params, ids: torch.Tensor, cfg: dict,
           mm: Callable = f32_mm) -> torch.Tensor:
    """(B, S) ids -> the final LayerNorm's output (B, S, D)."""
    s = ids.shape[1]
    x = p["wte.table"][ids] + p["wpe.pos"][:s]
    for i in range(cfg["n_layer"]):
        x = block(x, p, i, cfg, mm)
    return layer_norm(x, p["ln_f.scale"], p["ln_f.bias"],
                      cfg["layer_norm_epsilon"])


def logits(p: Params, ids: torch.Tensor, cfg: dict,
           mm: Callable = f32_mm) -> torch.Tensor:
    """(B, S) ids -> (B, S, V) logits of the tied head."""
    return mm(hidden(p, ids, cfg, mm), p["wte.table"].t())


def loss_and_grads(p: Params, ids: torch.Tensor, labels: torch.Tensor,
                   cfg: dict, mm: Callable = f32_mm, rows: int = 8
                   ) -> Tuple[float, Params]:
    """The mean next-token cross entropy over every (row, position) of
    the batch and its gradient in every weight, run ``rows`` rows at a
    time (the gradients of the blocks added up)."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in p.items()}
    total = ids.numel()
    loss = 0.0
    for r in range(0, ids.shape[0], rows):
        lg = logits(leaves, ids[r:r + rows], cfg, mm)
        part = torch.nn.functional.cross_entropy(
            lg.reshape(-1, lg.shape[-1]), labels[r:r + rows].reshape(-1),
            reduction="sum") / total
        part.backward()
        loss += float(part.detach())
        del lg, part
    return loss, {k: v.grad.detach() for k, v in leaves.items()}


def loss(p: Params, ids: torch.Tensor, labels: torch.Tensor, cfg: dict,
         mm: Callable = f32_mm, rows: int = 8) -> float:
    """The mean next-token cross entropy alone, ``rows`` rows at a
    time."""
    total = 0.0
    with torch.no_grad():
        for r in range(0, ids.shape[0], rows):
            lg = logits(p, ids[r:r + rows], cfg, mm)
            total += float(torch.nn.functional.cross_entropy(
                lg.reshape(-1, lg.shape[-1]),
                labels[r:r + rows].reshape(-1), reduction="sum"))
            del lg
    return total / ids.numel()


def clip_global_norm(grads: Params, max_norm: Optional[float]) -> Params:
    """Scale every gradient by min(1, max_norm / (global norm + 1e-6))."""
    if max_norm is None:
        return grads
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
    scale = min(1.0, max_norm / (float(norm) + 1e-6))
    return {k: g * scale for k, g in grads.items()}


class AdamW:
    """Adam with bias correction and decoupled weight decay on every
    weight (Loshchilov & Hutter): m = b1 m + (1 - b1) g,
    v = b2 v + (1 - b2) g^2, p -= lr (m / (1 - b1^t)) /
    (sqrt(v / (1 - b2^t)) + eps) + lr wd p, the decay on the weight
    before the step."""

    def __init__(self, lr: float, beta1: float, beta2: float, eps: float,
                 weight_decay: float):
        self.lr, self.b1, self.b2 = lr, beta1, beta2
        self.eps, self.wd = eps, weight_decay
        self.t = 0
        self.m: Params = {}
        self.v: Params = {}

    def step(self, p: Params, g: Params) -> Params:
        self.t += 1
        bc1 = 1 - self.b1 ** self.t
        bc2 = 1 - self.b2 ** self.t
        out = {}
        for k, w in p.items():
            m = self.m.get(k, torch.zeros_like(w))
            v = self.v.get(k, torch.zeros_like(w))
            m = self.b1 * m + (1 - self.b1) * g[k]
            v = self.b2 * v + (1 - self.b2) * g[k] * g[k]
            self.m[k], self.v[k] = m, v
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            out[k] = w - self.lr * upd - self.lr * self.wd * w
        return out


def train_steps(p: Params, batches: List[Tuple[torch.Tensor, torch.Tensor]],
                cfg: dict, opt_cfg: dict, mm: Callable = f32_mm,
                rows: int = 8) -> dict:
    """Run one optimizer step a batch from ``p``: each step's loss, the
    first step's clipped gradient (what the optimizer got) and the
    weights after the last step."""
    opt = AdamW(opt_cfg["lr"], opt_cfg["beta1"], opt_cfg["beta2"],
                opt_cfg["eps"], opt_cfg["weight_decay"])
    losses, first_grad = [], None
    for ids, labels in batches:
        loss, g = loss_and_grads(p, ids, labels, cfg, mm, rows)
        g = clip_global_norm(g, opt_cfg.get("grad_clip_norm"))
        losses.append(loss)
        if first_grad is None:
            first_grad = g
        p = opt.step(p, g)
        del g
    return {"losses": losses, "first_grad": first_grad, "params": p}
