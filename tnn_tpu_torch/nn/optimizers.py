"""Optimizers (``tnn_tpu.nn.optimizers``): SGD, Adam and AdamW as plain
tensor functions over float32 state, term for term as the JAX package
computes them (``torch.optim`` rounds its bias correction and decay in
another order).

    opt = AdamW(lr=3e-4, weight_decay=0.01, grad_clip_norm=1.0)
    state = opt.init(params)
    params, state = opt.update(grads, state, params, lr_scale=1.0)

``register`` / ``from_config`` / ``get_config`` round-trip an optimizer
through its config dict, ``{"type": "adamw", "lr": ..., ...}``, under the
JAX package's names ("sgd", "adam", "adamw").

``params`` and ``grads`` are trees: nested dicts (or lists) of tensors.
``update`` writes the new values INTO the parameter tensors and the state
tensors, in place (the JAX package returns new trees and donates the old
ones), and returns the same trees. Call it under ``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch


_REGISTRY: Dict[str, type] = {}


def register(name: str):
    def wrap(cls):
        _REGISTRY[name] = cls
        cls.opt_name = name
        return cls

    return wrap


def from_config(cfg: Dict[str, Any]) -> "Optimizer":
    """The optimizer a config dict names: ``{"type": name, **kwargs}``."""
    cfg = dict(cfg)
    name = cfg.pop("type")
    if name not in _REGISTRY:
        raise KeyError(f"unknown optimizer {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**cfg)


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in the JAX package's order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


class Optimizer:
    opt_name = "base"

    def __init__(self, lr: float = 1e-3, weight_decay: float = 0.0,
                 grad_clip_norm: Optional[float] = None):
        self.lr = float(lr)
        self.weight_decay = float(weight_decay)
        self.grad_clip_norm = None if grad_clip_norm is None \
            else float(grad_clip_norm)

    def init(self, params) -> Dict[str, Any]:
        state = self._init(params)
        leaf = tree_leaves(params)[0]
        state["step"] = torch.zeros((), dtype=torch.int32, device=leaf.device)
        return state

    def _init(self, params) -> Dict[str, Any]:
        return {}

    def update(self, grads, state, params, lr_scale=1.0, sq_norm=None
               ) -> Tuple[Any, Dict[str, Any]]:
        """One update of ``params`` (in place); returns (params, state).
        ``sq_norm`` (a float32 scalar) is the squared global norm the clip
        scales by, where ``grads`` holds only part of the gradient tree (a
        layout across processes); by default ``grads``' own."""
        grads = tree_map(lambda g: g.float(), grads)
        if self.grad_clip_norm is not None:
            grads = clip_by_global_norm(grads, self.grad_clip_norm, sq_norm)
        state["step"] += 1
        lr = self.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                       device=state["step"].device)
        self._update(grads, state, params, lr, state["step"])
        return params, state

    def _update(self, grads, state, params, lr, step):
        raise NotImplementedError

    def get_config(self) -> Dict[str, Any]:
        cfg = {"type": self.opt_name, "lr": self.lr,
               "weight_decay": self.weight_decay}
        if self.grad_clip_norm is not None:
            cfg["grad_clip_norm"] = self.grad_clip_norm
        cfg.update(self._config())
        return cfg

    def _config(self) -> Dict[str, Any]:
        return {}


def sum_leaves(tree) -> torch.Tensor:
    """The leaves of a tree of scalars added in ``tree_leaves`` order."""
    total = 0
    for x in tree_leaves(tree):
        total = total + x
    return torch.as_tensor(total, dtype=torch.float32)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squared entries, in float32."""
    return torch.sqrt(sum_leaves(tree_map(lambda x: x.float().square().sum(),
                                          tree)))


def clip_by_global_norm(grads, max_norm: float, sq_norm=None):
    """Scale every leaf by min(1, max_norm / (norm + 1e-6)); ``sq_norm``
    gives the squared norm where ``grads`` is part of the tree."""
    norm = global_norm(grads) if sq_norm is None else torch.sqrt(sq_norm)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return tree_map(lambda g: g * scale, grads)


def _assign(p, value):
    p.copy_(value.to(p.dtype))


@register("sgd")
class SGD(Optimizer):
    """SGD with optional momentum / nesterov; ``weight_decay`` adds wd * p
    to the gradient."""

    def __init__(self, lr: float = 0.01, momentum: float = 0.0,
                 nesterov: bool = False, weight_decay: float = 0.0,
                 grad_clip_norm=None):
        super().__init__(lr=lr, weight_decay=weight_decay,
                         grad_clip_norm=grad_clip_norm)
        self.momentum = float(momentum)
        self.nesterov = bool(nesterov)

    def _init(self, params):
        if self.momentum == 0.0:
            return {}
        return {"velocity": tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)}

    def _update(self, grads, state, params, lr, step):
        wd, mu = self.weight_decay, self.momentum
        if wd:
            grads = tree_map(lambda g, p: g + wd * p.float(), grads, params)
        if mu == 0.0:
            tree_map(lambda p, g: _assign(p, p.float() - lr * g), params,
                     grads)
            return

        def one(p, g, vel):
            vel.copy_(mu * vel + g)
            upd = g + mu * vel if self.nesterov else vel
            _assign(p, p.float() - lr * upd)

        tree_map(one, params, grads, state["velocity"])

    def _config(self):
        return {"momentum": self.momentum, "nesterov": self.nesterov}


@register("adam")
class Adam(Optimizer):
    """Adam with bias correction and optional AMSGrad. ``weight_decay`` here
    is L2 added to the gradient (classic Adam)."""

    def __init__(self, lr: float = 1e-3, beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8,
                 amsgrad: bool = False, weight_decay: float = 0.0,
                 grad_clip_norm=None):
        super().__init__(lr=lr, weight_decay=weight_decay,
                         grad_clip_norm=grad_clip_norm)
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)
        self.eps = float(eps)
        self.amsgrad = bool(amsgrad)

    def _init(self, params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        state = {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}
        if self.amsgrad:
            state["vmax"] = tree_map(zeros, params)
        return state

    def _decoupled(self):
        return False

    def _update(self, grads, state, params, lr, step):
        b1, b2, eps, wd = self.beta1, self.beta2, self.eps, self.weight_decay
        if wd and not self._decoupled():
            grads = tree_map(lambda g, p: g + wd * p.float(), grads, params)
        t = step.float()
        bc1 = 1 - torch.pow(b1, t)
        bc2 = 1 - torch.pow(b2, t)
        vmax = state.get("vmax")

        def one(p, g, m, v, vm=None):
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            vhat = v
            if vm is not None:
                vm.copy_(torch.maximum(vm, v))
                vhat = vm
            upd = (m / bc1) / (torch.sqrt(vhat / bc2) + eps)
            pf = p.float() - lr * upd
            if wd and self._decoupled():
                pf = pf - lr * wd * p.float()   # decay on the OLD parameter
            _assign(p, pf)

        if vmax is None:
            tree_map(one, params, grads, state["m"], state["v"])
        else:
            tree_map(one, params, grads, state["m"], state["v"], vmax)

    def _config(self):
        return {"beta1": self.beta1, "beta2": self.beta2, "eps": self.eps,
                "amsgrad": self.amsgrad}


@register("adamw")
class AdamW(Adam):
    """Adam with decoupled weight decay: p -= lr * wd * p_old."""

    def _decoupled(self):
        return True
