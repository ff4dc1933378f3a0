"""Losses (``tnn_tpu.nn.losses``): the fused log-softmax cross entropy the
LM trainer uses, and the ``get`` registry. All reductions in float32."""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch

_REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    def wrap(fn):
        _REGISTRY[name] = fn
        fn.loss_name = name
        return fn

    return wrap


def get(name) -> Callable:
    """A loss by name, or by a config dict ``{"type": name, **kwargs}`` whose
    extra keys bind as keyword arguments."""
    kwargs = {}
    if isinstance(name, dict):
        cfg = dict(name)
        name = cfg.pop("type")
        kwargs = cfg
    if name not in _REGISTRY:
        raise KeyError(f"unknown loss {name!r}; known: {sorted(_REGISTRY)}")
    fn = _REGISTRY[name]
    return functools.partial(fn, **kwargs) if kwargs else fn


@register("softmax_cross_entropy")
def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          weight: Optional[torch.Tensor] = None,
                          label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under softmax(logits).

    ``labels``: integer class ids, or one-hot / soft targets of the logits'
    shape. Integer labels < 0 are ignored (out of the mean too).
    ``label_smoothing`` mixes the target with the uniform distribution.
    Integer labels pick their log-probability with a gather instead of the
    JAX package's one-hot product: the same sum, without a (tokens, vocab)
    one-hot tensor."""
    logits = logits.float()
    logp = torch.log_softmax(logits, dim=-1)
    mask = None
    if labels.dtype.is_floating_point:
        nll = -(labels.float() * logp).sum(dim=-1)
        if label_smoothing:
            a = float(label_smoothing)
            nll = (1.0 - a) * nll - a / logits.shape[-1] * logp.sum(dim=-1)
    else:
        mask = (labels >= 0).float()
        idx = labels.long().clamp_min(0)[..., None]
        nll = -logp.gather(-1, idx)[..., 0]
        if label_smoothing:
            a = float(label_smoothing)
            nll = (1.0 - a) * nll - a / logits.shape[-1] * logp.sum(dim=-1)
    if weight is not None:
        nll = nll * weight
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()
