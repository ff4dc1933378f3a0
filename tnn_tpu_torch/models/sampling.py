"""Token sampling with per-row parameters (``tnn_tpu.models.sampling``).

``filter_logits`` gives the distribution a row samples from;
``make_sampler`` binds the parameters of one sampler;
``sample_ragged`` draws from it with an explicit ``torch.Generator``
(Gumbel-max, as ``jax.random.categorical``), greedy where temperature <= 0.
The two frameworks' random bits differ, so streams agree token for token
only under greedy decoding.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30  # large-negative beats -inf: 0*inf NaN hazards


def _per_row(value, rows, dtype, device):
    x = torch.as_tensor(value, dtype=dtype, device=device)
    return x.broadcast_to(rows)[..., None]


def _top_p_filter(x, p):
    """Nucleus filter over scaled logits: a token survives while the mass
    before it is below ``p``; the most probable token always survives."""
    down = torch.sort(x, dim=-1, descending=True).values
    probs = torch.softmax(down, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    keep = (csum - probs) < p
    cutoff = torch.where(keep, down, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(x < cutoff, NEG_INF, x)


def filter_logits(logits, temperature, top_k, top_p):
    """Temperature-scale, then top-k, then top-p over the survivors; returns
    float32 filtered logits. Per row: temperature <= 0 scales by 1; top_k
    <= 0 or >= V keeps all; top_p outside (0, 1) keeps all. Parameters are
    scalars or tensors broadcastable to ``logits.shape[:-1]``."""
    logits = logits.float()
    v = logits.shape[-1]
    rows = logits.shape[:-1]
    dev = logits.device
    t = _per_row(temperature, rows, torch.float32, dev)
    k = _per_row(top_k, rows, torch.int64, dev)
    p = _per_row(top_p, rows, torch.float32, dev)
    x = logits / torch.where(t > 0.0, t, 1.0)
    k_eff = torch.where((k > 0) & (k < v), k, v)
    down = torch.sort(x, dim=-1, descending=True).values
    kth = down.gather(-1, k_eff - 1)
    x = torch.where(x < kth, NEG_INF, x)
    p_eff = torch.where((p > 0.0) & (p < 1.0), p, 1.0)
    return _top_p_filter(x, p_eff)


def sample_ragged(logits, generator: torch.Generator, temperature, top_k,
                  top_p):
    """Sample one token per row with per-row temperature / top-k / top-p;
    rows with temperature <= 0 take the argmax. ``generator`` lives on the
    logits' device. Returns int64 token ids of shape ``logits.shape[:-1]``."""
    logits = logits.float()
    rows = logits.shape[:-1]
    t = torch.as_tensor(temperature, dtype=torch.float32,
                        device=logits.device).broadcast_to(rows)
    greedy = logits.argmax(dim=-1)
    x = filter_logits(logits, temperature, top_k, top_p)
    noise = torch.empty_like(x).exponential_(generator=generator)
    sampled = (x - noise.log()).argmax(dim=-1)   # Gumbel-max
    return torch.where(t > 0.0, sampled, greedy)


def make_sampler(temperature=0.0, top_k=0, top_p=0.0):
    """A ``(logits (..., V), generator) -> (...,)`` int64 sampler.

    temperature <= 0 is greedy (top_k / top_p ignored). Otherwise the
    logits are scaled by the temperature, filtered to the k largest
    (top_k > 0) and then to the smallest set whose probability reaches
    top_p (0 < top_p < 1), and a token is drawn with ``generator``. Any
    parameter may be a per-row tensor or array broadcastable to the
    logits' row dims (rows with temperature <= 0 stay greedy)."""
    per_row = any(getattr(x, "ndim", 0) for x in (temperature, top_k, top_p))
    if not per_row and float(temperature) <= 0.0:
        def greedy(logits, generator=None):
            return logits.argmax(dim=-1)
        return greedy

    def sample(logits, generator):
        return sample_ragged(logits, generator, temperature, top_k, top_p)
    return sample
