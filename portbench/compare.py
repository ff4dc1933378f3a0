"""The comparisons that decide ``correct``: the program's outputs against
the plain reference's, each reduced to one number held to a limit.

- Served tokens: the reference runs once over each sampled request's
  prompt and served tokens; at each served position it reads how far the
  served token's logit lies below its own best (greedy decoding serves
  the best token, so exact arithmetic reads 0).
- Training: each step's loss as a relative gap; the first gradient's and
  the three steps' weight change's norms leaf by leaf, as the gap between
  the program's norm and the reference's over the larger of the
  reference's norm of that leaf and of the median leaf, the worst leaf
  reported. Leaves whose reference gradient is under a thousandth of the
  median leaf's move under Adam by round-off alone and are left out by
  that rule; inside a leaf, the change leaves out the elements whose
  reference gradient is under a thousandth of the median leaf's
  root-mean-square element (GPT-2's key bias, a third of the fused qkv
  bias: softmax ignores a per-row constant).
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence, Tuple

import torch

from .reference import gpt2 as ref

# a leaf whose reference gradient norm is under this share of the median
# leaf's is left out of the leaf comparisons
ROUNDOFF_LEAF = 1e-3


def served_gaps(p: ref.Params, cfg: dict,
                served: Sequence[Tuple[Sequence[int], Sequence[int]]],
                device) -> torch.Tensor:
    """How far each served token's logit lies below the reference's best
    at its position, over (prompt, served tokens) pairs, as one float64
    vector on the host (greedy decoding serves the best token, so exact
    arithmetic reads 0 everywhere)."""
    out = []
    with torch.no_grad():
        for prompt, toks in served:
            ids = torch.tensor(list(prompt) + list(toks[:-1]),
                               dtype=torch.long, device=device)[None]
            lg = ref.logits(p, ids, cfg)[0, len(prompt) - 1:]
            t = torch.tensor(list(toks), dtype=torch.long,
                             device=device)[:, None]
            out.append((lg.max(dim=-1).values - lg.gather(-1, t)[:, 0])
                       .double().cpu())
            del lg
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.float64)


def leaf_norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's norm, summed in float64."""
    return {k: float(v.double().norm()) for k, v in tree.items()}


def kept_leaves(ref_grad_norms: Dict[str, float]) -> List[str]:
    """The leaves the leaf comparisons hold: reference gradient norm at
    least ``ROUNDOFF_LEAF`` of the median leaf's."""
    med = statistics.median(ref_grad_norms.values())
    return sorted(k for k, v in ref_grad_norms.items()
                  if v >= ROUNDOFF_LEAF * med)


def leaf_gaps(prog: Dict[str, float], refn: Dict[str, float],
              keep: Sequence[str]) -> Dict[str, float]:
    """| |prog_k| - |ref_k| | / max(|ref_k|, median |ref|) for each kept
    leaf's norm (infinite where a leaf is missing or not finite)."""
    med = statistics.median(refn[k] for k in keep)
    out = {}
    for k in keep:
        gap = abs(prog.get(k, math.nan) - refn[k]) / max(refn[k], med)
        out[k] = gap if math.isfinite(gap) else math.inf
    return out


def roundoff_floor(ref_grad: Dict[str, torch.Tensor]) -> float:
    """``ROUNDOFF_LEAF`` of the median leaf's root-mean-square reference
    gradient: an element whose reference gradient is under it (the key
    bias's third of a fused qkv bias, embedding rows no token reached)
    moves under Adam by round-off alone."""
    return ROUNDOFF_LEAF * statistics.median(
        float(g.double().norm()) / math.sqrt(g.numel())
        for g in ref_grad.values())


def change_norms(delta: Dict[str, torch.Tensor],
                 ref_grad: Dict[str, torch.Tensor], floor: float
                 ) -> Dict[str, float]:
    """Each leaf's change norm over the elements whose reference gradient
    reaches ``floor``."""
    out = {}
    for k, g in ref_grad.items():
        d = delta[k].to(g.device)
        out[k] = float(d[g.abs() >= floor].double().norm())
    return out


def loss_gap(prog: Sequence[float], refl: Sequence[float]) -> float:
    """The largest relative gap of one step's loss (infinite where the
    program's loss is not finite)."""
    gaps = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
            for a, b in zip(prog, refl)]
    return max(gaps) if len(gaps) == len(refl) else math.inf
