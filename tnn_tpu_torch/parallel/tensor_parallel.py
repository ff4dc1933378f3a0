"""Tensor (model) parallelism's sharding rules
(``tnn_tpu.parallel.tensor_parallel``).

Rules are (regex on a leaf's path in the JAX parameter tree) -> spec, in
the JAX package's order; the first match wins and an unmatched leaf is
replicated. A spec is a tuple like JAX's ``PartitionSpec``: ``()``
replicated, ``(None, "model")`` sharded on dim 1. Transformer blocks shard
qkv / fc / gate / up by columns and out / proj / down by rows (Megatron);
the token table shards over the vocabulary. The lookbehind keeps the MoE
router's ``moe/gate/kernel`` replicated, and the ``.+/`` prefix keeps a
bare tree's top-level ``gate/kernel`` (a lone MoE's) replicated.

``parallel.data_parallel`` runs these layouts (``make_dp_train_step(
tp=True)``): each "model" position holds its pieces, the fused qkv
columns taken per head (``_permute_qkv``, which serving's TP shares) so
a position holds whole heads, and one ``mesh.all_reduce`` follows each
row-parallel product.
"""
from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

import torch

from .mesh import Mesh

Spec = Tuple

DEFAULT_TP_RULES: List[Tuple[str, Spec]] = [
    (r".*attn/qkv_kernel$", (None, "model")),
    (r".*attn/qkv_bias$", ("model",)),
    (r".*attn/out_kernel$", ("model", None)),
    (r".*attn/out_bias$", ()),
    (r".*fc/kernel$", (None, "model")),
    (r".*fc/bias$", ("model",)),
    (r".*proj/kernel$", ("model", None)),
    (r".*proj/bias$", ()),
    (r".+/(?<!moe/)gate/kernel$", (None, "model")),
    (r".+/up/kernel$", (None, "model")),
    (r".+/down/kernel$", ("model", None)),
    (r".*wte/table$", ("model", None)),
    (r".*embedding/table$", ("model", None)),
]


def _key(path) -> str:
    return path if isinstance(path, str) else "/".join(path)


def spec_tree(params, rules: Optional[Sequence[Tuple[str, Spec]]] = None,
              _prefix: Tuple[str, ...] = ()):
    """The spec of every leaf of ``params`` (nested dicts, as the JAX
    parameter tree) by the path rules (``DEFAULT_TP_RULES`` by default),
    in the same nesting."""
    rules = list(rules) if rules is not None else DEFAULT_TP_RULES
    if isinstance(params, dict):
        return {k: spec_tree(v, rules, _prefix + (str(k),))
                for k, v in params.items()}
    return spec_for(_prefix, rules)


def spec_for(path, rules: Optional[Sequence[Tuple[str, Spec]]] = None
             ) -> Spec:
    """The spec of one leaf by its JAX path (a tuple of keys or a
    "/"-joined string)."""
    rules = list(rules) if rules is not None else DEFAULT_TP_RULES
    key = _key(path)
    for pat, spec in rules:
        if re.match(pat, key):
            return tuple(spec)
    return ()


def _permute_qkv(w: torch.Tensor, num_heads: int, num_kv_heads: int,
                 head_dim: int, tp: int) -> torch.Tensor:
    """Reorder fused-qkv columns ``[q | k | v]`` into per-shard groups
    ``[q_s | k_s | v_s]`` so that an even column split is head-aligned."""
    d, kv_d = num_heads * head_dim, num_kv_heads * head_dim
    lead = tuple(w.shape[:-1])
    q, k, v = w[..., :d], w[..., d:d + kv_d], w[..., d + kv_d:]
    q = q.reshape(lead + (tp, d // tp))
    k = k.reshape(lead + (tp, kv_d // tp))
    v = v.reshape(lead + (tp, kv_d // tp))
    return torch.cat([q, k, v], dim=-1).reshape(lead + (-1,))


def _unpermute_qkv(w, heads, kv_heads, head_dim, tp):
    """The inverse of ``_permute_qkv``: per-position groups back to
    ``[q | k | v]``."""
    d, kv_d = heads * head_dim, kv_heads * head_dim
    lead = tuple(w.shape[:-1])
    g = w.reshape(lead + (tp, (d + 2 * kv_d) // tp))
    q, k, v = g.split([d // tp, kv_d // tp, kv_d // tp], dim=-1)
    return torch.cat([t.reshape(lead + (-1,)) for t in (q, k, v)], dim=-1)


def shard_params_tp(params, mesh: Mesh, rules=None):
    """Each leaf placed per the TP rules (``data_parallel.place_by_specs``:
    one tensor a data x fsdp position); unmatched leaves replicate."""
    from .data_parallel import place_by_specs

    return place_by_specs(params, mesh, spec_tree(params, rules))


def logical_constraint(x, mesh: Mesh, spec: Spec):
    """The identity. The JAX package pins an activation's sharding here
    (``with_sharding_constraint``) so GSPMD lays the program out as asked;
    in one process the lockstep forward already holds each activation
    where its layout puts it, so there is nothing to constrain."""
    del mesh, spec
    return x
