"""GPT-2 weights made from a run's seed, on the device, in a few calls.

GPT-2's own initialisation (``initializer_range`` of the configuration):
every embedding and kernel normal(0, 0.02), the two residual projections
of each block (attention out, MLP proj) scaled by 1 / sqrt(2 n_layer) as
the GPT-2 paper prescribes, biases 0, LayerNorm scales 1. The normal
draws come from one ``torch.Generator`` on the device, in one call over
all of them, in float32: the masters the program keeps.

Keys are the flat names of the program's JAX-layout parameter tree
(``h3.attn.qkv_kernel``); kernels are (in, out). ``nest`` gives the tree
the program loads; the plain reference reads the flat dict.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def gpt2_shapes(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every weight: init is "normal", "resid"
    (the scaled projections), "zeros" or "ones"."""
    d, v, n = cfg["n_embd"], cfg["vocab_size"], cfg["n_positions"]
    out = [("wte.table", (v, d), "normal"), ("wpe.pos", (n, d), "normal")]
    for i in range(cfg["n_layer"]):
        h = f"h{i}."
        out += [(h + "ln1.scale", (d,), "ones"), (h + "ln1.bias", (d,), "zeros"),
                (h + "attn.qkv_kernel", (d, 3 * d), "normal"),
                (h + "attn.qkv_bias", (3 * d,), "zeros"),
                (h + "attn.out_kernel", (d, d), "resid"),
                (h + "attn.out_bias", (d,), "zeros"),
                (h + "ln2.scale", (d,), "ones"), (h + "ln2.bias", (d,), "zeros"),
                (h + "fc.kernel", (d, 4 * d), "normal"),
                (h + "fc.bias", (4 * d,), "zeros"),
                (h + "proj.kernel", (4 * d, d), "resid"),
                (h + "proj.bias", (d,), "zeros")]
    out += [("ln_f.scale", (d,), "ones"), ("ln_f.bias", (d,), "zeros")]
    return out


def make_gpt2(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The flat dict of float32 weights for ``seed`` on ``device``."""
    shapes = gpt2_shapes(cfg)
    std = float(cfg["initializer_range"])
    resid = std / math.sqrt(2 * cfg["n_layer"])
    drawn = [(name, shape, init) for name, shape, init in shapes
             if init in ("normal", "resid")]
    total = sum(math.prod(s) for _, s, _ in drawn)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.normal_(0.0, 1.0, generator=gen)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, init in shapes:
        if init in ("normal", "resid"):
            n = math.prod(shape)
            w = flat[at:at + n].view(shape)
            w.mul_(std if init == "normal" else resid)
            out[name] = w
            at += n
        elif init == "zeros":
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
        else:
            out[name] = torch.ones(shape, dtype=torch.float32, device=device)
    return out


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """The nested tree of a flat dict (``h0.attn.qkv_kernel`` ->
    ``tree["h0"]["attn"]["qkv_kernel"]``)."""
    tree: Dict = {}
    for name, value in flat.items():
        node = tree
        *parts, leaf = name.split(".")
        for p in parts:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree
