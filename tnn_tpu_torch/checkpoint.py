"""The ``.tnn`` model file (``tnn_tpu.checkpoint``), byte-compatible with
the JAX package's: a file either package writes, the other reads.

Layout: the magic ``TNNTPU1\\n``, a little-endian u64 header length, the
JSON header ``{"tensors": [{"key", "dtype", "shape", "offset", "nbytes"},
...], "meta": {...}}``, then each tensor's raw C-order bytes back to back.
Keys are tree paths ("params/h0/attn/qkv_kernel"), dict keys in sorted
order as JAX flattens them. ``save_model`` stores the model's config
(``get_config()``) as ``meta["model_config"]``; ``load_model`` rebuilds
the model from it (``core.module.module_from_config``) and copies the
file's weights in through ``load_jax_params``.

Tensors come back as CPU ``torch`` tensors. A ``bfloat16`` entry is read
as int16 and reinterpreted as ``torch.bfloat16``: no ``ml_dtypes``
needed. Files store float weights: ``save_tensors`` refuses an
``Int8Weight`` leaf (quantize after loading, ``nn.quant``).

The JAX package's training ``Checkpoint`` (optimizer moments, step, rng,
loader cursor) is not ported: it comes with ``train/loop.py``, ROADMAP
section 1 item 10.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .core.module import module_from_config
from .ops.quant_matmul import Int8Weight

_MAGIC = b"TNNTPU1\n"


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{"a/b/c": leaf} in JAX's flattening order: dict keys sorted, list
    items by index."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def _host_bytes(leaf) -> Tuple[str, list, np.ndarray]:
    """(dtype name, shape, C-order uint8 view) of a tensor or array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).replace("torch.", "")
        shape = list(t.shape)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return name, shape, t.numpy().reshape(-1).view(np.uint8)
    arr = np.ascontiguousarray(np.asarray(leaf))
    return str(arr.dtype), list(arr.shape), arr.reshape(-1).view(np.uint8)


def save_tensors(path: str, trees: Dict[str, Any], meta=None) -> None:
    """Write named trees (nested dicts of tensors or arrays) to one file;
    keys become "section/leaf/path". Written to ``path + ".tmp"`` and
    renamed, so a crash leaves no torn file."""
    for section, tree in trees.items():
        for leaf in _flatten(tree).values():
            if isinstance(leaf, Int8Weight):
                raise ValueError(
                    f"section {section!r} contains Int8Weight leaves: "
                    "checkpoints store float params; quantize AFTER load "
                    "(nn.quant.quantize_for_decode)")
    entries, blobs = [], []
    offset = 0
    for section, tree in trees.items():
        for key, leaf in _flatten(tree).items():
            name, shape, raw = _host_bytes(leaf)
            entries.append({"key": f"{section}/{key}" if key else section,
                            "dtype": name, "shape": shape, "offset": offset,
                            "nbytes": int(raw.nbytes)})
            blobs.append(raw)
            offset += raw.nbytes
    header = json.dumps({"tensors": entries, "meta": meta or {}}).encode()
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        for raw in blobs:
            f.write(raw.data)
    os.replace(tmp, path)


def _tensor(buf: bytearray, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        flat = (torch.frombuffer(buf, dtype=torch.int16) if buf
                else torch.empty(0, dtype=torch.int16))
        return flat.view(torch.bfloat16).reshape(shape)
    return torch.from_numpy(np.frombuffer(buf, np.dtype(dtype))).reshape(
        shape)


def _read_header(f, path: str) -> Dict:
    if f.read(len(_MAGIC)) != _MAGIC:
        raise ValueError(f"{path}: not a TNNTPU tensor file")
    (hlen,) = struct.unpack("<Q", f.read(8))
    return json.loads(f.read(hlen))


def read_tensor_file_header(path: str) -> Tuple[list, Dict]:
    """(tensor entries, meta) of a ``.tnn`` file, without its data."""
    with open(path, "rb") as f:
        header = _read_header(f, path)
    return header["tensors"], header.get("meta", {})


def read_tensor_file(path: str) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """({key: CPU tensor}, meta) of a ``.tnn`` file."""
    with open(path, "rb") as f:
        header = _read_header(f, path)
        base = f.tell()
        out = {}
        for e in header["tensors"]:
            f.seek(base + e["offset"])
            buf = bytearray(e["nbytes"])
            if f.readinto(buf) != e["nbytes"]:
                raise ValueError(f"{path}: {e['key']} is truncated")
            out[e["key"]] = _tensor(buf, e["dtype"], e["shape"])
    return out, header.get("meta", {})


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    nested: Dict[str, Any] = {}
    for key, leaf in flat.items():
        parts = key.split("/")
        node = nested
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return nested


def load_tensors(path: str, templates: Dict[str, Any]) \
        -> Tuple[Dict[str, Any], Dict]:
    """Load sections into trees shaped like ``templates`` (nested dicts
    whose leaves have ``.shape``). The keys must match exactly and every
    shape must agree: a mismatch raises, never loads in part."""
    flat, meta = read_tensor_file(path)
    return _sections(flat, templates), meta


def _sections(flat: Dict[str, torch.Tensor], templates: Dict[str, Any]) \
        -> Dict[str, Any]:
    out = {}
    for section, template in templates.items():
        tmpl = _flatten(template)
        want = {f"{section}/{k}" if k else section for k in tmpl}
        have = {k for k in flat
                if k == section or k.startswith(section + "/")}
        if want != have:
            missing, surplus = sorted(want - have), sorted(have - want)
            raise KeyError(f"checkpoint section {section!r} mismatch: "
                           f"missing={missing[:5]} surplus={surplus[:5]}")
        for key, leaf in tmpl.items():
            full = f"{section}/{key}" if key else section
            if tuple(flat[full].shape) != tuple(leaf.shape):
                raise ValueError(f"{full}: shape {tuple(flat[full].shape)} "
                                 f"!= template {tuple(leaf.shape)}")
        out[section] = _nest({k[len(section) + 1:]: v
                              for k, v in flat.items() if k in want})
    return out


def save_model(path: str, model) -> None:
    """One-file snapshot of a port ``GPT2`` or ``Llama``: its config and
    its parameters as the JAX package's tree."""
    save_tensors(path, {"params": model.jax_param_tree()},
                 meta={"model_config": model.get_config()})


def load_model(path: str, device="cuda"):
    """The model a ``.tnn`` file describes, with the file's weights, on
    ``device`` ("cuda" by default; raises without a card)."""
    flat, meta = read_tensor_file(path)
    model = module_from_config(meta["model_config"], device=device)
    template = _nest({"/".join(p): w for p, w in model.jax_param_paths()})
    model.load_jax_params(_sections(flat, {"params": template})["params"])
    return model
