"""The ``.tnn`` model file (``tnn_tpu.checkpoint``), byte-compatible with
the JAX package's: a file either package writes, the other reads.

Layout: the magic ``TNNTPU1\\n``, a little-endian u64 header length, the
JSON header ``{"tensors": [{"key", "dtype", "shape", "offset", "nbytes"},
...], "meta": {...}}``, then each tensor's raw C-order bytes back to back.
Keys are tree paths ("params/h0/attn/qkv_kernel"), dict keys in sorted
order as JAX flattens them. ``save_model`` stores the model's config
(``get_config()``) as ``meta["model_config"]``, and a model with state
(BatchNorm's running statistics) its ``net_state`` section;
``load_model`` rebuilds the model from the config
(``core.module.module_from_config``; an image model also needs the
``input_shape`` it was sized for, as the JAX package's ``load_model``
does) and copies the file's weights in through ``load_jax_params`` and
its ``net_state``, where the file has one, through ``load_jax_state``.

Tensors come back as CPU ``torch`` tensors. A ``bfloat16`` entry is read
as int16 and reinterpreted as ``torch.bfloat16``: no ``ml_dtypes``
needed. Files store float weights: ``save_tensors`` refuses an
``Int8Weight`` leaf (quantize after loading, ``nn.quant``).

``Checkpoint`` snapshots the whole training state in the JAX package's
directory layout: ``<dir>/step_<N>/state.tnn`` and then ``meta.json``,
whose presence marks a complete snapshot; ``<dir>/best/`` for the best
validation; the newest ``keep`` step directories kept. ``state.tnn``
holds ``params`` and ``opt_state`` under the JAX tree paths (the mapping
``save_model`` uses), ``net_state`` where the model has state buffers,
``step`` as a 0-d int32 and ``rng``, the port's generator state (uint8);
``meta.json`` the step, the model config, the scheduler's config and
state, the loader's ``state_dict`` and the caller's extras. Either package's directory restores into the port: a
JAX-written ``rng`` (a PRNG key, two uint32 words k0, k1) seeds the
port's generator with ``manual_seed((k0 << 32) | k1)``, since a JAX key
cannot set a ``torch.Generator``'s state; params, moments and step load
as written.
"""
from __future__ import annotations

import atexit
import json
import os
import shutil
import struct
import sys
import threading
from typing import Any, Dict, Optional, Tuple

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
    """One-file snapshot of a port model: its config, its parameters as
    the JAX package's tree and, where it has state, its ``net_state``."""
    trees = {"params": model.jax_param_tree()}
    net_state = model.jax_state_tree()
    if net_state:
        trees["net_state"] = net_state
    save_tensors(path, trees, meta={"model_config": model.get_config()})


def load_model(path: str, device="cuda", input_shape=None):
    """The model a ``.tnn`` file (``save_model``'s, or a ``Checkpoint``'s
    ``state.tnn``) describes, with the file's weights and state, on
    ``device`` ("cuda" by default; raises without a card). An image
    model is sized for per-sample inputs of ``input_shape``."""
    flat, meta = read_tensor_file(path)
    model = module_from_config(meta["model_config"], device=device,
                               input_shape=input_shape)
    templates = {"params": _nest({"/".join(p): w
                                  for p, w in model.jax_param_paths()})}
    state = {"/".join(p): b for p, b in model.jax_state_paths()}
    if state and any(k.startswith("net_state/") for k in flat):
        templates["net_state"] = _nest(state)
    loaded = _sections(flat, templates)
    model.load_jax_params(loaded["params"])
    if "net_state" in loaded:
        model.load_jax_state(loaded["net_state"])
    return model


class Checkpoint:
    """Directory checkpoints of the whole training state, with retention
    of the newest ``keep`` step directories."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = int(keep)
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # a block=False save still writing at exit would be cut off (its
        # thread is a daemon): join it
        atexit.register(self._join_at_exit)

    def _join_at_exit(self) -> None:
        try:
            self.wait()
        except Exception as e:  # noqa: BLE001 — exit path: report only
            print(f"checkpoint: async save failed at exit: {e}",
                  file=sys.stderr)

    def save(self, train_state, model=None, scheduler=None, loader=None,
             extra: Optional[Dict] = None, best: bool = False,
             block: bool = True) -> str:
        """Snapshot the training state; returns the snapshot's directory.

        Every parameter and moment is copied to the host before this call
        returns, with or without ``block``: the optimizer updates them in
        place, so a writer that read them later would race the next step.
        ``block=False`` then writes the file on a thread (one save at a
        time; a new save joins the previous one); ``wait()`` joins it and
        raises its failure. A parallel run's state whose leaves are
        sharded across processes is refused (``ValueError``), as JAX's
        ``device_get`` refuses such an array (``DataParallel.check_fetch``).
        """
        from .train.step import train_state_trees

        check = getattr(train_state.layout, "check_fetch", None)
        if check is not None:
            check(train_state)
        step = int(train_state.step)
        target = os.path.join(self.directory,
                              "best" if best else f"step_{step}")
        meta: Dict[str, Any] = {"step": step, "extra": extra or {}}
        if model is not None:
            meta["model_config"] = model.get_config()
        if scheduler is not None:
            meta["scheduler"] = {"config": scheduler.get_config(),
                                 "state": scheduler.state_dict()}
        if loader is not None:
            meta["loader"] = loader.state_dict()
        trees = train_state_trees(train_state)
        trees["rng"] = train_state.generator.get_state()

        def write():
            os.makedirs(target, exist_ok=True)
            save_tensors(os.path.join(target, "state.tnn"), trees, meta=meta)
            with open(os.path.join(target, "meta.json"), "w") as f:
                json.dump(meta, f, indent=2, default=str)
            if not best:
                self._gc()

        self.wait()     # writes stay in order
        if block:
            write()
        else:
            def guarded():
                try:
                    write()
                except BaseException as e:  # noqa: BLE001 — for wait()
                    self._error = e

            self._pending = threading.Thread(target=guarded, daemon=True)
            self._pending.start()
        return target

    def wait(self) -> None:
        """Join a ``block=False`` save in flight and raise its failure (a
        missing checkpoint must not pass for a written one)."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
            err, self._error = self._error, None
            if err is not None:
                raise err

    def _gc(self) -> None:
        steps = sorted(self._step_dirs())
        for s in steps[:max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    def _step_dirs(self):
        if not os.path.isdir(self.directory):
            return []
        out = []
        for d in os.listdir(self.directory):
            # meta.json is written after state.tnn: a directory without it
            # is a torn snapshot, neither restorable nor counted
            if not d.startswith("step_") or not os.path.isfile(
                    os.path.join(self.directory, d, "meta.json")):
                continue
            try:
                out.append(int(d[5:]))
            except ValueError:
                pass
        return out

    def latest_path(self) -> Optional[str]:
        """The newest complete step directory; else ``directory`` itself
        when it holds a snapshot (``.../best``, ``.../step_120``)."""
        steps = self._step_dirs()
        if steps:
            return os.path.join(self.directory, f"step_{max(steps)}")
        if os.path.isfile(os.path.join(self.directory, "state.tnn")):
            return self.directory
        return None

    def restore(self, train_state, path: Optional[str] = None,
                scheduler=None, loader=None):
        """Fill ``train_state`` (a fresh ``create_train_state``) from the
        newest snapshot, or ``path``, in place; set the scheduler's and
        the loader's state too. Returns ``(train_state, meta)``. Every key
        and shape must match the state's: a mismatch raises before
        anything is copied."""
        from .train.step import load_jax_train_state, train_state_trees

        path = path or self.latest_path()
        if path is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        flat, meta = read_tensor_file(os.path.join(path, "state.tnn"))
        want = train_state_trees(train_state)
        loaded = _sections(flat, {k: want[k] for k in
                                  ("params", "opt_state", "net_state")
                                  if k in want})
        load_jax_train_state(train_state, params=loaded["params"],
                             opt_state=loaded["opt_state"],
                             net_state=loaded.get("net_state"),
                             step=flat["step"])
        rng = flat["rng"]
        if rng.dtype == torch.uint8:
            train_state.generator.set_state(rng.contiguous())
        else:
            k0, k1 = (int(w) & 0xFFFFFFFF for w in rng.reshape(-1)[:2])
            train_state.generator.manual_seed((k0 << 32) | k1)
        if scheduler is not None and "scheduler" in meta:
            scheduler.load_state_dict(meta["scheduler"].get("state") or {})
        if loader is not None and "loader" in meta:
            loader.load_state_dict(meta["loader"])
        return train_state, meta
