"""Processes that train one model together (``jax.distributed``).

``initialize(coordinator, num_processes, process_id, device)`` joins this
process to a ``torch.distributed`` group through a TCP store at the
coordinator's ``host:port`` (process 0 hosts it), the address that the
JAX package's workers hand to ``jax.distributed.initialize``: one
``jax_coordinator`` config deploys to either package's workers.

Each process contributes its local devices, one mesh position each
(``local_devices``, by default ``[device]``); ``global_positions()`` is
every process's in JAX's order, process-major, each process's local
devices in turn, and ``parallel.make_mesh`` lays a mesh over its first
entries. Processes exchange their devices over the store first, and the
backend follows from them once, before the group exists
(``choose_backend``): NCCL where every rank holds a card of its own,
gloo where ranks share a card (NCCL refuses two ranks on one device) or
run on the CPU. A failed call never switches it.

The collectives are ``all_reduce`` alone, which gloo runs on CUDA
tensors too: ``all_reduce`` (differentiable: its backward all-reduces
the gradient, JAX's ``psum`` transpose), ``all_reduce_flat`` (many
tensors in one call a dtype, as a step's gradients travel) and
``assert_equal`` (a digest of a value's host bytes compared over the
group, the check JAX's ``device_put`` makes of a host value put onto a
mesh that spans processes).
"""
from __future__ import annotations

import datetime
import hashlib
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

_STATE: Optional[Dict[str, object]] = None


def _indexed(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def device_id(dev: torch.device) -> str:
    """What tells cards apart across processes: a card's UUID, "cpu" for
    the host."""
    if dev.type != "cuda":
        return dev.type
    return str(torch.cuda.get_device_properties(dev).uuid)


def choose_backend(ranks_devices: Sequence[Sequence[str]]
                   ) -> Tuple[str, str]:
    """(backend, reason) for ranks holding the devices ``device_id``
    names, one list a rank."""
    ids = [set(devs) for devs in ranks_devices]
    if any("cpu" in s for s in ids):
        return "gloo", "ranks on the CPU"
    if any(len(s) != 1 for s in ids):
        return "gloo", "a rank holds positions on several cards"
    cards = [next(iter(s)) for s in ids]
    if len(set(cards)) < len(cards):
        return "gloo", ("ranks share a card (NCCL cannot put two ranks on "
                        "one device)")
    return "nccl", "every rank holds a card of its own"


def initialize(coordinator: str, num_processes: int, process_id: int,
               device="cuda", local_devices: Optional[Sequence] = None,
               timeout_s: float = 600.0) -> str:
    """Join the group of ``num_processes`` processes as ``process_id``
    (the module docstring); returns the backend."""
    global _STATE
    if _STATE is not None:
        raise RuntimeError("the process group is already initialized")
    host, port = coordinator.rsplit(":", 1)
    device = _indexed(torch.device(device))
    local = [_indexed(torch.device(d)) for d in (local_devices or [device])]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, int(port), int(num_processes),
                          int(process_id) == 0, timeout)
    store.set(f"tnn/devices/{process_id}", json.dumps(
        {"names": [str(d) for d in local],
         "ids": [device_id(d) for d in local]}))
    infos = [json.loads(store.get(f"tnn/devices/{r}"))
             for r in range(int(num_processes))]
    backend, reason = choose_backend([i["ids"] for i in infos])
    dist.init_process_group(backend, store=store, rank=int(process_id),
                            world_size=int(num_processes), timeout=timeout)
    _STATE = {
        "rank": int(process_id), "world": int(num_processes),
        "backend": backend, "reason": reason, "store": store,
        "local": local,
        "positions": [(r, torch.device(n)) for r, i in enumerate(infos)
                      for n in i["names"]],
        # small control tensors (digests) travel on the host under gloo
        "control": device if backend == "nccl" else torch.device("cpu"),
    }
    return backend


def shutdown() -> None:
    """Leave the group (a no-op outside one)."""
    global _STATE
    if _STATE is None:
        return
    dist.destroy_process_group()
    _STATE = None


def is_initialized() -> bool:
    return _STATE is not None


def process_index() -> int:
    return 0 if _STATE is None else int(_STATE["rank"])


def process_count() -> int:
    return 1 if _STATE is None else int(_STATE["world"])


def backend() -> Optional[str]:
    return None if _STATE is None else str(_STATE["backend"])


def backend_reason() -> Optional[str]:
    return None if _STATE is None else str(_STATE["reason"])


def local_devices() -> List[torch.device]:
    return [] if _STATE is None else list(_STATE["local"])


def global_positions() -> List[Tuple[int, torch.device]]:
    """(process, device) of every position of the group, process-major
    (JAX's ``jax.devices()`` order)."""
    return [] if _STATE is None else list(_STATE["positions"])


# -- collectives ----------------------------------------------------------


def _reduce_(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
    if op not in ops:
        raise ValueError(f"unknown reduction {op!r}")
    dist.all_reduce(t, op=ops[op])
    return t


class _AllReduce(torch.autograd.Function):
    """The group's sum; its backward is the group's sum of the incoming
    gradient (each process's share of a value every process uses)."""

    @staticmethod
    def forward(ctx, x):
        return _reduce_(x.detach().contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return _reduce_(g.contiguous().clone())


def all_reduce(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """The sum (``op="max"``: the max, not differentiable) of ``x`` over
    the group, as a new tensor; differentiable where ``x`` requires
    grad."""
    if op == "sum" and torch.is_grad_enabled() and x.requires_grad:
        return _AllReduce.apply(x)
    return _reduce_(x.detach().contiguous().clone(), op)


def all_reduce_flat(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The group's sums of ``tensors`` (no grad), one collective a dtype:
    each dtype's tensors flattened into one buffer on its first tensor's
    device, since a collective's cost under gloo is mostly per call."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        dev = tensors[idx[0]].device
        flat = _reduce_(torch.cat([tensors[i].detach().reshape(-1).to(dev)
                                   for i in idx]))
        pieces = flat.split([tensors[i].numel() for i in idx])
        for i, piece in zip(idx, pieces):
            out[i] = piece.view(tensors[i].shape).to(tensors[i].device)
    return out


def _leaves(value):
    if isinstance(value, dict):
        for k in sorted(value):
            yield str(k).encode()
            yield from _leaves(value[k])
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _leaves(v)
    else:
        yield value


def digest(value) -> str:
    """A hex digest of ``value``'s host bytes (a tensor, an array, or
    dicts / lists / tuples of them), shapes and dtypes included."""
    h = hashlib.blake2b(digest_size=8)
    for leaf in _leaves(value):
        if isinstance(leaf, bytes):
            h.update(leaf)
            continue
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().to("cpu").contiguous()
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        else:
            a = np.ascontiguousarray(leaf)
            h.update(f"{a.dtype}{a.shape}".encode())
            h.update(a.tobytes())
    return h.hexdigest()


def assert_equal(value, what: str) -> str:
    """``value``'s digest, checked equal on every process of the group;
    a ``ValueError`` naming ``what`` and the ranks that hold another
    value than rank 0 otherwise (outside a group: the digest alone)."""
    d = digest(value)
    if _STATE is None:
        return d
    world, rank = int(_STATE["world"]), int(_STATE["rank"])
    table = torch.zeros(world, dtype=torch.int64, device=_STATE["control"])
    table[rank] = int.from_bytes(bytes.fromhex(d), "little", signed=True)
    got = _reduce_(table).tolist()
    differ = [r for r, v in enumerate(got) if v != got[0]]
    if differ:
        raise ValueError(
            f"{what} differs across processes: rank(s) {differ} hold "
            f"another value than rank 0 (a host value put onto a mesh that "
            f"spans processes must be equal on every process, as JAX's "
            f"device_put checks)")
    return d
