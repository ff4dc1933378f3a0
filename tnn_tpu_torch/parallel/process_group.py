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

Collectives run over the whole group or over a subgroup (``group``):
``subgroups(sets)`` makes one ``dist.new_group`` for each set of ranks
that holds more than one process and fewer than all (the whole group is
``dist``'s default), in the order given, which must be the same on every
process (``new_group`` requires it); ``parallel.mesh`` asks for the sets
of its axis slices once, when the mesh is made on every process. The
collectives: ``all_reduce`` (differentiable: its backward all-reduces
the gradient, JAX's ``psum`` transpose, for a share of a value that
every process's own loss uses), ``sum_forward`` and ``sum_backward``
(tensor parallelism's conjugate pair, for processes that compute one
loss: g sums in the forward and passes the gradient unchanged, f is the
identity in the forward and sums the gradient), ``all_reduce_flat``
(many tensors in one call a dtype, as a step's gradients travel),
``all_gather``, ``reduce_scatter``, ``all_to_all`` (differentiable: the
gradient goes back the way it came), the differentiable gathers
``gather_sum`` (its backward reduce-scatters: processes whose
downstreams differ) and ``gather_keep`` (its backward keeps this
process's entry: processes that compute the same downstream) and their
transpose ``take_own`` (this process's entry of a value every process
computes alike; its backward gathers), ``exchange`` (one tensor to one
rank and one from another, JAX's ``ppermute``; differentiable, the
gradient hops back), ``p2p`` (one round of one-way hops, a pipeline
tick's, every send and receive in flight at once; the pipeline drives
their gradients back itself) and ``assert_equal`` (a digest of a value's
host bytes compared over the group, the check JAX's ``device_put`` makes
of a host value put onto a mesh that spans processes).

Gloo (2.11) takes CUDA tensors in its collectives (all-reduce, gather,
reduce-scatter, all-to-all), moving them through the host itself, but
its send and receive write from the CUDA pointer and fail (``writev``:
Bad address; ``scripts/torch_gloo_probe.py``), so under gloo ``p2p``
(and ``exchange`` through it) copies a CUDA tensor to the host and its
result back; that follows from the backend, once, at ``initialize``. NCCL takes every call
on the card.
"""
from __future__ import annotations

import datetime
import hashlib
import json
from concurrent.futures import ThreadPoolExecutor
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
        # gloo's send / recv take host tensors only (module docstring)
        "host_p2p": backend == "gloo",
        "groups": {},
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


# -- subgroups ----------------------------------------------------------


def subgroups(sets: Sequence[Sequence[int]]) -> None:
    """Make the subgroup of each set of ranks not made yet, in the order
    given (the same on every process: the module docstring)."""
    if _STATE is None:
        return
    made = _STATE["groups"]
    world = int(_STATE["world"])
    for ranks in sets:
        key = tuple(sorted(set(int(r) for r in ranks)))
        if len(key) > 1 and len(key) < world and key not in made:
            made[key] = dist.new_group(list(key))


def group_of(ranks: Sequence[int]):
    """The subgroup over ``ranks`` (made by ``subgroups``), or None for
    the whole group."""
    key = tuple(sorted(set(int(r) for r in ranks)))
    if len(key) == int(_STATE["world"]):
        return None
    return _STATE["groups"][key]


def _ranks(group) -> List[int]:
    return list(range(int(_STATE["world"]))) if group is None \
        else dist.get_process_group_ranks(group)


# -- collectives ----------------------------------------------------------


def _reduce_(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
    if op not in ops:
        raise ValueError(f"unknown reduction {op!r}")
    dist.all_reduce(t, op=ops[op], group=group)
    return t


class _AllReduce(torch.autograd.Function):
    """The group's sum; its backward is the group's sum of the incoming
    gradient (each process's share of a value every process uses)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_(x.detach().contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_(g.contiguous().clone(), group=ctx.group), None


def all_reduce(x: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """The sum (``op="max"``: the max, not differentiable) of ``x`` over
    the group, as a new tensor; differentiable where ``x`` requires
    grad."""
    if op == "sum" and torch.is_grad_enabled() and x.requires_grad:
        return _AllReduce.apply(x, group)
    return _reduce_(x.detach().contiguous().clone(), op, group)


class _SumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce_(x.detach().contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce_(g.contiguous().clone(), group=ctx.group), None


def sum_forward(x: torch.Tensor, group=None) -> torch.Tensor:
    """Tensor parallelism's g: the sum over ``group`` of each process's
    part of one value, whose gradient every process already holds whole
    (they compute the same loss): the gradient passes unchanged."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _SumForward.apply(x, group)
    return _reduce_(x.detach().contiguous().clone(), group=group)


def sum_backward(x: torch.Tensor, group=None) -> torch.Tensor:
    """Tensor parallelism's f: ``x`` itself, whose gradient is the sum
    over ``group`` of each process's part of it."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _SumBackward.apply(x, group)
    return x


def all_reduce_flat(tensors: Sequence[torch.Tensor], group=None
                    ) -> List[torch.Tensor]:
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
                                   for i in idx]), group=group)
        pieces = flat.split([tensors[i].numel() for i in idx])
        for i, piece in zip(idx, pieces):
            out[i] = piece.view(tensors[i].shape).to(tensors[i].device)
    return out


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every process's ``x`` (equal shapes), stacked on a new dim 0 in
    rank order, on ``x``'s device (no grad)."""
    return _gather(x, group)


def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the group of ``x`` (dim 0 one entry a process, in
    rank order), this process's entry of it (no grad)."""
    t = x.detach().contiguous()
    n = len(_ranks(group))
    if t.shape[0] != n:
        raise ValueError(f"reduce_scatter takes one entry a process on dim "
                         f"0: {n}, got {t.shape[0]}")
    out = torch.empty_like(t[0])
    dist.reduce_scatter(out, list(t.unbind(0)), group=group)
    return out


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    t = x.detach().contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x``'s dim 0 (one entry a process, in rank order) sent entry j to
    process j; entry i of the result came from process i. Differentiable:
    the gradient of each entry goes back to where it came from."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllToAll.apply(x, group)
    return _all_to_all(x, group)


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    t = x.detach().contiguous()
    parts = [torch.empty_like(t) for _ in _ranks(group)]
    dist.all_gather(parts, t, group=group)
    return torch.stack(parts)


def _mine(group) -> int:
    return _ranks(group).index(int(_STATE["rank"]))


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group), None


class _GatherKeep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return g[_mine(ctx.group)].contiguous(), None


class _TakeOwn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x[_mine(group)].clone()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group), None


def gather_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every process's ``x`` stacked on a new dim 0 in rank order; its
    backward reduce-scatters: the gradient of this process's ``x`` is the
    sum of every process's gradient of its entry, for processes whose
    downstream computations differ (each holds a part of the loss)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherSum.apply(x, group)
    return _gather(x, group)


def gather_keep(x: torch.Tensor, group=None) -> torch.Tensor:
    """``gather_sum``'s forward; its backward keeps this process's entry
    of the gradient unsummed, for processes that all compute the same
    downstream from the gathered value (each holds the whole gradient)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherKeep.apply(x, group)
    return _gather(x, group)


def take_own(x: torch.Tensor, group=None) -> torch.Tensor:
    """This process's entry (dim 0, rank order) of a value every process
    of ``group`` computes alike; its backward gathers every process's
    gradient of its own entry, so each process holds the gradient of the
    whole value (``gather_keep``'s transpose)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _TakeOwn.apply(x, group)
    return x[_mine(group)].clone()


def p2p(sends: Sequence[Tuple[torch.Tensor, int]],
        recvs: Sequence[Tuple[Tuple[int, ...], torch.dtype, int,
                              torch.device]],
        group=None) -> List[torch.Tensor]:
    """One round of point-to-point hops, every send and receive in
    flight at once (a process may send to the process it receives from,
    or only send, or only receive: a pipeline's tick):
    ``sends`` are (tensor, global rank) pairs, ``recvs`` (shape, dtype,
    global rank, device) of what comes back, in an order both sides
    agree on. Under gloo through the host (the module docstring). No
    gradient."""
    host = bool(_STATE["host_p2p"])
    ops, got = [], []
    for t, dst in sends:
        t = t.detach().contiguous()
        if host and t.is_cuda:
            t = t.cpu()
        ops.append(dist.P2POp(dist.isend, t, int(dst), group))
    for shape, dtype, src, device in recvs:
        dev = torch.device("cpu") if host else torch.device(device)
        buf = torch.empty(tuple(shape), dtype=dtype, device=dev)
        got.append((buf, device))
        ops.append(dist.P2POp(dist.irecv, buf, int(src), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [buf.to(device) for buf, device in got]


def _exchange(x: torch.Tensor, dst: int, src: int, group) -> torch.Tensor:
    return p2p([(x, dst)], [(x.shape, x.dtype, src, x.device)], group)[0]


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dst, src, group):
        ctx.route = (dst, src, group)
        return _exchange(x, dst, src, group)

    @staticmethod
    def backward(ctx, g):
        dst, src, group = ctx.route
        return _exchange(g, src, dst, group), None, None, None


def exchange(x: torch.Tensor, dst: int, src: int, group=None
             ) -> torch.Tensor:
    """``x`` sent to rank ``dst`` while a tensor of its shape comes from
    rank ``src`` (global ranks of ``group``): one hop of a ring.
    Differentiable: the gradient hops back."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Exchange.apply(x, dst, src, group)
    return _exchange(x, dst, src, group)


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


def _leaf_digest(leaf) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        h.update(f"{t.dtype}{tuple(t.shape)}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy())
    else:
        a = np.ascontiguousarray(leaf)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.digest()


#: above this many bytes ``digest`` hashes the leaves on threads (hashlib
#: and the copies to the host release the interpreter lock)
_THREADED_BYTES = 1 << 24


def digest(value) -> str:
    """A hex digest of ``value``'s host bytes (a tensor, an array, or
    dicts / lists / tuples of them), shapes and dtypes included: each
    leaf's own digest, in order, hashed once more."""
    leaves = list(_leaves(value))
    arrays = [x for x in leaves if not isinstance(x, bytes)]
    size = sum(x.numel() * x.element_size() if isinstance(x, torch.Tensor)
               else np.asarray(x).nbytes for x in arrays)
    if size > _THREADED_BYTES and len(arrays) > 1:
        with ThreadPoolExecutor(max_workers=4) as pool:
            done = iter(list(pool.map(_leaf_digest, arrays)))
    else:
        done = iter([_leaf_digest(x) for x in arrays])
    h = hashlib.blake2b(digest_size=8)
    for leaf in leaves:
        h.update(leaf if isinstance(leaf, bytes) else next(done))
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
