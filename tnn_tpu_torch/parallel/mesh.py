"""Device meshes and the collectives of parallel training
(``tnn_tpu.parallel.mesh``).

A ``Mesh`` lays a list of devices out over the six named axes ``AXES``
(data, fsdp, model, pipe, seq, expert) in that order, as the JAX package's
``make_mesh`` reshapes its device list. It lives in one process: a mesh
position is a device, and a device may repeat (every position on
``cuda:0``, or N copies of ``"cpu"`` as the test suite's 8 virtual
devices), so one card runs every code path of a multi-device layout.

Every collective of the parallel steps is here, in one place:
``all_reduce`` (summed in position order, or the max), ``all_gather``,
``reduce_scatter``, ``all_to_all`` (Ulysses' re-sharding), ``hop`` (a
pipeline stage's output to the next stage's device), ``ring_hop`` (one
step of the ring: part i to position i + 1) and ``data_mean``. Each moves
tensors with ``Tensor.to`` and adds them on one device; positions that
share a card move nothing, so they measure code paths, not interconnect.
Each is differentiable where its inputs are: autograd carries the
gradient back along the same moves.

``seq_shard_map`` cuts (B, H, S, D) tensors over the seq positions (and
the batch over ``batch_axis``), runs a per-group body on lists of shards
and reassembles its output: the form ``ring_attention`` and
``ulysses_attention`` take on whole tensors.

Under an initialized ``process_group`` a mesh built without ``devices``
spans processes: it takes the first prod(sizes) entries of the group's
global position list, each position carrying its process
(``Mesh.processes``), and a process that holds none of them is refused.
A process reaches only its own positions. ``Mesh.span(axes, index)`` is
the set of processes of the positions that differ from ``index`` along
``axes`` alone (one axis: that axis's slice through ``index``, with each
slice position's process); the mesh makes the subgroup of every span
with more than one process when it is made, on every process in the
same order (``process_group.subgroups``). Each collective takes the
parts this process holds of one span (``over``), combines them in
position order, then, where the span holds more than one process,
combines the processes' results over its subgroup: ``position_sum``,
``all_reduce`` and ``reduce_scatter`` sum them (in the backward, with
``grad="sum"``, the gradients too, each process's loss using its share;
with ``grad="pass"`` the gradient passes unchanged, the processes
computing one loss: tensor parallelism's g), ``all_gather`` joins them,
``ring_hop`` moves the run's last part to the next process and
``all_to_all`` sends every piece to the process of its destination.
"""
from __future__ import annotations

import itertools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import process_group

AXES = ("data", "fsdp", "model", "pipe", "seq", "expert")


class Span:
    """The processes of one span of a mesh (the module docstring):
    ``procs`` in rank order, ``group`` their subgroup (None: the whole
    process group), ``crosses`` whether it holds more than one process.
    A span along one axis also has ``owners`` (each slice position's
    process, in axis order) and ``lo`` / ``hi``, the run of slice
    positions this process holds."""

    def __init__(self, procs: Tuple[int, ...], owners=None,
                 me: Optional[int] = None):
        self.procs = procs
        self.crosses = len(procs) > 1
        self.group = process_group.group_of(procs) if self.crosses \
            else None
        self.owners = owners
        if owners is not None:
            mine = [i for i, p in enumerate(owners) if p == me]
            self.lo, self.hi = (mine[0], mine[-1] + 1) if mine else (0, 0)


class Mesh:
    """Devices laid out over ``AXES``; ``shape`` maps each axis to its
    size, ``devices`` is the object array of ``torch.device``s and
    ``processes`` (None for a mesh of this process alone) the int array
    of each position's process."""

    def __init__(self, devices: np.ndarray,
                 processes: Optional[np.ndarray] = None):
        if devices.ndim != len(AXES):
            raise ValueError(f"a mesh has {len(AXES)} axes, got "
                             f"{devices.ndim}")
        self.devices = devices
        self.processes = processes
        self.process_index = process_group.process_index() \
            if processes is not None else 0
        self.axis_names = AXES
        self.shape: Dict[str, int] = dict(zip(AXES, devices.shape))
        self._spans: Dict[Tuple, Span] = {}

    @property
    def spans_processes(self) -> bool:
        return self.processes is not None and \
            len(set(self.processes.flat)) > 1

    def is_local(self, index: Tuple[int, ...]) -> bool:
        """Whether position ``index`` (one coordinate an axis of ``AXES``)
        lives in this process."""
        return self.processes is None or \
            int(self.processes[index]) == self.process_index

    def crossing_axes(self) -> Tuple[str, ...]:
        """The axes along which positions of different processes meet."""
        if self.processes is None:
            return ()
        return tuple(a for i, a in enumerate(AXES)
                     if self.shape[a] > 1
                     and np.any(np.diff(self.processes, axis=i) != 0))

    def span(self, axes, index: Tuple[int, ...]) -> Optional[Span]:
        """The span through position ``index`` (one coordinate an axis of
        ``AXES``) along ``axes`` (a name or names); None for a mesh of
        this process alone."""
        if self.processes is None:
            return None
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        key = tuple(None if a in axes else int(index[i])
                    for i, a in enumerate(AXES))
        if key not in self._spans:
            cut = tuple(slice(None) if k is None else k for k in key)
            owners = [int(p) for p in self.processes[cut].flat]
            self._spans[key] = Span(tuple(sorted(set(owners))),
                                    owners if len(axes) == 1 else None,
                                    self.process_index)
        return self._spans[key]

    def make_groups(self) -> None:
        """The subgroup of every span along any axes (the module
        docstring), made on every process in one order."""
        sets = []
        for k in range(1, len(AXES) + 1):
            for axes in itertools.combinations(range(len(AXES)), k):
                keep = [i for i in range(len(AXES)) if i not in axes]
                moved = np.moveaxis(self.processes, keep,
                                    list(range(len(keep))))
                for rest in np.ndindex(*moved.shape[:len(keep)]):
                    procs = tuple(sorted(set(int(p) for p in
                                             moved[rest].flat)))
                    if procs not in sets:
                        sets.append(procs)
        process_group.subgroups(sets)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_list(self) -> List[torch.device]:
        return list(self.devices.reshape(-1))

    def __repr__(self):
        live = {k: v for k, v in self.shape.items() if v > 1}
        procs = "" if self.processes is None else \
            f", processes={list(self.processes.flat)}"
        return (f"Mesh({live or {'data': 1}}, devices={self.device_list()}"
                f"{procs})")


def default_devices(n: int, device="cuda") -> List[torch.device]:
    """The first ``n`` cards on CUDA; ``n`` copies of ``device`` else."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev] * n
    count = torch.cuda.device_count()
    if n > count:
        raise ValueError(f"the mesh needs {n} devices but only {count} are "
                         "visible; name them with devices= (a card may hold "
                         "several positions, e.g. ['cuda:0'] * n)")
    return [torch.device("cuda", i) for i in range(n)]


def _indexed(dev: torch.device) -> torch.device:
    """"cuda" as the current card's index, as a model's device reads."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(data: int = 1, fsdp: int = 1, model: int = 1, pipe: int = 1,
              seq: int = 1, expert: int = 1,
              devices: Optional[Sequence] = None, *,
              device="cuda") -> Mesh:
    """A mesh of the given axis sizes over ``devices`` (its first
    prod(sizes) entries), by default ``default_devices(..., device)``, or
    under an initialized process group the group's positions (the
    module docstring)."""
    sizes = (data, fsdp, model, pipe, seq, expert)
    need = math.prod(sizes)
    if devices is None and process_group.is_initialized():
        return _group_mesh(sizes, need)
    if devices is None:
        devices = default_devices(need, device)
    devices = [_indexed(torch.device(d)) for d in devices]
    if need > len(devices):
        raise ValueError(f"mesh needs {need} devices, have {len(devices)}")
    arr = np.empty(need, dtype=object)
    for i, d in enumerate(devices[:need]):
        arr[i] = d
    return Mesh(arr.reshape(sizes))


def _group_mesh(sizes, need: int) -> Mesh:
    positions = process_group.global_positions()
    if need > len(positions):
        raise ValueError(f"mesh needs {need} devices, have {len(positions)} "
                         f"over {process_group.process_count()} processes")
    me = process_group.process_index()
    procs = [p for p, _ in positions[:need]]
    if me not in procs:
        raise ValueError(
            f"process {me} holds no position of the mesh {sizes}: its "
            f"positions come after the first {need} of the group's "
            f"{len(positions)}")
    devs = np.empty(need, dtype=object)
    for i, (_, d) in enumerate(positions[:need]):
        devs[i] = d
    mesh = Mesh(devs.reshape(sizes), np.array(procs).reshape(sizes))
    mesh.make_groups()
    return mesh


def data_mesh(n: Optional[int] = None, devices=None, *,
              device="cuda") -> Mesh:
    n = n or (len(devices) if devices is not None else 1)
    return make_mesh(data=n, devices=devices, device=device)


def axis_size(mesh: Mesh, name: str) -> int:
    return int(mesh.shape.get(name, 1))


def replicated(mesh: Mesh) -> Tuple:
    """The spec of a leaf every position holds whole (JAX's
    ``NamedSharding(mesh, P())``): the empty tuple."""
    del mesh
    return ()


def batch_sharding(mesh: Mesh, extra_axes: Tuple[str, ...] = ()) -> Tuple:
    """The spec of a batch cut over "data" and any live ``extra_axes``
    (JAX's ``batch_sharding``): ``((axes...),)`` on dim 0, or ``()`` where
    no such axis is live."""
    axes = ["data"] + [a for a in extra_axes if a in AXES]
    present = tuple(a for a in axes if axis_size(mesh, a) > 1)
    return (present,) if present else ()


def _live_axes(mesh: Mesh, names) -> Tuple[str, ...]:
    """The axes among ``names`` (one name, a sequence or None) of size > 1,
    in mesh order."""
    if names is None:
        return ()
    names = (names,) if isinstance(names, str) else tuple(names)
    return tuple(a for a in AXES if a in names and axis_size(mesh, a) > 1)


def seq_groups(mesh: Mesh, axis: str = "seq",
               batch_axis=None) -> List[List[torch.device]]:
    """The position groups of a context-parallel call: one group a batch
    shard (over the live ``batch_axis`` axes, in mesh order), each the
    devices of its ``axis`` positions in order. Every other axis is taken
    at index 0, as a ``shard_map`` over these axes replicates over the
    rest."""
    batch = _live_axes(mesh, batch_axis)
    names = list(AXES)
    arr = mesh.devices
    index = [0] * len(names)
    groups = []
    shape = [axis_size(mesh, a) for a in batch]
    for flat in range(math.prod(shape) if shape else 1):
        rest = flat
        for a, size in reversed(list(zip(batch, shape))):
            index[names.index(a)] = rest % size
            rest //= size
        group = []
        for s in range(axis_size(mesh, axis)):
            index[names.index(axis)] = s
            group.append(arr[tuple(index)])
        groups.append(group)
    return groups


def seq_shard_map(body: Callable, mesh: Mesh, axis: str = "seq",
                  batch_axis=None) -> Callable:
    """A per-group ``body(qs, ks, vs) -> outs`` (lists of (B_l, H, S_l, D)
    shards, one a position of the group's ``axis``) as a function of whole
    (B, H, S, D) tensors: B cut over the live ``batch_axis`` positions, S
    over ``axis``'s, each shard moved to its position's device, the
    outputs put back together on the first input's device (the JAX
    package's ``seq_shard_map``)."""

    def run(q, k, v):
        groups = seq_groups(mesh, axis, batch_axis)
        n_seq = len(groups[0])
        for t in (q, k, v):
            if t.shape[0] % len(groups):
                raise ValueError(f"batch {t.shape[0]} not divisible by "
                                 f"{len(groups)} batch shards")
        rows = []
        for g, (qb, kb, vb) in enumerate(zip(q.chunk(len(groups)),
                                             k.chunk(len(groups)),
                                             v.chunk(len(groups)))):
            devs = groups[g]
            cut = [[p.to(d) for p, d in zip(t.chunk(n_seq, dim=2), devs)]
                   for t in (qb, kb, vb)]
            outs = body(*cut)
            rows.append(torch.cat([o.to(q.device) for o in outs], dim=2))
        return torch.cat(rows, dim=0)

    return run


def local_mesh_info(device="cuda") -> Dict[str, object]:
    """The device census (``tnn_tpu.parallel.mesh``): the group's
    positions and this process's under an initialized process group,
    else this process's devices."""
    dev = torch.device(device)
    if process_group.is_initialized():
        local = process_group.local_devices()
        return {"device_count": len(process_group.global_positions()),
                "local_device_count": len(local),
                "process_count": process_group.process_count(),
                "platform": local[0].type}
    count = torch.cuda.device_count() if dev.type == "cuda" else 1
    return {"device_count": count, "local_device_count": count,
            "process_count": 1, "platform": dev.type}


# -- collectives ----------------------------------------------------------


def _crosses(over: Optional[Span]) -> bool:
    return over is not None and over.crosses


def position_sum(parts: Sequence[torch.Tensor], over: Optional[Span] = None,
                 grad: str = "sum") -> torch.Tensor:
    """``parts`` added in position order on the first part's device, then
    summed over ``over``'s processes (the module docstring: ``grad``)."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    if not _crosses(over):
        return total
    if grad == "pass":
        return process_group.sum_forward(total, over.group)
    return process_group.all_reduce(total, group=over.group)


def all_reduce(parts: Sequence[torch.Tensor], op: str = "sum",
               over: Optional[Span] = None, grad: str = "sum"
               ) -> List[torch.Tensor]:
    """The sum (``op="max"``: the elementwise max, no gradient) of
    ``parts`` (one tensor a position), taken in position order, then over
    ``over``'s processes, one copy on each part's device."""
    if op == "max":
        total = parts[0]
        for p in parts[1:]:
            total = torch.maximum(total, p.to(total.device))
        if _crosses(over):
            total = process_group.all_reduce(total, "max", over.group)
    elif op == "sum":
        total = position_sum(parts, over, grad)
    else:
        raise ValueError(f"unknown reduction {op!r}")
    return [total.to(p.device) for p in parts]


def all_gather(shards: Sequence[torch.Tensor], dim: int,
               devices: Sequence[torch.device],
               over: Optional[Span] = None) -> List[torch.Tensor]:
    """The shards (this process's run of ``over``'s slice, equal shapes
    across the processes) concatenated along ``dim`` in slice order, one
    copy on each of ``devices`` (no gradient across processes)."""
    full = torch.cat([s.to(shards[0].device) for s in shards], dim=dim)
    if _crosses(over):
        got = process_group.all_gather(full, over.group)
        full = torch.cat(got.unbind(0), dim=dim)
    return [full.to(d) for d in devices]


def reduce_scatter(parts: Sequence[torch.Tensor], dim: int,
                   devices: Sequence[torch.device],
                   over: Optional[Span] = None) -> List[torch.Tensor]:
    """The sum of ``parts`` (over ``over``'s processes too) cut into one
    equal piece a slice position along ``dim``: this process's pieces,
    piece i on ``devices[i]`` (no gradient)."""
    total = position_sum(parts)
    if not _crosses(over):
        pieces = total.chunk(len(devices), dim=dim)
        return [p.to(d) for p, d in zip(pieces, devices)]
    n = len(over.owners)
    pieces = total.chunk(n, dim=dim)
    rows = [torch.cat([pieces[i] for i in range(n) if over.owners[i] == p],
                      dim=dim) for p in over.procs]
    mine = process_group.reduce_scatter(torch.stack(rows), over.group)
    return [p.to(d) for p, d in zip(mine.chunk(len(devices), dim=dim),
                                    devices)]


def hop(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A pipeline stage's output moved to the next stage's device
    (differentiable: its gradient hops back)."""
    return x.to(device)


def ring_hop(parts: Sequence[torch.Tensor], over: Optional[Span] = None
             ) -> List[torch.Tensor]:
    """One step of a ring: part i moves to position (i + 1) % n (the JAX
    package's ``ppermute`` with ``perm = [(i, i + 1 mod n)]``); the
    positions' devices are those of ``parts``. Across processes
    ``parts`` are this process's run of ``over``'s slice: its last part
    goes to the process of the next position, and its first position
    takes the previous position's part from that one's process."""
    n = len(parts)
    if not _crosses(over):
        return [hop(parts[(j - 1) % n], parts[j].device) for j in range(n)]
    size = len(over.owners)
    dst = over.owners[over.hi % size]
    src = over.owners[(over.lo - 1) % size]
    first = process_group.exchange(parts[-1], dst, src, over.group)
    return [hop(first, parts[0].device)] + \
        [hop(parts[j - 1], parts[j].device) for j in range(1, n)]


def all_to_all(parts: Sequence[torch.Tensor], split_dim: int,
               concat_dim: int, over: Optional[Span] = None
               ) -> List[torch.Tensor]:
    """The tiled all-to-all of ``jax.lax.all_to_all``: position i cuts its
    part into n pieces along ``split_dim`` and sends piece j to position
    j, which concatenates what it receives along ``concat_dim`` in
    position order. Across processes ``parts`` are this process's run of
    ``over``'s slice (n its length): the pieces for each other process
    travel in one ``process_group.all_to_all``."""
    n = len(over.owners) if _crosses(over) else len(parts)
    for p in parts:
        if p.shape[split_dim] % n:
            raise ValueError(f"dim {split_dim} of size {p.shape[split_dim]}"
                             f" not divisible by {n} positions")
    pieces = [p.chunk(n, dim=split_dim) for p in parts]
    if not _crosses(over):
        return [torch.cat([pieces[i][j].to(parts[j].device)
                           for i in range(n)], dim=concat_dim)
                for j in range(n)]
    lo, hi = over.lo, over.hi
    runs = {p: [j for j in range(n) if over.owners[j] == p]
            for p in over.procs}
    # to process p: pieces[i][j] for this process's i, p's j, (i, j) order
    dev = parts[0].device
    send = torch.stack([torch.stack([pieces[i][j].to(dev)
                                     for i in range(hi - lo)
                                     for j in runs[p]])
                        for p in over.procs])
    got = process_group.all_to_all(send, over.group)
    # from process q: its i, this process's j, in (i, j) order
    frm = {}
    for q, block in zip(over.procs, got.unbind(0)):
        entries = block.unbind(0)
        for k, (i, j) in enumerate((i, j) for i in runs[q]
                                   for j in range(lo, hi)):
            frm[(i, j)] = entries[k]
    out = []
    for jl, j in enumerate(range(lo, hi)):
        out.append(torch.cat([frm[(i, j)].to(parts[jl].device)
                              for i in range(n)], dim=concat_dim))
    return out


def data_mean(values: Sequence[torch.Tensor],
              over: Optional[Span] = None) -> torch.Tensor:
    """The mean over the data axis of one value a replica, added in
    replica order on the first value's device (then over ``over``'s
    processes, each holding as many replicas)."""
    n = len(values) * (len(over.procs) if _crosses(over) else 1)
    return position_sum(values, over) / n
