"""Device meshes and the collectives of parallel training
(``tnn_tpu.parallel.mesh``).

A ``Mesh`` lays a list of devices out over the six named axes ``AXES``
(data, fsdp, model, pipe, seq, expert) in that order, as the JAX package's
``make_mesh`` reshapes its device list. It lives in one process: a mesh
position is a device, and a device may repeat (every position on
``cuda:0``, or N copies of ``"cpu"`` as the test suite's 8 virtual
devices), so one card runs every code path of a multi-device layout.

Every collective of the data-parallel and pipeline steps is here, in one
place: ``all_reduce`` (summed in device order), ``all_gather``,
``reduce_scatter``, ``hop`` (a stage's output to the next stage's device)
and ``data_mean``. Each moves tensors with ``Tensor.to`` and adds them on
one device; positions that share a card move nothing, so they measure
code paths, not interconnect.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

AXES = ("data", "fsdp", "model", "pipe", "seq", "expert")


class Mesh:
    """Devices laid out over ``AXES``; ``shape`` maps each axis to its
    size, ``devices`` is the object array of ``torch.device``s."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != len(AXES):
            raise ValueError(f"a mesh has {len(AXES)} axes, got "
                             f"{devices.ndim}")
        self.devices = devices
        self.axis_names = AXES
        self.shape: Dict[str, int] = dict(zip(AXES, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_list(self) -> List[torch.device]:
        return list(self.devices.reshape(-1))

    def __repr__(self):
        live = {k: v for k, v in self.shape.items() if v > 1}
        return f"Mesh({live or {'data': 1}}, devices={self.device_list()})"


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
    prod(sizes) entries), by default ``default_devices(..., device)``."""
    sizes = (data, fsdp, model, pipe, seq, expert)
    need = math.prod(sizes)
    if devices is None:
        devices = default_devices(need, device)
    devices = [_indexed(torch.device(d)) for d in devices]
    if need > len(devices):
        raise ValueError(f"mesh needs {need} devices, have {len(devices)}")
    arr = np.empty(need, dtype=object)
    for i, d in enumerate(devices[:need]):
        arr[i] = d
    return Mesh(arr.reshape(sizes))


def data_mesh(n: Optional[int] = None, devices=None, *,
              device="cuda") -> Mesh:
    n = n or (len(devices) if devices is not None else 1)
    return make_mesh(data=n, devices=devices, device=device)


def axis_size(mesh: Mesh, name: str) -> int:
    return int(mesh.shape.get(name, 1))


def local_mesh_info(device="cuda") -> Dict[str, object]:
    """The process's device census (``tnn_tpu.parallel.mesh``)."""
    dev = torch.device(device)
    count = torch.cuda.device_count() if dev.type == "cuda" else 1
    return {"device_count": count, "local_device_count": count,
            "process_count": 1, "platform": dev.type}


# -- collectives ----------------------------------------------------------


def _sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``parts`` added in position order on the first part's device."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return total


def all_reduce(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum of ``parts`` (one tensor a position), added in position
    order, one copy on each part's device."""
    total = _sum(parts)
    return [total.to(p.device) for p in parts]


def all_gather(shards: Sequence[torch.Tensor], dim: int,
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The shards concatenated along ``dim``, one copy on each of
    ``devices``."""
    full = torch.cat([s.to(shards[0].device) for s in shards], dim=dim)
    return [full.to(d) for d in devices]


def reduce_scatter(parts: Sequence[torch.Tensor], dim: int,
                   devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The sum of ``parts`` cut into ``len(devices)`` equal pieces along
    ``dim``, piece i on ``devices[i]``."""
    pieces = _sum(parts).chunk(len(devices), dim=dim)
    return [p.to(d) for p, d in zip(pieces, devices)]


def hop(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A pipeline stage's output moved to the next stage's device
    (differentiable: its gradient hops back)."""
    return x.to(device)


def data_mean(values: Sequence[torch.Tensor]) -> torch.Tensor:
    """The mean over the data axis of one value a replica, added in
    replica order on the first value's device."""
    return _sum(values) / len(values)
