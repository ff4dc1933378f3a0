"""Data parallelism and FSDP parameter sharding
(``tnn_tpu.parallel.data_parallel``).

``make_dp_train_step`` runs the single-device step over the global batch
with the batch cut over the mesh's data x fsdp positions (data major), one
model replica a position, all in one thread and one autograd graph:

* each microbatch of ``grad_accum`` is cut from the global batch as
  ``train.step.make_train_step`` cuts it, then split over the replicas;
* the replicas' forwards run in lockstep (``lockstep``): containers child
  by child, and a training BatchNorm normalizes every shard by the global
  batch's statistics, summed over the replicas inside the graph, so its
  running statistics are the single-device step's;
* the loss is the global mean, its one backward fills each replica's
  gradients, and ``mesh.all_reduce`` (``mesh.reduce_scatter`` for a
  sharded leaf) reduces them once;
* one optimizer update runs over the owned tree: each replicated leaf
  once (the first position's), each FSDP leaf as its shards, shard f
  being the slice of position (0, f)'s replica, its moments beside it;
  the new values go back to every replica (``mesh.all_gather`` for the
  shards).

FSDP here shards the optimizer state and its update only: every
position's replica holds the whole parameters and the whole gradients
between steps (the lockstep forward needs them), so a position's memory
is plain data parallelism's less the moments of the shards it does not
own. Sharding the parameters themselves (gathered layer by layer at use)
is ROADMAP.md item 11.4.

Dropout: every replica on the device of the state's generator draws from
that generator, the replicas in lockstep order; a replica on another
device draws from a generator of that device seeded, each microbatch,
from a digest of the state's generator. So every mask follows from the
run's seed and from the generator state a checkpoint keeps, and
``remat`` replays all of them.

``fsdp_spec_tree`` picks the sharded leaves as the JAX package does: a
leaf of at least ``min_size`` elements shards its first dim divisible by
the fsdp size. A spec is a tuple like JAX's ``PartitionSpec``: ``()``
replicated, ``(None, "fsdp")`` sharded on dim 1.

Not ported (ROADMAP.md item 11.4): ``tp=True`` and ``ep=True``, and MoE
models under data parallelism (the JAX layer's capacity counts the global
batch's tokens; per-replica routing would drop others).
"""
from __future__ import annotations

import copy
import dataclasses
import hashlib
from typing import Any, Callable, Dict, List, Optional

import torch

from ..core.rng import make_generator
from ..nn import losses as losses_lib
from ..nn import metrics as metrics_lib
from ..nn.blocks import Parallel, Residual, Sequential
from ..nn.norms import BatchNorm
from ..nn.schedulers import NoOp
from ..train.step import TrainState, apply_update, has_moe, microbatches, \
    remat_call, resolve_remat_policy, step_metrics, train_state_trees
from . import mesh as mesh_lib
from .mesh import Mesh

_NOT_PORTED = "not ported yet (ROADMAP.md item 11.4)"


def fsdp_spec_tree(params, mesh: Mesh, min_size: int = 2 ** 16):
    """A spec a leaf of ``params`` (nested dicts of anything with a
    ``shape``): ``("fsdp" at its first dim divisible by the fsdp size)``
    for a leaf of at least ``min_size`` elements, ``()`` else."""
    fsdp = mesh_lib.axis_size(mesh, "fsdp")

    def spec_for(x):
        shape = tuple(x.shape)
        size = 1
        for d in shape:
            size *= d
        if fsdp <= 1 or size < min_size:
            return ()
        for dim, d in enumerate(shape):
            if d % fsdp == 0:
                spec = [None] * len(shape)
                spec[dim] = "fsdp"
                return tuple(spec)
        return ()

    if isinstance(params, dict):
        return {k: fsdp_spec_tree(v, mesh, min_size)
                for k, v in params.items()}
    return spec_for(params)


def _fsdp_dim(spec) -> Optional[int]:
    return spec.index("fsdp") if "fsdp" in spec else None


def place_by_specs(params, mesh: Mesh, specs):
    """Each leaf placed per its spec: one tensor a data x fsdp position
    (data major), the whole leaf where it is replicated, the position's
    fsdp shard where it is sharded."""
    if isinstance(params, dict):
        return {k: place_by_specs(v, mesh, specs[k]) for k, v in
                params.items()}
    devices = _positions(mesh)
    fsdp = mesh_lib.axis_size(mesh, "fsdp")
    x = torch.as_tensor(params)
    dim = _fsdp_dim(specs)
    if dim is None:
        return [x.to(d) for d in devices]
    pieces = x.chunk(fsdp, dim=dim)
    return [pieces[i % fsdp].to(d) for i, d in enumerate(devices)]


def shard_params_fsdp(params, mesh: Mesh, min_size: int = 2 ** 16):
    """``place_by_specs`` at ``fsdp_spec_tree``'s specs."""
    return place_by_specs(params, mesh, fsdp_spec_tree(params, mesh,
                                                       min_size))


def _positions(mesh: Mesh) -> List[torch.device]:
    """The data x fsdp positions' devices, data major."""
    other = {k: v for k, v in mesh.shape.items()
             if k not in ("data", "fsdp") and v > 1}
    if other:
        raise NotImplementedError(
            f"mesh axes {other} with data parallelism are {_NOT_PORTED}")
    return list(mesh.devices.reshape(-1))


# -- the replicas' lockstep forward ----------------------------------------


def lockstep(mods, xs, train: bool, generators) -> List[torch.Tensor]:
    """The forward of replica modules ``mods`` over their shards ``xs``,
    one autograd graph: a ``Sequential`` child by child, a ``Residual``
    or ``Parallel`` branch by branch, a training ``BatchNorm`` by the
    statistics of all shards together; any other module replica by
    replica. A training module that holds a BatchNorm elsewhere raises
    (its statistics would be the shard's)."""
    head = mods[0]
    if isinstance(head, Sequential):
        for children in zip(*(m.layers for m in mods)):
            xs = lockstep(list(children), xs, train, generators)
        return xs
    if isinstance(head, Residual):
        ys = lockstep([m.layers[0] for m in mods], xs, train, generators)
        short = xs if len(head.layers) == 1 else lockstep(
            [m.layers[1] for m in mods], xs, train, generators)
        return [m.merge(y, s) for m, y, s in zip(mods, ys, short)]
    if isinstance(head, Parallel):
        branches = [lockstep([m.layers[i] for m in mods], xs, train,
                             generators) for i in range(len(head.layers))]
        return [m.merge([b[r] for b in branches])
                for r, m in enumerate(mods)]
    if isinstance(head, BatchNorm) and train:
        return _global_batchnorm(mods, xs)
    if train and any(isinstance(c, BatchNorm) for c in head.modules()):
        raise NotImplementedError(
            f"{type(head).__name__} holds a BatchNorm outside a "
            "Sequential / Residual / Parallel: its data-parallel "
            f"statistics are {_NOT_PORTED}")
    return [m(x, train=train, generator=g)
            for m, x, g in zip(mods, xs, generators)]


def _global_batchnorm(mods, xs):
    """Every shard normalized by the global batch's mean and variance:
    the shards' sums added in position order (``mesh.all_reduce``)."""
    dims = tuple(range(xs[0].ndim - 1))
    count = sum(x.numel() // x.shape[-1] for x in xs)
    s1 = mesh_lib.all_reduce([x.float().sum(dim=dims) for x in xs])
    s2 = mesh_lib.all_reduce([(x.float() * x.float()).sum(dim=dims)
                              for x in xs])
    out = []
    for m, x, a, b in zip(mods, xs, s1, s2):
        mean = a / count
        var = (b / count - mean * mean).clamp_min(0.0)
        out.append(m.normalize(x, mean, var))
    return out


# -- the layout -------------------------------------------------------------


class DataParallel:
    """The replicas, the owned tree (replicated leaves and FSDP shards)
    and its optimizer state of a data-parallel run. A ``TrainState``'s
    ``layout``: it gives the JAX-layout trees (``trees``: shards
    gathered) and loads them (``load``: placed again)."""

    def __init__(self, model, mesh: Mesh, fsdp: bool,
                 min_size: int = 2 ** 16):
        self.mesh = mesh
        self.devices = _positions(mesh)
        self.fsdp = mesh_lib.axis_size(mesh, "fsdp") if fsdp else 1
        dev = next(model.parameters()).device
        if dev != self.devices[0]:
            raise ValueError(f"the model lives on {dev}; the mesh's first "
                             f"position is {self.devices[0]}")
        self.model = model
        self.replicas = [model] + [copy.deepcopy(model).to(d)
                                   for d in self.devices[1:]]
        self.named = [dict(r.named_parameters()) for r in self.replicas]
        params = self.named[0]
        specs = fsdp_spec_tree(params, mesh, min_size) if fsdp else \
            {n: () for n in params}
        self.dims = {n: _fsdp_dim(s) for n, s in specs.items()}
        # shard f of a sharded leaf lives on the device of position (0, f)
        self.shard_devices = self.devices[:self.fsdp]
        self.owned = {n: p if self.dims[n] is None else self._shards(n)
                      for n, p in params.items()}

    def _shards(self, name: str) -> Dict[str, torch.Tensor]:
        """Shard f of a sharded leaf: a view of its slice in replica f
        (position (0, f)), which the update writes in place."""
        return {str(f): self.named[f][name].detach().chunk(
            self.fsdp, dim=self.dims[name])[f] for f in range(self.fsdp)}

    def generators(self, generator: torch.Generator
                   ) -> List[torch.Generator]:
        """The generator each replica's forward draws from (the module
        docstring): ``generator`` on its own device, elsewhere one a
        device seeded from a digest of ``generator``'s state."""
        by_device = {generator.device: generator}
        digest = None
        out = []
        for d in self.devices:
            if d not in by_device:
                if digest is None:
                    digest = hashlib.blake2b(
                        generator.get_state().numpy().tobytes(),
                        digest_size=8).digest()
                seed = hashlib.blake2b(digest + str(d).encode(),
                                       digest_size=8).digest()
                by_device[d] = make_generator(
                    int.from_bytes(seed, "little") >> 1, d)
            out.append(by_device[d])
        return out

    def sharded_names(self) -> List[str]:
        return [n for n, d in self.dims.items() if d is not None]

    # -- optimizer state between the owned and the full layouts -------------

    def full_opt_state(self, opt_state) -> Dict[str, Any]:
        """The optimizer state with every sharded moment gathered (new
        tensors on the first position's device)."""
        out = {}
        for key, val in opt_state.items():
            if not isinstance(val, dict):
                out[key] = val
                continue
            out[key] = {}
            for n, t in val.items():
                if isinstance(t, dict):
                    t = torch.cat([t[str(f)].to(self.devices[0])
                                   for f in range(self.fsdp)],
                                  dim=self.dims[n])
                out[key][n] = t
        return out

    @torch.no_grad()
    def set_opt_state(self, opt_state, full) -> None:
        """Copy a full-layout optimizer state into the owned one."""
        for key, val in opt_state.items():
            if not isinstance(val, dict):
                val.copy_(torch.as_tensor(full[key]))
                continue
            for n, t in val.items():
                src = torch.as_tensor(full[key][n])
                if isinstance(t, dict):
                    for f, piece in enumerate(src.chunk(self.fsdp,
                                                        dim=self.dims[n])):
                        t[str(f)].copy_(piece)
                else:
                    t.copy_(src)

    @torch.no_grad()
    def broadcast(self) -> None:
        """Every replica's parameters and state buffers from the owned
        tree: replicated leaves copied from the first replica, sharded
        ones gathered (``mesh.all_gather``)."""
        for n, own in self.owned.items():
            if isinstance(own, dict):
                fulls = mesh_lib.all_gather(
                    [own[str(f)] for f in range(self.fsdp)], self.dims[n],
                    self.devices)
                for named, full in zip(self.named, fulls):
                    named[n].copy_(full)
            else:
                for named in self.named[1:]:
                    named[n].copy_(own)
        buffers = dict(self.model.named_buffers())
        for rep in self.replicas[1:]:
            for n, b in rep.named_buffers():
                b.copy_(buffers[n])

    @torch.no_grad()
    def scatter_params(self) -> None:
        """The owned shards from the first replica's full parameters."""
        for n, own in self.owned.items():
            if isinstance(own, dict):
                pieces = self.named[0][n].chunk(self.fsdp, dim=self.dims[n])
                for f, piece in enumerate(pieces):
                    own[str(f)].copy_(piece)

    # -- TrainState layout ------------------------------------------------

    def trees(self, state: TrainState) -> Dict[str, Any]:
        full = dataclasses.replace(state, layout=None,
                                   opt_state=self.full_opt_state(
                                       state.opt_state))
        return train_state_trees(full)

    def load(self, state: TrainState, params=None, opt_state=None,
             net_state=None) -> None:
        from ..train.step import load_jax_train_state

        full_opt = self.full_opt_state(state.opt_state)
        plain = dataclasses.replace(state, layout=None, opt_state=full_opt)
        load_jax_train_state(plain, params=params, opt_state=opt_state,
                             net_state=net_state)
        if opt_state is not None:
            self.set_opt_state(state.opt_state, full_opt)
        self.scatter_params()
        self.broadcast()

    # -- the pieces of a step ------------------------------------------------

    def split(self, x: torch.Tensor) -> List[torch.Tensor]:
        n = len(self.devices)
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} not divisible by the "
                             f"data x fsdp mesh size {n}")
        return [s.to(d) for s, d in zip(x.chunk(n), self.devices)]

    @torch.no_grad()
    def reduce_grads(self, scale: float = 1.0) -> Dict[str, Any]:
        """The replicas' gradients reduced once, in the owned layout."""
        grads = {}
        for n, own in self.owned.items():
            parts = [named[n].grad if named[n].grad is not None
                     else torch.zeros_like(named[n])
                     for named in self.named]
            if scale != 1.0:
                parts = [g * scale for g in parts]
            if isinstance(own, dict):
                pieces = mesh_lib.reduce_scatter(parts, self.dims[n],
                                                 self.shard_devices)
                grads[n] = {str(f): g for f, g in enumerate(pieces)}
            else:
                grads[n] = mesh_lib.all_reduce(parts)[0]
        for named in self.named:
            for p in named.values():
                p.grad = None
        return grads


def _global_mean(values, counts, device):
    total = sum(counts)
    return mesh_lib.all_reduce([v.float() * (c / total)
                                for v, c in zip(values, counts)])[0] \
        .to(device)


class DPTrainStep:
    """``(state, data, labels) -> (state, metrics)`` over the global
    batch; ``layout`` is the run's ``DataParallel`` (set by
    ``place_state``)."""

    def __init__(self, optimizer, loss_fn, scheduler, grad_accum: int,
                 augment, remat, compute_accuracy: bool):
        self.layout: Optional[DataParallel] = None
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.scheduler = scheduler
        self.grad_accum = int(grad_accum)
        self.augment = augment
        self.remat = remat
        self.policy = resolve_remat_policy(remat) if remat else None
        self.compute_accuracy = compute_accuracy

    def _microbatch(self, state, data, labels):
        lay = self.layout
        xs, ls = lay.split(data), lay.split(labels)
        gens = lay.generators(state.generator)

        def fwd(*shards):
            return tuple(lockstep(lay.replicas, list(shards), True, gens))

        outs = remat_call(fwd, self.policy, gens, *xs) if self.remat \
            else fwd(*xs)
        counts = [x.shape[0] for x in xs]
        dev = lay.devices[0]
        loss = _global_mean([self.loss_fn(o, l) for o, l in zip(outs, ls)],
                            counts, dev)
        loss.backward()
        for rep in lay.replicas:
            commit = getattr(rep, "commit_state", None)
            if commit is not None:
                commit()
        acc = None
        if self.compute_accuracy:
            acc = _global_mean([metrics_lib.accuracy(o.detach(), l)
                                for o, l in zip(outs, ls)], counts, dev)
        return loss.detach(), acc

    def __call__(self, state: TrainState, data, labels):
        lay = self.layout
        if lay is None or state.layout is not lay:
            raise ValueError("place the state first (place_state)")
        data, labels = data.to(lay.devices[0]), labels.to(lay.devices[0])
        if self.augment is not None:
            data = self.augment(state.generator, data)
        n = self.grad_accum
        loss = acc = 0.0
        for d, l in microbatches(data, labels, n):
            mb_loss, mb_acc = self._microbatch(state, d, l)
            loss = loss + mb_loss
            if mb_acc is not None:
                acc = acc + mb_acc
        grads = lay.reduce_grads(1.0 / n)
        lr_scale = apply_update(self.optimizer, self.scheduler, state, grads,
                                lay.owned)
        lay.broadcast()
        return state, step_metrics(
            loss / n, lr_scale, acc / n if self.compute_accuracy else None)

    def eval_step(self, loss_fn="softmax_cross_entropy",
                  compute_accuracy: bool = True):
        """The eval step over the same replicas: each scores its shard,
        the loss is the global mean and the corrects their sum."""
        if isinstance(loss_fn, (str, dict)):
            loss_fn = losses_lib.get(loss_fn)

        @torch.no_grad()
        def step(state, data, labels):
            lay = self.layout
            xs, ls = lay.split(data), lay.split(labels)
            outs = lockstep(lay.replicas, xs, False, [None] * len(xs))
            metrics = {"loss": _global_mean(
                [loss_fn(o, l) for o, l in zip(outs, ls)],
                [x.shape[0] for x in xs], lay.devices[0])}
            if compute_accuracy:
                metrics["corrects"] = mesh_lib.all_reduce(
                    [metrics_lib.class_corrects(o, l) for o, l in
                     zip(outs, ls)])[0]
            return metrics

        return step


def make_dp_train_step(model, optimizer, mesh: Mesh,
                       loss_fn="softmax_cross_entropy", scheduler=None,
                       fsdp: bool = False, tp: bool = False,
                       ep: bool = False,
                       grad_accum: int = 1, augment: Optional[Callable] = None,
                       remat: "bool | str" = False,
                       compute_accuracy: bool = True):
    """A data-parallel train step over ``mesh`` (the module docstring).

    Returns ``(step, place_state, place_batch)``: ``place_state(state)``
    builds the replicas and the owned tree from a ``create_train_state``
    state of ``model`` and returns the state with its layout;
    ``step(state, data, labels)`` takes the global batch;
    ``place_batch(data, labels)`` puts it on the mesh's first position,
    where the step cuts it. ``step.eval_step(loss_fn)`` is the matching
    eval step."""
    if tp:
        raise NotImplementedError("tensor-parallel training (tp=True) is "
                                  + _NOT_PORTED)
    if ep:
        raise NotImplementedError("expert parallelism (ep=True) is "
                                  + _NOT_PORTED)
    if has_moe(model) and len(_positions(mesh)) > 1:
        raise NotImplementedError(
            "MoE under data parallelism is " + _NOT_PORTED + ": the JAX "
            "layer's capacity counts the global batch")
    if isinstance(loss_fn, (str, dict)):
        loss_fn = losses_lib.get(loss_fn)
    step = DPTrainStep(optimizer, loss_fn, scheduler or NoOp(), grad_accum,
                       augment, remat, compute_accuracy)
    first = _positions(mesh)[0]

    def place_state(state: TrainState) -> TrainState:
        if state.layout is not None:
            return state
        layout = DataParallel(model, mesh, fsdp)
        full = state.opt_state
        state.opt_state = optimizer.init(layout.owned)
        layout.set_opt_state(state.opt_state, full)
        layout.broadcast()
        state.layout = step.layout = layout
        return state

    def place_batch(data, labels):
        return data.to(first), labels.to(first)

    return step, place_state, place_batch
