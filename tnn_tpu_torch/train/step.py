"""Train, eval and predict steps (``tnn_tpu.train.step``).

A step is forward, loss, backward, optimizer update and metrics, run
eagerly: the model's f32 master parameters are updated in place by the
ported optimizer (``nn.optimizers``), with the scheduler's scale taken from
the step counter (or, for a host-driven scheduler, read once per call).
``TrainState`` carries the parameters, the optimizer state, the step
counter, the ``torch.Generator`` that augmentation and dropout draw from,
each parameter's path in the JAX package's tree, and the model's state
buffers (BatchNorm's running statistics, the JAX ``net_state``) with
theirs. Metrics stay tensors on the device; reading one syncs.

``augment`` is an on-device ``(generator, data) -> data`` transform (an
``AugmentationPipeline.apply``, ``data.augmentation``), run on the batch
inside the step before the forward, as the JAX step runs it on its
``aug_rng``: it draws from the state's generator first, dropout after it.
A training forward leaves BatchNorm's new statistics pending; the step
commits them after each microbatch's backward (``Module.commit_state``),
so the microbatches of ``grad_accum`` thread the state in order and a
forward recomputed under ``remat`` does not update it twice.

``remat`` recomputes the forward in the backward (``torch.utils.checkpoint``,
non-reentrant): True / "full" saves nothing inside the model; "dots" saves
the outputs of every matmul (``mm``, ``addmm``, ``bmm`` and the f32-output
product) and recomputes the rest; "dots_no_batch" saves only the products
without batch dimensions; "offload_dots" is "dots_no_batch" with the saved
outputs parked in pinned host memory during the step and copied back in
the backward. Attention kernels are not matmul ops: every policy runs the
flash forward (K4) again in the backward, as the JAX package's policies
recompute a ``pallas_call``. Dropout draws from the state's explicit
generator, which the checkpoint's own RNG stash does not cover: the
generator's state is taken at the checkpointed forward's entry and set
again for the recompute (and put back after it), so the recomputed masks
are the forward's.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint
from torch.utils._python_dispatch import TorchDispatchMode

from ..core.rng import make_generator
from ..nn import losses as losses_lib
from ..nn import metrics as metrics_lib
from ..nn.lm_loss import lm_head_loss
from ..nn.optimizers import Optimizer
from ..nn.schedulers import NoOp, Scheduler


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.nn.Parameter]   # the model's own parameters
    opt_state: Dict[str, Any]
    step: int
    generator: torch.Generator
    # parameter name -> its path in the JAX package's parameter tree
    jax_paths: Dict[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=dict)
    # the model's state buffers by name, and each one's path in the JAX
    # package's net_state
    buffers: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    state_paths: Dict[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=dict)
    # a parallel run's placement (``parallel.data_parallel``,
    # ``parallel.pipeline``): it gives and takes the JAX-layout trees
    layout: Any = None


def _paths(named: Dict[str, torch.Tensor], jax_paths) -> Dict:
    """{name: JAX path} of the tensors in ``named`` that a model's
    ``jax_param_paths`` / ``jax_state_paths`` lists."""
    names = {id(t): n for n, t in named.items()}
    return {names[id(t)]: tuple(path) for path, t in jax_paths
            if id(t) in names}


def create_train_state(model, optimizer: Optimizer, seed: int = 0
                       ) -> TrainState:
    """The train state of an initialised ``model``: its parameters and
    state buffers by name, the optimizer's zeroed state and a seeded
    generator on its device."""
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    buffers = dict(model.named_buffers())
    state_paths = _paths(buffers, getattr(model, "jax_state_paths", list)())
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=0, generator=make_generator(seed, device),
                      jax_paths=_paths(params, getattr(
                          model, "jax_param_paths", list)()),
                      buffers={n: buffers[n] for n in state_paths},
                      state_paths=state_paths)


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def train_state_trees(state: TrainState) -> Dict[str, Any]:
    """The state as the JAX package's trees, on the host: ``params`` and
    every per-parameter entry of ``opt_state`` (``m``, ``v``, ``vmax``,
    ``velocity``) nested by the JAX parameter paths, the model's
    ``net_state`` (where it has state buffers) by their JAX paths, the
    optimizer's ``step`` and the train ``step`` as 0-d int32 tensors, in
    the JAX package's section order. Copies: the optimizer's in-place
    updates do not reach them. A parallel run's state gives its layout's
    trees: sharded leaves gathered, a pipeline's packed rows."""
    if state.layout is not None:
        return state.layout.trees(state)

    def nest(flat, paths=state.jax_paths):
        tree: Dict[str, Any] = {}
        for name, t in flat.items():
            path = paths[name]
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = t.detach().to("cpu", copy=True)
        return tree

    opt = {}
    for key, val in state.opt_state.items():
        opt[key] = nest(val) if isinstance(val, dict) \
            else val.detach().to("cpu", copy=True)
    trees = {"params": nest(state.params), "opt_state": opt}
    if state.buffers:
        trees["net_state"] = nest(state.buffers, state.state_paths)
    trees["step"] = torch.tensor(int(state.step), dtype=torch.int32)
    return trees


@torch.no_grad()
def load_jax_train_state(state: TrainState, params=None, opt_state=None,
                         step=None, net_state=None) -> TrainState:
    """Copy the JAX package's training state into ``state`` in place:
    ``params`` (its parameter tree), ``opt_state`` (its optimizer state:
    trees under ``m``, ``v``, ``vmax`` or ``velocity`` beside ``step``),
    ``step`` and ``net_state`` (the state buffers' tree), as numpy arrays
    or tensors. A parallel run's state loads through its layout (shards
    and replicas placed, a pipeline's packed rows unpacked). Returns
    ``state``."""
    if state.layout is not None:
        state.layout.load(state, params=params, opt_state=opt_state,
                          net_state=net_state)
        if step is not None:
            state.step = int(_as_tensor(step))
        return state
    if params is not None:
        for name, path in state.jax_paths.items():
            state.params[name].copy_(_as_tensor(_leaf(params, path)))
    if opt_state is not None:
        for key, val in state.opt_state.items():
            if isinstance(val, dict):
                for name, t in val.items():
                    t.copy_(_as_tensor(_leaf(opt_state[key],
                                             state.jax_paths[name])))
            else:
                val.copy_(_as_tensor(opt_state[key]))
    if net_state is not None:
        for name, path in state.state_paths.items():
            state.buffers[name].copy_(_as_tensor(_leaf(net_state, path)))
    if step is not None:
        state.step = int(_as_tensor(step))
    return state


def aux_loss_sum(net_state) -> torch.Tensor:
    """The sum of every "aux_loss" leaf a layer reported in a model's state
    (``GPT2.net_state()``, nested dicts): the load-balancing term of MoE
    layers, which ``make_train_step`` adds into the loss (JAX's
    ``aux_loss_sum``). A state without such leaves sums to 0."""
    total = torch.zeros((), dtype=torch.float32)
    for key, leaf in net_state.items():
        if isinstance(leaf, dict):
            leaf = aux_loss_sum(leaf)
        elif key != "aux_loss":
            continue
        total = total.to(leaf.device) + leaf.float()
    return total


def has_moe(model) -> bool:
    from ..nn.moe import MoE

    return any(isinstance(m, MoE) for m in model.modules())


def moe_aux_loss(model) -> torch.Tensor:
    """The sum of the aux losses of every MoE layer's last forward in
    ``model`` (``MoE.last_aux``), in the order of ``model.modules()``:
    the JAX step's ``aux_loss_sum`` over the new ``net_state``."""
    from ..nn.moe import MoE

    total = None
    for m in model.modules():
        if isinstance(m, MoE) and m.last_aux is not None:
            total = m.last_aux if total is None else \
                total + m.last_aux.to(total.device)
    return total


# -- rematerialisation --------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RematPolicy:
    """Which matmul outputs a checkpointed forward keeps: those of batched
    products too (``batch``), and whether they wait in host memory
    (``offload``)."""
    batch: bool
    offload: bool

    def ops(self) -> set:
        aten = torch.ops.aten
        ops = {aten.mm.default, aten.addmm.default}
        # the f32-output products of bf16 operands on the card
        ops |= {getattr(op, "dtype") for op in (aten.mm, aten.addmm)
                if hasattr(op, "dtype")}
        if self.batch:
            ops |= {aten.bmm.default, aten.baddbmm.default}
        return ops


def resolve_remat_policy(remat) -> Optional[RematPolicy]:
    """Map a ``remat`` value to a policy (None = recompute everything); a
    name that is not a policy raises."""
    if remat is True or remat in ("full", "true"):
        return None
    policies = {"dots": RematPolicy(batch=True, offload=False),
                "dots_no_batch": RematPolicy(batch=False, offload=False),
                "offload_dots": RematPolicy(batch=False, offload=True)}
    if remat not in policies:
        raise ValueError(f"unknown remat policy {remat!r}; choose "
                         f"from {sorted(policies)} or True/'full'")
    return policies[remat]


class _SaveOutputs(TorchDispatchMode):
    """The checkpointed forward's mode: each output of ``ops`` is kept in
    ``store`` (detached; in pinned host memory with ``offload``)."""

    def __init__(self, ops, store, offload):
        super().__init__()
        self.ops, self.store, self.offload = ops, store, offload

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in self.ops:
            kept = out.detach()
            if self.offload:
                host = torch.empty(kept.shape, dtype=kept.dtype,
                                   pin_memory=kept.is_cuda)
                kept = (kept.device, host.copy_(kept, non_blocking=True))
            # the version tells the replay whether the forward wrote into
            # the output in place after the product (then it is not the
            # product's value any more)
            self.store.append((kept, out._version))
        return out


class _ReplayOutputs(TorchDispatchMode):
    """The recompute's mode: each call of ``ops`` returns the output the
    forward kept, in order, instead of running; other ops run again."""

    def __init__(self, ops, store):
        super().__init__()
        self.ops, self.store, self.next = ops, store, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in self.ops:
            return func(*args, **(kwargs or {}))
        kept, version = self.store[self.next]
        self.next += 1
        if isinstance(kept, tuple):
            device, host = kept
            return host.to(device, non_blocking=True)
        if kept._version != version:
            raise RuntimeError(f"remat: the output of {func} was modified "
                               "in place after it was saved")
        return kept


def _contexts(policy: RematPolicy):
    ops, store = policy.ops(), []
    return (_SaveOutputs(ops, store, policy.offload),
            _ReplayOutputs(ops, store))


def remat_call(fn: Callable, policy: Optional[RematPolicy], generators,
               *args):
    """``fn(*args)`` under a non-reentrant checkpoint with ``policy``
    (None = full recompute); the recompute draws what the forward drew
    from ``generators`` (one generator, a sequence of them, or None)."""
    if isinstance(generators, torch.Generator):
        generators = [generators]
    gens = list({id(g): g for g in generators or () if g is not None}
                .values())
    snapshot = [g.get_state() for g in gens]
    calls = [0]

    def body(*a):
        calls[0] += 1
        if calls[0] == 1 or not gens:
            return fn(*a)
        live = [g.get_state() for g in gens]
        for g, s in zip(gens, snapshot):
            g.set_state(s)
        try:
            return fn(*a)
        finally:
            for g, s in zip(gens, live):
                g.set_state(s)

    kw = {} if policy is None else {
        "context_fn": functools.partial(_contexts, policy)}
    return torch.utils.checkpoint.checkpoint(body, *args,
                                             use_reentrant=False, **kw)


# -- the pieces every train step shares ---------------------------------------


def microbatches(data, labels, n: int):
    """The ``n`` microbatches of a batch (``grad_accum``), cut in order."""
    if data.shape[0] % n:
        raise ValueError(f"batch size {data.shape[0]} not divisible by "
                         f"grad_accum {n}")
    return zip(data.chunk(n), labels.chunk(n))


def host_scale(scheduler) -> Optional[torch.Tensor]:
    """A host-driven scheduler's current scale, else None (read once per
    call: the plateau scheduler moves between calls)."""
    if not getattr(scheduler, "host_driven", False):
        return None
    return torch.tensor(scheduler.current_scale(), dtype=torch.float32)


def apply_update(optimizer: Optimizer, scheduler: Scheduler,
                 state: TrainState, grads, params, lr_scale=None,
                 sq_norm: Optional[Callable] = None):
    """One optimizer update of ``params`` by ``grads``, in place, at
    ``lr_scale`` (by default the scheduler's: ``host_scale`` or its scale
    at ``state.step``); advances ``state.step``. Returns the scale.
    ``sq_norm(grads)`` gives the clip's squared global norm where
    ``grads`` is this process's part of the tree (a layout across
    processes); it runs only where the optimizer clips."""
    if lr_scale is None:
        lr_scale = host_scale(scheduler)
    if lr_scale is None:
        lr_scale = scheduler.scale(state.step)
    with torch.no_grad():
        norm = None if sq_norm is None or \
            optimizer.grad_clip_norm is None else sq_norm(grads)
        optimizer.update(grads, state.opt_state, params, lr_scale=lr_scale,
                         sq_norm=norm)
    state.step += 1
    return lr_scale


def step_metrics(loss, lr_scale, accuracy=None, aux_loss=None
                 ) -> Dict[str, Any]:
    """A train step's metrics: the loss and the scale, and the accuracy
    and the MoE aux loss where the step has them."""
    metrics = {"loss": loss, "lr_scale": lr_scale}
    if accuracy is not None:
        metrics["accuracy"] = accuracy
    if aux_loss is not None:
        metrics["aux_loss"] = aux_loss
    return metrics


# -- steps --------------------------------------------------------------------


def make_train_step(
    model,
    optimizer: Optimizer,
    loss_fn: Callable | str = "softmax_cross_entropy",
    scheduler: Optional[Scheduler] = None,
    compute_accuracy: bool = True,
    grad_accum: int = 1,
    augment: Optional[Callable] = None,
    remat: "bool | str" = False,
    lm_head_chunk: Optional[int] = None,
    steps_per_call: int = 1,
) -> Callable[[TrainState, torch.Tensor, torch.Tensor],
              Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """A ``(state, data, labels) -> (state, metrics)`` step.

    ``grad_accum`` > 1 splits the batch into that many microbatches and
    averages their gradients before ONE optimizer update. With
    ``steps_per_call`` = W > 1 the step takes (W, B, ...) data and labels,
    runs W optimizer steps in a host loop, and returns the mean of each
    metric plus the per-step ``loss_trace``; a host-driven scheduler gives
    one scale per call. ``remat`` is False, True / "full" or a policy
    name (``resolve_remat_policy``). ``lm_head_chunk`` computes the loss
    with ``nn.lm_loss.lm_head_loss`` over the model's ``apply_hidden`` and
    ``head_table`` in vocab tiles of that many rows, without the
    (tokens, vocab) logits; it replaces ``loss_fn`` and needs
    ``compute_accuracy=False``. A model with a ``net_state()`` that holds
    MoE layers' "aux_loss" leaves (``aux_loss_sum``) trains on the loss
    plus their sum, and its metrics carry the sum as ``aux_loss``.
    ``augment(generator, data)`` transforms each call's batch on the
    device before the forward (the module docstring).
    """
    if lm_head_chunk is not None:
        if compute_accuracy:
            raise ValueError("lm_head_chunk computes no logits; pass "
                             "compute_accuracy=False")
        if not (hasattr(model, "apply_hidden")
                and hasattr(model, "head_table")):
            raise ValueError(f"{type(model).__name__} lacks apply_hidden/"
                             "head_table; lm_head_chunk needs an LM model")
    policy = resolve_remat_policy(remat) if remat else None
    if isinstance(loss_fn, (str, dict)):
        loss_fn = losses_lib.get(loss_fn)
    scheduler = scheduler or NoOp()
    grad_accum = int(grad_accum)
    steps_per_call = int(steps_per_call)

    forward = model if lm_head_chunk is None else model.apply_hidden
    moe = has_moe(model)
    commit_state = getattr(model, "commit_state", None)

    def apply_model(data, generator):
        out = forward(data, train=True, generator=generator)
        # the MoE layers' aux losses of this very forward
        return out, moe_aux_loss(model) if moe else None

    def forward_backward(state, data, labels):
        gen = state.generator
        if remat:
            out, aux = remat_call(lambda d: apply_model(d, gen), policy, gen,
                                  data)
        else:
            out, aux = apply_model(data, gen)
        if lm_head_chunk is not None:
            loss = lm_head_loss(out, model.head_table(), labels,
                                lm_head_chunk)
        else:
            loss = loss_fn(out, labels)
        if aux is not None:
            loss = loss + aux
            aux = aux.detach()
        loss.backward()
        if commit_state is not None:
            commit_state()
        acc = metrics_lib.accuracy(out.detach(), labels) \
            if compute_accuracy else None
        return loss.detach(), acc, aux

    def one_step(state: TrainState, data, labels, lr_scale=None):
        for p in state.params.values():
            p.grad = None
        if augment is not None:
            data = augment(state.generator, data)
        if grad_accum == 1:
            loss, acc, aux = forward_backward(state, data, labels)
        else:
            inv = 1.0 / grad_accum
            loss = acc = aux = 0.0
            # each microbatch's backward adds into .grad; the sum is scaled
            for d, l in microbatches(data, labels, grad_accum):
                mb_loss, mb_acc, mb_aux = forward_backward(state, d, l)
                loss = loss + mb_loss
                if compute_accuracy:
                    acc = acc + mb_acc
                if moe:
                    aux = aux + mb_aux
            loss, acc, aux = loss * inv, acc * inv, aux * inv
            with torch.no_grad():
                for p in state.params.values():
                    p.grad.mul_(inv)
        grads = {name: p.grad for name, p in state.params.items()}
        lr_scale = apply_update(optimizer, scheduler, state, grads,
                                state.params, lr_scale)
        for p in state.params.values():
            p.grad = None
        return state, step_metrics(loss, lr_scale,
                                   acc if compute_accuracy else None,
                                   aux if moe else None)

    if steps_per_call == 1:
        return one_step

    def multi_step(state: TrainState, data, labels):
        scale = host_scale(scheduler)
        trace = []
        for i in range(data.shape[0]):
            state, m = one_step(state, data[i], labels[i], scale)
            trace.append(m)
        metrics = {k: torch.stack([torch.as_tensor(m[k]).to(
            trace[0]["loss"].device) for m in trace]).float().mean()
            for k in trace[0]}
        metrics["loss_trace"] = torch.stack([m["loss"] for m in trace])
        return state, metrics

    return multi_step


def make_eval_step(model, loss_fn: Callable | str = "softmax_cross_entropy",
                   compute_accuracy: bool = True):
    """A ``(state, data, labels) -> metrics`` step without gradients."""
    if isinstance(loss_fn, (str, dict)):
        loss_fn = losses_lib.get(loss_fn)

    @torch.no_grad()
    def step(state: TrainState, data, labels):
        out = model(data)
        metrics = {"loss": loss_fn(out, labels)}
        if compute_accuracy:
            metrics["corrects"] = metrics_lib.class_corrects(out, labels)
        return metrics

    return step


def make_predict(model):
    """A ``data -> logits`` function without gradients (inference needs no
    ``TrainState``: the port's models hold their weights)."""

    @torch.no_grad()
    def predict(data):
        return model(data)

    return predict
