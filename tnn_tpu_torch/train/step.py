"""Train, eval and predict steps (``tnn_tpu.train.step``).

A step is forward, loss, backward, optimizer update and metrics, run
eagerly: the model's f32 master parameters are updated in place by the
ported optimizer (``nn.optimizers``), with the scheduler's scale taken from
the step counter (or, for a host-driven scheduler, read once per call).
``TrainState`` carries the parameters, the optimizer state, the step
counter, the ``torch.Generator`` that dropout draws from and each
parameter's path in the JAX package's tree. Metrics stay tensors on the
device; reading one syncs.

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


def create_train_state(model, optimizer: Optimizer, seed: int = 0
                       ) -> TrainState:
    """The train state of an initialised ``model``: its parameters by name,
    the optimizer's zeroed state and a seeded generator on its device."""
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    names = {id(p): n for n, p in params.items()}
    paths = {names[id(p)]: tuple(path)
             for path, p in getattr(model, "jax_param_paths", list)()
             if id(p) in names}
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=0, generator=torch.Generator(device=device)
                      .manual_seed(seed), jax_paths=paths)


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def train_state_trees(state: TrainState) -> Dict[str, Any]:
    """The state as the JAX package's trees, on the host: ``params`` and
    every per-parameter entry of ``opt_state`` (``m``, ``v``, ``vmax``,
    ``velocity``) nested by the JAX parameter paths, the optimizer's
    ``step`` and the train ``step`` as 0-d int32 tensors. Copies: the
    optimizer's in-place updates do not reach them."""

    def nest(flat):
        tree: Dict[str, Any] = {}
        for name, t in flat.items():
            path = state.jax_paths[name]
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = t.detach().to("cpu", copy=True)
        return tree

    opt = {}
    for key, val in state.opt_state.items():
        opt[key] = nest(val) if isinstance(val, dict) \
            else val.detach().to("cpu", copy=True)
    return {"params": nest(state.params), "opt_state": opt,
            "step": torch.tensor(int(state.step), dtype=torch.int32)}


@torch.no_grad()
def load_jax_train_state(state: TrainState, params=None, opt_state=None,
                         step=None) -> TrainState:
    """Copy the JAX package's training state into ``state`` in place:
    ``params`` (its parameter tree), ``opt_state`` (its optimizer state:
    trees under ``m``, ``v``, ``vmax`` or ``velocity`` beside ``step``) and
    ``step``, as numpy arrays or tensors. Returns ``state``."""
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


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet; it is queued in "
                              "ROADMAP.md")


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


def remat_call(fn: Callable, policy: Optional[RematPolicy],
               generator: Optional[torch.Generator], *args):
    """``fn(*args)`` under a non-reentrant checkpoint with ``policy``
    (None = full recompute); the recompute draws what the forward drew
    from ``generator``."""
    snapshot = generator.get_state() if generator is not None else None
    calls = [0]

    def body(*a):
        calls[0] += 1
        if calls[0] == 1 or snapshot is None:
            return fn(*a)
        live = generator.get_state()
        generator.set_state(snapshot)
        try:
            return fn(*a)
        finally:
            generator.set_state(live)

    kw = {} if policy is None else {
        "context_fn": functools.partial(_contexts, policy)}
    return torch.utils.checkpoint.checkpoint(body, *args,
                                             use_reentrant=False, **kw)


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
    ``augment`` is not ported yet and raises.
    """
    if augment is not None:
        _not_ported("augment (on-device augmentation)")
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
    host_driven = getattr(scheduler, "host_driven", False)
    grad_accum = int(grad_accum)
    steps_per_call = int(steps_per_call)

    forward = model if lm_head_chunk is None else model.apply_hidden
    moe = any(getattr(m, "moe", None) is not None for m in model.modules())

    def apply_model(data, generator):
        out = forward(data, train=True, generator=generator)
        # the MoE layers' state of this very forward
        return out, aux_loss_sum(model.net_state()) if moe else None

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
        acc = metrics_lib.accuracy(out.detach(), labels) \
            if compute_accuracy else None
        return loss.detach(), acc, aux

    def one_step(state: TrainState, data, labels, lr_scale=None):
        for p in state.params.values():
            p.grad = None
        if grad_accum == 1:
            loss, acc, aux = forward_backward(state, data, labels)
        else:
            if data.shape[0] % grad_accum:
                raise ValueError(f"batch size {data.shape[0]} not divisible "
                                 f"by grad_accum {grad_accum}")
            inv = 1.0 / grad_accum
            loss = acc = aux = 0.0
            # each microbatch's backward adds into .grad; the sum is scaled
            for d, l in zip(data.chunk(grad_accum), labels.chunk(grad_accum)):
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
        if lr_scale is None:
            lr_scale = scheduler.scale(state.step)
        grads = {name: p.grad for name, p in state.params.items()}
        with torch.no_grad():
            optimizer.update(grads, state.opt_state, state.params,
                             lr_scale=lr_scale)
        for p in state.params.values():
            p.grad = None
        state.step += 1
        metrics = {"loss": loss, "lr_scale": lr_scale}
        if compute_accuracy:
            metrics["accuracy"] = acc
        if moe:
            metrics["aux_loss"] = aux
        return state, metrics

    def host_scale():
        # read once per call: the plateau scheduler moves between calls
        return torch.tensor(scheduler.current_scale(), dtype=torch.float32) \
            if host_driven else None

    if steps_per_call == 1:
        def step(state: TrainState, data, labels):
            return one_step(state, data, labels, host_scale())
        return step

    def multi_step(state: TrainState, data, labels):
        scale = host_scale()
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
