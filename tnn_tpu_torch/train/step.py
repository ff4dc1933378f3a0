"""Train and eval steps (``tnn_tpu.train.step``).

A step is forward, loss, backward, optimizer update and metrics, run
eagerly: the model's f32 master parameters are updated in place by the
ported optimizer (``nn.optimizers``), with the scheduler's scale taken from
the step counter. ``TrainState`` carries the parameters, the optimizer
state, the step counter and the ``torch.Generator`` that dropout draws
from. Metrics stay tensors on the device; reading one syncs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..nn import losses as losses_lib
from ..nn import metrics as metrics_lib
from ..nn.optimizers import Optimizer
from ..nn.schedulers import NoOp, Scheduler


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.nn.Parameter]   # the model's own parameters
    opt_state: Dict[str, Any]
    step: int
    generator: torch.Generator


def create_train_state(model, optimizer: Optimizer, seed: int = 0
                       ) -> TrainState:
    """The train state of an initialised ``model``: its parameters by name,
    the optimizer's zeroed state and a seeded generator on its device."""
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=0, generator=torch.Generator(device=device)
                      .manual_seed(seed))


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet; it is queued in "
                              "ROADMAP.md")


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
    metric plus the per-step ``loss_trace``. ``augment``, ``remat`` and
    ``lm_head_chunk`` are not ported yet and raise.
    """
    if augment is not None:
        _not_ported("augment (on-device augmentation)")
    if remat:
        _not_ported("remat (activation rematerialisation)")
    if lm_head_chunk is not None:
        _not_ported("lm_head_chunk (the fused LM-head loss, nn.lm_loss)")
    if isinstance(loss_fn, (str, dict)):
        loss_fn = losses_lib.get(loss_fn)
    scheduler = scheduler or NoOp()
    grad_accum = int(grad_accum)
    steps_per_call = int(steps_per_call)

    def forward_backward(state, data, labels):
        out = model(data, train=True, generator=state.generator)
        loss = loss_fn(out, labels)
        loss.backward()
        acc = metrics_lib.accuracy(out.detach(), labels) \
            if compute_accuracy else None
        return loss.detach(), acc

    def one_step(state: TrainState, data, labels):
        for p in state.params.values():
            p.grad = None
        if grad_accum == 1:
            loss, acc = forward_backward(state, data, labels)
        else:
            if data.shape[0] % grad_accum:
                raise ValueError(f"batch size {data.shape[0]} not divisible "
                                 f"by grad_accum {grad_accum}")
            inv = 1.0 / grad_accum
            loss = acc = 0.0
            # each microbatch's backward adds into .grad; the sum is scaled
            for d, l in zip(data.chunk(grad_accum), labels.chunk(grad_accum)):
                mb_loss, mb_acc = forward_backward(state, d, l)
                loss = loss + mb_loss
                if compute_accuracy:
                    acc = acc + mb_acc
            loss, acc = loss * inv, acc * inv
            with torch.no_grad():
                for p in state.params.values():
                    p.grad.mul_(inv)
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
        return state, metrics

    if steps_per_call == 1:
        return one_step

    def multi_step(state: TrainState, data, labels):
        trace = []
        for i in range(data.shape[0]):
            state, m = one_step(state, data[i], labels[i])
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
