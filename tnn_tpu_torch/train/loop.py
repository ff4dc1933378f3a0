"""The training loop (``tnn_tpu.train.loop``): epochs, progress lines,
validation, best-validation and per-epoch snapshots, resume.

``train_model`` runs ``config.epochs`` epochs of ``make_train_step`` over
the train loader (shuffled unless ``config.shuffle`` is off), at most
``config.max_steps`` batches an epoch, limited at the source so the
loader's cursor never runs ahead of the steps taken. Batches reach the
device through ``data.loader.prefetch`` (a producer thread, pinned host
tensors, a ``non_blocking`` copy). Every ``progress_print_interval``
batches it logs the loss and, with ``print_memory_usage``, the host's
RSS, and calls ``metric_hook`` and ``state_hook``. After each epoch it
validates (``evaluate``), feeds a plateau scheduler's ``observe``, saves a
blocking ``best/`` snapshot on a new best and a ``block=False`` step
snapshot. ``config.resume`` restores the whole state from a checkpoint
directory, the port's or the JAX package's, and a restored cursor in the
middle of an epoch continues that epoch. ``config.profiler_type`` NORMAL
records one event a step into ``profiling.GlobalProfiler``, CUMULATIVE
only a running total (``tick``); both log a summary at the end.

``config.mesh_axes`` lays the run out over a mesh of ``devices`` (by
default the first N cards, or N copies of the CPU for a model there; a
card may be named several times, as in ``["cuda:0"] * 4``), with the JAX
loop's checks and messages. Any mix of "data", "fsdp", "model", "seq"
and "expert" runs ``parallel.make_dp_train_step`` (fsdp shards the large
leaves, "model" the transformer's TP leaves, "expert" the MoE expert
stacks); with "seq" the steps and the evaluation run inside an
``nn.attention.ring_context`` of ``config.seq_parallel_method`` whose
batch axes are the live ones of ("data", "fsdp"). The trained weights
are written back into the model at the end. ``{"pipe": N}`` and
``{"data": N, "pipe": M}`` split the model (``partition_model``,
"balanced") into ``pipeline_virtual x N`` stages of
``parallel.make_pipeline_train_step`` over ``config.num_microbatches``,
starting from the model's weights and writing the trained ones back into
it at the end. A checkpoint of a pipeline run holds the JAX package's
packed rows.

Under an initialized ``parallel.process_group`` (``cli.dist_worker`` with
``jax_coordinator``) the mesh is the group's: its positions span the
processes, each process runs its own positions' streams or stages and
the step's sums and hops cross the processes (``parallel.data_parallel``,
``parallel.pipeline``). Every axis may span processes, alone or
together, MoE models too, and the log line names the axes that cross.
The evaluation's metrics are then the global batch's. A snapshot of a
run whose leaves (or packed stage rows, where "pipe" crosses) are
sharded across processes raises at the first save, as the JAX loop's
does (its ``device_get`` cannot fetch such an array;
``DataParallel.check_fetch``, ``PipelineLayout.check_fetch``).
With no ``mesh_axes`` each process trains its own replica on its own
device.
"""
from __future__ import annotations

import itertools
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..checkpoint import Checkpoint
from ..core import dtypes as dt
from ..data.loader import DataLoader, prefetch, stage_batch
from ..profiling import EventType, GlobalProfiler, profiled
from ..profiling import profiler as _prof_mod
from ..utils.config import TrainingConfig
from ..utils.hardware import memory_usage_kb
from ..utils.logging import get_logger
from .step import (TrainState, create_train_state, make_eval_step,
                   make_train_step)


def _staged_batches(loader: DataLoader, batch_size: int,
                    config: TrainingConfig, device, reset: bool = True,
                    limit: int = -1):
    """One epoch of the loader's batches on ``device``, floating data cast
    to ``config.io_dtype``, through ``prefetch``. ``limit`` bounds the
    batches at the source: the producer must not move the cursor past
    what the steps consume, or a mid-epoch snapshot would record a
    position ahead of the model."""
    io_dtype = dt.DTypePolicy(io=config.io_dtype).io_dtype

    def gen():
        it = loader.batches(batch_size, reset=reset)
        if limit >= 0:
            it = itertools.islice(it, limit)
        yield from it

    def place(batch):
        data, labels = stage_batch(batch, device)
        if data.is_floating_point():
            data = data.to(io_dtype)
        return data, labels

    return prefetch(gen(), to_device=place)


def evaluate(eval_step, state: TrainState, loader: DataLoader,
             batch_size: int, config: Optional[TrainingConfig] = None,
             device=None) -> Dict[str, float]:
    """Loss (and accuracy where the step counts corrects) over every
    complete batch of ``loader``; a loader smaller than one batch gives
    ``{"loss": nan}``."""
    cfg = config or TrainingConfig()
    device = device if device is not None else \
        next(iter(state.params.values())).device
    total, corrects, loss_sum, batches = 0, 0.0, 0.0, 0
    for data, labels in _staged_batches(loader, batch_size, cfg, device):
        m = eval_step(state, data, labels)
        loss_sum += float(m["loss"])
        if "corrects" in m:
            corrects += float(m["corrects"])
        total += len(labels)
        batches += 1
    if batches == 0:
        # NaN never wins the best-validation comparison
        return {"loss": float("nan")}
    out = {"loss": loss_sum / batches}
    if total:
        out["accuracy"] = corrects / total
    return out


def _mesh(axes, devices, model):
    from ..parallel import make_mesh

    return make_mesh(**{k: axes.get(k, 1) for k in
                        ("data", "fsdp", "model", "pipe", "seq", "expert")},
                     devices=devices, device=next(model.parameters()).device)


def _pipeline_run(model, config, axes, optimizer, scheduler, augment, state,
                  devices, sample_shape, log):
    """The pipeline's (pipe, state, step, eval step) from the model's
    weights (the JAX loop's checks and messages)."""
    from ..parallel import partitioner
    from ..parallel.pipeline import (make_pipeline_eval_step,
                                     make_pipeline_train_step)

    bad = set(axes) - {"pipe", "data"}
    if bad:
        raise ValueError(f"pipeline runs compose with 'data' only; got "
                         f"{axes}")
    pp, dp = axes["pipe"], axes.get("data", 1)
    if int(config.gradient_accumulation_steps) > 1:
        raise ValueError(
            "pipeline runs accumulate over num_microbatches; "
            "gradient_accumulation_steps > 1 would be silently ignored — "
            "set num_microbatches instead")
    batch_size = int(config.batch_size)
    num_mb = max(1, int(config.num_microbatches))
    if batch_size % (num_mb * dp):
        raise ValueError(f"batch_size {batch_size} not divisible by "
                         f"num_microbatches*data = {num_mb}*{dp}")
    mb_global = batch_size // num_mb
    mesh = _mesh(axes, devices, model)
    virtual = max(1, int(getattr(config, "pipeline_virtual", 1)))
    stages = partitioner.partition_model(
        model, virtual * pp, (mb_global,) + sample_shape,
        strategy="balanced")
    io_dtype = dt.DTypePolicy(io=config.io_dtype).io_dtype
    pipe, step_fn, init_fn = make_pipeline_train_step(
        stages, optimizer, mesh, (mb_global,) + sample_shape,
        loss_fn=config.loss, num_microbatches=num_mb, input_dtype=io_dtype,
        scheduler=scheduler, data_axis="data" if dp > 1 else None,
        augment=augment, remat=config.remat, virtual=virtual)
    pipe.load_from(model)
    if state is None:
        state = init_fn(None)
        state.generator.manual_seed(int(config.seed))
    log.info("pipeline mesh %s: %d stages x %d microbatches (dp=%d, v=%d)%s",
             {k: v for k, v in mesh.shape.items() if v > 1}, virtual * pp,
             num_mb, dp, virtual, _crossing(mesh))
    return pipe, state, step_fn, make_pipeline_eval_step(pipe)


def _has_expert_leaves(model) -> bool:
    from ..nn.moe import ep_rules
    from ..parallel.tensor_parallel import spec_for

    return any(spec_for(path, ep_rules()) for path, _ in
               getattr(model, "jax_param_paths", list)())


def _in_context(fn, ring):
    def run(*a):
        with ring:
            return fn(*a)

    return run


def _data_parallel_run(model, config, axes, optimizer, scheduler, augment,
                       state, devices, sample_shape, log):
    """The (state, step, eval step) of a data / fsdp / model / seq /
    expert layout (the JAX loop's checks and messages)."""
    from ..nn.attention import count_attention_modules, ring_context
    from ..parallel import make_dp_train_step

    unsupported = set(axes) - {"data", "fsdp", "model", "seq", "expert"}
    if unsupported:
        raise ValueError(
            f"train_model auto-sharding handles data/fsdp/model/seq/"
            f"expert/pipe axes; got {axes}.")
    shard_ways = axes.get("data", 1) * axes.get("fsdp", 1)
    if int(config.batch_size) % shard_ways:
        raise ValueError(
            f"batch_size {config.batch_size} not divisible by the "
            f"data*fsdp mesh size {shard_ways} (mesh_axes={axes})")
    if axes.get("expert", 1) > 1 and not _has_expert_leaves(model):
        raise ValueError(
            f"mesh_axes={{'expert': {axes['expert']}}} but the "
            f"model has no MoE expert parameters — "
            f"{axes['expert']}x devices would replicate work "
            f"with zero speedup")
    mesh = _mesh(axes, devices, model)
    ring = None
    if axes.get("seq", 1) > 1:
        if count_attention_modules(model) == 0:
            raise ValueError(
                f"mesh_axes={{'seq': {axes['seq']}}} but the model has "
                f"no attention modules — {axes['seq']}x devices would "
                f"replicate work with zero speedup")
        if len(sample_shape) == 1 and sample_shape[0] % axes["seq"]:
            raise ValueError(
                f"sequence length {sample_shape[0]} not divisible by "
                f"mesh_axes['seq'] = {axes['seq']}")
        batch_axes = tuple(a for a in ("data", "fsdp") if axes.get(a, 1) > 1)
        ring = ring_context(mesh, batch_axis=batch_axes or None,
                            method=config.seq_parallel_method)
    if state is None:
        state = create_train_state(model, optimizer, seed=config.seed)
    step_fn, place_state, _ = make_dp_train_step(
        model, optimizer, mesh, loss_fn=config.loss, scheduler=scheduler,
        fsdp=axes.get("fsdp", 1) > 1, tp=axes.get("model", 1) > 1,
        ep=axes.get("expert", 1) > 1,
        grad_accum=config.gradient_accumulation_steps, augment=augment,
        remat=config.remat)
    state = place_state(state)
    eval_fn = step_fn.eval_step(config.loss)
    if ring is not None:
        step_fn, eval_fn = _in_context(step_fn, ring), \
            _in_context(eval_fn, ring)
    log.info("mesh %s: batch sharded over %d positions%s",
             {k: v for k, v in mesh.shape.items() if v > 1}, mesh.size,
             _crossing(mesh))
    return state, step_fn, eval_fn


def _crossing(mesh) -> str:
    """The log's note of the processes a mesh spans and its axes that
    cross them."""
    if not mesh.spans_processes:
        return ""
    return (f" of {len(set(mesh.processes.flat))} processes (crossing: "
            f"{', '.join(mesh.crossing_axes())})")


def train_model(
    model,
    config: TrainingConfig,
    train_loader: DataLoader,
    val_loader: Optional[DataLoader] = None,
    optimizer=None,
    scheduler=None,
    augment: Optional[Callable] = None,
    state: Optional[TrainState] = None,
    metric_hook: Optional[Callable[[int, Dict[str, Any]], None]] = None,
    state_hook: Optional[Callable[[TrainState], None]] = None,
    devices: Optional[Sequence] = None,
) -> Tuple[TrainState, List[Dict[str, Any]]]:
    """Train ``model`` per ``config``; returns (final state, per-epoch
    history). ``state`` continues a given state (otherwise a fresh one,
    its generator seeded with ``config.seed``). ``state_hook`` sees the
    live state at set-up, at every progress line and at each epoch's
    end. ``devices`` lays out ``config.mesh_axes`` (the module
    docstring)."""
    log = get_logger("tnn.train")
    if config.log_file:
        log.set_file_sink(config.log_file)
    axes = {k: int(v) for k, v in (config.mesh_axes or {}).items()
            if int(v) > 1}
    profiler_mode = config.profiler_type.upper()
    profiling_on = profiler_mode not in ("", "NONE")
    cumulative_prof = profiler_mode == "CUMULATIVE"
    optimizer = optimizer or config.make_optimizer()
    scheduler = scheduler or config.make_scheduler()
    plateau = getattr(scheduler, "host_driven", False)
    batch_size = int(config.batch_size)
    device = next(model.parameters()).device

    pipe = layout = None
    if "pipe" in axes:
        pipe, state, step_fn, eval_fn = _pipeline_run(
            model, config, axes, optimizer, scheduler, augment, state,
            devices, tuple(train_loader.data_shape), log)
    elif axes:
        state, step_fn, eval_fn = _data_parallel_run(
            model, config, axes, optimizer, scheduler, augment, state,
            devices, tuple(train_loader.data_shape), log)
        layout = state.layout
    else:
        if state is None:
            state = create_train_state(model, optimizer, seed=config.seed)
        step_fn = make_train_step(
            model, optimizer, loss_fn=config.loss, scheduler=scheduler,
            grad_accum=config.gradient_accumulation_steps, augment=augment,
            remat=config.remat)
        eval_fn = make_eval_step(model, loss_fn=config.loss)

    ckpt = Checkpoint(config.snapshot_dir)
    best_val = -float("inf")
    resumed = False
    if config.resume:
        state, meta = Checkpoint(config.resume).restore(
            state, scheduler=scheduler, loader=train_loader)
        best_val = float(meta.get("extra", {}).get("best_val",
                                                   -float("inf")))
        resumed = True
        log.info("resumed from %s at step %d", config.resume,
                 int(state.step))

    history: List[Dict[str, Any]] = []
    if state_hook:
        state_hook(state)
    if config.shuffle and not resumed:
        train_loader.shuffle()

    # the global profiler is touched only when this run profiles, and put
    # back in the finally
    if profiling_on:
        GlobalProfiler.clear()
        _prof_mod.enable(True)
    try:
        for epoch in range(int(config.epochs)):
            t_epoch = time.perf_counter()
            window_t0 = time.perf_counter()
            n_batches = 0
            m: Dict[str, Any] = {}
            # a resumed first epoch goes on from the restored cursor (an
            # end-of-epoch snapshot has no batches left: a fresh epoch)
            continue_epoch = (resumed and epoch == 0
                              and train_loader.remaining_batches(
                                  batch_size) > 0)
            for data, labels in _staged_batches(
                    train_loader, batch_size, config, device,
                    reset=not continue_epoch, limit=config.max_steps):
                if cumulative_prof:
                    t_step = time.perf_counter()
                    state, m = step_fn(state, data, labels)
                    GlobalProfiler.tick("train_step",
                                        time.perf_counter() - t_step)
                else:
                    with profiled(f"train_step/epoch{epoch}",
                                  EventType.COMPUTE):
                        state, m = step_fn(state, data, labels)
                n_batches += 1
                # metrics are read at the print interval only
                if n_batches % max(1, config.progress_print_interval) == 0:
                    loss = float(m["loss"])
                    acc = float(m.get("accuracy", 0.0))
                    dt_batch = (time.perf_counter() - window_t0) * 1e3 / max(
                        1, config.progress_print_interval)
                    window_t0 = time.perf_counter()
                    log.info("epoch %d batch %d: loss=%.4f acc=%.4f %.1f "
                             "ms/batch (%.0f samples/s)", epoch, n_batches,
                             loss, acc, dt_batch,
                             batch_size * 1e3 / max(dt_batch, 1e-9))
                    if config.print_memory_usage:
                        log.info("host RSS: %.1f MiB",
                                 memory_usage_kb() / 1024)
                    if metric_hook:
                        metric_hook(int(state.step), {"loss": loss,
                                                      "accuracy": acc,
                                                      "epoch": epoch})
                    if state_hook:
                        state_hook(state)

            if state_hook:
                state_hook(state)
            epoch_metrics: Dict[str, Any] = {
                "epoch": epoch,
                "train_loss": float(m["loss"]) if n_batches
                else float("nan"),
                "train_accuracy": float(m.get("accuracy", 0.0))
                if n_batches else 0.0,
                "batches": n_batches,
                "epoch_seconds": time.perf_counter() - t_epoch,
            }
            if val_loader is not None:
                val = evaluate(eval_fn, state, val_loader, batch_size,
                               config, device)
                epoch_metrics["val_loss"] = val["loss"]
                epoch_metrics["val_accuracy"] = val.get("accuracy", 0.0)
                if plateau and np.isfinite(val["loss"]):
                    scheduler.observe(val["loss"])
                score = val.get("accuracy", -val["loss"])
                if score > best_val:
                    best_val = score
                    path = ckpt.save(state, model=model, scheduler=scheduler,
                                     loader=train_loader,
                                     extra={"epoch": epoch, **val},
                                     best=True)
                    log.info("new best val %.4f -> %s", score, path)
            # the per-epoch snapshot writes while the next epoch runs; the
            # best-val save above blocks (its path may be read at once)
            ckpt.save(state, model=model, scheduler=scheduler,
                      loader=train_loader,
                      extra={**epoch_metrics, "best_val": best_val},
                      block=False)
            log.info("epoch %d done in %.1fs: train loss=%.4f acc=%.4f%s",
                     epoch, epoch_metrics["epoch_seconds"],
                     epoch_metrics["train_loss"],
                     epoch_metrics["train_accuracy"],
                     (f" | val loss={epoch_metrics['val_loss']:.4f} "
                      f"acc={epoch_metrics.get('val_accuracy', 0):.4f}")
                     if val_loader is not None else "")
            history.append(epoch_metrics)
    finally:
        ckpt.wait()     # the last epoch's snapshot lands before the return
        if pipe is not None:
            pipe.write_back(model)
        if layout is not None:
            layout.write_back(model)
        if profiling_on:
            for name, s in sorted(GlobalProfiler.summary().items()):
                log.info("profile %s: n=%d total=%.3fs mean=%.1fms", name,
                         int(s["count"]), s["total_s"], s["mean_s"] * 1e3)
            for key, total in sorted(GlobalProfiler.counters.items()):
                log.info("profile counter %s: total=%.3fs", key, total)
            _prof_mod.enable(False)
    return state, history
