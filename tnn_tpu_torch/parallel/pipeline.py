"""Pipeline parallelism (``tnn_tpu.parallel.pipeline``), in three forms.

1. ``spmd_pipeline`` / ``spmd_pipeline_interleaved``: identical-structure
   stages from stacked parameters (``stack_stage_params``), microbatches
   run on the GPipe tick schedule, or the interleaved one over ``virtual``
   chunks a device, each stage on its pipe position's device, every hop
   through ``mesh.hop``. Differentiable end to end.

2. ``HeteroPipeline`` / ``make_pipeline_train_step`` /
   ``make_pipeline_eval_step``: heterogeneous stages (a ``partitioner``
   split) on a (data x) pipe mesh, trained on the JAX package's schedule.
   Stage ``c * pp + d`` lives on pipe position d; the tick loop runs each
   (stage, microbatch) pair in its active window only (the JAX program
   runs every tick and masks the others: the numbers are the same), so a
   stage's BatchNorm state advances once a microbatch, as single-device
   gradient accumulation advances it. Activations hop in one buffer
   dtype, the JAX rule: the promotion of every boundary's dtype and the
   input's, integer inputs through float32. The loss is every active
   stage's aux loss (MoE) plus the last stage's loss, over the
   microbatches; the accuracy comes from the last stage alone. Under a
   data axis each data rank pipelines its slice of every microbatch with
   its own stage replicas: BatchNorm normalizes by the slice's statistics,
   the running statistics and the loss are averaged over the ranks, the
   corrects summed, the gradients reduced (``mesh.all_reduce``). One
   optimizer update runs over every stage's parameters together, as the
   JAX step updates its packed rows. ``remat`` recomputes each stage's
   forward in the backward (``train.step.remat_call``).

   The state's layout (``PipelineLayout``) gives and takes the JAX
   package's packed rows: row ``d * v + c`` holds stage ``c * pp + d``,
   its parameter (state) leaves in the JAX tree's order, float32, padded
   to the widest stage, so a checkpoint of either package's pipeline run
   restores into the other's.

   JAX's compiled pipeline sizes its stages without the input dtype, so a
   ``Sequential`` whose first layer is an ``Embedding`` (token input)
   fails there; the port raises a ``ValueError`` naming that limit.

   The forward keeps each (rank, stage, microbatch) pair's graph with its
   input cut off at the hop; the loss's ``backward()`` runs the reverse
   schedule by hand (``HeteroPipeline.backward``): tick by tick from the
   last, each pair backed out with its output's gradient from the next
   stage and each loss term's from the loss's gradient, the input's
   gradient hopped back. In one process and across processes the same
   arithmetic runs in the same order.

   **Across processes** (a mesh over an initialized ``process_group``):
   "pipe" and "data" may span processes. Every process builds every stage
   once to learn the boundaries' shapes and dtypes, then keeps only the
   stages and replicas of its own (data, pipe) positions (the others go to
   the meta device). Every process runs the same tick loop over its own
   pairs (``_Row``); a boundary between two processes is a hop in the
   buffer dtype at the tick's end (``process_group.p2p``: each process
   sends what its positions finished and receives what they run next), so
   a hop is issued by its sender and its receiver alone, and the reverse
   schedule runs the same hops backwards in the same order on every
   process. Each loss term is filled into a (rank, term) table by the
   process that computed it and the table all-reduced over the mesh's
   processes, so the loss and the corrects reach every process, added in
   the one-process order; the running statistics and the gradients sum
   over the data axis's processes, and the optimizer's clip scales by the
   global norm of every stage's gradient (``grad_sq_norm``). Where "pipe"
   crosses, the packed rows are sharded over it across processes and a
   snapshot raises, as JAX's ``device_get`` does
   (``PipelineLayout.check_fetch``); where only "data" crosses, every
   process holds every row. ``spmd_pipeline`` over a pipe axis that
   crosses processes runs the same row (``_AcrossRun``), its outputs on
   every process.

3. ``StagePipeline``: one stage a device, microbatches flowing through the
   stages in order with their BatchNorm state threaded through, gradients
   accumulated, one optimizer step a stage; token inputs work here.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..nn import losses as losses_lib
from ..nn import metrics as metrics_lib
from ..core.rng import make_generator
from ..nn.optimizers import sum_leaves, tree_leaves, tree_map
from ..nn.schedulers import NoOp
from ..train.step import (TrainState, apply_update, has_moe, moe_aux_loss,
                          remat_call, resolve_remat_policy, step_metrics)
from . import mesh as mesh_lib
from . import process_group
from .data_parallel import check_spans
from .mesh import Mesh

# ---------------------------------------------------------------------------
# 1. homogeneous stages
# ---------------------------------------------------------------------------


def stack_stage_params(per_stage_params: Sequence) -> Any:
    """Identical-structure stage trees stacked into one tree with a
    leading stage axis."""
    return tree_map(lambda *xs: torch.stack(xs), *per_stage_params)


def _pipe_devices(mesh: Mesh, axis: str) -> List[torch.device]:
    names = mesh_lib.AXES
    index = [0] * len(names)
    out = []
    for d in range(mesh_lib.axis_size(mesh, axis)):
        index[names.index(axis)] = d
        out.append(mesh.devices[tuple(index)])
    return out


def _stage_slice(stacked, s: int, device):
    return tree_map(lambda a: a[s].to(device), stacked)


def _homogeneous_run(block_fn, stacked_params, x_microbatches, mesh, axis,
                     virtual):
    pp = mesh_lib.axis_size(mesh, axis)
    num_mb = x_microbatches.shape[0]
    if num_mb < 1:
        raise ValueError("need at least one microbatch")
    n_stages = tree_leaves(stacked_params)[0].shape[0]
    if virtual < 1 or n_stages != virtual * pp:
        raise ValueError(f"stacked_params leading dim {n_stages} != "
                         f"virtual {virtual} * pipe {pp}")
    if virtual > 1 and num_mb % pp:
        raise ValueError(f"interleaved schedule needs num_microbatches "
                         f"({num_mb}) divisible by pipe size ({pp})")
    devices = _pipe_devices(mesh, axis)
    row = _Row.of(mesh, axis, [0] * len(mesh_lib.AXES), virtual, num_mb)
    if row.crosses:
        if not row.active:
            raise ValueError(
                f"process {row.me} holds no position of the {axis} row "
                f"through position 0 ({mesh!r}): across processes every "
                f"process of the pipeline holds a stage")
        leaves = tree_leaves(stacked_params)
        return _AcrossRun.apply(block_fn, stacked_params, row,
                                x_microbatches, *leaves)
    params = [_stage_slice(stacked_params, s, devices[s % pp])
              for s in range(n_stages)]
    outs: Dict[Tuple[int, int], torch.Tensor] = {}
    results = [None] * num_mb
    for d, c, m in _ticks(pp, virtual, num_mb):
        s = c * pp + d
        if s == 0:
            x = x_microbatches[m].to(devices[0])
        else:
            x = mesh_lib.hop(outs.pop((s - 1, m)), devices[d])
        y = _block(block_fn, params[s], x)
        if s == n_stages - 1:
            results[m] = y
        else:
            outs[(s, m)] = y
    return torch.stack([r.to(devices[-1]) for r in results])


def _block(block_fn, params, x):
    y = block_fn(params, x)
    if y.shape != x.shape:
        raise ValueError(f"pipeline stages must preserve activation "
                         f"shape, got {tuple(x.shape)} -> {tuple(y.shape)}")
    return y


def _ticks(pp: int, v: int, num_mb: int, with_tick: bool = False):
    """(pipe position d, chunk c, microbatch m) of every active pair, tick
    by tick (``with_tick``: (t, d, c, m)): GPipe's m = t - d at v = 1,
    else the interleaved sub-tick tau(c * pp + d, m) = d + m % pp + pp *
    (c + v * (m // pp))."""
    if v == 1:
        n_ticks = num_mb + pp - 1
    else:
        n_ticks = ((pp - 1) + ((num_mb - 1) % pp)
                   + pp * ((v - 1) + v * ((num_mb - 1) // pp)) + 1)
    for t in range(n_ticks):
        for d in range(pp):
            w = t - d
            if w < 0:
                continue
            if v == 1:
                c, m = 0, w
            else:
                q, j = divmod(w, pp)
                c, m = q % v, (q // v) * pp + j
            if m < num_mb:
                yield (t, d, c, m) if with_tick else (d, c, m)


def _tick_table(pp: int, v: int, num_mb: int) -> List[List[Tuple[int, int,
                                                                 int]]]:
    """The active (pipe position d, chunk c, microbatch m) pairs of each
    tick (``_ticks``)."""
    table: List[List[Tuple[int, int, int]]] = []
    t = -1
    for tick, d, c, m in _ticks(pp, v, num_mb, with_tick=True):
        while t < tick:
            table.append([])
            t += 1
        table[-1].append((d, c, m))
    return table


class _Row:
    """One data rank's pipe positions, as this process runs their part of
    the tick loop (the module docstring: across processes). ``procs[d]``
    and ``devices[d]`` are position d's process and device; a stage's
    output goes to the next stage's position within this process by
    ``Tensor.to``, to another process at the tick's boundary, where every
    process sends what its positions finished and receives what its
    positions run next (``process_group.p2p``), so each hop is issued by
    its sender and its receiver alone."""

    def __init__(self, procs: Sequence[int], devices, me: int, pp: int,
                 v: int, num_mb: int):
        self.procs, self.devices, self.me = list(procs), list(devices), me
        self.pp, self.L = pp, pp * v
        self.ticks = _tick_table(pp, v, num_mb)
        self.crosses = len(set(self.procs)) > 1

    @classmethod
    def of(cls, mesh: Mesh, axis: str, index, v: int, num_mb: int):
        """The row through mesh position ``index`` along ``axis``."""
        pp = mesh_lib.axis_size(mesh, axis)
        at = mesh_lib.AXES.index(axis)
        idx = [tuple(list(index[:at]) + [d] + list(index[at + 1:]))
               for d in range(pp)]
        procs = [int(mesh.processes[i]) if mesh.processes is not None
                 else 0 for i in idx]
        return cls(procs, [mesh.devices[i] for i in idx], mesh.process_index,
                   pp, v, num_mb)

    def local(self, d: int) -> bool:
        return self.procs[d] == self.me

    @property
    def active(self) -> bool:
        return self.me in self.procs

    def _pairs(self, t: int):
        if 0 <= t < len(self.ticks):
            for d, c, m in self.ticks[t]:
                if self.local(d):
                    yield d, c * self.pp + d, m

    def forward(self, start: Callable, run: Callable, shape: Callable,
                dtype, train: bool) -> None:
        """Every pair of this process's positions in tick order:
        ``start(m)`` is stage 0's input, ``run(s, m, x)`` stage s's
        output (the hop's tensor, ``shape(s)`` and ``dtype`` as stage s
        + 1 takes it), the last stage's ignored. A stage's input from
        another stage arrives detached, requiring grad under ``train``."""
        inbox: Dict[Tuple[int, int], torch.Tensor] = {}
        for t in range(len(self.ticks)):
            sends = []
            for d, s, m in self._pairs(t):
                y = run(s, m, start(m) if s == 0 else inbox.pop((s, m)))
                if s == self.L - 1:
                    continue
                nd = (d + 1) % self.pp
                if self.local(nd):
                    inbox[(s + 1, m)] = y.detach().to(
                        self.devices[nd]).requires_grad_(train)
                else:
                    sends.append((y, self.procs[nd]))
            recvs = [(d, s, m) for d, s, m in self._pairs(t + 1)
                     if s > 0 and not self.local((d - 1) % self.pp)]
            if sends or recvs:
                got = process_group.p2p(sends, [
                    (shape(s), dtype, self.procs[(d - 1) % self.pp],
                     self.devices[d]) for d, s, m in recvs])
                for (d, s, m), x in zip(recvs, got):
                    inbox[(s, m)] = x.requires_grad_(train)

    def backward(self, back: Callable, shape: Callable, dtype) -> None:
        """The reverse of ``forward``, tick by tick from the last, the
        same hops backwards: ``back(s, m, g)`` backs pair (s, m) out with
        ``g`` the gradient of its output (None for the last stage) and
        returns the gradient of its input (ignored for stage 0)."""
        outbox: Dict[Tuple[int, int], torch.Tensor] = {}
        for t in reversed(range(len(self.ticks))):
            sends = []
            for d, s, m in reversed(list(self._pairs(t))):
                gx = back(s, m, outbox.pop((s, m), None))
                if s == 0:
                    continue
                pd = (d - 1) % self.pp
                if self.local(pd):
                    outbox[(s - 1, m)] = gx.to(self.devices[pd])
                else:
                    sends.append((gx, self.procs[pd]))
            recvs = [(d, s, m) for d, s, m in self._pairs(t - 1)
                     if s < self.L - 1
                     and not self.local((d + 1) % self.pp)]
            if sends or recvs:
                got = process_group.p2p(sends, [
                    (shape(s + 1), dtype, self.procs[(d + 1) % self.pp],
                     self.devices[d]) for d, s, m in recvs])
                for (d, s, m), g in zip(recvs, got):
                    outbox[(s, m)] = g


class _AcrossRun(torch.autograd.Function):
    """``spmd_pipeline`` over a pipe axis that crosses processes: this
    process runs its stages' pairs (``_Row``) and keeps their graphs; the
    last stage's outputs reach every process of the row (an all-reduce
    in which only their process adds more than zeros). Its backward runs
    the row's reverse schedule from the last stage process's output
    gradient (every process computes the same downstream, so that one is
    the whole gradient) and all-reduces the input's and the stacked
    parameters' gradients over the row alike, each entry from one
    process."""

    @staticmethod
    def forward(ctx, block_fn, stacked, row, x, *leaves):
        group = process_group.group_of(sorted(set(row.procs)))
        pp, num_mb = row.pp, x.shape[0]
        slices = {}
        for d, s, m in (p for t in range(len(row.ticks))
                        for p in row._pairs(t)):
            if s not in slices:
                slices[s] = [a[s].detach().to(row.devices[d])
                             .requires_grad_(a.requires_grad)
                             for a in leaves]
        spec = tree_map(lambda a: None, stacked)
        pieces = {s: _unflatten(spec, ps) for s, ps in slices.items()}
        with torch.no_grad():
            probe = block_fn(next(iter(pieces.values())), x[0, :1].to(
                row.devices[0] if row.local(0) else
                next(iter(slices.values()))[0].device))
        dtype = probe.dtype
        xs = [x[m].detach().to(row.devices[0]).requires_grad_(
            x.requires_grad) if row.local(0) else None
            for m in range(num_mb)]
        kept, results = {}, [None] * num_mb

        def run(s, m, h):
            with torch.enable_grad():
                y = _block(block_fn, pieces[s], h)
            kept[(s, m)] = (h, y)
            if s == row.L - 1:
                results[m] = y.detach()
            return y.to(dtype)

        row.forward(lambda m: xs[m], run, lambda s: tuple(x.shape[1:]),
                    dtype, True)
        last = row.procs[(row.L - 1) % pp]
        out = torch.stack(results) if row.me == last else \
            torch.zeros((num_mb,) + tuple(x.shape[1:]), dtype=dtype,
                        device=row.devices[0] if row.local(0) else
                        next(iter(slices.values()))[0].device)
        out = process_group.all_reduce(out, group=group)
        ctx.state = (row, group, kept, slices, xs, dtype, last, x, leaves)
        return out

    @staticmethod
    def backward(ctx, g):
        row, group, kept, slices, xs, dtype, last, x, leaves = ctx.state
        gx = torch.zeros_like(x)

        def back(s, m, g_out):
            h, y = kept.pop((s, m))
            if s == row.L - 1:
                g_out = g[m] if row.me == last else torch.zeros_like(y)
            torch.autograd.backward([y], [g_out.to(y.device, y.dtype)])
            if s == 0:
                if h.grad is not None:
                    gx[m] = h.grad.to(gx.device)
                return None
            return h.grad.to(dtype)

        row.backward(back, lambda s: tuple(x.shape[1:]), dtype)
        grads = []
        for k, a in enumerate(leaves):
            full = torch.zeros_like(a)
            for s, ps in slices.items():
                if ps[k].grad is not None:
                    full[s] = ps[k].grad.to(full.device)
            grads.append(process_group.all_reduce(full, group=group))
        gx = process_group.all_reduce(gx, group=group) \
            if x.requires_grad else None
        return (None, None, None, gx, *grads)


def _unflatten(spec, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), spec)


def spmd_pipeline(block_fn: Callable, stacked_params, x_microbatches,
                  mesh: Mesh, axis: str = "pipe"):
    """Microbatches (num_mb, mb, ...) through a chain of identical-
    structure stages: ``block_fn(stage_params, activation)``, stage s's
    parameters the s-th slice of ``stacked_params``. Returns the last
    stage's outputs (num_mb, mb, ...)."""
    return _homogeneous_run(block_fn, stacked_params, x_microbatches, mesh,
                            axis, 1)


def spmd_pipeline_interleaved(block_fn: Callable, stacked_params,
                              x_microbatches, mesh: Mesh,
                              axis: str = "pipe", virtual: int = 2):
    """``spmd_pipeline`` over L = virtual * pp stages placed round-robin
    (stage s on pipe position s % pp), on the interleaved schedule;
    num_mb must be a multiple of pp."""
    return _homogeneous_run(block_fn, stacked_params, x_microbatches, mesh,
                            axis, int(virtual))


# ---------------------------------------------------------------------------
# 2. heterogeneous stages
# ---------------------------------------------------------------------------


def _sorted_paths(pairs) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, tensor) pairs in the JAX tree's flattening order (dict keys
    sorted at every level)."""
    return sorted(pairs, key=lambda kv: kv[0])


def _pack(tensors: Sequence[torch.Tensor], length: int) -> torch.Tensor:
    row = torch.zeros(length, dtype=torch.float32)
    off = 0
    for t in tensors:
        flat = t.detach().float().reshape(-1).cpu()
        row[off:off + flat.numel()] = flat
        off += flat.numel()
    return row


@torch.no_grad()
def _unpack(row, tensors: Sequence[torch.Tensor]) -> None:
    row = _rows(row).reshape(-1)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(row[off:off + n].reshape(t.shape).to(t.dtype))
        off += n


def _is_token_input(stage) -> bool:
    layers = getattr(stage, "layers", None)
    return bool(layers) and getattr(layers[0], "type_name", "") == \
        "embedding"


class HeteroPipeline:
    """The plan and the stage replicas of a heterogeneous-stage pipeline
    (the module docstring). ``input_shape`` is the global microbatch's
    shape; ``stages`` are built (on their devices) if they are not."""

    def __init__(self, stages: Sequence, mesh: Mesh, input_shape,
                 input_dtype=torch.bfloat16, num_microbatches: int = 4,
                 axis: str = "pipe", loss_fn=None,
                 compute_accuracy: bool = True,
                 data_axis: Optional[str] = None,
                 remat: "bool | str" = False, virtual: int = 1):
        self.stages = list(stages)
        self.mesh = mesh
        self.axis = axis
        self.pp = mesh_lib.axis_size(mesh, axis)
        self.v = int(virtual)
        other = {k: n for k, n in mesh.shape.items()
                 if k not in (axis, data_axis) and n > 1}
        if other:
            raise ValueError(
                f"pipeline runs compose with '{data_axis or 'data'}' only; "
                f"got mesh axes {other}")
        self.data_axis = data_axis if (
            data_axis and mesh_lib.axis_size(mesh, data_axis) > 1) else None
        self.dp = mesh_lib.axis_size(mesh, data_axis) if self.data_axis \
            else 1
        if self.dp > 1:
            if input_shape[0] % self.dp:
                raise ValueError(f"microbatch size {input_shape[0]} not "
                                 f"divisible by data axis {self.dp}")
            input_shape = (input_shape[0] // self.dp,) + tuple(
                input_shape[1:])
        if self.v * self.pp != len(self.stages):
            raise ValueError(f"{len(self.stages)} stages != virtual "
                             f"{self.v} x mesh {axis} size {self.pp}")
        self.L = len(self.stages)
        self.num_mb = int(num_microbatches)
        if self.v > 1 and self.num_mb % self.pp:
            raise ValueError(f"interleaved schedule needs num_microbatches "
                             f"({self.num_mb}) divisible by pipe "
                             f"({self.pp})")
        if _is_token_input(self.stages[0]):
            raise ValueError(
                "the compiled pipeline takes no token-input Sequential: "
                "the JAX package sizes its stages without the input dtype "
                "(tnn_tpu/parallel/pipeline.py:344, :383), so an Embedding "
                "first layer fails there; run it through StagePipeline")
        # device-order rows: row r = d * v + c holds stage c * pp + d
        self._stage_of_row = [(r % self.v) * self.pp + r // self.v
                              for r in range(self.L)]
        if isinstance(loss_fn, (str, dict)) or loss_fn is None:
            loss_fn = losses_lib.get(loss_fn or "softmax_cross_entropy")
        self.loss_fn = loss_fn
        self.compute_accuracy = bool(compute_accuracy)
        self.remat = remat
        self._remat_policy = resolve_remat_policy(remat) if remat else None
        self.devices = [[mesh.devices[self._index(r, d)]
                         for d in range(self.pp)] for r in range(self.dp)]
        self.spans = mesh.spans_processes
        check_spans(mesh)
        self.rows = [_Row.of(mesh, axis, self._index(r, 0), self.v,
                             self.num_mb) for r in range(self.dp)]
        # this process's (data rank, pipe position) pairs
        self.held = {(r, d) for r in range(self.dp) for d in range(self.pp)
                     if mesh.is_local(self._index(r, d))}
        self.home = mesh.devices[self._index(*min(self.held))]

        # shapes through the boundaries, each stage built on its device
        # (another process's stage on this process's first, until the
        # dtypes are probed)
        self.in_shapes: List[Tuple[int, ...]] = []
        shape = tuple(input_shape)
        for s, stage in enumerate(self.stages):
            self.in_shapes.append(shape)
            dev = self.devices[0][s % self.pp] if (0, s % self.pp) in \
                self.held else self.home
            if getattr(stage, "device", None) is None:
                stage.build(shape, dev)
            else:
                stage.to(dev)
                stage.device = dev
            shape = tuple(stage.output_shape(shape))
        self.out_shape = shape
        self.in_dtypes = self._probe_dtypes(input_dtype)
        self.replicas = [[st if (r, s % self.pp) in self.held else None
                          for s, st in enumerate(self.stages)]
                         for r in range(self.dp)]
        for r in range(1, self.dp):
            for s, st in enumerate(self.stages):
                if (r, s % self.pp) in self.held:
                    dev = self.devices[r][s % self.pp]
                    rep = copy.deepcopy(st).to(dev)
                    rep.device = dev
                    self.replicas[r][s] = rep
        # the hop buffer's dtype: the promotion of every boundary's dtype
        # and the input's, integer inputs through float32
        bounds = self.in_dtypes[1:] + [self.out_dtype]
        buf = bounds[0]
        for dt in bounds[1:]:
            buf = torch.promote_types(buf, dt)
        d0 = self.in_dtypes[0]
        buf = torch.promote_types(
            buf, d0 if d0.is_floating_point else torch.float32)
        self.buf_dtype = buf
        self.p_paths = [_sorted_paths(st.jax_param_paths())
                        for st in self.stages]
        self.s_paths = [_sorted_paths(st.jax_state_paths())
                        for st in self.stages]
        self.p_len = max(max(sum(t.numel() for _, t in ps)
                             for ps in self.p_paths), 1)
        self.s_len = max(max((sum(t.numel() for _, t in ss)
                              for ss in self.s_paths), default=0), 1)
        self.has_aux = [has_moe(st) for st in self.stages]
        self._anchor = torch.zeros((), requires_grad=True)
        # a stage no position of this process runs is released
        for s, st in enumerate(self.stages):
            if self.mine(s) is None:
                st.to("meta")

    def _index(self, r: int, d: int):
        index = [0] * len(mesh_lib.AXES)
        index[mesh_lib.AXES.index(self.axis)] = d
        if self.data_axis is not None:
            index[mesh_lib.AXES.index(self.data_axis)] = r
        return tuple(index)

    def mine(self, s: int):
        """This process's first replica of stage ``s`` (None where it
        holds none)."""
        return next((rep[s] for rep in self.replicas
                     if rep[s] is not None), None)

    def _mine_list(self, s: int):
        return [rep[s] for rep in self.replicas if rep[s] is not None]

    @property
    def pipe_crosses(self) -> bool:
        return any(row.crosses for row in self.rows)

    @torch.no_grad()
    def _probe_dtypes(self, dtype: torch.dtype) -> List[torch.dtype]:
        """Each boundary's dtype, from one eval forward of a one-sample
        batch through the stages (the JAX plan's shape propagation)."""
        dtypes = []
        x = torch.zeros((1,) + self.in_shapes[0][1:], dtype=dtype,
                        device=self.stages[0].device)
        for stage in self.stages:
            dtypes.append(x.dtype)
            x = stage(x.to(stage.device), train=False)
        self.out_dtype = x.dtype
        return dtypes

    # -- packed rows --------------------------------------------------------

    def init_params(self, seed: int) -> None:
        """Seeded weights, stage s from seed + s, copied to every data
        rank's replica."""
        for s in range(self.L):
            if self.mine(s) is not None:
                self.mine(s).init_params(seed + s)
        self.broadcast()

    @torch.no_grad()
    def broadcast(self) -> None:
        """Each stage's first replica's parameters and state buffers to
        this process's other replicas of it."""
        for s in range(self.L):
            reps = self._mine_list(s)
            for dst in reps[1:]:
                for a, b in zip(reps[0].parameters(), dst.parameters()):
                    b.copy_(a)
                for a, b in zip(reps[0].buffers(), dst.buffers()):
                    b.copy_(a)

    def _paths(self, s: int, state: bool = False):
        st = self.mine(s)
        return _sorted_paths(st.jax_state_paths() if state
                             else st.jax_param_paths())

    def pack_params(self, trees: Optional[Sequence] = None) -> torch.Tensor:
        """(L, p_len) float32 rows in device order of the stages'
        parameters, or of per-stage trees keyed like them (moments)."""
        rows = []
        for s in self._stage_of_row:
            if trees is None:
                leaves = [t for _, t in self._paths(s)]
            else:
                leaves = [_get(trees[s], p) for p, _ in self.p_paths[s]]
            rows.append(_pack(leaves, self.p_len))
        return torch.stack(rows)

    def pack_state(self) -> torch.Tensor:
        return torch.stack([_pack([t for _, t in self._paths(s, True)],
                                  self.s_len) for s in self._stage_of_row])

    def unpack_params(self, rows, trees: Optional[Sequence] = None) -> None:
        """Load device-order rows into the stages' parameters (or into
        per-stage trees keyed like them), this process's stages."""
        for r, s in enumerate(self._stage_of_row):
            if self.mine(s) is None:
                continue
            if trees is None:
                leaves = [t for _, t in self._paths(s)]
            else:
                leaves = [_get(trees[s], p) for p, _ in self.p_paths[s]]
            _unpack(rows[r], leaves)

    def unpack_state(self, rows) -> None:
        for r, s in enumerate(self._stage_of_row):
            if self.mine(s) is not None:
                _unpack(rows[r], [t for _, t in self._paths(s, True)])

    def unpack_stage_variables(self, packed_params, packed_state
                               ) -> List[dict]:
        """Per-stage {"params", "state"} JAX trees (global stage order)
        from packed rows."""
        out = [None] * self.L
        pr, sr = _rows(packed_params), _rows(packed_state)
        for r, s in enumerate(self._stage_of_row):
            def nest(row, paths):
                tree, off = {}, 0
                for path, t in paths:
                    n = t.numel()
                    node = tree
                    for k in path[:-1]:
                        node = node.setdefault(k, {})
                    node[path[-1]] = row[off:off + n].reshape(t.shape)
                    off += n
                return tree
            out[s] = {"params": nest(pr[r], self.p_paths[s]),
                      "state": nest(sr[r], self.s_paths[s])}
        return out

    # -- the schedule -------------------------------------------------------

    def _prep(self, data, labels):
        mb_global = self.in_shapes[0][0] * self.dp
        if data.shape[0] != self.num_mb * mb_global:
            raise ValueError(f"batch {data.shape[0]} != num_microbatches "
                             f"{self.num_mb} x microbatch {mb_global}")
        data = data.reshape((self.num_mb, mb_global) + tuple(data.shape[1:]))
        labels = labels.reshape((self.num_mb, mb_global)
                                + tuple(labels.shape[1:]))
        return data, labels, mb_global

    def _run_stage(self, rank: int, s: int, x, train: bool, generator):
        stage = self.replicas[rank][s]
        if train and self.remat:
            out = remat_call(lambda a: stage(a, train=True,
                                             generator=generator),
                             self._remat_policy, generator, x)
        else:
            out = stage(x, train=train, generator=generator)
        aux = moe_aux_loss(stage) if train else None
        if train:
            stage.commit_state()
        return out, aux

    def _terms(self, train: bool) -> List[Tuple[int, int, str]]:
        """A data rank's loss terms in tick order: (stage, microbatch,
        "aux" or "loss"), every active stage's aux loss (train) and the
        last stage's loss."""
        out = []
        for d, c, m in _ticks(self.pp, self.v, self.num_mb):
            s = c * self.pp + d
            if train and self.has_aux[s]:
                out.append((s, m, "aux"))
            if s == self.L - 1:
                out.append((s, m, "loss"))
        return out

    def _generators(self, generator):
        """Across processes each (rank, stage, microbatch) draws from a
        generator of its own, seeded from a digest of ``generator`` (the
        same on every process), which is then reseeded from that digest
        alike; in one process ``generator`` itself."""
        if not self.spans or generator is None:
            return lambda r, s, m: generator
        import hashlib

        digest = hashlib.blake2b(generator.get_state().numpy().tobytes(),
                                 digest_size=8).digest()
        made = {}

        def gen(r, s, m):
            if (r, s, m) not in made:
                seed = hashlib.blake2b(digest + f"{r}/{s}/{m}".encode(),
                                       digest_size=8).digest()
                made[(r, s, m)] = make_generator(
                    int.from_bytes(seed, "little") >> 1,
                    self.devices[r][s % self.pp])
            return made[(r, s, m)]

        nxt = hashlib.blake2b(digest + b"next", digest_size=8).digest()
        generator.manual_seed(int.from_bytes(nxt, "little") >> 1)
        return gen

    def schedule(self, data, labels, train: bool, generator=None):
        """The tick loop over every data rank this process takes part in
        (``_Row``): returns (the loss tensor, the corrects tensor or None)
        on this process's first device. Each term of the loss is filled
        into a (rank, term) table by the process that computed it and the
        table all-reduced over the mesh's processes (every entry from one
        process), so every process holds the same loss and corrects, added
        in the one-process order. Under ``train`` the loss's ``backward()``
        runs the reverse schedule (``backward``)."""
        data, labels, mb_global = self._prep(data, labels)
        local = self.in_shapes[0][0]
        terms = self._terms(train)
        slot = {t: k for k, t in enumerate(terms)}
        vals = torch.zeros(self.dp, max(len(terms), 1), dtype=torch.float32,
                           device=self.home)
        corr = torch.zeros(self.dp, self.num_mb, dtype=torch.float32,
                           device=self.home)
        gen = self._generators(generator)
        self._graphs: Dict[Tuple[int, int, int], Any] = {}
        for r, row in enumerate(self.rows):
            if not row.active:
                continue
            dev = self.devices[r]

            def start(m, r=r, dev=dev):
                return data[m, r * local:(r + 1) * local].to(
                    self.buf_dtype).to(dev[0])

            def run(s, m, x, r=r):
                # through the buffer dtype to the stage's input dtype
                out, aux = self._run_stage(r, s, x.to(self.in_dtypes[s]),
                                           train, gen(r, s, m))
                rec = {"x": x, "out": out, "terms": []}
                if aux is not None:
                    vals[r, slot[(s, m, "aux")]] = aux.detach().float()
                    rec["terms"].append(aux.float())
                if s < self.L - 1:
                    rec["out"] = out.to(self.buf_dtype)
                else:
                    lb = labels[m, r * local:(r + 1) * local].to(out.device)
                    loss = self.loss_fn(out, lb).float()
                    vals[r, slot[(s, m, "loss")]] = loss.detach()
                    rec["terms"].append(loss)
                    rec["out"] = None
                    if self.compute_accuracy:
                        corr[r, m] = metrics_lib.class_corrects(
                            out.detach(), lb).float()
                if train:
                    self._graphs[(r, s, m)] = rec
                return rec["out"]

            row.forward(start, run, lambda s: self.in_shapes[s],
                        self.buf_dtype, train)
        if self.spans:
            everyone = self._everyone()
            if everyone.crosses:
                vals, corr = process_group.all_reduce_flat([vals, corr],
                                                           everyone.group)
        losses = []
        for r in range(self.dp):
            row_vals = list(vals[r, :len(terms)].unbind(0))
            losses.append(sum(row_vals[1:], row_vals[0]))
        loss = mesh_lib.data_mean(losses) / self.num_mb
        corrects = None
        if self.compute_accuracy:
            corrects = mesh_lib.all_reduce([
                sum(list(corr[r].unbind(0))[1:], corr[r, 0])
                for r in range(self.dp)])[0]
        if train and self.dp > 1:
            self._merge_state()
        if train:
            loss = _PipeBackward.apply(self, self._anchor, loss)
        return loss, corrects, mb_global

    def _everyone(self):
        return self.mesh.span(mesh_lib.AXES, self._index(*min(self.held)))

    def backward(self, g: torch.Tensor) -> None:
        """The reverse schedule of the last ``schedule(train=True)``: each
        (rank, stage, microbatch) pair backed out in reverse tick order on
        the process that ran it, with its output's gradient from the next
        stage and each loss term's from ``g`` (the loss's gradient:
        ``g / num_microbatches / data ranks``, the one-process graph's
        arithmetic)."""
        coef = g / self.num_mb / self.dp
        graphs, self._graphs = self._graphs, {}
        for r, row in enumerate(self.rows):
            if not row.active:
                continue

            def back(s, m, g_out, r=r):
                rec = graphs.pop((r, s, m))
                roots = [t for t in rec["terms"]]
                grads = [coef.to(t.device) for t in roots]
                if rec["out"] is not None:
                    roots.append(rec["out"])
                    grads.append(g_out)
                torch.autograd.backward(roots, grads)
                x = rec["x"]
                return x.grad if s > 0 else None

            row.backward(back, lambda s: self.in_shapes[s], self.buf_dtype)

    @torch.no_grad()
    def _merge_state(self) -> None:
        """The data ranks' running statistics averaged (``data_mean``, its
        sum over the data axis's processes too), every replica left with
        the mean."""
        for s in range(self.L):
            reps = [(r, rep[s]) for r, rep in enumerate(self.replicas)
                    if rep[s] is not None]
            if not reps:
                continue
            over = self.mesh.span(self.data_axis, self._index(
                reps[0][0], s % self.pp)) if self.spans else None
            bufs = [dict(rep.named_buffers()) for _, rep in reps]
            for name in bufs[0]:
                mean = mesh_lib.data_mean([b[name] for b in bufs], over)
                for b in bufs:
                    b[name].copy_(mean)

    @torch.no_grad()
    def reduce_grads(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Every stage's gradients summed over the data ranks
        (``mesh.position_sum``, then over the data axis's processes in
        one flattened buffer a dtype), this process's stages, keyed like
        ``param_tree``."""
        grads, by_span = {}, {}
        for s in range(self.L):
            reps = [(r, rep[s]) for r, rep in enumerate(self.replicas)
                    if rep[s] is not None]
            if not reps:
                continue
            named = [dict(rep.named_parameters()) for _, rep in reps]
            grads[str(s)] = {}
            over = self.mesh.span(self.data_axis, self._index(
                reps[0][0], s % self.pp)) if self.spans and \
                self.data_axis else None
            for n, p in named[0].items():
                parts = [nm[n].grad if nm[n].grad is not None
                         else torch.zeros_like(nm[n]) for nm in named]
                grads[str(s)][n] = mesh_lib.position_sum(parts)
                if over is not None and over.crosses:
                    by_span.setdefault(over.procs, (over, []))[1].append(
                        (str(s), n))
            for nm in named:
                for p in nm.values():
                    p.grad = None
        for over, keys in by_span.values():
            summed = process_group.all_reduce_flat(
                [grads[s][n] for s, n in keys], over.group)
            for (s, n), g in zip(keys, summed):
                grads[s][n] = g
        return grads

    @torch.no_grad()
    def grad_sq_norm(self, grads) -> torch.Tensor:
        """The squared global norm of every stage's gradient (the clip's,
        ``DataParallel.grad_sq_norm``'s rule): each leaf's sum of squares
        in the one-process tree's order, a stage this process does not
        hold filled in by the process of its data rank 0 position."""
        names = [(s, n) for s in range(self.L)
                 for n, _ in self.stages[s].named_parameters()]
        vals = torch.zeros(len(names), dtype=torch.float32,
                           device=self.home)
        procs = self.mesh.processes
        for k, (s, n) in enumerate(names):
            owner = int(procs[self._index(0, s % self.pp)])
            if owner == self.mesh.process_index:
                vals[k] = grads[str(s)][n].float().square().sum()
        everyone = self._everyone()
        if everyone.crosses and names:
            vals = process_group.all_reduce(vals, group=everyone.group)
        tree = {}
        for (s, n), v in zip(names, vals.unbind(0)):
            tree.setdefault(str(s), {})[n] = v
        return sum_leaves(tree)

    def param_tree(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """This process's first replica of each of its stages'
        parameters: {stage: {name: p}}."""
        return {str(s): dict(self.mine(s).named_parameters())
                for s in range(self.L) if self.mine(s) is not None}

    def clear_pending(self) -> None:
        for rank in self.replicas:
            for st in rank:
                if st is None:
                    continue
                for m in st.modules():
                    if getattr(m, "pending_state", None) is not None:
                        m.pending_state = None

    def _layer_spans(self):
        k = 0
        for s, st in enumerate(self.stages):
            yield s, k, k + len(st.layers)
            k += len(st.layers)

    @torch.no_grad()
    def write_back(self, model) -> None:
        """Copy the stages' parameters and state into the unsplit
        ``model`` the stages were cut from (layer by layer, in order);
        across processes this process's stages."""
        for s, lo, hi in self._layer_spans():
            src = self.mine(s)
            if src is not None:
                for a, b in zip(src.layers, model.layers[lo:hi]):
                    b.load_state_dict(a.state_dict())

    @torch.no_grad()
    def load_from(self, model) -> None:
        """The unsplit ``model``'s weights and state into the stages."""
        if sum(len(st.layers) for st in self.stages) != len(model.layers):
            raise ValueError("the stages do not cover the model's layers")
        for s, lo, hi in self._layer_spans():
            dst = self.mine(s)
            if dst is not None:
                for a, b in zip(model.layers[lo:hi], dst.layers):
                    b.load_state_dict(a.state_dict())
        self.broadcast()


class _PipeBackward(torch.autograd.Function):
    """The pipeline's loss; its backward runs the reverse schedule
    (``HeteroPipeline.backward``) on this process, so every process calls
    ``loss.backward()`` on its own copy of the loss."""

    @staticmethod
    def forward(ctx, pipe, anchor, loss):
        ctx.pipe = pipe
        return loss.clone()

    @staticmethod
    def backward(ctx, g):
        ctx.pipe.backward(g)
        return None, None, None


def _rows(x) -> torch.Tensor:
    """A packed section as a tensor (a file's section read as a tree is
    ``{"": rows}``)."""
    if isinstance(x, dict):
        (x,) = x.values()
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.array(x))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


class PipelineLayout:
    """A pipeline run's ``TrainState`` layout: its trees are the JAX
    package's packed rows (``params``, every moment of ``opt_state``,
    ``net_state``), which ``load`` unpacks into the stages. Where "pipe"
    crosses processes the rows are sharded over it across them, and a
    snapshot raises as JAX's ``device_get`` does (``check_fetch``); where
    only "data" crosses every process holds every row."""

    def __init__(self, pipe: HeteroPipeline):
        self.pipe = pipe

    def check_fetch(self, state: TrainState = None) -> None:
        if self.pipe.pipe_crosses:
            raise ValueError(
                f"the packed stage rows (params, opt_state, net_state: "
                f"{self.pipe.L} rows) are sharded over "
                f"{self.pipe.axis!r} across processes: a snapshot fetches "
                f"every leaf to this host, and JAX refuses to fetch an "
                f"array that spans devices of other processes and is not "
                f"fully replicated (jax.Array._value: 'Fetching value for "
                f"jax.Array that spans non-addressable (non process local) "
                f"devices is not possible')")

    def _moment_trees(self, moments):
        """Per-stage {path: moment} trees of one opt_state entry."""
        pipe = self.pipe
        out = []
        for s, st in enumerate(pipe.stages):
            names = {id(p): n for n, p in st.named_parameters()}
            tree = {}
            if str(s) in moments:
                for path, t in pipe.p_paths[s]:
                    node = tree
                    for k in path[:-1]:
                        node = node.setdefault(k, {})
                    node[path[-1]] = moments[str(s)][names[id(t)]]
            out.append(tree)
        return out

    def trees(self, state: TrainState) -> Dict[str, Any]:
        self.check_fetch(state)
        pipe = self.pipe
        opt = {}
        for key, val in state.opt_state.items():
            opt[key] = pipe.pack_params(self._moment_trees(val)) \
                if isinstance(val, dict) else \
                val.detach().to("cpu", copy=True)
        return {"params": pipe.pack_params(), "opt_state": opt,
                "net_state": pipe.pack_state(),
                "step": torch.tensor(int(state.step), dtype=torch.int32)}

    def load(self, state: TrainState, params=None, opt_state=None,
             net_state=None) -> None:
        pipe = self.pipe
        if params is not None:
            pipe.unpack_params(_rows(params))
        if net_state is not None:
            pipe.unpack_state(_rows(net_state))
        if opt_state is not None:
            with torch.no_grad():
                for key, val in state.opt_state.items():
                    src = _rows(opt_state[key])
                    if isinstance(val, dict):
                        pipe.unpack_params(src, self._moment_trees(val))
                    else:
                        val.copy_(src)
        pipe.broadcast()


def make_pipeline_train_step(stages: Sequence, optimizer, mesh: Mesh,
                             input_shape, *, loss_fn=None,
                             num_microbatches: int = 4, axis: str = "pipe",
                             input_dtype=torch.bfloat16, scheduler=None,
                             compute_accuracy: bool = True,
                             data_axis: Optional[str] = None,
                             augment: Optional[Callable] = None,
                             remat: "bool | str" = False,
                             virtual: int = 1):
    """The pipeline train step over ``stages`` (a ``partitioner`` split);
    ``input_shape`` is the global microbatch's shape (mb, ...).

    Returns ``(pipe, step_fn, init_fn)``: ``init_fn(seed)`` draws the
    stages' weights (``HeteroPipeline.init_params``) and returns a
    ``TrainState`` with the pipeline's layout (``init_fn(None)`` keeps
    the weights the stages hold); ``step_fn(state, data, labels)`` runs
    num_microbatches x mb samples through the schedule and one optimizer
    update. Across processes every process calls both with the same
    global batch (checked, as JAX's ``device_put`` checks it)."""
    pipe = HeteroPipeline(stages, mesh, input_shape, input_dtype=input_dtype,
                          num_microbatches=num_microbatches, axis=axis,
                          loss_fn=loss_fn, compute_accuracy=compute_accuracy,
                          data_axis=data_axis, remat=remat, virtual=virtual)
    scheduler = scheduler or NoOp()

    def init_fn(seed: Optional[int] = 0) -> TrainState:
        if seed is not None:
            pipe.init_params(seed)
        tree = pipe.param_tree()
        flat = {f"{s}.{n}": p for s, ps in tree.items()
                for n, p in ps.items()}
        return TrainState(params=flat, opt_state=optimizer.init(tree),
                          step=0, generator=make_generator(
                              seed or 0, pipe.home),
                          layout=PipelineLayout(pipe))

    def step_fn(state: TrainState, data, labels):
        if pipe.spans:
            process_group.assert_equal((data, labels), "the global batch")
        data, labels = data.to(pipe.home), labels.to(pipe.home)
        if augment is not None:
            data = augment(state.generator, data)
        loss, corr, mb_global = pipe.schedule(data, labels, True,
                                              state.generator)
        loss.backward()
        pipe.clear_pending()
        grads = pipe.reduce_grads()
        lr_scale = apply_update(optimizer, scheduler, state, grads,
                                pipe.param_tree(), sq_norm=pipe.grad_sq_norm
                                if pipe.spans else None)
        pipe.broadcast()
        return state, step_metrics(
            loss.detach(), lr_scale,
            None if corr is None else corr / (pipe.num_mb * mb_global))

    return pipe, step_fn, init_fn


def make_pipeline_eval_step(pipe: HeteroPipeline):
    """(state, data, labels) -> {"loss", "corrects"} through the same
    schedule without training (BatchNorm on its running statistics)."""

    @torch.no_grad()
    def eval_fn(state, data, labels):
        if pipe.spans:
            process_group.assert_equal((data, labels), "the global batch")
        loss, corr, _ = pipe.schedule(data.to(pipe.home),
                                      labels.to(pipe.home), False)
        metrics = {"loss": loss}
        if corr is not None:
            metrics["corrects"] = corr
        return metrics

    return eval_fn


# ---------------------------------------------------------------------------
# 3. one stage a device
# ---------------------------------------------------------------------------


class StagePipeline:
    """Heterogeneous stage modules, one device each, microbatches flowing
    through them in order (``train_batch``): each stage's BatchNorm state
    threads through the microbatches as single-device gradient
    accumulation threads it, the gradients accumulate, and each stage
    takes one optimizer step of its own."""

    def __init__(self, stages: Sequence, optimizer, loss_fn,
                 devices=None):
        self.stages = list(stages)
        self.optimizer = optimizer
        if isinstance(loss_fn, (str, dict)):
            loss_fn = losses_lib.get(loss_fn)
        self.loss_fn = loss_fn
        if devices is None:
            devices = mesh_lib.default_devices(len(self.stages))
        devices = [torch.device(d) for d in devices]
        if len(devices) < len(self.stages):
            raise ValueError(f"{len(self.stages)} stages need as many "
                             f"devices, have {len(devices)}")
        self.devices = devices[:len(self.stages)]
        self.opt_states: List[Any] = []
        self.input_dtype = None

    def init(self, input_shape, input_dtype=None, *,
             seed: Optional[int] = 0):
        """Build every stage on its device for inputs of ``input_shape``
        (batch first; ``input_dtype`` is the data's, integer for token
        ids) and draw stage i's weights from seed + i (None keeps
        them)."""
        shape = tuple(input_shape)
        self.input_dtype = input_dtype
        self.opt_states = []
        for i, (stage, dev) in enumerate(zip(self.stages, self.devices)):
            if getattr(stage, "device", None) is None:
                stage.build(shape, dev)
            else:
                stage.to(dev)
                stage.device = dev
            if seed is not None:
                stage.init_params(seed + i)
            self.opt_states.append(self.optimizer.init(
                dict(stage.named_parameters())))
            shape = tuple(stage.output_shape(shape))
        return self

    @torch.no_grad()
    def forward(self, x):
        for stage, dev in zip(self.stages, self.devices):
            x = stage(mesh_lib.hop(x, dev))
        return x

    def train_batch(self, data, labels, num_microbatches: int = 4,
                    generator=None):
        """One step: every microbatch forward through the stages, its
        loss's backward (scaled by 1 / num_microbatches), one optimizer
        update a stage. Returns the mean microbatch loss (a device
        scalar)."""
        scale = 1.0 / num_microbatches
        losses = []
        for mb, lb in zip(data.chunk(num_microbatches),
                          labels.chunk(num_microbatches)):
            x = mb
            for stage, dev in zip(self.stages, self.devices):
                x = stage(mesh_lib.hop(x, dev), train=True,
                          generator=generator)
                stage.commit_state()
            loss = self.loss_fn(x, lb.to(x.device))
            (loss * scale).backward()
            losses.append(loss.detach())
        for stage, opt_state in zip(self.stages, self.opt_states):
            params = dict(stage.named_parameters())
            grads = {n: p.grad if p.grad is not None else
                     torch.zeros_like(p) for n, p in params.items()}
            with torch.no_grad():
                self.optimizer.update(grads, opt_state, params)
            for p in params.values():
                p.grad = None
        return sum(losses[1:], losses[0]) * scale
