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
from ..nn.optimizers import tree_leaves, tree_map
from ..nn.schedulers import NoOp
from ..train.step import (TrainState, apply_update, moe_aux_loss,
                          remat_call, resolve_remat_policy, step_metrics)
from . import mesh as mesh_lib
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
        y = block_fn(params[s], x)
        if y.shape != x.shape:
            raise ValueError(f"pipeline stages must preserve activation "
                             f"shape, got {tuple(x.shape)} -> "
                             f"{tuple(y.shape)}")
        if s == n_stages - 1:
            results[m] = y
        else:
            outs[(s, m)] = y
    return torch.stack([r.to(devices[-1]) for r in results])


def _ticks(pp: int, v: int, num_mb: int):
    """(pipe position d, chunk c, microbatch m) of every active pair, tick
    by tick: GPipe's m = t - d at v = 1, else the interleaved sub-tick
    tau(c * pp + d, m) = d + m % pp + pp * (c + v * (m // pp))."""
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
                yield d, c, m


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

        # shapes through the boundaries, each stage built on its device
        self.in_shapes: List[Tuple[int, ...]] = []
        shape = tuple(input_shape)
        for s, stage in enumerate(self.stages):
            self.in_shapes.append(shape)
            dev = self.devices[0][s % self.pp]
            if getattr(stage, "device", None) is None:
                stage.build(shape, dev)
            else:
                stage.to(dev)
                stage.device = dev
            shape = tuple(stage.output_shape(shape))
        self.out_shape = shape
        self.replicas = [self.stages] + [
            [copy.deepcopy(st).to(self.devices[r][s % self.pp])
             for s, st in enumerate(self.stages)]
            for r in range(1, self.dp)]
        self.in_dtypes = self._probe_dtypes(input_dtype)
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

    def _index(self, r: int, d: int):
        index = [0] * len(mesh_lib.AXES)
        index[mesh_lib.AXES.index(self.axis)] = d
        if self.data_axis is not None:
            index[mesh_lib.AXES.index(self.data_axis)] = r
        return tuple(index)

    @torch.no_grad()
    def _probe_dtypes(self, dtype: torch.dtype) -> List[torch.dtype]:
        """Each boundary's dtype, from one eval forward of a one-sample
        batch through the stages (the JAX plan's shape propagation)."""
        dtypes = []
        x = torch.zeros((1,) + self.in_shapes[0][1:], dtype=dtype,
                        device=self.devices[0][0])
        for s, stage in enumerate(self.stages):
            dtypes.append(x.dtype)
            x = stage(x.to(self.devices[0][s % self.pp]), train=False)
        self.out_dtype = x.dtype
        return dtypes

    # -- packed rows --------------------------------------------------------

    def init_params(self, seed: int) -> None:
        """Seeded weights, stage s from seed + s, copied to every data
        rank's replica."""
        for s, stage in enumerate(self.stages):
            stage.init_params(seed + s)
        self.broadcast()

    @torch.no_grad()
    def broadcast(self) -> None:
        """Data rank 0's parameters and state buffers to the other
        ranks' replicas."""
        for rank in self.replicas[1:]:
            for src, dst in zip(self.stages, rank):
                for a, b in zip(src.parameters(), dst.parameters()):
                    b.copy_(a)
                for a, b in zip(src.buffers(), dst.buffers()):
                    b.copy_(a)

    def pack_params(self, trees: Optional[Sequence] = None) -> torch.Tensor:
        """(L, p_len) float32 rows in device order of the stages'
        parameters, or of per-stage trees keyed like them (moments)."""
        rows = []
        for s in self._stage_of_row:
            if trees is None:
                leaves = [t for _, t in self.p_paths[s]]
            else:
                leaves = [_get(trees[s], p) for p, _ in self.p_paths[s]]
            rows.append(_pack(leaves, self.p_len))
        return torch.stack(rows)

    def pack_state(self) -> torch.Tensor:
        return torch.stack([_pack([t for _, t in self.s_paths[s]],
                                  self.s_len) for s in self._stage_of_row])

    def unpack_params(self, rows, trees: Optional[Sequence] = None) -> None:
        """Load device-order rows into the stages' parameters (or into
        per-stage trees keyed like them)."""
        for r, s in enumerate(self._stage_of_row):
            if trees is None:
                leaves = [t for _, t in self.p_paths[s]]
            else:
                leaves = [_get(trees[s], p) for p, _ in self.p_paths[s]]
            _unpack(rows[r], leaves)

    def unpack_state(self, rows) -> None:
        for r, s in enumerate(self._stage_of_row):
            _unpack(rows[r], [t for _, t in self.s_paths[s]])

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

    def schedule(self, data, labels, train: bool, generator=None):
        """The tick loop over every data rank: returns (the loss tensor,
        the corrects tensor or None) on the last stage's first device."""
        data, labels, mb_global = self._prep(data, labels)
        local = self.in_shapes[0][0]
        last = self.devices[0][(self.L - 1) % self.pp]
        losses, corrects = [], []
        for r in range(self.dp):
            outs: Dict[Tuple[int, int], torch.Tensor] = {}
            rank_loss, rank_corr = [], []
            dev = self.devices[r]
            for d, c, m in _ticks(self.pp, self.v, self.num_mb):
                s = c * self.pp + d
                if s == 0:
                    x = data[m, r * local:(r + 1) * local]
                else:
                    x = outs.pop((s - 1, m))
                # the hop: through the buffer dtype to the stage's input
                # dtype, onto the stage's device
                x = mesh_lib.hop(x.to(self.buf_dtype), dev[d]) \
                    .to(self.in_dtypes[s])
                out, aux = self._run_stage(r, s, x, train, generator)
                if aux is not None:
                    rank_loss.append(aux.float().to(last))
                if s < self.L - 1:
                    outs[(s, m)] = out
                    continue
                lb = labels[m, r * local:(r + 1) * local].to(out.device)
                rank_loss.append(self.loss_fn(out, lb).float().to(last))
                if self.compute_accuracy:
                    rank_corr.append(metrics_lib.class_corrects(
                        out.detach(), lb).float().to(last))
            losses.append(sum(rank_loss[1:], rank_loss[0]))
            if rank_corr:
                corrects.append(sum(rank_corr[1:], rank_corr[0]))
        loss = mesh_lib.data_mean(losses) / self.num_mb
        corr = mesh_lib.all_reduce(corrects)[0] if corrects else None
        if train and self.dp > 1:
            self._merge_state()
        return loss, corr, mb_global

    @torch.no_grad()
    def _merge_state(self) -> None:
        """The data ranks' running statistics averaged (``data_mean``),
        every rank left with the mean."""
        for s in range(self.L):
            bufs = [dict(rank[s].named_buffers()) for rank in self.replicas]
            for name in bufs[0]:
                mean = mesh_lib.data_mean([b[name] for b in bufs])
                for b in bufs:
                    b[name].copy_(mean)

    @torch.no_grad()
    def reduce_grads(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Every stage's gradients summed over the data ranks
        (``mesh.all_reduce``), keyed like ``param_tree``."""
        grads = {}
        for s in range(self.L):
            named = [dict(rank[s].named_parameters())
                     for rank in self.replicas]
            grads[str(s)] = {}
            for n, p in named[0].items():
                parts = [nm[n].grad if nm[n].grad is not None
                         else torch.zeros_like(nm[n]) for nm in named]
                grads[str(s)][n] = mesh_lib.all_reduce(parts)[0]
            for nm in named:
                for p in nm.values():
                    p.grad = None
        return grads

    def param_tree(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Data rank 0's parameters of every stage: {stage: {name: p}}."""
        return {str(s): dict(st.named_parameters())
                for s, st in enumerate(self.stages)}

    def clear_pending(self) -> None:
        for rank in self.replicas:
            for st in rank:
                for m in st.modules():
                    if getattr(m, "pending_state", None) is not None:
                        m.pending_state = None

    @torch.no_grad()
    def write_back(self, model) -> None:
        """Copy the stages' parameters and state into the unsplit
        ``model`` the stages were cut from (layer by layer, in order)."""
        layers = [c for st in self.stages for c in st.layers]
        for src, dst in zip(layers, model.layers):
            dst.load_state_dict(src.state_dict())

    @torch.no_grad()
    def load_from(self, model) -> None:
        """The unsplit ``model``'s weights and state into the stages."""
        layers = [c for st in self.stages for c in st.layers]
        if len(layers) != len(model.layers):
            raise ValueError("the stages do not cover the model's layers")
        for src, dst in zip(model.layers, layers):
            dst.load_state_dict(src.state_dict())
        self.broadcast()


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
    ``net_state``), which ``load`` unpacks into the stages."""

    def __init__(self, pipe: HeteroPipeline):
        self.pipe = pipe

    def _moment_trees(self, moments):
        """Per-stage {path: moment} trees of one opt_state entry."""
        pipe = self.pipe
        out = []
        for s, st in enumerate(pipe.stages):
            names = {id(p): n for n, p in st.named_parameters()}
            tree = {}
            for path, t in pipe.p_paths[s]:
                node = tree
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = moments[str(s)][names[id(t)]]
            out.append(tree)
        return out

    def trees(self, state: TrainState) -> Dict[str, Any]:
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
    update."""
    from ..core.rng import make_generator

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
                              seed or 0, pipe.devices[0][0]),
                          layout=PipelineLayout(pipe))

    def step_fn(state: TrainState, data, labels):
        dev0 = pipe.devices[0][0]
        data, labels = data.to(dev0), labels.to(dev0)
        if augment is not None:
            data = augment(state.generator, data)
        loss, corr, mb_global = pipe.schedule(data, labels, True,
                                              state.generator)
        loss.backward()
        pipe.clear_pending()
        grads = pipe.reduce_grads()
        lr_scale = apply_update(optimizer, scheduler, state, grads,
                                pipe.param_tree())
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
        dev0 = pipe.devices[0][0]
        loss, corr, _ = pipe.schedule(data.to(dev0), labels.to(dev0), False)
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
