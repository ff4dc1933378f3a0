"""Data, tensor, sequence and expert parallelism with FSDP parameter
sharding (``tnn_tpu.parallel.data_parallel``).

In the JAX package every layout is a sharding annotation on the
single-device step, so a layout's loss, gradients and parameters are the
single-device step's up to the order of its sums. ``make_dp_train_step``
holds the port to that in one process and one autograd graph, over the
mesh's positions (data, fsdp, model, seq, expert; a position is a
device, and a device may repeat):

* **The layout.** Each parameter's spec merges the enabled rule sets in
  the JAX order, first non-replicated wins: ``tp`` (``tensor_parallel.
  DEFAULT_TP_RULES``, "model"), ``ep`` (``nn.moe.ep_rules``, "expert"),
  ``fsdp`` (``fsdp_spec_tree``). Between steps every position holds its
  own copy of each replicated leaf and only its piece of each sharded
  one (``tensor_split`` along the spec's dim; the fused qkv columns are
  taken per head first, ``tensor_parallel._permute_qkv``, so a "model"
  position holds whole heads); the model's own tensors of sharded leaves
  are emptied until ``write_back``. The optimizer state lives with the
  first holder of each piece ("owned"), so moments follow their
  parameter's sharding.
* **Streams.** The batch is cut over the data x fsdp positions (data
  major) and, for (B, S) token inputs, S over the seq positions: one
  stream a (data, fsdp, seq) position, whose activations live on its
  lead position (model and expert index 0 in one process). Math that every "model" or
  "expert" position would repeat (embeddings, norms, residuals, a model
  with no TP leaf) runs once a stream, on the lead, as ``serving/tp.py``
  runs it.
* **The lockstep forward** (``_Run``) walks containers child by child.
  ``GPT2``, ``Llama`` and their blocks run their own forward with the
  lockstep as its run (``nn.run``: ``layer``, ``add``, ``mlp``), so a
  model has one forward; ``_Run`` supplies only the layers whose
  products are sharded or whose inputs cross streams (attention, through
  the layer's own projections; the MLP's column and row products; MoE;
  the embeddings; BatchNorm) and the head. Any other module runs stream
  by stream with its parameters as its lead position holds them. Its
  collective points,
  each a ``mesh`` function: a training BatchNorm normalizes by the global
  batch's statistics; under "model" each position runs the column pieces
  of qkv / fc / gate / up over its H/tp heads (K4 / K7 for a "pallas"
  model on CUDA) and one ``all_reduce`` follows each row-parallel product
  (out / proj / down), its bias added once; the token table is split over
  the vocabulary, its lookup masked and all-reduced, and the tied head's
  logits stay vocab-sharded into a cross entropy whose max and
  sum-of-exp are reduced over the "model" positions (on the chunked head
  loss too, ``lm_head_chunk``); under "seq" ``wpe`` and RoPE take the
  stream's global offset and attention runs the active ``ring_context``'s
  method ("ring" without one) over the seq positions of the same rows; at
  a ``MoE`` every stream's tokens are concatenated in global (row,
  position) order and routed once, so top-k, capacity and the aux loss
  count the global batch, the experts of each "expert" position computed
  there on its slice.
* **FSDP's parameter sharding.** A leaf sharded over "fsdp" is whole
  only while its layer runs: gathered at use, under a checkpoint that
  gathers it again for the backward, so autograd keeps no gathered copy
  between the two. Each position's gradient of the whole leaf is kept
  (per microbatch, then summed as ``.grad`` accumulates) and
  reduce-scattered in position order, the arithmetic of the replicated
  layout: losses and parameters equal plain data parallelism over the
  same positions bit for bit (the optimizer-state-only FSDP before it).
* **The update.** The loss is the global mean over the streams plus the
  MoE layers' aux loss (once); one backward; each piece's gradient is the
  sum over its holders in position order; one optimizer update over the
  owned tree; the new values copied to every other holder.

Dropout: every stream on the device of the state's generator draws from
that generator, the streams in lockstep order; a stream on another device
draws from a generator of that device seeded, each microbatch, from a
digest of the state's generator. ``remat`` replays all of them. Under
"model" and "seq" the masks are not the single-device step's.

``TrainState.layout`` gathers every sharded leaf back to JAX's full
layout (``trees``) and places a full-layout state (``load``), so a
checkpoint of any layout loads into JAX's templates and back.

**Across processes** (a mesh over an initialized ``process_group``, JAX's
mesh after ``jax.distributed.initialize``): every axis may span
processes, alone or together, MoE models included; each process must
hold one block of the mesh, of the same shape on every process. Each
process holds only its own positions and pieces and runs the same
optimizer update on its own copy of what it holds. The step checks the
global batch (and ``place_state`` the initial parameters) equal on every
process with ``process_group.assert_equal``, as JAX's ``device_put``
does, and keeps the rows of its streams. A stream runs on every process
that holds a "model" or "expert" position of it, its replicated math on
that process's first such position (its lead here), so two processes
compute one stream's loss. The optimizer's clip scales by the global
norm of the whole gradient tree (``grad_sq_norm``), as JAX's does. Every
sum then runs over a ``mesh.Span``:

* over a stream's "model" slice, tensor parallelism's conjugate pair
  (``process_group.sum_backward`` where an activation enters the column
  products, ``sum_forward`` after the row products, the masked lookup,
  the sum of exponentials and the label's logit; the row max
  ``all_reduce``'d with "max");
* over its "seq" slice, the ring's K/V hops (``mesh.ring_hop``) and
  Ulysses' re-sharding (``mesh.all_to_all``);
* over a leaf's "fsdp" slice, the gathers at use and in the remat
  backward (``join_at``) and the reduce-scatter of the whole-leaf
  gradients, whose pieces are then summed over the data and seq
  processes;
* over the stream span (the processes of the data, fsdp and seq
  positions through this process's lead: each stream counted once), the
  loss, accuracy and eval corrects, BatchNorm's statistics and the
  gradients of replicated leaves and "model" pieces, in one flattened
  buffer a dtype (``process_group.all_reduce_flat``);
* over the expert span, where "expert" crosses and each process runs
  its streams' replicated math whole, one copy of the replicated
  leaves' gradients, the router's too (the span's first process's:
  ``_one_copy``), so
  kernels that add in a varying order cannot set the ranks apart;
* at a ``MoE``, over the stream span too: every process gathers every
  stream's tokens (``gather_keep``) and computes the whole layer alike,
  the router included, then takes its own streams' output back
  (``take_own``, whose backward gathers every stream's output gradient),
  so the layer's gradients are whole on every process and are not summed
  again (``complete``), and each process's loss adds the aux loss whole
  while the loss metric adds it once, after the sum over the span; where
  "expert" crosses, each process computes its own experts' slice, f
  (``sum_backward``) over the expert span where the routed tokens enter
  them and the outputs ``gather_keep``'d over it.

With one position a process every sum adds the same two values as the
in-process mesh, so the results equal it bit for bit; with more they
add (p0 + p1) + (p2 + p3) where the in-process mesh adds ((p0 + p1) +
p2) + p3. Each stream draws dropout from a generator seeded from a
digest of the state's generator and the stream, so two processes that
run one stream draw the same masks, and the state's generator is then
reseeded from its digest alike on every process. ``TrainState.layout``'s
``trees`` gather the pieces of every process, a collective every process
calls at the same point (JAX's ``process_allgather``); a snapshot of a
leaf sharded across processes raises, as JAX's ``device_get`` does
(``check_fetch``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import itertools
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.nn.utils.stateless import _reparametrize_module

from ..core.rng import make_generator
from ..nn import losses as losses_lib
from ..nn import metrics as metrics_lib
from ..nn.attention import (MultiHeadAttention, active_ring_context,
                            apply_rope, sdpa)
from ..nn.blocks import Parallel, Residual, Sequential
from ..nn.embedding import Embedding, PositionalEmbedding
from ..nn.layers import Dropout
from ..nn.lm_loss import lm_head_loss, lm_head_lse
from ..nn.moe import MoE, ep_rules
from ..nn.norms import BatchNorm
from ..nn.optimizers import sum_leaves
from ..nn.schedulers import NoOp
from ..nn.transformer import GPTBlock
from ..ops.quant_matmul import qmatmul
from ..train.step import TrainState, apply_update, has_moe, microbatches, \
    moe_aux_loss, remat_call, resolve_remat_policy, step_metrics, \
    train_state_trees
from . import mesh as mesh_lib
from . import process_group
from .mesh import Mesh
from .ring_attention import ring_attention_local
from .tensor_parallel import _permute_qkv, _unpermute_qkv, spec_for
from .ulysses import check_ulysses, ulysses_attention_local

#: the layout's axes, in mesh order (a pipe axis runs ``parallel.pipeline``)
AXES = ("data", "fsdp", "model", "seq", "expert")
_AX = {a: i for i, a in enumerate(AXES)}


def fsdp_spec_tree(params, mesh: Mesh, min_size: int = 2 ** 16):
    """A spec a leaf of ``params`` (nested dicts of anything with a
    ``shape``): ``("fsdp" at its first dim divisible by the fsdp size)``
    for a leaf of at least ``min_size`` elements, ``()`` else."""
    if isinstance(params, dict):
        return {k: fsdp_spec_tree(v, mesh, min_size)
                for k, v in params.items()}
    return _fsdp_spec(tuple(params.shape), mesh_lib.axis_size(mesh, "fsdp"),
                      min_size)


def _fsdp_spec(shape, fsdp: int, min_size: int) -> Tuple:
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


def _spec_axis(spec) -> Tuple[Optional[str], Optional[int]]:
    """(axis, dim) of a leaf's spec; (None, None) when replicated."""
    for dim, a in enumerate(spec):
        if a is not None:
            return a, dim
    return None, None


def _coords(mesh: Mesh) -> List[Tuple[int, ...]]:
    """The (data, fsdp, model, seq, expert) coordinates of every position,
    in mesh order."""
    if mesh_lib.axis_size(mesh, "pipe") > 1:
        raise ValueError("a pipe axis runs through parallel.pipeline "
                         "(make_pipeline_train_step), not make_dp_train_step")
    return list(itertools.product(*(range(mesh_lib.axis_size(mesh, a))
                                    for a in AXES)))


def _index(c) -> Tuple[int, ...]:
    d, f, m, s, e = c
    return (d, f, m, 0, s, e)


def _device(mesh: Mesh, c) -> torch.device:
    return mesh.devices[_index(c)]


def check_spans(mesh: Mesh) -> None:
    """Refuse processes whose positions are not blocks of one shape (the
    module docstring)."""
    if not mesh.spans_processes:
        return
    crossing = mesh.crossing_axes()
    if set(crossing) - {"data"}:
        shapes = set()
        for p in sorted(set(int(q) for q in mesh.processes.flat)):
            at = np.argwhere(mesh.processes == p)
            lo, hi = at.min(0), at.max(0) + 1
            if int(np.prod(hi - lo)) != len(at):
                shapes = None
                break
            shapes.add(tuple(int(v) for v in hi - lo))
        if not shapes or len(shapes) > 1:
            raise ValueError(
                f"mesh axes {list(crossing)} cross a process boundary but "
                f"the processes' positions are not blocks of one shape "
                f"({mesh!r}): give every process as many positions, a "
                f"divisor of the mesh's trailing axes")


def place_by_specs(params, mesh: Mesh, specs):
    """Each leaf placed per its spec: one tensor a mesh position (mesh
    order), the whole leaf where it is replicated, the position's piece
    (``tensor_split`` along the spec's dim) where it is sharded."""
    if isinstance(params, dict):
        return {k: place_by_specs(v, mesh, specs[k]) for k, v in
                params.items()}
    coords = _coords(mesh)
    x = torch.as_tensor(params)
    axis, dim = _spec_axis(specs)
    if axis is None:
        return [x.to(_device(mesh, c)) for c in coords]
    pieces = x.tensor_split(mesh_lib.axis_size(mesh, axis), dim=dim)
    return [pieces[c[_AX[axis]]].to(_device(mesh, c)) for c in coords]


def shard_params_fsdp(params, mesh: Mesh, min_size: int = 2 ** 16):
    """``place_by_specs`` at ``fsdp_spec_tree``'s specs."""
    return place_by_specs(params, mesh, fsdp_spec_tree(params, mesh,
                                                       min_size))


class _Gather(torch.autograd.Function):
    """A sharded leaf made whole at one position; its gradient (the whole
    leaf's, at that position) is handed to the layout, which reduces it
    in position order (``DataParallel.reduce_grads``)."""

    @staticmethod
    def forward(ctx, anchor, layout, name, c):
        ctx.key = (layout, name, c)
        return layout.join_at(name, c)

    @staticmethod
    def backward(ctx, g):
        layout, name, c = ctx.key
        layout.stash_grad(name, c, g)
        return None, None, None, None


# -- the layout -------------------------------------------------------------


class DataParallel:
    """What every position holds of a parallel run (the module
    docstring): ``held[c][name]``, the owned pieces and their optimizer
    state. A ``TrainState``'s ``layout``: it gives the JAX-layout trees
    (``trees``: pieces gathered) and loads them (``load``: placed
    again)."""

    def __init__(self, model, mesh: Mesh, fsdp: bool = False,
                 tp: bool = False, ep: bool = False,
                 min_size: int = 2 ** 16):
        self.mesh = mesh
        check_spans(mesh)
        self.spans = mesh.spans_processes
        self.coords = [c for c in _coords(mesh) if mesh.is_local(_index(c))]
        self.size = {a: mesh_lib.axis_size(mesh, a) for a in AXES}
        # the "model" positions this process holds of each of its streams,
        # and the spans its sums run over (None: this process alone)
        self.model_run = sorted({c[_AX["model"]] for c in self.coords})
        self.expert_run = sorted({c[_AX["expert"]] for c in self.coords})
        lead = _index(self.coords[0])
        self.stream_span = mesh.span(("data", "fsdp", "seq"), lead)
        self.expert_span = mesh.span("expert", lead)
        self.fsdp_span = mesh.span("fsdp", lead)
        self.rest_span = mesh.span(("data", "seq"), lead)
        self.dev = {c: _device(mesh, c) for c in self.coords}
        self.devices = [self.dev[c] for c in self.coords]
        params = dict(model.named_parameters())
        if any(p.numel() == 0 for p in params.values()):
            raise ValueError("the model's sharded parameters are held by "
                             "another layout: call its write_back() first")
        first = self.devices[0]
        dev = next(iter(params.values())).device
        if dev != first:
            raise ValueError(f"the model lives on {dev}; the mesh's first "
                             f"position is {first}")
        self.model = model
        keys = {}
        by_id = {id(p): n for n, p in params.items()}
        for path, t in getattr(model, "jax_param_paths", list)():
            if id(t) in by_id:
                keys[by_id[id(t)]] = "/".join(path)
        self.axis: Dict[str, Optional[str]] = {}
        self.dim: Dict[str, Optional[int]] = {}
        for n, p in params.items():
            specs = []
            if tp:
                specs.append(spec_for(keys.get(n, n)))
            if ep:
                specs.append(spec_for(keys.get(n, n), ep_rules()))
            if fsdp:
                specs.append(_fsdp_spec(tuple(p.shape), self.size["fsdp"],
                                        min_size))
            spec = next((s for s in specs if s), ())
            axis, dim = _spec_axis(spec)
            if axis is not None and self.size[axis] == 1:
                axis = dim = None
            self.axis[n], self.dim[n] = axis, dim
        self._qkv = {}
        self._names: Dict[int, List[Tuple[str, str]]] = {}
        # leaves whose gradient every process of the stream span computes
        # whole (MoE's, ``_Run.moe``): not summed across processes
        self.complete = set()
        for prefix, m in model.named_modules():
            if isinstance(m, MoE):
                self.complete.update(f"{prefix}.{rel}" if prefix else rel
                                     for rel, _ in m.named_parameters())
            self._names[id(m)] = [
                (rel, f"{prefix}.{rel}" if prefix else rel)
                for rel, _ in m.named_parameters()]
            if isinstance(m, MultiHeadAttention):
                for rel in ("qkv_kernel", "qkv_bias"):
                    n = f"{prefix}.{rel}" if prefix else rel
                    if self.axis.get(n) == "model":
                        self._check_heads(m)
                        self._qkv[n] = (m.num_heads, m.num_kv_heads,
                                        m.head_dim, self.size["model"])
        self.held: Dict[Tuple, Dict[str, torch.Tensor]] = {
            c: {} for c in self.coords}
        self.starts: Dict[str, List[int]] = {}
        self.shapes = {n: tuple(p.shape) for n, p in params.items()}
        self.anchor = torch.zeros((), requires_grad=True)
        with torch.no_grad():
            for n, p in params.items():
                pieces = self._split(n, p.detach())
                self.starts[n] = [0]
                for piece in pieces[:-1]:
                    d = self.dim[n] or 0
                    self.starts[n].append(self.starts[n][-1]
                                          + piece.shape[d])
                for c in self.coords:
                    if c == self.coords[0] and self.axis[n] is None:
                        self.held[c][n] = p
                        continue
                    t = pieces[self.piece_of(n, c)].to(
                        self.dev[c], copy=True).contiguous()
                    self.held[c][n] = t.requires_grad_(p.requires_grad)
                if self.axis[n] is not None:
                    p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        self.owners = {n: self._owners(n) for n in params}
        self.owned = {n: self._owned(n) for n in params}
        self._mb_grads: Dict[Tuple[str, Tuple], torch.Tensor] = {}
        self._grads: Dict[Tuple[str, Tuple], torch.Tensor] = {}

    def _check_heads(self, attn) -> None:
        tp = self.size["model"]
        if attn.num_heads % tp or attn.num_kv_heads % tp:
            raise ValueError(
                f"tensor parallelism over {tp} positions needs num_heads "
                f"({attn.num_heads}) and num_kv_heads ({attn.num_kv_heads}) "
                f"divisible by {tp}: each position holds whole heads")

    # -- pieces ----------------------------------------------------------

    def piece_of(self, n: str, c) -> int:
        a = self.axis[n]
        return 0 if a is None else c[_AX[a]]

    def pieces(self, n: str) -> int:
        a = self.axis[n]
        return 1 if a is None else self.size[a]

    def _split(self, n: str, full: torch.Tensor) -> List[torch.Tensor]:
        if self.axis[n] is None:
            return [full]
        if n in self._qkv:
            full = _permute_qkv(full, *self._qkv[n])
        return list(full.tensor_split(self.pieces(n), dim=self.dim[n]))

    def _join(self, n: str, pieces, device) -> torch.Tensor:
        if self.axis[n] is None:
            return pieces[0].to(device)
        full = torch.cat([p.to(device) for p in pieces], dim=self.dim[n])
        if n in self._qkv:
            full = _unpermute_qkv(full, *self._qkv[n])
        return full

    def _at_piece(self, c, n: str, j: int):
        a = self.axis[n]
        c = list(c)
        c[_AX[a]] = j
        return tuple(c)

    def crossing(self, axis: Optional[str], c) -> Optional[mesh_lib.Span]:
        """The slice along ``axis`` through position ``c`` where it crosses
        processes, else None."""
        if axis is None or not self.spans:
            return None
        over = self.mesh.span(axis, _index(c))
        return over if over.crosses else None

    def span_of(self, n: str, c) -> Optional[mesh_lib.Span]:
        """The slice of leaf ``n``'s axis through ``c`` (``crossing``)."""
        return self.crossing(self.axis[n], c)

    def join_at(self, n: str, c) -> torch.Tensor:
        """Leaf ``n`` whole on position ``c``'s device, from the pieces of
        the positions that share c's other coordinates (gathered from
        the other processes of the slice where it crosses them)."""
        with torch.no_grad():
            if self.axis[n] is None:
                return self._join(n, [self.held[c][n]], self.dev[c])
            over = self.span_of(n, c)
            run = range(over.lo, over.hi) if over else range(self.pieces(n))
            return self._whole(n, [self.held[self._at_piece(c, n, j)][n]
                                   for j in run], over, self.dev[c])

    def _whole(self, n: str, mine, over, device) -> torch.Tensor:
        """Leaf ``n`` whole from this process's run of its pieces
        (``mine``), the other processes' gathered over ``over``: each
        piece padded to the widest along the leaf's dim (``tensor_split``
        may cut unequal pieces), trimmed after."""
        if over is None:
            return self._join(n, mine, device)
        dim = self.dim[n]
        ends = self.starts[n][1:] + [self.shapes[n][dim]]
        widths = [e - b for b, e in zip(self.starts[n], ends)]
        wide = max(widths)

        def pad(t):
            extra = wide - t.shape[dim]
            if not extra:
                return t
            shape = list(t.shape)
            shape[dim] = extra
            return torch.cat([t, t.new_zeros(shape)], dim=dim)

        block = torch.cat([pad(t.to(device)) for t in mine], dim=dim)
        got = process_group.all_gather(block, over.group)
        pieces = []
        for proc_block in got.unbind(0):
            pieces.extend(proc_block.split(wide, dim=dim))
        return self._join(n, [p.narrow(dim, 0, w) for p, w in
                              zip(pieces, widths)], device)

    def _owners(self, n: str) -> Dict[int, Tuple]:
        """The first local holder of each piece of ``n`` this process
        holds."""
        out = {}
        for c in self.coords:
            out.setdefault(self.piece_of(n, c), c)
        return dict(sorted(out.items()))

    def _owned(self, n: str):
        if self.axis[n] is None:
            return self.held[self.coords[0]][n]
        return {str(j): self.held[c][n].detach()
                for j, c in self.owners[n].items()}

    def check_fetch(self, state: TrainState) -> None:
        """Refuse to fetch a leaf sharded across processes to one host, as
        JAX's ``device_get`` refuses (``Checkpoint.save``)."""
        names = [n for n in self.sharded_names()
                 if self.span_of(n, self.coords[0]) is not None]
        if names:
            n = names[0]
            path = "/".join(state.jax_paths.get(n, (n,)))
            raise ValueError(
                f"params/{path} is sharded over {self.axis[n]!r} across "
                f"processes: a snapshot fetches every leaf to this host, "
                f"and JAX refuses to fetch an array that spans devices of "
                f"other processes and is not fully replicated (jax.Array "
                f"._value: 'Fetching value for jax.Array that spans "
                f"non-addressable (non process local) devices is not "
                f"possible'); {len(names)} leaves are sharded so")

    def sharded_names(self) -> List[str]:
        return [n for n, a in self.axis.items() if a is not None]

    def names_of(self, module) -> List[Tuple[str, str]]:
        """(name in ``module``, name in the model) of its parameters."""
        return self._names[id(module)]

    def leaf(self, n: str, c, whole: bool = True) -> torch.Tensor:
        """Leaf ``n`` as position ``c`` uses it: its own copy (replicated),
        its piece (``whole=False``), or made whole (``_Gather``)."""
        if self.axis[n] is None or not whole:
            return self.held[c][n]
        if self.axis[n] == "model" and self.span_of(n, c) is not None:
            raise ValueError(
                f"{n} is sharded over 'model' across processes and used "
                f"whole: the lockstep forward runs a 'model' leaf piece by "
                f"piece (the attention, MLP, embedding and head handlers)")
        if torch.is_grad_enabled():
            return _Gather.apply(self.anchor, self, n, c)
        return self.join_at(n, c)

    def gathers(self, names) -> bool:
        return any(self.axis[n] is not None for n in names)

    def position_bytes(self, opt_state=None) -> Dict[Tuple, Dict[str, int]]:
        """Per position, the bytes of the parameters it holds and (given
        the state's ``opt_state``) of the moments of the pieces it owns."""
        out = {c: {"params": sum(t.numel() * t.element_size()
                                 for t in self.held[c].values()),
                   "moments": 0} for c in self.coords}
        for val in (opt_state or {}).values():
            if not isinstance(val, dict):
                continue
            for n, t in val.items():
                if not isinstance(t, dict):
                    t = {"0": t}
                for j, c in self.owners[n].items():
                    part = t[str(j)]
                    out[c]["moments"] += part.numel() * part.element_size()
        return out

    # -- streams ---------------------------------------------------------

    def lead(self, d: int, f: int, s: int) -> Tuple:
        """Where this process runs a stream's replicated math."""
        return (d, f, self.model_run[0], s, self.expert_run[0])

    def streams(self, seq_split: bool) -> List[Tuple[int, int, int]]:
        """This process's streams, in mesh order."""
        seq = self.size["seq"] if seq_split else 1
        return [(d, f, s) for d in range(self.size["data"])
                for f in range(self.size["fsdp"]) for s in range(seq)
                if self.lead(d, f, s) in self.dev]

    def span_streams(self, seq_split: bool) -> List[List[Tuple[int, int,
                                                               int]]]:
        """The streams of each process of the stream span, in rank order
        (this process's are ``streams``)."""
        seq = self.size["seq"] if seq_split else 1
        _, _, m, _, e = self.lead(0, 0, 0)
        out = {p: [] for p in self.stream_span.procs}
        for d, f, s in itertools.product(range(self.size["data"]),
                                         range(self.size["fsdp"]),
                                         range(seq)):
            p = int(self.mesh.processes[_index((d, f, m, s, e))])
            out[p].append((d, f, s))
        return [out[p] for p in self.stream_span.procs]

    def global_streams(self, seq_split: bool) -> int:
        """The streams of every process."""
        return self.size["data"] * self.size["fsdp"] * (
            self.size["seq"] if seq_split else 1)

    def across(self, value: torch.Tensor) -> torch.Tensor:
        """This process's share of a sum over the streams, summed over the
        stream span where it crosses processes (no gradient: each
        process's backward runs on its own share)."""
        over = self.stream_span
        if over is None or not over.crosses:
            return value
        return process_group.all_reduce(value.detach(), group=over.group)

    def seq_split(self, x: torch.Tensor) -> bool:
        """Whether a batch cuts over the seq positions: (B, S) token
        ids."""
        if self.size["seq"] == 1 or x.ndim != 2 or x.is_floating_point():
            return False
        if x.shape[1] % self.size["seq"]:
            raise ValueError(f"sequence length {x.shape[1]} not divisible "
                             f"by the seq mesh size {self.size['seq']}")
        return True

    def split(self, x: torch.Tensor, seq_split: bool) -> List[torch.Tensor]:
        groups = self.size["data"] * self.size["fsdp"]
        if x.shape[0] % groups:
            raise ValueError(f"batch {x.shape[0]} not divisible by the "
                             f"data x fsdp mesh size {groups}")
        seq = self.size["seq"] if seq_split else 1
        out = []
        for (d, f, s) in self.streams(seq_split):
            rows = x.chunk(groups)[d * self.size["fsdp"] + f]
            if seq_split:
                rows = rows.chunk(seq, dim=1)[s]
            out.append(rows.to(self.dev[self.lead(d, f, s)]))
        return out

    def generators(self, generator: torch.Generator, streams
                   ) -> List[torch.Generator]:
        """The generator each stream's forward draws from (the module
        docstring): in one process ``generator`` on its own device,
        elsewhere one a device seeded from a digest of ``generator``'s
        state; across processes one a stream, seeded from that digest and
        the stream."""
        by_key = {} if self.spans else {generator.device: generator}
        digest = hashlib.blake2b(generator.get_state().numpy().tobytes(),
                                 digest_size=8).digest()
        out = []
        for (d, f, s) in streams:
            dev = self.dev[self.lead(d, f, s)]
            key = (d, f, s) if self.spans else dev
            if key not in by_key:
                tag = f"{d}/{f}/{s}" if self.spans else str(dev)
                seed = hashlib.blake2b(digest + tag.encode(),
                                       digest_size=8).digest()
                by_key[key] = make_generator(
                    int.from_bytes(seed, "little") >> 1, dev)
            out.append(by_key[key])
        if self.spans:
            nxt = hashlib.blake2b(digest + b"next", digest_size=8).digest()
            generator.manual_seed(int.from_bytes(nxt, "little") >> 1)
        return out

    # -- gradients -------------------------------------------------------

    def stash_grad(self, n: str, c, g: torch.Tensor) -> None:
        key = (n, c)
        prev = self._mb_grads.get(key)
        self._mb_grads[key] = g if prev is None else prev + g

    def fold_grads(self) -> None:
        """After a microbatch's backward: its gradients of gathered leaves
        added to the step's, as ``.grad`` accumulates."""
        for key, g in self._mb_grads.items():
            prev = self._grads.get(key)
            self._grads[key] = g if prev is None else prev + g
        self._mb_grads = {}

    @torch.no_grad()
    def reduce_grads(self, scale: float = 1.0) -> Dict[str, Any]:
        """Every piece's gradient, summed over its holders in position
        order (``mesh.all_reduce``; ``mesh.reduce_scatter`` for an fsdp
        leaf), in the owned layout. Across processes (the module
        docstring) the sums of replicated leaves and "model" pieces run
        over the stream span in one flattened buffer a dtype, and the
        whole-leaf sums of fsdp leaves are reduce-scattered over the fsdp
        slice, then summed over the data and seq processes."""
        sums, whole = {}, {}
        for n, own in self.owned.items():
            axis = self.axis[n]
            if axis == "fsdp":
                parts = []
                for c in self.coords:
                    g = self._grads.get((n, c))
                    parts.append(g if g is not None else torch.zeros(
                        self.shapes[n], dtype=self.held[c][n].dtype,
                        device=self.dev[c]))
                if scale != 1.0:
                    parts = [g * scale for g in parts]
                whole[n] = mesh_lib.position_sum(parts)
                continue
            by_piece: Dict[int, List[torch.Tensor]] = {}
            for c in self.coords:
                j = self.piece_of(n, c)
                t = self.held[c][n]
                parts = by_piece.setdefault(j, [])
                if t.grad is not None:
                    parts.append(t.grad)
                g = self._grads.get((n, c))
                if g is not None:
                    for jj, piece in enumerate(self._split(n, g)):
                        by_piece.setdefault(jj, []).append(piece)
            for j, owner in self.owners[n].items():
                parts = by_piece.get(j) or [torch.zeros_like(
                    self.held[owner][n])]
                if scale != 1.0:
                    parts = [g * scale for g in parts]
                sums[(n, j)] = mesh_lib.position_sum(parts)
        over = self.stream_span
        shared = [k for k in sums if k[0] not in self.complete]
        if over is not None and over.crosses and shared:
            sums.update(zip(shared, process_group.all_reduce_flat(
                [sums[k] for k in shared], over.group)))
        grads = {}
        for (n, j), g in sums.items():
            if self.axis[n] is None:
                grads[n] = g.to(self.dev[self.owners[n][0]])
            else:
                grads.setdefault(n, {})[str(j)] = g.to(
                    self.dev[self.owners[n][j]])
        for n, pieces in self._fsdp_pieces(whole).items():
            grads[n] = {str(j): piece.to(self.dev[self.owners[n][j]])
                        for j, piece in pieces.items()}
        self._one_copy(grads)
        for c in self.coords:
            for t in self.held[c].values():
                t.grad = None
        self._grads, self._mb_grads = {}, {}
        return grads

    def _one_copy(self, grads: Dict[str, Any]) -> None:
        """Where "expert" crosses processes each process of the expert span
        runs its streams' replicated math whole, and its gradients of the
        replicated leaves (the router's too) agree with the others' but
        for the bits of kernels that add in a varying order (K7's dQ):
        every process takes the span's first process's (a sum in which
        the others add zeros, so FP32 runs stay bit for bit)."""
        ex = self.expert_span
        if ex is None or not ex.crosses:
            return
        keys = [(n, k) for n, g in grads.items() if self.axis[n] != "expert"
                for k in (g if isinstance(g, dict) else [None])]
        if not keys:
            return
        first = self.mesh.process_index == ex.procs[0]

        def get(n, k):
            return grads[n] if k is None else grads[n][k]

        got = process_group.all_reduce_flat(
            [get(n, k) if first else torch.zeros_like(get(n, k))
             for n, k in keys], ex.group)
        for (n, k), g in zip(keys, got):
            if k is None:
                grads[n] = g
            else:
                grads[n][k] = g

    def _fsdp_pieces(self, whole: Dict[str, torch.Tensor]
                     ) -> Dict[str, Dict[int, torch.Tensor]]:
        """This process's pieces of each fsdp leaf's whole-leaf gradient
        sum: cut locally, or reduce-scattered over the fsdp slice where it
        crosses processes (one buffer a dtype, each process's row its
        pieces of every leaf), then summed over the data and seq
        processes where they cross."""
        fs, rest = self.fsdp_span, self.rest_span
        out: Dict[str, Dict[int, torch.Tensor]] = {}
        local = whole if fs is None or not fs.crosses else \
            {n: g for n, g in whole.items() if n in self.complete}
        for n, g in local.items():
            pieces = g.chunk(self.pieces(n), dim=self.dim[n])
            out[n] = {j: pieces[j] for j in self.owners[n]}
        if len(local) < len(whole):
            by_dtype: Dict[torch.dtype, List[str]] = {}
            for n, g in whole.items():
                if n not in local:
                    by_dtype.setdefault(g.dtype, []).append(n)
            for names in by_dtype.values():
                cut = {n: whole[n].chunk(self.pieces(n), dim=self.dim[n])
                       for n in names}
                rows = [torch.cat([cut[n][j].reshape(-1) for n in names
                                   for j, q in enumerate(fs.owners)
                                   if q == p]) for p in fs.procs]
                mine = process_group.reduce_scatter(
                    torch.stack(rows), fs.group)
                sizes = [(n, j) for n in names for j in self.owners[n]]
                flat = mine.split([cut[n][j].numel() for n, j in sizes])
                for (n, j), piece in zip(sizes, flat):
                    out.setdefault(n, {})[j] = piece.view(cut[n][j].shape)
        keys = [(n, j) for n, pieces in out.items() for j in pieces
                if n not in self.complete]
        if rest is not None and rest.crosses and keys:
            summed = process_group.all_reduce_flat(
                [out[n][j] for n, j in keys], rest.group)
            for (n, j), g in zip(keys, summed):
                out[n][j] = g
        return out

    @torch.no_grad()
    def grad_sq_norm(self, grads) -> torch.Tensor:
        """The squared global norm of the whole gradient tree, which the
        optimizer's clip scales by (JAX's ``clip_by_global_norm`` over
        the global tree), from this process's part ``grads`` (the owned
        layout): each leaf's (piece's) sum of squares added in the order
        of the one-process layout's tree, a piece this process does not
        hold filled in by the process of its first holder in mesh order
        (one all-reduce over the mesh's processes, every entry from one
        process, so the sums are exact)."""
        keys = [(n, j) for n in self.sharded_names()
                for j in range(self.pieces(n))]
        first = {}
        for c in _coords(self.mesh):
            for n in self.sharded_names():
                first.setdefault((n, self.piece_of(n, c)),
                                 int(self.mesh.processes[_index(c)]))
        me = self.mesh.process_index
        dev = self.devices[0]
        vals = torch.zeros(len(keys), dtype=torch.float32, device=dev)
        for k, (n, j) in enumerate(keys):
            if first[(n, j)] == me:
                vals[k] = grads[n][str(j)].float().square().sum()
        everyone = self.mesh.span(mesh_lib.AXES, _index(self.coords[0]))
        if everyone.crosses and keys:
            vals = process_group.all_reduce(vals, group=everyone.group)
        got = dict(zip(keys, vals.unbind(0)))
        tree = {n: ({str(j): got[(n, j)] for j in range(self.pieces(n))}
                    if self.axis[n] is not None
                    else grads[n].float().square().sum())
                for n in self.axis}
        return sum_leaves(tree)

    @torch.no_grad()
    def broadcast(self) -> None:
        """Every holder's copy from the owned tree."""
        for n, own in self.owned.items():
            for c in self.coords:
                src = own if self.axis[n] is None else \
                    own[str(self.piece_of(n, c))]
                dst = self.held[c][n]
                if dst.data_ptr() != src.data_ptr():
                    dst.copy_(src)

    # -- the full layout ---------------------------------------------------

    def full_params(self) -> Dict[str, torch.Tensor]:
        """Every leaf whole on the first position's device (new tensors;
        across processes a collective: the module docstring)."""
        first = self.coords[0]
        return {n: self.join_at(n, first).detach().clone()
                for n in self.axis}

    def full_opt_state(self, opt_state) -> Dict[str, Any]:
        """The optimizer state with every sharded moment gathered."""
        out = {}
        for key, val in opt_state.items():
            if not isinstance(val, dict):
                out[key] = val
                continue
            out[key] = {}
            for n, t in val.items():
                if isinstance(t, dict):
                    t = self._whole(n, [t[str(j)] for j in self.owners[n]],
                                    self.span_of(n, self.coords[0]),
                                    self.devices[0])
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
                    for j, piece in enumerate(self._split(n, src)):
                        if str(j) in t:
                            t[str(j)].copy_(piece)
                else:
                    t.copy_(src)

    @torch.no_grad()
    def set_params(self, full: Dict[str, torch.Tensor]) -> None:
        """Every holder's copy from whole leaves."""
        for n, t in full.items():
            pieces = self._split(n, torch.as_tensor(t))
            for c in self.coords:
                self.held[c][n].copy_(pieces[self.piece_of(n, c)])

    @torch.no_grad()
    def write_back(self, model=None) -> None:
        """Put every sharded leaf whole into the model's own tensors (they
        are empty during the run)."""
        params = dict((model or self.model).named_parameters())
        for n in self.sharded_names():
            params[n].data = self.join_at(n, self.coords[0]).detach()

    def trees(self, state: TrainState) -> Dict[str, Any]:
        full = dataclasses.replace(
            state, layout=None, params=self.full_params(),
            opt_state=self.full_opt_state(state.opt_state))
        return train_state_trees(full)

    def load(self, state: TrainState, params=None, opt_state=None,
             net_state=None) -> None:
        from ..train.step import load_jax_train_state

        full_params = self.full_params()
        full_opt = self.full_opt_state(state.opt_state)
        plain = dataclasses.replace(state, layout=None, params=full_params,
                                    opt_state=full_opt)
        load_jax_train_state(plain, params=params, opt_state=opt_state,
                             net_state=net_state)
        if opt_state is not None:
            self.set_opt_state(state.opt_state, full_opt)
        self.set_params(full_params)


# -- the lockstep forward ---------------------------------------------------


@contextlib.contextmanager
def _using(pairs):
    """Run with each module's parameters replaced (``(module, {name:
    tensor})`` pairs)."""
    with contextlib.ExitStack() as stack:
        for mod, params in pairs:
            stack.enter_context(_reparametrize_module(mod, params))
        yield


class _Run:
    """One lockstep forward over the streams of ``layout`` (the module
    docstring). Each handler maps a module and one activation a stream to
    one output a stream."""

    def __init__(self, layout: DataParallel, train: bool, streams,
                 generators, seq_split: bool):
        self.lay = layout
        self.train = train
        self.streams = streams
        self.global_streams = layout.global_streams(seq_split)
        self.gens = generators
        self.seq = layout.size["seq"] if seq_split else 1
        ctx = active_ring_context()
        self.method = ctx["method"] if ctx["mesh"] is not None else "ring"

    # -- helpers ---------------------------------------------------------

    def lead(self, i: int) -> Tuple:
        d, f, s = self.streams[i]
        return self.lay.lead(d, f, s)

    def at(self, i: int, m: int = 0, e: Optional[int] = None) -> Tuple:
        d, f, s = self.streams[i]
        return (d, f, m, s, self.lay.expert_run[0] if e is None else e)

    def tp_input(self, i: int, x):
        """Stream ``i``'s activation as it enters the column products of
        its "model" positions: f over the stream's "model" slice."""
        over = self.lay.crossing("model", self.lead(i))
        return x if over is None else \
            process_group.sum_backward(x, over.group)

    def call(self, mods, c, fn, *args, rels=None, whole: bool = True):
        """``fn(*args)`` with the parameters of ``mods`` (those named in
        ``rels``, else all) as position ``c`` holds them: sharded ones made
        whole, under a checkpoint, so the whole copies are gathered again
        for the backward rather than kept; or, ``whole=False``, its
        pieces."""
        lay = self.lay
        names = [(m, rel, full) for m in mods for rel, full in
                 lay.names_of(m) if rels is None or rel in rels]

        def body(*a):
            pairs = []
            for m in mods:
                pairs.append((m, {rel: lay.leaf(full, c, whole) for mm, rel,
                                  full in names if mm is m}))
            with _using(pairs):
                return fn(*a)

        if whole and torch.is_grad_enabled() and \
                lay.gathers(n for _, _, n in names):
            return remat_call(body, None, self.gens, *args)
        return body(*args)

    def per_stream(self, mod, xs, fn=None):
        fn = fn or (lambda x, g: mod(x, train=self.train, generator=g))
        return [self.call([mod], self.lead(i), fn, x, g)
                for i, (x, g) in enumerate(zip(xs, self.gens))]

    def name(self, mod, rel: str) -> Optional[str]:
        for r, full in self.lay.names_of(mod):
            if r == rel:
                return full
        return None

    def offset(self, i: int, x) -> int:
        return self.streams[i][2] * x.shape[1]

    # -- dispatch ------------------------------------------------------------

    def forward(self, mod, xs, hidden: bool = False):
        from ..models.gpt2 import GPT2
        from ..models.llama import Llama, LlamaBlock

        if isinstance(mod, (GPT2, Llama)):
            h = mod.run_hidden(xs, self)
            return h if hidden else [self.head(mod, t, i)
                                     for i, t in enumerate(h)]
        if isinstance(mod, Sequential):
            for child in mod.layers:
                xs = self.forward(child, xs)
            return xs
        if isinstance(mod, Residual):
            ys = self.forward(mod.layers[0], xs)
            short = xs if len(mod.layers) == 1 else self.forward(
                mod.layers[1], xs)
            return [mod.merge(y, s) for y, s in zip(ys, short)]
        if isinstance(mod, Parallel):
            branches = [self.forward(b, xs) for b in mod.layers]
            return [mod.merge([b[i] for b in branches])
                    for i in range(len(xs))]
        if isinstance(mod, BatchNorm) and self.train:
            return self.batchnorm(mod, xs)
        if isinstance(mod, MoE):
            return self.moe(mod, xs)
        if isinstance(mod, (GPTBlock, LlamaBlock)):
            return mod.run(xs, self)
        if isinstance(mod, MultiHeadAttention):
            return self.attention(mod, xs)
        if isinstance(mod, Embedding):
            return self.embed(mod, xs)
        if isinstance(mod, PositionalEmbedding):
            return self.positional(mod, xs)
        if isinstance(mod, Dropout):
            return [mod(x, train=self.train, generator=g)
                    for x, g in zip(xs, self.gens)]
        if self.train and any(isinstance(c, BatchNorm)
                              for c in mod.modules()):
            raise NotImplementedError(
                f"{type(mod).__name__} holds a BatchNorm outside a "
                "Sequential / Residual / Parallel: the lockstep forward "
                "cannot give it the global batch's statistics")
        if self.seq > 1 and any(isinstance(c, MultiHeadAttention)
                                for c in mod.modules()):
            raise ValueError(
                f"{type(mod).__name__}: its attention would see one seq "
                "position's slice; sequence parallelism runs the layers the "
                "lockstep forward descends into (GPT2, Llama, blocks, "
                "MultiHeadAttention in a Sequential)")
        # a module the lockstep does not descend into sees its stream's
        # whole input: attention inside it runs locally
        with _no_ring():
            return self.per_stream(mod, xs)

    # -- handlers --------------------------------------------------------

    def batchnorm(self, mod, xs):
        """Every stream normalized by the global batch's statistics: the
        streams' sums added in position order (``mesh.all_reduce``)."""
        dims = tuple(range(xs[0].ndim - 1))
        count = sum(x.numel() // x.shape[-1] for x in xs) \
            * self.global_streams // len(xs)
        over = self.lay.stream_span
        s1 = mesh_lib.all_reduce([x.float().sum(dim=dims) for x in xs],
                                 over=over)
        s2 = mesh_lib.all_reduce([(x.float() * x.float()).sum(dim=dims)
                                  for x in xs], over=over)
        out = []
        for i, (x, a, b) in enumerate(zip(xs, s1, s2)):
            mean = a / count
            var = (b / count - mean * mean).clamp_min(0.0)
            out.append(self.call([mod], self.lead(i), mod.normalize, x, mean,
                                 var))
        return out

    def moe(self, mod, xs):
        """One routing over every stream's tokens in global (row,
        position) order; the experts of each "expert" position computed on
        its slice there; the output cut back into the streams. Across
        processes every process of the stream span gathers every stream's
        tokens (``gather_keep``) and routes them all alike, so its MoE
        computes the whole layer, and takes its own streams' output back
        (``take_own``: the backward gathers every stream's output
        gradient), so the layer's gradients are whole on every process
        (``DataParallel.complete``); where "expert" crosses, each process
        computes its own experts, f (``sum_backward``) where the routed
        tokens enter them and the outputs ``gather_keep``'d over the
        expert span."""
        lay = self.lay
        first = lay.coords[0]
        dev = lay.dev[first]
        over = lay.stream_span if lay.stream_span is not None and \
            lay.stream_span.crosses else None
        if over is None:
            table = [list(self.streams)]
            parts = [x.to(dev) for x in xs]
        else:
            table = lay.span_streams(self.seq > 1)
            got = process_group.gather_keep(
                torch.stack([x.to(dev) for x in xs]), over.group)
            parts = [t for block in got.unbind(0) for t in block.unbind(0)]
        by_stream = dict(zip([st for q in table for st in q], parts))
        groups = {}
        for st in sorted(by_stream):
            groups.setdefault(st[:2], []).append(st)
        rows = [torch.cat([by_stream[st] for st in g], dim=1)
                for g in groups.values()]
        x_all = torch.cat(rows, dim=0) if len(rows) > 1 else rows[0]
        w_in = self.name(mod, "w_in")
        stacks = [self.name(mod, r) for r in ("w_in", "b_in", "w_out",
                                              "b_out")]
        gate = [self.name(mod, "gate_kernel")]
        ep = lay.axis[w_in] == "expert"
        ex = lay.expert_span if ep and lay.expert_span is not None and \
            lay.expert_span.crosses else None

        def route(x):
            experts = None
            if ep:
                def experts(xe):
                    if ex is not None:
                        xe = process_group.sum_backward(xe, ex.group)
                    pieces = xe.tensor_split(lay.size["expert"])
                    outs = []
                    for e in lay.expert_run:
                        c = first[:4] + (e,)
                        w = [lay.leaf(n, c, whole=False) for n in stacks]
                        outs.append(mod.expert_ffn(pieces[e].to(lay.dev[c]),
                                                   *w).to(xe.device))
                    ye = torch.cat(outs)
                    if ex is not None:
                        ye = process_group.gather_keep(ye, ex.group) \
                            .flatten(0, 1)
                    return ye
            else:
                full = [lay.leaf(n, first) for n in stacks]

                def experts(xe):
                    return mod.expert_ffn(xe, *full)
            with _using([(mod, {"gate_kernel": lay.leaf(gate[0], first)})]):
                return mod._route(x, experts)

        needs = gate + ([] if ep else stacks)
        if torch.is_grad_enabled() and lay.gathers(needs):
            out, aux = remat_call(route, None, self.gens, x_all)
        else:
            out, aux = route(x_all)
        mod.last_aux = aux
        if self.train:
            mod.pending_state = {"aux_loss": aux.detach()}
        cut = {}
        for seq, row in zip(groups.values(), out.chunk(len(rows), dim=0)):
            for st, part in zip(seq, row.chunk(len(seq), dim=1)
                                if len(seq) > 1 else [row]):
                cut[st] = part
        if over is not None:
            mine = process_group.take_own(torch.stack(
                [torch.stack([cut[st] for st in q]) for q in table]),
                over.group)
            return [mine[i].to(x.device) for i, x in enumerate(xs)]
        return [cut[st].to(x.device) for st, x in zip(self.streams, xs)]

    def embed(self, mod, ids):
        """The lookup; a vocab-sharded table masked on each "model"
        position and all-reduced."""
        lay = self.lay
        n = self.name(mod, "table")
        if lay.axis[n] != "model":
            return self.per_stream(mod, ids)
        out = []
        for i, x in enumerate(ids):
            parts = []
            for m in lay.model_run:
                c = self.at(i, m)
                piece = lay.leaf(n, c, whole=False)
                idx = x.to(lay.dev[c]) - lay.starts[n][m]
                live = (idx >= 0) & (idx < piece.shape[0])
                rows = mod.policy.cast_param(
                    piece[idx.clamp(0, piece.shape[0] - 1)])
                parts.append(torch.where(live[..., None], rows,
                                         torch.zeros((), dtype=rows.dtype,
                                                     device=rows.device)))
            out.append(mesh_lib.all_reduce(
                parts, over=self.lay.crossing("model", self.lead(i)),
                grad="pass")[0])
        return out

    def positional(self, mod, xs):
        return [self.call([mod], self.lead(i),
                          lambda x, o: mod(x, offset=o), x,
                          self.offset(i, x))
                for i, x in enumerate(xs)]

    def head(self, model, h, i: int):
        lay = self.lay
        if model.head is None:
            n = self.name(model.wte, "table")
            if lay.axis[n] == "model":
                h = self.tp_input(i, h)
                return tuple(
                    qmatmul(h.to(lay.dev[self.at(i, m)]),
                            model.policy.cast_param(
                                lay.leaf(n, self.at(i, m), whole=False)).t())
                    for m in lay.model_run)
            return self.call([model.wte], self.lead(i), model.wte.attend, h)
        return self.call(
            [model.head], self.lead(i),
            lambda t: qmatmul(t, model.policy.cast_param(model.head.kernel),
                              out_dtype=torch.float32), h)

    # -- the run's operations (``nn.run``) -----------------------------------

    layer = forward

    @staticmethod
    def add(xs, ys):
        return [x + y for x, y in zip(xs, ys)]

    def mlp(self, inner, cols, row, xs):
        """``row(inner(x))``, ``inner`` computing the column layers
        ``cols`` (GPT-2's fc, Llama's gate and up): under "model" each
        position runs ``inner`` on its columns and the row layer's product
        on its rows, one ``all_reduce`` sums them and the row bias is
        added once; otherwise the layers as they are."""
        lay = self.lay
        w_row = self.name(row, "kernel")
        if lay.axis[w_row] != "model":
            return [self.call(cols + [row], self.lead(i),
                              lambda h: row(inner(h)), x)
                    for i, x in enumerate(xs)]
        out = []
        for i, x in enumerate(xs):
            parts = []
            x = self.tp_input(i, x)
            for m in lay.model_run:
                c = self.at(i, m)
                a = self.call(cols, c, inner, x.to(lay.dev[c]), whole=False)
                w = row.policy.cast_param(lay.leaf(w_row, c, whole=False))
                parts.append(qmatmul(row.policy.cast_in(a), w))
            y = mesh_lib.all_reduce(parts, over=self.lay.crossing(
                "model", self.lead(i)), grad="pass")[0]
            b = self.name(row, "bias")
            if b is not None:
                y = y + lay.leaf(b, self.lead(i)).float()
            out.append(row.policy.cast_out(y))
        return out

    def attention(self, mod, xs):
        """``MultiHeadAttention``: each "model" position's heads projected
        from its qkv columns, attention over the seq positions of the same
        rows (ring or Ulysses) or locally, the out rows' partial products
        all-reduced and the bias added once."""
        lay = self.lay
        tp = lay.axis[self.name(mod, "qkv_kernel")] == "model"
        ranks = lay.model_run if tp else lay.model_run[:1]
        proj = {}
        for i, x in enumerate(xs):
            if tp:
                x = self.tp_input(i, x)
            for m in ranks:
                c = self.at(i, m)
                q, k, v = (t.transpose(1, 2) for t in self.call(
                    [mod], c, mod._project_qkv, x.to(lay.dev[c]),
                    rels=("qkv_kernel", "qkv_bias"), whole=not tp))
                if mod.rope_theta:
                    off = self.offset(i, x)
                    q = apply_rope(q, off, mod.rope_theta)
                    k = apply_rope(k, off, mod.rope_theta)
                proj[(i, m)] = (q, k, v)
        attn = {}
        if self.seq > 1:
            if self.method == "ulysses":
                q, k, _ = proj[(0, ranks[0])]
                check_ulysses(q.shape[1], k.shape[1],
                              xs[0].shape[1] * self.seq, self.seq)
            ring = ulysses_attention_local if self.method == "ulysses" \
                else ring_attention_local
            groups = {}
            for i, (d, f, s) in enumerate(self.streams):
                groups.setdefault((d, f), []).append(i)
            scale = 1.0 / math.sqrt(mod.head_dim)
            for idx in groups.values():
                for m in ranks:
                    qs, ks, vs = zip(*(proj[(i, m)] for i in idx))
                    over = self.lay.crossing("seq", self.at(idx[0], m))
                    outs = ring(qs, ks, vs, causal=mod.causal, scale=scale,
                                over=over)
                    for i, o in zip(idx, outs):
                        attn[(i, m)] = o
        else:
            with _no_ring():
                for key, (q, k, v) in proj.items():
                    attn[key] = sdpa(q, k, v, causal=mod.causal,
                                     backend=mod.backend)
        out = []
        for i, g in enumerate(self.gens):
            dtype = attn[(i, ranks[0])].dtype
            if not tp:
                out.append(self.call(
                    [mod], self.lead(i),
                    lambda t, gen: mod._project_out(t, self.train, gen),
                    attn[(i, ranks[0])].transpose(1, 2), g,
                    rels=("out_kernel", "out_bias")))
                continue
            parts = [self.call([mod], self.at(i, m), mod._out_product,
                               attn[(i, m)].transpose(1, 2),
                               rels=("out_kernel",), whole=False)
                     for m in ranks]
            y = mesh_lib.all_reduce(parts, over=self.lay.crossing(
                "model", self.lead(i)), grad="pass")[0]
            out.append(self.call(
                [mod], self.lead(i),
                lambda t, gen: mod._out_finish(t, dtype, self.train, gen),
                y, g, rels=("out_bias",)))
        return out


@contextlib.contextmanager
def _no_ring():
    from ..nn import attention

    prev = dict(attention._RING_CTX)
    attention._RING_CTX["mesh"] = None
    try:
        yield
    finally:
        attention._RING_CTX.update(prev)


# -- the loss -----------------------------------------------------------------


def sharded_cross_entropy(pieces: Sequence[torch.Tensor], starts,
                          labels: torch.Tensor,
                          over: Optional[mesh_lib.Span] = None
                          ) -> torch.Tensor:
    """``softmax_cross_entropy`` of logits split over the vocabulary
    (``pieces``, starting at vocab rows ``starts``) against integer
    ``labels`` (< 0 ignored): the row max and the sum of exponentials
    reduced over the pieces (``mesh.all_reduce``; then over the other
    processes of ``over``, the "model" slice), the label's logit from
    the piece that holds it."""
    mx = mesh_lib.all_reduce([p.detach().float().amax(-1) for p in pieces],
                             op="max", over=over)
    se = mesh_lib.all_reduce([torch.exp(p.float() - m[..., None]).sum(-1)
                              for p, m in zip(pieces, mx)], over=over,
                             grad="pass")
    zl = []
    for p, start in zip(pieces, starts):
        idx = labels.to(p.device).long() - start
        live = (idx >= 0) & (idx < p.shape[-1])
        z = p.float().gather(-1, idx.clamp(0, p.shape[-1] - 1)[..., None])
        zl.append(torch.where(live, z[..., 0], 0.0))
    zl = mesh_lib.all_reduce(zl, over=over, grad="pass")[0]
    dev = zl.device
    nll = mx[0].to(dev) + torch.log(se[0].to(dev)) - zl
    mask = (labels.to(dev) >= 0).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def _predictions(out, starts, over: Optional[mesh_lib.Span] = None
                 ) -> torch.Tensor:
    """The argmax over the vocabulary of whole or sharded logits (the
    first maximum, as ``argmax``; the pieces of the other processes of
    ``over`` taken in slice order)."""
    if not isinstance(out, tuple):
        return out.argmax(dim=-1)
    dev = out[0].device
    bests = []
    for p, start in zip(out, starts):
        v, i = p.float().max(dim=-1)
        bests.append((v.to(dev), i.to(dev) + start))
    if over is not None and over.crosses:
        vs, idx = zip(*bests)
        vs = process_group.all_gather(torch.stack(vs), over.group)
        idx = process_group.all_gather(torch.stack(idx), over.group)
        bests = list(zip(vs.flatten(0, 1).unbind(0),
                         idx.flatten(0, 1).unbind(0)))
    best_v = best_i = None
    for v, i in bests:
        if best_v is None:
            best_v, best_i = v, i
        else:
            better = v > best_v
            best_v = torch.where(better, v, best_v)
            best_i = torch.where(better, i, best_i)
    return best_i


def _hits(out, labels, starts, over=None):
    pred = _predictions(out, starts, over)
    labels, mask = metrics_lib._labels_mask(labels.to(pred.device),
                                            pred.ndim)
    return ((pred == labels) & mask), mask


def _global_mean(values, counts, device, total):
    """The mean of per-stream ``values`` weighted by their rows
    (``counts``) of ``total`` rows in all: this process's share of it
    where ``total`` counts every process's rows."""
    return mesh_lib.all_reduce([v.float() * (c / total)
                                for v, c in zip(values, counts)])[0] \
        .to(device)


class DPTrainStep:
    """``(state, data, labels) -> (state, metrics)`` over the global
    batch; ``layout`` is the run's ``DataParallel`` (set by
    ``place_state``)."""

    def __init__(self, model, optimizer, loss_fn, scheduler, grad_accum: int,
                 augment, remat, compute_accuracy: bool,
                 lm_head_chunk: Optional[int] = None):
        self.layout: Optional[DataParallel] = None
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.scheduler = scheduler
        self.grad_accum = int(grad_accum)
        self.augment = augment
        self.remat = remat
        self.policy = resolve_remat_policy(remat) if remat else None
        self.compute_accuracy = compute_accuracy
        self.lm_head_chunk = lm_head_chunk
        self.moe = has_moe(model)

    def _table(self):
        """(name of the head's table, the model module that owns it)."""
        model = self.model
        if model.head is None:
            return next(n for r, n in self.layout.names_of(model.wte)
                        if r == "table"), model.wte
        return None, model.head

    def _loss(self, run: _Run, out, labels, i: int, loss_fn=None):
        loss_fn = loss_fn or self.loss_fn
        if isinstance(out, tuple):
            over = run.lay.crossing("model", run.lead(i))
            if loss_fn is losses_lib.get("softmax_cross_entropy"):
                return sharded_cross_entropy(out, self._vocab_starts(),
                                             labels, over)
            if over is not None:
                raise ValueError(
                    f"{getattr(loss_fn, '__name__', loss_fn)}: the vocab-"
                    f"sharded logits cross processes; only "
                    f"softmax_cross_entropy reduces them there")
            out = torch.cat([p.to(out[0].device) for p in out], dim=-1)
        return loss_fn(out, labels)

    def _vocab_starts(self):
        """The vocab row each of this process's logit pieces starts at."""
        n, _ = self._table()
        return [self.layout.starts[n][m] for m in self.layout.model_run]

    def _hits(self, run: _Run, out, labels, i: int):
        if not isinstance(out, tuple):
            return _hits(out, labels, None)
        return _hits(out, labels, self._vocab_starts(),
                     run.lay.crossing("model", run.lead(i)))

    def _chunked_loss(self, run: _Run, h, labels, i: int):
        lay = self.layout
        chunk = self.lm_head_chunk
        n, owner = self._table()
        if n is not None and lay.axis[n] == "model":
            lse, zl = [], []
            over = run.lay.crossing("model", run.lead(i))
            h = run.tp_input(i, h)
            for m in lay.model_run:
                c = run.at(i, m)
                dev = lay.dev[c]
                table = owner.policy.cast_param(lay.leaf(n, c, whole=False))
                a, b = lm_head_lse(h.to(dev), table,
                                   labels.to(dev) - lay.starts[n][m], chunk)
                lse.append(a)
                zl.append(b)
            mx = mesh_lib.all_reduce([t.detach() for t in lse], op="max",
                                     over=over)
            se = mesh_lib.all_reduce([torch.exp(t - m)
                                      for t, m in zip(lse, mx)], over=over,
                                     grad="pass")
            total = mx[0] + torch.log(se[0]) - mesh_lib.all_reduce(
                zl, over=over, grad="pass")[0]
            return total.mean()
        return run.call([owner], run.lead(i),
                        lambda t: lm_head_loss(t, self.model.head_table(),
                                               labels, chunk), h)

    def _forward(self, state, xs, seq_split, train: bool):
        lay = self.layout
        streams = lay.streams(seq_split)
        gens = lay.generators(state.generator, streams) if train else \
            [None] * len(streams)
        run = _Run(lay, train, streams, gens, seq_split)
        return run, gens

    def _microbatch(self, state, data, labels):
        lay = self.layout
        seq_split = lay.seq_split(data)
        xs, ls = lay.split(data, seq_split), lay.split(labels, seq_split)
        run, gens = self._forward(state, xs, seq_split, True)
        hidden = self.lm_head_chunk is not None

        def fwd(*shards):
            outs = run.forward(self.model, list(shards), hidden)
            aux = moe_aux_loss(self.model) if self.moe else None
            return tuple(outs), aux

        if self.remat:
            outs, aux = remat_call(fwd, self.policy, gens, *xs)
        else:
            outs, aux = fwd(*xs)
        counts = [x.shape[0] for x in xs]
        total = counts[0] * lay.global_streams(seq_split)
        dev = lay.devices[0]
        score = self._chunked_loss if hidden else self._loss
        loss = _global_mean([score(run, o, l, i) for i, (o, l) in
                             enumerate(zip(outs, ls))], counts, dev, total)
        # the aux loss once: every process of the stream span computes the
        # whole MoE (``_Run.moe``), so each backward takes it whole and the
        # metric adds it after the sum over the span
        metric = lay.across(loss.detach())
        if aux is not None:
            loss = loss + aux.to(dev)
            aux = aux.detach().to(dev)
            metric = metric + aux
        loss.backward()
        lay.fold_grads()
        commit = getattr(self.model, "commit_state", None)
        if commit is not None:
            commit()
        acc = None
        if self.compute_accuracy:
            acc = lay.across(_global_mean(
                [self._accuracy(run, o, l, i) for i, (o, l) in
                 enumerate(zip(outs, ls))], counts, dev, total))
        return metric, acc, aux

    def _accuracy(self, run: _Run, out, labels, i: int):
        out = out.detach() if not isinstance(out, tuple) else \
            tuple(p.detach() for p in out)
        hits, mask = self._hits(run, out, labels, i)
        return hits.sum(dtype=torch.float32) / mask.sum(
            dtype=torch.float32).clamp_min(1.0)

    def __call__(self, state: TrainState, data, labels):
        lay = self.layout
        if lay is None or state.layout is not lay:
            raise ValueError("place the state first (place_state)")
        if lay.spans:
            process_group.assert_equal((data, labels), "the global batch")
        data, labels = data.to(lay.devices[0]), labels.to(lay.devices[0])
        if self.augment is not None:
            data = self.augment(state.generator, data)
        n = self.grad_accum
        loss = acc = aux = 0.0
        for d, l in microbatches(data, labels, n):
            mb_loss, mb_acc, mb_aux = self._microbatch(state, d, l)
            loss = loss + mb_loss
            if mb_acc is not None:
                acc = acc + mb_acc
            if mb_aux is not None:
                aux = aux + mb_aux
        grads = lay.reduce_grads(1.0 / n)
        lr_scale = apply_update(self.optimizer, self.scheduler, state, grads,
                                lay.owned, sq_norm=lay.grad_sq_norm
                                if lay.spans else None)
        lay.broadcast()
        return state, step_metrics(
            loss / n, lr_scale, acc / n if self.compute_accuracy else None,
            aux / n if self.moe else None)

    def eval_step(self, loss_fn="softmax_cross_entropy",
                  compute_accuracy: bool = True):
        """The eval step over the same layout: each stream scores its
        shard, the loss is the global mean and the corrects their sum."""
        if isinstance(loss_fn, (str, dict)):
            loss_fn = losses_lib.get(loss_fn)

        @torch.no_grad()
        def step(state, data, labels):
            lay = self.layout
            if lay.spans:
                process_group.assert_equal((data, labels),
                                           "the global batch")
            seq_split = lay.seq_split(data)
            xs = lay.split(data, seq_split)
            ls = lay.split(labels, seq_split)
            run, _ = self._forward(state, xs, seq_split, False)
            outs = run.forward(self.model, xs)
            vals = [self._loss(run, o, l, i, loss_fn) for i, (o, l) in
                    enumerate(zip(outs, ls))]
            metrics = {"loss": lay.across(_global_mean(
                vals, [x.shape[0] for x in xs], lay.devices[0],
                xs[0].shape[0] * lay.global_streams(seq_split)))}
            if compute_accuracy:
                metrics["corrects"] = mesh_lib.all_reduce(
                    [self._hits(run, o, l, i)[0].sum(dtype=torch.int32)
                     for i, (o, l) in enumerate(zip(outs, ls))],
                    over=lay.stream_span)[0]
            return metrics

        return step


def make_dp_train_step(model, optimizer, mesh: Mesh,
                       loss_fn="softmax_cross_entropy", scheduler=None,
                       fsdp: bool = False, tp: bool = False,
                       ep: bool = False,
                       grad_accum: int = 1, augment: Optional[Callable] = None,
                       remat: "bool | str" = False,
                       compute_accuracy: bool = True,
                       lm_head_chunk: Optional[int] = None):
    """A parallel train step over ``mesh`` (the module docstring):
    ``fsdp``, ``tp`` and ``ep`` pick the rule sets that shard the
    parameters; the mesh's seq positions cut (B, S) token batches.

    Returns ``(step, place_state, place_batch)``: ``place_state(state)``
    places a ``create_train_state`` state of ``model`` and returns it with
    its layout; ``step(state, data, labels)`` takes the global batch;
    ``place_batch(data, labels)`` puts it on the mesh's first position,
    where the step cuts it. ``step.eval_step(loss_fn)`` is the matching
    eval step. ``lm_head_chunk`` computes the loss over the model's
    hidden states in vocab tiles (``nn.lm_loss``) and needs
    ``compute_accuracy=False``."""
    if lm_head_chunk is not None:
        from ..models.gpt2 import GPT2
        from ..models.llama import Llama

        if compute_accuracy:
            raise ValueError("lm_head_chunk computes no logits; pass "
                             "compute_accuracy=False")
        if not isinstance(model, (GPT2, Llama)):
            raise ValueError(f"{type(model).__name__}: the parallel step's "
                             "lm_head_chunk takes a GPT2 or a Llama")
    if isinstance(loss_fn, (str, dict)):
        loss_fn = losses_lib.get(loss_fn)
    step = DPTrainStep(model, optimizer, loss_fn, scheduler or NoOp(),
                       grad_accum, augment, remat, compute_accuracy,
                       lm_head_chunk)
    first = _device(mesh, next(c for c in _coords(mesh)
                               if mesh.is_local(_index(c))))

    def place_state(state: TrainState) -> TrainState:
        if state.layout is not None:
            return state
        full = state.opt_state
        if mesh.spans_processes:
            check_spans(mesh)
            process_group.assert_equal(dict(model.named_parameters()),
                                       "the initial parameters")
        layout = DataParallel(model, mesh, fsdp=fsdp, tp=tp, ep=ep)
        state.opt_state = optimizer.init(layout.owned)
        layout.set_opt_state(state.opt_state, full)
        layout.broadcast()
        state.layout = step.layout = layout
        return state

    def place_batch(data, labels):
        return data.to(first), labels.to(first)

    return step, place_state, place_batch
