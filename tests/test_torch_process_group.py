"""The parallel layouts across processes (``tnn_tpu_torch.parallel.
process_group``, the mesh and ``make_dp_train_step`` over it) against
JAX's meshes and the port's in-process mesh.

Two ranks run as processes of their own on the CPU, over gloo (this file
run as a script is the rank side). One pair of processes runs every
case, first with one position a rank, then, after a second
``initialize``, with two; the cases' inputs (JAX's initial weights and
the batches, from numpy seeds) and the references are made once and
shared by the tests, also across xdist workers (a lock file in the run's
shared temporary directory).

- A conv + BatchNorm net and a 2-layer GPT-2 (``gpt2_tiny``'s blocks at
  vocab 64), 2 SGD steps at {"data": 2} (one position a rank) and
  {"data": 4} (two), and the GPT-2 at {"data": 2, "model": 2} (the
  "model" positions inside each rank); the GPT-2 with fsdp, model or seq
  across the ranks: {"fsdp": 2}, {"model": 2}, {"seq": 2} by the ring
  and by Ulysses (one position a rank), {"fsdp": 4}, {"model": 2,
  "seq": 2} ("model" crossing) and {"fsdp": 2, "seq": 2} ("fsdp"
  crossing; two a rank). Losses within 1e-5 relative and parameters and
  BatchNorm statistics within rtol 1e-5 / atol 1e-6 of JAX's
  ``make_dp_train_step`` over the same mesh on its forced CPU devices
  (inside its ``ring_context`` for "seq"), JAX's own DP bound; both
  ranks hold the same values bit for bit.
- Against the port's in-process mesh of the same shape, the two train
  steps and then one eval step (its loss and corrects): bit for bit with
  one position a rank (each sum across the ranks adds two values, a + b
  either way); with two the group adds (p0 + p1) + (p2 + p3) where the
  in-process mesh adds ((p0 + p1) + p2) + p3, one f32 rounding apart on
  each such sum, so within rtol 1e-5 / atol 1e-7 after two steps (the
  readings are about 3e-8 absolute).
- Under fsdp across the ranks each rank holds only its pieces between
  steps: the bytes of its positions are those of the in-process mesh's
  positions it stands for, half of every sharded leaf, and the model's
  own tensors of sharded leaves are empty.
- ``train_model`` at {"fsdp": 2} across the ranks trains until its first
  snapshot and raises there, naming the first leaf sharded across the
  ranks and JAX's condition: the JAX loop's ``Checkpoint.save`` fetches
  every leaf with ``jax.device_get``, which refuses an array that spans
  other processes' devices and is not fully replicated.
- ``assert_equal`` refuses a batch that differs across the ranks, naming
  it and the rank, as JAX's ``device_put`` refuses a host value that
  differs across processes; a rank with no position of a mesh is
  refused.
- F8: AdamW with a binding ``grad_clip_norm`` at {"fsdp": 2} and
  {"model": 2} across the ranks clips by the norm of the whole gradient
  tree, as JAX does: against JAX, and against the in-process mesh bit
  for bit with the norm of each step.
- A 2-layer, 4-expert, top-2 MoE GPT-2 at {"data": 2} and {"expert": 2}
  (one position a rank), {"expert": 4} and {"data": 2, "expert": 2}
  (two): losses, aux losses and parameters against JAX's and the
  in-process mesh's; each routing's top-k equal on both ranks by
  digest; under "expert" each rank holds its experts' pieces only.
- The conv + BatchNorm net's pipeline at {"pipe": 2} (GPipe and
  ``virtual=2``), {"pipe": 4} and {"data": 2, "pipe": 2}: losses and each
  stage's parameters and statistics against JAX's pipeline step at lr /
  (pp x data) (ROADMAP.md section 3) and against the in-process
  pipeline; where "pipe" crosses each rank holds only its stages.
  ``spmd_pipeline`` across the ranks against the in-process one.
- ``train_model`` at {"pipe": 2} across the ranks trains, then its first
  snapshot refuses the packed rows sharded over "pipe", as JAX's
  ``device_get`` does; {"pipe": 2, "model": 2} is refused with the JAX
  loop's message.
- With no ``mesh_axes`` each rank trains its own replica on its own data,
  equal bit for bit to a run of ``train_model`` in this process.
"""
import fcntl
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
SPAWN_TIMEOUT = 240
STEPS = 2
LR = 0.1
BATCH = 8
VOCAB, SEQ = 64, 16
#: (case, mesh axes, positions a rank, the seq method)
CASES = [("conv_bn", {"data": 2}, 1, None), ("gpt2", {"data": 2}, 1, None),
         ("gpt2", {"data": 2, "model": 2}, 2, None),
         ("conv_bn", {"data": 4}, 2, None), ("gpt2", {"data": 4}, 2, None),
         ("gpt2", {"fsdp": 2}, 1, None), ("gpt2", {"model": 2}, 1, None),
         ("gpt2", {"seq": 2}, 1, "ring"), ("gpt2", {"seq": 2}, 1, "ulysses"),
         ("gpt2", {"fsdp": 4}, 2, None),
         ("gpt2", {"model": 2, "seq": 2}, 2, "ring"),
         ("gpt2", {"fsdp": 2, "seq": 2}, 2, "ring")]
#: F8: AdamW whose global-norm clip binds (the first step's norm is
#: about 1; the test checks it binds), fsdp and model across the ranks
CLIP = 0.05
#: an eps near the clipped gradient's entries, so Adam's update follows the
#: clip's scale (at 1e-8 it would cancel it)
CLIP_EPS = 1e-3
CLIP_CASES = [("gpt2", {"fsdp": 2}, 1, None), ("gpt2", {"model": 2}, 1, None)]
#: MoE (2 layers, 4 experts, top-2): the token gather crosses at "data",
#: the experts at "expert"
MOE_CASES = [("moe", {"data": 2}, 1, None), ("moe", {"expert": 2}, 1, None),
             ("moe", {"expert": 4}, 2, None),
             ("moe", {"data": 2, "expert": 2}, 2, None)]
#: pipelines of the conv + BatchNorm net: (mesh axes, positions a rank,
#: virtual), 2 microbatches of 4
PIPE_CASES = [({"pipe": 2}, 1, 1), ({"pipe": 2}, 1, 2), ({"pipe": 4}, 2, 1),
              ({"data": 2, "pipe": 2}, 2, 1)]
PIPE_NUM_MB, PIPE_MB = 2, BATCH // 2


def _pipe_id(case):
    axes, _, virtual = case
    return "pipe_" + "_".join(f"{k}{v}" for k, v in axes.items()) + \
        f"_v{virtual}"


def _case_id(case):
    name, axes, _, method = case
    return name + "_" + "_".join(f"{k}{v}" for k, v in axes.items()) + (
        f"_{method}" if method else "")


def _ring(attention, mesh, axes, method):
    """The seq method's context from either package's ``nn.attention``
    (a null one without "seq"), with the live batch axes as the loop's."""
    import contextlib

    if not method:
        return contextlib.nullcontext()
    batch = tuple(a for a in ("data", "fsdp") if axes.get(a, 1) > 1)
    return attention.ring_context(mesh, batch_axis=batch or None,
                                  method=method)


# -- the rank side ------------------------------------------------------------


def _port_model(inputs, name):
    from tnn_tpu_torch.core import dtypes as tdt
    from tnn_tpu_torch.core.module import config_module
    from tnn_tpu_torch.models.gpt2 import GPT2

    spec = inputs[name]
    if name in ("gpt2", "moe"):
        model = GPT2(**spec["kwargs"], policy=tdt.FP32, device="cpu",
                     seed=None)
    else:
        model = config_module(spec["config"])
        model.init(spec["x"].shape[1:], device="cpu", seed=None)
    model.load_jax_params(spec["params"])
    if spec["state"]:
        model.load_jax_state(spec["state"])
    return model


def _clip_opt():
    """AdamW clipping at ``CLIP`` that records the norm of each update."""
    import torch

    from tnn_tpu_torch.nn import optimizers as topt

    class Recording(topt.AdamW):
        norms = []

        def update(self, grads, state, params, lr_scale=1.0, sq_norm=None):
            norm = topt.global_norm(grads) if sq_norm is None else \
                torch.sqrt(sq_norm)
            self.norms.append(float(norm))
            return super().update(grads, state, params, lr_scale, sq_norm)

    return Recording(lr=1e-3, eps=CLIP_EPS, grad_clip_norm=CLIP)


def run_dp(inputs, name, axes, devices=None, method=None, clip=False):
    """``STEPS`` SGD steps (``clip``: the recording AdamW) of
    ``make_dp_train_step`` over ``axes``: the losses, the JAX-layout
    params and net state, as numpy, the bytes of parameters each of this
    process's positions holds and, for a MoE, a digest of each routing's
    top-k experts."""
    import torch

    from tnn_tpu_torch import parallel as tpar
    from tnn_tpu_torch.nn import attention as tattn
    from tnn_tpu_torch.nn import optimizers as topt
    from tnn_tpu_torch.nn.moe import MoE
    from tnn_tpu_torch.parallel import process_group as pg
    from tnn_tpu_torch.train import step as tstep

    spec = inputs[name]
    model = _port_model(inputs, name)
    opt = _clip_opt() if clip else topt.SGD(lr=LR)
    mesh = tpar.make_mesh(**axes, devices=devices)
    step, place_state, place_batch = tpar.make_dp_train_step(
        model, opt, mesh, fsdp=axes.get("fsdp", 1) > 1,
        tp=axes.get("model", 1) > 1, ep=axes.get("expert", 1) > 1)
    state = place_state(tstep.create_train_state(model, opt))
    x, y = torch.from_numpy(spec["x"]), torch.from_numpy(spec["y"]).long()
    losses, aux, routing = [], [], []
    real = MoE._slots

    def slots(self, top_e, t, cap):
        routing.append(pg.digest(top_e))
        return real(self, top_e, t, cap)

    MoE._slots = slots
    try:
        with _ring(tattn, mesh, axes, method):
            for _ in range(STEPS):
                state, m = step(state, *place_batch(x, y))
                losses.append(float(m["loss"]))
                if "aux_loss" in m:
                    aux.append(float(m["aux_loss"]))
            ev = step.eval_step()(state, *place_batch(x, y))
    finally:
        MoE._slots = real
    held = {c: b["params"] for c, b in
            state.layout.position_bytes().items()}
    empty = sorted(n for n, p in model.named_parameters() if p.numel() == 0)
    trees = tstep.train_state_trees(state)
    return {"losses": losses, "params": _tree_np(trees["params"]),
            "net_state": _tree_np(trees.get("net_state", {})),
            "eval": [float(ev["loss"]), int(ev["corrects"])],
            "position_bytes": held, "emptied": empty,
            "sharded": sorted(state.layout.sharded_names()),
            "aux": aux, "routing": routing,
            "norms": list(opt.norms) if clip else []}


def run_pipe(inputs, case, devices=None):
    """``STEPS`` SGD steps of ``make_pipeline_train_step`` of the conv +
    BatchNorm net from JAX's packed rows, then one eval step: the losses,
    each stage this process holds as {path: array} (params and state),
    the eval loss and corrects, and the stages this process holds."""
    import torch

    from tnn_tpu_torch import parallel as tpar
    from tnn_tpu_torch.core.module import config_module
    from tnn_tpu_torch.nn import optimizers as topt
    from tnn_tpu_torch.train import step as tstep

    axes, _, virtual = case
    spec = inputs["conv_bn"]
    rows = inputs["pipe_rows"][_pipe_id(case)]
    shape = (PIPE_MB,) + spec["x"].shape[1:]
    stages = tpar.partition_model(config_module(spec["config"]),
                                  axes["pipe"] * virtual, shape)
    dp = axes.get("data", 1)
    pipe, step_fn, init = tpar.make_pipeline_train_step(
        stages, topt.SGD(lr=LR), tpar.make_mesh(**axes, devices=devices),
        shape, num_microbatches=PIPE_NUM_MB, input_dtype=torch.float32,
        data_axis="data" if dp > 1 else None, virtual=virtual)
    state = init(None)
    tstep.load_jax_train_state(state, params=rows[0], net_state=rows[1])
    x, y = torch.from_numpy(spec["x"]), torch.from_numpy(spec["y"]).long()
    losses, accs = [], []
    for _ in range(STEPS):
        state, m = step_fn(state, x, y)
        losses.append(float(m["loss"]))
        accs.append(float(m["accuracy"]))
    ev = tpar.make_pipeline_eval_step(pipe)(state, x, y)
    held = [s for s in range(pipe.L) if pipe.mine(s) is not None]
    return {"losses": losses, "accuracy": accs,
            "eval": [float(ev["loss"]), float(ev["corrects"])],
            "held": held,
            "meta": [s for s, st in enumerate(pipe.stages) if s not in held
                     and all(t.is_meta for t in st.state_dict().values())],
            "stages": {s: {"params": _tree_np(dict(
                ("/".join(p), t) for p, t in pipe._paths(s))),
                "state": _tree_np(dict(("/".join(p), t)
                                       for p, t in pipe._paths(s, True)))}
                for s in held}}


def run_spmd(virtual, devices=None):
    """``spmd_pipeline`` (``virtual`` > 1: the interleaved form) of a tanh
    layer over 2 pipe positions, 4 microbatches: the outputs and the
    gradients of a weighted sum of them."""
    import functools

    import torch

    from tnn_tpu_torch import parallel as tpar

    rs = np.random.RandomState(5)
    w = torch.tensor(rs.randn(2 * virtual, 6, 6).astype(np.float32) * 0.5,
                     requires_grad=True)
    x = torch.tensor(rs.randn(4, 3, 6).astype(np.float32),
                     requires_grad=True)
    fn = tpar.spmd_pipeline if virtual == 1 else functools.partial(
        tpar.spmd_pipeline_interleaved, virtual=virtual)
    out = fn(lambda p, h: torch.tanh(h @ p["w"]), {"w": w}, x,
             tpar.make_mesh(pipe=2, devices=devices))
    (out * torch.from_numpy(rs.randn(*out.shape).astype(np.float32))) \
        .sum().backward()
    return {"out": out.detach().numpy(), "w": w.grad.numpy(),
            "x": x.grad.numpy()}


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _train_pipe(inputs, tmp, axes):
    """``train_model`` of the conv + BatchNorm net at ``axes`` across the
    ranks on two batches: its error, the losses of the steps it took and
    the snapshots it left."""
    from tnn_tpu_torch.data.loader import ArrayDataLoader
    from tnn_tpu_torch.train import train_model
    from tnn_tpu_torch.utils.config import TrainingConfig

    spec = inputs["conv_bn"]
    model = _port_model(inputs, "conv_bn")
    snaps = tmp / ("train_" + "_".join(axes))
    cfg = TrainingConfig().update({
        "epochs": 1, "batch_size": BATCH, "shuffle": False,
        "mesh_axes": axes, "num_microbatches": PIPE_NUM_MB,
        "optimizer": {"type": "sgd", "lr": LR}, "snapshot_dir": str(snaps),
        "io_dtype": "float32", "progress_print_interval": 1})
    losses = []
    loader = ArrayDataLoader(np.concatenate([spec["x"], spec["x"][::-1]]),
                             np.concatenate([spec["y"], spec["y"][::-1]]))
    out = {"error": _error(lambda: train_model(
        model, cfg, loader,
        metric_hook=lambda step, m: losses.append(m["loss"])))}
    out["losses"] = losses
    out["snapshots"] = sorted(p.name for p in snaps.glob("*")) \
        if snaps.exists() else []
    return out


def _train_fsdp(inputs, tmp):
    """``train_model`` of the GPT-2 at {"fsdp": 2} across the ranks: its
    error, the losses of the steps it took and the bytes its rank
    held."""
    import torch

    from tnn_tpu_torch.data.loader import ArrayDataLoader
    from tnn_tpu_torch.train import train_model
    from tnn_tpu_torch.utils.config import TrainingConfig

    spec = inputs["gpt2"]
    model = _port_model(inputs, "gpt2")
    cfg = TrainingConfig().update({
        "epochs": 1, "batch_size": BATCH // 2, "shuffle": False,
        "mesh_axes": {"fsdp": 2}, "optimizer": {"type": "sgd", "lr": LR},
        "snapshot_dir": str(tmp / "train_fsdp"), "io_dtype": "float32",
        "progress_print_interval": 1})
    losses = []
    out = {"error": _error(lambda: train_model(
        model, cfg, ArrayDataLoader(spec["x"], spec["y"]),
        metric_hook=lambda step, m: losses.append(m["loss"])))}
    out["losses"] = losses
    out["snapshots"] = sorted(p.name for p in (tmp / "train_fsdp").glob("*")) \
        if (tmp / "train_fsdp").exists() else []
    out["whole_after"] = all(p.numel() > 0 for p in model.parameters())
    out["digest"] = torch.cat([p.detach().reshape(-1) for p in
                               model.parameters()]).sum().item()
    return out


def _replica(inputs, rank, tmp):
    """``train_model`` with no mesh_axes on this rank's own batches."""
    from tnn_tpu_torch.data.loader import ArrayDataLoader
    from tnn_tpu_torch.train import train_model

    x, y = replica_data(rank)
    model = _port_model(inputs, "conv_bn")
    train_model(model, replica_config(tmp / f"replica{rank}"),
                ArrayDataLoader(x, y))
    return _tree_np({n: p for n, p in model.named_parameters()})


def replica_data(rank):
    rs = np.random.RandomState(100 + rank)
    return (rs.randn(2 * BATCH, 8, 8, 3).astype(np.float32),
            rs.randint(0, 10, 2 * BATCH).astype(np.int32))


def replica_config(snapshots):
    from tnn_tpu_torch.utils.config import TrainingConfig

    return TrainingConfig().update({
        "epochs": 1, "batch_size": BATCH, "shuffle": False,
        "optimizer": {"type": "sgd", "lr": LR}, "io_dtype": "float32",
        "snapshot_dir": str(snapshots)})


def rank_main(rank: int, port: int, workdir: Path) -> None:
    import torch

    from tnn_tpu_torch import parallel as tpar
    from tnn_tpu_torch.parallel import process_group as pg

    torch.set_num_threads(1)
    inputs = pickle.loads((workdir / "inputs.pkl").read_bytes())
    out = {"runs": {}, "refusals": {}}
    coord = f"127.0.0.1:{port}"
    out["backend"] = pg.initialize(coord, 2, rank, "cpu")
    out["reason"] = pg.backend_reason()
    out["index"], out["count"] = pg.process_index(), pg.process_count()
    out["mesh_info"] = tpar.local_mesh_info("cpu")
    out["positions"] = [(p, str(d)) for p, d in pg.global_positions()]
    x = torch.tensor(float(rank + 1), requires_grad=True)
    (pg.all_reduce(x) * (rank + 1)).backward()
    out["psum_grad"] = float(x.grad)
    out["flat"] = [t.tolist() for t in pg.all_reduce_flat(
        [torch.full((2,), rank + 1.0), torch.tensor([rank], dtype=torch.int64),
         torch.full((3,), 0.5 * rank)])]
    out["equal_digest"] = pg.assert_equal({"a": np.arange(4)}, "a value")
    out["unequal"] = _error(lambda: pg.assert_equal(np.full(3, rank),
                                                    "a per-rank array"))
    out["no_position"] = _error(lambda: tpar.make_mesh(data=1))
    progress = workdir / f"rank{rank}.case"
    for case in CASES:
        if case[2] == 1:
            progress.write_text(_case_id(case))
            out["runs"][_case_id(case)] = run_dp(inputs, case[0], case[1],
                                                 method=case[3])
    for case in CLIP_CASES:
        progress.write_text("clip_" + _case_id(case))
        out["runs"]["clip_" + _case_id(case)] = run_dp(
            inputs, case[0], case[1], clip=True)
    _one_layouts(inputs, out, progress, 1)
    progress.write_text("spmd_pipeline")
    out["spmd"] = {v: run_spmd(v) for v in (1, 2)}
    progress.write_text("the refusals, the train_model run, the replica")
    spec = inputs["conv_bn"]
    bad = dict(inputs, conv_bn=dict(spec, x=spec["x"] + rank))
    out["batch_refused"] = _error(lambda: run_dp(bad, "conv_bn",
                                                 {"data": 2}))
    out["train_pipe"] = _train_pipe(inputs, workdir / str(rank),
                                    {"pipe": 2})
    out["refusals"]["pipe_model"] = _train_pipe(
        inputs, workdir / str(rank), {"pipe": 2, "model": 2})["error"]
    out["train_fsdp"] = _train_fsdp(inputs, workdir / str(rank))
    out["replica"] = _replica(inputs, rank, workdir / str(rank))
    pg.shutdown()
    pg.initialize(f"127.0.0.1:{port + 1}", 2, rank, "cpu",
                  local_devices=["cpu", "cpu"])
    out["mesh_info_2"] = tpar.local_mesh_info("cpu")
    for case in CASES:
        if case[2] == 2:
            progress.write_text(_case_id(case))
            out["runs"][_case_id(case)] = run_dp(inputs, case[0], case[1],
                                                 method=case[3])
    _one_layouts(inputs, out, progress, 2)
    pg.shutdown()
    (workdir / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))


def _one_layouts(inputs, out, progress, per_rank):
    """The MoE and pipeline cases of ``per_rank`` positions a rank."""
    for case in MOE_CASES:
        if case[2] == per_rank:
            progress.write_text(_case_id(case))
            out["runs"][_case_id(case)] = run_dp(inputs, case[0], case[1])
    for case in PIPE_CASES:
        if case[1] == per_rank:
            progress.write_text(_pipe_id(case))
            out["runs"][_pipe_id(case)] = run_pipe(inputs, case)


# -- the test side ------------------------------------------------------------


def _free_ports(n=2):
    """A base port with ``n`` free ports from it."""
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n > 65535:
            continue
        try:
            socks = []
            for k in range(1, n):
                t = socket.socket()
                socks.append(t)
                t.bind(("127.0.0.1", base + k))
            return base
        except OSError:
            continue
        finally:
            for t in socks:
                t.close()
    raise RuntimeError("no free ports")


def _inputs():
    import jax

    from tnn_tpu import models as jmodels
    from tnn_tpu import nn as jnn
    from tnn_tpu.core import dtypes as jdt
    from tnn_tpu.train import create_train_state as jcreate

    f32 = jdt.FP32
    conv = jnn.Sequential([
        jnn.Conv2D(4, 3, padding="same", use_bias=False, policy=f32),
        jnn.BatchNorm(policy=f32), jnn.Activation("relu", policy=f32),
        jnn.GlobalAvgPool(policy=f32), jnn.Dense(10, policy=f32)],
        policy=f32)
    kwargs = dict(vocab_size=VOCAB, max_len=SEQ)
    gpt = jmodels.zoo.create("gpt2_tiny", **kwargs, policy=f32)
    rs = np.random.RandomState(0)
    x = rs.randn(BATCH, 8, 8, 3).astype(np.float32)
    x[BATCH // 2:] *= 4.0       # the ranks' halves differ in scale
    y = rs.randint(0, 10, BATCH).astype(np.int32)
    ids = np.random.RandomState(1).randint(0, VOCAB, (BATCH, SEQ)) \
        .astype(np.int32)
    moe = jmodels.GPT2(vocab_size=VOCAB, max_len=SEQ, num_layers=2,
                       d_model=32, num_heads=4, moe_experts=4, policy=f32)
    moe_ids = np.random.RandomState(3).randint(0, VOCAB, (BATCH, SEQ)) \
        .astype(np.int32)
    out = {}
    for name, jmodel, a, b in (("conv_bn", conv, x, y),
                               ("gpt2", gpt, ids, np.roll(ids, -1, 1)),
                               ("moe", moe, moe_ids,
                                np.roll(moe_ids, -1, 1))):
        floating = a.dtype == np.float32
        st = jcreate(jmodel, jnn.SGD(lr=LR), jax.random.PRNGKey(0), a.shape,
                     input_dtype=jax.numpy.float32 if floating else None)
        out[name] = {"jmodel": jmodel, "x": a, "y": b,
                     "params": jax.tree.map(np.asarray, st.params),
                     "state": jax.tree.map(np.asarray, st.net_state),
                     "config": jmodel.get_config(),
                     "kwargs": dict(kwargs, num_layers=2, d_model=128,
                                    num_heads=2)}
    out["moe"]["kwargs"] = dict(kwargs, num_layers=2, d_model=32,
                                num_heads=4, moe_experts=4)
    out["pipes"], out["pipe_rows"] = {}, {}
    for case in PIPE_CASES:
        jpipe, jstep, state = _jax_pipe_setup(conv, case)
        out["pipes"][_pipe_id(case)] = (jpipe, jstep, state)
        out["pipe_rows"][_pipe_id(case)] = (np.asarray(state.params),
                                            np.asarray(state.net_state))
    return out


def _jax_pipe_setup(jmodel, case):
    """JAX's pipeline train step of ``case`` and its initial state, at
    lr / (pp x data): its step's gradient is pp x data times the loss's
    (ROADMAP.md section 3), so its update is the port's at lr."""
    import jax
    import jax.numpy as jnp

    from tnn_tpu import nn as jnn
    from tnn_tpu import parallel as jpar

    axes, _, virtual = case
    pp, dp = axes["pipe"], axes.get("data", 1)
    shape = (PIPE_MB, 8, 8, 3)
    stages = jpar.partition_model(jmodel, pp * virtual, shape)
    jpipe, jstep, jinit = jpar.make_pipeline_train_step(
        stages, jnn.SGD(lr=LR / (pp * dp)), jpar.make_mesh(**axes), shape,
        num_microbatches=PIPE_NUM_MB, input_dtype=jnp.float32,
        data_axis="data" if dp > 1 else None, virtual=virtual, donate=False)
    return jpipe, jstep, jinit(jax.random.PRNGKey(0))


def _jax_pipe(inputs, case):
    """JAX's pipeline from the shipped rows: the losses and, per stage,
    its params and state as {path: array} after ``STEPS`` steps."""
    import jax.numpy as jnp

    jpipe, jstep, st = inputs["pipes"][_pipe_id(case)]
    spec = inputs["conv_bn"]
    losses = []
    for _ in range(STEPS):
        st, m = jstep(st, jnp.asarray(spec["x"]), jnp.asarray(spec["y"]))
        losses.append(float(m["loss"]))
    stages = jpipe.unpack_stage_variables(st.params, st.net_state)
    return {"losses": losses,
            "stages": {s: {k: dict(_flat(v[k])) for k in ("params", "state")}
                       for s, v in enumerate(stages)}}


def _jax_dp(spec, axes, method=None, clip=False):
    import jax
    import jax.numpy as jnp

    from tnn_tpu import nn as jnn
    from tnn_tpu import parallel as jpar
    from tnn_tpu.nn import attention as jattn
    from tnn_tpu.train import create_train_state as jcreate
    from tnn_tpu.train.step import aux_loss_sum

    jmodel, x = spec["jmodel"], spec["x"]
    opt = jnn.AdamW(lr=1e-3, eps=CLIP_EPS, grad_clip_norm=CLIP) if clip \
        else jnn.SGD(lr=LR)
    st = jcreate(jmodel, opt, jax.random.PRNGKey(0), x.shape,
                 input_dtype=jnp.float32 if x.dtype == np.float32 else None)
    mesh = jpar.make_mesh(**axes)
    step, place_state, place_batch = jpar.make_dp_train_step(
        jmodel, opt, mesh, donate=False, fsdp=axes.get("fsdp", 1) > 1,
        tp=axes.get("model", 1) > 1, ep=axes.get("expert", 1) > 1)
    st = place_state(st)
    losses, aux = [], []
    with _ring(jattn, mesh, axes, method):
        for _ in range(STEPS):
            # placed again: the step's own output shardings would compile
            # it a second time
            st, m = step(place_state(st), *place_batch(
                jnp.asarray(x), jnp.asarray(spec["y"])))
            losses.append(float(m["loss"]))
            aux.append(float(aux_loss_sum(st.net_state)))
    return {"losses": losses, "aux": aux,
            "params": jax.tree.map(np.asarray, st.params),
            "net_state": jax.tree.map(np.asarray, st.net_state)}


def _build(workdir: Path):
    """Inputs, the two ranks' runs and every reference, in one pickle."""
    import torch

    inputs = _inputs()
    shipped = {k: {kk: vv for kk, vv in v.items() if kk != "jmodel"}
               for k, v in inputs.items() if k != "pipes"}
    (workdir / "inputs.pkl").write_bytes(pickle.dumps(shipped))
    port = _free_ports()
    env = {**os.environ, "TNN_PLATFORM": "cpu", "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(port), str(workdir)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in (0, 1)]
    # the references run while the ranks work
    jax_runs = {_case_id(c): _jax_dp(inputs[c[0]], c[1], c[3])
                for c in CASES + MOE_CASES}
    jax_runs.update({"clip_" + _case_id(c): _jax_dp(inputs[c[0]], c[1],
                                                    clip=True)
                     for c in CLIP_CASES})
    jax_runs.update({_pipe_id(c): _jax_pipe(inputs, c) for c in PIPE_CASES})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cpu4 = ["cpu"] * 4
        local = {_case_id(c): run_dp(shipped, c[0], c[1], devices=cpu4,
                                     method=c[3])
                 for c in CASES + MOE_CASES}
        local.update({"clip_" + _case_id(c): run_dp(
            shipped, c[0], c[1], devices=cpu4, clip=True)
            for c in CLIP_CASES})
        local.update({_pipe_id(c): run_pipe(shipped, c, devices=cpu4)
                      for c in PIPE_CASES})
        local["spmd"] = {v: run_spmd(v, devices=cpu4[:2]) for v in (1, 2)}
        replicas = []
        for rank in (0, 1):
            from tnn_tpu_torch.data.loader import ArrayDataLoader
            from tnn_tpu_torch.train import train_model

            model = _port_model(shipped, "conv_bn")
            train_model(model, replica_config(workdir / f"ref{rank}"),
                        ArrayDataLoader(*replica_data(rank)))
            replicas.append(_tree_np(dict(model.named_parameters())))
    finally:
        torch.set_num_threads(threads)
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=SPAWN_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            cases = [(workdir / f"rank{r}.case").read_text()
                     if (workdir / f"rank{r}.case").exists() else "start-up"
                     for r in (0, 1)]
            raise AssertionError(f"the ranks ran past {SPAWN_TIMEOUT} s, "
                                 f"in case {cases[0]!r} / {cases[1]!r}")
        logs.append(out)
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    ranks = [pickle.loads((workdir / f"rank{r}.pkl").read_bytes())
             for r in (0, 1)]
    return {"jax": jax_runs, "local": local, "replicas": replicas,
            "ranks": ranks}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.getbasetemp()
    shared = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    workdir = shared / "torch_process_group"
    with open(shared / "torch_process_group.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = workdir / "runs.pkl"
        if not done.exists():
            workdir.mkdir(exist_ok=True)
            t0 = time.perf_counter()
            result = _build(workdir)
            result["seconds"] = time.perf_counter() - t0
            done.write_bytes(pickle.dumps(result))
        return pickle.loads(done.read_bytes())


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield "/".join(map(str, prefix)), np.asarray(tree)


def _assert_trees(got, want, rtol, atol):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _assert_same(got, want):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_two_processes_match_jax_data_mesh(runs, case):
    cid = _case_id(case)
    a, b = (r["runs"][cid] for r in runs["ranks"])
    assert a["losses"] == b["losses"]
    _assert_same(a["params"], b["params"])
    _assert_same(a["net_state"], b["net_state"])
    ref = runs["jax"][cid]
    np.testing.assert_allclose(a["losses"], ref["losses"], rtol=1e-5)
    _assert_trees(a["params"], ref["params"], 1e-5, 1e-6)
    if case[0] == "conv_bn":
        _assert_trees(a["net_state"], ref["net_state"], 1e-5, 1e-6)


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_two_processes_match_in_process_mesh(runs, case):
    cid = _case_id(case)
    got, ref = runs["ranks"][1]["runs"][cid], runs["local"][cid]
    assert got["eval"][1] == ref["eval"][1]
    if case[2] == 1:
        assert got["eval"] == ref["eval"]
        assert got["losses"] == ref["losses"]
        _assert_same(got["params"], ref["params"])
        _assert_same(got["net_state"], ref["net_state"])
    else:
        np.testing.assert_allclose(got["losses"] + got["eval"][:1],
                                   ref["losses"] + ref["eval"][:1],
                                   rtol=1e-6)
        _assert_trees(got["params"], ref["params"], 1e-5, 1e-7)
        _assert_trees(got["net_state"], ref["net_state"], 1e-5, 1e-7)


def test_group_surface(runs):
    for r, out in enumerate(runs["ranks"]):
        assert out["backend"] == "gloo" and out["reason"] == \
            "ranks on the CPU"
        assert (out["index"], out["count"]) == (r, 2)
        assert out["positions"] == [(0, "cpu"), (1, "cpu")]
        assert out["mesh_info"] == {"device_count": 2,
                                    "local_device_count": 1,
                                    "process_count": 2, "platform": "cpu"}
        assert out["mesh_info_2"]["device_count"] == 4
        assert out["mesh_info_2"]["local_device_count"] == 2
        assert out["psum_grad"] == 3.0      # d/dx_r of sum_r' (r'+1) * psum
        assert out["flat"] == [[3.0, 3.0], [1], [0.5, 0.5, 0.5]]
    assert runs["ranks"][0]["equal_digest"] == \
        runs["ranks"][1]["equal_digest"]
    assert runs["ranks"][0]["no_position"] is None
    assert "process 1 holds no position" in runs["ranks"][1]["no_position"]


def test_assert_equal_refuses_unequal_batches(runs):
    for out in runs["ranks"]:
        assert "a per-rank array differs across processes: rank(s) [1]" \
            in out["unequal"]
        assert "the global batch differs across processes: rank(s) [1]" \
            in out["batch_refused"]


FSDP_CASES = [c for c in CASES if "fsdp" in c[1]]


@pytest.mark.parametrize("case", FSDP_CASES,
                         ids=[_case_id(c) for c in FSDP_CASES])
def test_fsdp_across_processes_holds_pieces(runs, case):
    cid = _case_id(case)
    ref = runs["local"][cid]["position_bytes"]
    whole = sum(np.asarray(v).nbytes for _, v in
                _flat(runs["local"][cid]["params"]))
    held = []
    for out in runs["ranks"]:
        got = out["runs"][cid]
        assert got["sharded"] and got["emptied"] == got["sharded"]
        assert len(got["position_bytes"]) == case[2]
        for c, b in got["position_bytes"].items():
            assert b == ref[c], c
            assert b < whole
        held.append(sum(got["position_bytes"].values()))
    assert sum(held) == sum(ref.values())


def test_train_model_fsdp_across_processes_stops_at_snapshot(runs):
    a, b = (out["train_fsdp"] for out in runs["ranks"])
    for out in (a, b):
        msg = out["error"]
        assert msg is not None and "is sharded over 'fsdp' across " \
            "processes" in msg, msg
        assert "Fetching value for jax.Array that spans non-addressable" \
            in msg
        assert len(out["losses"]) == 2 and out["snapshots"] == []
        assert out["whole_after"]
    assert a["losses"] == b["losses"] and a["digest"] == b["digest"]


def _check_in_process(got, ref, per_rank):
    """Bit for bit with one position a rank, else one f32 rounding apart
    on each sum across the ranks (the module docstring)."""
    if per_rank == 1:
        assert got["losses"] == ref["losses"]
        assert got["eval"] == ref["eval"]
    else:
        np.testing.assert_allclose(got["losses"] + got["eval"][:1],
                                   ref["losses"] + ref["eval"][:1],
                                   rtol=1e-6)
        assert got["eval"][1] == ref["eval"][1]
    for key in ("params", "net_state", "stages"):
        if key not in ref:
            continue
        want = ref[key] if key != "stages" else \
            {s: ref[key][s] for s in got[key]}
        if per_rank == 1:
            _assert_same(got[key], want)
        else:
            _assert_trees(got[key], want, 1e-5, 1e-7)


CLIP_IDS = [_case_id(c) for c in CLIP_CASES]


@pytest.mark.parametrize("case", CLIP_CASES, ids=CLIP_IDS)
def test_clip_norm_across_processes_matches_jax(runs, case):
    """F8: ``AdamW(grad_clip_norm)`` with fsdp or model across the ranks
    clips by the global norm of the whole gradient tree, JAX's, not this
    rank's pieces': the losses and parameters after 2 steps against
    JAX's, the clip binding, both ranks alike."""
    cid = "clip_" + _case_id(case)
    a, b = (r["runs"][cid] for r in runs["ranks"])
    assert a["losses"] == b["losses"] and a["norms"] == b["norms"]
    _assert_same(a["params"], b["params"])
    assert all(n > CLIP for n in a["norms"]), a["norms"]
    ref = runs["jax"][cid]
    np.testing.assert_allclose(a["losses"], ref["losses"], rtol=1e-5)
    _assert_trees(a["params"], ref["params"], 1e-5, 1e-6)


@pytest.mark.parametrize("case", CLIP_CASES, ids=CLIP_IDS)
def test_clip_norm_across_processes_matches_in_process(runs, case):
    """F8 against the port's in-process mesh, whose update sees the whole
    tree: the norms each step clipped by and everything else bit for
    bit."""
    cid = "clip_" + _case_id(case)
    got, ref = runs["ranks"][0]["runs"][cid], runs["local"][cid]
    assert got["norms"] == ref["norms"]
    _check_in_process(got, ref, 1)


MOE_IDS = [_case_id(c) for c in MOE_CASES]


@pytest.mark.parametrize("case", MOE_CASES, ids=MOE_IDS)
def test_moe_across_processes_matches_jax(runs, case):
    """A MoE GPT-2 with the token gather ("data") or the experts
    ("expert") crossing the ranks: losses (the aux loss in them once),
    aux losses and parameters against JAX's ``make_dp_train_step`` over
    the same mesh; both ranks alike."""
    cid = _case_id(case)
    a, b = (r["runs"][cid] for r in runs["ranks"])
    assert a["losses"] == b["losses"] and a["aux"] == b["aux"]
    _assert_same(a["params"], b["params"])
    ref = runs["jax"][cid]
    np.testing.assert_allclose(a["losses"], ref["losses"], rtol=1e-5)
    np.testing.assert_allclose(a["aux"], ref["aux"], rtol=1e-5)
    _assert_trees(a["params"], ref["params"], 1e-5, 1e-6)


@pytest.mark.parametrize("case", MOE_CASES, ids=MOE_IDS)
def test_moe_across_processes_matches_in_process(runs, case):
    cid = _case_id(case)
    got, ref = runs["ranks"][1]["runs"][cid], runs["local"][cid]
    _check_in_process(got, ref, case[2])
    if case[2] == 1:
        assert got["aux"] == ref["aux"]


EXPERT_CASES = [c for c in MOE_CASES if "expert" in c[1]]


@pytest.mark.parametrize("case", EXPERT_CASES,
                         ids=[_case_id(c) for c in EXPERT_CASES])
def test_expert_across_processes_holds_pieces(runs, case):
    """Each rank holds its positions' expert pieces only: the bytes of the
    in-process mesh's positions it stands for, the stacks' share of its
    experts, the model's own stacks emptied."""
    cid = _case_id(case)
    ref = runs["local"][cid]["position_bytes"]
    whole = sum(np.asarray(v).nbytes for _, v in
                _flat(runs["local"][cid]["params"]))
    held = []
    for out in runs["ranks"]:
        got = out["runs"][cid]
        assert got["sharded"] and all(n.endswith(("w_in", "b_in", "w_out",
                                                  "b_out"))
                                      for n in got["sharded"])
        assert got["emptied"] == got["sharded"]
        for c, nbytes in got["position_bytes"].items():
            assert nbytes == ref[c] and nbytes < whole, c
        held.append(sum(got["position_bytes"].values()))
    assert sum(held) == sum(ref.values())


def test_moe_routing_equal_on_both_ranks(runs):
    """The router runs on every rank over the same gathered tokens: each
    routing's top-k experts equal byte for byte on both ranks (digests)
    and to the in-process mesh's."""
    cid = _case_id(MOE_CASES[0])
    a, b = (r["runs"][cid]["routing"] for r in runs["ranks"])
    assert len(a) >= 2 * STEPS and a == b
    assert a[:2 * STEPS] == runs["local"][cid]["routing"][:2 * STEPS]


PIPE_IDS = [_pipe_id(c) for c in PIPE_CASES]


@pytest.mark.parametrize("case", PIPE_CASES, ids=PIPE_IDS)
def test_pipeline_across_processes_matches_jax(runs, case):
    """The conv + BatchNorm pipeline with "pipe" or "data" crossing the
    ranks (GPipe and interleaved): losses, and each stage's parameters
    and BatchNorm statistics after 2 steps against JAX's pipeline step at
    lr / (pp x data), whose gradient is pp x data times the loss's;
    both ranks' losses alike, every stage held by a rank."""
    cid = _pipe_id(case)
    a, b = (r["runs"][cid] for r in runs["ranks"])
    assert a["losses"] == b["losses"] and a["eval"] == b["eval"]
    ref = runs["jax"][cid]
    np.testing.assert_allclose(a["losses"], ref["losses"], rtol=1e-5)
    seen = set()
    for out in (a, b):
        for s, st in out["stages"].items():
            seen.add(s)
            _assert_trees(st, ref["stages"][s], 1e-4, 1e-6)
    assert seen == set(ref["stages"])


@pytest.mark.parametrize("case", PIPE_CASES, ids=PIPE_IDS)
def test_pipeline_across_processes_matches_in_process(runs, case):
    """Against the port's in-process pipeline of the same shape; where
    "pipe" crosses, each rank holds only its own stages (the others
    released), where only "data" crosses every stage."""
    cid = _pipe_id(case)
    ref = runs["local"][cid]
    for r, out in enumerate(runs["ranks"]):
        got = out["runs"][cid]
        _check_in_process(got, ref, case[1])
        L = len(ref["stages"])
        if "data" in case[0]:
            assert got["held"] == list(range(L)) and got["meta"] == []
        else:
            assert 0 < len(got["held"]) < L
            assert sorted(got["held"] + got["meta"]) == list(range(L))


@pytest.mark.parametrize("virtual", [1, 2], ids=["gpipe", "interleaved"])
def test_spmd_pipeline_across_processes(runs, virtual):
    """``spmd_pipeline`` with its two pipe positions on the two ranks:
    the outputs on both ranks bit for bit the in-process ones, the
    gradients of the stacked weights and of the input within rounding
    (the reverse schedule adds the microbatches' gradients in another
    order than autograd's one graph)."""
    a, b = (r["spmd"][virtual] for r in runs["ranks"])
    ref = runs["local"]["spmd"][virtual]
    for k in ("out", "w", "x"):
        assert np.array_equal(a[k], b[k]), k
    assert np.array_equal(a["out"], ref["out"])
    for k in ("w", "x"):
        np.testing.assert_allclose(a[k], ref[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_train_model_pipe_across_processes_stops_at_snapshot(runs):
    """``train_model`` at {"pipe": 2} across the ranks trains its two
    batches with equal losses on both ranks, then the first snapshot
    refuses the packed rows sharded over "pipe" across the ranks, as
    JAX's ``device_get`` refuses them."""
    a, b = (out["train_pipe"] for out in runs["ranks"])
    for out in (a, b):
        msg = out["error"]
        assert msg is not None and "sharded over 'pipe' across " \
            "processes" in msg, msg
        assert "Fetching value for jax.Array that spans non-addressable" \
            in msg
        assert len(out["losses"]) == 2 and out["snapshots"] == []
    assert a["losses"] == b["losses"]


def test_pipe_with_model_refused_as_in_jax(runs):
    """A pipeline composed with "model" is refused on both ranks with the
    JAX loop's message (``tnn_tpu/train/loop.py:142-144``)."""
    for out in runs["ranks"]:
        msg = out["refusals"]["pipe_model"]
        assert msg is not None and msg.startswith(
            "pipeline runs compose with 'data' only"), msg


def test_independent_replicas_without_mesh_axes(runs):
    a, b = (out["replica"] for out in runs["ranks"])
    assert any(not np.array_equal(a[k], b[k]) for k in a)
    for got, ref in zip((a, b), runs["replicas"]):
        _assert_same(got, ref)


def test_choose_backend_and_outside_a_group():
    from tnn_tpu_torch.parallel import process_group as pg

    assert pg.choose_backend([["cpu"], ["cpu"]])[0] == "gloo"
    assert pg.choose_backend([["GPU-a"], ["GPU-b"]]) == (
        "nccl", "every rank holds a card of its own")
    assert pg.choose_backend([["GPU-a"], ["GPU-a"]])[1].startswith(
        "ranks share a card")
    assert pg.choose_backend([["GPU-a", "GPU-b"], ["GPU-c"]])[0] == "gloo"
    assert not pg.is_initialized()
    assert (pg.process_index(), pg.process_count()) == (0, 1)
    d = pg.assert_equal(np.zeros(3, np.float32), "x")
    assert d == pg.digest(np.zeros(3, np.float32))
    assert d != pg.digest(np.zeros(3, np.float64))
    assert d != pg.digest(np.zeros((1, 3), np.float32))
    import torch

    assert pg.digest(torch.zeros(3)) == pg.digest(torch.zeros(3))
    assert pg.digest(torch.zeros(3, dtype=torch.bfloat16)) != \
        pg.digest(torch.zeros(3))


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    rank_main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
