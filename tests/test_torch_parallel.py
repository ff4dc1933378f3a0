"""Port parity: the mesh, the partitioner, data parallelism with FSDP and
the three pipelines (``tnn_tpu_torch.parallel``) against the JAX package
on its 8 virtual CPU devices, the port's mesh on 8 ``"cpu"`` positions.

- The partitioner's cut points equal JAX's (WRN-16-8, a builder LM at
  GPT-2 small's width).
- ``make_dp_train_step`` at data=8 and at data=2 x fsdp=4 (momentum
  SGD, leaves and their velocity sharded): the loss and the parameters after 2 steps within rtol 1e-5 /
  atol 1e-6, JAX's own DP bound; the spec tree equal to
  ``fsdp_spec_tree``'s; each sharded leaf and its moments held as shards.
- ``remat`` ("full", "dots") at data=2 with dropout 0.1 and grad_accum 2
  equals the same run without remat bit for bit: the recompute replays
  every replica's masks.
- A Dense -> BatchNorm -> Dense model whose two halves of the batch differ
  16x in scale: the loss and the running statistics of global-batch
  BatchNorm (JAX's DP is the single-device step), under grad_accum 1 and
  2, within 1e-5.
- ``spmd_pipeline`` and its interleaved form: outputs and gradients.
- ``HeteroPipeline`` on the conv + BatchNorm net at pp 2 and 4, v 1 and 2,
  data 2, remat, started from JAX's packed rows: FP32 loss within 1e-5,
  the gradients' rows within rtol 1e-4 of ``jax.grad`` of JAX's
  ``pipeline_loss`` (its train step's own per-device gradient is pp x
  data times that on this JAX version, which the test records), the new
  state rows within 1e-5, then one SGD step.
- ``StagePipeline``: BatchNorm stages, and a token-input LM, against
  JAX's; the compiled pipeline's token-input ValueError.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnn_tpu import nn as jnn
from tnn_tpu import parallel as jpar
from tnn_tpu.core import dtypes as jdt
from tnn_tpu.nn.builder import LayerBuilder as JBuilder
from tnn_tpu.train import step as jstep
from tnn_tpu_torch import parallel as tpar
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.core.module import config_module
from tnn_tpu_torch.nn import optimizers as topt
from tnn_tpu_torch.nn.builder import LayerBuilder as TBuilder
from tnn_tpu_torch.train import step as tstep

F32 = jdt.FP32
CPU8 = ["cpu"] * 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _port(jmodel, sample_shape, params, state=None):
    model = config_module(jmodel.get_config())
    model.init(sample_shape, device="cpu", seed=None)
    model.load_jax_params(_np(params))
    if state:
        model.load_jax_state(_np(state))
    return model


def _assert_params(model, jparams, rtol=1e-5, atol=1e-6):
    jparams = _np(jparams)
    for path, p in model.jax_param_paths():
        np.testing.assert_allclose(p.detach().numpy(), _leaf(jparams, path),
                                   rtol=rtol, atol=atol,
                                   err_msg="/".join(path))


# -- mesh and partitioner -----------------------------------------------------


def test_make_mesh_axes_and_devices():
    mesh = tpar.make_mesh(data=2, pipe=4, device="cpu")
    assert mesh.shape["data"] == 2 and mesh.shape["pipe"] == 4
    assert tpar.axis_size(mesh, "model") == 1
    assert mesh.size == 8 and set(mesh.device_list()) == {
        torch.device("cpu")}
    assert tpar.AXES == jpar.mesh.AXES
    with pytest.raises(ValueError, match="mesh needs 32 devices"):
        tpar.make_mesh(data=16, pipe=2, devices=CPU8)
    assert tpar.data_mesh(4, devices=CPU8).shape["data"] == 4
    info = tpar.local_mesh_info("cpu")
    assert info["platform"] == "cpu" and info["process_count"] == 1


def _wrn_config():
    from tnn_tpu.models import zoo

    return zoo.create("cifar100_wrn16_8", policy=F32)


def _lm(B, width=768, vocab=50257, seq=1024, layers=12):
    p = F32 if B is JBuilder else tdt.FP32
    b = B((seq,), policy=p).embedding(vocab, width).positional_embedding()
    for _ in range(layers):
        b = b.flash_gpt_block(width // 64)
    return b.layernorm().dense(vocab).build()


@pytest.mark.parametrize("stages", [2, 4, 8])
def test_partitioner_cut_points_match_jax(stages):
    jw = _wrn_config()
    tw = config_module(jw.get_config())
    shape = (8, 32, 32, 3)
    assert tpar.balanced_partitions(tw, stages, shape) == [
        tpar.SeqPartition(p.start, p.length)
        for p in jpar.balanced_partitions(jw, stages, shape)]
    jl, tl = _lm(JBuilder), _lm(TBuilder)
    assert [tuple(vars(p).values()) for p in tpar.balanced_partitions(
        tl, stages, (2, 1024))] == [
        tuple(vars(p).values())
        for p in jpar.balanced_partitions(jl, stages, (2, 1024))]
    for a, b in zip(tw.layers, jw.children):
        assert tpar.layer_flops(a, (8, 32, 32, 3)) == \
            jpar.partitioner.layer_flops(b, (8, 32, 32, 3))
        break
    assert [(p.start, p.length) for p in tpar.proportional_partitions(
        7, [1, 2, 1])] == [(p.start, p.length) for p in
                           jpar.partitioner.proportional_partitions(
                               7, [1, 2, 1])]
    split = tpar.partition_model(tw, stages, shape)
    assert [s.get_config() for s in split] == [
        s.get_config() for s in jpar.partition_model(jw, stages, shape)]


# -- data parallel ------------------------------------------------------------


def _mlp(units=32):
    return jnn.Sequential([jnn.Dense(units, activation="relu", policy=F32),
                           jnn.Dense(units, activation="relu", policy=F32),
                           jnn.Dense(4, policy=F32)], policy=F32)


def _batch(n=16, width=8, classes=4, seed=0):
    x = np.random.RandomState(seed).randn(n, width).astype(np.float32)
    y = np.random.RandomState(seed + 1).randint(0, classes, n).astype(
        np.int32)
    return x, y


def _dp_pair(jmodel, jopt, topt_, mesh_kw, fsdp, x, y, steps=2, **kw):
    """Both packages' DP runs from JAX's initial state: (JAX state,
    metrics, port model, port state, metrics)."""
    jstate = jstep.create_train_state(jmodel, jopt, jax.random.PRNGKey(0),
                                      x.shape, input_dtype=jnp.float32)
    start = _np(jstate.params), _np(jstate.net_state)
    jmesh = jpar.make_mesh(**mesh_kw)
    step, place_state, place_batch = jpar.make_dp_train_step(
        jmodel, jopt, jmesh, fsdp=fsdp, donate=False, **kw)
    jstate = place_state(jstate)
    jm = []
    for _ in range(steps):
        jstate, m = step(jstate, *place_batch(jnp.asarray(x),
                                              jnp.asarray(y)))
        jm.append(float(m["loss"]))
    model = _port(jmodel, x.shape[1:], *start)
    tmesh = tpar.make_mesh(**mesh_kw, devices=CPU8)
    tstate = tstep.create_train_state(model, topt_)
    tstep_fn, tplace, tbatch = tpar.make_dp_train_step(
        model, topt_, tmesh, fsdp=fsdp, **kw)
    tstate = tplace(tstate)
    tm = []
    for _ in range(steps):
        tstate, m = tstep_fn(tstate, *tbatch(torch.from_numpy(x),
                                             torch.from_numpy(y).long()))
        tm.append(float(m["loss"]))
    # sharded leaves live in the layout's pieces during the run
    tstate.layout.write_back()
    return jstate, jm, model, tstate, tm


@pytest.mark.parametrize("mesh_kw,fsdp", [
    ({"data": 8}, False), ({"data": 2, "fsdp": 4}, True)])
def test_dp_matches_jax(mesh_kw, fsdp):
    if fsdp:
        jmodel = jnn.Sequential([jnn.Dense(512, policy=F32),
                                 jnn.Dense(512, activation="relu",
                                           policy=F32),
                                 jnn.Dense(4, policy=F32)], policy=F32)
        jopt = jnn.SGD(lr=0.05, momentum=0.9)
        opt = topt.SGD(lr=0.05, momentum=0.9)
        x, y = _batch(width=512)
    else:
        jmodel, jopt, opt = _mlp(), jnn.SGD(lr=0.1), topt.SGD(lr=0.1)
        x, y = _batch()
    jstate, jm, model, tstate, tm = _dp_pair(jmodel, jopt, opt, mesh_kw,
                                             fsdp, x, y)
    np.testing.assert_allclose(tm, jm, rtol=1e-5)
    _assert_params(model, jstate.params)
    lay = tstate.layout
    if fsdp:
        # the two 512 x 512 kernels shard; their moments follow
        sharded = lay.sharded_names()
        assert len(sharded) == 2
        for name in sharded:
            shards = lay.owned[name]
            assert [tuple(s.shape) for s in shards.values()] == [
                (128, 512)] * 4
            assert tuple(tstate.opt_state["velocity"][name]["0"].shape) \
                == (128, 512)
        trees = tstep.train_state_trees(tstate)
        jm_tree = _np(jstate.opt_state["velocity"])
        for path in (("00_dense", "kernel"), ("01_dense", "kernel")):
            np.testing.assert_allclose(
                _leaf(trees["opt_state"]["velocity"], path).numpy(),
                _leaf(jm_tree, path), rtol=1e-5, atol=1e-6)
    # every position holds the owned copy of each replicated leaf and its
    # own piece of each sharded one
    for c in lay.coords:
        for name, own in lay.owned.items():
            want = own if lay.axis[name] is None else \
                own[str(lay.piece_of(name, c))]
            assert torch.equal(lay.held[c][name], want)


def test_fsdp_spec_tree_matches_jax():
    jmodel = jnn.Sequential([jnn.Dense(512, policy=F32),
                             jnn.Dense(300, policy=F32),
                             jnn.Dense(7, policy=F32)], policy=F32)
    v = jmodel.init(jax.random.PRNGKey(0), (2, 384))
    for kw in ({"data": 2, "fsdp": 4}, {"fsdp": 8}, {"data": 8}):
        want = jpar.data_parallel.fsdp_spec_tree(v["params"],
                                                 jpar.make_mesh(**kw))
        got = tpar.fsdp_spec_tree(_np(v["params"]),
                                  tpar.make_mesh(**kw, devices=CPU8))
        flat = jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
        for path, spec in flat[0]:
            assert _leaf(got, [k.key for k in path]) == tuple(spec)
    placed = tpar.shard_params_fsdp(
        _np(v["params"]), tpar.make_mesh(data=2, fsdp=4, devices=CPU8))
    assert [tuple(t.shape) for t in placed["00_dense"]["kernel"]] == [
        (96, 512)] * 8
    assert [tuple(t.shape) for t in placed["02_dense"]["kernel"]] == [
        (300, 7)] * 8


def _bn_model():
    return jnn.Sequential([jnn.Dense(16, use_bias=False, policy=F32),
                           jnn.BatchNorm(policy=F32),
                           jnn.Dense(4, policy=F32)], policy=F32)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_dp_batchnorm_uses_global_batch_statistics(grad_accum):
    """The shards differ 16x in scale: per-replica statistics would move
    the running statistics and the loss far from JAX's global ones."""
    x, y = _batch()
    x[8:] *= 16.0
    jstate, jm, model, tstate, tm = _dp_pair(
        _bn_model(), jnn.SGD(lr=0.1), topt.SGD(lr=0.1), {"data": 2},
        False, x, y, grad_accum=grad_accum)
    np.testing.assert_allclose(tm, jm, rtol=1e-5)
    want = _np(jstate.net_state)
    for path, buf in model.jax_state_paths():
        np.testing.assert_allclose(buf.numpy(), _leaf(want, path),
                                   rtol=1e-5, atol=1e-6)
    _assert_params(model, jstate.params)


def test_dp_refusals():
    """What the parallel step still refuses: a pipe axis (the pipelines'
    layout), heads that do not split over "model", a sequence that does
    not split over "seq", and the chunked head loss with accuracy."""
    from tnn_tpu_torch.models.gpt2 import GPT2

    model = config_module(_mlp().get_config()).init((8,), device="cpu")
    with pytest.raises(ValueError, match="pipe axis"):
        tpar.make_dp_train_step(model, topt.SGD(),
                                tpar.make_mesh(data=2, pipe=2, devices=CPU8))
    gpt = GPT2(vocab_size=32, max_len=8, num_layers=1, d_model=16,
               num_heads=2, policy=tdt.FP32, device="cpu")
    _, place_state, _ = tpar.make_dp_train_step(
        gpt, topt.SGD(), tpar.make_mesh(model=4, devices=CPU8), tp=True)
    with pytest.raises(ValueError, match="whole heads"):
        place_state(tstep.create_train_state(gpt, topt.SGD()))
    step, place_state, place_batch = tpar.make_dp_train_step(
        gpt, topt.SGD(), tpar.make_mesh(seq=3, devices=CPU8))
    state = place_state(tstep.create_train_state(gpt, topt.SGD()))
    ids = torch.zeros(2, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="not divisible by the seq"):
        step(state, ids, ids)
    with pytest.raises(ValueError, match="compute_accuracy=False"):
        tpar.make_dp_train_step(gpt, topt.SGD(),
                                tpar.make_mesh(data=2, devices=CPU8),
                                lm_head_chunk=8)


def _dropout_mlp():
    return jnn.Sequential([jnn.Dense(32, activation="relu", policy=F32),
                           jnn.Dropout(0.1, policy=F32),
                           jnn.Dense(32, activation="relu", policy=F32),
                           jnn.Dropout(0.1, policy=F32),
                           jnn.Dense(4, policy=F32)], policy=F32)


def _dp_dropout_run(remat, steps=2):
    model = config_module(_dropout_mlp().get_config()).init(
        (8,), device="cpu", seed=0)
    opt = topt.SGD(lr=0.1)
    step, place_state, place_batch = tpar.make_dp_train_step(
        model, opt, tpar.make_mesh(data=2, devices=CPU8), grad_accum=2,
        remat=remat)
    state = place_state(tstep.create_train_state(model, opt, seed=3))
    x, y = _batch()
    losses = []
    for _ in range(steps):
        state, m = step(state, *place_batch(torch.from_numpy(x),
                                            torch.from_numpy(y).long()))
        losses.append(float(m["loss"]))
    return losses, torch.cat([p.detach().flatten()
                              for p in model.parameters()])


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_dp_remat_with_dropout_equals_no_remat_bit_for_bit(remat):
    base_losses, base_params = _dp_dropout_run(False)
    losses, params = _dp_dropout_run(remat)
    assert losses == base_losses and torch.equal(params, base_params)


# -- homogeneous pipelines -----------------------------------------------------


def _stacked(n, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(n, d, d)).astype(np.float32) * 0.3,
            "b": rng.normal(size=(n, d)).astype(np.float32) * 0.1}


@pytest.mark.parametrize("virtual,num_mb", [(1, 3), (2, 4)])
def test_spmd_pipelines_match_jax(virtual, num_mb):
    pp = 4
    params = _stacked(virtual * pp)
    x = np.random.default_rng(1).normal(size=(num_mb, 2, 8)).astype(
        np.float32)

    def jblock(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    def tblock(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    jmesh = jpar.make_mesh(pipe=pp)
    tmesh = tpar.make_mesh(pipe=pp, devices=CPU8)

    def jloss(ps):
        if virtual == 1:
            out = jpar.spmd_pipeline(jblock, ps, jnp.asarray(x), jmesh)
        else:
            out = jpar.spmd_pipeline_interleaved(
                jblock, ps, jnp.asarray(x), jmesh, virtual=virtual)
        return jnp.sum(out ** 2), out

    (jl, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    tparams = {k: torch.tensor(v, requires_grad=True)
               for k, v in params.items()}
    if virtual == 1:
        tout = tpar.spmd_pipeline(tblock, tparams, torch.from_numpy(x),
                                  tmesh)
    else:
        tout = tpar.spmd_pipeline_interleaved(
            tblock, tparams, torch.from_numpy(x), tmesh, virtual=virtual)
    (tout ** 2).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    for k in params:
        np.testing.assert_allclose(tparams[k].grad.numpy(),
                                   np.asarray(jgrad[k]), rtol=1e-4,
                                   atol=1e-5)
    stacked = tpar.stack_stage_params([{"w": torch.zeros(2)},
                                       {"w": torch.ones(2)}])
    assert tuple(stacked["w"].shape) == (2, 2)


def test_interleaved_pipeline_validates():
    mesh = tpar.make_mesh(pipe=2, devices=CPU8)
    p = {k: torch.tensor(v) for k, v in _stacked(4).items()}
    with pytest.raises(ValueError, match="divisible by pipe"):
        tpar.spmd_pipeline_interleaved(lambda a, h: h, p,
                                       torch.zeros(3, 2, 8), mesh)
    with pytest.raises(ValueError, match="leading dim"):
        tpar.spmd_pipeline_interleaved(lambda a, h: h, p,
                                       torch.zeros(4, 2, 8), mesh,
                                       virtual=3)


# -- heterogeneous pipeline ---------------------------------------------------


def _conv_bn_net(mod, policy):
    if mod is jnn:
        return jnn.Sequential([
            jnn.Conv2D(8, 3, padding="same", use_bias=False, policy=policy),
            jnn.BatchNorm(policy=policy), jnn.Activation("relu",
                                                         policy=policy),
            jnn.Conv2D(16, 3, strides=2, padding="same", use_bias=False,
                       policy=policy),
            jnn.BatchNorm(policy=policy), jnn.Activation("relu",
                                                         policy=policy),
            jnn.GlobalAvgPool(policy=policy), jnn.Dense(10, policy=policy),
        ], name="convbn", policy=policy)
    return config_module(_conv_bn_net(jnn, F32).get_config())


NUM_MB, MB = 4, 4


def _hetero_pair(pp, virtual, data, remat):
    jmodel = _conv_bn_net(jnn, F32)
    tmodel = _conv_bn_net(None, None)
    shape = (MB, 8, 8, 3)
    n = pp * virtual
    jstages = jpar.partition_model(jmodel, n, shape)
    tstages = tpar.partition_model(tmodel, n, shape)
    jmesh = jpar.make_mesh(data=data, pipe=pp)
    tmesh = tpar.make_mesh(data=data, pipe=pp, devices=CPU8)
    kw = dict(num_microbatches=NUM_MB, input_dtype=jnp.float32,
              data_axis="data" if data > 1 else None, remat=remat,
              virtual=virtual)
    jpipe, _, jinit = jpar.make_pipeline_train_step(
        jstages, jnn.SGD(lr=0.1), jmesh, shape, **kw)
    kw["input_dtype"] = torch.float32
    tpipe, tstep_fn, tinit = tpar.make_pipeline_train_step(
        tstages, topt.SGD(lr=0.1), tmesh, shape, **kw)
    jstate = jinit(jax.random.PRNGKey(0))
    # running statistics away from their init values (the rows' padding
    # stays zero)
    stage_vars = jpipe.unpack_stage_variables(jstate.params,
                                              jstate.net_state)
    for v in stage_vars:
        v["state"] = jax.tree.map(lambda a: a + 0.25, v["state"])
    jstate = jstate._replace(
        net_state=jpipe.pack_stage_variables(stage_vars)[1])
    tstate = tinit(None)
    tstep.load_jax_train_state(tstate, params=np.asarray(jstate.params),
                               net_state=np.asarray(jstate.net_state))
    return jpipe, jstate, tpipe, tstate, tstep_fn


@pytest.mark.parametrize("pp,virtual,data,remat", [
    (2, 1, 1, False), (4, 1, 1, False), (2, 2, 1, False),
    (2, 1, 2, False), (2, 1, 1, True)])
def test_hetero_pipeline_matches_jax(pp, virtual, data, remat):
    jpipe, jstate, tpipe, tstate, tstep_fn = _hetero_pair(pp, virtual, data,
                                                         remat)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(NUM_MB * MB, 8, 8, 3)).astype(np.float32)
    x[::2] *= 4.0
    y = rng.integers(0, 10, NUM_MB * MB).astype(np.int32)
    args = (jstate.net_state, jnp.asarray(x), jnp.asarray(y),
            jax.random.PRNGKey(1))
    with jpipe.mesh:
        jloss, jnew, jmet, jscaled = jax.jit(
            jpipe.pipeline_value_and_grad)(jstate.params, *args)
        jgrads = jax.jit(jax.grad(
            lambda p: jpipe.pipeline_loss(p, *args)[0]))(jstate.params)
    # the JAX train step's gradient (its per-device VJP) is pp x data
    # times the loss's on this JAX version: ROADMAP.md section 3
    np.testing.assert_allclose(np.asarray(jscaled),
                               pp * data * np.asarray(jgrads), rtol=1e-4,
                               atol=1e-6)
    loss, corr, mb_global = tpipe.schedule(torch.from_numpy(x),
                                           torch.from_numpy(y).long(), True)
    loss.backward()
    tpipe.clear_pending()
    grads = tpipe.reduce_grads()
    trees = tstate.layout._moment_trees(grads)
    grows = tpipe.pack_params(trees).numpy()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(
        float(jloss))
    np.testing.assert_allclose(grows, np.asarray(jgrads), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tpipe.pack_state().numpy(),
                               np.asarray(jnew), rtol=1e-5, atol=1e-6)
    assert float(corr) / (NUM_MB * mb_global) == pytest.approx(
        float(jmet["accuracy"]))
    # one step through the step function from the same rows: SGD moves the
    # params by lr x the same gradients
    tstep.load_jax_train_state(tstate, params=np.asarray(jstate.params),
                               net_state=np.asarray(jstate.net_state))
    tstate, m = tstep_fn(tstate, torch.from_numpy(x),
                         torch.from_numpy(y).long())
    want = np.asarray(jstate.params) - 0.1 * np.asarray(jgrads)
    np.testing.assert_allclose(tstep.train_state_trees(tstate)["params"]
                               .numpy(), want, rtol=1e-4, atol=1e-6)
    assert float(m["loss"]) == pytest.approx(float(jloss), rel=1e-5)


def test_hetero_pipeline_eval_and_rows_round_trip():
    jpipe, jstate, tpipe, tstate, _ = _hetero_pair(2, 1, 1, False)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(NUM_MB * MB, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, NUM_MB * MB).astype(np.int32)
    jm = jpar.make_pipeline_eval_step(jpipe)(jstate, jnp.asarray(x),
                                             jnp.asarray(y))
    tm = tpar.make_pipeline_eval_step(tpipe)(tstate, torch.from_numpy(x),
                                             torch.from_numpy(y).long())
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["corrects"]) == float(jm["corrects"])
    trees = tstep.train_state_trees(tstate)
    np.testing.assert_array_equal(trees["params"].numpy(),
                                  np.asarray(jstate.params))
    np.testing.assert_array_equal(trees["net_state"].numpy(),
                                  np.asarray(jstate.net_state))
    want = jpipe.unpack_stage_variables(jstate.params, jstate.net_state)
    got = tpipe.unpack_stage_variables(trees["params"], trees["net_state"])
    for a, b in zip(want, got):
        for (pa, la), (pb, lb) in zip(
                jax.tree_util.tree_flatten_with_path(_np(a))[0],
                jax.tree_util.tree_flatten_with_path(
                    jax.tree.map(np.asarray, b))[0]):
            assert [k.key for k in pa] == [k.key for k in pb]
            np.testing.assert_array_equal(la, lb)


def test_hetero_pipeline_refuses_token_input():
    lm = config_module(JBuilder((8,), policy=F32).embedding(20, 8)
                       .dense(20).build().get_config())
    stages = tpar.partition_model(lm, 2, (2, 8))
    with pytest.raises(ValueError, match="token-input"):
        tpar.HeteroPipeline(stages, tpar.make_mesh(pipe=2, devices=CPU8),
                            (2, 8), input_dtype=torch.int32)


# -- StagePipeline -------------------------------------------------------------


def _stage_pair(jmodel, shape, dtype, n_stages=2):
    jstages = jpar.partition_model(jmodel, n_stages, shape)
    jsp = jpar.StagePipeline(jstages, jnn.SGD(lr=0.1),
                             jnn.losses.get("softmax_cross_entropy"),
                             devices=jax.devices()[:n_stages])
    jsp.init(jax.random.PRNGKey(0), shape, input_dtype=dtype)
    tstages = [config_module(s.get_config()) for s in jstages]
    tsp = tpar.StagePipeline(tstages, topt.SGD(lr=0.1),
                             "softmax_cross_entropy",
                             devices=CPU8[:n_stages])
    tsp.init(shape, seed=None)
    for st, v in zip(tstages, jsp.variables):
        st.load_jax_params(_np(v["params"]))
        if v["state"]:
            st.load_jax_state(_np(v["state"]))
    return jsp, tsp


@pytest.mark.parametrize("kind", ["batchnorm", "tokens"])
def test_stage_pipeline_matches_jax(kind):
    rng = np.random.default_rng(5)
    if kind == "batchnorm":
        jmodel = _conv_bn_net(jnn, F32)
        shape, dtype = (8, 8, 8, 3), jnp.float32
        x = rng.normal(size=shape).astype(np.float32)
        y = rng.integers(0, 10, 8).astype(np.int32)
        tx = torch.from_numpy(x)
    else:
        jmodel = (JBuilder((8,), policy=F32).embedding(30, 16)
                  .positional_embedding().gpt_block(2).layernorm()
                  .dense(30).build())
        shape, dtype = (4, 8), jnp.int32
        x = rng.integers(0, 30, shape).astype(np.int32)
        y = rng.integers(0, 30, shape).astype(np.int32)
        tx = torch.from_numpy(x).long()
    jsp, tsp = _stage_pair(jmodel, shape, dtype)
    for _ in range(2):
        jl = jsp.train_batch(jnp.asarray(x), jnp.asarray(y),
                             num_microbatches=2)
        tl = tsp.train_batch(tx, torch.from_numpy(y).long(),
                             num_microbatches=2)
        assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    for st, v in zip(tsp.stages, jsp.variables):
        for path, p in st.jax_param_paths():
            np.testing.assert_allclose(p.detach().numpy(),
                                       _leaf(_np(v["params"]), path),
                                       rtol=1e-4, atol=1e-6)
        for path, b in st.jax_state_paths():
            np.testing.assert_allclose(b.numpy(),
                                       _leaf(_np(v["state"]), path),
                                       rtol=1e-5, atol=1e-6)
    out = tsp.forward(tx)
    np.testing.assert_allclose(out.numpy(), np.asarray(jsp.forward(
        jnp.asarray(x))), rtol=1e-4, atol=1e-5)
