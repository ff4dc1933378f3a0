"""The port's control plane (``tnn_tpu_torch.distributed``,
``cli.dist_worker``) against the JAX package's.

The classes of ``tests/test_distributed.py`` run against the port: the
coordinator and its workers as threads of this process over loopback,
the same framed protocol as a multi-process run. Then the two packages
drive each other on either transport (Python or native, on each side),
``pack`` gives both packages' bytes, the worker CLI trains in a process
of its own, two workers with ``jax_coordinator`` train one model over a
process group (at {"data": 2}, and at {"fsdp": 2} up to the snapshot
that JAX's loop refuses as well), and the worker's synthetic loader
draws JAX's batches.
"""
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from tnn_tpu_torch import native
from tnn_tpu_torch.distributed import Command, Coordinator, Worker, protocol
from tnn_tpu_torch.distributed.transport import (NativeTransport, PyTransport,
                                                 make_transport)
from tnn_tpu_torch.profiling import EventType, GlobalProfiler

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _spawn_worker(port, results, name="w", worker_cls=Worker, **kw):
    def run():
        w = worker_cls("127.0.0.1", port, **kw).start()
        results[name] = w
        w.join(timeout=30)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def _await_workers(results, n, timeout=60.0):
    """wait_for_workers returns when the coordinator saw the handshake,
    which can be before the worker thread stores its Worker: wait for
    both."""
    deadline = time.monotonic() + timeout
    while len(results) < n:
        assert time.monotonic() < deadline, \
            f"only {len(results)}/{n} registered"
        time.sleep(0.01)
    return list(results.values())


class TestProtocol:
    def test_handshake_config_barrier_shutdown(self):
        with Coordinator(num_workers=2) as coord:
            res = {}
            t1 = _spawn_worker(coord.port(), res, "a", heartbeat_interval=0.2)
            t2 = _spawn_worker(coord.port(), res, "b", heartbeat_interval=0.2)
            assert coord.wait_for_workers(timeout=60) == [0, 1]
            _await_workers(res, 2)
            coord.deploy_config({"model": "x", "ranks": {"0": {}, "1": {}}},
                                timeout=60)
            assert all(w.config["model"] == "x" for w in res.values())
            done = []

            def at_barrier(w):
                w.barrier("sync1", timeout=60)
                done.append(w.rank)

            bts = [threading.Thread(target=at_barrier, args=(w,))
                   for w in res.values()]
            for t in bts:
                t.start()
            coord.barrier("sync1", timeout=60)
            for t in bts:
                t.join(timeout=60)
            assert sorted(done) == [0, 1]
            coord.set_train_mode(False)
            time.sleep(0.3)
            assert all(not w.training for w in res.values())
            coord.shutdown()
            t1.join(timeout=60)
            t2.join(timeout=60)
            assert not any(w.running for w in res.values())

    def test_explicit_rank_request(self):
        with Coordinator(num_workers=1) as coord:
            res = {}
            t = _spawn_worker(coord.port(), res, rank=5)
            coord.wait_for_workers(timeout=60)
            assert _await_workers(res, 1)[0].rank == 5
            coord.shutdown()
            t.join(timeout=60)

    def test_profiling_rpc_merges_workers(self):
        with Coordinator(num_workers=1) as coord:
            res = {}
            t = _spawn_worker(coord.port(), res)
            coord.wait_for_workers(timeout=60)
            _await_workers(res, 1)
            GlobalProfiler.clear()
            GlobalProfiler.add_event(EventType.COMPUTE, 0.0, 1.0, "span-x")
            merged = coord.collect_profiles(timeout=60)
            assert any(e.name == "span-x" for e in merged.events)
            coord.clear_profiling()
            time.sleep(0.3)
            assert GlobalProfiler.events == []
            coord.shutdown()
            t.join(timeout=60)

    def test_custom_rpc(self):
        with Coordinator(num_workers=1) as coord:
            res = {}
            t = _spawn_worker(coord.port(), res)
            coord.wait_for_workers(timeout=60)
            w = _await_workers(res, 1)[0]
            w.on("add", lambda obj: {"sum": obj["a"] + obj["b"]})
            assert coord.send_custom(w.rank, {"name": "add", "a": 2, "b": 3})
            assert coord.recv_custom(timeout=60)["sum"] == 5
            w.send_custom({"name": "status", "ok": True})
            assert coord.recv_custom(timeout=60)["ok"] is True
            coord.shutdown()
            t.join(timeout=60)

    def test_save_rpc(self, tmp_path):
        with Coordinator(num_workers=1) as coord:
            res = {}
            t = _spawn_worker(coord.port(), res)
            coord.wait_for_workers(timeout=60)
            saved = []
            _await_workers(res, 1)[0].on_save = saved.append
            coord.save_all(str(tmp_path / "snap"), timeout=60)
            assert saved == [str(tmp_path / "snap")]
            coord.shutdown()
            t.join(timeout=60)


class TestFailureDetection:
    def test_disconnect_detected_and_callback_fires(self):
        failed = []
        with Coordinator(num_workers=2, on_failure=failed.append) as coord:
            res = {}
            t1 = _spawn_worker(coord.port(), res, "a")
            t2 = _spawn_worker(coord.port(), res, "b")
            coord.wait_for_workers(timeout=60)
            _await_workers(res, 2)
            victim = res["a"]
            victim._running = False
            victim._t.close()   # an abrupt death: no SHUTDOWN_ACK
            coord.wait_failed(victim.rank, timeout=60)
            assert failed == [victim.rank]
            coord.set_train_mode(False)   # skips the dead worker
            coord.shutdown()
            t1.join(timeout=60)
            t2.join(timeout=60)

    def test_heartbeat_timeout_detected(self):
        with Coordinator(num_workers=1, heartbeat_timeout=0.6) as coord:
            res = {}
            t = _spawn_worker(coord.port(), res, heartbeat_interval=60.0)
            coord.wait_for_workers(timeout=60)
            w = _await_workers(res, 1)[0]
            coord.wait_failed(w.rank, timeout=60)   # one beat, then silence
            coord.shutdown(timeout=2)
            t.join(timeout=60)


class TestRobustness:
    def test_rank_collision_assigns_free_rank(self):
        with Coordinator(num_workers=2) as coord:
            res = {}
            t1 = _spawn_worker(coord.port(), res, "a", rank=1)
            time.sleep(0.3)     # a registers first
            t2 = _spawn_worker(coord.port(), res, "b")
            assert coord.wait_for_workers(timeout=60) == [0, 1]
            _await_workers(res, 2)
            assert res["a"].rank == 1 and res["b"].rank == 0
            coord.shutdown()
            t1.join(timeout=60)
            t2.join(timeout=60)

    def test_barrier_releases_when_worker_dies(self):
        with Coordinator(num_workers=2, heartbeat_timeout=60) as coord:
            res = {}
            t1 = _spawn_worker(coord.port(), res, "a")
            t2 = _spawn_worker(coord.port(), res, "b")
            coord.wait_for_workers(timeout=60)
            _await_workers(res, 2)
            res["a"]._running = False
            res["a"]._t.close()     # dies before reaching the barrier
            done = []

            def arrive():
                res["b"].barrier("b", timeout=60)
                done.append(True)

            bt = threading.Thread(target=arrive, daemon=True)
            bt.start()
            coord.barrier("b", timeout=60)
            bt.join(timeout=60)
            assert done
            coord.shutdown(timeout=2)
            t1.join(timeout=60)
            t2.join(timeout=60)

    def test_mismatched_barrier_arrivals_not_lost(self):
        with Coordinator(num_workers=1) as coord:
            res = {}
            t = _spawn_worker(coord.port(), res)
            coord.wait_for_workers(timeout=60)
            w = _await_workers(res, 1)[0]
            order = []

            def go():
                w.barrier("second", timeout=60)
                order.append("released")

            bt = threading.Thread(target=go, daemon=True)
            bt.start()
            time.sleep(0.3)     # the "second" arrival lands first
            coord.barrier("second", timeout=60)
            bt.join(timeout=60)
            assert order == ["released"]
            coord.shutdown()
            t.join(timeout=60)

    def test_dead_arrival_cannot_release_barrier_for_absent_worker(self):
        """A arrives, B arrives then dies, C never arrives: no release
        until C arrives."""
        with Coordinator(num_workers=3, heartbeat_timeout=600) as coord:
            res = {}
            ts = [_spawn_worker(coord.port(), res, n) for n in "abc"]
            coord.wait_for_workers(timeout=60)
            _await_workers(res, 3)
            wa, wb, wc = res["a"], res["b"], res["c"]
            released = []

            def arrive(w):
                try:
                    w.barrier("gate", timeout=30)
                    released.append(w.rank)
                except TimeoutError:
                    pass

            ta = threading.Thread(target=arrive, args=(wa,), daemon=True)
            tb = threading.Thread(target=arrive, args=(wb,), daemon=True)
            ta.start()
            tb.start()
            time.sleep(0.4)
            wb._running = False
            wb._t.close()
            deadline = time.monotonic() + 10
            while wb.rank not in coord.failed_workers():
                assert time.monotonic() < deadline
                time.sleep(0.05)
            with pytest.raises(TimeoutError):
                coord.barrier("gate", timeout=1.5)
            assert released == []
            tc = threading.Thread(target=arrive, args=(wc,), daemon=True)
            tc.start()
            coord.barrier("gate", timeout=60)
            ta.join(timeout=60)
            tc.join(timeout=60)
            assert sorted(released) == sorted([wa.rank, wc.rank])
            coord.shutdown(timeout=2)
            for t in ts:
                t.join(timeout=60)

    def test_unknown_command_does_not_kill_pump(self):
        with Coordinator(num_workers=1) as coord:
            res = {}
            t = _spawn_worker(coord.port(), res)
            coord.wait_for_workers(timeout=60)
            w = _await_workers(res, 1)[0]
            w._t.send(w._conn, 999, b'{"x": 1}')
            time.sleep(0.3)
            assert coord._pump.is_alive()
            w.on("ping", lambda obj: {"pong": 1})
            coord.send_custom(w.rank, {"name": "ping"})
            assert coord.recv_custom(timeout=60)["pong"] == 1
            coord.shutdown()
            t.join(timeout=60)

    def test_save_all_without_handler_raises(self, tmp_path):
        with Coordinator(num_workers=1) as coord:
            res = {}
            t = _spawn_worker(coord.port(), res)
            coord.wait_for_workers(timeout=60)
            _await_workers(res, 1)
            with pytest.raises(RuntimeError, match="did not save"):
                coord.save_all(str(tmp_path / "nowhere"), timeout=60)
            coord.shutdown()
            t.join(timeout=60)

    def test_failed_worker_can_rejoin(self):
        failed = []
        with Coordinator(num_workers=2, on_failure=failed.append) as coord:
            res = {}
            t1 = _spawn_worker(coord.port(), res, "a")
            t2 = _spawn_worker(coord.port(), res, "b")
            coord.wait_for_workers(timeout=60)
            _await_workers(res, 2)
            dead = res["a"].rank
            res["a"]._running = False
            res["a"]._t.close()
            coord.wait_failed(dead, timeout=60)
            res2 = {}
            t3 = _spawn_worker(coord.port(), res2, "a2", rank=dead)
            assert _await_workers(res2, 1)[0].rank == dead
            coord.wait_alive(dead, timeout=60)
            coord.shutdown()
            for t in (t1, t2, t3):
                t.join(timeout=60)


class TestHandshakeStorm:
    def test_simultaneous_connects_all_get_acks(self):
        """16 workers connect at once and each receives its
        HANDSHAKE_ACK."""
        n = 16
        with Coordinator(num_workers=n) as coord:
            res, errs = {}, []

            def run(i):
                try:
                    res[i] = Worker("127.0.0.1", coord.port(), rank=i,
                                    heartbeat_interval=5.0).start()
                except Exception as e:  # noqa: BLE001 — asserted below
                    errs.append((i, repr(e)))

            threads = [threading.Thread(target=run, args=(i,), daemon=True)
                       for i in range(n)]
            for t in threads:
                t.start()
            ranks = coord.wait_for_workers(timeout=90)
            for t in threads:
                t.join(timeout=60)
            assert not errs, errs
            assert ranks == list(range(n)) and sorted(res) == ranks
            assert all(res[i].rank == i for i in res)
            coord.shutdown()


class TestTransportInterop:
    def test_python_worker_native_coordinator(self):
        coord = Coordinator(num_workers=1)  # native where it is built
        try:
            res = {}

            def run():
                w = Worker("127.0.0.1", coord.port(),
                           transport=PyTransport(listen_port=None)).start()
                res["w"] = w
                w.barrier("x", timeout=60)
                w.join(timeout=60)

            t = threading.Thread(target=run, daemon=True)
            t.start()
            coord.wait_for_workers(timeout=60)
            coord.barrier("x", timeout=60)
            coord.shutdown()
            t.join(timeout=60)
            assert "w" in res
        finally:
            coord.close()

    def test_concurrent_large_sends_do_not_interleave(self):
        recv = PyTransport(listen_port=0)
        send = PyTransport(listen_port=None)
        try:
            conn = send.connect("127.0.0.1", recv.port())
            n_threads, frames_each, size = 4, 8, 256 * 1024

            def blast(tag):
                for _ in range(frames_each):
                    assert send.send(conn, tag, bytes([tag]) * size)

            threads = [threading.Thread(target=blast, args=(t,), daemon=True)
                       for t in range(1, n_threads + 1)]
            for t in threads:
                t.start()
            got = 0
            deadline = time.monotonic() + 30
            while got < n_threads * frames_each:
                assert time.monotonic() < deadline, f"only {got} frames"
                ev = recv.recv(timeout=1.0)
                if ev is None or ev[0] != "msg":
                    continue
                _, _, cmd, payload = ev
                assert payload == bytes([cmd]) * size
                got += 1
            for t in threads:
                t.join(timeout=60)
        finally:
            send.close()
            recv.close()

    def test_large_payload(self):
        """Frames beyond the native 64 KB receive buffer take the
        two-phase path."""
        with Coordinator(num_workers=1) as coord:
            res = {}
            t = _spawn_worker(coord.port(), res)
            coord.wait_for_workers(timeout=60)
            big = "x" * 300_000
            w = _await_workers(res, 1)[0]
            w.on("echo", lambda obj: {"blob": obj["blob"]})
            coord.send_custom(w.rank, {"name": "echo", "blob": big})
            assert coord.recv_custom(timeout=60)["blob"] == big
            coord.shutdown()
            t.join(timeout=60)

    def test_make_transport_picks_native_where_it_loads(self):
        t = make_transport(listen_port=None)
        try:
            want = NativeTransport if native.available() else PyTransport
            assert type(t) is want
        finally:
            t.close()
        t = make_transport(listen_port=None, prefer_native=False)
        assert type(t) is PyTransport
        t.close()


# -- the two packages against each other ---------------------------------------

jdist = pytest.importorskip("tnn_tpu.distributed")


def _transport(package, kind, listen):
    """A listening (coordinator) or connecting (worker) transport of
    ``package`` ("port" or "jax"), Python or native."""
    if package == "port":
        from tnn_tpu_torch.distributed import transport as mod
        lib = native
    else:
        from tnn_tpu import native as lib
        from tnn_tpu.distributed import transport as mod
    if kind == "native" and not lib.available():
        pytest.skip(f"the {package} package's native runtime is not built")
    cls = mod.NativeTransport if kind == "native" else mod.PyTransport
    return cls("", 0 if listen else None)


def _package(name):
    if name == "port":
        from tnn_tpu_torch import profiling
        return Coordinator, Worker, profiling.GlobalProfiler
    from tnn_tpu import profiling
    return jdist.Coordinator, jdist.Worker, profiling.GlobalProfiler


@pytest.mark.parametrize("worker_kind", ["py", "native"])
@pytest.mark.parametrize("coord_kind", ["py", "native"])
@pytest.mark.parametrize("coord_pkg,worker_pkg",
                         [("port", "jax"), ("jax", "port")])
def test_cross_package_exchange(tmp_path, coord_pkg, worker_pkg, coord_kind,
                               worker_kind):
    """One package's coordinator drives the other's worker through the
    handshake, a config over the compression threshold, a barrier, the
    profile merge, a save and the shutdown."""
    coord_cls, _, _ = _package(coord_pkg)
    _, worker_cls, worker_prof = _package(worker_pkg)
    coord = coord_cls(1, transport=_transport(coord_pkg, coord_kind, True))
    source = worker_prof.source
    worker_prof.source = "main"         # stamped "worker0" at the handshake
    try:
        res = {}
        t = _spawn_worker(coord.port(), res, worker_cls=worker_cls,
                          heartbeat_interval=0.2,
                          transport=_transport(worker_pkg, worker_kind,
                                               False))
        assert coord.wait_for_workers(timeout=60) == [0]
        w = _await_workers(res, 1)[0]
        assert (w.rank, w.world) == (0, 1)
        config = {"model_name": "flash_vit", "blob": "y" * 5000,
                  "ranks": {"0": {"batch_size": 8}}}
        coord.deploy_config(config, timeout=60)
        assert w.config == config
        arrived = threading.Thread(target=w.barrier, args=("sync",),
                                   kwargs={"timeout": 60}, daemon=True)
        arrived.start()
        coord.barrier("sync", timeout=60)
        arrived.join(timeout=60)
        assert not arrived.is_alive()
        worker_prof.clear()
        worker_prof.add_event(_event_type(worker_pkg), 0.0, 1.0,
                              "cross-span")
        merged = coord.collect_profiles(timeout=60)
        spans = [e for e in merged.events if e.name == "cross-span"]
        assert [e.source for e in spans] == ["worker0"]
        saved = []
        w.on_save = saved.append
        coord.save_all(str(tmp_path / "snap"), timeout=60)
        assert saved == [str(tmp_path / "snap")]
        coord.shutdown()
        t.join(timeout=60)
        assert not w.running
    finally:
        worker_prof.clear()
        worker_prof.source = source
        coord.close()


def _event_type(package):
    if package == "port":
        return EventType.COMPUTE
    from tnn_tpu.profiling import EventType as JaxEventType
    return JaxEventType.COMPUTE


@pytest.mark.parametrize("size", [100, 4096, 4097, 50_000])
def test_pack_bytes_equal_jax(size):
    """``pack`` gives the JAX package's bytes, raw up to 4,096 bytes of
    JSON and zlib past them; each package unpacks the other's."""
    from tnn_tpu.distributed import protocol as jproto

    obj = {"name": "cfg", "rank": 3, "blob": "z" * size, "f": 0.25,
           "nested": {"a": [1, 2, 3]}}
    got = protocol.pack(obj)
    assert got == jproto.pack(obj)
    assert got[:1] == (b"\x01" if len(json.dumps(obj)) > 4096
                       else b"\x00")
    assert protocol.unpack(jproto.pack(obj)) == obj
    assert jproto.unpack(got) == obj
    assert [(c.name, int(c)) for c in Command] == \
        [(c.name, int(c)) for c in jproto.Command]
    assert protocol.COMPRESS_THRESHOLD == jproto.COMPRESS_THRESHOLD


# -- cli.dist_worker ----------------------------------------------------------

def test_dist_worker_cli_trains_saves_and_exits(tmp_path):
    """``python -m tnn_tpu_torch.cli.dist_worker`` on the CPU: joins,
    trains mnist_cnn for a few steps between the barriers, serves a save
    that restores through ``Checkpoint``, exits 0 at the shutdown."""
    from tnn_tpu_torch.checkpoint import Checkpoint
    from tnn_tpu_torch.cli.trainer import create_model
    from tnn_tpu_torch.train import create_train_state
    from tnn_tpu_torch.utils.config import TrainingConfig

    config = {"model_name": "mnist_cnn", "dataset_name": "synthetic",
              "batch_size": 8, "epochs": 1, "max_steps": 6,
              "progress_print_interval": 2, "seed": 1,
              "ranks": {"0": {"snapshot_dir": str(tmp_path / "snaps")}}}
    with Coordinator(num_workers=1) as coord:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tnn_tpu_torch.cli.dist_worker",
             "--coordinator", f"127.0.0.1:{coord.port()}", "--rank", "0"],
            cwd=ROOT, env={**os.environ, "TNN_PLATFORM": "cpu"},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            assert coord.wait_for_workers(timeout=120) == [0]
            coord.deploy_config(config, timeout=60)
            coord.start_profiling()
            coord.barrier("start", timeout=120)
            coord.save_all(str(tmp_path / "mid"), timeout=120)
            coord.barrier("done", timeout=120)
            prof = coord.collect_profiles(timeout=60)
            coord.shutdown(timeout=60)
            out, _ = proc.communicate(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
    assert proc.returncode == 0, out
    assert "rank 0: trained 1 epochs" in out
    assert {e.source for e in prof.events} == {"worker0"}
    cfg = TrainingConfig().update({k: v for k, v in config.items()
                                   if k != "ranks"})
    model = create_model(cfg, (28, 28, 1), "cpu")
    state, meta = Checkpoint(str(tmp_path / "mid" / "rank0")).restore(
        create_train_state(model, cfg.make_optimizer()))
    assert 0 <= meta["step"] <= 6 and meta["model_config"]["type"]
    assert os.listdir(tmp_path / "snaps")    # train_model's own snapshot


def test_dist_worker_refuses_jax_coordinator(tmp_path):
    """Named for the refusal it replaced: ``cli.dist_worker`` now accepts
    ``jax_coordinator``. Two worker processes on the CPU join one gloo
    group there and train one ``{"data": 2}`` mnist_cnn (BatchNorm's
    statistics over the global batch) on the same MNIST file; both print
    the backend, exit 0, and their final parameters and statistics are
    equal bit for bit and moved from the initial ones."""
    import socket

    import torch

    from tnn_tpu_torch.checkpoint import Checkpoint
    from tnn_tpu_torch.cli.trainer import create_model
    from tnn_tpu_torch.train import create_train_state
    from tnn_tpu_torch.utils.config import TrainingConfig

    rng = np.random.default_rng(3)
    rows = np.concatenate([rng.integers(0, 10, (32, 1)),
                           rng.integers(0, 256, (32, 784))], axis=1)
    np.savetxt(tmp_path / "mnist_train.csv", rows, fmt="%d", delimiter=",")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        group_port = s.getsockname()[1]
    config = {"model_name": "mnist_cnn", "dataset_name": "mnist",
              "dataset_path": str(tmp_path), "batch_size": 8, "epochs": 1,
              "max_steps": 2, "mesh_axes": {"data": 2}, "seed": 1,
              "jax_coordinator": f"127.0.0.1:{group_port}",
              "ranks": {str(r): {"snapshot_dir": str(tmp_path / f"snap{r}")}
                        for r in (0, 1)}}
    env = {**os.environ, "TNN_PLATFORM": "cpu"}
    with Coordinator(num_workers=2) as coord:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "tnn_tpu_torch.cli.dist_worker",
             "--coordinator", f"127.0.0.1:{coord.port()}", "--rank", str(r)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
        try:
            assert coord.wait_for_workers(timeout=120) == [0, 1]
            coord.deploy_config(config, timeout=60)
            coord.barrier("start", timeout=180)
            coord.barrier("done", timeout=180)
            coord.shutdown(timeout=60)
            outs = [p.communicate(timeout=60)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert f"rank {r}: process group of 2 over gloo (ranks on the " \
            "CPU)" in out, out
    cfg = TrainingConfig().update({k: v for k, v in config.items()
                                   if k in TrainingConfig.__dataclass_fields__})
    states = []
    for r in (0, 1):
        model = create_model(cfg, (28, 28, 1), "cpu")
        state, meta = Checkpoint(str(tmp_path / f"snap{r}")).restore(
            create_train_state(model, cfg.make_optimizer()))
        assert meta["step"] == 2
        states.append(state)
    start = create_model(cfg, (28, 28, 1), "cpu")
    for n, p in dict(start.named_parameters()).items():
        assert torch.equal(states[0].params[n], states[1].params[n]), n
    assert any(not torch.equal(states[0].params[n], p) for n, p in
               start.named_parameters())
    for n, b in states[0].buffers.items():
        assert torch.equal(b, states[1].buffers[n]), n


def test_dist_worker_jax_coordinator_fsdp_stops_at_snapshot(tmp_path):
    """Two worker processes with ``jax_coordinator`` train one mnist_cnn
    at ``{"fsdp": 2}`` across them (its large dense kernel sharded over
    the two ranks): both log the same losses for the steps they take,
    then the first snapshot refuses the leaf sharded across the ranks,
    as the JAX loop's ``device_get`` does, and both report it."""
    _stops_at_snapshot(tmp_path, {"fsdp": 2}, seed=4,
                       refusal="sharded over 'fsdp' across processes")


def test_dist_worker_jax_coordinator_pipe_stops_at_snapshot(tmp_path):
    """The same two workers at ``{"pipe": 2}``: mnist_cnn split into two
    stages, one a rank, the activations hopping between the processes;
    both log the same losses, then the first snapshot refuses the packed
    stage rows sharded over "pipe" across the ranks, as JAX's
    ``device_get`` refuses them."""
    _stops_at_snapshot(tmp_path, {"pipe": 2}, seed=5,
                       refusal="sharded over 'pipe' across processes")


def _stops_at_snapshot(tmp_path, mesh_axes, seed, refusal):
    import socket

    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, 10, (16, 1)),
                           rng.integers(0, 256, (16, 784))], axis=1)
    np.savetxt(tmp_path / "mnist_train.csv", rows, fmt="%d", delimiter=",")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        group_port = s.getsockname()[1]
    config = {"model_name": "mnist_cnn", "dataset_name": "mnist",
              "dataset_path": str(tmp_path), "batch_size": 8, "epochs": 1,
              "max_steps": 2, "mesh_axes": mesh_axes, "seed": 1,
              "progress_print_interval": 1,
              "jax_coordinator": f"127.0.0.1:{group_port}",
              "ranks": {str(r): {"snapshot_dir": str(tmp_path / f"snap{r}")}
                        for r in (0, 1)}}
    env = {**os.environ, "TNN_PLATFORM": "cpu"}
    with Coordinator(num_workers=2) as coord:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "tnn_tpu_torch.cli.dist_worker",
             "--coordinator", f"127.0.0.1:{coord.port()}", "--rank", str(r)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
        try:
            assert coord.wait_for_workers(timeout=120) == [0, 1]
            coord.deploy_config(config, timeout=60)
            coord.barrier("start", timeout=180)
            with pytest.raises(RuntimeError):
                coord.barrier("done", timeout=180)
            outs = [p.communicate(timeout=60)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
    losses = []
    crossing = next(iter(mesh_axes))
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode != 0, out
        assert refusal in out, out
        assert f"crossing: {crossing}" in out, out
        losses.append([line.split("loss=")[1].split()[0] for line in
                       out.splitlines() if "batch" in line and "loss=" in
                       line])
        assert not os.listdir(tmp_path / f"snap{r}") if \
            (tmp_path / f"snap{r}").exists() else True
    assert len(losses[0]) == 2 and losses[0] == losses[1]


def test_lm_deploy_ends_at_the_corpus_loader_in_both_workers(tmp_path):
    """Where a MoE or LM deploy ends in either package's worker: both
    hand ``train=True`` to the LM corpus loader (``factory.create``),
    which takes no such flag, so the deploy raises a ``TypeError`` there,
    before its model is built and before the "start" barrier."""
    from tnn_tpu.data import factory as jfactory

    from tnn_tpu_torch.data import factory

    (tmp_path / "train.bin").write_bytes(np.arange(64, dtype=np.uint16)
                                         .tobytes())
    for fac in (jfactory, factory):
        with pytest.raises(TypeError, match="train"):
            fac.create("openwebtext", str(tmp_path), train=True)


@pytest.mark.parametrize("model_name,rank", [("mnist_cnn", 0),
                                             ("cifar100_wrn16_8", 1),
                                             ("flash_vit", 2)])
def test_synthetic_loader_draws_jax_workers_batches(model_name, rank):
    """The worker's synthetic loader is the JAX worker's
    (``tnn_tpu/cli/dist_worker.py:118-123``): shape, classes, seed and
    the shuffled batches."""
    from tnn_tpu.data.loader import SyntheticDataLoader as JaxSynthetic

    from tnn_tpu_torch.cli.dist_worker import synthetic_loader
    from tnn_tpu_torch.utils.config import TrainingConfig

    cfg = TrainingConfig().update({"model_name": model_name,
                                   "batch_size": 4, "seed": 7})
    got = synthetic_loader(cfg, rank)
    shape = (28, 28, 1) if "mnist" in model_name else (32, 32, 3)
    ref = JaxSynthetic(20 * 4, shape, 100 if "100" in model_name else 10,
                       seed=7 + rank)
    np.testing.assert_array_equal(got.data, ref.data)
    np.testing.assert_array_equal(got.labels, ref.labels)
    got.shuffle()
    ref.shuffle()
    for _ in range(3):
        (a, la), (b, lb) = got.get_batch(4), ref.get_batch(4)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)


def test_dist_coordinator_cli_runs_a_worker_to_the_end(tmp_path):
    """``python -m tnn_tpu_torch.cli.dist_coordinator`` with one worker
    process: joins, deploys, both barriers, the merged Chrome trace, the
    shutdown; both exit 0."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "TNN_PLATFORM": "cpu"}
    config = {"model_name": "mnist_cnn", "dataset_name": "synthetic",
              "batch_size": 8, "epochs": 1, "max_steps": 2,
              "snapshot_dir": str(tmp_path / "snaps")}
    (tmp_path / "c.json").write_text(json.dumps(config))
    trace = tmp_path / "trace.json"
    coord = subprocess.Popen(
        [sys.executable, "-m", "tnn_tpu_torch.cli.dist_coordinator",
         "--num-workers", "1", "--port", str(port), "--bind", "127.0.0.1",
         "--config", f"@{tmp_path / 'c.json'}", "--profile-out", str(trace)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        first = coord.stdout.readline()     # the worker connects once it
        assert "listening on port" in first, first     # listens
        worker = subprocess.run(
            [sys.executable, "-m", "tnn_tpu_torch.cli.dist_worker",
             "--coordinator", f"127.0.0.1:{port}"], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=120)
        out, _ = coord.communicate(timeout=60)
        out = first + out
    finally:
        if coord.poll() is None:
            coord.kill()
    assert worker.returncode == 0, worker.stdout + worker.stderr
    assert coord.returncode == 0, out
    assert "all workers shut down" in out and "joined as rank 0/1" in \
        worker.stdout
    events = json.loads(trace.read_text())["traceEvents"]
    rows = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert rows == {"worker0"} and any(e["ph"] == "X" for e in events)
