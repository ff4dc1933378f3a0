#!/usr/bin/env python
"""Control-plane worker: trains as the coordinator's config says
(``tnn_tpu.cli.dist_worker``; parity: examples/tcp_worker.cpp).

    python -m tnn_tpu_torch.cli.dist_worker --coordinator host:5555 [--rank 0]

It joins a coordinator (``cli.dist_coordinator``, of either package),
takes the deployed ``TrainingConfig`` dict (``config["ranks"][str(rank)]``
overrides per rank), and runs ``train_model`` between the "start" and
"done" barriers on the card (``TNN_PLATFORM=cpu``: the CPU), while the
event loop answers profiling, save and health requests. A save request
is served on the training thread at ``train_model``'s next ``state_hook``
(the optimizer updates the parameters in place, so no other thread reads
a live state), into ``<path>/rank<r>`` (``checkpoint.Checkpoint``).
``dataset_name`` "synthetic" (or empty) trains on fixed random samples
(28 x 28 x 1 for an MNIST model, else 32 x 32 x 3; 100 classes where the
model's name holds "100", else 10; seeded ``seed + rank``).

Without ``jax_coordinator`` each worker trains its own replica. With it
(``"host:port"``, the JAX package's ``jax.distributed.initialize``
address), every rank joins one ``torch.distributed`` group there before
its model is built (``parallel.process_group.initialize``, rank 0 hosting
the store), on the device ``TNN_PLATFORM`` gives and with
``TNN_NUM_DEVICES`` positions of it (default 1), and a config's
``mesh_axes`` lay one model over every rank's positions: ``{"data": N}``
sums the step's gradients, BatchNorm statistics and metrics across the
ranks; "fsdp", "model", "seq" (with ``seq_parallel_method``) and
"expert" may cross the ranks too, alone or together, MoE models
included (``parallel.data_parallel``), and so may "pipe" (with
``num_microbatches`` and ``pipeline_virtual``; ``parallel.pipeline``),
composed with "data" only, as in JAX's loop. A run whose leaves (or
packed stage rows) are sharded across the ranks stops at its first
snapshot, which JAX's loop refuses as well. An LM corpus
(``dataset_name`` "openwebtext") fails at its loader, before the
"start" barrier, in both packages' workers: ``factory.create(...,
train=True)`` hands the loader a flag it does not take. The backend, printed on the worker's first lines, is NCCL where
every rank holds a card of its own and gloo where ranks share one or run
on the CPU. Every rank must load the same data: the step checks each
global batch equal across the ranks, as JAX's ``device_put`` does, so
"synthetic" data (seeded per rank) fails at the first step there, as it
does in the JAX package. The group shuts down after the "done" barrier.
A worker shut down before a config arrives (a rank that rejoined after
training) returns without joining a group.
"""
import argparse
import os
import threading
import time

from tnn_tpu_torch.cli import console_entry
from tnn_tpu_torch.distributed import Worker
from tnn_tpu_torch.utils.platform import apply_env_platform


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--coordinator", required=True, help="host:port")
    ap.add_argument("--rank", type=int, default=None)
    args = ap.parse_args(argv)
    host, port = args.coordinator.rsplit(":", 1)
    device = apply_env_platform()   # without a card this raises before joining

    w = Worker(host, int(port), rank=args.rank).start()
    print(f"joined as rank {w.rank}/{w.world}", flush=True)

    # on_save first: a SAVE_TO_FILE may arrive any time after the
    # handshake, while this process still builds its model. The request
    # is queued and served by the training thread at its next state_hook,
    # never here: the optimizer updates the state's tensors in place
    pending = []
    pending_lock = threading.Lock()
    final = {}
    model_ref = {}

    def _save_to(path, st):
        from tnn_tpu_torch.checkpoint import Checkpoint

        # rank-qualified: ranks saving the same step to one shared
        # directory would race on its files
        Checkpoint(os.path.join(path, f"rank{w.rank}")).save(
            st, model=model_ref.get("model"))

    def state_hook(st):
        with pending_lock:
            reqs, pending[:] = pending[:], []
        for req in reqs:
            try:
                _save_to(req["path"], st)
            except Exception as e:  # noqa: BLE001 — sent back as ok: False
                req["err"] = str(e)
            req["done"].set()

    def on_save(path):
        # the final-state check and the append are atomic with the
        # set-final-then-drain below (one lock): no request is stranded
        # between the end of training and the drain
        with pending_lock:
            st = final.get("state")
            if st is None:
                req = {"path": path, "done": threading.Event(), "err": None}
                pending.append(req)
        if st is not None:      # training is over: nothing steps the state
            _save_to(path, st)
            return
        # hook firings can be minutes apart around an evaluation; the
        # worker's event loop is not blocked meanwhile (saves are served on
        # a thread of their own)
        if not req["done"].wait(timeout=600):
            raise RuntimeError("save not serviced within 600s "
                               "(training thread stalled?)")
        if req["err"]:
            raise RuntimeError(req["err"])

    w.on_save = on_save

    while w.config is None and w.running:
        time.sleep(0.05)
    if w.config is None:
        # shut down (or the coordinator lost) before a config came: a rank
        # that rejoined after training has nothing to run
        print(f"rank {w.rank}: shut down before a config arrived",
              flush=True)
        w.close()
        return None, []
    config = dict(w.config)
    per_rank = (config.pop("ranks", {}) or {}).get(str(w.rank), {})
    config.update(per_rank)
    grouped = bool(config.get("jax_coordinator"))
    if grouped:
        from tnn_tpu_torch.parallel import process_group

        local = int(os.environ.get("TNN_NUM_DEVICES", "0") or 0) or 1
        backend = process_group.initialize(
            config["jax_coordinator"], num_processes=w.world,
            process_id=w.rank, device=device, local_devices=[device] * local)
        print(f"rank {w.rank}: process group of {w.world} over {backend} "
              f"({process_group.backend_reason()}), {local} position(s) "
              f"on {device}", flush=True)
    try:
        out = _train(w, config, device, state_hook, pending_lock, final,
                     model_ref)
    except BaseException as e:
        w.report_error(f"{type(e).__name__}: {e}")
        w.close()
        raise
    finally:
        if grouped:
            process_group.shutdown()
    w.join(timeout=60)
    return out


def _train(w, config, device, state_hook, pending_lock, final, model_ref):
    """Build the model and loader, train between the "start" and "done"
    barriers."""
    from tnn_tpu_torch.cli.trainer import create_model
    from tnn_tpu_torch.train import train_model
    from tnn_tpu_torch.utils.config import TrainingConfig

    known = set(TrainingConfig.__dataclass_fields__)
    cfg = TrainingConfig().update({k: v for k, v in config.items()
                                   if k in known})
    if cfg.dataset_name in ("", "synthetic"):
        loader = synthetic_loader(cfg, w.rank)
    else:
        from tnn_tpu_torch.data import factory

        loader = factory.create(cfg.dataset_name, cfg.dataset_path,
                                train=True)
    model = create_model(cfg, loader.data_shape, device)
    model_ref["model"] = model

    w.barrier("start", timeout=600)
    state, history = train_model(model, cfg, loader, state_hook=state_hook)
    with pending_lock:
        final["state"] = state
    state_hook(state)   # requests that raced with the end of training
    print(f"rank {w.rank}: trained {len(history)} epochs, "
          f"final loss {history[-1]['train_loss']:.4f}", flush=True)
    w.barrier("done", timeout=600)
    return state, history


def synthetic_loader(cfg, rank):
    """The fixed random samples of ``dataset_name`` "synthetic" for
    ``rank`` (the module docstring)."""
    from tnn_tpu_torch.data.loader import SyntheticDataLoader

    shape = (28, 28, 1) if "mnist" in cfg.model_name else (32, 32, 3)
    return SyntheticDataLoader(20 * cfg.batch_size, shape,
                               100 if "100" in cfg.model_name else 10,
                               seed=cfg.seed + rank)


cli = console_entry(main)


if __name__ == "__main__":
    main()
