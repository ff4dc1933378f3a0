#!/usr/bin/env python
"""Train a zoo model from a config (``tnn_tpu.cli.trainer``).

Layers of config, as in the JAX package: defaults <- ``.env`` and the
environment <- ``--config`` JSON <- flags. The model runs on the card;
``TNN_PLATFORM=cpu`` runs it on the CPU (``utils.platform``).

    python -m tnn_tpu_torch.cli.trainer --model cifar100_wrn16_8 \\
        --dataset cifar100 --data-path data/cifar100 --epochs 20 \\
        --batch-size 128

A vision model is sized for the loader's samples and its weights drawn
from the config's seed; an LM (``--model gpt2_tiny``) trains on a token
file with ``--dataset openwebtext --data-path DIR/train.bin`` (1024-token
windows, ``DIR/val.bin`` validating). ``--dataset synthetic`` trains on
fixed random data. Snapshots (``best/`` and per epoch) go to the config's
``snapshot_dir``; ``cli.inferencer`` reads their ``state.tnn``.

``--mesh`` lays the run out over a mesh (``train.loop``): data, fsdp,
model, seq (``--seq-parallel-method ring`` or ``ulysses``) and expert, or
pipe with data (``--num-microbatches``, ``--pipeline-virtual``);
``--mesh-devices`` names its devices, a card as often as it holds
positions. The README's pipelined WRN on one card:

    python -m tnn_tpu_torch.cli.trainer --model cifar100_wrn16_8 \
        --dataset cifar100 --data-path data/cifar100 --mesh data=2,pipe=4 \
        --num-microbatches 8 --pipeline-virtual 2 \
        --mesh-devices cuda:0,cuda:0,cuda:0,cuda:0,cuda:0,cuda:0,cuda:0,cuda:0

Positions that share a card run every code path of the layout; they
measure no interconnect.
"""
from __future__ import annotations

import argparse
import json
import os
import platform as host_platform

import torch

from tnn_tpu_torch.cli import console_entry
from tnn_tpu_torch.data import factory
from tnn_tpu_torch.data.loader import SyntheticDataLoader
from tnn_tpu_torch.models import zoo
from tnn_tpu_torch.train import train_model
from tnn_tpu_torch.utils.config import TrainingConfig
from tnn_tpu_torch.utils.device import resolve_device
from tnn_tpu_torch.utils.env import load_env_file
from tnn_tpu_torch.utils.platform import apply_env_platform


def build_loaders(cfg: TrainingConfig, synthetic_classes: int):
    """The train and validation loaders of the config's dataset (no
    validation loader where the dataset has no test split on disk)."""
    if cfg.dataset_name in ("", "synthetic"):
        shape = (32, 32, 3) if "mnist" not in cfg.model_name \
            else (28, 28, 1)
        train = SyntheticDataLoader(50 * cfg.batch_size, shape,
                                    synthetic_classes, seed=cfg.seed)
        val = SyntheticDataLoader(10 * cfg.batch_size, shape,
                                  synthetic_classes, seed=cfg.seed + 1)
        return train, val
    if cfg.dataset_name == "openwebtext":
        # a token file (``cli.prepare_corpus``'s train.bin), with val.bin
        # beside it as the validation stream; the token loader takes no
        # ``train`` flag (the JAX trainer passes one and raises)
        train = factory.create(cfg.dataset_name, cfg.dataset_path,
                               seed=cfg.seed)
        val_path = os.path.join(os.path.dirname(cfg.dataset_path),
                                "val.bin")
        val = factory.create(cfg.dataset_name, val_path) \
            if os.path.basename(cfg.dataset_path) == "train.bin" \
            and os.path.exists(val_path) else None
        return train, val
    # the JAX trainer's call: ImageFolderDataLoader takes no ``train``, so
    # tiny_imagenet / imagenet100 raise TypeError here as they do there
    train = factory.create(cfg.dataset_name, cfg.dataset_path, train=True,
                           seed=cfg.seed)
    try:
        val = factory.create(cfg.dataset_name, cfg.dataset_path, train=False)
    except (FileNotFoundError, OSError):
        val = None
    return train, val


def create_model(cfg: TrainingConfig, sample_shape, device):
    """The zoo model ``cfg.model_name`` on ``device``, weights from
    ``cfg.seed``; a vision model sized for ``sample_shape``."""
    kw = dict(device=device, seed=cfg.seed)
    if cfg.model_name in zoo.vision_names():
        kw["input_shape"] = tuple(sample_shape)
    return zoo.create(cfg.model_name, **kw)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="", help="JSON config file")
    ap.add_argument("--model", default=None)
    ap.add_argument("--dataset", default=None,
                    help=f"one of {factory.available()} or 'synthetic'")
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--resume", default=None,
                    help="checkpoint dir to resume from")
    ap.add_argument("--snapshot-dir", default=None)
    ap.add_argument("--profile", default=None,
                    choices=["NONE", "NORMAL", "CUMULATIVE"])
    ap.add_argument("--num-classes", type=int, default=10,
                    help="classes for synthetic data")
    ap.add_argument("--mesh", default=None,
                    help="parallel layout, e.g. data=2,pipe=4 or "
                         "data=2,model=2,seq=2 "
                         "(axes: data fsdp model pipe seq expert)")
    ap.add_argument("--num-microbatches", type=int, default=None,
                    help="pipeline microbatches per step (with --mesh "
                         "pipe=N)")
    ap.add_argument("--pipeline-virtual", type=int, default=None,
                    help="interleaved virtual stages per pipe position "
                         "(v>1 splits the model into v*pp stages)")
    ap.add_argument("--seq-parallel-method", default=None,
                    choices=["ring", "ulysses"],
                    help="context-parallel scheme for --mesh seq=N")
    ap.add_argument("--mesh-devices", default=None,
                    help="comma-separated devices of the mesh's positions, "
                         "e.g. cuda:0,cuda:0 (default: the first N cards, "
                         "or the CPU with --device cpu)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the model runs (default: the card, or "
                         "TNN_PLATFORM=cpu)")
    ap.add_argument("--history-out", default=None,
                    help="write the per-epoch metrics history to this "
                         "JSON file")
    args = ap.parse_args(argv)

    load_env_file()
    cfg = TrainingConfig().load_from_env()
    if args.config:
        cfg.load_from_json(args.config)
    for flag, field in [("model", "model_name"), ("dataset", "dataset_name"),
                        ("data_path", "dataset_path"), ("epochs", "epochs"),
                        ("batch_size", "batch_size"), ("resume", "resume"),
                        ("snapshot_dir", "snapshot_dir"),
                        ("profile", "profiler_type")]:
        v = getattr(args, flag)
        if v is not None:
            setattr(cfg, field, v)
    if args.lr is not None:
        cfg.optimizer = {**cfg.optimizer, "lr": args.lr}
    if args.mesh is not None:
        cfg.mesh_axes = {k: int(v) for k, v in
                         (kv.split("=") for kv in args.mesh.split(",") if kv)}
    if args.num_microbatches is not None:
        cfg.num_microbatches = args.num_microbatches
    if args.pipeline_virtual is not None:
        cfg.pipeline_virtual = args.pipeline_virtual
    if args.seq_parallel_method is not None:
        cfg.seq_parallel_method = args.seq_parallel_method
    devices = [d for d in args.mesh_devices.split(",") if d] \
        if args.mesh_devices else None
    if args.history_out:
        # an unwritable path fails before the run, not after it
        os.makedirs(os.path.dirname(os.path.abspath(args.history_out)),
                    exist_ok=True)
        open(args.history_out, "a").close()

    device = resolve_device(args.device) if args.device \
        else apply_env_platform()
    train_loader, val_loader = build_loaders(cfg, args.num_classes)
    model = create_model(cfg, train_loader.data_shape, device)
    state, history = train_model(model, cfg, train_loader, val_loader,
                                 devices=devices)
    if args.history_out:
        name = torch.cuda.get_device_name(device) \
            if device.type == "cuda" else device.type
        with open(args.history_out, "w") as f:
            json.dump({"model": cfg.model_name, "dataset": cfg.dataset_name,
                       "batch_size": cfg.batch_size, "epochs": cfg.epochs,
                       "device": name, "host": host_platform.platform(),
                       "history": history}, f, indent=2, default=float)
    final = history[-1] if history else {}
    print(f"done: {len(history)} epochs, final train loss "
          f"{final.get('train_loss', float('nan')):.4f}, "
          f"val acc {final.get('val_accuracy', 0.0):.4f}")
    return state, history


cli = console_entry(main)


if __name__ == "__main__":
    main()
