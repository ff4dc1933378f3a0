#!/usr/bin/env python
"""Batch inference from a saved model (``tnn_tpu.cli.inferencer``):
accuracy and samples/s over a dataset's eval split.

    python -m tnn_tpu_torch.cli.inferencer \\
        --model-file model_snapshots/best/state.tnn --dataset cifar100 \\
        --data-path data/cifar100

``--model-file`` is a ``.tnn`` file of either package (``save_model``'s,
or a ``Checkpoint``'s ``state.tnn``); the model is sized for the loader's
samples. It runs on the card; ``TNN_PLATFORM=cpu`` runs it on the CPU.
``--dataset synthetic`` runs on fixed random data.
"""
from __future__ import annotations

import argparse
import time

import torch

from tnn_tpu_torch import checkpoint
from tnn_tpu_torch.cli import console_entry
from tnn_tpu_torch.data import factory
from tnn_tpu_torch.data.loader import SyntheticDataLoader, prefetch
from tnn_tpu_torch.train import make_predict
from tnn_tpu_torch.utils.platform import apply_env_platform


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model-file", required=True, help=".tnn model file")
    ap.add_argument("--dataset", default="synthetic")
    ap.add_argument("--data-path", default="data")
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--num-classes", type=int, default=10)
    args = ap.parse_args(argv)

    device = apply_env_platform()
    if args.dataset == "synthetic":
        loader = SyntheticDataLoader(20 * args.batch_size, (32, 32, 3),
                                     args.num_classes)
    else:
        loader = factory.create(args.dataset, args.data_path, train=False)
    model = checkpoint.load_model(args.model_file, device=device,
                                  input_shape=loader.data_shape)
    predict = make_predict(model)
    total = 0
    corrects = torch.zeros((), dtype=torch.int64, device=device)
    t0 = time.perf_counter()
    for data, labels in prefetch(loader.batches(args.batch_size),
                                 to_device=device):
        corrects += (predict(data).argmax(-1) == labels).sum()
        total += len(labels)
    accuracy = int(corrects) / max(total, 1)     # waits for the last batch
    seconds = time.perf_counter() - t0
    print(f"accuracy {accuracy:.4f} over {total} samples, "
          f"{total / seconds:.0f} samples/s")
    return {"accuracy": accuracy, "samples": total,
            "samples_per_s": total / seconds}


cli = console_entry(main)


if __name__ == "__main__":
    main()
