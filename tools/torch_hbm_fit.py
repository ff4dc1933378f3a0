#!/usr/bin/env python
"""Device-memory fit table of the GPT-2 and Llama families on one card,
for the PyTorch port (``tnn_tpu_torch``): the port's ``tools/hbm_fit.py``.

Each row's train state (the f32 parameters and AdamW's moments and step,
the tensors ``train.step.create_train_state`` holds) is built on the
``meta`` device, so its bytes are exact and no memory is touched. The
training total adds the activations under remat (the block-boundary
activations plus one block's interior), the gradients in flight and the
f32 logits; the decode columns are the bf16 and int8 weights plus a
bf16 KV cache at batch 1. The models, batches and formulas are those of
``tools/hbm_fit.py``, column for column.

    python -m tools.torch_hbm_fit [--seq 1024] [--hbm-gb G]

``--hbm-gb`` defaults to the card's memory
(``torch.cuda.get_device_properties(0).total_memory``); without a card
it must be given.
"""
from __future__ import annotations

import argparse

import torch

# (size, train batch) of each row, as the JAX tool's
ROWS = (("small", 8), ("medium", 4), ("large", 1), ("llama_small", 8),
        ("llama_1b", 2))


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a nest of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def train_state_bytes(model, optimizer) -> int:
    """The train state's bytes: the model's parameters, its state buffers
    and the optimizer's state (``create_train_state`` without its
    generator, which holds no device memory)."""
    params = dict(model.named_parameters())
    return (tree_bytes(params) + tree_bytes(dict(model.named_buffers()))
            + tree_bytes(optimizer.init(params)))


def row(size: str, batch: int, seq: int):
    from tnn_tpu_torch import nn
    from tnn_tpu_torch.models import zoo

    # a size starting with "llama" names the Llama family, anything else
    # is gpt2_<size>
    name = size if size.startswith("llama") else f"gpt2_{size}"
    model = zoo.create(name, max_len=seq, device="meta", seed=None)
    state_b = train_state_bytes(model, nn.AdamW(lr=1e-4))
    n_params = sum(p.numel() for p in model.parameters())
    d, L = model.d_model, model.num_layers
    # remat: the L + 1 block-boundary activations (bf16), one block's
    # interior recomputed in the backward (about 6 activation-sized
    # tensors for ln / qkv / attention / MLP), the f32 gradients in flight
    boundary = (L + 1) * batch * seq * d * 2
    interior = 6 * batch * seq * 4 * d * 2
    grads = 4 * n_params
    logits = batch * seq * model.vocab_size * 4
    train_total = state_b + boundary + interior + grads + logits
    # decode at batch 1: bf16 weights, or int8 weights at 0.52 of their
    # bytes (the JAX tool's ratio for GPT-2: int8 matmul kernels, bf16
    # embeddings and norms), plus a bf16 KV cache; GQA models hold
    # H_kv / H of the kv width a position
    w_bf16 = 2 * n_params
    w_int8 = int(w_bf16 * 0.52)
    kv_frac = getattr(model, "num_kv_heads", model.num_heads) \
        / model.num_heads
    kv = int(2 * L * seq * d * 2 * kv_frac)
    return {"size": name, "params_M": round(n_params / 1e6),
            "train_batch": batch,
            "train_state_GB": round(state_b / 2**30, 2),
            "train_total_GB": round(train_total / 2**30, 2),
            "decode_bf16_GB": round((w_bf16 + kv) / 2**30, 2),
            "decode_int8_GB": round((w_int8 + kv) / 2**30, 2)}


def card_gb() -> float:
    """The card's memory in GiB; raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no card (torch.cuda.is_available() is False): "
                           "give --hbm-gb")
    return torch.cuda.get_device_properties(0).total_memory / 2**30


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--hbm-gb", type=float, default=None,
                    help="device memory of one card, GiB (default: the "
                         "card's)")
    args = ap.parse_args(argv)
    hbm = args.hbm_gb if args.hbm_gb is not None else card_gb()
    rows = [row(size, batch, args.seq) for size, batch in ROWS]
    cols = list(rows[0])
    print(" | ".join(cols))
    for r in rows:
        fit = "FITS" if r["train_total_GB"] < hbm else \
            "NEEDS FSDP/smaller bs"
        print(" | ".join(str(r[c]) for c in cols), "|", fit,
              f"(vs {hbm:.2f} GB)")
    return rows


if __name__ == "__main__":
    main()
