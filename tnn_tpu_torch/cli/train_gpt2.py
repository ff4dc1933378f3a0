#!/usr/bin/env python
"""Train a decoder LM, GPT-2 or Llama (``--arch``), on a token stream
(``tnn_tpu.cli.train_gpt2``): mmap token stream -> (B, S) windows -> train
step (``--backend pallas``: the flash attention kernels, K4 forward and the
fused backward K7, or the split backward K5 + K6 at long sequences) ->
held-out loss -> KV-cache sampling in byte mode.

    python -m tnn_tpu_torch.cli.prepare_corpus --out data/pytok \\
        --source /usr/lib/python3.12
    python -m tnn_tpu_torch.cli.train_gpt2 --tokens data/pytok --steps 300 \\
        --backend pallas

Results (loss curve, final train / held-out loss and perplexity, tok/s)
are written as one JSON file under --results. ``--device`` defaults to
cuda, and the run refuses to start without a card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from tnn_tpu_torch.data.token_stream import TokenStreamDataLoader
from tnn_tpu_torch.models.gpt2 import GPT2, generate
from tnn_tpu_torch.models.llama import Llama
from tnn_tpu_torch.nn.optimizers import AdamW
from tnn_tpu_torch.nn.schedulers import WarmupCosineAnnealing
from tnn_tpu_torch.train import (create_train_state, make_eval_step,
                                 make_train_step)
from tnn_tpu_torch.utils.device import resolve_device


def _platform(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else device.type


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tokens", required=True,
                    help="corpus dir from prepare_corpus (train.bin/val.bin)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=0,
                    help="grouped-query attention: KV heads (< --heads, "
                         "divisor); 0 = full MHA")
    ap.add_argument("--arch", default="gpt2", choices=["gpt2", "llama"],
                    help="decoder family: gpt2 (learned positions, GELU MLP) "
                         "or llama (RoPE + RMSNorm + SwiGLU)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--backend", default="xla", choices=["xla", "pallas"],
                    help="attention backend (pallas = the flash kernels)")
    ap.add_argument("--sample", type=int, default=128,
                    help="tokens to sample after training (0 = skip)")
    ap.add_argument("--fused-head-loss", type=int, default=0, metavar="CHUNK",
                    help="vocab chunk for the streaming LM-head loss (not "
                         "ported yet); 0 = materialized logits")
    ap.add_argument("--steps-per-call", type=int, default=1,
                    help="optimizer steps per call of the step function")
    ap.add_argument("--results", default="benchmarks/results")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.fused_head_loss:
        raise NotImplementedError("--fused-head-loss (nn.lm_loss) is not "
                                  "ported yet (ROADMAP.md)")
    device = resolve_device(args.device)

    with open(os.path.join(args.tokens, "meta.json")) as f:
        meta = json.load(f)
    vocab = int(meta["vocab_size"])
    train_loader = TokenStreamDataLoader(
        os.path.join(args.tokens, "train.bin"), args.seq)
    val_path = os.path.join(args.tokens, "val.bin")
    val_loader = TokenStreamDataLoader(val_path, args.seq) \
        if os.path.exists(val_path) else None
    print(f"corpus: {meta['train_tokens']} train tokens, vocab {vocab}")

    # a non-divisor remainder runs as one final smaller call, so --steps is
    # always exact
    spc = max(1, min(args.steps_per_call, args.steps))
    n_full, rem = divmod(args.steps, spc)
    total_steps = args.steps
    call_sizes = [spc] * n_full + ([rem] if rem else [])

    model_kw = dict(vocab_size=vocab, max_len=args.seq,
                    num_layers=args.layers, d_model=args.d_model,
                    num_heads=args.heads, backend=args.backend,
                    num_kv_heads=args.kv_heads or None, device=device, seed=0)
    if args.arch == "llama":
        model = Llama(**model_kw)
    else:
        model = GPT2(dropout=0.0, **model_kw)
    opt = AdamW(lr=args.lr, weight_decay=0.01, grad_clip_norm=1.0)
    sched = WarmupCosineAnnealing(warmup=max(10, total_steps // 20),
                                  t_max=total_steps)
    state = create_train_state(model, opt, seed=0)

    def make_step(n):
        return make_train_step(model, opt, scheduler=sched,
                               compute_accuracy=True, steps_per_call=n)

    step = make_step(spc)
    step_rem = make_step(rem) if rem else None

    def put(x):
        return torch.from_numpy(x).to(device).long()

    rng = np.random.default_rng(0)
    curve = []
    done = 0
    t0 = time.time()
    for c, n in enumerate(call_sizes):
        data, labels = train_loader.random_windows(args.batch * n, rng)
        if n > 1:
            data = data.reshape(n, args.batch, args.seq)
            labels = labels.reshape(n, args.batch, args.seq)
        fn = step if n == spc else step_rem
        state, m = fn(state, put(data), put(labels))
        done += n
        if c % max(1, 20 // spc) == 0 or done == total_steps:
            loss = float(m["loss_trace"][-1]) if n > 1 else float(m["loss"])
            curve.append({"step": done - 1, "loss": round(loss, 4),
                          "ppl": round(float(np.exp(loss)), 3)})
            print(f"step {done - 1}: loss {loss:.4f} ppl {np.exp(loss):.2f}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_secs = time.time() - t0
    tok_s = total_steps * args.batch * args.seq / train_secs

    out = {"metric": f"{args.arch}_bytes_lm", "backend": args.backend,
           # a CPU curve must never pass for the card's numbers
           "platform": _platform(device),
           "model": {"layers": args.layers, "d_model": args.d_model,
                     "heads": args.heads, "seq": args.seq, "vocab": vocab},
           "steps": total_steps, "steps_per_call": spc,
           "train_tok_per_s": round(tok_s, 1),
           "final_train_loss": curve[-1]["loss"],
           "final_train_ppl": curve[-1]["ppl"], "curve": curve}

    if val_loader is not None:
        ev = make_eval_step(model, compute_accuracy=False)
        losses = []
        for _ in range(10):
            d, l = val_loader.random_windows(args.batch, rng)
            losses.append(float(ev(state, put(d), put(l))["loss"]))
        val_loss = float(np.mean(losses))
        out["val_loss"] = round(val_loss, 4)
        out["val_ppl"] = round(float(np.exp(val_loss)), 3)
        print(f"held-out: loss {val_loss:.4f} ppl {np.exp(val_loss):.2f}")

    if args.sample > 0 and meta["mode"] == "byte":
        d, _ = val_loader.random_windows(1, rng) if val_loader is not None \
            else train_loader.random_windows(1, rng)
        # prompt + new tokens must fit the context
        n_new = min(args.sample, args.seq - 1)
        prompt_len = min(32, args.seq - n_new)
        gen = torch.Generator(device=device).manual_seed(0)
        t0 = time.time()
        toks = generate(model, put(d[:, :prompt_len]), n_new,
                        temperature=0.8, generator=gen, max_len=args.seq)
        toks = toks.cpu().numpy()
        decode_s = time.time() - t0
        text = bytes(int(t) for t in toks[0] if t < 256).decode(
            "utf-8", errors="replace")
        out["decode_tok_per_s"] = round(n_new / decode_s, 1)
        out["sample"] = text[:200]
        print(f"sample ({out['decode_tok_per_s']} tok/s):")
        print(text[:200])

    os.makedirs(args.results, exist_ok=True)
    path = os.path.join(args.results,
                        f"lm_{args.arch}_{meta['mode']}_{args.backend}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print("results ->", path)
    return out


if __name__ == "__main__":
    main()
