#!/usr/bin/env python
"""GPT-2 autoregressive generation (``tnn_tpu.cli.gpt2_inference``).

    python -m tnn_tpu_torch.cli.gpt2_inference --prompt "The meaning of
        life is" -n 50 --fused

Runs the model a ``.tnn`` file holds (``--model-file``, written by either
package's ``save_model``) or a seeded random-weight zoo model (a smoke
test and a tokens/s measurement of the decode path itself). With
``--vocab`` (a vocab.bin) the prompt is BPE-encoded and the text printed;
without it the prompt's bytes are its token ids. ``--int8`` decodes from int8 weights (``nn.quant.quantize_for_decode``
on a copy); ``--fused`` (implies ``--int8``) generates through
``models.fused_decode.fused_generate``, one launch of the fused
decode-stack kernel per token. Generation runs twice and the second call
is timed. ``--device`` defaults to cuda and raises without a card.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from tnn_tpu_torch import checkpoint
from tnn_tpu_torch.cli import console_entry
from tnn_tpu_torch.data.tokenizer import Tokenizer
from tnn_tpu_torch.models import zoo
from tnn_tpu_torch.models.gpt2 import generate


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="gpt2_small", choices=zoo.names(),
                    help="zoo name (seeded random weights; used when "
                         "--model-file is absent)")
    ap.add_argument("--model-file", default="", help=".tnn snapshot")
    ap.add_argument("--vocab", default="",
                    help="vocab.bin, the reference format")
    ap.add_argument("--prompt", default="The meaning of life is")
    ap.add_argument("-n", "--max-new-tokens", type=int, default=50)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0,
                    help="sample only from the k highest logits (0 = off)")
    ap.add_argument("--top-p", type=float, default=0.0,
                    help="nucleus sampling: smallest token set with "
                         "cumulative prob >= p (0 = off)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--int8", action="store_true",
                    help="decode from int8 weights")
    ap.add_argument("--fused", action="store_true",
                    help="the fused decode-stack kernel, one launch per "
                         "token (ops/decode_stack.py); implies --int8")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.fused:
        args.int8 = True
    if (args.top_k or args.top_p) and args.temperature <= 0:
        # top-k / top-p only shape a stochastic distribution; under greedy
        # decoding they would be silently ignored
        print("--top-k/--top-p need sampling: defaulting --temperature 1.0")
        args.temperature = 1.0

    tokenizer = Tokenizer().load(args.vocab) if args.vocab else None
    if args.model_file:
        model = checkpoint.load_model(args.model_file, device=args.device)
    else:
        model = zoo.create(args.model, device=args.device, seed=args.seed)
        print(f"no --model-file: random-weight {args.model} "
              "(smoke/benchmark mode)")
    if args.int8:
        from tnn_tpu_torch.nn.quant import (quantize_for_decode,
                                            quantized_bytes)

        before = quantized_bytes(model)
        model = quantize_for_decode(model)
        print(f"int8 weights: {before / 2**20:.0f} MB -> "
              f"{quantized_bytes(model) / 2**20:.0f} MB")
    if tokenizer is not None:
        prompt_ids = np.asarray(tokenizer.encode(args.prompt),
                                np.int64)[None]
    else:
        print("no --vocab: using byte-level prompt ids")
        prompt_ids = np.frombuffer(args.prompt.encode(), np.uint8).astype(
            np.int64)[None] % model.vocab_size

    gen_fn = generate
    if args.fused:
        from tnn_tpu_torch.models.fused_decode import fused_generate as gen_fn

    def run():
        gen = torch.Generator(device=model.device).manual_seed(args.seed)
        return gen_fn(model, prompt_ids, args.max_new_tokens,
                      temperature=args.temperature, generator=gen,
                      top_k=args.top_k, top_p=args.top_p)

    # the first call warms up (kernel builds, allocator); the second is
    # timed, ending in the host copy of its tokens
    run().cpu()
    t0 = time.perf_counter()
    new_tokens = run().cpu().numpy()[0]
    dt = time.perf_counter() - t0
    if tokenizer is not None:
        full = prompt_ids[0].tolist() + new_tokens.tolist()
        print("---\n" + tokenizer.decode(full) + "\n---")
    else:
        print("generated ids:", new_tokens[:16].tolist(), "...")
    print(f"{len(new_tokens)} tokens in {dt * 1e3:.0f} ms "
          f"({len(new_tokens) / dt:.1f} tok/s)")
    return 0


cli = console_entry(main)


if __name__ == "__main__":
    raise SystemExit(main())
