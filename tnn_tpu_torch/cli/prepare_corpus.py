#!/usr/bin/env python
"""Build a flat uint16 token .bin from local text files
(``tnn_tpu.cli.prepare_corpus``). Two tokenizations:

  --mode byte  token = raw byte (0..255), 256 = end-of-text between files
               (vocab_size 257)
  --mode bpe   the BPE tokenizer (``data.tokenizer``) over ``--vocab``, or
               over a vocabulary of ``--train-vocab-size`` tokens trained
               on the corpus itself and saved as <out>/vocab.bin

    python -m tnn_tpu_torch.cli.prepare_corpus --out data/pytok \\
        --source /usr/lib/python3.12 --glob '*.py' --val-fraction 0.05

writes <out>/train.bin, <out>/val.bin and <out>/meta.json.
"""
from __future__ import annotations

import argparse
import fnmatch
import json
import os

import numpy as np

from tnn_tpu_torch.cli import console_entry

BYTE_EOT = 256  # end-of-text id in byte mode (vocab_size = 257)


def iter_files(sources, pattern, max_bytes):
    total = 0
    for src in sources:
        if os.path.isfile(src):
            yield src
            continue
        for root, _, files in os.walk(src):
            for name in sorted(files):
                if not fnmatch.fnmatch(name, pattern):
                    continue
                path = os.path.join(root, name)
                try:
                    total += os.path.getsize(path)
                except OSError:
                    continue
                yield path
                if max_bytes and total >= max_bytes:
                    return


def encode_byte(paths):
    chunks = []
    for path in paths:
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            continue
        chunks.append(np.frombuffer(raw, np.uint8).astype(np.uint16))
        chunks.append(np.array([BYTE_EOT], np.uint16))
    if not chunks:
        raise SystemExit("no input files matched")
    return np.concatenate(chunks)


def encode_bpe(paths, vocab_path, out_dir, train_vocab_size):
    from tnn_tpu_torch.data.tokenizer import Tokenizer, train_bpe

    def read(path):
        try:
            with open(path, "r", encoding="utf-8", errors="ignore") as f:
                return f.read()
        except OSError:
            return ""

    if vocab_path:
        tok = Tokenizer().load(vocab_path)
    else:
        print(f"training {train_vocab_size}-token BPE vocab from the "
              "corpus...")
        tok = train_bpe((read(p) for p in paths), vocab_size=train_vocab_size)
        tok.save(os.path.join(out_dir, "vocab.bin"))
    if tok.vocab_size > 65536:
        raise SystemExit(f"vocab_size {tok.vocab_size} exceeds the uint16 "
                         "token format (max 65536): ids would wrap")
    eot = tok.eot_token
    chunks = []
    for path in paths:
        text = read(path)
        if not text:
            continue
        ids = tok.encode(text)
        if eot is not None:
            ids = ids + [eot]
        chunks.append(np.asarray(ids, np.uint16))
    if not chunks:
        raise SystemExit("no input files matched")
    return np.concatenate(chunks), tok.vocab_size


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--source", nargs="+", required=True,
                    help="files or directories to read")
    ap.add_argument("--glob", default="*.py", help="filename pattern in dirs")
    ap.add_argument("--mode", choices=["byte", "bpe"], default="byte")
    ap.add_argument("--vocab", default="",
                    help="vocab.bin for --mode bpe (omit to train one from "
                         "the corpus into <out>/vocab.bin)")
    ap.add_argument("--train-vocab-size", type=int, default=4096,
                    help="vocab size when training a BPE vocab")
    ap.add_argument("--val-fraction", type=float, default=0.05)
    ap.add_argument("--max-mb", type=float, default=64.0,
                    help="stop reading input after this many MB")
    args = ap.parse_args(argv)

    paths = list(iter_files(args.source, args.glob,
                            int(args.max_mb * 1e6) if args.max_mb else 0))
    os.makedirs(args.out, exist_ok=True)
    if args.mode == "byte":
        tokens = encode_byte(paths)
        vocab_size = BYTE_EOT + 1
    else:
        tokens, vocab_size = encode_bpe(paths, args.vocab, args.out,
                                        args.train_vocab_size)
    n_val = int(len(tokens) * args.val_fraction)
    train, val = tokens[:-n_val] if n_val else tokens, tokens[-n_val:]
    train.tofile(os.path.join(args.out, "train.bin"))
    if n_val:
        val.tofile(os.path.join(args.out, "val.bin"))
    meta = {"mode": args.mode, "vocab_size": vocab_size,
            "files": len(paths), "train_tokens": int(len(train)),
            "val_tokens": int(n_val)}
    with open(os.path.join(args.out, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    print(json.dumps(meta))
    return meta


cli = console_entry(main)


if __name__ == "__main__":
    main()
