#!/usr/bin/env python
"""Serving front end on stdin/stdout JSON lines (``tnn_tpu.cli.serve``).

    echo '{"tokens": [464, 3616, 286], "max_new_tokens": 16}' | \
        python -m tnn_tpu_torch.cli.serve --model gpt2_small

Each stdin line is one request:

    {"id": 3, "tokens": [464, 3616, 286], "max_new_tokens": 8,
     "temperature": 0.8, "top_k": 40, "top_p": 0.9, "stop_token": 50256}

``id`` defaults to the engine request id. Responses stream as the engine
produces them, one JSON object per line, as the JAX front end emits them:

    {"event": "token", "id": 3, "token": 257}
    {"event": "done", "id": 3, "tokens": [...], "finish_reason": "length",
     "ttft_ms": 12.3}
    {"event": "error", "id": 3, "reason": "..."}

New lines are read between engine steps, so requests join a running batch.
EOF ends the input; the server then finishes every request and exits 0.
Weights are seeded random (``--seed``); ``--device`` defaults to cuda and
the server refuses to start without a card unless ``--device cpu``.

``--sp N`` serves with sequence parallelism: the KV pool's blocks split
over N shards, a request's blocks round-robin over them, so the longest
servable context is N times one shard's. ``--sp-devices`` names the
shards' devices as a comma list (``cuda:0,cuda:0`` puts two shards on one
card); the default is the first N cards, or N copies of the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import select
import sys

from tnn_tpu_torch.models import zoo
from tnn_tpu_torch.serving.engine import InferenceEngine


def _emit(obj) -> None:
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def _stdin_ready(fd: int, timeout) -> bool:
    return bool(select.select([fd], [], [], timeout)[0])


def _sp_preflight(ap, args, sp_devices) -> None:
    """The JAX front end's fail-fast checks of an impossible SP setup, run
    before any weight is built."""
    if sp_devices is not None and len(sp_devices) != args.sp:
        ap.error(f"--sp-devices names {len(sp_devices)} device(s) for "
                 f"--sp {args.sp}")
    if sp_devices is None and args.device.startswith("cuda"):
        import torch
        n_dev = torch.cuda.device_count()
        if args.sp > n_dev:
            ap.error(f"--sp {args.sp} exceeds the {n_dev} visible card(s); "
                     "put several shards on one card with --sp-devices")
    if args.num_blocks % args.sp:
        ap.error(f"--num-blocks {args.num_blocks} does not divide evenly "
                 f"over --sp {args.sp} shards")
    if args.quant_weights:
        ap.error("--quant-weights is incompatible with --sp > 1 (serve fp "
                 "weights under SP)")
    if args.decode_path == "fused":
        ap.error("--decode-path fused is incompatible with --sp > 1 (the "
                 "fused kernel assembles one chip's contiguous cache; use "
                 "auto, paged, or standard)")
    # the engine's assembly width, from the model's shape alone
    max_len = zoo.create(args.model, device="meta", seed=None).max_len
    cap = min(max_len, (args.num_blocks - args.sp) * args.block_size)
    msl = min(args.max_seq_len or cap, cap)
    nb = -(-msl // args.block_size)
    if nb % args.sp:
        ap.error(f"--sp {args.sp} does not divide the assembly width ({nb} "
                 f"blocks/seq from max_seq_len {msl}, block size "
                 f"{args.block_size}); pick --max-seq-len (or --num-blocks/"
                 "--block-size) so ceil(max_seq_len / block_size) is a "
                 "multiple of sp")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="gpt2_small", choices=zoo.names())
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--num-blocks", type=int, default=64,
                    help="KV pool size in blocks (1 is reserved scratch)")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--max-batch-size", type=int, default=8)
    ap.add_argument("--chunk-size", type=int, default=64)
    ap.add_argument("--max-new-tokens", type=int, default=32,
                    help="default for requests that omit it")
    ap.add_argument("--kv-dtype", default="f32", choices=("f32", "int8"),
                    help="KV pool page dtype: int8 halves resident KV and "
                         "decode page traffic (per-row f32 scale sidecar; "
                         "output gated by closeness, not exactness)")
    ap.add_argument("--quant-weights", action="store_true",
                    help="serve projection/MLP matmuls from int8 weights "
                         "via the in-kernel-dequant quant_matmul kernel")
    ap.add_argument("--decode-path", default="auto",
                    choices=("auto", "standard", "fused", "paged"),
                    help="decode program: paged (the paged-attention "
                         "kernel), standard (assembled caches), fused (the "
                         "one-launch decode-stack kernel on lockstep "
                         "batches; needs --quant-weights), or auto")
    ap.add_argument("--max-seq-len", type=int, default=0,
                    help="longest request (prompt + new tokens); 0 = the "
                         "model's or the pool's limit, whichever is less")
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence-parallel degree: shard the KV pool's "
                         "blocks over this many shards")
    ap.add_argument("--sp-devices", default="",
                    help="comma list of one device per shard, e.g. "
                         "cuda:0,cuda:0 (default: the first --sp cards)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sp_devices = [d for d in args.sp_devices.split(",") if d] or None
    if args.sp > 1:
        _sp_preflight(ap, args, sp_devices)

    model = zoo.create(args.model, device=args.device, seed=args.seed)
    print(f"random-weight {args.model} on {model.device} "
          f"(seed {args.seed})", file=sys.stderr)
    engine = InferenceEngine(
        model, num_blocks=args.num_blocks, block_size=args.block_size,
        max_batch_size=args.max_batch_size, chunk_size=args.chunk_size,
        seed=args.seed, kv_dtype=args.kv_dtype,
        quant_weights=args.quant_weights, decode_path=args.decode_path,
        max_seq_len=args.max_seq_len or None, sp=args.sp,
        sp_devices=sp_devices, device=args.device)
    if args.sp > 1:
        print(f"sequence parallel: sp={args.sp}, "
              f"{engine.pool.blocks_per_shard} block(s)/shard, max context "
              f"{engine.max_seq_len} tokens over "
              f"{', '.join(str(d) for d in engine.pool.devices)}",
              file=sys.stderr)
    user_ids = {}

    def handle_line(line: bytes) -> None:
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            _emit({"event": "error", "reason": f"bad json: {e}"})
            return
        if not isinstance(req, dict):
            _emit({"event": "error", "reason": "a request is a JSON object"})
            return
        try:
            rid = engine.submit(
                req["tokens"],
                int(req.get("max_new_tokens", args.max_new_tokens)),
                temperature=float(req.get("temperature", 0.0)),
                top_k=int(req.get("top_k", 0)),
                top_p=float(req.get("top_p", 0.0)),
                stop_token=req.get("stop_token"))
        except (ValueError, KeyError, TypeError) as e:
            _emit({"event": "error", "id": req.get("id"), "reason": str(e)})
            return
        user_ids[rid] = req.get("id", rid)

    fd = sys.stdin.fileno()
    pending = b""
    eof = False
    while not eof or engine.has_work:
        # read whatever input has arrived; block only while the engine idles
        while not eof and _stdin_ready(fd, 0.0 if engine.has_work else None):
            data = os.read(fd, 1 << 16)
            eof = not data
            pending += data if data else b"\n"
            *lines, pending = pending.split(b"\n")
            for line in lines:
                if line.strip():
                    handle_line(line)
        if not engine.has_work:
            continue
        events = engine.step()
        for rid, tok in events["tokens"]:
            _emit({"event": "token", "id": user_ids[rid], "token": tok})
        for rid in events["finished"]:
            r = engine.result(rid)
            _emit({"event": "done", "id": user_ids[rid],
                   "tokens": list(r.out_tokens),
                   "finish_reason": r.finish_reason,
                   "ttft_ms": round((r.ttft_s or 0.0) * 1e3, 3)})
        for rid, error in events["failed"]:
            _emit({"event": "error", "id": user_ids[rid], "reason": error})
    print("serve summary: " + json.dumps(
        {k: round(v, 3) if isinstance(v, float) else v
         for k, v in engine.stats().items()}), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
