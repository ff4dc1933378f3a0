"""What gloo does with CUDA tensors on one card, for
``tnn_tpu_torch/parallel/process_group.py``'s rule (collectives take the
card's tensors; ``exchange``'s send / receive go through the host).

    python scripts/torch_gloo_probe.py [--sizes-mb 6,25,100] [--iters 5]

Two processes on ``cuda:0`` join a gloo group over a TCP store on
``localhost``. Each collective the port uses runs once on CUDA tensors,
in a pair of processes of its own (a refused send kills its process),
and reports "ok" with its result or the error. Then one pair times
``all_reduce`` and ``all_gather`` of f32 tensors of each size three
ways: gloo on the CUDA tensor, staged through a pinned host buffer, and
(``all_reduce``) through a pageable ``.cpu()`` copy: ms a call over
``iters`` calls after two warm-up calls, the card synchronized around.
Prints the card's name and power limit first, then one JSON object.
Needs the card.
"""
from __future__ import annotations

import argparse
import datetime
import json
import socket
import subprocess
import sys
import time

OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all_single",
       "broadcast", "batch_isend_irecv", "new_group_all_reduce")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _join(rank: int, port: int):
    import torch
    import torch.distributed as dist

    store = dist.TCPStore("127.0.0.1", port, 2, rank == 0,
                          datetime.timedelta(seconds=60))
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2)
    torch.cuda.set_device(0)
    return torch, dist


def probe(rank: int, port: int, op: str) -> dict:
    torch, dist = _join(rank, port)
    x = torch.full((4,), float(rank + 1), device="cuda:0")
    if op == "all_reduce":
        y = x.clone()
        dist.all_reduce(y)
    elif op == "all_gather":
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        y = torch.cat(parts)
    elif op == "reduce_scatter":
        y = torch.empty(2, device="cuda:0")
        dist.reduce_scatter(y, list(x.chunk(2)))
    elif op == "all_to_all_single":
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x + torch.arange(4.0, device="cuda:0"))
    elif op == "broadcast":
        y = x.clone()
        dist.broadcast(y, 0)
    elif op == "batch_isend_irecv":
        y = torch.empty_like(x)
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, 1 - rank),
            dist.P2POp(dist.irecv, y, 1 - rank)])
        for w in works:
            w.wait()
    else:
        group = dist.new_group([0, 1])
        y = x.clone()
        dist.all_reduce(y, group=group)
    out = y.tolist()
    dist.destroy_process_group()
    return {"result": out}


def timing(rank: int, port: int, sizes_mb, iters: int) -> dict:
    torch, dist = _join(rank, port)
    out = {}

    def clock(fn):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / iters

    for mb in sizes_mb:
        n = int(mb * 2 ** 20) // 4
        x = torch.randn(n, device="cuda:0")
        pinned = torch.empty(n, pin_memory=True)
        parts = [torch.empty(n, device="cuda:0") for _ in range(2)]
        host_parts = [torch.empty(n, pin_memory=True) for _ in range(2)]

        def ar_cuda():
            dist.all_reduce(x.clone())

        def ar_pinned():
            pinned.copy_(x)
            dist.all_reduce(pinned)
            pinned.to("cuda:0", non_blocking=True)

        def ar_pageable():
            h = x.cpu()
            dist.all_reduce(h)
            h.to("cuda:0")

        def ag_cuda():
            dist.all_gather(parts, x)

        def ag_pinned():
            pinned.copy_(x)
            dist.all_gather(host_parts, pinned)
            torch.stack(host_parts).to("cuda:0")

        for name, fn in (("all_reduce_cuda", ar_cuda),
                         ("all_reduce_pinned", ar_pinned),
                         ("all_reduce_pageable", ar_pageable),
                         ("all_gather_cuda", ag_cuda),
                         ("all_gather_pinned", ag_pinned)):
            out[f"{name}_{mb}MB_ms"] = clock(fn)
    dist.destroy_process_group()
    return out


def _pair(args) -> list:
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r),
                               "--port", str(port), *args],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        lines = [x for x in out.splitlines() if x.startswith("{")]
        last = (err.strip().splitlines() or [""])[-1]
        outs.append(json.loads(lines[-1]) if lines and p.returncode == 0
                    else {"error": f"exit {p.returncode}: {last}"})
    return outs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes-mb", default="6,25,100")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--op", default=None)
    args = ap.parse_args()
    sizes = [float(s) for s in args.sizes_mb.split(",")]
    if args.rank is not None:
        out = probe(args.rank, args.port, args.op) if args.op else \
            timing(args.rank, args.port, sizes, args.iters)
        print(json.dumps(out), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_gloo_probe: needs the card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    ops = {}
    for op in OPS:
        first = _pair(["--op", op])[0]
        ops[op] = first.get("error") or f"ok {first['result']}"
    times = _pair(["--sizes-mb", args.sizes_mb, "--iters",
                   str(args.iters)])[0]
    print(json.dumps({"torch": torch.__version__, "cuda_tensors": ops,
                      "ms": times}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
