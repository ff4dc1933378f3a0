"""Offer an open serving cell's mix at other fixed rates, one process a
rate, and report the backlog at each: how the knee (the highest rate the
system sustains) was found once, when the cell's rate was fixed. The
benchmark's own runs never search for a rate.

    python3 -m portbench.sweep --workload serve-gpt2s-r80 \\
        --rates 25,30,35 --seed 5 --seconds 20

For each rate it prints one JSON line: the requests sent, the requests
outstanding (sent, not finished) at each quarter of the window, the
tokens served a second and the TTFT and TPOT tails. A backlog that grows
quarter by quarter marks a rate above the knee.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from . import harness
from .run import ROOT


def one(workload: str, rate: float, seed: int, seconds: float) -> dict:
    import torch

    from .run import run_cell

    os.environ["TNN_TORCH_BUILD_DIR"] = str(ROOT / "build" / "kernels")
    bench = harness.load_benchmark(ROOT)
    cell = harness.resolve(bench, workload, ROOT)
    cell.traffic = dict(cell.traffic, arrivals=dict(
        cell.traffic["arrivals"], rate=rate))
    run = run_cell(cell, seed, seconds, False, torch.device("cuda", 0))
    reqs, t0 = run.data["requests"], run.data["t0"]
    backlog = []
    for q in (0.25, 0.5, 0.75, 1.0):
        t = t0 + q * seconds
        backlog.append(sum(1 for r in reqs if r.t_sched <= t
                           and (r.t_done is None or r.t_done > t)))
    metrics = harness.read_metrics(run, run.cell.end_to_end)
    tokens = run.module("metrics", "serve_tokens_per_s").read(run)
    return {"rate": rate, "seed": seed, "sent": len(reqs),
            "backlog_by_quarter": backlog, "failed": run.failed,
            "serve_tokens_per_s": tokens, "correct": run.correct,
            **{k: v["value"] for k, v in metrics.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=20)
    ap.add_argument("--one", type=float, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:
        print(json.dumps(one(args.workload, args.one, args.seed,
                             args.seconds)), flush=True)
        return 0
    for rate in (float(r) for r in args.rates.split(",")):
        proc = subprocess.run(
            [sys.executable, "-m", "portbench.sweep", "--workload",
             args.workload, "--rates", args.rates, "--seed", str(args.seed),
             "--seconds", str(args.seconds), "--one", str(rate)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        out = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        print(out[-1] if out else json.dumps(
            {"rate": rate, "rc": proc.returncode,
             "stderr": proc.stderr[-2000:]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
