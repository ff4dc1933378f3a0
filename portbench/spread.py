"""Run one cell several times, each run a process of its own, and report
each metric's median and spread per set of runs.

    python3 -m portbench.spread --workload train-gpt2s-b32 \\
        --seeds 11,12,13,14,15,16 --sets 2 --seconds 30 \\
        --out train-spread.jsonl

A set runs every seed once, in order; ``--sets 2`` runs the same seeds
again (the two sets a bound is measured from). Each run's result line,
exit code, wall time and the end of its standard error are appended to
``--out`` as one JSON line; the summary (per set and metric: median,
spread as the interquartile distance over the median, by
``statistics.quantiles``) is printed last. ``--trace`` and ``--control``
pass through to ``portbench/run.py``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from .yardstick import spread

ROOT = Path(__file__).resolve().parent.parent


def one(workload: str, seed: int, seconds: float, trace: int,
        control: str) -> dict:
    cmd = [sys.executable, "portbench/run.py", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace",
           str(trace), "--control", control]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True)
    rec = {"workload": workload, "seed": seed, "trace": trace,
           "control": control, "rc": proc.returncode,
           "wall_s": time.perf_counter() - t0,
           "stderr_tail": proc.stderr[-3000:]}
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if lines:
        rec["result"] = json.loads(lines[-1])
    return rec


def summary(recs) -> dict:
    out = {}
    for rec in recs:
        res = rec.get("result")
        if not res:
            continue
        for name, m in res["metrics"].items():
            out.setdefault(name, []).append(m["value"])
    return {name: {"n": len(v), "median": statistics.median(v),
                   "spread": spread(v) if len(v) >= 2 else None,
                   "values": v} for name, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.spread")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--control", default="off")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    sets = []
    for k in range(args.sets):
        recs = []
        for seed in seeds:
            rec = one(args.workload, seed, args.seconds, args.trace,
                      args.control)
            rec["set"] = k
            with open(out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            res = rec.get("result") or {}
            print(json.dumps({"set": k, "seed": seed, "rc": rec["rc"],
                              "wall_s": round(rec["wall_s"], 1),
                              "correct": res.get("correct"),
                              "metrics": {n: m["value"] for n, m in
                                          res.get("metrics", {}).items()},
                              "checks": {n: c["value"] for n, c in
                                         res.get("checks", {}).items()}}),
                  flush=True)
            if rec["rc"] != 0 or not res:
                print(rec["stderr_tail"], flush=True)
            recs.append(rec)
        sets.append(summary(recs))
    print(json.dumps({"workload": args.workload, "sets": sets}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
