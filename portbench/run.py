"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload serve-gpt2s-r80 --seed 7 \\
        --seconds 30 --trace 0

(``python3 -m portbench.run`` with the same arguments is the same run.)

It runs from the root of a checkout that holds the program
(``tnn_tpu_torch``) beside ``BENCHMARK.json``, on a machine with as many
CUDA cards as the cell asks for; without them it exits 2 and prints no
result. ``--trace 0`` reports the cell's end-to-end metrics, ``--trace
1`` its per-layer metrics, read from the program's counters and a
profiled sub-window. Every run checks what its timed path produced
against the plain reference (``portbench/compare.py``) and prints each
number compared beside its limit, last on standard error and last in the
result line. ``--control int8`` (or ``fp8``) puts the configuration's
lower-precision control in the program's place: the comparison must
call it not correct. The program's kernels build into
``build/kernels/`` inside the checkout, where later runs find them.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__" and not __package__:
    # run as a script: the checkout's root, not this folder, on the path
    sys.path[0] = str(ROOT)

from portbench import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default="off",
                    help="run the configuration's lower-precision control "
                         "in the program's place (its name in the "
                         "configuration's 'control' entry)")
    return ap.parse_args(argv)


def run_cell(cell: harness.Cell, seed: int, seconds: float, traced: bool,
             device, control: str = "off",
             t_start: float = None) -> harness.Run:
    """Drive ``cell`` once on ``device``; returns the finished run."""
    run = harness.Run(cell=cell, seed=seed, seconds=seconds, traced=traced,
                      device=device, control=control,
                      t_start=T_START if t_start is None else t_start)
    driver = run.module("drivers", cell.traffic["driver"])
    driver.run(run)
    return run


def device_info(run: harness.Run) -> dict:
    import torch

    dev = run.device
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu",
            "count": run.cell.chips,
            "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.traced:
        t = run.trace
        info["busy_s"] = t.busy_s if t is not None else 0.0
        info["window_s"] = t.window_s if t is not None else 0.0
    return info


def main(argv=None) -> int:
    args = parse(argv)
    # the program's kernel libraries, at a fixed path inside the checkout
    os.environ["TNN_TORCH_BUILD_DIR"] = str(ROOT / "build" / "kernels")
    try:
        bench = harness.load_benchmark(ROOT)
        cell = harness.resolve(bench, args.workload, ROOT)
    except (OSError, KeyError, ValueError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    if not (ROOT / "tnn_tpu_torch").is_dir():
        print(f"portbench: the program (tnn_tpu_torch) is not in {ROOT}",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), args.control)
    found = harness.forbidden_loaded()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    line = harness.result_line(run, device_info(run))
    for name, value in run.info.items():
        print(f"info {name}: {value!r}", file=sys.stderr)
    for name, (value, limit) in run.checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
