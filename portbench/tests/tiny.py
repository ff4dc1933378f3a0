"""A copy of the benchmark with tiny configurations, mixes and cells, for
the CPU tests: the harness drives the program at these sizes on the
CPU, where every kernel runs its plain version."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

from portbench import harness

REPO = Path(__file__).resolve().parents[2]

TINY_MODEL = {"n_layer": 2, "n_embd": 64, "n_head": 4, "n_positions": 128,
              "n_ctx": 128, "vocab_size": 512}

CELLS = {
    "train-tiny": ("tiny_train", "lm-train-tiny", {"batch": 2, "seq": 32,
                                                  "tokens": 20000}),
    "serve-tiny-closed": ("tiny_serve", "gen-closed-tiny",
                          {"arrivals": {"kind": "closed", "clients": 6},
                           "pool": 256}),
    "serve-tiny-open": ("tiny_serve", "gen-open-tiny",
                        {"arrivals": {"kind": "poisson", "rate": 20.0}}),
}


def make_copy(dest: Path) -> Path:
    """``BENCHMARK.json`` and ``portbench/`` copied to ``dest``, with the
    tiny configurations, mixes and cells added as new files and entries
    (what a later change to the benchmark would add). Returns ``dest``."""
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.load_benchmark(REPO)
    cfgs = dest / "portbench" / "configs"
    mixes = dest / "portbench" / "traffic"
    train = harness.load_json(cfgs / "flash_gpt2_small.json")
    train.update(TINY_MODEL, micro_batch_size=2,
                 limits={"loss": 0.05, "grad": 0.1, "update": 0.1,
                         "batch_rows": 0})
    serve = harness.load_json(cfgs / "gpt2_small.json")
    # a wider initialisation than GPT-2's sharpens the tiny model's
    # logits, so that a planted fault moves its greedy tokens: clean runs
    # read mean gaps under 5e-4, planted faults above 0.5
    serve.update(TINY_MODEL, initializer_range=0.2,
                 limits={"gap_mean": 0.02, "short_answers": 0})
    serve["serving"].update(max_batch_size=4, num_blocks=129,
                            chunk_size=16, token_budget=64)
    for name, cfg in (("tiny_train", train), ("tiny_serve", serve)):
        (cfgs / f"{name}.json").write_text(json.dumps(cfg, indent=1))
        bench["configs"].append({
            "name": name, "source": cfg["source"],
            "file": f"portbench/configs/{name}.json",
            "reduced": ["n_layer", "n_positions"], "why": "CPU tests"})
    base_train = harness.load_json(mixes / "lm-train-b32-s1024.json")
    base_serve = harness.load_json(mixes / "gen-open-r80.json")
    for cell, (config, mix, over) in CELLS.items():
        m = dict(base_train if config == "tiny_train" else base_serve)
        if config == "tiny_serve":
            m.update(prompt_len={"dist": "lognormal", "median": 12,
                                 "sigma": 0.6, "min": 4, "max": 24},
                     output_len={"dist": "uniform", "min": 8, "max": 16})
        m.update(over)
        (mixes / f"{mix}.json").write_text(json.dumps(m, indent=1))
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": mix, "chips": 1,
                                   "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            src = {"train": "train-gpt2s-b32", "closed": "serve-gpt2s-sat",
                   "open": "serve-gpt2s-r80"}
            for cell, tag in (("train-tiny", "train"),
                              ("serve-tiny-closed", "closed"),
                              ("serve-tiny-open", "open")):
                if src[tag] in m["workloads"]:
                    m["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


def run_in_copy(dest: Path, workload: str, seed: int = 3,
                seconds: float = 2.0, traced: bool = False,
                control: str = "off"):
    """Run ``workload`` of the copy at ``dest`` on the CPU in this
    process; returns the finished run and its result line."""
    import torch

    from portbench import run as run_mod

    bench = harness.load_benchmark(dest)
    cell = harness.resolve(bench, workload, dest)
    run = run_mod.run_cell(cell, seed, seconds, traced, torch.device("cpu"),
                           control)
    return run, harness.result_line(run, run_mod.device_info(run))


if __name__ == "__main__":
    # python -m portbench.tests.tiny DEST WORKLOAD [SEED [SECONDS]]
    out = make_copy(Path(sys.argv[1]))
    args = sys.argv[2:]
    r, line = run_in_copy(out, args[0], *(int(a) for a in args[1:2]),
                          *(float(a) for a in args[2:3]))
    print(json.dumps(line, default=str))
