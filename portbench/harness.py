"""The harness: it reads ``BENCHMARK.json``, finds every piece of a cell by
name, drives the cell and assembles the result line.

A cell names a configuration (``configs/<config>.json`` by the
configuration's ``file``) and a traffic mix (``traffic/<mix>.json``). The
mix names its driver (``drivers/<driver>.py``: set-up, window, check)
and its generator (``generators/<generator>.py``). Every metric is a
reader of its own, ``metrics/<name>.py``, with ``read(run)`` returning a
number or None; the harness asks the cell's end-to-end metrics in an
untraced run and its per-layer metrics in a traced one, and leaves out a
metric whose reader finds nothing to read. Adding a configuration, a
mix, a cell or a metric therefore takes new files and new entries only.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

# modules whose presence in the process the harness refuses: JAX and the
# JAX package the program was ported from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tnn_tpu")


def load_benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, base: Path) -> ModuleType:
    """``<base>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = base / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {name!r} at {path}")
    key = f"portbench._{kind}_{name.replace('.', '_').replace('-', '_')}" \
        f"_{abs(hash(str(base)))}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its pieces resolved."""
    name: str
    base: Path              # the benchmark's directory: its pieces by kind
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: dict, workload: str, root: Path) -> Cell:
    """The cell named ``workload``, its configuration and mix read, its
    metrics picked (a metric without ``workloads`` holds for every cell
    that reports the end-to-end metric it moves)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = load_json(root / cfg_entry["file"])
    base = root / bench["paths"][0]
    traffic = load_json(base / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if m["moves"] in names and _applies(m, workload)]
    return Cell(workload, base, int(w["chips"]), w["config"], config,
                w["traffic"], traffic, e2e, layer)


@dataclass
class Run:
    """One run of a cell: what its driver measured, for the readers.

    ``data`` holds what the driver recorded, by key (each driver's
    docstring lists its keys); ``trace`` the traced sub-window's
    ``devtrace.TraceSummary`` (traced runs only)."""
    cell: Cell
    seed: int
    seconds: float
    traced: bool
    device: Any
    control: str = "off"
    t_start: float = field(default_factory=time.perf_counter)
    setup_s: Optional[float] = None
    memory_peak_bytes: int = 0
    attempted: int = 0
    failed: int = 0
    # name -> (value, limit); a value above its limit is not correct
    checks: Dict[str, tuple] = field(default_factory=dict)
    # name -> value: readings printed beside the checks, compared with
    # nothing
    info: Dict[str, Any] = field(default_factory=dict)
    data: Dict[str, Any] = field(default_factory=dict)
    trace: Any = None

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def module(self, kind: str, name: str) -> ModuleType:
        """The cell's piece of ``kind`` named ``name``."""
        return load_module(kind, name, self.cell.base)

    def setup_done(self) -> None:
        """Close set-up: everything from the process's start to here."""
        self.setup_s = time.perf_counter() - self.t_start

    def limit(self, name: str) -> float:
        return float(self.config["limits"][name])

    def check(self, name: str, value: float) -> None:
        self.checks[name] = (float(value), self.limit(name))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(v) and v <= lim for v, lim in self.checks.values())


def read_metrics(run: Run, specs: List[dict]) -> Dict[str, dict]:
    out = {}
    for m in specs:
        value = run.module("metrics", m["name"]).read(run)
        if value is None:
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules the harness refuses, compared
    whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def result_line(run: Run, device: dict) -> dict:
    """The run's result: metrics of the run's kind, the device, the
    breakdown of a traced run, and the numbers compared last."""
    specs = run.cell.per_layer if run.traced else run.cell.end_to_end
    res = {"correct": run.correct, "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": read_metrics(run, specs),
           "device": device}
    if run.traced and run.trace is not None:
        res["breakdown"] = {
            "device_ops": [[n, s] for n, s in run.trace.device_ops],
            "idle_gaps": [[n, s] for n, s in run.trace.idle_gaps]}
    res["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in run.checks.items()}
    return res
