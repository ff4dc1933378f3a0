"""``TrainingConfig`` (``tnn_tpu.utils.config``): defaults, overlaid by the
environment (``load_from_env``, the JAX package's variable names) and by a
JSON file (``load_from_json``, where an unknown key raises). The same
fields as the JAX package's, so one JSON file configures either package;
``make_optimizer``, ``make_scheduler`` and ``make_policy`` build the
port's optimizer, scheduler and ``core.dtypes.DTypePolicy``.
``mesh_axes`` lays a run out over a mesh (``train.loop``): "data",
"fsdp", "model", "seq" (with ``seq_parallel_method``) and "expert", or
"pipe" (with ``num_microbatches`` and ``pipeline_virtual``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional

from .env import Env


@dataclasses.dataclass
class TrainingConfig:
    # trainer params
    epochs: int = 10
    batch_size: int = 32
    max_steps: int = -1  # -1 = no limit; else max batches per epoch
    lr_initial: float = 1e-3
    gradient_accumulation_steps: int = 1
    progress_print_interval: int = 100
    profiler_type: str = "NONE"  # NONE | NORMAL | CUMULATIVE
    print_memory_usage: bool = False
    model_name: str = "cifar10_resnet9"
    model_path: str = ""  # load checkpoint from here before training
    dataset_name: str = ""
    dataset_path: str = "data"
    io_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # distributed params
    num_microbatches: int = 2
    mesh_axes: Dict[str, int] = dataclasses.field(default_factory=dict)
    # rematerialize the forward in the backward (memory for FLOPs): False |
    # True | a policy name ("dots", "dots_no_batch", "offload_dots"); see
    # train.step.make_train_step
    remat: Any = False
    # pipeline runs: virtual (interleaved) stages per device (the JAX
    # package's; the port has no pipeline runs yet)
    pipeline_virtual: int = 1
    seq_parallel_method: str = "ring"  # "ring" (K/V rotation) | "ulysses" (all-to-all)

    shuffle: bool = True
    optimizer: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"type": "sgd", "lr": 0.001})
    scheduler: Optional[Dict[str, Any]] = None
    # name, or {"type": name, **kwargs} (e.g. label_smoothing) — nn.losses.get
    loss: Any = "softmax_cross_entropy"
    seed: int = 0
    snapshot_dir: str = "model_snapshots"
    resume: str = ""  # checkpoint dir to resume full training state from
    log_file: str = ""

    # -- loading --------------------------------------------------------------

    def load_from_env(self) -> "TrainingConfig":
        """Overlay environment variables (EPOCHS, BATCH_SIZE, MAX_STEPS,
        ...: the JAX package's names)."""
        self.epochs = Env.get("EPOCHS", self.epochs)
        self.batch_size = Env.get("BATCH_SIZE", self.batch_size)
        self.max_steps = Env.get("MAX_STEPS", self.max_steps)
        self.lr_initial = Env.get("LR_INITIAL", self.lr_initial)
        self.gradient_accumulation_steps = Env.get(
            "GRADIENT_ACCUMULATION_STEPS", self.gradient_accumulation_steps)
        self.progress_print_interval = Env.get(
            "PROGRESS_PRINT_INTERVAL", self.progress_print_interval)
        self.profiler_type = Env.get("PROFILER_TYPE", self.profiler_type).upper()
        self.print_memory_usage = Env.get("PRINT_MEMORY_USAGE", self.print_memory_usage)
        self.model_name = Env.get("MODEL_NAME", self.model_name)
        self.model_path = Env.get("MODEL_PATH", self.model_path)
        self.dataset_name = Env.get("DATASET_NAME", self.dataset_name)
        self.dataset_path = Env.get("DATASET_PATH", self.dataset_path)
        self.io_dtype = Env.get("IO_DTYPE", self.io_dtype)
        self.param_dtype = Env.get("PARAM_DTYPE", self.param_dtype)
        self.compute_dtype = Env.get("COMPUTE_DTYPE", self.compute_dtype)
        self.num_microbatches = Env.get("NUM_MICROBATCHES", self.num_microbatches)
        self.seed = Env.get("SEED", self.seed)
        self.snapshot_dir = Env.get("SNAPSHOT_DIR", self.snapshot_dir)
        self.resume = Env.get("RESUME", self.resume)
        self.loss = Env.get("LOSS", self.loss)
        return self

    def load_from_json(self, path: str) -> "TrainingConfig":
        """Overlay a JSON file; an unknown key raises (a typo must not be
        ignored)."""
        with open(path, "r", encoding="utf-8") as f:
            cfg = json.load(f)
        return self.update(cfg)

    def update(self, cfg: Dict[str, Any]) -> "TrainingConfig":
        known = {f.name for f in dataclasses.fields(self)}
        unknown = set(cfg) - known
        if unknown:
            raise KeyError(f"unknown TrainingConfig keys: {sorted(unknown)}; "
                           f"known: {sorted(known)}")
        for k, v in cfg.items():
            setattr(self, k, v)
        return self

    # -- introspection --------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    def print_config(self) -> None:
        """Print every field, one a line."""
        print("Training configuration:")
        for k, v in self.to_dict().items():
            print(f"  {k}: {v}")

    # -- factory helpers ------------------------------------------------------

    def make_optimizer(self):
        from ..nn import optimizers

        cfg = dict(self.optimizer)
        cfg.setdefault("type", "sgd")
        if "lr" not in cfg:
            cfg["lr"] = self.lr_initial
        return optimizers.from_config(cfg)

    def make_scheduler(self):
        from ..nn import schedulers

        if not self.scheduler:
            return schedulers.NoOp()
        return schedulers.from_config(dict(self.scheduler))

    def make_policy(self):
        from ..core import dtypes

        return dtypes.DTypePolicy(io=self.io_dtype, param=self.param_dtype,
                                  compute=self.compute_dtype)
