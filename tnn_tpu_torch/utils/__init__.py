"""Host utilities (``tnn_tpu.utils``): the ``.env`` loader and typed
getters, ``TrainingConfig``, loggers, host and card readings, and the
power-of-two bucketing of the serving programs."""
from .bucketing import pow2_bucket
from .config import TrainingConfig
from .env import Env, load_env_file
from .hardware import device_info, hbm_stats, memory_usage_kb
from .logging import Logger, get_logger

__all__ = ["Env", "load_env_file", "TrainingConfig", "Logger", "get_logger",
           "device_info", "hbm_stats", "memory_usage_kb", "pow2_bucket"]
