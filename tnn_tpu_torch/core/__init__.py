"""The core (``tnn_tpu.core``): dtype policies, the config-built
``Module`` and its registry, and seeded generators."""
from . import dtypes, module, rng

__all__ = ["dtypes", "module", "rng"]
