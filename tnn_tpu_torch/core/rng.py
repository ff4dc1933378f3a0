"""Random draws (``tnn_tpu.core.rng``).

The JAX package threads splittable keys (``split_for``, ``key_stream``)
through its containers. The port has no keys: every consumer draws, in
order, from one explicit ``torch.Generator``, the one ``TrainState``
carries. What a generator is asked for, and in which order, is part of
each consumer's contract:

- a train step draws its augmentation first (``data.augmentation``: each
  op of the pipeline in order, each op its gate and then its own
  parameters), then the forward's dropout masks, layer by layer in the
  order the forward runs them (``nn.layers.Dropout``);
- seeded initialisation (``init_params``) draws every weight in the order
  of the model's parameter tree (``jax_param_paths``).

The two frameworks draw different bits from one seed: a port run is held
to the JAX package's by what a draw must satisfy, not by its values.
"""
from __future__ import annotations

import torch


def make_generator(seed: int, device="cpu") -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``: the port's
    counterpart of ``jax.random.PRNGKey(seed)``."""
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))

