"""The program's GPT-2 (``tnn_tpu_torch.models.gpt2.GPT2``) built from a
configuration file, holding the benchmark's weights for the run's seed.

The configuration gives OpenAI's keys (``n_layer``, ``n_embd``,
``n_head``, ``n_positions``, ``vocab_size``, ``tie_word_embeddings``)
and the precision policy by the program's name; ``attention`` picks the
program's attention backend ("flash" for its hand-written flash
kernels, "paged" for the serving path's default)."""
from __future__ import annotations

from portbench import weights

BACKENDS = {"flash": "pallas", "paged": "xla"}


def build(cfg: dict, seed: int, device, train: bool = False):
    from tnn_tpu_torch.core import dtypes as dt
    from tnn_tpu_torch.models.gpt2 import GPT2

    policy = {"mixed_bfloat16": dt.MIXED_BF16,
              "float32": dt.FP32}[cfg["precision"]["policy"]]
    model = GPT2(vocab_size=cfg["vocab_size"], max_len=cfg["n_positions"],
                 num_layers=cfg["n_layer"], d_model=cfg["n_embd"],
                 num_heads=cfg["n_head"],
                 backend=BACKENDS[cfg["attention"]],
                 dropout=float(cfg["resid_pdrop"]) if train else 0.0,
                 tie_embeddings=bool(cfg["tie_word_embeddings"]),
                 policy=policy, device=device, seed=None)
    w = weights.make_gpt2(cfg, seed, device)
    model.load_jax_params(weights.nest(w))
    return model
