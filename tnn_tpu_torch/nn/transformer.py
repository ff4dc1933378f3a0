"""Pre-LN transformer blocks (``tnn_tpu.nn.transformer``): the GPT
decoder block, with a dense MLP or a mixture-of-experts FFN
(``moe_experts > 0``), and the ViT encoder block, the same block without
the causal mask."""
from __future__ import annotations

from typing import Optional

import torch

from ..core.module import Module, register_module
from .attention import MultiHeadAttention
from .layers import Dense, Dropout
from .moe import MoE
from .norms import LayerNorm
from .run import LocalRun


@register_module("gpt_block")
class GPTBlock(Module):
    """x + drop(attn(ln1(x))), then x + drop(proj(act(fc(ln2(x))))).

    ``backend`` picks the attention backend ("xla" or "pallas", the flash
    kernels); ``dropout`` applies, when training, inside the attention
    block and after each residual branch, drawing from the caller's
    generator in that order. ``kv_cache_dtype="int8"`` quantizes the
    decode cache (``MultiHeadAttention``).

    ``moe_experts > 0`` replaces the MLP by a top-``moe_top_k`` ``MoE`` of
    that many experts (hidden width ``mlp_ratio * d_model``); ``fc`` and
    ``proj`` are None then, ``moe`` None otherwise. The training forward
    keeps the MoE's state (``{"aux_loss": ...}``, ``{}`` for a dense
    block) in ``net_state``; the cached and paged forwards drop it, as the
    JAX block does. MoE draws nothing from the generator (the JAX block
    splits a fourth key for MoE blocks only, which keeps dense blocks'
    draws unchanged; the port's draws are sequential, so they stay so).

    With ``d_model`` the weights are made at once on ``device``; with None
    (registered as "gpt_block", a ``Sequential`` child) ``build`` sizes
    them from the input."""

    def __init__(self, d_model: Optional[int] = None,
                 num_heads: Optional[int] = None, *, mlp_ratio: int = 4,
                 num_kv_heads: Optional[int] = None, backend: str = "xla",
                 dropout: float = 0.0, kv_cache_dtype: Optional[str] = None,
                 moe_experts: int = 0, moe_top_k: int = 2,
                 causal: bool = True, activation: str = "gelu", name=None,
                 policy=None, device="cuda"):
        super().__init__(name=name, policy=policy)
        p = self.policy
        self.num_heads = int(num_heads)
        self.num_kv_heads = int(num_kv_heads) if num_kv_heads \
            else self.num_heads
        self.kv_cache_dtype = kv_cache_dtype
        self.mlp_ratio = int(mlp_ratio)
        self.dropout = float(dropout)
        self.causal = bool(causal)
        self.backend = backend
        self.activation = activation
        self.moe_experts = int(moe_experts)
        self.moe_top_k = int(moe_top_k)
        self.net_state: dict = {}
        self.ln1 = LayerNorm(None, policy=p)
        self.attn = MultiHeadAttention(None, num_heads,
                                       num_kv_heads=num_kv_heads,
                                       causal=causal, backend=backend,
                                       dropout=dropout,
                                       kv_cache_dtype=kv_cache_dtype,
                                       policy=p)
        self.drop = Dropout(dropout)
        self.ln2 = LayerNorm(None, policy=p)
        self.moe = self.fc = self.proj = None
        if self.moe_experts > 0:
            self.moe = MoE(None, self.moe_experts, top_k=self.moe_top_k,
                           activation=activation,
                           hidden_ratio=self.mlp_ratio, policy=p)
            # capacity tells identical padding rows apart, and a paged
            # decode step's padding rows read back the scratch slot they
            # all write: its writer must not vary from run to run
            self.attn.last_writer_scatter = True
        if d_model is not None:
            self.build((1, int(d_model)), device)

    def _build(self, input_shape, device):
        d = int(input_shape[-1])
        for part in (self.ln1, self.attn, self.ln2, self.moe):
            if part is not None:
                part.build(input_shape, device)
        if self.moe is None:
            p = self.policy
            self.fc = Dense(d, self.mlp_ratio * d,
                            activation=self.activation, policy=p,
                            device=device)
            self.proj = Dense(self.mlp_ratio * d, d, policy=p, device=device)

    def _param_slots(self):
        """(path in the block's JAX tree, owning module, attribute) of each
        weight."""
        parts = ("ln1", "attn", "ln2") + (("moe",) if self.moe is not None
                                          else ("fc", "proj"))
        for key in parts:
            for path, owner, attr in getattr(self, key)._param_slots():
                yield (key,) + path, owner, attr

    def _state_slots(self):
        # the JAX block's state is its MoE's, not nested under "moe"
        if self.moe is not None:
            yield from self.moe._state_slots()

    def _config(self):
        cfg = {"num_heads": self.num_heads, "mlp_ratio": self.mlp_ratio,
               "dropout": self.dropout, "causal": self.causal,
               "backend": self.backend, "activation": self.activation}
        if self.num_kv_heads != self.num_heads:
            cfg["num_kv_heads"] = self.num_kv_heads
        if self.kv_cache_dtype:
            cfg["kv_cache_dtype"] = self.kv_cache_dtype
        if self.moe_experts:
            cfg["moe_experts"] = self.moe_experts
            cfg["moe_top_k"] = self.moe_top_k
        return cfg

    def _ffn(self, h, train=False):
        """The MLP or the MoE over ln2's output: (out, the layer's
        state)."""
        if self.moe is not None:
            out = self.moe(h, train=train)
            return out, {"aux_loss": self.moe.last_aux}
        return self.proj(self.fc(h)), {}

    def _mlp(self, x, train=False, generator=None):
        """x + drop(ffn(ln2(x))) and the layer's state."""
        h, state = self._ffn(self.ln2(x), train)
        return x + self.drop(h, train=train, generator=generator), state

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.run(x, LocalRun(train, generator))

    def run(self, x, run):
        """The forward under ``run`` (``nn.run``: one device, or the
        parallel step's streams)."""
        h = run.layer(self.attn, run.layer(self.ln1, x))
        x = run.add(x, run.layer(self.drop, h))
        h = run.layer(self.ln2, x)
        if self.moe is not None:
            h = run.layer(self.moe, h)
            self.net_state = {"aux_loss": self.moe.last_aux}
        else:
            h = run.mlp(self.fc, [self.fc], self.proj, h)
            self.net_state = {}
        return run.add(x, run.layer(self.drop, h))

    def init_cache(self, batch: int, max_len: int):
        return self.attn.init_cache(batch, max_len)

    def apply_cached(self, x, cache, offset):
        """``forward`` for new tokens at ``offset`` against a KV cache that
        it updates in place; see ``MultiHeadAttention.apply_cached``."""
        h, cache = self.attn.apply_cached(self.ln1(x), cache, offset)
        return self._mlp(x + h)[0], cache

    def apply_paged(self, x, pages_k, pages_v, block_tables, offsets, layer,
                    q_lens=None):
        """``forward`` against the paged KV pool; see
        ``MultiHeadAttention.apply_paged`` for the contract."""
        h = self.attn.apply_paged(self.ln1(x), pages_k, pages_v,
                                  block_tables, offsets, layer=layer,
                                  q_lens=q_lens)
        return self._mlp(x + h)[0]


@register_module("encoder_block")
class EncoderBlock(GPTBlock):
    """The non-causal pre-LN encoder block of a ViT
    (``tnn_tpu.nn.transformer.EncoderBlock``): ``GPTBlock`` with
    ``causal=False``."""

    def __init__(self, d_model: Optional[int] = None,
                 num_heads: Optional[int] = None, *, mlp_ratio: int = 4,
                 backend: str = "xla", dropout: float = 0.0,
                 activation: str = "gelu", name=None, policy=None,
                 device="cuda"):
        super().__init__(d_model, num_heads, mlp_ratio=mlp_ratio,
                         backend=backend, dropout=dropout, causal=False,
                         activation=activation, name=name, policy=policy,
                         device=device)

    def _config(self):
        cfg = super()._config()
        cfg.pop("causal")
        return cfg
