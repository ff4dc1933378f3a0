"""Vision Transformer (``tnn_tpu.models.vit``): patchify (a VALID conv of
stride ``patch_size``) -> class token -> learned positional embedding ->
encoder blocks -> LayerNorm -> the head on the class token.
``backend="pallas"`` runs the flash-attention kernels (K4 forward, K7
backward: ``flash_vit``, non-causal at S = (H / p) * (W / p) + 1)."""
from __future__ import annotations

from torch import nn

from ..core.module import Module, register_module
from ..nn.embedding import ClassToken, PositionalEmbedding
from ..nn.layers import Conv2D, Dense, Dropout
from ..nn.norms import LayerNorm
from ..nn.transformer import EncoderBlock


@register_module("vit")
class ViT(Module):
    """A ViT; ``init(input_shape, device=, seed=)`` sizes it (the
    positional table holds one row per patch plus the class token).

    Its parameter tree is the JAX model's: "patch", "cls", "pos", "ln",
    "head" and one "h{i}" per block; it has no state."""

    def __init__(self, num_classes: int = 200, patch_size: int = 8,
                 d_model: int = 384, num_layers: int = 6,
                 num_heads: int = 6, mlp_ratio: int = 4,
                 dropout: float = 0.0, backend: str = "xla", name=None,
                 policy=None):
        super().__init__(name=name, policy=policy)
        self.num_classes = int(num_classes)
        self.patch_size = int(patch_size)
        self.d_model = int(d_model)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.mlp_ratio = int(mlp_ratio)
        self.dropout = float(dropout)
        self.backend = backend
        p = self.policy
        self.patch = Conv2D(d_model, patch_size, strides=patch_size,
                            padding="valid", policy=p)
        self.cls = ClassToken(policy=p)
        self.pos = PositionalEmbedding(policy=p)
        self.drop = Dropout(dropout, policy=p)
        self.ln = LayerNorm(policy=p)
        self.head = Dense(None, num_classes, policy=p)
        self.blocks = nn.ModuleList()

    def _parts(self):
        return (("patch", self.patch), ("cls", self.cls), ("pos", self.pos),
                ("ln", self.ln), ("head", self.head))

    def _build(self, input_shape, device):
        n, h, w, _ = input_shape
        patches = self.patch.build(input_shape, device)
        tokens = self.cls.build((n, patches[1] * patches[2], self.d_model),
                                device)
        self.pos.build(tokens, device)
        self.ln.build(tokens, device)
        self.head.build((n, self.d_model), device)
        self.blocks = nn.ModuleList(
            EncoderBlock(self.d_model, self.num_heads,
                         mlp_ratio=self.mlp_ratio, backend=self.backend,
                         dropout=self.dropout, policy=self.policy,
                         device=device)
            for _ in range(self.num_layers))

    def _param_slots(self):
        for key, part in self._parts():
            for path, owner, attr in part._param_slots():
                yield (key,) + path, owner, attr
        for i, blk in enumerate(self.blocks):
            for path, owner, attr in blk._param_slots():
                yield (f"h{i}",) + path, owner, attr

    def forward(self, x, *, train=False, generator=None):
        x = self.patch(x)
        n, h, w, d = x.shape
        x = self.pos(self.cls(x.reshape(n, h * w, d)))
        x = self.drop(x, train=train, generator=generator)
        for blk in self.blocks:
            x = blk(x, train=train, generator=generator)
        return self.head(self.ln(x)[:, 0])

    def output_shape(self, input_shape):
        return (input_shape[0], self.num_classes)

    def _config(self):
        return {"num_classes": self.num_classes,
                "patch_size": self.patch_size, "d_model": self.d_model,
                "num_layers": self.num_layers, "num_heads": self.num_heads,
                "mlp_ratio": self.mlp_ratio, "dropout": self.dropout,
                "backend": self.backend}
