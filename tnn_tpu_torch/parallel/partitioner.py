"""Split a ``Sequential`` into pipeline stages (``tnn_tpu.parallel.
partitioner``).

``split`` rebuilds each layer range from its layers' configs into a fresh
``Sequential`` named ``stage{i}`` (unbuilt: the pipeline sizes each stage
on its device). ``proportional_partitions`` cuts by layer counts,
``balanced_partitions`` greedily by the forward FLOPs ``layer_flops``
estimates, with the JAX package's rule, so both packages cut the same
model at the same points.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

from ..core.module import Module, config_module
from ..nn.blocks import Sequential


@dataclasses.dataclass(frozen=True)
class SeqPartition:
    """A stage's layer range: ``length`` layers from ``start``."""

    start: int
    length: int


def split(model: Sequential,
          partitions: Sequence[SeqPartition]) -> List[Sequential]:
    """Each partition's layers cloned through their configs into a stage."""
    stages = []
    for i, part in enumerate(partitions):
        children = model.layers[part.start:part.start + part.length]
        cloned = [config_module(c.get_config()) for c in children]
        stages.append(Sequential(cloned, name=f"stage{i}",
                                 policy=model.policy))
    return stages


def proportional_partitions(num_layers: int, proportions: Sequence[float]
                            ) -> List[SeqPartition]:
    """Layer counts in the given proportions (at least one a stage)."""
    if num_layers < len(proportions):
        raise ValueError(f"cannot split {num_layers} layers into "
                         f"{len(proportions)} stages")
    total = sum(proportions)
    counts = [max(1, round(num_layers * p / total)) for p in proportions]
    while sum(counts) > num_layers:
        counts[counts.index(max(counts))] -= 1
    while sum(counts) < num_layers:
        counts[counts.index(min(counts))] += 1
    parts, start = [], 0
    for c in counts:
        parts.append(SeqPartition(start, c))
        start += c
    return parts


def layer_flops(layer: Module, input_shape: Tuple[int, ...]) -> float:
    """A rough forward FLOPs count of one layer (the JAX package's rule:
    dense and conv products, attention blocks' projections, scores and
    MLP, containers summed, anything else one pass over its output)."""
    out_shape = layer.output_shape(tuple(input_shape))
    t = layer.type_name
    if t == "dense":
        return 2.0 * math.prod(input_shape) * out_shape[-1]
    if t == "conv2d":
        kh, kw = layer.kernel_size
        cin = input_shape[-1] // layer.groups
        return 2.0 * math.prod(out_shape) * kh * kw * cin
    if t in ("multihead_attention", "gpt_block", "encoder_block"):
        n, s, d = input_shape[0], input_shape[-2], input_shape[-1]
        proj = 8.0 * n * s * d * d
        attn = 4.0 * n * s * s * d
        mlp = 0.0
        if t in ("gpt_block", "encoder_block"):
            mlp = 4.0 * n * s * d * d * layer.mlp_ratio
        return proj + attn + mlp
    if t in ("sequential", "residual", "parallel"):
        total, shape = 0.0, tuple(input_shape)
        for child in layer.layers:
            total += layer_flops(child, shape)
            if t == "sequential":
                shape = child.output_shape(shape)
        return total
    return float(math.prod(out_shape))


def balanced_partitions(model: Sequential, num_stages: int,
                        input_shape: Tuple[int, ...],
                        weights: Optional[Sequence[float]] = None
                        ) -> List[SeqPartition]:
    """A contiguous split into ``num_stages`` of about equal FLOPs (each
    stage's share scaled by ``weights``): a stage is cut where its running
    cost reaches its share, or where the layers left equal the stages
    left."""
    costs = []
    shape = tuple(input_shape)
    for child in model.layers:
        costs.append(layer_flops(child, shape))
        shape = child.output_shape(shape)
    n = len(costs)
    if num_stages > n:
        raise ValueError(f"cannot split {n} layers into {num_stages} "
                         "stages")
    weights = list(weights) if weights else [1.0] * num_stages
    total = sum(costs)
    wsum = sum(weights)
    parts: List[SeqPartition] = []
    start, acc, stage = 0, 0.0, 0
    for i, c in enumerate(costs):
        acc += c
        remaining_layers = n - i - 1
        remaining_stages = num_stages - stage - 1
        share = total * weights[stage] / wsum
        if stage < num_stages - 1 and (
                acc >= share or remaining_layers == remaining_stages):
            parts.append(SeqPartition(start, i - start + 1))
            start, acc, stage = i + 1, 0.0, stage + 1
    parts.append(SeqPartition(start, n - start))
    return parts


def partition_model(model: Sequential, num_stages: int,
                    input_shape: Tuple[int, ...],
                    strategy: str = "balanced") -> List[Sequential]:
    """``split`` at ``balanced_partitions``' or equal layer counts'
    cut points."""
    return split(model, partition_points(model, num_stages, input_shape,
                                         strategy))


def partition_points(model: Sequential, num_stages: int,
                     input_shape: Tuple[int, ...],
                     strategy: str = "balanced") -> List[SeqPartition]:
    """The cut points ``partition_model`` splits at."""
    if strategy == "balanced":
        return balanced_partitions(model, num_stages, input_shape)
    if strategy == "uniform":
        return proportional_partitions(len(model.layers),
                                       [1.0] * num_stages)
    raise ValueError(f"unknown strategy {strategy!r}")
