"""The benchmark's frozen arithmetic: the H100's peaks, the work of a GPT-2
step and of the flash kernels, kernel names, and the statistics the
metrics take.

Nothing here imports the program: a change to the program cannot move
the yardstick. The formulas were copied from the program's chip tools
(the peaks, ``model_flops_per_step``, ``flash_work`` and ``kernel_label``
of ``chip_smoke.py``), with the flash kernels' live-pair count rewritten
from shapes alone.
"""
from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Optional, Sequence, Tuple

# NVIDIA H100 SXM data sheet: dense rates, no sparsity, at 700 W
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12,      # tensor cores
            "int8": 1979e12,         # tensor cores
            "float32": 67e12}        # outside the tensor cores


def model_flops_per_step(layers: int, d_model: int, vocab: int, batch: int,
                         seq: int) -> float:
    """A GPT-2 train step's model FLOPs: 6 x (weights in matmuls, the tied
    head included: 12 L d^2 + V d) per token, plus causal attention 6 L S d
    per token (QK and PV over S/2 keys on average, forward and the
    backward's twice as much)."""
    n = 12 * layers * d_model ** 2 + vocab * d_model
    return float((6 * n + 6 * layers * seq * d_model) * batch * seq)


def block_flops_per_token(layers: int, d_model: int) -> float:
    """Forward FLOPs of one token through the blocks' matmuls (qkv, out,
    fc, proj: 12 d^2 weights a layer), without attention."""
    return 2.0 * 12 * layers * d_model ** 2


def attention_flops(layers: int, d_model: int, keys: int) -> float:
    """Forward FLOPs of one query attending over ``keys`` positions (its
    own included): QK and PV, 2 d each per key, in every layer."""
    return 4.0 * layers * d_model * keys


def head_flops(vocab: int, d_model: int) -> float:
    """Forward FLOPs of the head for one sampled position."""
    return 2.0 * vocab * d_model


def serve_request_flops(layers: int, d_model: int, vocab: int,
                        prompt_len: int, first: int, stop: int) -> float:
    """The forward FLOPs that produced output tokens ``first`` .. ``stop``
    - 1 of a request with a ``prompt_len``-token prompt. Output token j is
    sampled at position ``prompt_len - 1 + j``: that position's pass
    through the blocks, its attention over ``prompt_len + j`` keys and the
    head. Token 0 also carries the prefill of the prompt's other
    positions (blocks and attention, no head)."""
    if stop <= first:
        return 0.0
    blocks = block_flops_per_token(layers, d_model)
    head = head_flops(vocab, d_model)
    total = 0.0
    if first == 0:
        p = prompt_len - 1                  # positions 0 .. P-2
        total += p * blocks + attention_flops(layers, d_model,
                                              p * (p + 1) // 2)
    n = stop - first
    # keys over j = first .. stop-1: sum of (prompt_len + j)
    keys = n * prompt_len + (first + stop - 1) * n // 2
    total += n * (blocks + head) + attention_flops(layers, d_model, keys)
    return total


def causal_pairs(batch: int, heads: int, seq: int) -> int:
    """Live (query, key) pairs of causal self-attention over ``seq``."""
    return batch * heads * seq * (seq + 1) // 2


def flash_work(batch: int, heads: int, seq: int, head_dim: int,
               elem_bytes: int, causal: bool = True
               ) -> Tuple[Tuple[float, float], Tuple[float, float]]:
    """((bytes, operations) of the flash forward, (bytes, operations) of
    the fused backward) for self-attention of this shape without a mask.
    Bytes: each input read once and each output written once (forward:
    q, k, v, O and the f32 logsumexp; backward: q, k, v, O, dO and the
    logsumexp, then dQ, dK, dV). Operations: 2 D per product per live
    (query, key) pair, 2 products forward (QK, PV) and 5 backward."""
    pairs = causal_pairs(batch, heads, seq) if causal \
        else batch * heads * seq * seq
    rows = batch * heads * seq
    qo = kv = rows * head_dim * elem_bytes
    fwd = (2 * qo + 2 * kv + 4 * rows, 4 * head_dim * pairs)
    bwd = (3 * qo + 2 * kv + 4 * rows + qo + 2 * kv, 10 * head_dim * pairs)
    return (float(fwd[0]), float(fwd[1])), (float(bwd[0]), float(bwd[1]))


def least_time_s(nbytes: float, ops: float, dtype: str = "bfloat16"
                 ) -> float:
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over HBM bandwidth."""
    return max(ops / PEAK_OPS[dtype], nbytes / HBM_BYTES_PER_S)


def kernel_label(name: str) -> str:
    """A CUDA kernel's profiler name without its return type, namespace
    and arguments: ``flash_bwd_wgmma_kernel<64, false>``."""
    name = name.replace("(anonymous namespace)::", "")
    return name[5:].split("(")[0] if name.startswith("void ") else \
        name.split("(")[0]


def kernel_base(name: str) -> str:
    """``kernel_label`` without template arguments."""
    return kernel_label(name).split("<")[0].strip()


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of all values:
    the smallest value with at least q% of the values at or below it.
    None for no values."""
    if not values:
        return None
    s = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(s)))
    return float(s[k - 1])


def spread(values: Iterable[float]) -> float:
    """The distance between the first and the third quartile as a share
    of the median (``statistics.quantiles`` with n=4)."""
    v: List[float] = list(values)
    q1, med, q3 = statistics.quantiles(v, n=4)
    return (q3 - q1) / med
