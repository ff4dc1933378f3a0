"""Fused whole-stack decode (``tnn_tpu/ops/pallas/decode_stack.py``): every
GPT-2 block of one w8a8 decode step in one kernel launch (K8).

Int8 decode at small batch is bound by the host, not the card: the unfused
step issues a few thousand small ops per token (49 matmuls, each with
w8a8's quantize and rescale passes, plus norms, attention and cache
writes). K8 runs all L blocks of one step in a single launch.

``fused_decode_stack(x, t, k_cache, v_cache, stacks, *, num_heads,
chunks)``:

  x : (B, D) the embedded tokens (wte + wpe), f32 or bf16;
  t : the position every row writes (the lockstep offset), an int;
  k_cache, v_cache : (L, B, T, D) f32 or bf16, rows [0, t) filled;
  stacks : the layer-stacked weights of ``models.fused_decode.
      stack_decode_weights`` (``STACK_KEYS``): int8 ``qkv_q`` (L, 3D, D),
      ``out_q`` (L, D, D), ``fc_q`` (L, F, D), ``proj_q`` (L, D, F) and f32
      per-layer vectors.

It returns ``(x_out, k_cache, v_cache)``: x_out (B, D) in x's dtype, and
the two caches, which are updated IN PLACE at row t (the JAX call aliases
them and returns new arrays; here they are the caller's tensors).

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/decode_stack.cu``) on the current stream, or raises; on a CPU
tensor it computes ``fused_decode_stack_reference``, the plain PyTorch
version. ``fused_decode_stack.launches`` counts the kernel launches.
The kernel's launch plan reads shapes only, and this module mirrors it
for the tests: ``plan_partition`` (each block's contiguous rows of every
matrix, the same in every layer), ``plan_stages`` (the ring stages of a
block's share), ``plan_splits`` (attention's split of positions 0..t) and
``barriers_per_step`` (5 L - 1 grid barriers); ``check_kernel_geometry``
holds its refusals and its shared-memory rule.

Numerics, as the TPU kernel's body (``_decode_kernel``):

  * the residual ``x_acc`` is f32 across all L layers;
  * LayerNorm is one-pass: var = max(E[x^2] - E[x]^2, 0), eps 1e-5, f32,
    ``y = (x - mean) * rsqrt(var + eps) * scale + bias``;
  * each matmul input (ln1 out, attention context, ln2 out, gelu out) is
    quantized per row: sx = absmax / 127 (1.0 for a zero row), codes
    round-half-even(x / sx) clipped to +-127; the int8 x int8 products are
    exact, rescaled as ``acc * sx * w_scale + bias`` in that order;
  * q stays f32; k and v are cast to the cache dtype and written at row t
    before attention reads the cache; attention over rows 0..t takes the
    softmax as p / sum(p) per head (the kernel sums exp(s - m) v over
    ranges of positions and divides by the whole row's sum once per
    output, which moves only roundings);
  * x_acc = x_mid + proj_b, then plus each MLP chunk's part in chunk order:
    the MLP runs in ``chunks`` chunks of F, and the GELU (tanh) output is
    quantized per chunk, so the chunk count changes the numerics;
  * x_out is x_acc cast to x's dtype once, at the end.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import numpy as np
import torch

from . import runtime

STACK_KEYS = ("ln1_s", "ln1_b", "ln2_s", "ln2_b", "qkv_q", "qkv_s", "qkv_b",
              "out_q", "out_s", "out_b", "fc_q", "fc_s", "fc_b", "proj_q",
              "proj_s", "proj_b")
# the kernel keeps one int32 sum per row in registers
MAX_BATCH = 16
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 227 * 1024          # shared memory a block may use (H100)
# jax.nn.gelu(approximate=True)'s constant: np.sqrt(2 / np.pi) in f32
_SQRT_2_OVER_PI = float(np.float32(np.sqrt(2 / np.pi)))


# -- the plain version --------------------------------------------------------

def _layernorm(x, scale, bias, eps=1e-5):
    # sum / D, as jnp.mean and the kernel (torch's mean multiplies by 1/D)
    d = x.shape[-1]
    mean = x.sum(dim=-1, keepdim=True) / d
    mean2 = (x * x).sum(dim=-1, keepdim=True) / d
    var = (mean2 - mean * mean).clamp_min(0.0)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * scale + bias


def _quant_rows(x):
    """Per-row symmetric int8 (w8a8's): codes and the (B, 1) f32 scale."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    sx = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 127.0)
    return torch.round(x / sx).clamp(-127, 127), sx


def _i8dot(codes, w_q):
    """(B, K) codes x (N, K) int8 -> (B, N) f32 of the exact integer sums.
    Every partial sum is an integer below 127 * 127 * K < 2^53, so the f64
    product is exact on either device, and its cast rounds as the int32
    sum's does."""
    return (codes.double() @ w_q.double().t()).float()


def _gelu(x):
    cube = x * x * x
    return x * (0.5 * (1.0 + torch.tanh(
        _SQRT_2_OVER_PI * (x + 0.044715 * cube))))


def _attention(q, kc, vc, t, num_heads):
    """q (B, D) f32 against cache rows 0..t of (B, T, D): per head, f32
    scores, the max, exp, p / sum(p), then p @ V."""
    b, d = q.shape
    dh = d // num_heads
    k = kc[:, :t + 1].float().reshape(b, t + 1, num_heads, dh)
    v = vc[:, :t + 1].float().reshape(b, t + 1, num_heads, dh)
    s = torch.einsum("bhd,bjhd->bhj", q.reshape(b, num_heads, dh), k) \
        * (1.0 / math.sqrt(dh))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhj,bjhd->bhd", p, v).reshape(b, d)


def fused_decode_stack_reference(x, t, k_cache, v_cache, stacks, *,
                                 num_heads: int, chunks: int = 2,
                                 code_steps=None):
    """Plain PyTorch ``fused_decode_stack``: the kernel's parity oracle, at
    the same rounding points (module docstring). Writes row t of both
    caches in place.

    ``code_steps``, a dict, receives for each matmul ("qkv", "out", "fc",
    "proj") the list over layers (and chunks) of one int8 step of its
    input times the largest weight it meets: max row scale x 127 x max
    channel scale. That is the most one activation code that rounds to
    its other neighbour moves an output of that matmul, which is what a
    kernel's other summation order can do at a tie."""
    t = int(t)
    s = stacks
    d = x.shape[1]
    f = s["fc_s"].shape[1]
    fc_w = f // chunks

    def matmul(site, codes, sx, w_q, w_s):
        if code_steps is not None:
            code_steps.setdefault(site, []).append(
                float(sx.max()) * 127.0 * float(w_s.max()))
        return _i8dot(codes, w_q) * sx * w_s

    x_acc = x.float()
    for layer in range(k_cache.shape[0]):
        h = _layernorm(x_acc, s["ln1_s"][layer], s["ln1_b"][layer])
        qkv = matmul("qkv", *_quant_rows(h), s["qkv_q"][layer],
                     s["qkv_s"][layer]) + s["qkv_b"][layer]
        q, k_new, v_new = qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:]
        k_cache[layer, :, t] = k_new.to(k_cache.dtype)
        v_cache[layer, :, t] = v_new.to(v_cache.dtype)
        ctx = _attention(q, k_cache[layer], v_cache[layer], t, num_heads)
        x_mid = x_acc + (matmul("out", *_quant_rows(ctx), s["out_q"][layer],
                                s["out_s"][layer]) + s["out_b"][layer])
        h = _layernorm(x_mid, s["ln2_s"][layer], s["ln2_b"][layer])
        codes, sx = _quant_rows(h)
        x_acc = x_mid + s["proj_b"][layer]
        for c in range(chunks):
            cols = slice(c * fc_w, (c + 1) * fc_w)
            fc = matmul("fc", codes, sx, s["fc_q"][layer, cols],
                        s["fc_s"][layer, cols]) + s["fc_b"][layer, cols]
            x_acc = x_acc + matmul("proj", *_quant_rows(_gelu(fc)),
                                   s["proj_q"][layer][:, cols],
                                   s["proj_s"][layer])
    return x_acc.to(x.dtype), k_cache, v_cache


# -- the launch plan ----------------------------------------------------------
# csrc/decode_stack.cu: one block per SM of 16 consumer warps and a producer
# warp that streams the block's weight rows into a ring of STAGE_BYTES
# stages; these functions mirror the kernel's own plan, from shapes only.

CONSUMER_WARPS = 16
STAGE_BYTES = 24 * 1024
MIN_RING_STAGES = 2
MAX_RING_STAGES = 16
MIN_SPLIT_LEN = 64                # positions for each split, at least
MAX_SPLIT_LEN = 1024              # and at most (its scores in smem)
MAX_SPLITS = MAX_SPLIT_LEN // 4   # the merge's (m, l, weight) there
_SMALL_BYTES = 2048


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _up16(n: int) -> int:
    return _cdiv(n, 16) * 16


def plan_partition(n_rows: int, blocks: int):
    """The rows [r0, r1) of an ``n_rows``-row matrix that each of
    ``blocks`` blocks owns: contiguous, in block order, covering every row
    once. The same in every layer, so the L-layer launch equals the chain
    of one-layer launches."""
    return [(n_rows * i // blocks, n_rows * (i + 1) // blocks)
            for i in range(blocks)]


def matrix_shapes(d_model: int, d_ff: int):
    """(output rows, bytes a row) of qkv, out, fc (all chunks) and proj."""
    return {"qkv": (3 * d_model, d_model), "out": (d_model, d_model),
            "fc": (d_ff, d_model), "proj": (d_model, d_ff)}


def plan_stages(rows: int, row_bytes: int):
    """(stages, rows a stage) of a block's share: whole rows, at most
    STAGE_BYTES a stage, spread evenly."""
    cap = max(1, STAGE_BYTES // row_bytes)
    n = _cdiv(rows, cap)
    return n, (_cdiv(rows, n) if n else 0)


def plan_splits(batch: int, heads: int, t: int,
                blocks: int = runtime.H100_SMS):
    """(splits, positions a split) of each (row, head)'s positions 0..t:
    as many splits as keep batch x heads x splits within the blocks, at
    most one per MIN_SPLIT_LEN positions (rounded up), and enough that
    none has more than MAX_SPLIT_LEN; none empty. Shapes only (t is a
    host int): the launch needs no sync."""
    n = t + 1
    s = min(max(blocks // (batch * heads), 1), _cdiv(n, MIN_SPLIT_LEN),
            MAX_SPLITS)
    s = max(s, _cdiv(n, MAX_SPLIT_LEN))
    pps = _cdiv(n, s)
    return _cdiv(n, pps), pps


def barriers_per_step(n_layers: int, chunks: int) -> int:
    """K8's grid barriers a launch: five a layer (qkv | attention | out |
    fc | proj) for any chunk count, less the last."""
    del chunks            # the MLP's chunks share the fc and proj phases
    return 5 * n_layers - 1


def _smem_bytes(batch: int, d_model: int, d_ff: int, chunks: int,
                head_dim: int, blocks: int) -> int:
    """Shared memory of one K8 block before its ring (the kernel's
    ``plan_layout``): the stage barriers, the int8 codes of a D-wide
    matmul input, a union of the GELU codes (B x F), LayerNorm's staged
    rows and one attention split's scores and p @ V partials, the next
    LayerNorm's vectors, two buffers of per-row vectors, the block's
    residual columns and int32 sums, and a small region of scales and
    reductions."""
    rq, rf, ro = (_cdiv(n, blocks) for n in (3 * d_model, d_ff, d_model))
    return (_up16(2 * MAX_RING_STAGES * 8) + _up16(batch * d_model)
            + _up16(max(batch * d_ff, 4 * batch * d_model,
                        4 * (MAX_SPLIT_LEN + CONSUMER_WARPS * head_dim)))
            + _up16(8 * d_model) + 2 * _up16(4 * 3 * max(rq, rf))
            + _up16(4 * batch * ro)
            + _up16(4 * batch * max(rq, rf, chunks * ro)) + _SMALL_BYTES)


def ring_stages(smem: int, fixed: int) -> int:
    """The ring stages ``smem`` bytes hold past the ``fixed`` layout."""
    return min(MAX_RING_STAGES, (smem - fixed) // STAGE_BYTES)


def _scratch_floats(batch, d_model, d_ff, chunks, heads, splits, n_layers):
    """f32 scratch of a launch: x_acc, x_mid, q, ctx (B, D) each, the GELU
    outputs (B, F), the split partials (B, H, splits, Dh + 4), and the
    absmax slots of the context (L, B) and the GELU output (L, C, B)."""
    head_dim = d_model // heads
    return (batch * (4 * d_model + d_ff)
            + batch * heads * splits * (head_dim + 4)
            + n_layers * batch * (chunks + 1))


# -- the wrapper --------------------------------------------------------------

def _check(x, t, k_cache, v_cache, stacks, num_heads, chunks):
    if x.ndim != 2:
        raise ValueError(f"x must be (B, D); got {tuple(x.shape)}")
    b, d = x.shape
    if k_cache.ndim != 4 or tuple(k_cache.shape[1:2]) + tuple(
            k_cache.shape[3:]) != (b, d):
        raise ValueError(f"caches must be (L, {b}, T, {d}); got "
                         f"{tuple(k_cache.shape)}")
    if v_cache.shape != k_cache.shape or v_cache.dtype != k_cache.dtype:
        raise ValueError("k_cache and v_cache differ in shape or dtype")
    n_layers, _, t_max, _ = k_cache.shape
    if not 0 <= int(t) < t_max:
        raise ValueError(f"position t={int(t)} outside the cache [0, "
                         f"{t_max})")
    if num_heads < 1 or d % num_heads:
        raise ValueError(f"D={d} not divisible by num_heads={num_heads}")
    missing = set(STACK_KEYS) - set(stacks)
    if missing:
        raise ValueError(f"stacks lack {sorted(missing)}")
    f = stacks["fc_s"].shape[-1]
    if chunks < 1 or f % chunks:
        raise ValueError(f"F={f} not divisible by chunks={chunks}")
    want = {"qkv_q": (n_layers, 3 * d, d), "out_q": (n_layers, d, d),
            "fc_q": (n_layers, f, d), "proj_q": (n_layers, d, f)}
    for key in STACK_KEYS:
        arr = stacks[key]
        if key in want:
            shape, dtype = want[key], torch.int8
        else:
            width = {"qkv": 3 * d, "fc": f}.get(key.split("_")[0], d)
            shape, dtype = (n_layers, width), torch.float32
        if tuple(arr.shape) != shape or arr.dtype != dtype:
            raise ValueError(f"stacks[{key!r}] must be {dtype} {shape}; got "
                             f"{arr.dtype} {tuple(arr.shape)}")


def fused_decode_stack(x, t, k_cache, v_cache, stacks: Dict[str, torch.Tensor],
                       *, num_heads: int, chunks: int = 2,
                       stamps: Optional[torch.Tensor] = None):
    """All L GPT-2 blocks of one decode step (module docstring): returns
    (x_out, k_cache, v_cache), the caches updated in place at row t. On
    CUDA tensors it launches K8 or raises; the kernel takes B <=
    ``MAX_BATCH``, D and F / chunks multiples of 16, 1, 2, 4 or 8 chunks,
    and contiguous tensors on one device. ``stamps``, an int64
    CUDA tensor of ``barriers_per_step(L, chunks) + 2`` elements, receives
    block 0's ``%globaltimer`` (ns) at its start, after each grid barrier
    and at its end: the step's phases, timed on the card."""
    _check(x, t, k_cache, v_cache, stacks, num_heads, chunks)
    if x.device.type == "cpu":
        if stamps is not None:
            raise ValueError("stamps are the kernel's clock: CUDA tensors "
                             "only")
        return fused_decode_stack_reference(x, t, k_cache, v_cache, stacks,
                                            num_heads=num_heads,
                                            chunks=chunks)
    return _launch(x, int(t), k_cache, v_cache, stacks, num_heads, chunks,
                   stamps)


fused_decode_stack.launches = 0


def check_kernel_geometry(batch: int, d_model: int, d_ff: int, chunks: int,
                          head_dim: int, dtype, *,
                          blocks: int = runtime.H100_SMS) -> int:
    """Raise ValueError (with the reason) if K8 cannot run B = ``batch``
    rows of width D = ``d_model`` with an MLP of F = ``d_ff`` in
    ``chunks`` chunks and heads of ``head_dim`` in ``dtype`` on
    ``blocks`` blocks (one an SM); return the block's shared memory in
    bytes: the fixed layout (``_smem_bytes``) and as many ring stages as
    fit, at least ``MIN_RING_STAGES``. The cache length does not bound it:
    attention's splits hold at most MAX_SPLIT_LEN scores. ``_launch``
    calls it, and the serving engine's fused-path probe calls it with its
    own geometry, so that a configuration the kernel refuses fails at
    construction."""
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(f"kernel takes f32 or bf16 x and caches; got "
                         f"{dtype}")
    if batch > MAX_BATCH:
        raise ValueError(f"kernel takes at most {MAX_BATCH} rows; got "
                         f"{batch}")
    if chunks not in (1, 2, 4, 8) or d_ff % chunks:
        raise ValueError(f"kernel takes 1, 2, 4 or 8 MLP chunks that "
                         f"divide F={d_ff}; got {chunks}")
    fc_width = d_ff // chunks
    if d_model % 16 or fc_width % 16:
        raise ValueError(f"kernel needs D ({d_model}) and F / chunks "
                         f"({fc_width}) to be multiples of 16 (16-byte "
                         "int8 loads)")
    if head_dim not in (8, 16, 32, 64, 128, 256):
        raise ValueError(f"kernel takes a head dim that is a power of two "
                         f"from 8 to 256; got {head_dim}")
    if max(d_model, d_ff) > STAGE_BYTES:
        raise ValueError(f"kernel streams whole weight rows into "
                         f"{STAGE_BYTES}-byte stages; D={d_model}, "
                         f"F={d_ff}")
    fixed = _smem_bytes(batch, d_model, d_ff, chunks, head_dim, blocks)
    if ring_stages(_SMEM_LIMIT, fixed) < MIN_RING_STAGES:
        raise ValueError(f"K8 needs {fixed} bytes of shared memory and "
                         f"{MIN_RING_STAGES} stages of {STAGE_BYTES} at "
                         f"B={batch}, D={d_model}, F={d_ff}; a block has "
                         f"{_SMEM_LIMIT}")
    return fixed + ring_stages(_SMEM_LIMIT, fixed) * STAGE_BYTES


def _launch(x, t, k_cache, v_cache, stacks, num_heads, chunks, stamps):
    n_layers, b, t_max, d, f = (k_cache.shape[0], x.shape[0],
                                k_cache.shape[2], x.shape[1],
                                stacks["fc_s"].shape[-1])
    tensors = [x, k_cache, v_cache] + [stacks[k] for k in STACK_KEYS]
    for name, arr in zip(("x", "k_cache", "v_cache") + STACK_KEYS, tensors):
        if arr.device != x.device:
            raise ValueError(f"{name} is on {arr.device}, x on {x.device}")
        if not arr.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if arr.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             "(the kernel's vector loads and bulk copies)")
    if t >= MAX_SPLITS * MAX_SPLIT_LEN:
        raise ValueError(f"kernel attends over at most "
                         f"{MAX_SPLITS * MAX_SPLIT_LEN} positions; t={t}")
    head_dim = d // num_heads
    blocks = runtime.sm_count(x.device)
    for dtype in (x.dtype, k_cache.dtype):   # x's and the caches' types
        smem = check_kernel_geometry(b, d, f, chunks, head_dim, dtype,
                                     blocks=blocks)
    splits, _ = plan_splits(b, num_heads, t, blocks)
    if stamps is not None and (
            stamps.dtype != torch.int64 or stamps.device != x.device
            or stamps.numel() < barriers_per_step(n_layers, chunks) + 2):
        raise ValueError(f"stamps must be int64 on {x.device} with "
                         f"{barriers_per_step(n_layers, chunks) + 2} "
                         "elements")
    x_out = torch.empty_like(x)
    scratch = torch.empty(
        _scratch_floats(b, d, f, chunks, num_heads, splits, n_layers),
        dtype=torch.float32, device=x.device)
    lib = _library()
    counters = runtime.zeroed_counters(
        "decode_stack", x.device,
        lib.tnn_fused_decode_stack_counters(b, num_heads))
    err = lib.tnn_fused_decode_stack(
        *[a.data_ptr() for a in tensors], x_out.data_ptr(),
        scratch.data_ptr(), _KERNEL_DTYPES[x.dtype],
        _KERNEL_DTYPES[k_cache.dtype], b, d, t_max, n_layers, f, chunks,
        num_heads, t, smem, 1.0 / math.sqrt(head_dim), splits,
        counters.data_ptr(),
        None if stamps is None else stamps.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_decode_stack kernel launch failed: CUDA "
                           f"error {err}")
    runtime.count_launch(fused_decode_stack)
    return x_out, k_cache, v_cache


def kernel_plan(batch: int, d_model: int, d_ff: int, chunks: int,
                heads: int, blocks: int, smem: int) -> Dict[str, int]:
    """The kernel's own shared-memory plan (``tnn_fused_decode_stack_plan``,
    on the machine with the card): its fixed layout's bytes and ring
    stages, for checking this module's mirror of it."""
    out = (ctypes.c_int * 2)()
    err = _library().tnn_fused_decode_stack_plan(
        batch, d_model, d_ff, chunks, heads, blocks, smem, out)
    if err != 0:
        raise ValueError(f"the kernel refuses this plan: CUDA error {err}")
    return {"fixed": out[0], "ring": out[1]}


def _library():
    lib = runtime.load("decode_stack")
    fn = lib.tnn_fused_decode_stack
    if fn.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * (3 + len(STACK_KEYS) + 2) + [i] * 11 + [
            ctypes.c_float, i, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
        lib.tnn_fused_decode_stack_counters.argtypes = [i, i]
        lib.tnn_fused_decode_stack_counters.restype = i
        lib.tnn_fused_decode_stack_plan.argtypes = [i] * 7 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.tnn_fused_decode_stack_plan.restype = i
    return lib
