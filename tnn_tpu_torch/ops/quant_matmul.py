"""Int8 weights for decode: the weight-only int8 matmul, w8a8 and the
``qmatmul`` dispatch (``tnn_tpu/ops/pallas/quant_matmul.py``).

A logical (K, N) matmul weight is stored TRANSPOSED as ``q: (N', K')`` int8
with ``scale: (N',)`` f32 (absmax/127 per output channel), both zero-padded
to multiples of 128 at quantize time (padded channels carry scale 1.0), so
no call pads the weight. The per-N scale factors out of the K sum:
``out = (x @ q^T) * scale``, one multiply per output element after the loop.

``int8_matmul`` is the kernel wrapper. On a CUDA tensor it launches the
hand-written CUDA kernel (``csrc/quant_matmul.cu``) on the current stream,
or raises; on a CPU tensor it computes ``int8_matmul_reference``, the plain
PyTorch version (the int8 weight converted to x's dtype, an f32 product,
the scale, then ``out_dtype``). ``int8_matmul.launches`` counts the kernel
launches. ``plan_int8_matmul`` is the fixed rule that picks the kernel's
body (tensor cores or SIMT) and its tile from the shapes.

``w8a8_matmul`` quantizes the activation per row and takes an exact
int8 x int8 -> int32 product: ``torch._int_mm`` on the card (a library
call, as the JAX package leaves this dot to XLA), an int32 matmul on the
CPU. ``qmatmul`` picks w8a8 at ``W8A8_MAX_ROWS`` rows or fewer and the
kernel above, and ``matmul_f32`` (the f32-accumulating float product,
differentiable) for float weights.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from . import runtime

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The kernel's tiles (csrc/quant_matmul.cu): both bodies take 64 weight rows
# (output columns) a block; the tensor-core body TC_TILES_M x rows (one
# consumer warpgroup), the SIMT body 64 x rows
TILE_N = 64
TC_TILES_M = (8, 16, 32, 64, 128)
SIMT_TILE_M = 64


class MatmulPlan(NamedTuple):
    """How ``int8_matmul`` runs on the card: ``body`` "wgmma" (bf16 x on
    the tensor cores) or "simt"; ``tile_m`` x rows a block (by ``TILE_N``
    output columns), each block over the whole K."""
    body: str
    tile_m: int

    def blocks(self, m: int, n: int) -> int:
        return (-(-m // self.tile_m)) * (-(-n // TILE_N))


def plan_int8_matmul(m: int, n: int, k: int, x_dtype,
                     sms: int = runtime.H100_SMS) -> MatmulPlan:
    """The body and tile of an (m, k) x (k, n) int8 matmul, from the
    shapes alone (a fixed rule, not a fallback):

    * f32 x, or bf16 x whose K is not a positive multiple of 8 (TMA needs
      16-byte rows), takes the SIMT body, 64 x 64 tiles;
    * bf16 x takes the tensor-core body: the smallest wgmma N of
      ``TC_TILES_M`` that holds m rows up to 64; above 64 rows 128, unless
      128-row tiles give fewer blocks than half the card's SMs (``sms``),
      then 64 (on the H100 a 128-row tile at 144 blocks beat a 64-row one
      at 288, and 96 blocks of 64 rows beat 192 of 32). K is not split:
      f32 partials summed in a fixed order gained nothing at the GPT-2
      shapes that give fewer blocks than SMs."""
    if x_dtype != torch.bfloat16 or k <= 0 or k % 8:
        return MatmulPlan("simt", SIMT_TILE_M)
    if m <= TC_TILES_M[-2]:
        return MatmulPlan("wgmma", next(t for t in TC_TILES_M if t >= m))
    tiles_n = -(-n // TILE_N)
    return MatmulPlan("wgmma",
                      128 if 2 * tiles_n * -(-m // 128) >= sms else 64)


_BODIES = {"simt": 0, "wgmma": 1}

# At this many activation rows or fewer ``qmatmul`` takes w8a8; above it the
# weight-only kernel (``tnn_tpu/ops/pallas/quant_matmul.py:252``).
W8A8_MAX_ROWS = 256


class Int8Weight:
    """A quantized (K, N) matmul weight: ``q`` (N', K') int8, ``scale``
    (N',) f32, N'/K' being N/K zero-padded to multiples of 128, and the
    logical dims ``n``/``k``. Decode-time only: it keeps no float master
    and no optimizer steps it."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor,
                 n: Optional[int] = None, k: Optional[int] = None):
        self.q = q
        self.scale = scale
        self.n = int(n) if n is not None else q.shape[0]
        self.k = int(k) if k is not None else q.shape[1]

    @property
    def shape(self):   # logical (K, N), as the float kernel it replaces
        return (self.k, self.n)

    @property
    def dtype(self) -> torch.dtype:
        return self.q.dtype

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def nbytes(self) -> int:
        """Bytes as stored: the padded int8 values and the f32 scales."""
        return self.q.numel() * self.q.element_size() \
            + self.scale.numel() * self.scale.element_size()

    def dequant(self) -> torch.Tensor:
        """(K, N) f32 materialisation, for tests and references."""
        full = self.q.float() * self.scale[:, None]
        return full[:self.n, :self.k].t()

    def __repr__(self):
        return f"Int8Weight(K={self.k}, N={self.n})"


def _pad_to_multiple(x: torch.Tensor, mult: int, dim: int,
                     value: float = 0) -> torch.Tensor:
    pad = (-x.shape[dim]) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    fill = torch.full(shape, value, dtype=x.dtype, device=x.device)
    return torch.cat([x, fill], dim=dim)


def quantize_int8(w: torch.Tensor) -> Int8Weight:
    """Symmetric per-output-channel quantization of a (K, N) weight:
    scale[n] = absmax(w[:, n]) / 127 (1.0 where the column is all zero),
    q[n, k] = round-half-even(w[k, n] / scale[n]) clipped to +-127, both
    padded to multiples of 128 (scale with 1.0)."""
    w = w.detach().float()
    k_dim, n_dim = w.shape
    absmax = w.abs().amax(dim=0)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 127.0)
    q = torch.round(w / scale[None, :]).clamp(-127, 127).to(torch.int8).t()
    q = _pad_to_multiple(_pad_to_multiple(q, 128, 0), 128, 1).contiguous()
    scale = _pad_to_multiple(scale, 128, 0, value=1.0)
    return Int8Weight(q, scale, n=n_dim, k=k_dim)


def _check(x, q, scale, n, k):
    n = q.shape[0] if n is None else int(n)
    k = x.shape[-1] if k is None else int(k)
    if x.shape[-1] != k:
        raise ValueError(f"x K dim {x.shape[-1]} != weight logical K {k}")
    if q.dtype != torch.int8 or q.ndim != 2 or q.shape[1] < k \
            or q.shape[0] < n:
        raise ValueError(f"q must be int8 (N' >= {n}, K' >= {k}); got "
                         f"{q.dtype} {tuple(q.shape)}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (q.shape[0],):
        raise ValueError(f"scale must be f32 ({q.shape[0]},); got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    return n, k


def int8_matmul_reference(x, q, scale, *, n: Optional[int] = None,
                          k: Optional[int] = None, out_dtype=None):
    """Plain PyTorch ``int8_matmul``: the kernel's parity oracle."""
    n, k = _check(x, q, scale, n, k)
    out_dtype = out_dtype or x.dtype
    # int8 -> x's dtype is exact (|q| <= 127), as is either dtype -> f32
    w = q[:n, :k].to(x.dtype).float()
    out = (x.reshape(-1, k).float() @ w.t()) * scale[:n]
    return out.to(out_dtype).reshape(*x.shape[:-1], n)


def int8_matmul(x, q, scale, *, n: Optional[int] = None,
                k: Optional[int] = None, out_dtype=None):
    """``x @ W`` for an int8 W: x (..., K) bf16 or f32, q (N', K') int8,
    scale (N',) f32; ``n``/``k`` are W's logical dims (default q's rows and
    x's last dim). Returns (..., n) in ``out_dtype`` (x's dtype by default,
    or f32), accumulated in f32 with the scale applied after the K sum.
    On CUDA tensors the kernel takes contiguous q and scale and raises on
    anything else."""
    n, k = _check(x, q, scale, n, k)
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return int8_matmul_reference(x, q, scale, n=n, k=k,
                                     out_dtype=out_dtype)
    return _launch(x, q, scale, n, k, out_dtype)


int8_matmul.launches = 0


def _launch(x, q, scale, n, k, out_dtype):
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul kernel needs CUDA tensors; x is on "
                         f"{x.device}")
    for name, t in (("q", q), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _KERNEL_DTYPES or out_dtype not in (x.dtype,
                                                          torch.float32):
        raise ValueError(f"kernel takes bf16 or f32 x with out_dtype x's "
                         f"dtype or f32; got x {x.dtype}, out {out_dtype}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    if x2.data_ptr() % 16:   # TMA reads 16-byte aligned rows
        x2 = x2.clone()
    m = x2.shape[0]
    plan = plan_int8_matmul(m, n, k, x.dtype, runtime.sm_count(x.device))
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    err = _library().tnn_int8_matmul(
        x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        _KERNEL_DTYPES[x.dtype], _KERNEL_DTYPES[out_dtype], m, n, k,
        q.shape[1], _BODIES[plan.body], plan.tile_m,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed ({plan}): "
                           f"CUDA error {err}")
    int8_matmul.launches += 1
    return out.reshape(*lead, n)


def _library():
    lib = runtime.load("quant_matmul")
    fn = lib.tnn_int8_matmul
    if fn.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 4 + [i] * 8 + [ptr]
        fn.restype = ctypes.c_int
    return lib


def _int_mm(xi: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact (M, K') int8 x (N', K') int8 -> (M, N') int32 product."""
    if xi.device.type == "cpu":
        return xi.to(torch.int32) @ q.to(torch.int32).t()
    # cuBLASLt's int8 GEMM behind torch._int_mm wants more than 16 rows
    # (and K, N multiples of 8, which the 128-padded storage gives)
    m = xi.shape[0]
    mp = max(32, -(-m // 8) * 8)
    if mp != m:
        xi = torch.cat([xi, xi.new_zeros((mp - m, xi.shape[1]))])
    return torch._int_mm(xi, q.t())[:m]


def w8a8_matmul(x, w: Int8Weight, out_dtype=None):
    """``x @ W`` with the activation quantized too: per row, sx = absmax /
    127 (1.0 for an all-zero row), xi = round-half-even(x / sx) clipped to
    +-127, zero-padded to the stored K'; then the exact int32 product,
    rescaled in f32 as ``acc * sx * scale`` and cast to ``out_dtype``
    (x's dtype by default)."""
    out_dtype = out_dtype or x.dtype
    *lead, k_in = x.shape
    if k_in != w.k:
        raise ValueError(f"x K dim {k_in} != weight logical K {w.k}")
    xf = x.reshape(-1, k_in).float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    sx = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 127.0)
    xi = torch.round(xf / sx).clamp(-127, 127).to(torch.int8)
    pad = w.q.shape[1] - k_in
    if pad:
        xi = torch.cat([xi, xi.new_zeros((xi.shape[0], pad))], dim=1)
    acc = _int_mm(xi, w.q)
    out = acc.float() * sx * w.scale[None, :]
    return out[:, :w.n].to(out_dtype).reshape(*lead, w.n)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """2-D ``a @ b`` with an f32 result: on the card a bf16 product runs on
    the tensor cores with f32 output; on the CPU the inputs are widened
    first, which is exact for bf16 values."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _MatmulF32(torch.autograd.Function):
    """``x @ w`` of compute-dtype operands with an f32 result. The backward
    rounds the f32 output gradient to the operands' dtype and accumulates
    both products in f32 before rounding them to the operands' dtype. JAX
    transposes the f32-output dot the same way but for that first rounding:
    it multiplies the f32 gradient by the bf16 operand. Rounding keeps both
    products on the tensor cores; its effect on the gradients is measured
    against JAX's in ``tests/test_torch_training.py``."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return _mm_f32(x2, w)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm_f32(g, w.t()).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            dw = _mm_f32(x2.t(), g).to(w.dtype)
        return dx, dw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated and returned in float32: JAX's ``dot_general``
    with ``preferred_element_type=float32`` (the float branch of
    ``qmatmul``). Differentiable."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    lead = x.shape[:-1]
    y = _MatmulF32.apply(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*lead, w.shape[-1])


def qmatmul(x, w, out_dtype=None, rows: Optional[int] = None):
    """``x @ w`` for a float (K, N) weight or an ``Int8Weight``.

    Int8: w8a8 at ``W8A8_MAX_ROWS`` rows or fewer, the weight-only kernel
    above; both return ``out_dtype`` or x's dtype. ``rows`` overrides the
    row count the choice reads: a caller that computes only some rows of a
    larger call (the head under ``last_only``) passes the larger count, so
    it takes the branch the whole call would. Float: the f32-accumulating
    product, returned in f32 or ``out_dtype``."""
    if isinstance(w, Int8Weight):
        if rows is None:
            rows = math.prod(x.shape[:-1])
        if rows <= W8A8_MAX_ROWS:
            return w8a8_matmul(x, w, out_dtype=out_dtype)
        return int8_matmul(x, w.q, w.scale, n=w.n, k=w.k,
                           out_dtype=out_dtype)
    out = matmul_f32(x, w)
    return out.to(out_dtype) if out_dtype is not None else out
