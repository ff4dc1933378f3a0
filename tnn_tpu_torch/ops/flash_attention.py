"""Flash attention: the forward (K4), the fused backward (K7) and the split
backward (K5 dQ, K6 dK/dV).

Port of ``tnn_tpu/ops/pallas/flash_attention.py``. ``flash_attention`` is
the differentiable entry: a ``torch.autograd.Function`` whose forward calls
``flash_attention_fwd`` and whose backward calls ``flash_attention_bwd``
(K7), or ``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv`` (K5,
K6) where the reference's rule (``use_fused_bwd``) takes the split path.
Those four are the kernel wrappers. On CUDA tensors they launch the
hand-written kernels of ``csrc/flash_attention.cu`` on the current stream,
or raise; on CPU tensors they compute ``flash_attention_reference`` and
(their part of) ``flash_attention_backward_reference``, the plain PyTorch
versions with the same rounding points. Each wrapper's ``launches`` counts
its kernel launches.

Rounding points (those of the Pallas kernels): f32 logits; p rounded to
v's dtype before the PV product; f32 accumulation; the per-row logsumexp
in f32, ``+inf`` on rows with no live key (whose output is exactly 0). The
backward recomputes p = exp(s - lse), rounds it to dO's dtype for dV and
rounds ds = p (dP - delta) scale to q's dtype for dK and dQ. The plain
forward normalises at the row's final maximum; the kernel rounds p at its
running maximum, one key tile at a time (128 keys in bf16, 64 in f32), as
the TPU kernel does per kv block, so the two differ within the rounding of
p. bf16 inputs take the kernels' tensor-core bodies (K4, K5, K6, K7), f32
inputs their f32 bodies on the CUDA cores.
"""
from __future__ import annotations

import ctypes
import math
import os
from typing import Optional

import torch

from . import runtime

_NEG_INF = -1e30
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The reference's VMEM budget for its fused backward's resident set; above
# it the split two-kernel path runs (``_FUSED_BWD_MAX_BYTES`` of the JAX
# package). It has no meaning for this card's memory: it is read from the
# reference's variable at import only so that both packages, run under the
# same environment, pick the same backward at every shape.
_FUSED_BWD_MAX_BYTES = int(
    os.environ.get("TNN_FLASH_FUSED_BWD_MAX_BYTES", 12 * 2**20))


def _block_geometry(sq: int, skv: int, block_q: int, block_k: int):
    """Block sizes and padded lengths, as the JAX package computes them."""
    bq = min(block_q, max(sq, 8))
    bk = min(block_k, max(skv, 8))
    return bq, bk, -(-sq // bq) * bq, -(-skv // bk) * bk


def _fused_bwd_applicable(sq_p: int, d: int, bq: int = 512, bk: int = 512,
                          itemsize: int = 4) -> bool:
    """The JAX package's estimate of its fused backward's VMEM-resident set
    (the full-sequence dQ output block and f32 scratch, double-buffered
    q/o/dO/k/v blocks and dK/dV outputs, dK/dV f32 scratch) against
    ``_FUSED_BWD_MAX_BYTES``; ``TNN_FLASH_FUSED_BWD=0`` (read per call)
    forces the split path."""
    if os.environ.get("TNN_FLASH_FUSED_BWD", "1") == "0":
        return False
    dq_bytes = sq_p * d * (itemsize + 4)
    blk_in = (3 * bq + 2 * bk) * d * itemsize + bq * 4
    blk_out = 2 * bk * d * itemsize
    acc = 2 * bk * d * 4
    resident = dq_bytes + 2 * (blk_in + blk_out) + acc
    return resident <= _FUSED_BWD_MAX_BYTES


def use_fused_bwd(q, k) -> bool:
    """Whether the backward of attention over q (B, H, Sq, D) and k takes
    the fused kernel (K7) or the split pair (K5, K6): the reference's rule
    (``_flash_bwd``), its default (512, 512) blocks, the padded Sq and q's
    itemsize. At D=64 in bf16 the fused path ends past S = 29,184.

    On this card the rule is the reference's, not a memory limit: K7 keeps
    dQ in an f32 buffer in device memory and could run at any length. The
    port follows the rule so that a run takes the kernels the reference
    takes at the same shape."""
    bq, bk, sq_p, _ = _block_geometry(q.shape[2], k.shape[2], 512, 512)
    return _fused_bwd_applicable(sq_p, q.shape[3], bq, bk, q.element_size())


def norm_mask(mask, b, h, sq, skv):
    """A boolean mask broadcastable to (B, H, Sq, Skv) in the kernel's
    grouped (G, Sq, Skv) int8 layout, G in {1, B, B*H}: a (B, 1, Sq, Skv)
    padding mask is not repeated per head (``_norm_mask`` of the JAX
    package)."""
    if mask.ndim == 2:
        mask = mask[None, None]
    elif mask.ndim == 3:
        if mask.shape[0] != 1:
            raise ValueError(
                f"3-D mask with leading dim {mask.shape[0]} is ambiguous "
                "(B or H?); pass a 4-D mask shaped (B, 1, Sq, Skv) or "
                "(1, H, Sq, Skv)")
        mask = mask[None]
    mb, mh = mask.shape[0], mask.shape[1]
    if (mb, mh) == (1, 1):
        g = mask.reshape(1, *mask.shape[2:])
    elif mh == 1:
        g = mask.reshape(mb, *mask.shape[2:])
    else:
        g = mask.broadcast_to(b, h, *mask.shape[2:]).reshape(
            b * h, *mask.shape[2:])
    g = g.broadcast_to(g.shape[0], sq, skv)
    return (g != 0).to(torch.int8).contiguous()


def _group_index(groups, b, h):
    """(B*H,) mask group of each flattened batch*head."""
    bh = torch.arange(b * h)
    if groups == 1:
        return torch.zeros_like(bh)
    if groups == b * h:
        return bh
    return bh // h


def _live(q, k, mask, off, causal):
    """(B, H, Sq, Skv) bool: which logits survive."""
    b, h, sq, _ = q.shape
    skv = k.shape[2]
    live = torch.ones(b, h, sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        qpos = off + torch.arange(sq, device=q.device)[:, None]
        live = live & (qpos >= torch.arange(skv, device=q.device)[None, :])
    if mask is not None:
        grp = _group_index(mask.shape[0], b, h).to(q.device)
        live = live & (mask[grp] != 0).reshape(b, h, sq, skv)
    return live


def _logits(q, k, mask, off, causal, scale):
    g = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(g, dim=1)   # the plain version copies GQA heads
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    live = _live(q, k, mask, off, causal)
    return torch.where(live, s, _NEG_INF), live


def flash_attention_reference(q, k, v, *, causal=False, scale=None,
                              mask=None, kv_offset=0):
    """Plain PyTorch forward: (O in q's dtype, lse (B, H, Sq) f32).

    ``mask`` is the grouped (G, Sq, Skv) int8 layout of ``norm_mask`` or
    None; ``kv_offset`` an int. The kernel's parity oracle."""
    scale = _scale(q, scale)
    s, live = _logits(q, k, mask, int(kv_offset), causal, scale)
    # with no key (Skv = 0) every row is dead: O = 0, lse = +inf
    m = s.amax(dim=-1, keepdim=True) if s.shape[-1] else s.new_full(
        (*s.shape[:-1], 1), -math.inf)
    p = torch.where(live, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    g = q.shape[1] // k.shape[1]
    vr = v.repeat_interleave(g, dim=1)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vr.float())
    lsafe = torch.where(l == 0.0, 1.0, l)
    out = (acc / lsafe).to(q.dtype)
    lse = torch.where(l > 0.0, m + torch.log(lsafe), math.inf)[..., 0]
    return out, lse


def flash_attention_backward_reference(q, k, v, o, lse, do, *, causal=False,
                                       scale=None, mask=None, kv_offset=0):
    """Plain PyTorch backward: (dQ, dK, dV) in the inputs' dtypes, dK and
    dV summed over each GQA group in f32 as the JAX package does."""
    scale = _scale(q, scale)
    s, _ = _logits(q, k, mask, int(kv_offset), causal, scale)
    p = torch.exp(s - lse[..., None])       # lse = +inf on dead rows -> 0
    g = q.shape[1] // k.shape[1]
    kr = k.repeat_interleave(g, dim=1).float()
    vr = v.repeat_interleave(g, dim=1).float()
    do32 = do.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), do32)
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, vr)
    delta = (do32 * o.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr).to(q.dtype)
    dk, dv = group_sum_kv_grads(dk.to(k.dtype), dv.to(v.dtype), k.shape[1])
    return dq, dk, dv


def group_sum_kv_grads(dk, dv, hkv):
    """Per-q-head (B, H, Skv, D) dK / dV -> per-kv-head (B, H_kv, Skv, D):
    each group summed in f32 and cast back (``_group_sum_kv_grads``)."""
    b, h, skv, d = dk.shape
    if h == hkv:
        return dk, dv
    g = h // hkv
    return tuple(x.reshape(b, hkv, g, skv, d).float().sum(2).to(x.dtype)
                 for x in (dk, dv))


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def flash_attention_fwd(q, k, v, *, causal=False, scale=None, mask=None,
                        kv_offset=0):
    """K4. (O, lse) of attention over contiguous (B, H, Sq, D) q and
    (B, H_kv, Skv, D) k, v. On CUDA tensors the kernel takes bf16 or f32
    inputs of one dtype and D of 64 or 128, and raises on anything else."""
    _check(q, k, v, mask)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, scale=scale,
                                         mask=mask, kv_offset=kv_offset)
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    _check_kernel_args(q, k, v, mask)
    _check_tma_bases(q.dtype, q=q, k=k, v=v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _library()
    err = lib.tnn_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _KERNEL_DTYPES[q.dtype], b, h, hkv, sq, skv, d,
        0 if mask is None else mask.shape[0], int(causal), int(kv_offset),
        _scale(q, scale), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention forward kernel launch failed: "
                           f"CUDA error {err}")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=False, scale=None,
                        mask=None, kv_offset=0):
    """K7. (dQ, dK, dV) from the forward's inputs, its O and lse, and the
    output gradient dO (contiguous, q's shape and dtype)."""
    _check(q, k, v, mask)
    if q.device.type == "cpu":
        return flash_attention_backward_reference(
            q, k, v, o, lse, do, causal=causal, scale=scale, mask=mask,
            kv_offset=kv_offset)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    _check_tma_bases(q.dtype, q=q, k=k, v=v, do=do)
    dq_acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, h, skv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, h, skv, d), dtype=v.dtype, device=q.device)
    _launch_bwd(_library().tnn_flash_bwd, "backward", q, k, v, o, lse, do,
                (dq_acc, dk, dv), causal, scale, mask, kv_offset)
    flash_attention_bwd.launches += 1
    dk, dv = group_sum_kv_grads(dk, dv, k.shape[1])
    return dq_acc.to(q.dtype), dk, dv


flash_attention_bwd.launches = 0


def flash_attention_bwd_dq(q, k, v, o, lse, do, *, causal=False, scale=None,
                           mask=None, kv_offset=0):
    """K5. dQ in q's dtype, from the same inputs as ``flash_attention_bwd``.
    The kernel writes each row once from an f32 sum in registers: no
    atomics, the same bits on every run."""
    _check(q, k, v, mask)
    if q.device.type == "cpu":
        return flash_attention_backward_reference(
            q, k, v, o, lse, do, causal=causal, scale=scale, mask=mask,
            kv_offset=kv_offset)[0]
    _check_tma_bases(q.dtype, q=q, k=k, v=v, do=do)
    dq = torch.empty_like(q)
    _launch_bwd(_library().tnn_flash_bwd_dq, "dQ backward", q, k, v, o, lse,
                do, (dq,), causal, scale, mask, kv_offset)
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, o, lse, do, *, causal=False, scale=None,
                            mask=None, kv_offset=0):
    """K6. (dK, dV) in k's and v's dtypes, per kv head: the kernel writes
    them per q head and each GQA group is summed in f32 here."""
    _check(q, k, v, mask)
    if q.device.type == "cpu":
        return flash_attention_backward_reference(
            q, k, v, o, lse, do, causal=causal, scale=scale, mask=mask,
            kv_offset=kv_offset)[1:]
    _check_tma_bases(q.dtype, q=q, k=k, v=v, do=do)
    b, h, _, d = q.shape
    skv = k.shape[2]
    dk = torch.empty((b, h, skv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, h, skv, d), dtype=v.dtype, device=q.device)
    _launch_bwd(_library().tnn_flash_bwd_dkv, "dK/dV backward", q, k, v, o,
                lse, do, (dk, dv), causal, scale, mask, kv_offset)
    flash_attention_bwd_dkv.launches += 1
    return group_sum_kv_grads(dk, dv, k.shape[1])


flash_attention_bwd_dkv.launches = 0


def _launch_bwd(entry, what, q, k, v, o, lse, do, outs, causal, scale, mask,
                kv_offset):
    """Check a backward's CUDA inputs and launch its C ``entry``, whose
    output pointers ``outs`` sit between the inputs (with the f32 delta
    scratch) and the shape; raises if the launch fails."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    _check_kernel_args(q, k, v, mask)
    for name, x, dtype in (("o", o, q.dtype), ("do", do, q.dtype),
                           ("lse", lse, torch.float32)):
        if x.device != q.device or not x.is_contiguous() or x.dtype != dtype:
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on "
                             f"{q.device}")
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, h, sq):
        raise ValueError("o / do must have q's shape and lse (B, H, Sq)")
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        *(x.data_ptr() for x in outs), _KERNEL_DTYPES[q.dtype], b, h, hkv,
        sq, skv, d, 0 if mask is None else mask.shape[0], int(causal),
        int(kv_offset), _scale(q, scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention {what} kernel launch failed: "
                           f"CUDA error {err}")


def _check(q, k, v, mask):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"need q (B, H, Sq, D) and k, v (B, H_kv, Skv, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[1] == 0 \
            or h % k.shape[1]:
        raise ValueError(f"q has {h} heads but k/v have {k.shape[1]}; need "
                         "H % H_kv == 0 and equal batch and head dims")
    if mask is not None:
        if mask.ndim != 3 or mask.shape[1:] != (sq, k.shape[2]) \
                or mask.shape[0] not in (1, b, b * h):
            raise ValueError(f"mask must be grouped (G, Sq, Skv) with G in "
                             f"{{1, B, B*H}}; got {tuple(mask.shape)}")


def _check_kernel_args(q, k, v, mask):
    for name, x in (("q", q), ("k", k), ("v", v), ("mask", mask)):
        if x is None:
            continue
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"kernel takes bf16 or f32 q, k, v of one dtype; "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] not in (64, 128):
        raise ValueError(f"kernel supports head_dim 64 or 128, got "
                         f"{q.shape[-1]}")
    if mask is not None and mask.dtype != torch.int8:
        raise ValueError(f"mask must be int8, got {mask.dtype}")


def _check_tma_bases(dtype, **tensors):
    """The bf16 bodies of K4-K7 read these tensors through TMA, whose
    tensor maps need 16-byte-aligned base addresses."""
    if dtype != torch.bfloat16:
        return
    for name, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(f"bf16 {name} must start on a 16-byte boundary "
                             "(the kernel reads it through TMA)")


def _library():
    lib = runtime.load("flash_attention")
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if lib.tnn_flash_fwd.argtypes is None:
        lib.tnn_flash_fwd.argtypes = [ptr] * 6 + [i] * 10 + [f, ptr]
        lib.tnn_flash_fwd.restype = ctypes.c_int
        lib.tnn_flash_bwd.argtypes = [ptr] * 11 + [i] * 10 + [f, ptr]
        lib.tnn_flash_bwd.restype = ctypes.c_int
        lib.tnn_flash_bwd_dq.argtypes = [ptr] * 9 + [i] * 10 + [f, ptr]
        lib.tnn_flash_bwd_dq.restype = ctypes.c_int
        lib.tnn_flash_bwd_dkv.argtypes = [ptr] * 10 + [i] * 10 + [f, ptr]
        lib.tnn_flash_bwd_dkv.restype = ctypes.c_int
    return lib


class _FlashAttention(torch.autograd.Function):
    """K4 forward; K7 backward, or K5 and K6 where ``use_fused_bwd`` says
    so; mask and kv_offset carry no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, kv_offset, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                       mask=mask, kv_offset=kv_offset)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.args = (causal, scale, kv_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, out, lse = ctx.saved_tensors
        causal, scale, kv_offset = ctx.args
        args = (q, k, v, out, lse, do.contiguous())
        kw = dict(causal=causal, scale=scale, mask=mask, kv_offset=kv_offset)
        if use_fused_bwd(q, k):
            dq, dk, dv = flash_attention_bwd(*args, **kw)
        else:
            dq = flash_attention_bwd_dq(*args, **kw)
            dk, dv = flash_attention_bwd_dkv(*args, **kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, mask=None, kv_offset=None):
    """Fused attention over (B, H, S, Dh) tensors; differentiable.

    ``mask``: boolean, broadcastable to (B, H, Sq, Skv), True = attend;
    kept in its grouped form. ``kv_offset``: absolute position of q[0]
    among the keys (cached decode, Sq != Skv), an int or a 0-d tensor.
    Both compose with ``causal``. GQA: k and v may carry H_kv heads with
    H % H_kv == 0; the kernels never copy the shared heads."""
    b, h, sq, _ = q.shape
    if mask is not None:
        mask = norm_mask(torch.as_tensor(mask, device=q.device), b, h, sq,
                         k.shape[2])
    off = 0 if kv_offset is None else int(kv_offset)
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), mask, off, bool(causal),
                                 scale)
