#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``tnn_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository checkout around this file.
It builds every kernel of the port from ``tnn_tpu_torch/csrc`` (one ``nvcc``
per source, all started together) and runs these phases, each printing its
numbers on its own line:

1. device: the card's name, the device count and its power limit;
2. kernel: the paged-attention kernel (K1) against its plain PyTorch
   version at the shapes of ``gpt2_small`` serving, with the tolerance
   stated, and its time beside the plain version's, a library call's and
   the card's bound;
3. flash: the flash-attention forward (K4) and backward (K7) against their
   plain versions at the training shape and its variants, with their
   times beside the plain versions', the library's and the bound, and the
   backward call's time split by kernel (delta pre-pass, K7, the zero-fill
   of dQ's f32 buffer, the casts, the GQA group sum);
4. serving: ``InferenceEngine`` serving full-width ``gpt2_small`` (seeded
   random weights) 8 requests through the paged path, with K1's launch
   count read over that run;
5. cli: ``python -m tnn_tpu_torch.cli.serve`` on two JSON lines;
6. training: ``tnn_tpu_torch.cli.train_gpt2`` trains full-width
   ``flash_gpt2_small`` for 30 steps on a seeded synthetic corpus, with K4's
   and K7's launch counts, its steady step time and a profiler window read
   over that run; then one step with the kernels against the same step
   with the plain versions, under bf16 and FP32;
7. train_cli: a byte-mode corpus from the card's Python stdlib, trained at
   two layers with sampling (``generate`` through K4's ``kv_offset`` form);
8. int8_kernel: the int8 paged-attention kernel (K2) against its plain
   version at the serving shapes, with times beside the plain version's,
   SDPA's on the gathered, dequantized K/V and the bound;
9. int8_matmul: the weight-only int8 matmul (K3) against its plain version
   at GPT-2 small's five matmul shapes at 512 rows, the head at the 8 rows
   the serving path gives it, and a ragged case, with times beside the
   plain version's, ``torch.mm``'s and the bound;
10. serving_int8: the serving phase's traffic with ``kv_dtype="int8",
   quant_weights=True``: K2 and K3 launch counts, the float model's
   teacher-forced closeness gate and a decode profile; then the CLI with
   ``--kv-dtype int8 --quant-weights``;
11. flash_split (run after flash): the split backward, K5 (dQ) and K6 (dK,
   dV), against the plain backward in K7's 13 cases and llama_small's
   attention at S=4096; against K7 at S=32,768, where K5 must repeat its
   dQ bit for bit; all four flash kernels under a mask of 4 x 2^30 bytes;
   times at S=32,768 beside the plain version's at S=4096, SDPA's (forward
   beside K4, backward beside the others) and the bound, each backward
   call split by kernel (delta pre-pass, body, group sum), and K5 + K6
   beside K7 and SDPA's backward;
12. training_long (run after training): full-width ``flash_llama_small``
   (vocab 32,000) trained at B=1, S=32,768 for 6 AdamW steps and 2
   held-out batches, with K4 = 12 x 8, K5 = K6 = 12 x 6 and K7 = 0
   launches, falling loss, step time, MFU, peak memory and a profiled
   step, whose flash kernels must be the tensor-core bodies of K4, K5 and
   K6. train_cli (7) also runs ``--arch llama`` at S=32,768, 2 layers.

13. decode_stack: the fused decode-stack kernel (K8) against its plain
   version at gpt2_small's width in 48 cases (B 1 and 2, T 1024, three
   positions, bf16 and f32, 1, 2, 4 and 8 MLP chunks), layer by layer,
   with the 12-layer launch equal to the chain of one-layer launches;
   times beside the plain version's and the unfused int8 blocks';
14. fused_generate: ``cli.gpt2_inference --fused`` and ``--int8`` (64
   tokens, tokens/s), ``fused_generate`` in process (K8 = 63 launches),
   its teacher-forced logits against the unfused int8 step, and kernels
   and aten ops per token of both;
15. serving_fused: ``InferenceEngine(..., quant_weights=True,
   decode_path="fused", max_batch_size=2)`` on 6 requests (lockstep pairs,
   then a ragged pair): K8 = lockstep steps, K3 = 48 x wide standard
   mixed steps, the closeness gate, steady decode profiles beside the
   paged paths, and the CLI with ``--decode-path fused``;
16. paged_stats: the paged kernels' stats form (K1s: out and each row's
   softmax max m and normalizer l) against its plain version in 36 cases
   (both page types, bf16 and f32, decode and ragged chunks, Dh 64 and
   128, block sizes 4 to 32, holes and dead rows), each also split
   round-robin over 2 and 4 tables and merged against unsharded K1 / K2;
   times at the serving decode shape beside K1's;
17. serving_sp: ``InferenceEngine(sp=2, sp_devices=["cuda:0", "cuda:0"])``
   serving full-width ``gpt2_small``: teacher-forced mixed-step logits
   against sp=1, a 900-token prompt refused at sp=1 on one shard's pool
   and served at sp=2, the serving traffic on the bf16 and int8 pools
   (K1s = 2 x 12 x paged model steps, K1 = K2 = 0), the standard path,
   steady decode profiles beside sp=1, and the CLI with ``--sp 2``.

Any failure raises and the script exits non-zero. Without a card, or
without the package beside it, it exits non-zero and prints no result.
The last line is ``{"ok": true, "device": {...}}``; the one before it holds
the kernels' numbers as JSON.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12,      # dense tensor-core rate
            "int8": 1979e12,         # dense int8 tensor-core rate
            "float32": 67e12}        # float32 outside the tensor cores
# kernel vs plain version, element by element:
#   |out - ref| <= atol + rtol * (|ref| + p.|v|),
# as (atol, rtol), where p.|v| is the plain version over |V|. Both sides
# round every p_j to the page dtype before the PV product (the kernel at its
# running max, the plain version after normalising), each within half an ulp
# (2^-8 relative in bf16), so their PV sums differ by at most 2^-7 p.|v|; the
# two roundings of the output add at most 2^-7 |ref|. f32 differs in
# summation order only.
TOLERANCE = {"float32": (1e-5, 1e-5), "bfloat16": (1e-4, 2 ** -7)}


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, iters: int = 50, warmup: int = 10):
    """Time of one ``fn()`` call: (device, events, per_name). ``device`` is
    the summed duration of the CUDA kernels ``torch.profiler`` records over
    ``iters`` calls, divided by ``iters``: the card's own time, without the
    host overhead between launches (None where the profiler records no
    device activity). ``events`` is CUDA-event time over ``iters`` calls
    after warm-up, which includes any host gap between them.

    The profiler can drop a kernel's record (one of three K5 launches at
    S=32,768 went missing once, which read as two thirds of its time), so
    ``device`` sums, per kernel name, the mean recorded duration times the
    launches a call makes, the name's records over ``iters`` rounded up;
    ``per_name`` maps each kernel name to its share of ``device``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    events = t0.elapsed_time(t1) / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    per_name = {n: sum(d) / len(d) * -(-len(d) // iters) / 1e3
                for n, d in by_name.items()}
    device = sum(per_name.values()) if per_name else None
    return device, events, per_name


# -- phase 1 ------------------------------------------------------------------

def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    info = {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "nvidia_smi": smi[0] if smi else "",
            "torch": torch.__version__, "cuda": torch.version.cuda}
    log("device", **info)
    return info


def build_kernels():
    """Build every kernel source at once: one nvcc per source, in parallel
    (each waits in its own subprocess). Meanwhile the CUDA context, cuBLAS
    and the profiler's device tracing start up, which would otherwise
    delay the first phase."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tnn_tpu_torch.ops import runtime

    names = sorted(p.stem for p in runtime.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        builds = [pool.submit(runtime.build, n) for n in names]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            x = torch.ones(64, 64, device="cuda")
            (x @ x).sum().item()
        libs = [b.result() for b in builds]
    log("build", seconds=round(time.perf_counter() - t0, 3),
        libraries=[str(x) for x in libs])


# -- phase 2 ------------------------------------------------------------------

def paged_case(seed, *, batch, q_lens, kv_lens, heads, kv_heads, head_dim,
               block_size, dtype, decode_form, holes=False, layers=12,
               layer=5):
    """Random pool pages + ragged block tables for one kernel call."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    pages_per_row = [math.ceil(n / block_size) for n in kv_lens]
    nb = max(max(pages_per_row), 1)
    num_blocks = sum(pages_per_row) + 1 + 8
    perm = rng.permutation(np.arange(1, num_blocks))
    tables = np.zeros((batch, nb), np.int32)   # scratch-padded, as the pool
    used = 0
    for i, n in enumerate(pages_per_row):
        tables[i, :n] = perm[used:used + n]
        used += n
        if holes and n > 2:
            tables[i, 1] = -1                  # a hole the kernel must skip
    dev = torch.device("cuda")
    shape = (layers, num_blocks, kv_heads, block_size, head_dim)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pages_k = torch.randn(shape, generator=gen, device=dev).to(dtype)
    pages_v = torch.randn(shape, generator=gen, device=dev).to(dtype)
    qw = max(q_lens)
    q = torch.randn((batch, qw, heads, head_dim), generator=gen,
                    device=dev).to(dtype)
    args = dict(q=q[:, 0].contiguous() if decode_form else q,
                pages_k=pages_k, pages_v=pages_v,
                block_tables=torch.from_numpy(tables).to(dev),
                kv_lens=torch.tensor(kv_lens, dtype=torch.int32, device=dev),
                q_lens=None if decode_form else torch.tensor(
                    q_lens, dtype=torch.int32, device=dev),
                layer=layer)
    return args


def paged_work(args):
    """(bytes, operations) this call's data needs. Bytes: each live K/V
    position (below the row's kv_len, in no -1 hole) read once (int8 pages:
    one byte an element and a 4-byte scale per position and head), each
    live query token read and its output written once, the table entries
    the rows use and the lengths read once. Operations: the QK and PV
    products of every live query token with every live key it attends."""
    import numpy as np

    from tnn_tpu_torch.ops.paged_attention import QuantPages

    q, pk = args["q"], args["pages_k"]
    elem = q.element_size()
    quant = isinstance(pk, QuantPages)
    _, _, hkv, bs, dh = (pk.data if quant else pk).shape
    kv_row = dh + 4 if quant else dh * elem     # bytes per position, head
    h = q.shape[-2]
    kv = args["kv_lens"].tolist()
    ql = [1] * len(kv) if args["q_lens"] is None else args["q_lens"].tolist()
    live_kv = live_q = entries = keys = 0
    for row, n, m in zip(args["block_tables"].cpu().numpy(), kv, ql):
        used = row[:math.ceil(n / bs)]
        live = np.repeat(used >= 0, bs)[:n]
        seen = np.cumsum(live)   # live keys at or before each position
        live_kv += int(live.sum())
        live_q += m
        entries += len(used)
        keys += int(seen[n - m:n].sum())
    lens = len(kv) * (1 if args["q_lens"] is None else 2)
    nbytes = (live_kv * 2 * hkv * kv_row + live_q * 2 * h * dh * elem
              + 4 * (entries + lens))
    return nbytes, 4 * keys * h * dh


def sdpa_inputs(args):
    """The same attention as dense tensors for F.scaled_dot_product_attention:
    gathered contiguous K/V (B, H_kv, T, Dh) and a boolean mask."""
    import torch

    q, pk, pv = args["q"], args["pages_k"], args["pages_v"]
    layer, tables = args["layer"], args["block_tables"].long()
    qq = q[:, None] if q.ndim == 3 else q
    b, qw, h, dh = qq.shape
    _, _, hkv, bs, _ = pk.shape
    t = tables.shape[1] * bs
    k = pk[layer][tables.clamp_min(0)].transpose(1, 2).reshape(b, hkv, t, dh)
    v = pv[layer][tables.clamp_min(0)].transpose(1, 2).reshape(b, hkv, t, dh)
    kv = args["kv_lens"].long()
    ql = torch.ones_like(kv) if args["q_lens"] is None \
        else args["q_lens"].long()
    tpos = torch.arange(qw, device=q.device)
    kpos = torch.arange(t, device=q.device)
    mask = kpos[None, None, :] <= (kv - ql)[:, None, None] + tpos[None, :, None]
    mask = mask & (tables >= 0).repeat_interleave(bs, 1)[:, None, :]
    # rows with nothing to attend get one dummy key (their output is ignored)
    mask[..., 0] |= ~mask.any(-1)
    return (qq.transpose(1, 2).contiguous(), k.contiguous(), v.contiguous(),
            mask[:, None], h != hkv)


def phase_kernel(results):
    import torch
    import torch.nn.functional as F

    from tnn_tpu_torch.ops.paged_attention import (paged_attention,
                                                   paged_attention_reference)

    bf16, f32 = torch.bfloat16, torch.float32
    rng_lens = [1000, 17, 512, 1, 333, 768, 64, 999]
    mixed_q = [64, 64, 40, 64, 1, 1, 1, 1]
    mixed_kv = [64, 448, 980, 704, 513, 100, 2, 1000]
    small = dict(heads=12, kv_heads=12, head_dim=64, block_size=16)
    cases = {
        "decode_bf16": dict(decode_form=True, q_lens=[1] * 8,
                            kv_lens=rng_lens, dtype=bf16, **small),
        "mixed_bf16": dict(decode_form=False, q_lens=mixed_q,
                           kv_lens=mixed_kv, dtype=bf16, **small),
        "decode_gqa4_bf16": dict(decode_form=True, q_lens=[1] * 8,
                                 kv_lens=rng_lens, dtype=bf16, heads=12,
                                 kv_heads=4, head_dim=64, block_size=16),
        "mixed_gqa4_bf16": dict(decode_form=False, q_lens=mixed_q,
                                kv_lens=mixed_kv, dtype=bf16, heads=12,
                                kv_heads=4, head_dim=64, block_size=16),
        "holes_zero_len_bf16": dict(decode_form=False,
                                    q_lens=[64, 0, 1, 0, 30, 1, 64, 1],
                                    kv_lens=[300, 0, 200, 50, 90, 0, 64, 77],
                                    dtype=bf16, holes=True, **small),
        "decode_f32": dict(decode_form=True, q_lens=[1] * 8,
                           kv_lens=rng_lens, dtype=f32, **small),
        "decode_gqa4_f32": dict(decode_form=True, q_lens=[1] * 8,
                                kv_lens=rng_lens, dtype=f32, heads=12,
                                kv_heads=4, head_dim=64, block_size=16),
        "mixed_f32": dict(decode_form=False, q_lens=mixed_q,
                          kv_lens=mixed_kv, dtype=f32, holes=True, **small),
        "decode_hd128_bf16": dict(decode_form=True, q_lens=[1] * 8,
                                  kv_lens=rng_lens, dtype=bf16, heads=6,
                                  kv_heads=6, head_dim=128, block_size=16),
        "mixed_hd128_f32": dict(decode_form=False, q_lens=mixed_q,
                                kv_lens=mixed_kv, dtype=f32, heads=6,
                                kv_heads=6, head_dim=128, block_size=16),
    }
    worst = 0.0
    for i, (name, spec) in enumerate(cases.items()):
        args = paged_case(100 + i, batch=8, **spec)
        before = paged_attention.launches
        out = paged_attention(**args)
        torch.cuda.synchronize()
        if paged_attention.launches != before + 1:
            raise AssertionError(f"{name}: kernel did not launch")
        ref = paged_attention_reference(**args).float()
        ref_abs_v = paged_attention_reference(
            **{**args, "pages_v": args["pages_v"].abs()}).float()
        diff = (out.float() - ref).abs()
        atol, rtol = TOLERANCE[str(spec["dtype"]).split(".")[-1]]
        err = diff.max().item()
        # the largest share of its own limit any element uses (<= 1 passes)
        limit = atol + rtol * (ref.abs() + ref_abs_v)
        used = (diff / limit).max().item()
        # rows with no live query token must be exactly zero
        ql = spec["q_lens"]
        dead_nonzero = 0.0
        if not spec["decode_form"]:
            for bi, n in enumerate(ql):
                dead_nonzero = max(dead_nonzero,
                                   out[bi, n:].float().abs().max().item()
                                   if n < out.shape[1] else 0.0)
        for bi, n in enumerate(spec["kv_lens"]):
            if n == 0:
                dead_nonzero = max(dead_nonzero,
                                   out[bi].float().abs().max().item())
        ok = math.isfinite(used) and used <= 1.0 and dead_nonzero == 0.0
        log("kernel", case=name, max_abs_err=err, atol=atol, rtol=rtol,
            limit_used=used, dead_rows_max=dead_nonzero, ok=ok)
        if not ok:
            raise AssertionError(
                f"paged_attention {name}: |err| exceeds {atol} + {rtol} "
                f"(|ref| + p.|v|) ({used:.3g} of the limit) or dead rows "
                f"{dead_nonzero}")
        worst = max(worst, err)

    # timing at the decode shape of the serving path (gpt2_small, B=8)
    timed = {}
    for name in ("decode_bf16", "mixed_bf16"):
        args = paged_case(7, batch=8, **cases[name])
        nbytes, ops = paged_work(args)
        bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[
            "bfloat16"])
        sq, sk, sv, smask, gqa = sdpa_inputs(args)
        runs = {"": lambda: paged_attention(**args),
                "plain_": lambda: paged_attention_reference(**args),
                "library_": lambda: F.scaled_dot_product_attention(
                    sq, sk, sv, attn_mask=smask, enable_gqa=gqa)}
        timed[name] = {}
        for prefix, fn in runs.items():
            device, events, _ = time_ms(fn)
            # device time where the profiler saw the kernels, else events
            timed[name][prefix + "ms"] = events if device is None else device
            timed[name][prefix + "events_ms"] = events
        timed[name].update(bound_ms=bound_ms, bytes=nbytes, ops=ops,
                           bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                           >= ops / PEAK_OPS["bfloat16"] else "operations")
        log("kernel_time", case=name, **timed[name])
    paged_attention.launches = 0   # comparison launches do not count
    results["paged_attention"] = dict(max_abs_err=worst, **timed[
        "decode_bf16"])


# -- phase 3 ------------------------------------------------------------------
#
# K4 and K7 against their plain versions, element by element:
#   |got - ref| <= atol + rtol * (|ref| + mag),  (atol, rtol) as TOLERANCE,
# where mag is the same product taken over magnitudes. Forward O: mag =
# p.|v| (the plain forward over |V|): both sides round every p to the input
# dtype (the kernel at its running maximum, one 64-key tile at a time), each
# within 2^-8 relative in bf16, and round O. Backward: both sides recompute
# p from f32 logits that differ in summation order, so a rounding of p to
# bf16 may land one ulp (2^-7 relative) apart; dV = sum round(p) dO has mag
# = round(p)^T |dO|. ds = round(p (dP - delta) scale) may differ by one ulp
# of itself plus the f32 error of dP - delta, both within
# 2^-7 p scale (|dP| + |delta|) =: 2^-7 M, so dK and dQ have mag = M^T |Q|
# and M |K|; dQ's atomicAdd order changes only f32 roundings. GQA sums the
# per-head magnitudes too. The logsumexp is f32 on both sides: within
# 1e-5 + 1e-6 |ref|, and +inf on exactly the same rows, whose O and dQ are
# exactly 0.
LSE_TOL = (1e-5, 1e-6)


def flash_case(seed, *, b, h, hkv, sq, skv, d, dtype, causal, kv_offset=0,
               mask_groups=None):
    """Random inputs of one flash-attention call on the card, with the
    grouped int8 mask (one fully masked row) where ``mask_groups`` is
    "1", "B" or "BH"."""
    import torch

    from tnn_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    mask = None
    if mask_groups is not None:
        shape = {"1": (1, 1, sq, skv), "B": (b, 1, sq, skv),
                 "BH": (b, h, sq, skv)}[mask_groups]
        full = torch.rand(shape, generator=gen, device=dev) > 0.25
        full[0, 0, 5] = False                    # a row with no live key
        mask = fa.norm_mask(full, b, h, sq, skv)
    return dict(q=randn(b, h, sq, d), k=randn(b, hkv, skv, d),
                v=randn(b, hkv, skv, d), do=randn(b, h, sq, d), mask=mask,
                causal=causal, kv_offset=kv_offset)


def flash_work(args):
    """(bytes, operations) of K4 and of K7 on these inputs. Bytes: each
    input read once and each output written once (forward: q, k, v, the
    mask, O and the f32 logsumexp; backward: q, k, v, O, dO, the
    logsumexp and the mask, then dQ, dK, dV). Operations: 2 D per product
    per live (query, key) pair of this run's mask, 2 products forward (QK,
    PV) and 5 backward."""
    from tnn_tpu_torch.ops import flash_attention as fa

    q, k = args["q"], args["k"]
    elem = q.element_size()
    pairs = int(fa._live(q, k, args["mask"], args["kv_offset"],
                         args["causal"]).sum())
    rows = q.shape[0] * q.shape[1] * q.shape[2]
    mask = 0 if args["mask"] is None else args["mask"].numel()
    qo, kv = q.numel() * elem, k.numel() * elem
    fwd = (2 * qo + 2 * kv + 4 * rows + mask, 4 * q.shape[-1] * pairs)
    bwd = (3 * qo + 2 * kv + 4 * rows + mask + qo + 2 * kv,
           10 * q.shape[-1] * pairs)
    return fwd, bwd


def backward_magnitudes(q, k, v, o, lse, do, *, causal, mask, kv_offset):
    """M^T |Q|, M |K| and round(p)^T |dO| (see the tolerance note)."""
    import torch

    from tnn_tpu_torch.ops import flash_attention as fa

    scale = fa._scale(q, None)
    s, _ = fa._logits(q, k, mask, kv_offset, causal, scale)
    p = torch.exp(s - lse[..., None])
    del s
    g = q.shape[1] // k.shape[1]
    do32 = do.float()
    dp = torch.einsum("bhqd,bhkd->bhqk", do32,
                      v.repeat_interleave(g, dim=1).float())
    delta = (do32 * o.float()).sum(dim=-1, keepdim=True)
    m = p * scale * (dp.abs() + delta.abs())
    del dp
    mag_dq = torch.einsum("bhqk,bhkd->bhqd", m,
                          k.repeat_interleave(g, dim=1).float().abs())
    mag_dk = torch.einsum("bhqk,bhqd->bhkd", m, q.float().abs())
    mag_dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(),
                          do32.abs())
    b, h, skv, d = mag_dk.shape
    hkv = k.shape[1]
    mag_dk, mag_dv = (x.reshape(b, hkv, g, skv, d).sum(2)
                      for x in (mag_dk, mag_dv))
    return mag_dq, mag_dk, mag_dv


def _limit_used(got, ref, mag, dtype):
    atol, rtol = TOLERANCE[dtype]
    diff = (got.float() - ref.float()).abs()
    limit = atol + rtol * (ref.float().abs() + mag)
    return diff.max().item(), (diff / limit).max().item()


def flash_check(name, args):
    """One case: K4 and K7 once each, held against the plain versions."""
    import torch

    from tnn_tpu_torch.ops import flash_attention as fa

    q, k, v, do = args["q"], args["k"], args["v"], args["do"]
    kw = dict(causal=args["causal"], mask=args["mask"],
              kv_offset=args["kv_offset"])
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    if (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches) \
            != (before[0] + 1, before[1] + 1):
        raise AssertionError(f"flash {name}: a kernel did not launch")
    dtype = str(q.dtype).split(".")[-1]
    ref, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    mag_o = fa.flash_attention_reference(q, k, v.abs(), **kw)[0].float()
    errs = {"o": _limit_used(o, ref, mag_o, dtype)}
    del mag_o
    refs = fa.flash_attention_backward_reference(q, k, v, o, lse, do, **kw)
    mags = backward_magnitudes(q, k, v, o, lse, do, **kw)
    for gname, got, r, mag in zip(("dq", "dk", "dv"), grads, refs, mags):
        errs[gname] = _limit_used(got, r, mag, dtype)
    del refs, mags
    dead = torch.isinf(ref_lse)
    same_dead = bool(torch.equal(torch.isinf(lse), dead)
                     and (lse[dead] > 0).all())
    live_lse = (lse[~dead] - ref_lse[~dead]).abs()
    lse_used = (live_lse / (LSE_TOL[0] + LSE_TOL[1]
                            * ref_lse[~dead].abs())).max().item()
    dead_nonzero = max(o[dead].float().abs().max().item(),
                       grads[0][dead].float().abs().max().item()) \
        if dead.any() else 0.0
    worst = max(u for _, u in errs.values())
    ok = (math.isfinite(worst) and worst <= 1.0 and lse_used <= 1.0
          and same_dead and dead_nonzero == 0.0)
    log("flash", case=name, dtype=dtype, shape=list(q.shape),
        kv_heads=k.shape[1], skv=k.shape[2], causal=args["causal"],
        kv_offset=args["kv_offset"],
        mask_groups=None if args["mask"] is None else args["mask"].shape[0],
        **{f"{n}_max_abs_err": e for n, (e, _) in errs.items()},
        **{f"{n}_limit_used": u for n, (_, u) in errs.items()},
        lse_limit_used=lse_used, dead_rows=int(dead.sum()),
        dead_rows_max=dead_nonzero, ok=ok)
    if not ok:
        raise AssertionError(f"flash {name}: kernel vs plain outside the "
                             f"stated limit ({errs}, lse {lse_used}, dead "
                             f"rows {same_dead} / {dead_nonzero})")
    return errs["o"][0], max(errs[n][0] for n in ("dq", "dk", "dv"))


def flash_cases():
    """The flash cases: gpt2_small's training shape (B=8, H=12, S=1024,
    D=64) and its variants."""
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    train = dict(b=8, h=12, hkv=12, sq=1024, skv=1024, d=64)
    return {
        "train_bf16": dict(train, dtype=bf16, causal=True),
        "noncausal_bf16": dict(train, dtype=bf16, causal=False),
        "gqa12_4_bf16": dict(train, hkv=4, dtype=bf16, causal=True),
        "hd128_6h_bf16": dict(train, h=6, hkv=6, d=128, dtype=bf16,
                              causal=True),
        "ragged1000_bf16": dict(train, sq=1000, skv=1000, dtype=bf16,
                                causal=True),
        "mask_g1_bf16": dict(train, b=4, dtype=bf16, causal=True,
                             mask_groups="1"),
        "mask_gB_bf16": dict(train, b=4, dtype=bf16, causal=False,
                             mask_groups="B"),
        "mask_gBH_bf16": dict(train, b=4, dtype=bf16, causal=True,
                              mask_groups="BH"),
        "offset_sq1_bf16": dict(train, sq=1, dtype=bf16, causal=True,
                                kv_offset=700),
        "offset_sq64_bf16": dict(train, sq=64, dtype=bf16, causal=True,
                                 kv_offset=960),
        "train_f32": dict(train, dtype=f32, causal=True),
        "noncausal_f32": dict(train, dtype=f32, causal=False),
        "gqa12_4_f32": dict(train, hkv=4, dtype=f32, causal=True),
    }


# the kernels of one backward call (K7, K5 or K6), by a part of their names:
# the delta pre-pass, the body (every "flash_bwd" kernel: the tensor-core
# one in bf16), dq_acc's zero-fill (K7), the GQA group sum of dK / dV (K7,
# K6; none where H = H_kv) and the copies that cast dQ (K7) and, under GQA,
# the group sum's operands
BWD_PARTS = (("flash_delta_kernel", "delta"), ("FillFunctor", "zero_fill"),
             ("reduce_kernel", "group_sum"), ("copy", "cast"))


def bwd_parts(per_name, body):
    """{part: ms per call} of a backward call's kernels, its body's time
    under ``body``."""
    parts = {}
    for name, ms in per_name.items():
        part = body if "flash_bwd" in name else next(
            (p for key, p in BWD_PARTS if key in name), name[:80])
        parts[part] = parts.get(part, 0.0) + ms
    return parts


def kernel_label(name):
    """A CUDA kernel's profiler name without its return type, namespace
    and arguments: ``flash_bwd_wgmma_kernel<64, false>``."""
    name = name.replace("(anonymous namespace)::", "")
    return name[5:].split("(")[0] if name.startswith("void ") else \
        name.split("(")[0]


def phase_flash(results):
    import torch
    import torch.nn.functional as F

    from tnn_tpu_torch.ops import flash_attention as fa

    cases = flash_cases()
    worst_fwd = worst_bwd = 0.0
    for i, (name, spec) in enumerate(cases.items()):
        args = flash_case(200 + i, **spec)
        e_fwd, e_bwd = flash_check(name, args)
        worst_fwd, worst_bwd = max(worst_fwd, e_fwd), max(worst_bwd, e_bwd)
        del args
        torch.cuda.empty_cache()

    # times at the training shape: B=8, H=12, S=1024, D=64, bf16, causal
    args = flash_case(7, **cases["train_bf16"])
    q, k, v, do = args["q"], args["k"], args["v"], args["do"]
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    (fwd_bytes, fwd_ops), (bwd_bytes, bwd_ops) = flash_work(args)
    lq, lk, lv = (x.detach().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
    runs = {
        "flash_attention_fwd": (fwd_bytes, fwd_ops, {
            "": lambda: fa.flash_attention_fwd(q, k, v, causal=True),
            "plain_": lambda: fa.flash_attention_reference(q, k, v,
                                                           causal=True),
            "library_": lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True)}),
        "flash_attention_bwd": (bwd_bytes, bwd_ops, {
            "": lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                               causal=True),
            "plain_": lambda: fa.flash_attention_backward_reference(
                q, k, v, o, lse, do, causal=True),
            "library_": lambda: torch.autograd.grad(
                lib_out, (lq, lk, lv), do, retain_graph=True)}),
    }
    for name, (nbytes, ops, fns) in runs.items():
        timed = {}
        for prefix, fn in fns.items():
            device, events, per_name = time_ms(fn, iters=20, warmup=3)
            timed[prefix + "ms"] = events if device is None else device
            timed[prefix + "events_ms"] = events
            if prefix == "" and name.endswith("bwd"):
                timed["split_ms"] = bwd_parts(per_name, "k7")
        byte_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        op_ms = 1e3 * ops / PEAK_OPS["bfloat16"]
        timed.update(bound_ms=max(byte_ms, op_ms), bytes=nbytes, ops=ops,
                     bound_by="bytes" if byte_ms >= op_ms else "operations")
        log("flash_time", kernel=name, case="train_bf16", **timed)
        results[name] = dict(timed, max_abs_err=worst_fwd
                             if name.endswith("fwd") else worst_bwd)
    # comparison launches do not count
    fa.flash_attention_fwd.launches = fa.flash_attention_bwd.launches = 0
    del args, q, k, v, do, o, lse, lq, lk, lv, lib_out
    torch.cuda.empty_cache()


# -- phase 4 ------------------------------------------------------------------

def mixed_logits_check(model, seed, tol):
    """One ragged mixed step (prompt chunks beside decode rows over earlier
    KV) through ``GPT2.apply_paged`` with the kernel, then the same forward
    with the plain attention function on the same pages; returns the max
    |logit difference| over live positions and fails past ``tol`` of the
    largest logit."""
    import numpy as np
    import torch

    from tnn_tpu_torch.ops import paged_attention as pa
    from tnn_tpu_torch.serving.kv_pool import PagedKVPool

    dev = model.device
    bs, b, qw = 16, 8, 64
    starts = np.array([0, 0, 130, 700, 37, 512, 999, 3], np.int32)
    q_lens = np.array([64, 17, 64, 40, 1, 1, 1, 0], np.int32)
    pool = PagedKVPool(model.num_layers, model.num_kv_heads,
                       model.d_model // model.num_heads, 600, bs,
                       model.policy.compute_dtype, dev)
    nb = pool.blocks_for(model.max_len)
    tables = np.zeros((b, nb), np.int32)
    for i in range(b):
        blocks = pool.alloc(pool.blocks_for(starts[i] + q_lens[i]))
        tables[i, :len(blocks)] = blocks
    gen = torch.Generator(device=dev).manual_seed(seed)
    for pages in (pool.pages_k, pool.pages_v):   # the rows' earlier KV
        pages.copy_(torch.randn(pages.shape, generator=gen, device=dev))
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, model.vocab_size, (b, qw),
                                         dtype=np.int32)).to(dev)
    args = [torch.from_numpy(x).to(dev) for x in (tables, starts, q_lens)]
    saved = (pool.pages_k.clone(), pool.pages_v.clone())
    with torch.no_grad():
        before = pa.paged_attention.launches
        kern = model.apply_paged(toks, pool.pages_k, pool.pages_v, *args)
        if pa.paged_attention.launches != before + model.num_layers:
            raise AssertionError("mixed step did not run the kernel per layer")
        pool.pages_k.copy_(saved[0])
        pool.pages_v.copy_(saved[1])
        kernel_fn = pa.paged_attention
        pa.paged_attention = pa.paged_attention_reference
        try:
            plain = model.apply_paged(toks, pool.pages_k, pool.pages_v, *args)
        finally:
            pa.paged_attention = kernel_fn
    live = torch.arange(qw, device=dev)[None, :] < args[2][:, None]
    diff = (kern - plain).abs()[live].max().item()
    scale = plain[live].abs().max().item()
    ok = math.isfinite(diff) and diff <= tol * scale
    log("serving_logits", policy=model.policy.compute, max_abs_err=diff,
        max_abs_logit=scale, tolerance=tol * scale, ok=ok)
    if not ok:
        raise AssertionError(f"mixed-step logits kernel vs plain: {diff} > "
                             f"{tol * scale}")


def serve_traffic(model, seed, num_requests=8, new_tokens=64, **engine_kw):
    """One engine run over the smoke traffic; returns (engine, rids)."""
    import numpy as np

    from tnn_tpu_torch.serving.engine import InferenceEngine

    engine = InferenceEngine(model, num_blocks=512, block_size=16,
                             max_batch_size=8, chunk_size=64, seed=seed,
                             device=model.device, **engine_kw)
    rng = np.random.default_rng(seed)
    rids = []
    for i in range(num_requests):
        prompt = rng.integers(0, model.vocab_size, int(rng.integers(16, 769)))
        sampled = i % 2 == 1
        rids.append(engine.submit(
            prompt, new_tokens, temperature=0.8 if sampled else 0.0,
            top_k=50 if sampled else 0, top_p=0.95 if sampled else 0.0))
    engine.run_until_complete()
    return engine, rids


def steady_decode_engine(model, new_tokens, batch=8, **engine_kw):
    """An engine with ``batch`` requests of 500-token prompts, past their
    prefill and first decode step, with ``new_tokens`` tokens each to
    decode."""
    import numpy as np

    from tnn_tpu_torch.serving.engine import InferenceEngine

    engine = InferenceEngine(model, num_blocks=512, block_size=16,
                             max_batch_size=batch, chunk_size=64, seed=0,
                             device=model.device, **engine_kw)
    rng = np.random.default_rng(5)
    for _ in range(batch):
        engine.submit(rng.integers(0, model.vocab_size, 500), new_tokens)
    while any(r.cache_len < r.prefill_len or not r.out_tokens
              for r in engine.requests.values()):
        engine.step()
    engine.step()
    return engine


def profile_decode_steps(model, steps=10, phase="serving_profile",
                         batch=8, **engine_kw):
    """Steady decode steps of ``batch`` rows: wall time per step without the
    profiler in three windows of ``steps`` steps (their median is the step
    time; their spread is the host's within one process), then from a
    profiler window over as many further steps the device-busy time per
    step (summed kernel durations), the kernels that take the most device
    time, the outermost aten ops and the kernels per step, and the ops
    that take the most host self time. Idle share = 1 - busy / unprofiled
    step time: the profiler slows the host, so its own window's wall time
    is printed but not used."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    engine = steady_decode_engine(model, 4 * steps + 8, batch, **engine_kw)
    windows = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) * 1e3 / steps)
    step_ms = sorted(windows)[1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name = collections.Counter()
    host_self = collections.Counter()   # profiled host self time, us
    ops = kernels = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name[:60]] += e.time_range.elapsed_us()
            kernels += 1
            continue
        host_self[e.name[:40]] += e.self_cpu_time_total
        parent = e.cpu_parent
        ops += e.name.startswith("aten::") and not (
            parent is not None and parent.name.startswith("aten::"))
    busy_ms = sum(by_name.values()) / 1e3 / steps
    # host cost per op: the unprofiled step over the step's outermost
    # aten ops, which is what a path with more ops pays more of
    log(phase, decode_rows=batch, kv_len=500, step_ms=step_ms,
        step_ms_windows=windows, profiled_step_ms=profiled_ms,
        device_busy_ms=busy_ms,
        idle_share=1.0 - busy_ms / step_ms,
        aten_ops_per_step=ops / steps, kernels_per_step=kernels / steps,
        step_us_per_op=step_ms * 1e3 * steps / max(ops, 1),
        top_kernels_ms=[(n, t / 1e3 / steps)
                        for n, t in by_name.most_common(6)],
        top_host_self_ms=[(n, t / 1e3 / steps)
                          for n, t in host_self.most_common(8)],
        program_steps=engine.stats()["program_steps"])


def host_ab(model, rounds=4, steps=5, launches=2000,
            phase="serving_int8_host_ab", paths=None):
    """Two decode paths' steady steps timed in alternating windows of
    ``steps`` steps (default: the bf16 path, then int8 pool and weights),
    each round also timing ``launches`` back-to-back tiny kernel launches
    (the host's cost per launch at that moment), and one last round with
    Python's garbage collector off. If the second/first ratio holds while
    all three move together, the host's speed varies and each path pays
    for it per op; a ratio that moves alone is the second path's own."""
    import gc

    import torch

    n = rounds + 1
    paths = paths or {"bf16": {}, "int8": INT8_SERVING}
    engines = {name: steady_decode_engine(model, n * steps + 8, **kw)
               for name, kw in paths.items()}
    first, second = paths
    probe = torch.zeros(1024, device=model.device)

    def window(fn, count):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(count):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / count

    rows = []
    for r in range(n):
        if r == rounds:
            gc.disable()
        try:
            row = {"launch_us": window(lambda: probe.add_(1),
                                       launches) * 1e6}
            for name, eng in engines.items():
                row[f"{name}_ms"] = window(eng.step, steps) * 1e3
        finally:
            gc.enable()
        row["ratio"] = row[f"{second}_ms"] / row[f"{first}_ms"]
        rows.append(row)
    log(phase, steps_per_window=steps,
        launches_per_window=launches, rounds=rows[:rounds],
        gc_off=rows[rounds])


def phase_serving(results):
    import torch

    from tnn_tpu_torch.core import dtypes as dt
    from tnn_tpu_torch.models import zoo
    from tnn_tpu_torch.ops.paged_attention import paged_attention
    from tnn_tpu_torch.serving.scheduler import RequestState

    t0 = time.perf_counter()
    model = zoo.create("gpt2_small", device="cuda", seed=0)
    log("model", name="gpt2_small", policy=model.policy.compute,
        params=sum(p.numel() for p in model.parameters()),
        init_s=round(time.perf_counter() - t0, 3))
    serve_traffic(model, seed=1, num_requests=2, new_tokens=4)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    paged_attention.launches = 0
    t0 = time.perf_counter()
    engine, rids = serve_traffic(model, seed=0)
    wall = time.perf_counter() - t0
    launches = paged_attention.launches
    stats = engine.stats()
    finished = [engine.result(r) for r in rids]
    bad = [r.rid for r in finished if r.state is not RequestState.FINISHED
           or len(r.out_tokens) != 64]
    expected = model.num_layers * engine.model_steps
    log("serving", requests=len(rids), finished=len(rids) - len(bad),
        kernel_launches=launches, model_steps=engine.model_steps,
        expected_launches=expected, wall_s=wall,
        ttft_ms_p50=stats["ttft_ms_p50"], ttft_ms_p95=stats["ttft_ms_p95"],
        decode_tok_per_s=stats["tok_per_s"],
        step_ms_mean=stats["step_latency_ms_mean"],
        steps=stats["steps"], preemptions=stats["preemptions"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    if bad:
        raise AssertionError(f"requests not FINISHED with 64 tokens: {bad}")
    if launches != expected or launches == 0:
        raise AssertionError(f"paged_attention launched {launches} times, "
                             f"expected num_layers x model steps = {expected}")
    results["launches"] = launches
    engine.check_invariants()

    # greedy decoding is deterministic: a second run gives the same tokens
    engine2, rids2 = serve_traffic(model, seed=0)
    greedy = [(a, b) for i, (a, b) in enumerate(zip(rids, rids2))
              if i % 2 == 0]
    same = all(engine.result(a).out_tokens == engine2.result(b).out_tokens
               for a, b in greedy)
    log("serving_repeat", greedy_requests=len(greedy), identical=same)
    if not same:
        raise AssertionError("two greedy runs gave different tokens")

    profile_decode_steps(model)
    mixed_logits_check(model, seed=3, tol=3e-2)
    del engine, engine2, model
    fp32 = zoo.create("gpt2_small", device="cuda", seed=0, policy=dt.FP32)
    mixed_logits_check(fp32, seed=4, tol=1e-4)
    del fp32
    torch.cuda.empty_cache()


# -- phase 5 ------------------------------------------------------------------

def cli_check(flags=()):
    """The serving CLI on two JSON lines, with ``flags`` added."""
    lines = [{"id": "greedy", "tokens": [464, 3616, 286, 1204, 318],
              "max_new_tokens": 8},
             {"id": "sampled", "tokens": list(range(100, 140)),
              "max_new_tokens": 6, "temperature": 0.8, "top_k": 50,
              "top_p": 0.95}]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tnn_tpu_torch.cli.serve", "--model",
         "gpt2_small", *flags],
        input="".join(json.dumps(x) + "\n" for x in lines),
        capture_output=True, text=True, timeout=600)
    events = [json.loads(x) for x in proc.stdout.splitlines() if x.strip()]
    done = {e["id"]: e for e in events if e.get("event") == "done"}
    ok = (proc.returncode == 0 and set(done) == {"greedy", "sampled"}
          and len(done["greedy"]["tokens"]) == 8
          and len(done["sampled"]["tokens"]) == 6)
    log("cli", flags=list(flags), returncode=proc.returncode,
        done_events=len(done),
        token_events=sum(e.get("event") == "token" for e in events),
        seconds=round(time.perf_counter() - t0, 3), ok=ok)
    if not ok:
        raise AssertionError(f"CLI run failed: rc {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return proc


def phase_cli(results):
    cli_check()


# -- phase 6 ------------------------------------------------------------------

TRAIN_STEPS = 30
EVAL_STEPS = 10     # the trainer's held-out pass: 10 batches
TRAIN_ARGS = dict(batch=8, seq=1024, layers=12, d_model=768, heads=12)
# one step with the kernels against the same step with the plain versions,
# from the same weights and batch (AdamW, lr 3e-4, no schedule): the loss
# within `loss` relative, and the parameter update (new - old over every
# parameter but the key bias, whose gradient is zero but for rounding and
# which Adam scales up to +-lr) with a cosine above `cos` to the plain one.
# Adam's first update is g / (|g| + eps) per element, so elements whose
# gradient is at rounding level flip sign; FP32 differs only in summation
# order, bf16 also in where p and ds are rounded.
STEP_TOLERANCE = {"float32": dict(loss=1e-5, cos=0.999),
                  "bfloat16": dict(loss=1e-3, cos=0.99)}
PEAK_BF16 = PEAK_OPS["bfloat16"]


def synthetic_corpus(path, vocab=50257, n_train=2_000_000, n_val=200_000,
                     seed=0):
    """uint16 tokens below ``vocab`` with structure to learn: one seeded
    256-token segment repeated, 10% of positions replaced by noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    segment = rng.integers(0, vocab, 256)

    def stream(n):
        toks = np.tile(segment, n // 256 + 1)[:n]
        noise = rng.random(n) < 0.1
        toks[noise] = rng.integers(0, vocab, int(noise.sum()))
        return toks.astype(np.uint16)

    stream(n_train).tofile(path / "train.bin")
    stream(n_val).tofile(path / "val.bin")
    (path / "meta.json").write_text(json.dumps({
        "mode": "synthetic", "vocab_size": vocab, "files": 0,
        "train_tokens": n_train, "val_tokens": n_val}))


def model_flops_per_step(layers, d_model, vocab, batch, seq):
    """6 x (weights in matmuls, the tied head included: 12 L d^2 + V d) per
    token, plus causal attention 6 L S d per token (QK and PV over S/2 keys
    on average, forward and the backward's twice as much)."""
    n = 12 * layers * d_model ** 2 + vocab * d_model
    return (6 * n + 6 * layers * seq * d_model) * batch * seq


def _flash_gpt2_small(policy=None):
    """Seeded full-width flash_gpt2_small on the card."""
    from tnn_tpu_torch.models import zoo

    return zoo.create("flash_gpt2_small", device="cuda", seed=0,
                      policy=policy)


def _fresh_step(model):
    from tnn_tpu_torch.nn.optimizers import AdamW
    from tnn_tpu_torch.train import create_train_state, make_train_step

    opt = AdamW(lr=3e-4, weight_decay=0.01, grad_clip_norm=1.0)
    return create_train_state(model, opt), make_train_step(model, opt)


def _batch(loader, rng):
    import torch

    d, l = loader.random_windows(TRAIN_ARGS["batch"], rng)
    return (torch.from_numpy(d).cuda().long(),
            torch.from_numpy(l).cuda().long())


def step_kernel_vs_plain(model, loader):
    """One train step of ``model`` with K4/K7, then the same step with the
    plain versions swapped into the autograd Function, from the same
    weights."""
    import numpy as np
    import torch

    from tnn_tpu_torch.ops import flash_attention as fa

    policy = model.policy
    state, step = _fresh_step(model)
    x, y = _batch(loader, np.random.default_rng(3))
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    _, m = step(state, x, y)
    loss_k = float(m["loss"])
    kern = {n: p.detach().clone() for n, p in model.named_parameters()}
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(start[n])
    state, step = _fresh_step(model)
    saved = fa.flash_attention_fwd, fa.flash_attention_bwd
    fa.flash_attention_fwd = fa.flash_attention_reference
    fa.flash_attention_bwd = fa.flash_attention_backward_reference
    try:
        _, m = step(state, x, y)
    finally:
        fa.flash_attention_fwd, fa.flash_attention_bwd = saved
    loss_p = float(m["loss"])
    d = model.d_model
    dk, dp = [], []
    for n, p in model.named_parameters():
        a, b = kern[n] - start[n], p.detach() - start[n]
        if n.endswith("qkv_bias"):
            a, b = torch.cat([a[:d], a[2 * d:]]), torch.cat([b[:d], b[2 * d:]])
        dk.append(a.flatten())
        dp.append(b.flatten())
    dk, dp = torch.cat(dk).double(), torch.cat(dp).double()
    cos = float(dk @ dp / (dk.norm() * dp.norm()))
    tol = STEP_TOLERANCE[policy.compute]
    rel = abs(loss_k - loss_p) / abs(loss_p)
    ok = math.isfinite(loss_k) and rel <= tol["loss"] and cos > tol["cos"]
    log("train_step_vs_plain", policy=policy.compute, loss_kernel=loss_k,
        loss_plain=loss_p, loss_rel_diff=rel, update_cosine=cos,
        update_norm=float(dk.norm()), tolerance=tol, ok=ok)
    del model, state, step, start, kern
    if not ok:
        raise AssertionError(f"{policy.compute} train step kernel vs plain: "
                             f"loss rel {rel}, update cosine {cos}")


class StepRecorder:
    """Wraps the trainer's step function: keeps every step's loss (on the
    device), CUDA events around the steady steps ``timed`` and a profiler
    window over the steps ``profiled`` (after the timed ones: the profiler
    slows the host)."""

    def __init__(self, timed=range(10, 20), profiled=range(22, 24)):
        self.timed, self.profiled = timed, profiled
        self.losses, self.events, self.prof = [], [], None

    def wrap(self, make_train_step):
        def make(*a, **kw):
            step = make_train_step(*a, **kw)

            def run(state, x, y):
                import torch
                from torch.profiler import ProfilerActivity, profile

                i = len(self.losses)
                if i == self.profiled.start:
                    torch.cuda.synchronize()
                    self.prof = profile(activities=[ProfilerActivity.CPU,
                                                    ProfilerActivity.CUDA])
                    self.prof.start()
                if i in self.timed:
                    self.events.append(torch.cuda.Event(enable_timing=True))
                    self.events[-1].record()
                state, m = step(state, x, y)
                self.losses.append(m["loss"])
                if i == self.timed[-1]:
                    self.events.append(torch.cuda.Event(enable_timing=True))
                    self.events[-1].record()
                if i == self.profiled[-1]:
                    torch.cuda.synchronize()
                    self.prof.stop()
                return state, m
            return run
        return make

    def step_ms(self):
        return self.events[0].elapsed_time(self.events[-1]) / len(self.timed)

    def kernel_labels(self):
        """The labels (``kernel_label``) of the profiled kernels."""
        import torch

        return sorted({kernel_label(e.name) for e in self.prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA})

    def device_ms(self):
        """Summed kernel durations per profiled step, by kernel name."""
        import collections

        import torch

        by_name = collections.Counter()
        for e in self.prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.name[:60]] += e.time_range.elapsed_us()
        n = len(self.profiled)
        return {k: v / 1e3 / n for k, v in by_name.items()}


def phase_training(results):
    import contextlib
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from tnn_tpu_torch.cli import train_gpt2
    from tnn_tpu_torch.core import dtypes as dt
    from tnn_tpu_torch.data.token_stream import TokenStreamDataLoader
    from tnn_tpu_torch.ops import flash_attention as fa

    with tempfile.TemporaryDirectory() as tmp:
        corpus = Path(tmp) / "corpus"
        corpus.mkdir()
        synthetic_corpus(corpus)
        rec = StepRecorder()
        real_make = train_gpt2.make_train_step

        argv = ["--tokens", str(corpus), "--steps", str(TRAIN_STEPS),
                "--backend", "pallas", "--sample", "0",
                "--results", str(Path(tmp) / "results")]
        for key, value in TRAIN_ARGS.items():
            argv += [f"--{key.replace('_', '-')}", str(value)]
        train_gpt2.make_train_step = rec.wrap(real_make)
        torch.cuda.reset_peak_memory_stats()
        fa.flash_attention_fwd.launches = fa.flash_attention_bwd.launches = 0
        fa.flash_attention_bwd_dq.launches = 0
        fa.flash_attention_bwd_dkv.launches = 0
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):   # its progress
                out = train_gpt2.main(argv)
            wall = time.perf_counter() - t0
        finally:
            train_gpt2.make_train_step = real_make
        fwd, bwd = fa.flash_attention_fwd.launches, \
            fa.flash_attention_bwd.launches
        split = (fa.flash_attention_bwd_dq.launches,
                 fa.flash_attention_bwd_dkv.launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [float(x) for x in rec.losses]
        layers = TRAIN_ARGS["layers"]
        want = (layers * (TRAIN_STEPS + EVAL_STEPS), layers * TRAIN_STEPS)
        finite = all(math.isfinite(x) for x in losses)
        falling = float(np.mean(losses[-5:])) < losses[0]
        # S=1024 is inside the fused backward's budget: K5 and K6 stay idle
        ok = (len(losses) == TRAIN_STEPS and finite and falling
              and (fwd, bwd) == want and split == (0, 0)
              and math.isfinite(out.get("val_loss", math.nan)))
        log("training", model="flash_gpt2_small", steps=TRAIN_STEPS,
            **TRAIN_ARGS, first_loss=losses[0],
            last5_mean_loss=float(np.mean(losses[-5:])), losses=losses,
            val_loss=out.get("val_loss"), cli_train_tok_per_s=out[
                "train_tok_per_s"], platform=out["platform"],
            fwd_launches=fwd, bwd_launches=bwd, expected_launches=list(want),
            split_launches=list(split), wall_s=wall, ok=ok)
        if not ok:
            raise AssertionError(
                f"training: {len(losses)} steps, finite {finite}, falling "
                f"{falling}, launches {(fwd, bwd)} vs {want}, K5/K6 {split}")
        results["flash_launches"] = {"flash_attention_fwd": fwd,
                                     "flash_attention_bwd": bwd}
        step_ms = rec.step_ms()
        kernels = rec.device_ms()
        busy = sum(kernels.values())
        tokens = TRAIN_ARGS["batch"] * TRAIN_ARGS["seq"]
        flops = model_flops_per_step(
            TRAIN_ARGS["layers"], TRAIN_ARGS["d_model"], 50257,
            TRAIN_ARGS["batch"], TRAIN_ARGS["seq"])
        log("train_profile", steps_timed=len(rec.timed), step_ms=step_ms,
            tokens_per_s=tokens / step_ms * 1e3, peak_mem_gb=peak,
            model_flops_per_step=flops,
            flops_formula="B*S*(6*(12*L*d^2 + V*d) + 6*L*S*d)",
            mfu=flops / (step_ms * 1e-3 * PEAK_BF16),
            device_busy_ms=busy, idle_share=1.0 - busy / step_ms,
            flash_kernels_ms=sum(t for n, t in kernels.items()
                                 if "flash" in n),
            top_kernels_ms=sorted(kernels.items(), key=lambda kv: -kv[1])[:8])
        loader = TokenStreamDataLoader(str(corpus / "train.bin"),
                                       TRAIN_ARGS["seq"])
        for policy in (dt.MIXED_BF16, dt.FP32):
            step_kernel_vs_plain(_flash_gpt2_small(policy), loader)
            torch.cuda.empty_cache()


# -- phase 7 ------------------------------------------------------------------

def phase_train_cli(results):
    import contextlib
    import sysconfig
    import tempfile
    from pathlib import Path

    import torch

    from tnn_tpu_torch.cli import prepare_corpus, train_gpt2
    from tnn_tpu_torch.ops import flash_attention as fa

    layers, steps, evals, sample = 2, 20, 10, 32
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(sys.stderr):     # their progress
        corpus, res = Path(tmp) / "corpus", Path(tmp) / "results"
        t0 = time.perf_counter()
        meta = prepare_corpus.main([
            "--out", str(corpus), "--source",
            sysconfig.get_paths()["stdlib"], "--max-mb", "8"])
        fa.flash_attention_fwd.launches = fa.flash_attention_bwd.launches = 0
        out = train_gpt2.main([
            "--tokens", str(corpus), "--steps", str(steps), "--batch", "8",
            "--seq", "256", "--layers", str(layers), "--d-model", "768",
            "--heads", "12", "--backend", "pallas", "--sample", str(sample),
            "--results", str(res)])
        fwd, bwd = fa.flash_attention_fwd.launches, \
            fa.flash_attention_bwd.launches
        saved = json.loads((res / "lm_gpt2_byte_pallas.json").read_text())
    # K4 on every train, held-out, prompt and decode forward (generate's
    # cached steps take its kv_offset form); K7 on every train backward
    want = (layers * (steps + evals + 1 + (sample - 1)), layers * steps)
    fields = {"metric", "backend", "platform", "model", "steps",
              "steps_per_call", "train_tok_per_s", "final_train_loss",
              "final_train_ppl", "curve", "val_loss", "val_ppl",
              "decode_tok_per_s", "sample"}
    ok = (saved == out and set(out) == fields
          and out["platform"] == torch.cuda.get_device_name(0)
          and all(math.isfinite(c["loss"]) for c in out["curve"])
          and math.isfinite(out["val_loss"]) and len(out["sample"]) > 0
          and out["decode_tok_per_s"] > 0 and (fwd, bwd) == want)
    log("train_cli", corpus_tokens=meta["train_tokens"],
        **{k: out.get(k) for k in ("final_train_loss", "val_loss",
                                   "train_tok_per_s", "decode_tok_per_s")},
        sample_chars=len(out.get("sample", "")), fwd_launches=fwd,
        bwd_launches=bwd, expected_launches=list(want),
        seconds=round(time.perf_counter() - t0, 3), ok=ok)
    if not ok:
        raise AssertionError(f"train CLI run failed: launches {(fwd, bwd)} "
                             f"vs {want}; {out}")
    train_cli_llama(fields)


def train_cli_llama(fields):
    """``cli.train_gpt2 --arch llama`` at S=32,768 (2 layers of
    llama_small's widths) on the stdlib byte corpus: K5 and K6 on every
    train backward, K7 never, K4 on every train, held-out, prompt and
    decode forward."""
    import contextlib
    import sysconfig
    import tempfile
    from pathlib import Path

    import torch

    from tnn_tpu_torch.cli import prepare_corpus, train_gpt2
    from tnn_tpu_torch.ops import flash_attention as fa

    layers, steps, evals, sample = 2, 3, 10, 8
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd,
                fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(sys.stderr):     # their progress
        corpus, res = Path(tmp) / "corpus", Path(tmp) / "results"
        t0 = time.perf_counter()
        prepare_corpus.main([
            "--out", str(corpus), "--source",
            sysconfig.get_paths()["stdlib"], "--max-mb", "8"])
        for c in counters:
            c.launches = 0
        out = train_gpt2.main([
            "--tokens", str(corpus), "--arch", "llama", "--steps", str(steps),
            "--batch", "1", "--seq", str(LONG_SEQ), "--layers", str(layers),
            "--d-model", "768", "--heads", "12", "--kv-heads", "4",
            "--backend", "pallas", "--sample", str(sample),
            "--results", str(res)])
        launches = tuple(c.launches for c in counters)
        saved = json.loads((res / "lm_llama_byte_pallas.json").read_text())
    want = (layers * (steps + evals + 1 + (sample - 1)), 0, layers * steps,
            layers * steps)
    ok = (saved == out and set(out) == fields
          and out["metric"] == "llama_bytes_lm"
          and out["platform"] == torch.cuda.get_device_name(0)
          and all(math.isfinite(c["loss"]) for c in out["curve"])
          and math.isfinite(out["val_loss"]) and len(out["sample"]) > 0
          and launches == want)
    log("train_cli_llama", seq=LONG_SEQ, layers=layers,
        **{k: out.get(k) for k in ("platform", "final_train_loss",
                                   "val_loss", "train_tok_per_s",
                                   "decode_tok_per_s")},
        k4_k7_k5_k6_launches=list(launches), expected_launches=list(want),
        seconds=round(time.perf_counter() - t0, 3), ok=ok)
    if not ok:
        raise AssertionError(f"llama train CLI run failed: launches "
                             f"{launches} vs {want}; {out}")


# -- phase 8 ------------------------------------------------------------------
#
# K2 against its plain version, element by element:
#   |out - ref| <= atol + rtol * |ref| + 1e-5 * p.|v|,  (atol, rtol) below,
# where p.|v| is the plain version over |V|. Both sides dequantize K/V to
# f32 and leave p unrounded (v is f32), so their f32 sums differ in order
# only, within 1e-5 p.|v|. A bf16 q is promoted to f32 exactly; the output
# is then rounded to bf16 on both sides from f32 values that may straddle a
# rounding point: one bf16 ulp, at most 2^-7 |ref|.
INT8_TOLERANCE = {"float32": (1e-5, 1e-5), "bfloat16": (1e-4, 2 ** -7)}


def quant_case(seed, **spec):
    """``paged_case`` with the pages quantized as the pool writes them."""
    from tnn_tpu_torch.ops import paged_attention as pa

    args = paged_case(seed, **spec)
    for name in ("pages_k", "pages_v"):
        args[name] = pa.QuantPages(*pa.quantize_kv_rows(args[name].float()))
    return args


def dequant_args(args):
    """The same call over pages dequantized to q's dtype (for SDPA)."""
    deq = {}
    for name in ("pages_k", "pages_v"):
        p = args[name]
        deq[name] = (p.data.float() * p.scale).to(args["q"].dtype)
    return {**args, **deq}


def phase_int8_kernel(results):
    import torch
    import torch.nn.functional as F

    from tnn_tpu_torch.ops import paged_attention as pa

    bf16, f32 = torch.bfloat16, torch.float32
    kv500 = [500, 17, 512, 1, 333, 499, 64, 510]
    mixed_q = [64, 64, 40, 64, 1, 1, 1, 1]
    mixed_kv = [64, 448, 980, 704, 513, 100, 2, 1000]
    small = dict(heads=12, kv_heads=12, head_dim=64, block_size=16)
    cases = {
        "decode_bf16": dict(decode_form=True, q_lens=[1] * 8,
                            kv_lens=[500] * 8, dtype=bf16, **small),
        "decode_ragged_bf16": dict(decode_form=True, q_lens=[1] * 8,
                                   kv_lens=kv500, dtype=bf16, **small),
        "mixed_bf16": dict(decode_form=False, q_lens=mixed_q,
                           kv_lens=mixed_kv, dtype=bf16, **small),
        "decode_gqa4_bf16": dict(decode_form=True, q_lens=[1] * 8,
                                 kv_lens=kv500, dtype=bf16, heads=12,
                                 kv_heads=4, head_dim=64, block_size=16),
        "mixed_gqa4_f32": dict(decode_form=False, q_lens=mixed_q,
                               kv_lens=mixed_kv, dtype=f32, heads=12,
                               kv_heads=4, head_dim=64, block_size=16),
        "holes_zero_len_bf16": dict(decode_form=False,
                                    q_lens=[64, 0, 1, 0, 30, 1, 64, 1],
                                    kv_lens=[300, 0, 200, 50, 90, 0, 64, 77],
                                    dtype=bf16, holes=True, **small),
        "decode_f32": dict(decode_form=True, q_lens=[1] * 8, kv_lens=kv500,
                           dtype=f32, **small),
        "mixed_holes_f32": dict(decode_form=False, q_lens=mixed_q,
                                kv_lens=mixed_kv, dtype=f32, holes=True,
                                **small),
        "decode_bs4_bf16": dict(decode_form=True, q_lens=[1] * 8,
                                kv_lens=kv500, dtype=bf16, heads=12,
                                kv_heads=12, head_dim=64, block_size=4),
        "mixed_bs4_f32": dict(decode_form=False, q_lens=mixed_q,
                              kv_lens=mixed_kv, dtype=f32, heads=12,
                              kv_heads=12, head_dim=64, block_size=4),
        "decode_hd128_bf16": dict(decode_form=True, q_lens=[1] * 8,
                                  kv_lens=kv500, dtype=bf16, heads=6,
                                  kv_heads=6, head_dim=128, block_size=16),
        "mixed_hd128_f32": dict(decode_form=False, q_lens=mixed_q,
                                kv_lens=mixed_kv, dtype=f32, heads=6,
                                kv_heads=6, head_dim=128, block_size=16),
    }
    worst = 0.0
    for i, (name, spec) in enumerate(cases.items()):
        args = quant_case(300 + i, batch=8, **spec)
        before = (pa.paged_attention.launches,
                  pa.paged_attention.int8_launches)
        out = pa.paged_attention(**args)
        torch.cuda.synchronize()
        if (pa.paged_attention.launches, pa.paged_attention.int8_launches) \
                != (before[0], before[1] + 1):
            raise AssertionError(f"int8 {name}: K2 did not launch alone")
        ref = pa.paged_attention_reference(**args).float()
        v = args["pages_v"]
        ref_abs_v = pa.paged_attention_reference(**{
            **args, "pages_v": pa.QuantPages(v.data.abs(), v.scale)}).float()
        diff = (out.float() - ref).abs()
        atol, rtol = INT8_TOLERANCE[str(spec["dtype"]).split(".")[-1]]
        limit = atol + rtol * ref.abs() + 1e-5 * ref_abs_v
        used = (diff / limit).max().item()
        err = diff.max().item()
        dead_nonzero = 0.0
        if not spec["decode_form"]:
            for bi, n in enumerate(spec["q_lens"]):
                if n < out.shape[1]:
                    dead_nonzero = max(dead_nonzero,
                                       out[bi, n:].float().abs().max().item())
        for bi, n in enumerate(spec["kv_lens"]):
            if n == 0:
                dead_nonzero = max(dead_nonzero,
                                   out[bi].float().abs().max().item())
        ok = math.isfinite(used) and used <= 1.0 and dead_nonzero == 0.0
        log("int8_kernel", case=name, block_size=spec["block_size"],
            max_abs_err=err, atol=atol, rtol=rtol, limit_used=used,
            dead_rows_max=dead_nonzero, ok=ok)
        if not ok:
            raise AssertionError(
                f"int8 paged_attention {name}: |err| exceeds {atol} + {rtol} "
                f"|ref| + 1e-5 p.|v| ({used:.3g} of the limit) or dead rows "
                f"{dead_nonzero}")
        worst = max(worst, err)

    timed = {}
    for name in ("decode_bf16", "mixed_bf16"):
        args = quant_case(7, batch=8, **cases[name])
        nbytes, ops = paged_work(args)
        bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                             ops / PEAK_OPS["bfloat16"])
        sq, sk, sv, smask, gqa = sdpa_inputs(dequant_args(args))
        runs = {"": lambda: pa.paged_attention(**args),
                "plain_": lambda: pa.paged_attention_reference(**args),
                "library_": lambda: F.scaled_dot_product_attention(
                    sq, sk, sv, attn_mask=smask, enable_gqa=gqa)}
        timed[name] = {}
        for prefix, fn in runs.items():
            device, events, _ = time_ms(fn)
            timed[name][prefix + "ms"] = events if device is None else device
            timed[name][prefix + "events_ms"] = events
        timed[name].update(bound_ms=bound_ms, bytes=nbytes, ops=ops,
                           bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                           >= ops / PEAK_OPS["bfloat16"] else "operations")
        log("int8_kernel_time", case=name, **timed[name])
    pa.paged_attention.int8_launches = 0   # comparison launches do not count
    results["paged_attention_int8"] = dict(max_abs_err=worst,
                                           **timed["decode_bf16"])


# -- phase 9 ------------------------------------------------------------------
#
# K3 against its plain version, element by element:
#   |got - ref| <= 1e-5 * mag + rtol * |ref|,  mag = |x| @ |dequant(W)|,
# rtol 0 for an f32 result and 2^-7 for a bf16 one. Both sides sum the same
# f32 products (int8 -> x's dtype is exact) in another order: for K up to
# 3072 the two sums differ by about sqrt(K) 2^-24 mag (3.3e-6 mag), within
# 1e-5 mag. A bf16 result rounds the two sums on each side of a rounding
# point at most one ulp apart, 2^-7 |ref|.
MATMUL_SHAPES = {   # (M, K, N, out f32): gpt2_small at 512 rows, the
    # head as the serving path calls it (8 last rows), and a ragged case
    "qkv": (512, 768, 2304, False), "out": (512, 768, 768, False),
    "fc": (512, 768, 3072, False), "proj": (512, 3072, 768, False),
    "head": (512, 768, 50257, True), "head8": (8, 768, 50257, True),
    "ragged": (300, 300, 130, False)}


def phase_int8_matmul(results):
    import torch

    from tnn_tpu_torch.ops import quant_matmul as qm

    dev = torch.device("cuda")
    worst = 0.0
    for i, (shape, (m, k, n, head)) in enumerate(MATMUL_SHAPES.items()):
        gen = torch.Generator(device=dev).manual_seed(400 + i)
        iw = qm.quantize_int8(torch.randn((k, n), generator=gen, device=dev)
                              * 0.02)
        x32 = torch.randn((m, k), generator=gen, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            name = f"{shape}_{str(dtype).split('.')[-1]}"
            x = x32.to(dtype)
            out_dtype = torch.float32 if head else None
            kw = dict(n=n, k=k, out_dtype=out_dtype)
            before = qm.int8_matmul.launches
            got = qm.int8_matmul(x, iw.q, iw.scale, **kw)
            torch.cuda.synchronize()
            if qm.int8_matmul.launches != before + 1:
                raise AssertionError(f"int8_matmul {name}: K3 did not launch")
            ref = qm.int8_matmul_reference(x, iw.q, iw.scale, **kw).float()
            mag = x.float().abs() @ iw.dequant().abs()
            rtol = 0.0 if got.dtype == torch.float32 else 2 ** -7
            diff = (got.float() - ref).abs()
            used = (diff / (1e-5 * mag + rtol * ref.abs())).max().item()
            err = diff.max().item()
            ok = math.isfinite(used) and used <= 1.0 \
                and tuple(got.shape) == (m, n)
            entry = dict(case=name, m=m, k=k, n=n, out=str(got.dtype),
                         max_abs_err=err, limit_used=used, ok=ok)
            if not ok:
                log("int8_matmul", **entry)
                raise AssertionError(f"int8_matmul {name}: |err| exceeds "
                                     f"1e-5 mag + {rtol} |ref| ({used:.3g} "
                                     "of the limit)")
            worst = max(worst, err)
            del ref, mag, diff
            # time: the kernel, the plain version, and torch.mm of x with
            # the weight dequantized ahead (int8 -> x's dtype), then the scale
            wt = iw.q[:n, :k].to(dtype).t()
            sc = iw.scale[:n]
            odt = out_dtype or dtype
            mm_kw = {} if odt == dtype else {"out_dtype": odt}
            runs = {"": lambda: qm.int8_matmul(x, iw.q, iw.scale, **kw),
                    "plain_": lambda: qm.int8_matmul_reference(
                        x, iw.q, iw.scale, **kw),
                    "library_": lambda: (torch.mm(x, wt, **mm_kw)
                                         * sc).to(odt)}
            for prefix, fn in runs.items():
                device, events, _ = time_ms(fn, iters=20, warmup=3)
                entry[prefix + "ms"] = events if device is None else device
                entry[prefix + "events_ms"] = events
            nbytes = (m * k * x.element_size() + n * k + 4 * n
                      + m * n * torch.empty((), dtype=odt).element_size())
            ops = 2 * m * n * k
            peak = PEAK_OPS[str(dtype).split(".")[-1]]
            byte_ms, op_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / peak
            entry.update(bound_ms=max(byte_ms, op_ms), bytes=nbytes, ops=ops,
                         bound_by="bytes" if byte_ms >= op_ms
                         else "operations")
            log("int8_matmul", **entry)
            if name == "qkv_bfloat16":
                results["int8_matmul"] = entry
            del got, wt
        del iw, x32
        torch.cuda.empty_cache()
    results["int8_matmul"]["max_abs_err"] = worst
    qm.int8_matmul.launches = 0   # comparison launches do not count


# -- phase 10 -----------------------------------------------------------------

INT8_SERVING = dict(kv_dtype="int8", quant_weights=True)


def count_wide_steps(fn):
    """Run ``fn()`` counting the ragged mixed steps (``GPT2.apply_paged``
    calls) of more than ``W8A8_MAX_ROWS`` token rows, whose matmuls take
    K3; returns (fn's result, that count)."""
    from tnn_tpu_torch.models.gpt2 import GPT2
    from tnn_tpu_torch.ops.quant_matmul import W8A8_MAX_ROWS

    real = GPT2.apply_paged
    wide = [0]

    def apply_paged(self, toks, *a, **kw):
        wide[0] += toks.numel() > W8A8_MAX_ROWS
        return real(self, toks, *a, **kw)

    GPT2.apply_paged = apply_paged
    try:
        out = fn()
    finally:
        GPT2.apply_paged = real
    return out, wide[0]


def closeness_gate(model, engine, rids):
    """The float model, teacher-forced over the int8 engine's greedy
    sequences (tests/test_quant_serving.py:289-329): the chosen token is the
    argmax in >= 75% of positions and trails it by < 0.25 everywhere else.
    Returns (exact, total, largest margin)."""
    import torch

    exact = total = 0
    margins = []
    for rid in rids:
        req = engine.result(rid)
        seq = list(req.prompt) + list(req.out_tokens)
        with torch.inference_mode():
            logits = model(torch.tensor([seq], device=model.device))[0]
        plen = len(req.prompt)
        rows = logits[plen - 1:len(seq) - 1].double()
        chosen = torch.tensor(req.out_tokens, device=rows.device)
        best = rows.max(dim=-1).values
        picked = rows.gather(1, chosen[:, None])[:, 0]
        hit = rows.argmax(dim=-1) == chosen
        exact += int(hit.sum())
        total += len(chosen)
        margins += (best - picked)[~hit].tolist()
    return exact, total, max(margins, default=0.0)


def phase_serving_int8(results):
    import torch

    from tnn_tpu_torch.models import zoo
    from tnn_tpu_torch.ops import paged_attention as pa
    from tnn_tpu_torch.ops import quant_matmul as qm
    from tnn_tpu_torch.serving.scheduler import RequestState

    model = zoo.create("gpt2_small", device="cuda", seed=0)
    serve_traffic(model, seed=1, num_requests=2, new_tokens=4,
                  **INT8_SERVING)                                # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.paged_attention.launches = pa.paged_attention.int8_launches = 0
    qm.int8_matmul.launches = 0
    t0 = time.perf_counter()
    (engine, rids), wide = count_wide_steps(
        lambda: serve_traffic(model, seed=0, **INT8_SERVING))
    wall = time.perf_counter() - t0
    k1, k2 = pa.paged_attention.launches, pa.paged_attention.int8_launches
    k3 = qm.int8_matmul.launches
    stats = engine.stats()
    steps = engine.model_steps
    want = {"k1": 0, "k2": model.num_layers * steps,
            "k3": (4 * model.num_layers + 1) * wide}
    bf16_bytes = 2 * model.num_layers * model.num_kv_heads * (
        model.d_model // model.num_heads) * 2
    finished = [engine.result(r) for r in rids]
    bad = [r.rid for r in finished if r.state is not RequestState.FINISHED
           or len(r.out_tokens) != 64]
    log("serving_int8", requests=len(rids), finished=len(rids) - len(bad),
        model_steps=steps, wide_steps=wide, k1_launches=k1, k2_launches=k2,
        k3_launches=k3, expected=want, wall_s=wall,
        ttft_ms_p50=stats["ttft_ms_p50"], ttft_ms_p95=stats["ttft_ms_p95"],
        decode_tok_per_s=stats["tok_per_s"],
        step_ms_mean=stats["step_latency_ms_mean"], steps=stats["steps"],
        preemptions=stats["preemptions"],
        kv_bytes_per_token=stats["kv_bytes_per_token"],
        kv_scale_bytes_per_token=stats["kv_scale_bytes_per_token"],
        bf16_kv_bytes_per_token=bf16_bytes,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    if bad:
        raise AssertionError(f"int8 requests not FINISHED with 64 tokens: "
                             f"{bad}")
    if {"k1": k1, "k2": k2, "k3": k3} != want or wide == 0:
        raise AssertionError(f"int8 serving launches K1 {k1}, K2 {k2}, K3 "
                             f"{k3} over {steps} steps ({wide} wide); want "
                             f"{want}")
    if 2 * stats["kv_bytes_per_token"] != bf16_bytes \
            or not stats["quant_weights"] or stats["kv_dtype"] != "int8":
        raise AssertionError(f"int8 engine stats: {stats}")
    results["int8_launches"] = {"k2": k2, "k3": k3}
    engine.check_invariants()

    engine2, rids2 = serve_traffic(model, seed=0, **INT8_SERVING)
    greedy = [(a, b) for i, (a, b) in enumerate(zip(rids, rids2))
              if i % 2 == 0]
    same = all(engine.result(a).out_tokens == engine2.result(b).out_tokens
               for a, b in greedy)
    exact, total, worst = closeness_gate(model, engine,
                                         [a for a, _ in greedy])
    ok = same and exact >= 0.75 * total and worst < 0.25
    log("serving_int8_close", greedy_requests=len(greedy), identical=same,
        argmax_positions=exact, positions=total,
        argmax_share=exact / max(total, 1), worst_margin=worst, ok=ok)
    if not ok:
        raise AssertionError(f"int8 serving: repeat identical {same}, "
                             f"argmax {exact}/{total}, worst margin {worst}")
    del engine, engine2
    # the bf16 pool and weights at the same point of the process, beside
    # the int8 path, so that the two differ only in the path
    profile_decode_steps(model, phase="serving_int8_profile_bf16_beside")
    profile_decode_steps(model, phase="serving_int8_profile", **INT8_SERVING)
    host_ab(model)
    del model
    torch.cuda.empty_cache()
    cli_check(("--kv-dtype", "int8", "--quant-weights"))


# -- phase 11 -----------------------------------------------------------------
#
# K5 (dQ) and K6 (dK, dV) against the plain backward, element by element,
# with K7's limit (the note above phase 3): both recompute p and ds from f32
# logits and round them at the same points, and K5 sums dQ in registers
# where K7 adds it with atomicAdd, which changes only f32 roundings. At the
# long-context shape (B=1, H=12, H_kv=4, S=32,768, D=64, bf16, causal) the
# whole plain version does not fit (one (H, S, S) f32 tensor is 51.5 GB),
# but slices of it do, since the plain backward takes the kernels' own O
# and logsumexp: dQ of a block of 64 rows needs only those rows against
# every key (kv_offset = the block's first row), and dK/dV of a tile of 64
# keys only the rows from the tile's first on against those keys. So K5's
# dQ is held to the limit on the first, a middle and the last row block,
# and K6's dK/dV on the first key tile (the longest sum, all 32,768 rows),
# a middle and the last. K5 + K6 against K7 (relative L2 per gradient) is
# then a sanity reading within one bf16 unit, 2^-8. In bf16 all three run on
# the tensor cores. K6 is K7's body without the dQ products, so its dK and
# dV equal K7's bit for bit. K5 rounds p and ds at the same points as K7,
# but from p = exp2(fma(S, scale log2(e), -lse log2(e))) where K7 takes
# exp2((S scale - lse) log2(e)), and sums dQ over 128-key tiles where K7
# adds 64-key pieces into dq_acc in an order that changes from run to run;
# so a rounding of ds may land one bf16 unit apart. Read (NVIDIA H100 80GB
# HBM3, 700 W): dQ 1.9e-4, dK 0, dV 0.
LONG_SEQ = 32768
SPLIT_SEQ = 4096
LLAMA_ATTN = dict(b=1, h=12, hkv=4, d=64)   # llama_small's attention
LONG_TILE = 64                              # rows / keys of one plain slice
LONG_VS_K7_REL_L2 = 2.0 ** -8


def live_pairs(args):
    """Live (query, key) pairs of an unmasked call, from its shapes."""
    import torch

    q, k = args["q"], args["k"]
    b, h, sq, _ = q.shape
    skv = k.shape[2]
    if args["mask"] is not None:
        raise ValueError("live_pairs counts unmasked calls")
    if not args["causal"]:
        return b * h * sq * skv
    rows = args["kv_offset"] + 1 + torch.arange(sq, dtype=torch.int64)
    return b * h * int(rows.clamp(0, skv).sum())


def split_work(args):
    """{kernel: (bytes, operations)} of K4, K5, K6 and K7 on these unmasked
    inputs. Bytes: K4 reads q, k, v and writes O and the f32 logsumexp;
    the backward kernels read q, k, v, O, dO and the logsumexp, then write
    dQ (K5), dK and dV (K6) or all three (K7), each once. Operations: 2 D
    per product per live pair; K4 takes two products (S, PV), K5 three (S,
    dP, dQ), K6 four (S, dP, dV, dK), K7 five."""
    q, k = args["q"], args["k"]
    elem = q.element_size()
    qo, kv = q.numel() * elem, k.numel() * elem
    rows = 4 * q.shape[0] * q.shape[1] * q.shape[2]
    reads = 3 * qo + 2 * kv + rows
    per_product = 2 * q.shape[-1] * live_pairs(args)
    return {"flash_attention_fwd_long": (2 * qo + 2 * kv + rows,
                                         2 * per_product),
            "flash_attention_bwd_dq": (reads + qo, 3 * per_product),
            "flash_attention_bwd_dkv": (reads + 2 * kv, 4 * per_product),
            "flash_attention_bwd_long": (reads + qo + 2 * kv,
                                         5 * per_product)}


def _rel_l2(got, ref):
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


def split_check(name, args):
    """One case: K4, then K5, K6 and K7 once each, K5 and K6 held against
    the plain backward; returns ({gradient: (max |err|, share of the limit
    used)}, {gradient: relative L2 of K5/K6 to the plain version},
    {gradient: the same for K7})."""
    import torch

    from tnn_tpu_torch.ops import flash_attention as fa

    q, k, v, do = args["q"], args["k"], args["v"], args["do"]
    kw = dict(causal=args["causal"], mask=args["mask"],
              kv_offset=args["kv_offset"])
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    before = (fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    dq = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, o, lse, do, **kw)
    fused = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    if (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) != (before[0] + 1,
                                                    before[1] + 1):
        raise AssertionError(f"flash_split {name}: a kernel did not launch")
    dtype = str(q.dtype).split(".")[-1]
    refs = fa.flash_attention_backward_reference(q, k, v, o, lse, do, **kw)
    mags = backward_magnitudes(q, k, v, o, lse, do, **kw)
    errs, split_l2, fused_l2 = {}, {}, {}
    for gname, got, f, r, mag in zip(("dq", "dk", "dv"), (dq, dk, dv), fused,
                                     refs, mags):
        errs[gname] = _limit_used(got, r, mag, dtype)
        split_l2[gname], fused_l2[gname] = _rel_l2(got, r), _rel_l2(f, r)
    del refs, mags
    dead = torch.isinf(lse)
    dead_nonzero = dq[dead].float().abs().max().item() if dead.any() else 0.0
    worst = max(u for _, u in errs.values())
    ok = math.isfinite(worst) and worst <= 1.0 and dead_nonzero == 0.0
    log("flash_split", case=name, dtype=dtype, shape=list(q.shape),
        kv_heads=k.shape[1], skv=k.shape[2], causal=args["causal"],
        kv_offset=args["kv_offset"],
        mask_groups=None if args["mask"] is None else args["mask"].shape[0],
        **{f"{n}_max_abs_err": e for n, (e, _) in errs.items()},
        **{f"{n}_limit_used": u for n, (_, u) in errs.items()},
        split_rel_l2=split_l2, fused_rel_l2=fused_l2,
        dead_rows=int(dead.sum()), dead_rows_max=dead_nonzero, ok=ok)
    if not ok:
        raise AssertionError(f"flash_split {name}: kernel vs plain outside "
                             f"the stated limit ({errs}, dead rows "
                             f"{dead_nonzero})")
    return errs, split_l2, fused_l2


def long_plain_slices(args, o, lse, dq, dk, dv):
    """K5's dQ on the first, a middle and the last block of 64 rows, and
    K6's dK/dV on the first, a middle and the last tile of 64 keys, of an
    unmasked causal call at S=32,768, each against the plain backward of
    its slice (see the note above LONG_SEQ); returns ({check: max |err|},
    {check: share of the limit used})."""
    from tnn_tpu_torch.ops import flash_attention as fa

    q, k, v, do = args["q"], args["k"], args["v"], args["do"]
    s, t = q.shape[2], LONG_TILE
    dtype = str(q.dtype).split(".")[-1]
    errs, used = {}, {}
    for r in (0, s // 2, s - t):
        rows = slice(r, r + t)
        sl = [x[:, :, rows] for x in (q, o, lse, do)]
        kw = dict(causal=True, mask=None, kv_offset=r)
        ref = fa.flash_attention_backward_reference(sl[0], k, v, sl[1],
                                                    sl[2], sl[3], **kw)[0]
        mag = backward_magnitudes(sl[0], k, v, sl[1], sl[2], sl[3], **kw)[0]
        errs[f"dq_rows_{r}"], used[f"dq_rows_{r}"] = _limit_used(
            dq[:, :, rows], ref, mag, dtype)
    for c in (0, s // 2, s - t):
        rows, keys = slice(c, s), slice(c, c + t)
        sl = [x[:, :, rows] for x in (q, o, lse, do)]
        sk, sv = k[:, :, keys], v[:, :, keys]
        refs = fa.flash_attention_backward_reference(
            sl[0], sk, sv, sl[1], sl[2], sl[3], causal=True)
        mags = backward_magnitudes(sl[0], sk, sv, sl[1], sl[2], sl[3],
                                   causal=True, mask=None, kv_offset=0)
        for name, got, ref, mag in (("dk", dk, refs[1], mags[1]),
                                    ("dv", dv, refs[2], mags[2])):
            key = f"{name}_keys_{c}"
            errs[key], used[key] = _limit_used(got[:, :, keys], ref, mag,
                                               dtype)
        del refs, mags
    return errs, used


def mask_past_2_31():
    """K4, K5, K6 and K7 under a grouped mask of 4 x 2^30 bytes (B=4, H=1,
    S=32,768, causal, bf16), whose last group starts past 2^31 and whose
    last rows end near 2^32: the last 64 rows of the last batch (O, lse
    and dQ) and its last 64 keys (dK, dV, which only those rows see)
    against the plain version of that slice (kv_offset S - 64), one row
    fully masked."""
    import torch

    from tnn_tpu_torch.ops import flash_attention as fa

    s, t = LONG_SEQ, 64
    args = flash_case(11, b=4, h=1, hkv=1, sq=s, skv=s, d=64,
                      dtype=torch.bfloat16, causal=True)
    mask = torch.ones((4, s, s), dtype=torch.int8, device="cuda")
    mask[3, :, 5::7] = 0
    mask[3, s - 10] = 0                        # a row with no live key
    q, k, v, do = args["q"], args["k"], args["v"], args["do"]
    kw = dict(causal=True, mask=mask, kv_offset=0)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    dq = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, o, lse, do, **kw)
    fused = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    rows = slice(s - t, s)
    sq_, so, sdo = (x[3:, :, rows].contiguous() for x in (q, o, do))
    slse = lse[3:, :, rows].contiguous()
    skw = dict(causal=True, mask=mask[3:, rows].contiguous(),
               kv_offset=s - t)
    sk, sv = k[3:], v[3:]
    ref_o, ref_lse = fa.flash_attention_reference(sq_, sk, sv, **skw)
    mag_o = fa.flash_attention_reference(sq_, sk, sv.abs(), **skw)[0].float()
    refs = fa.flash_attention_backward_reference(sq_, sk, sv, so, slse, sdo,
                                                 **skw)
    mags = backward_magnitudes(sq_, sk, sv, so, slse, sdo, **skw)
    keys = slice(s - t, s)
    used = {"o": _limit_used(o[3:, :, rows], ref_o, mag_o, "bfloat16")[1]}
    for name, got, ref, mag in (
            ("dq", dq[3:, :, rows], refs[0], mags[0]),
            ("dq_k7", fused[0][3:, :, rows], refs[0], mags[0]),
            ("dk", dk[3:, :, keys], refs[1][:, :, keys], mags[1][:, :, keys]),
            ("dk_k7", fused[1][3:, :, keys], refs[1][:, :, keys],
             mags[1][:, :, keys]),
            ("dv", dv[3:, :, keys], refs[2][:, :, keys], mags[2][:, :, keys]),
            ("dv_k7", fused[2][3:, :, keys], refs[2][:, :, keys],
             mags[2][:, :, keys])):
        used[name] = _limit_used(got, ref, mag, "bfloat16")[1]
    dead = torch.isinf(lse[3, 0])
    dead_ok = (bool(dead[s - 10]) and int(dead.sum()) == 1
               and torch.equal(torch.isinf(slse), torch.isinf(ref_lse))
               and o[3, 0, s - 10].abs().max().item() == 0.0
               and dq[3, 0, s - 10].abs().max().item() == 0.0)
    worst = max(used.values())
    ok = math.isfinite(worst) and worst <= 1.0 and dead_ok
    log("flash_split_mask_2_32", mask_bytes=mask.numel(),
        last_group_offset=3 * s * s, limit_used=used, dead_row_ok=dead_ok,
        ok=ok)
    if not ok:
        raise AssertionError(f"mask past 2^31: {used}, dead row {dead_ok}")


def phase_flash_split(results):
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from tnn_tpu_torch.ops import flash_attention as fa

    bf16 = torch.bfloat16
    cases = flash_cases()
    cases["llama_s4096_bf16"] = dict(LLAMA_ATTN, sq=SPLIT_SEQ, skv=SPLIT_SEQ,
                                     dtype=bf16, causal=True)
    worst_dq = worst_dkv = 0.0
    for i, (name, spec) in enumerate(cases.items()):
        args = flash_case(500 + i, **spec)
        errs, split_l2, fused_l2 = split_check(name, args)
        worst_dq = max(worst_dq, errs["dq"][0])
        worst_dkv = max(worst_dkv, errs["dk"][0], errs["dv"][0])
        del args
        torch.cuda.empty_cache()
    # the long-context shape: K5 and K6 against plain slices, K5 repeated,
    # and K5 + K6 against K7 as a sanity reading
    long = flash_case(9, **LLAMA_ATTN, sq=LONG_SEQ, skv=LONG_SEQ, dtype=bf16,
                      causal=True)
    q, k, v, do = long["q"], long["k"], long["v"], long["do"]
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    dq = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, causal=True)
    dq2 = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, causal=True)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, o, lse, do, causal=True)
    fused = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    same = bool(torch.equal(dq, dq2))
    l2 = {n: _rel_l2(a, f) for n, a, f in zip(("dq", "dk", "dv"),
                                              (dq, dk, dv), fused)}
    finite = all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv))
    del dq2, fused
    slice_errs, slice_used = long_plain_slices(long, o, lse, dq, dk, dv)
    worst_dq = max([worst_dq] + [e for n, e in slice_errs.items()
                                 if n.startswith("dq")])
    worst_dkv = max([worst_dkv] + [e for n, e in slice_errs.items()
                                   if not n.startswith("dq")])
    worst_used = max(slice_used.values())
    ok = (same and finite and math.isfinite(worst_used) and worst_used <= 1.0
          and all(l2[n] <= LONG_VS_K7_REL_L2 for n in l2))
    log("flash_split_long", shape=list(q.shape), kv_heads=k.shape[1],
        plain_slices_max_abs_err=slice_errs,
        plain_slices_limit_used=slice_used,
        split_vs_fused_rel_l2=l2, split_vs_fused_limit=LONG_VS_K7_REL_L2,
        readings_at_4096={"split": split_l2, "fused": fused_l2},
        dq_bit_identical=same, finite=finite, ok=ok)
    if not ok:
        raise AssertionError(f"K5 + K6 at S={LONG_SEQ}: plain slices "
                             f"{slice_used}, vs K7 {l2} (limit "
                             f"{LONG_VS_K7_REL_L2}), repeat identical {same}")
    mask_past_2_31()
    torch.cuda.empty_cache()

    # times at the long-context shape; the plain backward at S=4096 (the
    # plain version of both K5 and K6), SDPA's backward at S=32,768 (all
    # three gradients in one call, the library's nearest function)
    small = flash_case(10, **LLAMA_ATTN, sq=SPLIT_SEQ, skv=SPLIT_SEQ,
                       dtype=bf16, causal=True)
    so, slse = fa.flash_attention_fwd(small["q"], small["k"], small["v"],
                                      causal=True)
    plain = (small["q"], small["k"], small["v"], so, slse, small["do"])
    lq, lk, lv = (x.detach().requires_grad_() for x in (q, k, v))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        lib_out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                                 enable_gqa=True)

    def sdpa_fwd():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)

    fns = {
        "flash_attention_fwd_long": lambda: fa.flash_attention_fwd(
            q, k, v, causal=True),
        "plain_fwd": lambda: fa.flash_attention_reference(
            small["q"], small["k"], small["v"], causal=True),
        "library_fwd": sdpa_fwd,
        "flash_attention_bwd_dq": lambda: fa.flash_attention_bwd_dq(
            q, k, v, o, lse, do, causal=True),
        "flash_attention_bwd_dkv": lambda: fa.flash_attention_bwd_dkv(
            q, k, v, o, lse, do, causal=True),
        "flash_attention_bwd_long": lambda: fa.flash_attention_bwd(
            q, k, v, o, lse, do, causal=True),
        "plain": lambda: fa.flash_attention_backward_reference(
            *plain, causal=True),
        "library": lambda: torch.autograd.grad(lib_out, (lq, lk, lv), do,
                                               retain_graph=True)}
    times, per_names = {}, {}
    bodies = {"flash_attention_bwd_dq": "k5", "flash_attention_bwd_dkv": "k6",
              "flash_attention_bwd_long": "k7"}
    for name, fn in fns.items():
        device, events, per_names[name] = time_ms(fn, iters=3, warmup=1)
        times[name] = (events if device is None else device, events)
    worst = {"flash_attention_bwd_dq": worst_dq,
             "flash_attention_bwd_dkv": worst_dkv}
    for name, (nbytes, ops) in split_work(long).items():
        byte_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        op_ms = 1e3 * ops / PEAK_OPS["bfloat16"]
        ref = "_fwd" if name.endswith("fwd_long") else ""
        timed = dict(ms=times[name][0], events_ms=times[name][1],
                     plain_ms=times["plain" + ref][0],
                     plain_events_ms=times["plain" + ref][1],
                     library_ms=times["library" + ref][0],
                     library_events_ms=times["library" + ref][1],
                     bound_ms=max(byte_ms, op_ms), bytes=nbytes, ops=ops,
                     bound_by="bytes" if byte_ms >= op_ms else "operations",
                     seq=LONG_SEQ, plain_seq=SPLIT_SEQ)
        if name in bodies:
            timed["split_ms"] = bwd_parts(per_names[name], bodies[name])
            timed["kernels"] = sorted(map(kernel_label, per_names[name]))
        log("flash_split_time", kernel=name, case="llama_s32768_bf16",
            **timed)
        if name in worst:     # K4 and K7 at this shape are logged only
            results[name] = dict(timed, max_abs_err=worst[name])
    # the pair against the two other ways to the same three gradients
    split = (times["flash_attention_bwd_dq"][0]
             + times["flash_attention_bwd_dkv"][0])
    log("flash_split_vs_fused", case="llama_s32768_bf16", k5_ms=times[
        "flash_attention_bwd_dq"][0], k6_ms=times[
            "flash_attention_bwd_dkv"][0], k5_k6_ms=split,
        k7_ms=times["flash_attention_bwd_long"][0],
        sdpa_bwd_ms=times["library"][0],
        k5_k6_over_k7=split / times["flash_attention_bwd_long"][0],
        k5_k6_over_sdpa=split / times["library"][0])
    # comparison launches do not count
    for wrapper in (fa.flash_attention_fwd, fa.flash_attention_bwd,
                    fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
        wrapper.launches = 0
    del long, small, plain, q, k, v, do, o, lse, dq, dk, dv, lq, lk, lv
    del lib_out
    torch.cuda.empty_cache()


# -- phase 12 -----------------------------------------------------------------

LONG_TRAIN_STEPS = 6   # 2 warm-up, 3 timed, 1 profiled
LONG_EVAL_STEPS = 2


def llama_flops_per_step(model, batch, seq):
    """6 x (weights in matmuls, the tied head included: per layer the qkv
    projection d (d + 2 kv_d), the output d^2 and the SwiGLU 3 d hidden;
    V d) per token, plus causal attention 6 L S d per token (QK and PV over
    S/2 keys on average, forward and the backward's twice as much)."""
    d, kv_d = model.d_model, model.num_kv_heads * (
        model.d_model // model.num_heads)
    per_layer = d * (d + 2 * kv_d) + d * d + 3 * d * model.mlp_hidden
    n = model.num_layers * per_layer + model.vocab_size * d
    return (6 * n + 6 * model.num_layers * seq * d) * batch * seq


def phase_training_long(results):
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from tnn_tpu_torch.data.token_stream import TokenStreamDataLoader
    from tnn_tpu_torch.models import zoo
    from tnn_tpu_torch.nn.optimizers import AdamW
    from tnn_tpu_torch.nn.schedulers import WarmupCosineAnnealing
    from tnn_tpu_torch.ops import flash_attention as fa
    from tnn_tpu_torch.train import (create_train_state, make_eval_step,
                                     make_train_step)

    t0 = time.perf_counter()
    model = zoo.create("flash_llama_small", max_len=LONG_SEQ, device="cuda",
                       seed=0)
    init_s = time.perf_counter() - t0
    steps, evals = LONG_TRAIN_STEPS, LONG_EVAL_STEPS
    # the CLI's optimizer and schedule
    opt = AdamW(lr=3e-4, weight_decay=0.01, grad_clip_norm=1.0)
    sched = WarmupCosineAnnealing(warmup=max(10, steps // 20), t_max=steps)
    state = create_train_state(model, opt, seed=0)
    rec = StepRecorder(timed=range(2, steps - 1),
                       profiled=range(steps - 1, steps))
    step = rec.wrap(make_train_step)(model, opt, scheduler=sched)
    ev = make_eval_step(model, compute_accuracy=False)
    with tempfile.TemporaryDirectory() as tmp:
        synthetic_corpus(Path(tmp), vocab=model.vocab_size)
        train = TokenStreamDataLoader(str(Path(tmp) / "train.bin"), LONG_SEQ)
        val = TokenStreamDataLoader(str(Path(tmp) / "val.bin"), LONG_SEQ)
        rng = np.random.default_rng(0)

        def batch(loader):
            d, l = loader.random_windows(1, rng)
            return (torch.from_numpy(d).cuda().long(),
                    torch.from_numpy(l).cuda().long())

        counters = (fa.flash_attention_fwd, fa.flash_attention_bwd,
                    fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step(state, *batch(train))
        val_losses = [float(ev(state, *batch(val))["loss"])
                      for _ in range(evals)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fwd, bwd, dq, dkv = (c.launches for c in counters)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in rec.losses]
    layers = model.num_layers
    want = (layers * (steps + evals), 0, layers * steps, layers * steps)
    finite = all(math.isfinite(x) for x in losses + val_losses)
    falling = losses[-1] < losses[0]
    ok = finite and falling and (fwd, bwd, dq, dkv) == want
    log("training_long", model="flash_llama_small", batch=1, seq=LONG_SEQ,
        layers=layers, d_model=model.d_model, heads=model.num_heads,
        kv_heads=model.num_kv_heads, mlp_hidden=model.mlp_hidden,
        vocab=model.vocab_size, policy=model.policy.compute,
        init_s=init_s, steps=steps, losses=losses, val_losses=val_losses,
        k4_launches=fwd, k7_launches=bwd, k5_launches=dq, k6_launches=dkv,
        expected_launches=list(want), wall_s=wall, ok=ok)
    if not ok:
        raise AssertionError(
            f"long training: finite {finite}, falling {falling}, launches "
            f"K4/K7/K5/K6 {(fwd, bwd, dq, dkv)} vs {want}")
    results["split_launches"] = {"flash_attention_bwd_dq": dq,
                                 "flash_attention_bwd_dkv": dkv}
    step_ms = rec.step_ms()
    kernels = rec.device_ms()
    busy = sum(kernels.values())
    flops = llama_flops_per_step(model, 1, LONG_SEQ)
    # which bodies ran: the profiled step's flash kernels by name; in bf16
    # K4, K5 and K6 take the tensor-core bodies and nothing else
    flash_bodies = [n for n in rec.kernel_labels() if n.startswith("flash_")]
    ran = {k: any(n.split("<")[0] == body for n in flash_bodies)
           for k, body in (("K4", "flash_fwd_wgmma_kernel"),
                           ("K5", "flash_bwd_dq_wgmma_kernel"),
                           ("K6", "flash_bwd_wgmma_kernel"))}
    simt = [n for n in flash_bodies if n.split("<")[0] in (
        "flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_kernel")]
    log("training_long_profile", steps_timed=len(rec.timed), step_ms=step_ms,
        tokens_per_s=LONG_SEQ / step_ms * 1e3, peak_mem_gb=peak,
        model_flops_per_step=flops,
        flops_formula="B*S*(6*(L*(d*(d+2*kv_d) + d^2 + 3*d*hidden) + V*d)"
                      " + 6*L*S*d)",
        mfu=flops / (step_ms * 1e-3 * PEAK_BF16), device_busy_ms=busy,
        idle_share=1.0 - busy / step_ms,
        flash_kernels_ms={n: t for n, t in kernels.items() if "flash" in n},
        flash_bodies=flash_bodies, tensor_core_bodies_ran=ran,
        top_kernels_ms=sorted(kernels.items(), key=lambda kv: -kv[1])[:10])
    if not all(ran.values()) or simt:
        raise AssertionError(f"long training's flash kernels {flash_bodies}: "
                             f"tensor-core bodies {ran}, SIMT bodies {simt}")
    del model, state, step, ev
    torch.cuda.empty_cache()


# -- phase 13 -----------------------------------------------------------------
#
# K8 against its plain version. Both compute in f32 at the same rounding
# points, so they differ by summation order (LayerNorm's statistics, the
# attention sums): about 1e-7 relative. Where such a difference meets a tie
# of a rounding (a re-quantized activation's x / sx near k + 1/2, or a bf16
# cache row), one value moves to its other neighbour, and every later
# re-quantization of the stack can amplify that: over 12 layers one moved
# bf16 row ended 88 code steps away in one case of 48 (NVIDIA H100 80GB
# HBM3 at 700 W). So the stack is held against the plain
# version layer by layer:
#   * the L-layer launch equals the chain of L one-layer launches (f32
#     between them, the residual's own type) bit for bit;
#   * each one-layer launch, on the chain's input, against the plain
#     version on the same input and caches: per element
#       |k8 - plain| <= 1e-5 max|plain| + DECODE_FLIP_STEPS * U,
#     U the largest code step (``code_steps``: one int8 step of the input
#     times the largest weight it meets) of the matmuls that write the
#     residual (out, proj); on row t of the caches the same with U of qkv,
#     plus one unit of the cache dtype's rounding (2^-8 |plain| in bf16).
#     Within one layer a moved code still spreads through LN2, fc, GELU
#     and proj: the same run read at most 7.8 code steps in a layer, in 9
#     of its 576 layers; the limit is twice that, and at most
#     DECODE_MOVED_LAYERS of a case's 12 layers may leave the float term.
DECODE_T = 1024
DECODE_FLIP_STEPS = 16
DECODE_MOVED_LAYERS = 4


def decode_stack_inputs(model, *, batch, t, dtype, seed):
    """Seeded caches (N(0, 0.5^2), the scale of this model's k and v) and x
    from the model's own embedding of random tokens at position t."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (model.num_layers, batch, DECODE_T, model.d_model)
    kc = (torch.randn(shape, generator=gen, device="cuda") * 0.5).to(dtype)
    vc = (torch.randn(shape, generator=gen, device="cuda") * 0.5).to(dtype)
    tok = torch.randint(0, model.vocab_size, (batch, 1), generator=gen,
                        device="cuda")
    with torch.inference_mode():
        x = model.wpe(model.wte(tok), offset=t)[:, 0].to(dtype).contiguous()
    return x, kc, vc


def decode_stack_bytes(model, batch, t, itemsize):
    """Bytes K8 must move: every int8 weight (12 D^2 a layer at F = 4D)
    and f32 vector (22 D) once, cache rows 0..t of K and V (row t is the
    write), x in and x_out."""
    d, f, n_layers = model.d_model, 4 * model.d_model, model.num_layers
    weights = n_layers * (4 * d * d + 2 * f * d + 4 * (14 * d + 2 * f))
    return (weights + n_layers * 2 * batch * (t + 1) * d * itemsize
            + 2 * batch * d * itemsize)


def decode_stack_case(stacks, heads, x, t, kc, vc, chunks):
    """One case: the L-layer launch, its repeat, the chain of one-layer
    launches and each layer against the plain version. Returns the
    reading."""
    import torch

    from tnn_tpu_torch.ops import decode_stack as ds

    n_layers = kc.shape[0]
    k0, v0 = kc.clone(), vc.clone()
    before = ds.fused_decode_stack.launches
    out, kc, vc = ds.fused_decode_stack(x, t, kc, vc, stacks,
                                        num_heads=heads, chunks=chunks)
    torch.cuda.synchronize()
    launched = ds.fused_decode_stack.launches - before
    others = all(torch.equal(a[:, :, :t], b[:, :, :t])
                 and torch.equal(a[:, :, t + 1:], b[:, :, t + 1:])
                 for a, b in ((kc, k0), (vc, v0)))
    k2, v2 = k0.clone(), v0.clone()
    again, k2, v2 = ds.fused_decode_stack(x, t, k2, v2, stacks,
                                          num_heads=heads, chunks=chunks)
    repeat = (torch.equal(again, out) and torch.equal(k2, kc)
              and torch.equal(v2, vc))
    cast = 2 ** -8 if kc.dtype == torch.bfloat16 else 0.0
    h = x.float()
    kch, vch = k0.clone(), v0.clone()
    used = row_used = err = row_err = code_steps = 0.0
    layers_past_float = 0
    for layer in range(n_layers):
        one = {k: v[layer:layer + 1] for k, v in stacks.items()}
        kr, vr = k0[layer:layer + 1].clone(), v0[layer:layer + 1].clone()
        steps = {}
        ref, kr, vr = ds.fused_decode_stack_reference(
            h, t, kr, vr, one, num_heads=heads, chunks=chunks,
            code_steps=steps)
        h, _, _ = ds.fused_decode_stack(h, t, kch[layer:layer + 1],
                                        vch[layer:layer + 1], one,
                                        num_heads=heads, chunks=chunks)
        diff = (h - ref).abs()
        floor = 1e-5 * ref.abs().max()
        u_res = max(steps["out"] + steps["proj"])
        used = max(used, (diff / (floor + DECODE_FLIP_STEPS * u_res))
                   .max().item())
        code_steps = max(code_steps, ((diff - floor) / u_res).max().item())
        err = max(err, diff.max().item())
        layers_past_float += bool((diff > floor).any())
        for got, want in ((kch, kr), (vch, vr)):
            g, w = got[layer, :, t].float(), want[0, :, t].float()
            e = (g - w).abs()
            lim = 1e-5 * w.abs().max() + cast * w.abs() \
                + DECODE_FLIP_STEPS * max(steps["qkv"])
            row_err = max(row_err, e.max().item())
            row_used = max(row_used, (e / lim).max().item())
    torch.cuda.synchronize()
    chain = (torch.equal(h.to(out.dtype), out) and torch.equal(kch, kc)
             and torch.equal(vch, vc))
    ok = (launched == 1 and bool(torch.isfinite(out).all()) and others
          and repeat and chain and used <= 1.0 and row_used <= 1.0
          and layers_past_float <= DECODE_MOVED_LAYERS)
    return dict(max_abs_err=err, limit_used=used, code_steps=code_steps,
                row_t_err=row_err,
                row_t_limit_used=row_used,
                layers_past_float=layers_past_float, chain_bit_for_bit=chain,
                other_rows_same=others, repeat_bit_for_bit=repeat, ok=ok)


def phase_decode_stack(results):
    import torch

    from tnn_tpu_torch.models import fused_decode, zoo
    from tnn_tpu_torch.nn.quant import quantize_for_decode
    from tnn_tpu_torch.ops import decode_stack as ds

    model = quantize_for_decode(zoo.create("gpt2_small", device="cuda",
                                           seed=0))
    stacks = fused_decode.stack_decode_weights(model)
    heads = model.num_heads
    failures = []
    worst = 0.0
    ncase = 0
    for batch in (1, 2):
        picked = fused_decode.pick_chunks(model.d_model, 4 * model.d_model,
                                          batch, DECODE_T)
        for dtype in (torch.bfloat16, torch.float32):
            for t in (0, DECODE_T // 2 - 1, DECODE_T - 1):
                for chunks in sorted({picked, 1, 2, 4, 8} - {None}):
                    ncase += 1
                    x, kc, vc = decode_stack_inputs(
                        model, batch=batch, t=t, dtype=dtype,
                        seed=1000 + ncase)
                    reading = decode_stack_case(stacks, heads, x, t, kc, vc,
                                                chunks)
                    log("decode_stack", case=ncase, batch=batch,
                        dtype=str(dtype).split(".")[-1], t=t, chunks=chunks,
                        picked=chunks == picked, **reading)
                    worst = max(worst, reading["max_abs_err"],
                                reading["row_t_err"])
                    if not reading["ok"]:
                        failures.append(ncase)
                    del x, kc, vc
    if failures:
        raise AssertionError(f"decode_stack cases failed: {failures}")

    # times at the shape of the JSON line: B = 1, t = T - 1, bf16, the
    # reference's chunk count; beside them the unfused w8a8 blocks of the
    # same quantized model (GPTBlock.apply_cached: no single PyTorch call
    # computes the stack)
    batch, t, dtype = 1, DECODE_T - 1, torch.bfloat16
    chunks = fused_decode.pick_chunks(model.d_model, 4 * model.d_model,
                                      batch, DECODE_T)
    x, kc, vc = decode_stack_inputs(model, batch=batch, t=t, dtype=dtype,
                                    seed=7)
    dh = model.d_model // heads
    caches = [{"k": kc[i].view(batch, DECODE_T, heads, dh).transpose(1, 2),
               "v": vc[i].view(batch, DECODE_T, heads, dh).transpose(1, 2)}
              for i in range(model.num_layers)]

    def unfused():
        with torch.inference_mode():
            h = x[:, None]
            for blk, cache in zip(model.blocks, caches):
                h, _ = blk.apply_cached(h, cache, t)
        return h

    entry = {"batch": batch, "t": t, "dtype": "bfloat16", "chunks": chunks,
             "max_abs_err": worst}
    runs = {"": lambda: ds.fused_decode_stack(
                x, t, kc, vc, stacks, num_heads=heads, chunks=chunks),
            "plain_": lambda: ds.fused_decode_stack_reference(
                x, t, kc, vc, stacks, num_heads=heads, chunks=chunks),
            "unfused_": unfused}
    for prefix, fn in runs.items():
        device, events, _ = time_ms(fn, iters=20, warmup=3)
        entry[prefix + "ms"] = events if device is None else device
        entry[prefix + "events_ms"] = events
    # the same launch at t = 0, where attention reads one row: the rest of
    # the step (weights, row passes, grid syncs), at each chunk count: each
    # chunk adds two grid syncs a layer and two matmul phases
    entry["t0_ms_by_chunks"] = {
        c: time_ms(lambda c=c: ds.fused_decode_stack(
            x, 0, kc, vc, stacks, num_heads=heads, chunks=c),
            iters=20, warmup=3)[0]
        for c in (1, 2, 4, 8)}
    nbytes = decode_stack_bytes(model, batch, t, 2)
    d, n_layers = model.d_model, model.num_layers
    int8_ops = n_layers * 2 * batch * 12 * d * d
    f32_ops = n_layers * 4 * batch * (t + 1) * d
    byte_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    op_ms = 1e3 * (int8_ops / PEAK_OPS["int8"] + f32_ops / PEAK_OPS["float32"])
    entry.update(bound_ms=max(byte_ms, op_ms), bytes=nbytes,
                 int8_ops=int8_ops, f32_ops=f32_ops,
                 bound_by="bytes" if byte_ms >= op_ms else "operations",
                 library_ms=None, grid_syncs=n_layers * (3 + 2 * chunks) - 1)
    log("decode_stack_time", **entry)
    results["fused_decode_stack"] = entry
    ds.fused_decode_stack.launches = 0   # comparison launches do not count
    del model, stacks, caches, x, kc, vc
    torch.cuda.empty_cache()


# -- phase 14 -----------------------------------------------------------------

PROMPT = "The meaning of life is"
GENERATE_TOKENS = 64


def generate_cli(flags):
    """``cli.gpt2_inference`` on full-width gpt2_small; returns its
    tokens/s line's numbers and the generated ids it prints."""
    proc = subprocess.run(
        [sys.executable, "-m", "tnn_tpu_torch.cli.gpt2_inference", "-n",
         str(GENERATE_TOKENS), *flags], capture_output=True, text=True,
        timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"gpt2_inference {flags} failed: rc "
                             f"{proc.returncode}\n{proc.stderr[-4000:]}")
    last = proc.stdout.strip().splitlines()[-1]       # "N tokens in X ms"
    words = last.split()
    ids = [ln for ln in proc.stdout.splitlines()
           if ln.startswith("generated ids:")][0]
    return {"tokens": int(words[0]), "ms": float(words[3]),
            "tok_per_s": float(words[5].strip("(")), "ids": ids}


def teacher_forced(model, stream, plen, chunks=None):
    """Per-step logits over a fixed token stream: the unfused int8 step
    (``apply_cached``) when ``chunks`` is None, else K8 (fused_generate's
    body)."""
    import torch

    from tnn_tpu_torch.models import fused_decode
    from tnn_tpu_torch.ops.decode_stack import fused_decode_stack

    caches = model.init_cache(1, stream.shape[1])
    out = []
    with torch.inference_mode():
        out.append(model.apply_cached(stream[:, :plen], caches, 0)[:, -1])
        if chunks is not None:
            stacks = fused_decode.decode_stacks(model)
            kc, vc = fused_decode.caches_to_stacked(caches)
        for pos in range(plen, stream.shape[1] - 1):
            tok = stream[:, pos:pos + 1]
            if chunks is None:
                out.append(model.apply_cached(tok, caches, pos)[:, -1])
                continue
            x = model.wpe(model.wte(tok), offset=pos)[:, 0].contiguous()
            x_out, kc, vc = fused_decode_stack(
                x, pos, kc, vc, stacks, num_heads=model.num_heads,
                chunks=chunks)
            out.append(model._head(x_out[:, None, :])[:, -1])
    return torch.stack(out, dim=1)[0].float()


def per_token_profile(fn, tokens):
    """Kernels and outermost aten ops per generated token of ``fn()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = ops = 0
    busy = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels += 1
            busy += e.time_range.elapsed_us()
            continue
        parent = e.cpu_parent
        ops += e.name.startswith("aten::") and not (
            parent is not None and parent.name.startswith("aten::"))
    return {"kernels_per_token": kernels / tokens,
            "aten_ops_per_token": ops / tokens,
            "busy_ms_per_token": busy / 1e3 / tokens,
            "profiled_ms_per_token": wall * 1e3 / tokens}


def phase_fused_generate(results):
    import numpy as np
    import torch

    from tnn_tpu_torch.models import fused_decode, zoo
    from tnn_tpu_torch.models.gpt2 import generate
    from tnn_tpu_torch.nn.quant import quantize_for_decode
    from tnn_tpu_torch.ops import decode_stack as ds

    fused_cli = generate_cli(["--fused"])
    int8_cli = generate_cli(["--int8"])
    model = quantize_for_decode(zoo.create("gpt2_small", device="cuda",
                                           seed=0))
    prompt = torch.from_numpy(np.frombuffer(PROMPT.encode(), np.uint8)
                              .astype(np.int64))[None].to(model.device)
    plen = prompt.shape[1]
    fused_decode.fused_generate(model, prompt, 4)                # warm-up
    torch.cuda.synchronize()
    ds.fused_decode_stack.launches = 0
    t0 = time.perf_counter()
    toks = fused_decode.fused_generate(model, prompt, GENERATE_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ds.fused_decode_stack.launches
    again = fused_decode.fused_generate(model, prompt, GENERATE_TOKENS)
    chunks = fused_decode.pick_chunks(model.d_model, 4 * model.d_model, 1,
                                      plen + GENERATE_TOKENS)
    # fused against unfused int8, teacher-forced over the fused stream:
    # JAX's bound for its kernel (tests/test_fused_decode.py:62-63)
    stream = torch.cat([prompt, toks], dim=1)
    fused = teacher_forced(model, stream, plen, chunks)
    unfused = teacher_forced(model, stream, plen)
    rel = ((fused - unfused).abs().amax(dim=-1)
           / unfused.abs().amax(dim=-1)).max().item()
    agree = (fused.argmax(-1) == unfused.argmax(-1)).float().mean().item()
    n_prof = 16
    prof = {"fused": per_token_profile(
                lambda: fused_decode.fused_generate(model, prompt, n_prof),
                n_prof),
            "int8_unfused": per_token_profile(
                lambda: generate(model, prompt, n_prof), n_prof)}
    in_vocab = bool(((toks >= 0) & (toks < model.vocab_size)).all())
    ok = (launches == GENERATE_TOKENS - 1 and in_vocab
          and tuple(toks.shape) == (1, GENERATE_TOKENS)
          and torch.equal(toks, again) and rel < 0.05
          and fused_cli["tokens"] == int8_cli["tokens"] == GENERATE_TOKENS)
    log("fused_generate", prompt_tokens=plen, new_tokens=GENERATE_TOKENS,
        chunks=chunks, k8_launches=launches,
        expected_launches=GENERATE_TOKENS - 1, wall_ms=wall * 1e3,
        tok_per_s=GENERATE_TOKENS / wall, repeat_identical=torch.equal(
            toks, again), teacher_forced_rel=rel,
        teacher_forced_argmax_agree=agree, cli_fused=fused_cli,
        cli_int8=int8_cli, profile=prof, ok=ok)
    if not ok:
        raise AssertionError("fused_generate failed its checks")
    results["fused_generate_launches"] = launches
    del model
    torch.cuda.empty_cache()


# -- phase 15 -----------------------------------------------------------------

FUSED_SERVING = dict(quant_weights=True, decode_path="fused",
                     max_batch_size=2, num_blocks=512, block_size=16,
                     chunk_size=256)


def fused_traffic(model, seed):
    """4 requests of 128-token prompts, admitted in pairs (equal lengths:
    every decode step lockstep), then 2 of 150 and 200 tokens (ragged
    offsets: standard decode steps, and 256-token chunks whose 512-row
    mixed steps take K3); 64 greedy tokens each. Returns (engine, rids)."""
    import numpy as np

    from tnn_tpu_torch.serving.engine import InferenceEngine

    engine = InferenceEngine(model, seed=seed, device=model.device,
                             **FUSED_SERVING)
    rng = np.random.default_rng(seed)
    rids = [engine.submit(rng.integers(0, model.vocab_size, n), 64)
            for n in (128, 128, 128, 128, 150, 200)]
    engine.run_until_complete()
    return engine, rids


def phase_serving_fused(results):
    import torch

    from tnn_tpu_torch.models import zoo
    from tnn_tpu_torch.ops import decode_stack as ds
    from tnn_tpu_torch.ops import paged_attention as pa
    from tnn_tpu_torch.ops import quant_matmul as qm
    from tnn_tpu_torch.ops.quant_matmul import W8A8_MAX_ROWS
    from tnn_tpu_torch.serving.engine import InferenceEngine
    from tnn_tpu_torch.serving.scheduler import RequestState

    model = zoo.create("gpt2_small", device="cuda", seed=0)
    fused_traffic(model, seed=1)                                 # warm-up
    real = InferenceEngine._mixed_standard
    wide = [0]

    def mixed_standard(self, toks, *a):
        wide[0] += toks.numel() > W8A8_MAX_ROWS
        return real(self, toks, *a)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ds.fused_decode_stack.launches = 0
    pa.paged_attention.launches = pa.paged_attention.int8_launches = 0
    qm.int8_matmul.launches = 0
    InferenceEngine._mixed_standard = mixed_standard
    t0 = time.perf_counter()
    try:
        engine, rids = fused_traffic(model, seed=0)
    finally:
        InferenceEngine._mixed_standard = real
    wall = time.perf_counter() - t0
    k8, k3 = ds.fused_decode_stack.launches, qm.int8_matmul.launches
    k1, k2 = pa.paged_attention.launches, pa.paged_attention.int8_launches
    stats = engine.stats()
    steps = stats["program_steps"]
    bad = [r for r in rids if engine.result(r).state
           is not RequestState.FINISHED
           or len(engine.result(r).out_tokens) != 64]
    want_k3 = 4 * model.num_layers * wide[0]
    exact, total, worst = closeness_gate(model, engine, rids)
    ok = (not bad and k8 == steps.get("fdecode", 0) > 0
          and steps.get("decode", 0) > 0 and k1 == k2 == 0
          and k3 == want_k3 and wide[0] > 0
          and stats["decode_path"] == "fused"
          and exact >= 0.75 * total and worst < 0.25)
    log("serving_fused", requests=len(rids), finished=len(rids) - len(bad),
        chunks=engine._fused["chunks"], assembly_len=engine.assembly_len,
        program_steps=steps, k8_launches=k8, wide_steps=wide[0],
        k3_launches=k3, expected_k3=want_k3, k1_launches=k1,
        k2_launches=k2, wall_s=wall, ttft_ms_p50=stats["ttft_ms_p50"],
        ttft_ms_p95=stats["ttft_ms_p95"],
        decode_tok_per_s=stats["tok_per_s"],
        step_ms_mean=stats["step_latency_ms_mean"], steps=stats["steps"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
        argmax_positions=exact, positions=total, worst_margin=worst, ok=ok)
    if not ok:
        raise AssertionError(f"fused serving failed its checks: {bad}")
    results["fused_launches"] = k8
    engine.check_invariants()
    del engine
    # steady decode at two rows: the fused path, the paged path on the same
    # int8 weights, and the int8 pool's paged path
    profile_decode_steps(model, phase="serving_fused_profile", batch=2,
                         **{k: FUSED_SERVING[k] for k in
                            ("quant_weights", "decode_path")})
    profile_decode_steps(model, phase="serving_fused_profile_paged_beside",
                         batch=2, quant_weights=True)
    profile_decode_steps(model, phase="serving_fused_profile_int8_beside",
                         batch=2, **INT8_SERVING)
    del model
    torch.cuda.empty_cache()
    proc = cli_check(("--quant-weights", "--decode-path", "fused",
                      "--max-batch-size", "2"))
    summary = json.loads(proc.stderr.split("serve summary: ")[1])
    if summary["decode_path"] != "fused":
        raise AssertionError(f"CLI summary: {summary}")


# -- phase 16 -----------------------------------------------------------------
#
# K1s (the paged kernels with return_stats) against the plain stats version
# (``paged_attention_reference(..., return_stats=True)``), element by
# element. out: K1's and K2's limits above (both normalize once, at the
# end). m: both take the max of the same f32 scores summed in another order,
# each within a few ulps of sum_d |q_d k_d| scale (about 7 at Dh 128 and
# N(0, 1) inputs: 1e-6), so |m - m_ref| <= 1e-5 (1 + |m_ref|). l =
# sum_j exp(s_j - m) moves by the error of s_j - m (2e-5 relative at most)
# and one rounding per page rescale (at most 63 pages: 4e-6), so |l - l_ref|
# <= 1e-4 l_ref. A row with no live key (kv_len 0, a padding token, every
# block a -1 hole) must read exactly (0, -1e30, 0), and only those rows.
#
# The merge check splits each row's blocks round-robin over 2 and over 4
# tables (-1 where another table holds the block, as the SP pool's local
# tables), runs K1s on each and combines the partials with
# ``softmax_merge.merge_shards``, against unsharded K1 (K2 over int8
# pages). Each side lies within K1's limit of the exact value, so the two
# lie within twice it: (1e-4, 2^-6) in bf16, (2e-5, 2e-5) in f32.
STATS_M_TOL = 1e-5
STATS_L_TOL = 1e-4
MERGE_TOLERANCE = {"float32": (2e-5, 2e-5), "bfloat16": (1e-4, 2 ** -6)}


def stats_cases():
    """{name: (int8 pages, paged_case spec, row made all -1 holes)}: both
    page types, bf16 and f32, decode (3-D q) and ragged chunks of up to 16
    tokens, Dh 64 and 128, block sizes 4 to 32, GQA, holes, a kv_len-0
    row, padding tokens and a q_len-0 row."""
    import torch

    decode_kv = [0, 17, 512, 1, 333, 499, 64, 510]
    ragged_q = [16, 16, 9, 16, 1, 1, 3, 0]
    ragged_kv = [16, 448, 980, 704, 513, 100, 3, 40]
    cases = {}
    for quant in (False, True):
        kind = "int8" if quant else "pages"
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[-1]
            for bs in (4, 16, 32):
                mha = dict(heads=12, kv_heads=12, head_dim=64, block_size=bs,
                           dtype=dtype, holes=True)
                cases[f"{kind}_decode_{dn}_bs{bs}"] = (quant, dict(
                    decode_form=True, q_lens=[1] * 8, kv_lens=decode_kv,
                    **mha), 3)
                cases[f"{kind}_ragged_{dn}_bs{bs}"] = (quant, dict(
                    decode_form=False, q_lens=ragged_q, kv_lens=ragged_kv,
                    **mha), 5)
            cases[f"{kind}_ragged_gqa4_{dn}"] = (quant, dict(
                decode_form=False, q_lens=ragged_q, kv_lens=ragged_kv,
                heads=12, kv_heads=4, head_dim=64, block_size=16,
                dtype=dtype, holes=True), 5)
            cases[f"{kind}_decode_hd128_{dn}"] = (quant, dict(
                decode_form=True, q_lens=[1] * 8, kv_lens=decode_kv,
                heads=6, kv_heads=6, head_dim=128, block_size=8, dtype=dtype,
                holes=True), 3)
            cases[f"{kind}_ragged_hd128_{dn}"] = (quant, dict(
                decode_form=False, q_lens=ragged_q, kv_lens=ragged_kv,
                heads=6, kv_heads=6, head_dim=128, block_size=32,
                dtype=dtype), None)
    return cases


def split_tables(tables, n):
    """Round-robin split of block tables over ``n`` shards: shard s keeps
    positions j % n == s, -1 elsewhere."""
    import torch

    pos = torch.arange(tables.shape[1], device=tables.device)
    return [torch.where(pos % n == s, tables, -1).contiguous()
            for s in range(n)]


def stats_check(name, quant, spec, args):
    """One K1s case against the plain stats version, then the 2- and
    4-way merge against unsharded K1 / K2. Returns the reading."""
    import torch

    from tnn_tpu_torch.ops import paged_attention as pa
    from tnn_tpu_torch.ops.softmax_merge import merge_shards

    counter = "int8_stats_launches" if quant else "stats_launches"
    before = getattr(pa.paged_attention, counter)
    out, m, l = pa.paged_attention(**args, return_stats=True)  # noqa: E741
    torch.cuda.synchronize()
    if getattr(pa.paged_attention, counter) != before + 1:
        raise AssertionError(f"stats {name}: K1s did not launch")
    ref, m_ref, l_ref = pa.paged_attention_reference(**args,
                                                     return_stats=True)
    v = args["pages_v"]
    abs_v = pa.QuantPages(v.data.abs(), v.scale) if quant else v.abs()
    ref_abs_v = pa.paged_attention_reference(
        **{**args, "pages_v": abs_v}).float()
    dt = str(spec["dtype"]).split(".")[-1]
    ref = ref.float()
    diff = (out.float() - ref).abs()
    if quant:
        atol, rtol = INT8_TOLERANCE[dt]
        limit = atol + rtol * ref.abs() + 1e-5 * ref_abs_v
    else:
        atol, rtol = TOLERANCE[dt]
        limit = atol + rtol * (ref.abs() + ref_abs_v)
    out_used = (diff / limit).max().item()
    dead = l_ref == 0
    live = ~dead
    m_used = ((m - m_ref).abs()[live]
              / (STATS_M_TOL * (1 + m_ref.abs()[live]))).max().item()
    l_used = ((l - l_ref).abs()[live]
              / (STATS_L_TOL * l_ref[live])).max().item()
    dead_exact = bool((m[dead] == -1e30).all() and (l[dead] == 0).all()
                      and (out.float()[dead.expand_as(out)] == 0).all()
                      and (l[live] > 0).all())
    # the merge over round-robin shards against the unsharded kernel
    base = pa.paged_attention(**args).float()
    matol, mrtol = MERGE_TOLERANCE[dt]
    merge_used = {}
    for n in (2, 4):
        parts = [pa.paged_attention(**{**args, "block_tables": t},
                                    return_stats=True)
                 for t in split_tables(args["block_tables"], n)]
        merged = merge_shards(*zip(*parts)).float()
        mlimit = matol + mrtol * (base.abs() + ref_abs_v)
        merge_used[n] = ((merged - base).abs() / mlimit).max().item()
    used = [out_used, m_used, l_used, *merge_used.values()]
    ok = all(math.isfinite(u) and u <= 1.0 for u in used) and dead_exact \
        and int(dead.sum()) > 0
    reading = dict(case=name, max_abs_err=diff.max().item(),
                   out_limit_used=out_used,
                   m_max_abs_err=(m - m_ref).abs()[live].max().item(),
                   m_limit_used=m_used,
                   l_max_rel_err=((l - l_ref).abs()[live]
                                  / l_ref[live]).max().item(),
                   l_limit_used=l_used, dead_rows=int(dead.sum()),
                   dead_exact=dead_exact, merge2_limit_used=merge_used[2],
                   merge4_limit_used=merge_used[4], ok=ok)
    log("paged_stats", **reading)
    if not ok:
        raise AssertionError(f"paged_attention stats {name} failed: "
                             f"{reading}")
    return reading


def phase_paged_stats(results):
    import torch
    import torch.nn.functional as F

    from tnn_tpu_torch.ops import paged_attention as pa

    worst = {False: 0.0, True: 0.0}
    for i, (name, (quant, spec, hole_row)) in enumerate(
            stats_cases().items()):
        make = quant_case if quant else paged_case
        args = make(500 + i, batch=8, **spec)
        if hole_row is not None:   # a live row whose blocks are all holes
            args["block_tables"][hole_row] = -1
        reading = stats_check(name, quant, spec, args)
        worst[quant] = max(worst[quant], reading["max_abs_err"])

    # time at the serving decode shape (gpt2_small heads, 8 rows, kv 500,
    # bf16): K1s beside K1 (K2 over int8 pages) in one call
    shape = dict(decode_form=True, q_lens=[1] * 8, kv_lens=[500] * 8,
                 heads=12, kv_heads=12, head_dim=64, block_size=16,
                 dtype=torch.bfloat16)
    for quant, key in ((False, "paged_attention_stats"),
                       (True, "paged_attention_int8_stats")):
        args = (quant_case if quant else paged_case)(7, batch=8, **shape)
        nbytes, ops = paged_work(args)
        q = args["q"]
        nbytes += 2 * 4 * q.shape[0] * q.shape[-2]   # m and l, f32
        bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                             ops / PEAK_OPS["bfloat16"])
        sq, sk, sv, smask, gqa = sdpa_inputs(dequant_args(args) if quant
                                             else args)
        runs = {"": lambda: pa.paged_attention(**args, return_stats=True),
                "nostats_": lambda: pa.paged_attention(**args),
                "plain_": lambda: pa.paged_attention_reference(
                    **args, return_stats=True),
                "library_": lambda: F.scaled_dot_product_attention(
                    sq, sk, sv, attn_mask=smask, enable_gqa=gqa)}
        timed = {}
        for prefix, fn in runs.items():
            device, events, _ = time_ms(fn)
            timed[prefix + "ms"] = events if device is None else device
            timed[prefix + "events_ms"] = events
        timed.update(bound_ms=bound_ms, bytes=nbytes, ops=ops,
                     bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                     >= ops / PEAK_OPS["bfloat16"] else "operations")
        log("paged_stats_time", kernel=key, **timed)
        results[key] = dict(max_abs_err=worst[quant], **timed)
    # comparison launches do not count
    pa.paged_attention.launches = pa.paged_attention.int8_launches = 0
    pa.paged_attention.stats_launches = 0
    pa.paged_attention.int8_stats_launches = 0


# -- phase 17 -----------------------------------------------------------------
#
# Sequence-parallel serving of full-width gpt2_small at sp = 2, both shards
# on the one card (sp_devices cuda:0 twice: every SP code path, K1s
# included, without a second card). Limits:
# * teacher-forced mixed-step logits, sp = 2 against sp = 1 on the same KV
#   (a ragged step of prompt chunks and decode rows): under FP32 the only
#   difference is the reassociated softmax, about an ulp a layer, so 1e-4
#   of max|logit| (the FP32 kernel-vs-plain bound of phase 4); in bf16 each
#   shard rounds its partial output to bf16 before the merge, as K1 rounds
#   its own, so the kernel-vs-plain bf16 bound, 3e-2 of max|logit|;
# * greedy streams: identical to sp = 1's, or differing first at a token
#   where either engine's top-2 logit gap is below the near-tie bound: 1e-3,
#   or twice the largest bf16 logit difference the teacher-forced check
#   read, where that is larger (a flip needs the gap below the difference).
SP_DEVICES = ["cuda:0", "cuda:0"]
SP_LOGIT_TOL = {"fp32": 1e-4, "bf16": 3e-2}
NEAR_TIE = 1e-3


def gap_engine_class():
    """An InferenceEngine that keeps, per request, every emitted token's
    top-2 logit gap (the engine's own logits)."""
    from tnn_tpu_torch.serving.engine import InferenceEngine

    class GapEngine(InferenceEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.gaps = {}

        def _build(self, chunks, events):
            rec = super()._build(chunks, events)
            if rec is not None:
                self._rows = [r.rid for r in rec.get("rows",
                                                     rec.get("live"))]
            return rec

        def _sample(self, logits, step):
            top2 = logits.float().topk(2, dim=-1).values
            self._gap = (top2[:, 0] - top2[:, 1]).cpu()
            return super()._sample(logits, step)

        def step(self):
            events = super().step()
            for rid, _ in events["tokens"]:
                self.gaps.setdefault(rid, []).append(
                    float(self._gap[self._rows.index(rid)]))
            return events

    return GapEngine


def streams_agree(eng_a, rids_a, eng_b, rids_b, tie):
    """Greedy streams of two engines: (equal streams, near-tie
    divergences); raises on a divergence at a token whose gap is >= tie in
    both engines."""
    equal = flips = 0
    for ra, rb in zip(rids_a, rids_b):
        a, b = eng_a.result(ra).out_tokens, eng_b.result(rb).out_tokens
        if a == b:
            equal += 1
            continue
        i = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        gap = min(eng_a.gaps[ra][i], eng_b.gaps[rb][i])
        if gap >= tie:
            raise AssertionError(f"greedy streams differ at token {i} with "
                                 f"top-2 gap {gap} >= {tie}: {a} vs {b}")
        flips += 1
    return equal, flips


def sp_logits_check(model, seed, tol, kv_dtype="f32"):
    """One ragged mixed step through the SP adapter over two shards of a
    pool, then through the model over the same KV laid out as one pool
    (the shards' pages side by side: global id = shard * N_l + local row).
    Returns the max |logit difference| over live positions; fails past
    ``tol`` of the largest logit."""
    import numpy as np
    import torch

    from tnn_tpu_torch.ops import paged_attention as pa
    from tnn_tpu_torch.serving import step_build
    from tnn_tpu_torch.serving.kv_pool import PagedKVPool
    from tnn_tpu_torch.serving.sp import SPContext

    dev = model.device
    bs, b, qw = 16, 8, 64
    starts = np.array([0, 0, 130, 700, 37, 512, 959, 3], np.int32)
    q_lens = np.array([64, 17, 64, 40, 1, 1, 1, 0], np.int32)
    ctx = SPContext(model, 2, devices=SP_DEVICES)
    pool = PagedKVPool(model.num_layers, model.num_kv_heads,
                       model.d_model // model.num_heads, 1200, bs,
                       model.policy.compute_dtype, dev, kv_dtype=kv_dtype,
                       sp=2, devices=ctx.devices)
    nb = pool.blocks_for(model.max_len)
    tables = np.zeros((b, nb), np.int32)
    for i in range(b):
        blocks = pool.alloc(pool.blocks_for(starts[i] + q_lens[i]))
        tables[i, :len(blocks)] = blocks
    gen = torch.Generator(device=dev).manual_seed(seed)
    for pages in pool.pages_k + pool.pages_v:   # the rows' earlier KV
        if kv_dtype == "int8":
            data, scale = pa.quantize_kv_rows(torch.randn(
                pages.data.shape, generator=gen, device=dev))
            pages.data.copy_(data)
            pages.scale.copy_(scale)
        else:
            pages.copy_(torch.randn(pages.shape, generator=gen, device=dev))

    def joined(side):   # the shards' pages as one (L, N, ...) pool
        if kv_dtype == "int8":
            return pa.QuantPages(torch.cat([p.data for p in side], 1),
                                 torch.cat([p.scale for p in side], 1))
        return torch.cat(side, 1)

    one_k, one_v = joined(pool.pages_k), joined(pool.pages_v)
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, model.vocab_size, (b, qw),
                                         dtype=np.int32)).to(dev)
    put = [torch.from_numpy(x).to(dev) for x in (tables, starts, q_lens)]
    local = [torch.from_numpy(t).to(dev) for t in step_build.shard_tables(
        tables, 2, pool.blocks_per_shard)]
    with torch.inference_mode():
        counts = (pa.paged_attention.stats_launches,
                  pa.paged_attention.int8_stats_launches)
        sharded = ctx.model.apply_paged(toks, pool.pages_k, pool.pages_v,
                                        local, put[1], put[2])
        after = (pa.paged_attention.stats_launches,
                 pa.paged_attention.int8_stats_launches)
        single = model.apply_paged(toks, one_k, one_v, *put)
    want = 2 * model.num_layers
    if sum(after) - sum(counts) != want:
        raise AssertionError(f"SP mixed step launched K1s "
                             f"{sum(after) - sum(counts)} times, want {want}")
    live = torch.arange(qw, device=dev)[None, :] < put[2][:, None]
    diff = (sharded - single).abs()[live].max().item()
    scale = single[live].abs().max().item()
    ok = math.isfinite(diff) and diff <= tol * scale
    log("serving_sp_logits", policy=model.policy.compute, kv_dtype=kv_dtype,
        max_abs_err=diff, max_abs_logit=scale, tolerance=tol * scale, ok=ok)
    if not ok:
        raise AssertionError(f"SP mixed-step logits against sp=1: {diff} > "
                             f"{tol * scale}")
    return diff


def sp_traffic(model, seed, num_requests=8, new_tokens=64, **engine_kw):
    """``serve_traffic`` on the gap-recording engine."""
    import numpy as np

    engine = gap_engine_class()(model, num_blocks=512, block_size=16,
                                max_batch_size=8, chunk_size=64, seed=seed,
                                device=model.device, **engine_kw)
    rng = np.random.default_rng(seed)
    rids = []
    for i in range(num_requests):
        prompt = rng.integers(0, model.vocab_size, int(rng.integers(16, 769)))
        sampled = i % 2 == 1
        rids.append(engine.submit(
            prompt, new_tokens, temperature=0.8 if sampled else 0.0,
            top_k=50 if sampled else 0, top_p=0.95 if sampled else 0.0))
    engine.run_until_complete()
    return engine, rids


def pool_shard_bytes(pool):
    """Bytes of one shard's K and V pages (and scales)."""
    from tnn_tpu_torch.ops.paged_attention import QuantPages

    total = 0
    for p in pool.shard_pages()[0]:
        for t in (p if isinstance(p, QuantPages) else (p,)):
            total += t.numel() * t.element_size()
    return total


def sp_run(model, tie, label, **kw):
    """sp = 1 then sp = 2 over the serving traffic; launch counts of the
    sp = 2 run (counts set to 0 just before it, read just after), its
    streams against sp = 1's. Returns the sp = 2 launch counts."""
    import torch

    from tnn_tpu_torch.ops import paged_attention as pa
    from tnn_tpu_torch.serving.scheduler import RequestState

    eng1, rids1 = sp_traffic(model, seed=0, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.paged_attention.launches = pa.paged_attention.int8_launches = 0
    pa.paged_attention.stats_launches = 0
    pa.paged_attention.int8_stats_launches = 0
    t0 = time.perf_counter()
    eng2, rids2 = sp_traffic(model, seed=0, sp=2, sp_devices=SP_DEVICES,
                             **kw)
    wall = time.perf_counter() - t0
    counts = {"k1": pa.paged_attention.launches,
              "k2": pa.paged_attention.int8_launches,
              "k1s": pa.paged_attention.stats_launches,
              "k1s_int8": pa.paged_attention.int8_stats_launches}
    stats = eng2.stats()
    paged_steps = sum(stats["program_steps"].get(k, 0)
                      for k in ("mixed", "pdecode"))
    quant = kw.get("kv_dtype") == "int8"
    want = {"k1": 0, "k2": 0,
            "k1s": 0 if quant else 2 * model.num_layers * paged_steps,
            "k1s_int8": 2 * model.num_layers * paged_steps if quant else 0}
    bad = [r for r in rids2 if eng2.result(r).state
           is not RequestState.FINISHED
           or len(eng2.result(r).out_tokens) != 64]
    greedy = [i for i in range(len(rids2)) if i % 2 == 0]
    equal, flips = streams_agree(eng1, [rids1[i] for i in greedy], eng2,
                                 [rids2[i] for i in greedy], tie)
    ok = (not bad and counts == want and paged_steps > 0
          and stats["sp_degree"] == 2
          and stats["pool_blocks_per_shard"] == 256)
    log("serving_sp", run=label, requests=len(rids2),
        finished=len(rids2) - len(bad), model_steps=eng2.model_steps,
        program_steps=stats["program_steps"], launches=counts,
        expected=want, greedy_equal=equal, greedy_near_tie_flips=flips,
        near_tie=tie, wall_s=wall, ttft_ms_p50=stats["ttft_ms_p50"],
        ttft_ms_p95=stats["ttft_ms_p95"],
        decode_tok_per_s=stats["tok_per_s"],
        step_ms_mean=stats["step_latency_ms_mean"],
        sp1_step_ms_mean=eng1.stats()["step_latency_ms_mean"],
        preemptions=stats["preemptions"],
        pool_bytes_per_shard=pool_shard_bytes(eng2.pool),
        pool_bytes_sp1=pool_shard_bytes(eng1.pool),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30, ok=ok)
    if not ok:
        raise AssertionError(f"SP serving {label}: launches {counts} (want "
                             f"{want}), unfinished {bad}, stats {stats}")
    eng2.check_invariants()
    return counts


def phase_serving_sp(results):
    import numpy as np
    import torch

    from tnn_tpu_torch.core import dtypes as dt
    from tnn_tpu_torch.models import zoo
    from tnn_tpu_torch.ops import paged_attention as pa
    from tnn_tpu_torch.serving.engine import InferenceEngine

    fp32 = zoo.create("gpt2_small", device="cuda", seed=0, policy=dt.FP32)
    sp_logits_check(fp32, seed=4, tol=SP_LOGIT_TOL["fp32"])
    del fp32
    torch.cuda.empty_cache()
    model = zoo.create("gpt2_small", device="cuda", seed=0)
    worst = max(sp_logits_check(model, seed=3, tol=SP_LOGIT_TOL["bf16"]),
                sp_logits_check(model, seed=5, tol=SP_LOGIT_TOL["bf16"],
                                kv_dtype="int8"))
    tie = max(NEAR_TIE, 2 * worst)
    sp_traffic(model, seed=1, num_requests=2, new_tokens=4, sp=2,
               sp_devices=SP_DEVICES)                            # warm-up

    # (a) the capability gate: a 900-token prompt on one shard's footprint
    # (32 blocks of 16) is refused at sp = 1 and serves at sp = 2 on 64
    rng = np.random.default_rng(11)
    long_prompt = rng.integers(0, model.vocab_size, 900)
    gate = dict(block_size=16, max_batch_size=8, chunk_size=64,
                device=model.device)
    refused = ""
    try:
        InferenceEngine(model, num_blocks=32, **gate).submit(long_prompt, 16)
    except ValueError as e:
        refused = str(e)
    gap_engine = gap_engine_class()
    eng_sp = gap_engine(model, num_blocks=64, sp=2, sp_devices=SP_DEVICES,
                        **gate)
    eng_ref = gap_engine(model, num_blocks=512, **gate)
    rid_sp, rid_ref = (e.submit(long_prompt, 16) for e in (eng_sp, eng_ref))
    for e in (eng_sp, eng_ref):
        e.run_until_complete()
    equal, flips = streams_agree(eng_ref, [rid_ref], eng_sp, [rid_sp], tie)
    ok = ("exceeds" in refused and eng_sp.pool.blocks_per_shard == 32
          and len(eng_sp.result(rid_sp).out_tokens) == 16)
    log("serving_sp_gate", prompt=len(long_prompt), sp1_refusal=refused,
        sp2_blocks_per_shard=eng_sp.pool.blocks_per_shard,
        sp2_max_seq_len=eng_sp.max_seq_len, tokens=len(
            eng_sp.result(rid_sp).out_tokens), equal_to_sp1_big_pool=equal,
        near_tie_flips=flips, ok=ok)
    if not ok:
        raise AssertionError(f"SP capability gate: {refused!r}")
    del eng_sp, eng_ref

    # (b) parity on the bf16 pool, (c) on the int8 pool; greedy streams
    # under FP32 too, where a flip needs a gap below 1e-3
    fp32 = zoo.create("gpt2_small", device="cuda", seed=0, policy=dt.FP32)
    sp_run(fp32, NEAR_TIE, "fp32_model")
    del fp32
    torch.cuda.empty_cache()
    launches = sp_run(model, tie, "bf16_pool")
    launches_int8 = sp_run(model, tie, "int8_pool", kv_dtype="int8")
    results["sp_launches"] = {"stats": launches["k1s"],
                              "int8_stats": launches_int8["k1s_int8"]}

    # (d) a few steps of the standard path at sp = 2
    std = gap_engine_class()
    engines = [std(model, num_blocks=512, block_size=16, max_batch_size=8,
                   chunk_size=64, decode_path="standard",
                   device=model.device, **kw)
               for kw in ({}, dict(sp=2, sp_devices=SP_DEVICES))]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, model.vocab_size, n) for n in (40, 300)]
    before = pa.paged_attention.stats_launches
    rids = [[e.submit(p, 8) for p in prompts] for e in engines]
    for e in engines:
        e.run_until_complete()
    equal, flips = streams_agree(engines[0], rids[0], engines[1], rids[1],
                                 tie)
    steps = engines[1].stats()["program_steps"]
    ok = (engines[1].stats()["decode_path"] == "standard"
          and steps.get("decode", 0) > 0
          and pa.paged_attention.stats_launches == before)
    log("serving_sp_standard", program_steps=steps, greedy_equal=equal,
        near_tie_flips=flips, ok=ok)
    if not ok:
        raise AssertionError(f"SP standard path: {steps}")
    engines[1].check_invariants()
    del engines

    # steady decode at 8 rows, kv 500: sp = 1 and sp = 2 in alternating
    # windows (the host's speed moves within a process), then each path's
    # profile
    sp2 = dict(sp=2, sp_devices=SP_DEVICES)
    host_ab(model, phase="serving_sp_host_ab",
            paths={"sp1": {}, "sp2": sp2})
    profile_decode_steps(model, phase="serving_sp_profile", **sp2)
    profile_decode_steps(model, phase="serving_sp_profile_sp1_beside")
    del model
    torch.cuda.empty_cache()
    cli_check(("--sp", "2", "--sp-devices", ",".join(SP_DEVICES)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        import tnn_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the tnn_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 3
    t_start = time.perf_counter()
    info = phase_device()
    results = {}
    build_kernels()
    for phase in (phase_kernel, phase_flash, phase_flash_split,
                  phase_serving, phase_cli, phase_training,
                  phase_training_long, phase_train_cli, phase_int8_kernel,
                  phase_int8_matmul, phase_serving_int8, phase_decode_stack,
                  phase_fused_generate, phase_serving_fused,
                  phase_paged_stats, phase_serving_sp):
        t0 = time.perf_counter()
        phase(results)
        log("phase_seconds", name=phase.__name__,
            seconds=round(time.perf_counter() - t0, 3))
    log("total_seconds", seconds=round(time.perf_counter() - t_start, 3))
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    flash = "tnn_tpu/ops/pallas/flash_attention.py"
    kernels = [{"name": "paged_attention", "route": "cuda",
                "source": "tnn_tpu_torch/csrc/paged_attention.cu",
                "replaces": "tnn_tpu/ops/pallas/paged_attention.py:203",
                "launches": results["launches"],
                **{k: results["paged_attention"][k] for k in keys}}]
    for name, line in (("flash_attention_fwd", 262),
                       ("flash_attention_bwd", 666)):
        kernels.append({"name": name, "route": "cuda",
                        "source": "tnn_tpu_torch/csrc/flash_attention.cu",
                        "replaces": f"{flash}:{line}",
                        "launches": results["flash_launches"][name],
                        **{k: results[name][k] for k in keys}})
    kernels.append({"name": "paged_attention_int8", "route": "cuda",
                    "source": "tnn_tpu_torch/csrc/paged_attention.cu",
                    "replaces": "tnn_tpu/ops/pallas/paged_attention.py:115",
                    "launches": results["int8_launches"]["k2"],
                    **{k: results["paged_attention_int8"][k] for k in keys}})
    kernels.append({"name": "int8_matmul", "route": "cuda",
                    "source": "tnn_tpu_torch/csrc/quant_matmul.cu",
                    "replaces": "tnn_tpu/ops/pallas/quant_matmul.py:152",
                    "launches": results["int8_launches"]["k3"],
                    **{k: results["int8_matmul"][k] for k in keys}})
    for name, line in (("flash_attention_bwd_dq", 578),
                       ("flash_attention_bwd_dkv", 618)):
        kernels.append({"name": name, "route": "cuda",
                        "source": "tnn_tpu_torch/csrc/flash_attention.cu",
                        "replaces": f"{flash}:{line}",
                        "launches": results["split_launches"][name],
                        **{k: results[name][k] for k in keys}})
    kernels.append({"name": "fused_decode_stack", "route": "cuda",
                    "source": "tnn_tpu_torch/csrc/decode_stack.cu",
                    "replaces": "tnn_tpu/ops/pallas/decode_stack.py:173",
                    "launches": results["fused_launches"],
                    **{k: results["fused_decode_stack"][k] for k in keys}})
    for name, launches in (("paged_attention_stats", "stats"),
                           ("paged_attention_int8_stats", "int8_stats")):
        kernels.append({"name": name, "route": "cuda",
                        "source": "tnn_tpu_torch/csrc/paged_attention.cu",
                        "replaces": "tnn_tpu/ops/pallas/paged_attention.py:203",
                        "launches": results["sp_launches"][launches],
                        **{k: results[name][k] for k in keys}})
    print(info["nvidia_smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
