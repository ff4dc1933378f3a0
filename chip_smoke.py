#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``tnn_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository checkout around this file.
It builds every kernel of the port's serving path from ``tnn_tpu_torch/csrc``
and runs these phases, each printing its numbers on its own line:

1. device: the card's name, the device count and its power limit;
2. kernel: each kernel against its plain PyTorch version at the shapes of
   ``gpt2_small`` serving, with the tolerance stated, and its time beside
   the plain version's, a library call's and the card's bound;
3. serving: ``InferenceEngine`` serving full-width ``gpt2_small`` (seeded
   random weights) through the paged path, with every kernel's launch count
   read over that run;
4. cli: ``python -m tnn_tpu_torch.cli.serve`` on two JSON lines.

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
    """Time of one ``fn()`` call, two ways: (device, events). ``device`` is
    the summed duration of the CUDA kernels ``torch.profiler`` records over
    ``iters`` calls, divided by ``iters``: the card's own time, without the
    host overhead between launches (None where the profiler records no
    device activity). ``events`` is CUDA-event time over ``iters`` calls
    after warm-up, which includes any host gap between them."""
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
    kernels = [e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device = sum(kernels) / iters / 1e3 if kernels else None
    return device, events


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
    position (below the row's kv_len, in no -1 hole) read once, each live
    query token read and its output written once, the table entries the
    rows use and the lengths read once. Operations: the QK and PV products
    of every live query token with every live key it attends."""
    import numpy as np

    q, pk = args["q"], args["pages_k"]
    elem = q.element_size()
    _, _, hkv, bs, dh = pk.shape
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
    nbytes = (live_kv * 2 * hkv * dh * elem + live_q * 2 * h * dh * elem
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

    from tnn_tpu_torch.ops import runtime
    from tnn_tpu_torch.ops.paged_attention import (paged_attention,
                                                   paged_attention_reference)

    t0 = time.perf_counter()
    lib = runtime.build("paged_attention")
    log("build", seconds=round(time.perf_counter() - t0, 3),
        library=str(lib))

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
            device, events = time_ms(fn)
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


def serve_traffic(model, seed, num_requests=16, new_tokens=64):
    """One engine run over the smoke traffic; returns (engine, rids)."""
    import numpy as np

    from tnn_tpu_torch.serving.engine import InferenceEngine

    engine = InferenceEngine(model, num_blocks=512, block_size=16,
                             max_batch_size=8, chunk_size=64, seed=seed,
                             device=model.device)
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


def profile_decode_steps(model, steps=10):
    """Steady decode steps of 8 rows: wall time per step without the
    profiler, then device-busy time per step (summed kernel durations) and
    the kernels that take the most device time from a profiler window over
    as many further steps. Idle share = 1 - busy / unprofiled step time:
    the profiler slows the host, so its own window's wall time is printed
    but not used."""
    import collections

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tnn_tpu_torch.serving.engine import InferenceEngine

    engine = InferenceEngine(model, num_blocks=512, block_size=16,
                             max_batch_size=8, chunk_size=64, seed=0,
                             device=model.device)
    rng = np.random.default_rng(5)
    for _ in range(8):
        engine.submit(rng.integers(0, model.vocab_size, 500), 2 * steps + 8)
    while any(r.cache_len < r.prefill_len or not r.out_tokens
              for r in engine.requests.values()):
        engine.step()
    engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name[:60]] += e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3 / steps
    log("serving_profile", decode_rows=8, kv_len=500, step_ms=step_ms,
        profiled_step_ms=profiled_ms, device_busy_ms=busy_ms,
        idle_share=1.0 - busy_ms / step_ms,
        top_kernels_ms=[(n, t / 1e3 / steps)
                        for n, t in by_name.most_common(6)])


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


# -- phase 4 ------------------------------------------------------------------

def phase_cli():
    lines = [{"id": "greedy", "tokens": [464, 3616, 286, 1204, 318],
              "max_new_tokens": 8},
             {"id": "sampled", "tokens": list(range(100, 140)),
              "max_new_tokens": 6, "temperature": 0.8, "top_k": 50,
              "top_p": 0.95}]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tnn_tpu_torch.cli.serve", "--model",
         "gpt2_small"], input="".join(json.dumps(x) + "\n" for x in lines),
        capture_output=True, text=True, timeout=600)
    events = [json.loads(x) for x in proc.stdout.splitlines() if x.strip()]
    done = {e["id"]: e for e in events if e.get("event") == "done"}
    ok = (proc.returncode == 0 and set(done) == {"greedy", "sampled"}
          and len(done["greedy"]["tokens"]) == 8
          and len(done["sampled"]["tokens"]) == 6)
    log("cli", returncode=proc.returncode, done_events=len(done),
        token_events=sum(e.get("event") == "token" for e in events),
        seconds=round(time.perf_counter() - t0, 3), ok=ok)
    if not ok:
        raise AssertionError(f"CLI run failed: rc {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")


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
    info = phase_device()
    results = {}
    phase_kernel(results)
    phase_serving(results)
    phase_cli()
    kernels = [{"name": "paged_attention", "route": "cuda",
                "source": "tnn_tpu_torch/csrc/paged_attention.cu",
                "replaces": "tnn_tpu/ops/pallas/paged_attention.py:203",
                "launches": results["launches"],
                **{k: results["paged_attention"][k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}}]
    print(info["nvidia_smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
