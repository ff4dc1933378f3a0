"""K8 (the fused decode stack) of two source trees, timed like for like on
one card.

    python scripts/torch_decode_stack_ab.py ROOT_A ROOT_B [--order 0,1,1,0]

Each ROOT is a checkout of this repository (an unpacked ``git archive``
of another commit, or ``.``). For each entry of ``--order`` one process
imports ``tnn_tpu_torch`` from that root, builds its kernels into a
build directory of its own, and times, on full-width ``gpt2_small`` with
int8 weights and seeded bf16 caches of T = 1024 (``chip_smoke.py``'s
inputs and its ``time_ms``, which sums the profiler's device time):

  * K8 at B = 1, t = 1023, C = 2 (the kernels JSON line's shape) and at
    B = 2 (the fused engine's rows);
  * K8 at t = 0 for each chunk count 1, 2, 4, 8;
  * the unfused w8a8 blocks (``GPTBlock.apply_cached``) at B = 1, t = 1023.

It prints one JSON line per process and the card's name and power limit.
Needs a CUDA card; the measuring code is this script's and this
repository's ``chip_smoke.py``, whatever the root.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(root: str) -> dict:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    cs = _chip_smoke()
    from tnn_tpu_torch.models import fused_decode, zoo
    from tnn_tpu_torch.nn.quant import quantize_for_decode
    from tnn_tpu_torch.ops import decode_stack as ds

    assert Path(ds.__file__).resolve().is_relative_to(Path(root).resolve())
    model = quantize_for_decode(zoo.create("gpt2_small", device="cuda",
                                           seed=0))
    stacks = fused_decode.stack_decode_weights(model)
    heads, t = model.num_heads, cs.DECODE_T - 1
    out = {"root": root}

    def k8(x, kc, vc, tt, chunks):
        return cs.time_ms(lambda: ds.fused_decode_stack(
            x, tt, kc, vc, stacks, num_heads=heads, chunks=chunks),
            iters=50, warmup=5)[0]

    for batch in (1, 2):
        x, kc, vc = cs.decode_stack_inputs(model, batch=batch, t=t,
                                           dtype=torch.bfloat16, seed=7)
        out[f"k8_b{batch}_t{t}_c2_ms"] = k8(x, kc, vc, t, 2)
        if batch == 1:
            out["t0_ms_by_chunks"] = {c: k8(x, kc, vc, 0, c)
                                      for c in (1, 2, 4, 8)}
            dh = model.d_model // heads
            caches = [{"k": kc[i].view(1, cs.DECODE_T, heads, dh)
                       .transpose(1, 2),
                       "v": vc[i].view(1, cs.DECODE_T, heads, dh)
                       .transpose(1, 2)} for i in range(model.num_layers)]

            def unfused():
                with torch.inference_mode():
                    h = x[:, None]
                    for blk, cache in zip(model.blocks, caches):
                        h, _ = blk.apply_cached(h, cache, t)
                return h

            out["unfused_ms"] = cs.time_ms(unfused, iters=20, warmup=3)[0]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--order", default="0,1,1,0")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    for i in (int(k) for k in args.order.split(",")):
        root = args.roots[i]
        env = dict(os.environ, TNN_TORCH_BUILD_DIR=str(
            Path(root).resolve() / "build" / f"ab_kernels_{i}"))
        proc = subprocess.run([sys.executable, __file__, "--measure", root],
                              env=env, capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
