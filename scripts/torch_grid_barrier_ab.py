"""Grid-barrier cost on one card: cooperative groups' ``grid.sync()``
against the hand-rolled barrier of the fused decode stack (K8,
``tnn_tpu_torch/csrc/decode_stack.cu``).

    python scripts/torch_grid_barrier_ab.py [--iters 20000] [--rounds 3]

One cooperative launch of one block per SM, K8's block shape (16 warps
that synchronise, one warp that does not), runs ``iters`` barriers back
to back; CUDA events time the launch, and the script prints microseconds
per barrier for each variant, in alternating rounds:

  * ``cg``: ``cooperative_groups::this_grid().sync()`` (every thread of
    the block takes part, the 17th warp too);
  * ``release_acquire``: K8's barrier (a named barrier of the 16 warps,
    thread 0's ``red.release.gpu`` add on a counter, an ``ld.acquire.gpu``
    spin until the count reaches the barrier's target, a named barrier);
  * ``relaxed_poll``: the same, spinning on ``ld.relaxed.gpu`` with one
    ``fence.acq_rel.gpu`` after the count is reached.

The CUDA source is built with ``nvcc`` (sm_90a) into ``build/`` at the
repository root. Needs the card; prints the card's name and power limit
first.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

constexpr int kWarps = 16, kConsumers = kWarps * 32, kThreads = kConsumers + 32;

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "r"(kConsumers) : "memory");
}

__global__ void __launch_bounds__(kThreads, 1) cg_kernel(int iters) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < iters; ++i) grid.sync();
}

template <bool kRelaxed>
__global__ void __launch_bounds__(kThreads, 1)
    hand_kernel(unsigned* count, int iters) {
  if (threadIdx.x >= kConsumers) return;
  unsigned target = 0;
  for (int i = 0; i < iters; ++i) {
    target += gridDim.x;
    consumer_sync();
    if (threadIdx.x == 0) {
      asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n"
                   :: "l"(count), "r"(1u) : "memory");
      unsigned v = 0;
      do {
        if (kRelaxed)
          asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n"
                       : "=r"(v) : "l"(count) : "memory");
        else
          asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                       : "=r"(v) : "l"(count) : "memory");
      } while (v < target);
      if (kRelaxed) asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    }
    consumer_sync();
  }
}

extern "C" int barrier_ms(int variant, int iters, float* ms) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  unsigned* count = nullptr;
  cudaError_t err = cudaMalloc(&count, sizeof(unsigned));
  if (err != cudaSuccess) return err;
  cudaMemset(count, 0, sizeof(unsigned));
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  void* argv_cg[] = {&iters};
  void* argv_hand[] = {&count, &iters};
  const void* kern =
      variant == 0 ? reinterpret_cast<const void*>(cg_kernel)
      : variant == 1 ? reinterpret_cast<const void*>(hand_kernel<false>)
                     : reinterpret_cast<const void*>(hand_kernel<true>);
  cudaEventRecord(a);
  err = cudaLaunchCooperativeKernel(kern, dim3(sms), dim3(kThreads),
                                    variant == 0 ? argv_cg : argv_hand, 0, 0);
  cudaEventRecord(b);
  if (err == cudaSuccess) err = cudaEventSynchronize(b);
  if (err == cudaSuccess) err = cudaGetLastError();
  cudaEventElapsedTime(ms, a, b);
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  cudaFree(count);
  return err;
}
"""

VARIANTS = ("cg", "release_acquire", "relaxed_poll")


def build() -> ctypes.CDLL:
    sys.path.insert(0, str(ROOT))
    from tnn_tpu_torch.ops import runtime

    out = ROOT / "build" / "grid_barrier_ab"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "grid_barrier_ab.cu"
    src.write_text(SOURCE)
    lib = out / "grid_barrier_ab.so"
    subprocess.run([runtime.find_nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
                    str(src)], check=True)
    dll = ctypes.CDLL(str(lib))
    dll.barrier_ms.argtypes = [ctypes.c_int, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_float)]
    dll.barrier_ms.restype = ctypes.c_int
    return dll


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20000)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    dll = build()
    ms = ctypes.c_float()
    for v in range(len(VARIANTS)):             # warm-up
        if dll.barrier_ms(v, 100, ctypes.byref(ms)) != 0:
            raise RuntimeError(f"{VARIANTS[v]} launch failed")
    us = {name: [] for name in VARIANTS}
    for r in range(args.rounds):
        order = range(len(VARIANTS)) if r % 2 == 0 \
            else reversed(range(len(VARIANTS)))
        for v in order:
            err = dll.barrier_ms(v, args.iters, ctypes.byref(ms))
            if err != 0:
                raise RuntimeError(f"{VARIANTS[v]} failed: CUDA error {err}")
            us[VARIANTS[v]].append(ms.value * 1e3 / args.iters)
    print(json.dumps({"us_per_barrier": us, "iters": args.iters}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
