// Fused whole-stack GPT-2 decode for Hopper (sm_90a): K8.
//
// Replaces the Pallas TPU kernel
//   tnn_tpu/ops/pallas/decode_stack.py:fused_decode_stack (body _decode_kernel)
// and computes what it computes: all L blocks of one w8a8 decode step, for
// B rows at one position t, in ONE launch. x (B, D) f32 or bf16 is the
// embedded token; the caches (L, B, T, D) f32 or bf16 get row t of every
// layer written in place; the weights are the int8 stacks qkv (L, 3D, D),
// out (L, D, D), fc (L, F, D), proj (L, D, F), each row an output channel,
// with f32 per-channel scales, biases and LayerNorm vectors.
//
// Rounding points are the TPU kernel's (ops/decode_stack.py lists them):
// the residual stays f32; one-pass LayerNorm; every matmul input quantized
// per row (sx = absmax / 127, codes rint(x / sx) clipped to +-127, a true
// division); exact int8 x int8 sums (__dp4a into int32); the rescale
// acc * sx * w_scale + bias in that order; softmax as p / sum(p); the GELU
// output quantized per MLP chunk. Products and sums whose order the
// reference fixes use __fmul_rn / __fadd_rn, so that nvcc does not contract
// them into FMAs, and the build has no --use_fast_math: "/" is correctly
// rounded. rsqrtf and tanhf are not XLA's functions, so a re-quantized code
// can move by one step at a tie against the JAX kernel (the tests' limits
// allow for it).
//
// What bounds it on the H100: bytes. One step reads every int8 weight once
// (12 D^2 per layer: 85 MB for GPT-2 small) and rows 0..t of both caches;
// the operations (2 B per weight byte) are far below the int8 rate.
//
// Design: one cooperative launch of 512-thread blocks, as many as fit on
// the card at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs),
// with a grid-wide barrier (cooperative_groups grid sync) between the
// phases of each layer. The TPU kernel's sequential (layer, chunk) grid
// becomes a loop inside every block:
//   1. every block computes LN1 of the B rows of x_acc and quantizes them
//      into its shared memory (cheaper than a barrier);
//   2. each warp owns columns of qkv (__dp4a over K = D with 16-byte int8
//      loads): q to an f32 scratch, k and v to row t of the layer's cache
//      in the cache dtype; grid sync (row t is read by other blocks next);
//   3. attention: each block takes (row, head) items, reads cache rows
//      0..t of the head in 16-byte loads (f32 scores, max, exp, p / sum(p),
//      p @ V) and writes the context (B, D) f32; grid sync;
//   4. every block quantizes the context rows; each warp owns columns of
//      the out projection and writes x_mid and x_acc = x_mid + proj_b;
//      grid sync;
//   5. every block computes LN2 of x_mid and quantizes it; per MLP chunk:
//      the warps own fc columns (GELU, g to an f32 scratch), grid sync,
//      every block quantizes g, the warps own proj columns and add the
//      chunk's part to x_acc, grid sync.
// A warp owns the same D-wide columns in phases 4 and 5, so x_acc needs no
// atomics and every run gives the same bits. That is L (3 + 2 C) grid syncs
// a step, less the last. Data written inside the launch is read back with
// __ldcg (L2, never a stale L1 line). Rows past the live batch of a padded
// engine step compute on whatever their caches hold and are never read.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 16;  // ops/decode_stack.py MAX_BATCH
constexpr int kRed = kWarps * 256;  // reduction floats: a warp per head dim

struct Params {
  const void* x;
  void* kc;
  void* vc;
  const float* ln1_s;
  const float* ln1_b;
  const float* ln2_s;
  const float* ln2_b;
  const int8_t* qkv_q;
  const float* qkv_s;
  const float* qkv_b;
  const int8_t* out_q;
  const float* out_s;
  const float* out_b;
  const int8_t* fc_q;
  const float* fc_s;
  const float* fc_b;
  const int8_t* proj_q;
  const float* proj_s;
  const float* proj_b;
  void* x_out;
  float* x_acc;  // (B, D) the residual
  float* x_mid;  // (B, D) after attention, LN2's input
  float* qbuf;   // (B, D) q of the layer
  float* ctx;    // (B, D) attention output
  float* g;      // (B, F / chunks) one chunk of GELU outputs
  float scale;  // 1 / sqrt(head dim), rounded to f32 once on the host
  int B, D, T, L, F, chunks, H, t;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// a cache element, through L2: row t was written by another block
__device__ __forceinline__ float ld_cache(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_cache(const __nv_bfloat16* p) {
  const unsigned short bits =
      __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(bits) << 16);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ int warp_sum_i(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// block-wide max or sum; every thread gets the result
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < kWarps ? red[lane] : (kMax ? -CUDART_INF_F : 0.f);
  return kMax ? warp_max(v) : warp_sum(v);
}

__device__ __forceinline__ int8_t quant_code(float v, float s) {
  const float r = fminf(fmaxf(rintf(v / s), -127.f), 127.f);
  return static_cast<int8_t>(r);
}

__device__ __forceinline__ float row_scale(float absmax) {
  return absmax == 0.f ? 1.f : absmax / 127.f;
}

// jax.nn.gelu(approximate=True): x * (0.5 * (1 + tanh(c * (x + 0.044715 x^3))))
__device__ __forceinline__ float gelu(float x) {
  const float c = 0.7978845608028654f;  // f32(np.sqrt(2 / np.pi))
  const float cube = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(c, __fadd_rn(x, __fmul_rn(0.044715f, cube)));
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.f, tanhf(inner))));
}

// One-pass LayerNorm of B rows of width D (x_in at layer 0, else `src`),
// quantized per row into shared memory: codes dst (B, D), scales sx (B).
// One warp per row.
template <typename TX>
__device__ void ln_quant(const Params& p, const TX* x_in, const float* src,
                         const float* scale, const float* bias, int8_t* dst,
                         float* sx) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int D = p.D;
  for (int b = warp; b < p.B; b += kWarps) {
    const size_t row = static_cast<size_t>(b) * D;
    auto val = [&](int i) -> float {
      return x_in != nullptr ? to_f32(x_in[row + i]) : __ldcg(src + row + i);
    };
    float s = 0.f, s2 = 0.f;
#pragma unroll 8
    for (int i = lane; i < D; i += 32) {
      const float v = val(i);
      s = __fadd_rn(s, v);
      s2 = __fadd_rn(s2, __fmul_rn(v, v));
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mean = s / static_cast<float>(D);
    const float mean2 = s2 / static_cast<float>(D);
    const float var = fmaxf(__fsub_rn(mean2, __fmul_rn(mean, mean)), 0.f);
    const float r = rsqrtf(__fadd_rn(var, 1e-5f));
    auto y = [&](int i) -> float {
      return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(val(i), mean), r),
                                 scale[i]),
                       bias[i]);
    };
    float amax = 0.f;
#pragma unroll 8
    for (int i = lane; i < D; i += 32) amax = fmaxf(amax, fabsf(y(i)));
    const float q = row_scale(warp_max(amax));
#pragma unroll 8
    for (int i = lane; i < D; i += 32) dst[row + i] = quant_code(y(i), q);
    if (lane == 0) sx[b] = q;
  }
}

// Per-row quantization of B rows of width K from f32 scratch `src` into
// shared memory. One warp per row.
__device__ void quant_rows(const float* src, int B, int K, int8_t* dst,
                           float* sx) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int b = warp; b < B; b += kWarps) {
    const size_t row = static_cast<size_t>(b) * K;
    float amax = 0.f;
#pragma unroll 8
    for (int i = lane; i < K; i += 32)
      amax = fmaxf(amax, fabsf(__ldcg(src + row + i)));
    const float q = row_scale(warp_max(amax));
#pragma unroll 8
    for (int i = lane; i < K; i += 32)
      dst[row + i] = quant_code(__ldcg(src + row + i), q);
    if (lane == 0) sx[b] = q;
  }
}

// The exact int32 sums of one weight row w (K int8, 16-byte aligned, K a
// multiple of 16) against the B code rows in shared memory (row stride K);
// every lane of the warp gets every row's sum.
__device__ __forceinline__ void dot_rows(const int8_t* act, const int8_t* w,
                                         int K, int B, int (&acc)[kMaxB]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int b = 0; b < kMaxB; ++b) acc[b] = 0;
  const int4* w4 = reinterpret_cast<const int4*>(w);
  for (int i = lane; i < K / 16; i += 32) {
    const int4 wv = __ldg(w4 + i);
#pragma unroll
    for (int b = 0; b < kMaxB; ++b) {
      if (b < B) {
        const int4 av =
            *reinterpret_cast<const int4*>(act + static_cast<size_t>(b) * K +
                                           static_cast<size_t>(i) * 16);
        acc[b] = __dp4a(av.x, wv.x, acc[b]);
        acc[b] = __dp4a(av.y, wv.y, acc[b]);
        acc[b] = __dp4a(av.z, wv.z, acc[b]);
        acc[b] = __dp4a(av.w, wv.w, acc[b]);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < kMaxB; ++b)
    if (b < B) acc[b] = warp_sum_i(acc[b]);
}

// acc * sx * w_scale (+ bias), in the reference's order
__device__ __forceinline__ float rescale(int acc, float sx, float ws) {
  return __fmul_rn(__fmul_rn(static_cast<float>(acc), sx), ws);
}

// 8 consecutive cache elements (16 bytes of bf16, 32 of f32) as f32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldcg(reinterpret_cast<const uint4*>(p));
  const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Phase 3 for one (row, head): softmax attention over cache rows 0..t.
// Scores: one thread per position, its key row in 16-byte loads. p @ V:
// thread (group, c) sums 8 dims (chunk c) over the positions of its group;
// the groups of a warp meet by shuffles, the warps in shared memory. The
// head dim is a power of two from 8 to 256 (ops/decode_stack.py checks).
template <typename TC>
__device__ void attend(const Params& p, int layer, int b, int h, float* qs,
                       float* sc, float* red) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int D = p.D, dh = D / p.H, t = p.t;
  const size_t base =
      (static_cast<size_t>(layer) * p.B + b) * p.T * D + static_cast<size_t>(h) * dh;
  const TC* kb = static_cast<const TC*>(p.kc) + base;
  const TC* vb = static_cast<const TC*>(p.vc) + base;
  for (int i = tid; i < dh; i += kThreads)
    qs[i] = __ldcg(p.qbuf + static_cast<size_t>(b) * D + h * dh + i);
  __syncthreads();
  float m = -CUDART_INF_F;
  for (int j = tid; j <= t; j += kThreads) {
    const TC* kr = kb + static_cast<size_t>(j) * D;
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < dh; d += 8) {
      float v[8];
      load8(kr + d, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += qs[d + e] * v[e];
    }
    s = __fmul_rn(s, p.scale);
    sc[j] = s;
    m = fmaxf(m, s);
  }
  m = block_reduce<true>(m, red);
  float sum = 0.f;
  for (int j = tid; j <= t; j += kThreads) {
    const float e = expf(__fsub_rn(sc[j], m));
    sc[j] = e;
    sum += e;
  }
  sum = block_reduce<false>(sum, red);
  for (int j = tid; j <= t; j += kThreads) sc[j] = sc[j] / sum;
  __syncthreads();
  const int nvec = dh / 8;            // 8-dim chunks of the head
  const int groups = kThreads / nvec;
  const int c = tid % nvec, grp = tid / nvec;
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  for (int j = grp; j <= t; j += groups) {
    float v[8];
    load8(vb + static_cast<size_t>(j) * D + c * 8, v);
    const float pj = sc[j];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] += pj * v[e];
  }
  // the groups of one warp: lanes nvec apart hold the same chunk
  for (int o = nvec; o < 32; o <<= 1)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  __syncthreads();  // red was read by the sum's reduction
  if (lane < nvec)
#pragma unroll
    for (int e = 0; e < 8; ++e) red[warp * dh + c * 8 + e] = acc[e];
  __syncthreads();
  if (tid < dh) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * dh + tid];
    p.ctx[static_cast<size_t>(b) * D + h * dh + tid] = s;
  }
  __syncthreads();  // qs, sc and red are reused by the next item
}

template <typename TX, typename TC>
__global__ void __launch_bounds__(kThreads, 1)
    decode_stack_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = p.B, D = p.D, F = p.F, t = p.t;
  const int fcw = F / p.chunks;
  const int dh = D / p.H;
  auto up16 = [](int n) { return (n + 15) / 16 * 16; };
  int8_t* hq = reinterpret_cast<int8_t*>(smem);  // (B, D) codes
  int8_t* gq = hq + up16(B * D);                  // (B, F / chunks) codes
  float* hs = reinterpret_cast<float*>(gq + up16(B * fcw));
  float* gs = hs + kMaxB;
  float* red = gs + kMaxB;  // kRed floats
  float* qs = red + kRed;   // one head of q
  float* sc = qs + up16(dh * 4) / 4;  // T scores

  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x % 32;
  const int gwarp = blockIdx.x * kWarps + threadIdx.x / 32;
  const int nwarps = gridDim.x * kWarps;
  const TX* x_in = static_cast<const TX*>(p.x);
  TC* kc = static_cast<TC*>(p.kc);
  TC* vc = static_cast<TC*>(p.vc);
  int acc[kMaxB];

  for (int layer = 0; layer < p.L; ++layer) {
    const size_t l = static_cast<size_t>(layer);
    // 1. LN1 + quantize, in every block
    ln_quant(p, layer == 0 ? x_in : static_cast<const TX*>(nullptr), p.x_acc,
             p.ln1_s + l * D, p.ln1_b + l * D, hq, hs);
    __syncthreads();
    // 2. qkv columns: q to scratch, k / v to row t of the cache
    for (int n = gwarp; n < 3 * D; n += nwarps) {
      dot_rows(hq, p.qkv_q + (l * 3 * D + n) * D, D, B, acc);
      const float ws = p.qkv_s[l * 3 * D + n], bias = p.qkv_b[l * 3 * D + n];
#pragma unroll
      for (int b = 0; b < kMaxB; ++b) {
        if (b < B && lane == b) {
          const float v = __fadd_rn(rescale(acc[b], hs[b], ws), bias);
          if (n < D) {
            p.qbuf[static_cast<size_t>(b) * D + n] = v;
          } else {
            const size_t at = ((l * B + b) * p.T + t) * D + (n % D);
            if (n < 2 * D)
              kc[at] = from_f32<TC>(v);
            else
              vc[at] = from_f32<TC>(v);
          }
        }
      }
    }
    grid.sync();
    // 3. attention, one (row, head) item per block at a time
    for (int item = blockIdx.x; item < B * p.H; item += gridDim.x)
      attend<TC>(p, layer, item / p.H, item % p.H, qs, sc, red);
    grid.sync();
    // 4. out projection: x_mid = x + attn, x_acc = x_mid + proj_b
    quant_rows(p.ctx, B, D, hq, hs);
    __syncthreads();
    for (int n = gwarp; n < D; n += nwarps) {
      dot_rows(hq, p.out_q + (l * D + n) * D, D, B, acc);
      const float ws = p.out_s[l * D + n], bias = p.out_b[l * D + n];
#pragma unroll
      for (int b = 0; b < kMaxB; ++b) {
        if (b < B && lane == b) {
          const size_t at = static_cast<size_t>(b) * D + n;
          const float x = layer == 0 ? to_f32(x_in[at]) : __ldcg(p.x_acc + at);
          const float xm = __fadd_rn(x, __fadd_rn(rescale(acc[b], hs[b], ws),
                                                  bias));
          p.x_mid[at] = xm;
          p.x_acc[at] = __fadd_rn(xm, p.proj_b[l * D + n]);
        }
      }
    }
    grid.sync();
    // 5. LN2 + quantize in every block, then the MLP chunk by chunk
    ln_quant(p, static_cast<const TX*>(nullptr), p.x_mid, p.ln2_s + l * D,
             p.ln2_b + l * D, hq, hs);
    __syncthreads();
    for (int c = 0; c < p.chunks; ++c) {
      for (int nl = gwarp; nl < fcw; nl += nwarps) {
        const size_t n = static_cast<size_t>(c) * fcw + nl;
        dot_rows(hq, p.fc_q + (l * F + n) * D, D, B, acc);
        const float ws = p.fc_s[l * F + n], bias = p.fc_b[l * F + n];
#pragma unroll
        for (int b = 0; b < kMaxB; ++b)
          if (b < B && lane == b)
            p.g[static_cast<size_t>(b) * fcw + nl] =
                gelu(__fadd_rn(rescale(acc[b], hs[b], ws), bias));
      }
      grid.sync();
      quant_rows(p.g, B, fcw, gq, gs);
      __syncthreads();
      const bool last = layer == p.L - 1 && c == p.chunks - 1;
      for (int n = gwarp; n < D; n += nwarps) {
        dot_rows(gq, p.proj_q + (l * D + n) * F + static_cast<size_t>(c) * fcw,
                 fcw, B, acc);
        const float ws = p.proj_s[l * D + n];
#pragma unroll
        for (int b = 0; b < kMaxB; ++b) {
          if (b < B && lane == b) {
            const size_t at = static_cast<size_t>(b) * D + n;
            const float v =
                __fadd_rn(__ldcg(p.x_acc + at), rescale(acc[b], gs[b], ws));
            p.x_acc[at] = v;
            if (last) static_cast<TX*>(p.x_out)[at] = from_f32<TX>(v);
          }
        }
      }
      if (!last) grid.sync();
    }
  }
}

template <typename TX, typename TC>
int launch(const Params& p, int smem, cudaStream_t stream) {
  const void* kern = reinterpret_cast<const void*>(decode_stack_kernel<TX, TC>);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return cudaErrorNotSupported;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  Params args = p;
  void* argv[] = {&args};
  err = cudaLaunchCooperativeKernel(kern, dim3(sms * per_sm), dim3(kThreads),
                                    argv, static_cast<size_t>(smem), stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Plain C entry (ctypes). dtype codes: 0 = float32, 1 = bfloat16. scratch
// holds B (4 D + F / chunks) floats. Returns 0 or the CUDA error code; a
// refused cooperative launch is an error, never a fall-through.
extern "C" int tnn_fused_decode_stack(
    const void* x, void* kc, void* vc, const void* ln1_s, const void* ln1_b,
    const void* ln2_s, const void* ln2_b, const void* qkv_q, const void* qkv_s,
    const void* qkv_b, const void* out_q, const void* out_s, const void* out_b,
    const void* fc_q, const void* fc_s, const void* fc_b, const void* proj_q,
    const void* proj_s, const void* proj_b, void* x_out, void* scratch,
    int x_dtype, int cache_dtype, int B, int D, int T, int L, int F, int chunks,
    int H, int t, int smem, float scale, void* stream) {
  if (B < 1 || B > kMaxB || D % 16 || F % chunks || (F / chunks) % 16 ||
      D % H || t < 0 || t >= T || (D / H) % 8 || D / H > 256 ||
      ((D / H) & (D / H - 1)))
    return cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.kc = kc;
  p.vc = vc;
  p.ln1_s = static_cast<const float*>(ln1_s);
  p.ln1_b = static_cast<const float*>(ln1_b);
  p.ln2_s = static_cast<const float*>(ln2_s);
  p.ln2_b = static_cast<const float*>(ln2_b);
  p.qkv_q = static_cast<const int8_t*>(qkv_q);
  p.qkv_s = static_cast<const float*>(qkv_s);
  p.qkv_b = static_cast<const float*>(qkv_b);
  p.out_q = static_cast<const int8_t*>(out_q);
  p.out_s = static_cast<const float*>(out_s);
  p.out_b = static_cast<const float*>(out_b);
  p.fc_q = static_cast<const int8_t*>(fc_q);
  p.fc_s = static_cast<const float*>(fc_s);
  p.fc_b = static_cast<const float*>(fc_b);
  p.proj_q = static_cast<const int8_t*>(proj_q);
  p.proj_s = static_cast<const float*>(proj_s);
  p.proj_b = static_cast<const float*>(proj_b);
  p.x_out = x_out;
  float* s = static_cast<float*>(scratch);
  const size_t bd = static_cast<size_t>(B) * D;
  p.x_acc = s;
  p.x_mid = s + bd;
  p.qbuf = s + 2 * bd;
  p.ctx = s + 3 * bd;
  p.g = s + 4 * bd;
  p.B = B;
  p.D = D;
  p.T = T;
  p.L = L;
  p.F = F;
  p.chunks = chunks;
  p.H = H;
  p.t = t;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && cache_dtype == 0) return launch<float, float>(p, smem, st);
  if (x_dtype == 0 && cache_dtype == 1)
    return launch<float, __nv_bfloat16>(p, smem, st);
  if (x_dtype == 1 && cache_dtype == 0)
    return launch<__nv_bfloat16, float>(p, smem, st);
  if (x_dtype == 1 && cache_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(p, smem, st);
  return cudaErrorInvalidValue;
}
