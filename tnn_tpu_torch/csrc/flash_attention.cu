// Flash attention for Hopper (sm_90a): the forward (K4), the fused
// one-sweep backward (K7) and the split backward (K5 dQ, K6 dK/dV), bf16 or
// f32, head dim 64 or 128.
//
// Replaces the Pallas TPU kernels
//   tnn_tpu/ops/pallas/flash_attention.py:_flash_fwd / _fwd_kernel       (K4)
//   tnn_tpu/ops/pallas/flash_attention.py:_flash_bwd dQ pass /
//                                        _bwd_dq_kernel                   (K5)
//   tnn_tpu/ops/pallas/flash_attention.py:_flash_bwd dK/dV pass /
//                                        _bwd_dkv_kernel                  (K6)
//   tnn_tpu/ops/pallas/flash_attention.py:_flash_bwd_fused /
//                                        _bwd_fused_kernel                (K7)
// and computes what they compute, at the same rounding points:
//   * q (B, H, Sq, D), k and v (B, H_kv, Skv, D), all contiguous; a q head h
//     reads kv head h / (H / H_kv) (GQA: the shared heads are never copied);
//   * logits in f32 (f32 products and sums of the input values) times
//     `scale`; a key is live when it is below Skv, when `causal` is off or
//     off + q_row >= key, and when the grouped int8 mask (G, Sq, Skv) with
//     G in {1, B, B*H} holds a non-zero there; dead logits become -1e30;
//   * forward: online softmax per key tile in f32 (128 keys in bf16, 64 in
//     f32), p rounded to the input dtype before the PV product (the TPU
//     kernel's p.astype(v.dtype)), f32 accumulation; O in the input dtype
//     and the f32 logsumexp per row, +inf on rows with no live key, whose
//     output is exactly 0;
//   * backward: p = exp(s - lse) recomputed per tile, delta = rowsum(dO*O)
//     in a pre-pass, dV += round(p)^T dO, ds = round(p * (dP - delta) *
//     scale) with dP = dO V^T, dK += ds^T Q and dQ += ds K. Rounding to the
//     input dtype matches the TPU kernels' p.astype(dO.dtype) and
//     ds.astype(q.dtype). K7 takes five products per live tile; K5 (S, dP,
//     dQ) and K6 (S, dP, dV, dK) take seven between them.
//
// Every offset that multiplies two lengths, or a length by B*H, is taken in
// size_t: at S = 32,768 a mask of G groups spans G * 2^30 bytes.
//
// What bounds it on the H100: at gpt2_small's training shape (B=8, H=12,
// S=1024, D=64, bf16, causal) the forward moves 50 MB and computes 12.9
// GFLOP of causal QK and PV (0.015 ms at 3.35 TB/s vs 0.013 ms at 989
// TFLOP/s: bytes, barely); the backward computes 32 GFLOP (0.033 ms,
// operations). At llama_small's long-context shape (B=1, H=12, H_kv=4,
// S=32,768) every kernel is operations-bound: K4 1.65 TFLOP, K5 2.47, K6
// 3.30, K7 4.12.
//
// Two bodies. bf16 inputs run on the tensor cores, in all four kernels:
// wgmma products of bf16 tiles with f32 accumulation, which is what the
// plain version's f32 products of the same bf16 values compute, up to
// summation order; TMA tile loads and a producer warpgroup (hopper.cuh;
// the design is noted above each kernel). f32 inputs run the SIMT body in
// f32 on the CUDA cores (67 TFLOP/s peak): the tensor cores have no exact
// f32 product, and TF32 keeps 10 bits of mantissa. The launch code picks
// the body by dtype; nothing falls back from one to the other. On the card
// (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py) the tensor-core bodies
// take 0.07 ms (K4) and 0.22 ms (K7 alone) at the training shape, against
// 0.75 and 1.58 ms for the SIMT body; at llama_small's long-context shape
// the K5 call takes 11.2 ms and the K6 call 14.7 ms, against 102.4 and
// 128.3 ms on the SIMT body (the K7 call 19.3 ms there).
//
// `nvcc -Xptxas -v` with runtime.NVCC_FLAGS on this file (CUDA 12.9), for
// the tensor-core bodies: 168 registers a thread at launch (384 threads,
// one block an SM); setmaxnreg gives the producer 24 and the consumers 240.
// No spills in K4 and K5 at D = 64 and 128. K6 and K7 at D = 64 spill a
// few bytes (8-byte stack frames; K6 stores 4 bytes, K7 8); at D = 128
// both spill (K6 972 bytes, K7 736) and ptxas serializes their products
// for lack of registers (C7512), off the main paths. Shared memory: K4
// 83,008 bytes (D=64) and 164,928 (D=128); K5 132,184 and 164,952; K6
// 67,624 and 133,160; K7 116,776 and 215,080.
//
// SIMT body. The TPU grid walks kv blocks in order and carries (m, l, acc)
// in VMEM scratch; here one block of 256 threads owns one (batch*head,
// 64-row query tile) and loops over the live key tiles itself: causal tiles
// above the diagonal are neither read nor computed, and the heaviest causal
// tiles are launched first. Each thread holds a 4 x 4 piece of the 64 x 64
// logit tile and 4 rows x D/16 dims of the accumulator; the 16 threads of a
// half-warp share a row, so row maxima and sums are half-warp shuffles.
//
// The TPU's fused backward carries a full-sequence dQ scratch across a
// SEQUENTIAL grid; CUDA blocks run in no order. The SIMT K7 and K6 give one
// block one (batch*q-head, 64-key tile): it keeps K_j, V_j in shared memory
// and dK_j, dV_j in registers, and walks the q tiles that can see it. K7
// adds each q tile's dQ contribution ds K_j into an f32 (B*H, Sq, D)
// buffer with atomicAdd, so the low bits of its dQ depend on the order the
// blocks finish in and differ from run to run; K6 is the same kernel
// without the dQ products. The SIMT K5 owns one (batch*q-head, 64-row q
// tile), as the forward does, walks the live key tiles (causal: up to the
// row tile's last live key, the TPU's dead-block clamp), keeps dQ in
// registers in f32 and writes it once: no atomics, the same bits on every
// run. The tensor-core bodies keep these shapes of work (K5: 128-row q
// tiles on a persistent grid). dK and dV are written per q head; the
// caller sums each GQA group, as the TPU path does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kTile = 64;      // query rows and keys per tile
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kSub = 4;        // rows / columns of a tile each thread owns
constexpr float kNegInf = -1e30f;  // the TPU kernel's _NEG_INF
constexpr unsigned kFull = 0xffffffffu;

struct Shape {
  int B, H, HKV, Sq, Skv, g;  // g = H / HKV
  int mask_groups;            // 0 = no mask, else 1, B or B*H
  int causal;
  int off;                    // absolute position of q row 0 among the keys
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype
}
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// the mask rows of flattened batch*head `bh` (nullptr without a mask)
__device__ __forceinline__ const int8_t* mask_rows(const int8_t* mask,
                                                   const Shape& s, int bh) {
  if (mask == nullptr) return nullptr;
  int grp = 0;
  if (s.mask_groups == s.B * s.H) {
    grp = bh;
  } else if (s.mask_groups == s.B) {
    grp = bh / s.H;
  }
  return mask + static_cast<size_t>(grp) * s.Sq * s.Skv;
}

__device__ __forceinline__ bool is_live(const Shape& s, const int8_t* m,
                                        int qi, int kj) {
  if (qi >= s.Sq || kj >= s.Skv) return false;
  if (s.causal && s.off + qi < kj) return false;
  if (m != nullptr && m[static_cast<size_t>(qi) * s.Skv + kj] == 0)
    return false;
  return true;
}

// key tiles of q rows [q0, q0 + rows): causal tiles past the diagonal are
// neither loaded nor computed
__device__ __forceinline__ int key_tiles(const Shape& s, int q0, int rows,
                                         int keys) {
  int nk = (s.Skv + keys - 1) / keys;
  if (s.causal) {
    const int last = s.off + q0 + rows - 1;  // the rows' last position
    nk = last < 0 ? 0 : min(nk, last / keys + 1);
  }
  return nk;
}

// rows [row0, row0 + kTile) of a (rows, D) matrix into shared memory as f32,
// rows past `rows` as zeros
template <typename T, int D, int STRIDE>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rows) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D;
    const int c = i % D;
    const int gr = row0 + r;
    dst[r * STRIDE + c] =
        gr < rows ? to_f32(src[static_cast<size_t>(gr) * D + c]) : 0.f;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// ---------------------------------------------------------------- forward --

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int8_t* __restrict__ mask,
                     T* __restrict__ o, float* __restrict__ lse,
                     const Shape s) {
  constexpr int QS = D + 1;  // padded strides: no bank conflicts
  constexpr int VS = D;
  constexpr int PS = kTile + 1;
  constexpr int kDims = D / 16;  // output dims per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kTile * QS;
  float* vs = ks + kTile * QS;
  float* ps = vs + kTile * VS;

  const int bh = blockIdx.y;
  const int b = bh / s.H;
  const int bkv = b * s.HKV + (bh % s.H) / s.g;
  const int nq = (s.Sq + kTile - 1) / kTile;
  const int qt = s.causal ? nq - 1 - static_cast<int>(blockIdx.x)
                          : static_cast<int>(blockIdx.x);
  const int q0 = qt * kTile;
  const int tr = threadIdx.x / 16;  // rows tr + 16 i
  const int tc = threadIdx.x % 16;  // keys / dims tc + 16 j

  const T* qp = q + static_cast<size_t>(bh) * s.Sq * D;
  const T* kp = k + static_cast<size_t>(bkv) * s.Skv * D;
  const T* vp = v + static_cast<size_t>(bkv) * s.Skv * D;
  const int8_t* mp = mask_rows(mask, s, bh);

  load_tile<T, D, QS>(qs, qp, q0, s.Sq);

  float m[kSub], l[kSub], acc[kSub][kDims];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kDims; ++e) acc[i][e] = 0.f;
  }

  const int nk = key_tiles(s, q0, kTile, kTile);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's reads of ks / vs / ps are done
    load_tile<T, D, QS>(ks, kp, k0, s.Skv);
    load_tile<T, D, VS>(vs, vp, k0, s.Skv);
    __syncthreads();

    float sc[kSub][kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kSub], kv[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) qv[i] = qs[(tr + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < kSub; ++j) kv[j] = ks[(tc + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int r = tr + 16 * i;
      bool live[kSub];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        live[j] = is_live(s, mp, q0 + r, k0 + tc + 16 * j);
        sc[i][j] = live[j] ? sc[i][j] * s.scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        // rows with no live key so far have m_new == -1e30: the masked
        // entries must not become exp(0) = 1
        const float p = live[j] ? expf(sc[i][j] - m_new) : 0.f;
        rs += p;
        ps[r * PS + tc + 16 * j] = round_to<T>(p);
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < kDims; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float pv[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) pv[i] = ps[(tr + 16 * i) * PS + c];
#pragma unroll
      for (int e = 0; e < kDims; ++e) {
        const float vv = vs[c * VS + tc + 16 * e];
#pragma unroll
        for (int i = 0; i < kSub; ++i) acc[i][e] = fmaf(pv[i], vv, acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int qi = q0 + tr + 16 * i;
    if (qi >= s.Sq) continue;
    const float lsafe = l[i] == 0.f ? 1.f : l[i];  // dead rows -> 0
    const size_t row = static_cast<size_t>(bh) * s.Sq + qi;
#pragma unroll
    for (int e = 0; e < kDims; ++e)
      o[row * D + tc + 16 * e] = from_f32<T>(acc[i][e] / lsafe);
    if (tc == 0) lse[row] = l[i] > 0.f ? m[i] + logf(lsafe) : INFINITY;
  }
}

// --------------------------------------------------------------- backward --

// delta[row] = sum_d dO[row, d] * O[row, d] in f32; one warp per row
template <typename T, int D>
__global__ void flash_delta_kernel(const T* __restrict__ o,
                                   const T* __restrict__ dout,
                                   float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps leave together
  float acc = 0.f;
  const size_t base = static_cast<size_t>(row) * D;
#pragma unroll
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f32(dout[base + d]), to_f32(o[base + d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) delta[row] = acc;
}

// lse and delta of q rows [q0, q0 + kTile) into shared memory; +inf on
// padding rows makes their p exactly 0
__device__ __forceinline__ void load_row_stats(float* lse_s, float* delta_s,
                                               const float* lsep,
                                               const float* deltap, int q0,
                                               int sq) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const bool in = q0 + i < sq;
    lse_s[i] = in ? lsep[q0 + i] : INFINITY;
    delta_s[i] = in ? deltap[q0 + i] : 0.f;
  }
}

// One (64 q rows, 64 keys) tile of the backward, from Q, dO, K, V (f32,
// row stride D + 1) in shared memory: S = Q K^T and dP = dO V^T for q rows
// tr + 16 i and keys tc + 16 j, then p = exp(S scale - lse), stored rounded
// to T in pts (when given), and ds = round(p (dP - delta) scale) in dss,
// both (q row, key) with row stride kTile + 1.
template <typename T, int D>
__device__ __forceinline__ void bwd_tile(const Shape& s, const int8_t* mp,
                                         int q0, int k0, const float* qs,
                                         const float* dos, const float* ks,
                                         const float* vs, const float* lse_s,
                                         const float* delta_s, float* pts,
                                         float* dss) {
  constexpr int S = D + 1;
  constexpr int PS = kTile + 1;
  const int tr = threadIdx.x / 16;
  const int tc = threadIdx.x % 16;
  float sc[kSub][kSub], dp[kSub][kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      sc[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[kSub], dov[kSub], kv[kSub], vv[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      qv[i] = qs[(tr + 16 * i) * S + d];
      dov[i] = dos[(tr + 16 * i) * S + d];
    }
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      kv[j] = ks[(tc + 16 * j) * S + d];
      vv[j] = vs[(tc + 16 * j) * S + d];
    }
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
        dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int r = tr + 16 * i;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const int c = tc + 16 * j;
      const float sv =
          is_live(s, mp, q0 + r, k0 + c) ? sc[i][j] * s.scale : kNegInf;
      const float p = expf(sv - lse_s[r]);
      if (pts != nullptr) pts[r * PS + c] = round_to<T>(p);
      dss[r * PS + c] = round_to<T>(p * (dp[i][j] - delta_s[r]) * s.scale);
    }
  }
}

// acc[i][e] += sum_c dss[tr + 16 i, c] * ks[c, tc + 16 e]: the dQ product
// of one tile, q rows tr + 16 i, dims tc + 16 e
template <int D>
__device__ __forceinline__ void add_ds_k(float acc[kSub][D / 16],
                                         const float* dss, const float* ks) {
  constexpr int S = D + 1;
  constexpr int PS = kTile + 1;
  const int tr = threadIdx.x / 16;
  const int tc = threadIdx.x % 16;
#pragma unroll 2
  for (int c = 0; c < kTile; ++c) {
    float dr[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) dr[i] = dss[(tr + 16 * i) * PS + c];
#pragma unroll
    for (int e = 0; e < D / 16; ++e) {
      const float kv = ks[c * S + tc + 16 * e];
#pragma unroll
      for (int i = 0; i < kSub; ++i) acc[i][e] = fmaf(dr[i], kv, acc[i][e]);
    }
  }
}

// K5: dQ of one (batch*q-head, 64-row q tile), accumulated in registers
// over the live key tiles and written once in T.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int8_t* __restrict__ mask,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        const Shape s) {
  constexpr int S = D + 1;
  constexpr int PS = kTile + 1;
  constexpr int kDims = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * S;
  float* ks = dos + kTile * S;
  float* vs = ks + kTile * S;
  float* dss = vs + kTile * S;  // round(ds), (q row, key)
  float* lse_s = dss + kTile * PS;
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.y;
  const int b = bh / s.H;
  const int bkv = b * s.HKV + (bh % s.H) / s.g;
  const int nq = (s.Sq + kTile - 1) / kTile;
  const int qt = s.causal ? nq - 1 - static_cast<int>(blockIdx.x)
                          : static_cast<int>(blockIdx.x);
  const int q0 = qt * kTile;
  const int tr = threadIdx.x / 16;
  const int tc = threadIdx.x % 16;

  const T* kp = k + static_cast<size_t>(bkv) * s.Skv * D;
  const T* vp = v + static_cast<size_t>(bkv) * s.Skv * D;
  const int8_t* mp = mask_rows(mask, s, bh);

  load_tile<T, D, S>(qs, q + static_cast<size_t>(bh) * s.Sq * D, q0, s.Sq);
  load_tile<T, D, S>(dos, dout + static_cast<size_t>(bh) * s.Sq * D, q0,
                     s.Sq);
  load_row_stats(lse_s, delta_s, lse + static_cast<size_t>(bh) * s.Sq,
                 delta + static_cast<size_t>(bh) * s.Sq, q0, s.Sq);

  float acc[kSub][kDims];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int e = 0; e < kDims; ++e) acc[i][e] = 0.f;

  const int nk = key_tiles(s, q0, kTile, kTile);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's reads of ks / vs / dss are done
    load_tile<T, D, S>(ks, kp, k0, s.Skv);
    load_tile<T, D, S>(vs, vp, k0, s.Skv);
    __syncthreads();
    bwd_tile<T, D>(s, mp, q0, k0, qs, dos, ks, vs, lse_s, delta_s, nullptr,
                   dss);
    __syncthreads();
    add_ds_k<D>(acc, dss, ks);
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int qi = q0 + tr + 16 * i;
    if (qi >= s.Sq) continue;
    const size_t row = static_cast<size_t>(bh) * s.Sq + qi;
#pragma unroll
    for (int e = 0; e < kDims; ++e)
      dq[row * D + tc + 16 * e] = from_f32<T>(acc[i][e]);
  }
}

// K7 (kDq) and K6 (!kDq): dK and dV of one (batch*q-head, 64-key tile)
// over the q tiles that can see it; K7 also adds each tile's dQ product into
// dq_acc with atomicAdd.
template <typename T, int D, bool kDq>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int8_t* __restrict__ mask,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* dq_acc,
                     T* __restrict__ dk, T* __restrict__ dv, const Shape s) {
  constexpr int S = D + 1;
  constexpr int PS = kTile + 1;
  constexpr int kDims = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * S;
  float* qs = vs + kTile * S;
  float* dos = qs + kTile * S;
  float* pts = dos + kTile * S;   // round(p), (q row, key)
  float* dss = pts + kTile * PS;  // round(ds), (q row, key)
  float* lse_s = dss + kTile * PS;
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.y;
  const int b = bh / s.H;
  const int bkv = b * s.HKV + (bh % s.H) / s.g;
  const int k0 = blockIdx.x * kTile;
  const int tr = threadIdx.x / 16;
  const int tc = threadIdx.x % 16;

  const T* qp = q + static_cast<size_t>(bh) * s.Sq * D;
  const T* dop = dout + static_cast<size_t>(bh) * s.Sq * D;
  const float* lsep = lse + static_cast<size_t>(bh) * s.Sq;
  const float* deltap = delta + static_cast<size_t>(bh) * s.Sq;
  const int8_t* mp = mask_rows(mask, s, bh);

  load_tile<T, D, S>(ks, k + static_cast<size_t>(bkv) * s.Skv * D, k0,
                     s.Skv);
  load_tile<T, D, S>(vs, v + static_cast<size_t>(bkv) * s.Skv * D, k0,
                     s.Skv);

  float dk_acc[kSub][kDims], dv_acc[kSub][kDims];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int e = 0; e < kDims; ++e) {
      dk_acc[i][e] = 0.f;
      dv_acc[i][e] = 0.f;
    }

  // the q tiles that can see this key tile: causal rows below k0 - off see
  // none of its keys (with Sq < Skv a trailing key tile may see no q tile)
  const int nq = (s.Sq + kTile - 1) / kTile;
  int qt0 = 0;
  if (s.causal && k0 - s.off > 0) qt0 = (k0 - s.off) / kTile;

  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous q tile's reads are done
    load_tile<T, D, S>(qs, qp, q0, s.Sq);
    load_tile<T, D, S>(dos, dop, q0, s.Sq);
    load_row_stats(lse_s, delta_s, lsep, deltap, q0, s.Sq);
    __syncthreads();
    bwd_tile<T, D>(s, mp, q0, k0, qs, dos, ks, vs, lse_s, delta_s, pts, dss);
    __syncthreads();

    // dV += round(p)^T dO and dK += ds^T Q: keys tr + 16 i, dims tc + 16 e
#pragma unroll 2
    for (int r = 0; r < kTile; ++r) {
      float pr[kSub], dr[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        pr[i] = pts[r * PS + tr + 16 * i];
        dr[i] = dss[r * PS + tr + 16 * i];
      }
#pragma unroll
      for (int e = 0; e < kDims; ++e) {
        const float dov = dos[r * S + tc + 16 * e];
        const float qv = qs[r * S + tc + 16 * e];
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          dv_acc[i][e] = fmaf(pr[i], dov, dv_acc[i][e]);
          dk_acc[i][e] = fmaf(dr[i], qv, dk_acc[i][e]);
        }
      }
    }

    if constexpr (kDq) {
      // dQ += ds K over this key tile: q rows tr + 16 i, dims tc + 16 e
      float dq[kSub][kDims];
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int e = 0; e < kDims; ++e) dq[i][e] = 0.f;
      add_ds_k<D>(dq, dss, ks);
      float* dqp = dq_acc + static_cast<size_t>(bh) * s.Sq * D;
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int qi = q0 + tr + 16 * i;
        if (qi >= s.Sq) continue;
#pragma unroll
        for (int e = 0; e < kDims; ++e)
          atomicAdd(dqp + static_cast<size_t>(qi) * D + tc + 16 * e,
                    dq[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int kj = k0 + tr + 16 * i;
    if (kj >= s.Skv) continue;
    const size_t row = static_cast<size_t>(bh) * s.Skv + kj;
#pragma unroll
    for (int e = 0; e < kDims; ++e) {
      dk[row * D + tc + 16 * e] = from_f32<T>(dk_acc[i][e]);
      dv[row * D + tc + 16 * e] = from_f32<T>(dv_acc[i][e]);
    }
  }
}

// ------------------------------------------- bf16 on the tensor cores --
//
// The bf16 forward (K4) and fused backward (K7) on wgmma, fed by TMA
// (hopper.cuh). A block is three warpgroups: warpgroup 0 is the producer
// (one thread issues the TMA loads; the warpgroup gives up its registers
// with setmaxnreg), warpgroups 1 and 2 are consumers of 64 rows each.

constexpr int kWg = 128;              // threads of a warpgroup
constexpr int kWgBlock = 3 * kWg;     // producer + two consumers
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBox = 64 * 128;        // bytes of a 64-row, 64-column box

// K4. A persistent grid, one block per SM: block i takes the work items
// (batch*head, 128-row q tile) i, i + grid, ..., heaviest causal tiles
// first. The producer loads an item's Q tile once and streams its 128-key
// K and V tiles through a two-stage ring (K and V on barriers of their own,
// so S waits for K only), running ahead into the next item while the
// consumers finish this one. Each consumer warpgroup owns 64 q rows and,
// per key tile, computes S = Q K^T on wgmma (both from shared memory), the
// online softmax on the accumulator fragments, and O += round(P) V with P
// from registers; each tile's S product is issued beside the previous
// tile's PV product, and the softmax waits for S only.
template <int D>
struct FwdTiles {
  static constexpr int kBoxes = D / 64;
  static constexpr int kRows = 128;     // q rows of an item
  static constexpr int kKeys = 128;     // keys of a tile
  static constexpr int kStages = 2;
  static constexpr int kQBytes = kBoxes * kRows * 128;
  static constexpr int kKVBytes = kBoxes * kKeys * 128;  // K or V tile
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * (2 + 3 * kStages);
};

// the q tile and batch*head of work item `item` (heaviest causal first)
__device__ __forceinline__ void fwd_item(const Shape& s, int nq, int item,
                                         int* qt, int* bh) {
  const int bhs = s.B * s.H;
  *bh = item % bhs;
  *qt = s.causal ? nq - 1 - item / bhs : item / bhs;
}

template <int D>
__global__ void __launch_bounds__(kWgBlock, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const int8_t* __restrict__ mask,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, const Shape s) {
  using C = FwdTiles<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = hopper::align_1024(smem_raw);
  uint8_t* ks = qs + C::kQBytes;
  uint8_t* vs = ks + C::kStages * C::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + C::kStages *
                                                 C::kKVBytes);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;
  uint64_t* v_full = k_full + C::kStages;
  uint64_t* empty = v_full + C::kStages;

  const int nq = (s.Sq + C::kRows - 1) / C::kRows;
  const int items = nq * s.B * s.H;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, 2 * kWg);  // every consumer thread
    for (int i = 0; i < C::kStages; ++i) {
      hopper::mbar_init(&k_full[i], 1);
      hopper::mbar_init(&v_full[i], 1);
      hopper::mbar_init(&empty[i], 2 * kWg);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == 0) {  // ------------------------------------------- producer --
    hopper::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int g = 0;  // key tiles loaded so far, over all items
      for (int item = blockIdx.x, n = 0; item < items;
           item += gridDim.x, ++n) {
        int qt, bh;
        fwd_item(s, nq, item, &qt, &bh);
        const int bkv = (bh / s.H) * s.HKV + (bh % s.H) / s.g;
        const int q0 = qt * C::kRows;
        hopper::mbar_wait(q_empty, (n & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(q_full, C::kQBytes);
        for (int bx = 0; bx < C::kBoxes; ++bx)
          hopper::tma_load_3d(qs + bx * C::kRows * 128, &tq, q_full, 64 * bx,
                              q0, bh);
        const int nk = key_tiles(s, q0, C::kRows, C::kKeys);
        for (int kt = 0; kt < nk; ++kt, ++g) {
          const int st = g % C::kStages;
          hopper::mbar_wait(&empty[st], ((g / C::kStages) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&k_full[st], C::kKVBytes);
          for (int bx = 0; bx < C::kBoxes; ++bx)
            hopper::tma_load_3d(ks + st * C::kKVBytes + bx * C::kKeys * 128,
                                &tk, &k_full[st], 64 * bx, kt * C::kKeys,
                                bkv);
          hopper::mbar_arrive_expect_tx(&v_full[st], C::kKVBytes);
          for (int bx = 0; bx < C::kBoxes; ++bx)
            hopper::tma_load_3d(vs + st * C::kKVBytes + bx * C::kKeys * 128,
                                &tv, &v_full[st], 64 * bx, kt * C::kKeys,
                                bkv);
        }
      }
    }
  } else {  // ---------------------------------------------- consumers --
    hopper::regs_inc<kConsumerRegs>();
    const int cw = wg - 1;  // rows 64 cw .. 64 cw + 63 of an item
    const int t = threadIdx.x % kWg;
    const int lane = t % 32;
    const int r16 = 16 * (t / 32) + lane / 4;  // fragment rows r16, r16 + 8
    const int c2 = 2 * (lane % 4);
    // p = exp2(S c - m c) with m the running maximum of the raw logits:
    // the scale is positive, so m scale is the maximum of the scaled
    // logits the plain version takes, bit for bit
    const float c = s.scale * kLog2e;

    float acc[C::kBoxes][32];
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float sc[64];                   // S of a tile: 64 rows x 128 keys
    uint32_t pa[C::kKeys / 16][4];  // round(P) of the previous tile
    int q0 = 0, qa = 0, bh = 0;
    const int8_t* mp = nullptr;

    // S = Q K^T of the key tile in stage st into sc
    auto issue_s = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int bx = kk / 4;
        hopper::wgmma_ss_n128<0, 0>(
            sc,
            hopper::sw128_desc(
                qs + bx * C::kRows * 128 + cw * kBox + (kk % 4) * 32, false),
            hopper::sw128_desc(
                ks + st * C::kKVBytes + bx * C::kKeys * 128 + (kk % 4) * 32,
                false),
            kk > 0);
      }
      hopper::wgmma_commit();
    };
    // O += round(P) V of the key tile in stage st: V read N-contiguous
    auto issue_pv = [&](int st) {
#pragma unroll
      for (int bx = 0; bx < C::kBoxes; ++bx)
#pragma unroll
        for (int kk = 0; kk < C::kKeys / 16; ++kk)
          hopper::wgmma_rs_n64<1>(
              acc[bx], pa[kk],
              hopper::sw128_desc(vs + st * C::kKVBytes +
                                     bx * C::kKeys * 128 + kk * 16 * 128,
                                 true),
              1);
      hopper::wgmma_commit();
    };
    // the online softmax of key tile kt on sc (P left in sc); alpha
    // rescales the earlier tiles' sums
    float alpha[2];
    auto softmax = [&](int kt) {
      const int k0 = kt * C::kKeys;
      const bool all_live =
          mp == nullptr && k0 + C::kKeys <= s.Skv &&
          (!s.causal || s.off + q0 + 64 * cw >= k0 + C::kKeys - 1);
      if (!all_live) {  // dead logits -inf: p 0 at any running maximum
#pragma unroll
        for (int i = 0; i < 64; ++i)
          if (!is_live(s, mp, qa + hopper::acc_row(i),
                       k0 + hopper::acc_col(i) + c2))
            sc[i] = -INFINITY;
      }
      float mx[2] = {m[0], m[1]}, mc[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 64; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        alpha[r] = exp2f((m[r] - mx[r]) * c);
        m[r] = mx[r];
        mc[r] = mx[r] * c;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const float p = exp2f(fmaf(sc[i], c, -mc[(i >> 1) & 1]));
        rs[(i >> 1) & 1] += p;
        sc[i] = p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(kFull, rs[r], 1);
        rs[r] += __shfl_xor_sync(kFull, rs[r], 2);
        l[r] = alpha[r] * l[r] + rs[r];
      }
    };

    int g = 0;  // key tiles consumed so far, over all items
    for (int item = blockIdx.x, n = 0; item < items;
         item += gridDim.x, ++n) {
      int qt;
      fwd_item(s, nq, item, &qt, &bh);
      q0 = qt * C::kRows;
      qa = q0 + 64 * cw + r16;
      mp = mask_rows(mask, s, bh);
      const int nk = key_tiles(s, q0, C::kRows, C::kKeys);
#pragma unroll
      for (int bx = 0; bx < C::kBoxes; ++bx)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[bx][i] = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = kNegInf;
        l[r] = 0.f;
      }
      hopper::mbar_wait(q_full, n & 1);
      if (nk == 0) hopper::mbar_arrive(q_empty);
      // one key tile; the first issues no PV product. Branches on data
      // stay outside the spans where a product is in flight (the first
      // tile's is a compile-time one), or ptxas serializes the products.
      auto step = [&](int kt, auto first) {
        const int st = g % C::kStages;
        const int pst = (g + C::kStages - 1) % C::kStages;
        hopper::mbar_wait(&k_full[st], (g / C::kStages) & 1);
        if constexpr (!decltype(first)::value)
          hopper::mbar_wait(&v_full[pst], ((g - 1) / C::kStages) & 1);
        hopper::wgmma_fence();
        issue_s(st);
        if constexpr (decltype(first)::value) {
          hopper::wgmma_wait<0>();
        } else {
          issue_pv(pst);
          hopper::wgmma_wait<1>();
        }
        hopper::fence_regs(sc);
        softmax(kt);
        if constexpr (!decltype(first)::value) {
          hopper::wgmma_wait<0>();
#pragma unroll
          for (int bx = 0; bx < C::kBoxes; ++bx) hopper::fence_regs(acc[bx]);
#pragma unroll
          for (int kk = 0; kk < C::kKeys / 16; ++kk)
            hopper::fence_regs(pa[kk]);
          hopper::mbar_arrive(&empty[pst]);
        }
#pragma unroll
        for (int bx = 0; bx < C::kBoxes; ++bx)
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[bx][i] *= alpha[(i >> 1) & 1];
#pragma unroll
        for (int kk = 0; kk < C::kKeys / 16; ++kk)
          hopper::pack_a(sc, kk, pa[kk]);
        if (kt == nk - 1) hopper::mbar_arrive(q_empty);  // S read Q last
        ++g;
      };
      if (nk > 0) step(0, std::true_type{});
      for (int kt = 1; kt < nk; ++kt) step(kt, std::false_type{});
      if (nk > 0) {
        const int pst = (g - 1) % C::kStages;
        hopper::mbar_wait(&v_full[pst], ((g - 1) / C::kStages) & 1);
        hopper::wgmma_fence();
        issue_pv(pst);
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int bx = 0; bx < C::kBoxes; ++bx) hopper::fence_regs(acc[bx]);
        hopper::mbar_arrive(&empty[pst]);
      }

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = qa + 8 * r;
        if (qi >= s.Sq) continue;
        const float lsafe = l[r] == 0.f ? 1.f : l[r];  // dead rows -> 0
        const size_t row = static_cast<size_t>(bh) * s.Sq + qi;
#pragma unroll
        for (int bx = 0; bx < C::kBoxes; ++bx)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(o + row * D + 64 * bx +
                                               8 * j + c2) =
                __floats2bfloat162_rn(acc[bx][4 * j + 2 * r] / lsafe,
                                      acc[bx][4 * j + 2 * r + 1] / lsafe);
        if (lane % 4 == 0)
          lse[row] =
              l[r] > 0.f ? m[r] * s.scale + logf(lsafe) : INFINITY;
      }
    }
  }
}


// K7. One block owns one (batch*q-head, 128-key tile); each consumer
// warpgroup owns 64 of the keys, keeps their K and V in shared memory for
// the whole sweep and dK, dV in registers. The producer streams 64-row Q
// and dO tiles (TMA) and their lse and delta rows (plain loads by its first
// warp: a (B, H, Sq) f32 row is 16-byte aligned only when Sq % 4 == 0, which
// a bulk copy needs) through a two-stage ring. Per q tile a consumer takes
// the five products of the TPU kernel, all on wgmma:
//   S^T = K Q^T and dP^T = V dO^T (both operands from shared memory);
//   P^T = exp(S^T scale - lse) and dS^T = round(P^T (dP^T - delta) scale)
//   on the fragments; dV += round(P^T) dO and dK += dS^T Q with the left
//   side from registers; dS^T stored to shared memory as bf16, then
//   dQ = dS K with dS read M-contiguous.
// The consumer's f32 64 x D dQ tile goes to shared memory row-major, and
// one bulk reduce-add (cp.reduce.async.bulk ... add.f32) adds it into
// dq_acc, where the SIMT body issues 64 D scalar atomicAdds; the order in
// which blocks add differs from run to run, and with it dQ's low bits. Key
// tiles are the grid's slow axis, so the heaviest causal blocks (the first
// keys, seen by every q tile) of all heads run in the first wave.
// K6 is this kernel with kDq = false: four products a q tile, and no dS^T
// store, dQ product, dQ tile, bulk reduce-add or dq_acc (48 KiB less
// shared memory at D = 64). Issuing the next q tile's S^T and dP^T beside
// this tile's dV and dK products (K4's order) spilled and serialized the
// products, much slower on the card; a third stage gained nothing. With
// Sq = 0 (no map of 0 rows) the C entry writes dK = dV = 0.
template <int D, bool kDq>
struct BwdTiles {
  static constexpr int kBoxes = D / 64;
  static constexpr int kKeys = 128;     // keys of a block, 64 per consumer
  static constexpr int kRows = 64;      // q rows of a streamed tile
  static constexpr int kStages = 2;
  static constexpr int kKVBytes = kBoxes * kKeys * 128;   // K or V
  static constexpr int kQBytes = kBoxes * kRows * 128;    // Q or dO tile
  static constexpr int kDSBytes = kDq ? 64 * 128 : 0;     // dS^T, bf16
  static constexpr int kDQBytes = kDq ? kRows * D * 4 : 0;  // dQ tile, f32
  static constexpr int kSmem = 1024 + 2 * kKVBytes + 2 * kStages * kQBytes +
                               2 * kDSBytes + 2 * kDQBytes +
                               kStages * 2 * kRows * 4 + 8 * (1 + 2 * kStages);
};

template <int D, bool kDq>
__global__ void __launch_bounds__(kWgBlock, 1)
    flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const int8_t* __restrict__ mask,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq_acc,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, const Shape s) {
  using C = BwdTiles<D, kDq>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = hopper::align_1024(smem_raw);
  uint8_t* vs = ks + C::kKVBytes;
  uint8_t* qs = vs + C::kKVBytes;                  // stages of Q
  uint8_t* dos = qs + C::kStages * C::kQBytes;     // stages of dO
  uint8_t* dss = dos + C::kStages * C::kQBytes;    // dS^T per consumer
  float* dqs = reinterpret_cast<float*>(dss + 2 * C::kDSBytes);
  float* stats = dqs + 2 * C::kDQBytes / 4;        // per stage: lse, delta
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + C::kStages * 2 *
                                                  C::kRows);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + C::kStages;

  const int bh = blockIdx.x;  // key tiles on the slow axis (see above)
  const int b = bh / s.H;
  const int bkv = b * s.HKV + (bh % s.H) / s.g;
  const int k0 = blockIdx.y * C::kKeys;
  // the q tiles that can see this key tile: causal rows below k0 - off see
  // none of its keys (with Sq < Skv a trailing key tile may see no q tile)
  const int nq = (s.Sq + C::kRows - 1) / C::kRows;
  const int qt0 = s.causal && k0 - s.off > 0 ? (k0 - s.off) / C::kRows : 0;
  const int iters = nq > qt0 ? nq - qt0 : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int i = 0; i < C::kStages; ++i) {
      hopper::mbar_init(&full[i], 32);  // the producer's first warp
      hopper::mbar_init(&empty[i], 8);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == 0) {  // ------------------------------------------- producer --
    hopper::regs_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(kv_full, 2 * C::kKVBytes);
        for (int bx = 0; bx < C::kBoxes; ++bx) {
          hopper::tma_load_3d(ks + bx * C::kKeys * 128, &tk, kv_full,
                              64 * bx, k0, bkv);
          hopper::tma_load_3d(vs + bx * C::kKeys * 128, &tv, kv_full,
                              64 * bx, k0, bkv);
        }
      }
      const float* lsep = lse + static_cast<size_t>(bh) * s.Sq;
      const float* deltap = delta + static_cast<size_t>(bh) * s.Sq;
      for (int it = 0; it < iters; ++it) {
        const int st = it % C::kStages;
        const int q0 = (qt0 + it) * C::kRows;
        hopper::mbar_wait(&empty[st], ((it / C::kStages) & 1) ^ 1);
        if (lane == 0) {
          hopper::mbar_expect_tx(&full[st], 2 * C::kQBytes);
          for (int bx = 0; bx < C::kBoxes; ++bx) {
            hopper::tma_load_3d(qs + st * C::kQBytes + bx * kBox, &tq,
                                &full[st], 64 * bx, q0, bh);
            hopper::tma_load_3d(dos + st * C::kQBytes + bx * kBox, &tdo,
                                &full[st], 64 * bx, q0, bh);
          }
        }
        // padding rows: lse +inf makes their p exactly 0
        float* ls = stats + st * 2 * C::kRows;
        for (int i = lane; i < C::kRows; i += 32) {
          const bool in = q0 + i < s.Sq;
          ls[i] = in ? lsep[q0 + i] : INFINITY;
          ls[C::kRows + i] = in ? deltap[q0 + i] : 0.f;
        }
        hopper::mbar_arrive(&full[st]);
      }
    }
  } else {  // ---------------------------------------------- consumers --
    hopper::regs_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int t = threadIdx.x % kWg;
    const int lane = t % 32;
    const int r16 = 16 * (t / 32) + lane / 4;  // fragment rows r16, r16 + 8
    const int c2 = 2 * (lane % 4);
    const int kb = k0 + 64 * cw;               // this warpgroup's first key
    const int8_t* mp = mask_rows(mask, s, bh);
    uint8_t* my_ds = dss + cw * C::kDSBytes;
    float* my_dq = dqs + cw * C::kRows * D;

    float dk_acc[C::kBoxes][32], dv_acc[C::kBoxes][32];
#pragma unroll
    for (int bx = 0; bx < C::kBoxes; ++bx)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        dk_acc[bx][i] = 0.f;
        dv_acc[bx][i] = 0.f;
      }

    hopper::mbar_wait(kv_full, 0);
    for (int it = 0; it < iters; ++it) {
      const int st = it % C::kStages;
      const int q0 = (qt0 + it) * C::kRows;
      hopper::mbar_wait(&full[st], (it / C::kStages) & 1);
      const uint8_t* qst = qs + st * C::kQBytes;
      const uint8_t* dost = dos + st * C::kQBytes;
      const float* ls = stats + st * 2 * C::kRows;

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 q rows each
      float sc[32], dp[32];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int bx = kk / 4;
        const int koff = bx * C::kKeys * 128 + cw * kBox + (kk % 4) * 32;
        const int qoff = bx * kBox + (kk % 4) * 32;
        hopper::wgmma_ss_n64<0, 0>(sc, hopper::sw128_desc(ks + koff, false),
                                   hopper::sw128_desc(qst + qoff, false),
                                   kk > 0);
        hopper::wgmma_ss_n64<0, 0>(dp, hopper::sw128_desc(vs + koff, false),
                                   hopper::sw128_desc(dost + qoff, false),
                                   kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);

      // P^T and dS^T on the fragments: row = key, column = q row
      const bool all_live = mp == nullptr && kb + 64 <= s.Skv &&
                            (!s.causal || s.off + q0 >= kb + 63);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 lj = *reinterpret_cast<const float2*>(ls + 8 * j + c2);
        const float2 dj =
            *reinterpret_cast<const float2*>(ls + C::kRows + 8 * j + c2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const float lv = (e & 1) ? lj.y : lj.x;
          const float dv_ = (e & 1) ? dj.y : dj.x;
          float p = exp2f((sc[i] * s.scale - lv) * kLog2e);
          if (!all_live &&
              !is_live(s, mp, q0 + 8 * j + c2 + (e & 1),
                       kb + r16 + hopper::acc_row(i)))
            p = 0.f;
          sc[i] = p;
          dp[i] = p * (dp[i] - dv_) * s.scale;
        }
      }
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hopper::pack_a(sc, kk, pa[kk]);
        hopper::pack_a(dp, kk, da[kk]);
      }
      // dV += round(P^T) dO and dK += dS^T Q, dO and Q read N-contiguous
      hopper::wgmma_fence();
#pragma unroll
      for (int bx = 0; bx < C::kBoxes; ++bx)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int off = bx * kBox + kk * 16 * 128;
          hopper::wgmma_rs_n64<1>(dv_acc[bx], pa[kk],
                                  hopper::sw128_desc(dost + off, true), 1);
          hopper::wgmma_rs_n64<1>(dk_acc[bx], da[kk],
                                  hopper::sw128_desc(qst + off, true), 1);
        }
      hopper::wgmma_commit();

      if constexpr (kDq) {
        // dS^T to shared memory, rows = keys, 128-byte swizzle; its
        // 16-column slice kk of A-fragment pairs: (r16, 16 kk + c2),
        // (r16 + 8, ...), (r16, 16 kk + 8 + c2), (r16 + 8, ...)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = r16 + 8 * (j & 1);
            const int c = 16 * kk + 8 * (j >> 1) + c2;
            *reinterpret_cast<uint32_t*>(my_ds + hopper::sw128_offset(r, c)) =
                da[kk][j];
          }
        if (t == 0) hopper::bulk_wait_read();  // the last dQ tile was read
        hopper::fence_proxy_async();
        hopper::named_sync(1 + cw, kWg);
      }
      hopper::wgmma_wait();
#pragma unroll
      for (int bx = 0; bx < C::kBoxes; ++bx) {
        hopper::fence_regs(dv_acc[bx]);
        hopper::fence_regs(dk_acc[bx]);
      }
      if (lane == 0) hopper::mbar_arrive(&empty[st]);
      if constexpr (kDq) {
        // dQ = dS K over this warpgroup's 64 keys: dS read M-contiguous from
        // its transpose, K N-contiguous; 64 columns at a time
#pragma unroll
        for (int bx = 0; bx < C::kBoxes; ++bx) {
          float dq[32];
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hopper::wgmma_ss_n64<1, 1>(
                dq, hopper::sw128_desc(my_ds + kk * 16 * 128, true),
                hopper::sw128_desc(ks + bx * C::kKeys * 128 + cw * kBox +
                                       kk * 16 * 128,
                                   true),
                kk > 0);
          hopper::wgmma_commit();
          hopper::wgmma_wait();
          hopper::fence_regs(dq);
#pragma unroll
          for (int i = 0; i < 32; i += 2)
            *reinterpret_cast<float2*>(my_dq + (r16 + hopper::acc_row(i)) * D +
                                       64 * bx + hopper::acc_col(i) + c2) =
                make_float2(dq[i], dq[i + 1]);
        }
        hopper::fence_proxy_async();
        hopper::named_sync(1 + cw, kWg);
        if (t == 0) {
          const int rows = min(C::kRows, s.Sq - q0);
          hopper::bulk_reduce_add_f32(
              dq_acc + (static_cast<size_t>(bh) * s.Sq + q0) * D, my_dq,
              static_cast<uint32_t>(rows * D * 4));
          hopper::bulk_commit();
        }
      }
    }
    if (kDq && t == 0) hopper::bulk_wait();

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kj = kb + r16 + 8 * r;
      if (kj >= s.Skv) continue;
      const size_t row = static_cast<size_t>(bh) * s.Skv + kj;
#pragma unroll
      for (int bx = 0; bx < C::kBoxes; ++bx)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int i = 4 * j + 2 * r;
          const size_t at = row * D + 64 * bx + 8 * j + c2;
          *reinterpret_cast<__nv_bfloat162*>(dk + at) =
              __floats2bfloat162_rn(dk_acc[bx][i], dk_acc[bx][i + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dv + at) =
              __floats2bfloat162_rn(dv_acc[bx][i], dv_acc[bx][i + 1]);
        }
    }
  }
}

// K5. K4's persistent grid and producer with K7's products: block i takes
// the work items (batch*q-head, 128-row q tile) i, i + grid, ..., heaviest
// causal tiles first (fwd_item). The producer loads an item's Q and dO
// tiles once and streams its key tiles (K and V on barriers of their own)
// through a three-stage ring, running ahead into the next item. Each
// consumer warpgroup owns 64 q rows, holds their lse and delta in
// registers (plain loads: a (B, H, Sq) f32 row is 16-byte aligned only
// when Sq % 4 == 0) and, per key tile:
//   S = Q K^T and dP = dO V^T, both operands from shared memory, S in a
//   group of its own so that p = exp(S scale - lse) is computed while dP
//   is in flight; ds = round(p (dP - delta) scale) on the fragments,
//   packed into A fragments; dQ += ds K with K read MN-major.
// dQ stays in registers in f32 and is written once in bf16: no atomics,
// the same bits on every run. Key tiles are 128 keys at D = 64 and 64 at
// D = 128, where 128 would hold S, dP (64 registers each) and dQ (64)
// at once and spill. Where it could break, and what the design does:
//   * registers: S, dP (kKeys / 2 each), dQ (D / 2) and the packed ds;
//     ptxas reports no spill at either D. Issuing the next tile's S (and
//     dP) beside this tile's dQ product, K4's order, was no faster on the
//     card; the third stage and p as one fma and exp2 were.
//   * ragged edges: the 3-D maps zero-fill rows past Sq and Skv within a
//     head; is_live drops keys past Skv, above the causal diagonal (off +
//     row, element by element: Sq < Skv with kv_offset, the diagonal
//     inside a 128-row item) and where the int8 mask is 0, read at size_t
//     offsets; padding rows take lse = +inf.
//   * dead rows (lse = +inf): p = exp2(-inf) = 0, so ds = 0 and their dQ
//     is exactly 0.
//   * empty lengths: a map cannot have 0 rows; the C entry writes dQ = 0
//     when Skv = 0 and launches nothing when Sq = 0.
//   * TMA bases: the wrapper refuses q, k, v and dO that do not start on a
//     16-byte boundary.
//   * GQA: a q head h reads kv head h / g through the map's head index; the
//     shared heads are never copied.
template <int D>
struct DqTiles {
  static constexpr int kBoxes = D / 64;
  static constexpr int kRows = 128;             // q rows of an item
  static constexpr int kKeys = D == 64 ? 128 : 64;  // keys of a tile
  static constexpr int kStages = 3;
  static constexpr int kQBytes = kBoxes * kRows * 128;   // Q or dO
  static constexpr int kKVBytes = kBoxes * kKeys * 128;  // K or V tile
  static constexpr int kSmem =
      1024 + 2 * kQBytes + 2 * kStages * kKVBytes + 8 * (2 + 3 * kStages);
};

// D (64 x N, f32) += A (64 x 16) B (16 x N), both K-major from shared
// memory, N = 64 or 128
template <int N>
__device__ __forceinline__ void wgmma_ss_k(float (&d)[N / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  if constexpr (N == 128) {
    hopper::wgmma_ss_n128<0, 0>(d, da, db, scale_d);
  } else {
    hopper::wgmma_ss_n64<0, 0>(d, da, db, scale_d);
  }
}

template <int D>
__global__ void __launch_bounds__(kWgBlock, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const int8_t* __restrict__ mask,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq,
                              const Shape s) {
  using C = DqTiles<D>;
  constexpr int kN = C::kKeys / 2;   // accumulator registers of S or dP
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = hopper::align_1024(smem_raw);
  uint8_t* dos = qs + C::kQBytes;
  uint8_t* ks = dos + C::kQBytes;
  uint8_t* vs = ks + C::kStages * C::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + C::kStages *
                                                 C::kKVBytes);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;
  uint64_t* v_full = k_full + C::kStages;
  uint64_t* empty = v_full + C::kStages;

  const int nq = (s.Sq + C::kRows - 1) / C::kRows;
  const int items = nq * s.B * s.H;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, 2 * kWg);  // every consumer thread
    for (int i = 0; i < C::kStages; ++i) {
      hopper::mbar_init(&k_full[i], 1);
      hopper::mbar_init(&v_full[i], 1);
      hopper::mbar_init(&empty[i], 2 * kWg);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == 0) {  // ------------------------------------------- producer --
    hopper::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int g = 0;  // key tiles loaded so far, over all items
      for (int item = blockIdx.x, n = 0; item < items;
           item += gridDim.x, ++n) {
        int qt, bh;
        fwd_item(s, nq, item, &qt, &bh);
        const int bkv = (bh / s.H) * s.HKV + (bh % s.H) / s.g;
        const int q0 = qt * C::kRows;
        hopper::mbar_wait(q_empty, (n & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(q_full, 2 * C::kQBytes);
        for (int bx = 0; bx < C::kBoxes; ++bx) {
          hopper::tma_load_3d(qs + bx * C::kRows * 128, &tq, q_full, 64 * bx,
                              q0, bh);
          hopper::tma_load_3d(dos + bx * C::kRows * 128, &tdo, q_full,
                              64 * bx, q0, bh);
        }
        const int nk = key_tiles(s, q0, C::kRows, C::kKeys);
        for (int kt = 0; kt < nk; ++kt, ++g) {
          const int st = g % C::kStages;
          hopper::mbar_wait(&empty[st], ((g / C::kStages) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&k_full[st], C::kKVBytes);
          for (int bx = 0; bx < C::kBoxes; ++bx)
            hopper::tma_load_3d(ks + st * C::kKVBytes + bx * C::kKeys * 128,
                                &tk, &k_full[st], 64 * bx, kt * C::kKeys,
                                bkv);
          hopper::mbar_arrive_expect_tx(&v_full[st], C::kKVBytes);
          for (int bx = 0; bx < C::kBoxes; ++bx)
            hopper::tma_load_3d(vs + st * C::kKVBytes + bx * C::kKeys * 128,
                                &tv, &v_full[st], 64 * bx, kt * C::kKeys,
                                bkv);
        }
      }
    }
  } else {  // ---------------------------------------------- consumers --
    hopper::regs_inc<kConsumerRegs>();
    const int cw = wg - 1;  // rows 64 cw .. 64 cw + 63 of an item
    const int t = threadIdx.x % kWg;
    const int lane = t % 32;
    const int r16 = 16 * (t / 32) + lane / 4;  // fragment rows r16, r16 + 8
    const int c2 = 2 * (lane % 4);
    const float c = s.scale * kLog2e;  // p = exp2(S c - lse log2(e))

    float acc[C::kBoxes][32];   // dQ: 64 rows x D
    float sc[kN], dp[kN];       // S and dP of a tile: 64 rows x kKeys
    uint32_t da[C::kKeys / 16][4];  // round(ds) as A fragments

    int g = 0;  // key tiles consumed so far, over all items
    for (int item = blockIdx.x, n = 0; item < items;
         item += gridDim.x, ++n) {
      int qt, bh;
      fwd_item(s, nq, item, &qt, &bh);
      const int q0 = qt * C::kRows;
      const int qa = q0 + 64 * cw + r16;
      const int8_t* mp = mask_rows(mask, s, bh);
      const int nk = key_tiles(s, q0, C::kRows, C::kKeys);
      // lse and delta of rows qa, qa + 8; +inf on padding rows makes their
      // p exactly 0
      float lr[2], dr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool in = qa + 8 * r < s.Sq;
        const size_t row = static_cast<size_t>(bh) * s.Sq + qa + 8 * r;
        lr[r] = in ? lse[row] * kLog2e : INFINITY;
        dr[r] = in ? delta[row] : 0.f;
      }
#pragma unroll
      for (int bx = 0; bx < C::kBoxes; ++bx)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[bx][i] = 0.f;
      hopper::mbar_wait(q_full, n & 1);
      if (nk == 0) hopper::mbar_arrive(q_empty);

      for (int kt = 0; kt < nk; ++kt, ++g) {
        const int st = g % C::kStages;
        const int k0 = kt * C::kKeys;
        const uint8_t* kst = ks + st * C::kKVBytes;
        const uint8_t* vst = vs + st * C::kKVBytes;
        hopper::mbar_wait(&k_full[st], (g / C::kStages) & 1);
        hopper::mbar_wait(&v_full[st], (g / C::kStages) & 1);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int qoff = (kk / 4) * C::kRows * 128 + cw * kBox +
                           (kk % 4) * 32;
          const int koff = (kk / 4) * C::kKeys * 128 + (kk % 4) * 32;
          wgmma_ss_k<C::kKeys>(sc, hopper::sw128_desc(qs + qoff, false),
                               hopper::sw128_desc(kst + koff, false),
                               kk > 0);
        }
        hopper::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int qoff = (kk / 4) * C::kRows * 128 + cw * kBox +
                           (kk % 4) * 32;
          const int koff = (kk / 4) * C::kKeys * 128 + (kk % 4) * 32;
          wgmma_ss_k<C::kKeys>(dp, hopper::sw128_desc(dos + qoff, false),
                               hopper::sw128_desc(vst + koff, false),
                               kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        hopper::fence_regs(sc);

        // p on the fragments: row qa + acc_row(i), key k0 + acc_col(i) + c2
        const bool all_live =
            mp == nullptr && k0 + C::kKeys <= s.Skv &&
            (!s.causal || s.off + q0 + 64 * cw >= k0 + C::kKeys - 1);
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          float p = exp2f(fmaf(sc[i], c, -lr[(i >> 1) & 1]));
          if (!all_live &&
              !is_live(s, mp, qa + hopper::acc_row(i),
                       k0 + hopper::acc_col(i) + c2))
            p = 0.f;
          sc[i] = p;
        }
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dp);
        if (kt == nk - 1) hopper::mbar_arrive(q_empty);  // Q, dO read last
#pragma unroll
        for (int i = 0; i < kN; ++i)
          dp[i] = sc[i] * (dp[i] - dr[(i >> 1) & 1]) * s.scale;
#pragma unroll
        for (int kk = 0; kk < C::kKeys / 16; ++kk)
          hopper::pack_a(dp, kk, da[kk]);

        // dQ += round(ds) K, K read N-contiguous
        hopper::wgmma_fence();
#pragma unroll
        for (int bx = 0; bx < C::kBoxes; ++bx)
#pragma unroll
          for (int kk = 0; kk < C::kKeys / 16; ++kk)
            hopper::wgmma_rs_n64<1>(
                acc[bx], da[kk],
                hopper::sw128_desc(kst + bx * C::kKeys * 128 + kk * 16 * 128,
                                   true),
                1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int bx = 0; bx < C::kBoxes; ++bx) hopper::fence_regs(acc[bx]);
#pragma unroll
        for (int kk = 0; kk < C::kKeys / 16; ++kk) hopper::fence_regs(da[kk]);
        hopper::mbar_arrive(&empty[st]);
      }

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = qa + 8 * r;
        if (qi >= s.Sq) continue;
        const size_t row = static_cast<size_t>(bh) * s.Sq + qi;
#pragma unroll
        for (int bx = 0; bx < C::kBoxes; ++bx)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(dq + row * D + 64 * bx +
                                               8 * j + c2) =
                __floats2bfloat162_rn(acc[bx][4 * j + 2 * r],
                                      acc[bx][4 * j + 2 * r + 1]);
      }
    }
  }
}

// ----------------------------------------------------------------- launch --

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// fn(T{}, std::integral_constant<int, D>{}) for the entry's dtype and D
template <typename Fn>
cudaError_t dispatch(int dtype, int D, Fn fn) {
  using D64 = std::integral_constant<int, 64>;
  using D128 = std::integral_constant<int, 128>;
  if (dtype == 0) return D == 64 ? fn(float{}, D64{}) : fn(float{}, D128{});
  return D == 64 ? fn(__nv_bfloat16{}, D64{}) : fn(__nv_bfloat16{}, D128{});
}

// the number of SMs of the current device: the size of a persistent grid
cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

// the bf16 forward on wgmma (K4's tensor-core body)
template <int D>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v,
                             const void* mask, void* o, float* lse,
                             const Shape& s, cudaStream_t st) {
  using C = FwdTiles<D>;
  // Skv == 0: no key tile is read (every row is dead: O = 0, lse = +inf),
  // but a map needs a row and an aligned base
  const int kv_rows = max(s.Skv, 1);
  if (s.Skv == 0) k = v = q;
  CUtensorMap tq, tk, tv;
  cudaError_t e =
      hopper_host::bf16_rows_map(&tq, q, s.B * s.H, s.Sq, D, C::kRows);
  if (e == cudaSuccess)
    e = hopper_host::bf16_rows_map(&tk, k, s.B * s.HKV, kv_rows, D, C::kKeys);
  if (e == cudaSuccess)
    e = hopper_host::bf16_rows_map(&tv, v, s.B * s.HKV, kv_rows, D, C::kKeys);
  if (e != cudaSuccess) return e;
  auto kernel = flash_fwd_wgmma_kernel<D>;
  e = allow_smem(kernel, C::kSmem);
  if (e != cudaSuccess) return e;
  int sms = 0;
  e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const int items = (s.Sq + C::kRows - 1) / C::kRows * s.B * s.H;
  kernel<<<min(items, sms), kWgBlock, C::kSmem, st>>>(
      tq, tk, tv, static_cast<const int8_t*>(mask),
      static_cast<__nv_bfloat16*>(o), lse, s);
  return cudaGetLastError();
}

// K4: bf16 on the tensor cores, f32 on the SIMT body
template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* mask, void* o, float* lse, const Shape& s,
                       cudaStream_t st) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_fwd_wgmma<D>(q, k, v, mask, o, lse, s, st);
  } else {
    const size_t smem = sizeof(float) * (2 * kTile * (D + 1) + kTile * D +
                                         kTile * (kTile + 1));
    auto kernel = flash_fwd_kernel<T, D>;
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((s.Sq + kTile - 1) / kTile, s.B * s.H);
    kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int8_t*>(mask),
        static_cast<T*>(o), lse, s);
    return cudaGetLastError();
  }
}

// the delta pre-pass of every backward
template <typename T, int D>
cudaError_t launch_delta(const void* o, const void* dout, float* delta,
                         const Shape& s, cudaStream_t st) {
  const int rows = s.B * s.H * s.Sq;
  constexpr int kRowsPerBlock = 8;  // warps of the delta pre-pass
  if (rows == 0) return cudaSuccess;
  flash_delta_kernel<T, D><<<(rows + kRowsPerBlock - 1) / kRowsPerBlock,
                             kRowsPerBlock * 32, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows);
  return cudaGetLastError();
}

// the bf16 backward of K7 (kDq: dQ into dq_acc) or K6 on wgmma, after the
// delta pre-pass
template <int D, bool kDq>
cudaError_t launch_bwd_wgmma(const void* q, const void* k, const void* v,
                             const void* mask, const void* dout,
                             const float* lse, const float* delta,
                             float* dq_acc, void* dk, void* dv,
                             const Shape& s, cudaStream_t st) {
  using C = BwdTiles<D, kDq>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t e =
      hopper_host::bf16_rows_map(&tq, q, s.B * s.H, s.Sq, D, C::kRows);
  if (e == cudaSuccess)
    e = hopper_host::bf16_rows_map(&tdo, dout, s.B * s.H, s.Sq, D, C::kRows);
  if (e == cudaSuccess)
    e = hopper_host::bf16_rows_map(&tk, k, s.B * s.HKV, s.Skv, D, C::kKeys);
  if (e == cudaSuccess)
    e = hopper_host::bf16_rows_map(&tv, v, s.B * s.HKV, s.Skv, D, C::kKeys);
  if (e != cudaSuccess) return e;
  auto kernel = flash_bwd_wgmma_kernel<D, kDq>;
  e = allow_smem(kernel, C::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid(s.B * s.H, (s.Skv + C::kKeys - 1) / C::kKeys);
  kernel<<<grid, kWgBlock, C::kSmem, st>>>(
      tq, tk, tv, tdo, static_cast<const int8_t*>(mask), lse, delta, dq_acc,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), s);
  return cudaGetLastError();
}

// K7 (dq_acc given) or K6 (dq_acc null), after the delta pre-pass; bf16 on
// the tensor cores, f32 on the SIMT body
template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* mask, const void* o, const void* dout,
                       const float* lse, float* delta, float* dq_acc, void* dk,
                       void* dv, const Shape& s, cudaStream_t st) {
  cudaError_t e = launch_delta<T, D>(o, dout, delta, s, st);
  if (e != cudaSuccess) return e;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (dq_acc != nullptr)
      return launch_bwd_wgmma<D, true>(q, k, v, mask, dout, lse, delta,
                                       dq_acc, dk, dv, s, st);
    return launch_bwd_wgmma<D, false>(q, k, v, mask, dout, lse, delta,
                                      nullptr, dk, dv, s, st);
  } else {
    auto kernel = dq_acc != nullptr ? &flash_bwd_kernel<T, D, true>
                                    : &flash_bwd_kernel<T, D, false>;
    const size_t smem = sizeof(float) * (4 * kTile * (D + 1) +
                                         2 * kTile * (kTile + 1) + 2 * kTile);
    e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((s.Skv + kTile - 1) / kTile, s.B * s.H);
    kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int8_t*>(mask),
        static_cast<const T*>(dout), lse, delta, dq_acc, static_cast<T*>(dk),
        static_cast<T*>(dv), s);
    return cudaGetLastError();
  }
}

// the bf16 dQ pass on wgmma (K5's tensor-core body), after the delta
// pre-pass
template <int D>
cudaError_t launch_bwd_dq_wgmma(const void* q, const void* k, const void* v,
                                const void* mask, const void* dout,
                                const float* lse, const float* delta,
                                void* dq, const Shape& s, cudaStream_t st) {
  using C = DqTiles<D>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t e =
      hopper_host::bf16_rows_map(&tq, q, s.B * s.H, s.Sq, D, C::kRows);
  if (e == cudaSuccess)
    e = hopper_host::bf16_rows_map(&tdo, dout, s.B * s.H, s.Sq, D, C::kRows);
  if (e == cudaSuccess)
    e = hopper_host::bf16_rows_map(&tk, k, s.B * s.HKV, s.Skv, D, C::kKeys);
  if (e == cudaSuccess)
    e = hopper_host::bf16_rows_map(&tv, v, s.B * s.HKV, s.Skv, D, C::kKeys);
  if (e != cudaSuccess) return e;
  auto kernel = flash_bwd_dq_wgmma_kernel<D>;
  e = allow_smem(kernel, C::kSmem);
  int sms = 0;
  if (e == cudaSuccess) e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const int items = (s.Sq + C::kRows - 1) / C::kRows * s.B * s.H;
  kernel<<<min(items, sms), kWgBlock, C::kSmem, st>>>(
      tq, tk, tv, tdo, static_cast<const int8_t*>(mask), lse, delta,
      static_cast<__nv_bfloat16*>(dq), s);
  return cudaGetLastError();
}

// K5, after the delta pre-pass; bf16 on the tensor cores, f32 on the SIMT
// body
template <typename T, int D>
cudaError_t launch_bwd_dq(const void* q, const void* k, const void* v,
                          const void* mask, const void* o, const void* dout,
                          const float* lse, float* delta, void* dq,
                          const Shape& s, cudaStream_t st) {
  cudaError_t e = launch_delta<T, D>(o, dout, delta, s, st);
  if (e != cudaSuccess) return e;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_bwd_dq_wgmma<D>(q, k, v, mask, dout, lse, delta, dq, s,
                                  st);
  } else {
    const size_t smem = sizeof(float) * (4 * kTile * (D + 1) +
                                         kTile * (kTile + 1) + 2 * kTile);
    auto kernel = flash_bwd_dq_kernel<T, D>;
    e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((s.Sq + kTile - 1) / kTile, s.B * s.H);
    kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int8_t*>(mask),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), s);
    return cudaGetLastError();
  }
}

bool make_shape(Shape* s, int B, int H, int HKV, int Sq, int Skv, int D,
                int dtype, int mask_groups, int causal, int off, float scale) {
  if ((D != 64 && D != 128) || (dtype != 0 && dtype != 1) || HKV < 1 ||
      H % HKV != 0 || B < 0 || Sq < 0 || Skv < 0)
    return false;
  if (mask_groups != 0 && mask_groups != 1 && mask_groups != B &&
      mask_groups != B * H)
    return false;
  s->B = B;
  s->H = H;
  s->HKV = HKV;
  s->Sq = Sq;
  s->Skv = Skv;
  s->g = H / HKV;
  s->mask_groups = mask_groups;
  s->causal = causal;
  s->off = off;
  s->scale = scale;
  return true;
}

size_t elem_bytes(int dtype) {
  return dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
}

// dK = dV = 0, per q head: the backward of a call with no q row, whose
// tensor maps would have no row
cudaError_t zero_dkv(void* dk, void* dv, const Shape& s, int D, int dtype,
                     cudaStream_t st) {
  const size_t bytes =
      static_cast<size_t>(s.B) * s.H * s.Skv * D * elem_bytes(dtype);
  cudaError_t e = cudaMemsetAsync(dk, 0, bytes, st);
  if (e == cudaSuccess) e = cudaMemsetAsync(dv, 0, bytes, st);
  return e;
}

}  // namespace

// C entries for ctypes. dtype: 0 = float32, 1 = bfloat16. Every pointer is a
// device pointer of a contiguous tensor (mask may be null: no mask); the
// launches go on `stream`. Each returns the cudaError_t of its launches.

// K4: o (B, H, Sq, D) in the input dtype, lse (B, H, Sq) f32.
extern "C" int tnn_flash_fwd(const void* q, const void* k, const void* v,
                             const void* mask, void* o, void* lse, int dtype,
                             int B, int H, int HKV, int Sq, int Skv, int D,
                             int mask_groups, int causal, int off, float scale,
                             void* stream) {
  Shape s;
  if (!make_shape(&s, B, H, HKV, Sq, Skv, D, dtype, mask_groups, causal, off,
                  scale))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(dispatch(dtype, D, [&](auto t, auto d) {
    return launch_fwd<decltype(t), decltype(d)::value>(
        q, k, v, mask, o, static_cast<float*>(lse), s, st);
  }));
}

// K7: dq_acc (B, H, Sq, D) f32, zeroed by the caller, receives dQ; dk and
// dv (B, H, Skv, D) per q head in the input dtype; delta (B, H, Sq) f32 is
// scratch.
extern "C" int tnn_flash_bwd(const void* q, const void* k, const void* v,
                             const void* mask, const void* o,
                             const void* dout, const void* lse, void* delta,
                             void* dq_acc, void* dk, void* dv, int dtype,
                             int B, int H, int HKV, int Sq, int Skv, int D,
                             int mask_groups, int causal, int off, float scale,
                             void* stream) {
  Shape s;
  if (!make_shape(&s, B, H, HKV, Sq, Skv, D, dtype, mask_groups, causal, off,
                  scale))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || Skv == 0) return static_cast<int>(cudaSuccess);
  if (Sq == 0)  // no q row: dK = dV = 0 (and dq_acc, empty, may be null)
    return static_cast<int>(zero_dkv(dk, dv, s, D, dtype, st));
  if (dq_acc == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(dtype, D, [&](auto t, auto d) {
    return launch_bwd<decltype(t), decltype(d)::value>(
        q, k, v, mask, o, dout, static_cast<const float*>(lse),
        static_cast<float*>(delta), static_cast<float*>(dq_acc), dk, dv, s,
        st);
  }));
}

// K5: dq (B, H, Sq, D) in the input dtype, written whole; delta (B, H, Sq)
// f32 is scratch.
extern "C" int tnn_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* mask, const void* o,
                                const void* dout, const void* lse,
                                void* delta, void* dq, int dtype, int B,
                                int H, int HKV, int Sq, int Skv, int D,
                                int mask_groups, int causal, int off,
                                float scale, void* stream) {
  Shape s;
  if (!make_shape(&s, B, H, HKV, Sq, Skv, D, dtype, mask_groups, causal, off,
                  scale))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0) return static_cast<int>(cudaSuccess);
  if (Skv == 0)  // no key: every row is dead, dQ = 0
    return static_cast<int>(cudaMemsetAsync(
        dq, 0, static_cast<size_t>(B) * H * Sq * D * elem_bytes(dtype), st));
  return static_cast<int>(dispatch(dtype, D, [&](auto t, auto d) {
    return launch_bwd_dq<decltype(t), decltype(d)::value>(
        q, k, v, mask, o, dout, static_cast<const float*>(lse),
        static_cast<float*>(delta), dq, s, st);
  }));
}

// K6: dk and dv (B, H, Skv, D) per q head in the input dtype; delta
// (B, H, Sq) f32 is scratch.
extern "C" int tnn_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* mask, const void* o,
                                 const void* dout, const void* lse,
                                 void* delta, void* dk, void* dv, int dtype,
                                 int B, int H, int HKV, int Sq, int Skv,
                                 int D, int mask_groups, int causal, int off,
                                 float scale, void* stream) {
  Shape s;
  if (!make_shape(&s, B, H, HKV, Sq, Skv, D, dtype, mask_groups, causal, off,
                  scale))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || Skv == 0) return static_cast<int>(cudaSuccess);
  if (Sq == 0)  // no q row: dK = dV = 0
    return static_cast<int>(zero_dkv(dk, dv, s, D, dtype, st));
  return static_cast<int>(dispatch(dtype, D, [&](auto t, auto d) {
    return launch_bwd<decltype(t), decltype(d)::value>(
        q, k, v, mask, o, dout, static_cast<const float*>(lse),
        static_cast<float*>(delta), nullptr, dk, dv, s, st);
  }));
}
