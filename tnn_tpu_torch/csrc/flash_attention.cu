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
//   * forward: online softmax per 64-key tile in f32, p rounded to the input
//     dtype before the PV product (the TPU kernel's p.astype(v.dtype)), f32
//     accumulation; O in the input dtype and the f32 logsumexp per row,
//     +inf on rows with no live key, whose output is exactly 0;
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
// S=32,768) every kernel is operations-bound: K5 2.47 TFLOP, K6 3.30, K7
// 4.12. This first version computes in f32 on the CUDA cores (no tensor
// cores: 67 TFLOP/s peak), so it is operations-bound far above either
// line; mma/wgmma, TMA and warp specialisation are later work.
//
// Design. The TPU grid walks kv blocks in order and carries (m, l, acc) in
// VMEM scratch; here one block of 256 threads owns one (batch*head, 64-row
// query tile) and loops over the live key tiles itself: causal tiles above
// the diagonal are neither read nor computed, and the heaviest causal tiles
// are launched first. Each thread holds a 4 x 4 piece of the 64 x 64 logit
// tile and 4 rows x D/16 dims of the accumulator; the 16 threads of a
// half-warp share a row, so row maxima and sums are half-warp shuffles.
//
// The TPU's fused backward carries a full-sequence dQ scratch across a
// SEQUENTIAL grid; CUDA blocks run in no order. Here one block owns one
// (batch*q-head, 64-key tile), keeps K_j, V_j in shared memory and dK_j, dV_j
// in registers, and walks the q tiles that can see it. K7 adds each q tile's
// dQ contribution ds K_j into an f32 (B*H, Sq, D) buffer with atomicAdd, so
// the low bits of its dQ depend on the order the blocks finish in and
// differ from run to run; K6 is the same kernel without the dQ products.
// K5 owns one (batch*q-head, 64-row q tile), as the forward does, walks the
// live key tiles (causal: up to the row tile's last live key, the TPU's
// dead-block clamp), keeps dQ in registers in f32 and writes it once: no
// atomics, the same bits on every run. dK and dV are written per q head;
// the caller sums each GQA group, as the TPU path does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

  int nk = (s.Skv + kTile - 1) / kTile;
  if (s.causal) {
    const int last = s.off + q0 + kTile - 1;  // the tile's last position
    nk = last < 0 ? 0 : min(nk, last / kTile + 1);
  }
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

  int nk = (s.Skv + kTile - 1) / kTile;
  if (s.causal) {
    const int last = s.off + q0 + kTile - 1;  // the tile's last position
    nk = last < 0 ? 0 : min(nk, last / kTile + 1);
  }
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

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* mask, void* o, float* lse, const Shape& s,
                       cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (2 * kTile * (D + 1) + kTile * D + kTile * (kTile + 1));
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

// K7 (dq_acc given) or K6 (dq_acc null), after the delta pre-pass
template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* mask, const void* o, const void* dout,
                       const float* lse, float* delta, float* dq_acc, void* dk,
                       void* dv, const Shape& s, cudaStream_t st) {
  cudaError_t e = launch_delta<T, D>(o, dout, delta, s, st);
  if (e != cudaSuccess) return e;
  const size_t smem = sizeof(float) * (4 * kTile * (D + 1) +
                                       2 * kTile * (kTile + 1) + 2 * kTile);
  auto kernel = dq_acc != nullptr ? &flash_bwd_kernel<T, D, true>
                                  : &flash_bwd_kernel<T, D, false>;
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

// K5, after the delta pre-pass
template <typename T, int D>
cudaError_t launch_bwd_dq(const void* q, const void* k, const void* v,
                          const void* mask, const void* o, const void* dout,
                          const float* lse, float* delta, void* dq,
                          const Shape& s, cudaStream_t st) {
  cudaError_t e = launch_delta<T, D>(o, dout, delta, s, st);
  if (e != cudaSuccess) return e;
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
  return static_cast<int>(dispatch(dtype, D, [&](auto t, auto d) {
    return launch_bwd<decltype(t), decltype(d)::value>(
        q, k, v, mask, o, dout, static_cast<const float*>(lse),
        static_cast<float*>(delta), nullptr, dk, dv, s, st);
  }));
}
