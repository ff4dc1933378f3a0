// Weight-only int8 matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   tnn_tpu/ops/pallas/quant_matmul.py:int8_matmul (body _kernel)
// and computes what it computes: out[m, n] = (sum_k x[m, k] * q[n, k]) *
// scale[n], with x (M, K) bf16 or f32, q (N', K') int8 (the logical (K, N)
// weight stored transposed and zero-padded to multiples of 128), scale (N')
// f32, the sum in f32, the per-N scale applied once after the K sum, and the
// result cast to out's dtype (x's, or f32 for the head). int8 -> bf16 is
// exact (|q| <= 127), so the f32 FMAs below over x and the converted weight
// compute the TPU kernel's sums up to their order.
//
// What bounds it on the H100: at decode-sized M the weight bytes (one byte
// per K*N; GPT-2 small's tied head is 38.6 MB), at M in the hundreds the
// operations (2*M*N*K). This first version runs SIMT f32 FMAs and is far
// from either bound: its aim is to be right. Tensor cores (bf16 mma.sync
// m16n8k16 on the converted tile, or int8 wgmma) and TMA staging are later
// work.
//
// Design: the TPU grid's sequential K axis (an f32 VMEM accumulator carried
// across grid steps) becomes a loop inside each block. One block of 256
// threads computes a 64 x 64 output tile; per 32-deep K step it stages the x
// tile and the int8 weight tile, converted to f32, in shared memory, and
// each thread accumulates a 4 x 4 sub-tile (rows ty + 16 i, columns tx + 16
// j) in registers. The block masks the M, N and K edges itself: x is not
// padded, and the weight's padding is never read past the logical K.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;  // 16 x 16, each thread 4 x 4 outputs
constexpr int kSub = 4;

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
  return __float2bfloat16(x);
}

template <typename TX, typename TO>
__global__ void __launch_bounds__(kThreads)
    int8_matmul_kernel(const TX* __restrict__ x, const int8_t* __restrict__ q,
                       const float* __restrict__ scale, TO* __restrict__ out,
                       int M, int N, int K, int Kp) {
  // +1 column: the transposed stores below hit 32 distinct banks
  __shared__ float xs[kBK][kBM + 1];
  __shared__ float ws[kBK][kBN + 1];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  float acc[kSub][kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // consecutive threads read consecutive k of one row: coalesced
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK;
      const int gm = m0 + r, gk = k0 + kk;
      xs[kk][r] = (gm < M && gk < K)
                      ? to_f32(x[static_cast<size_t>(gm) * K + gk])
                      : 0.f;
    }
    for (int i = threadIdx.x; i < kBN * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK;
      const int gn = n0 + r, gk = k0 + kk;
      const size_t off = static_cast<size_t>(gn) * Kp + gk;
      ws[kk][r] = (gn < N && gk < K) ? static_cast<float>(q[off]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kSub], b[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kSub; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // the per-N scale factors out of the K sum: one multiply per output
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    const int gn = n0 + tx + 16 * j;
    if (gn >= N) continue;
    const float s = scale[gn];
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int gm = m0 + ty + 16 * i;
      if (gm < M)
        out[static_cast<size_t>(gm) * N + gn] = from_f32<TO>(acc[i][j] * s);
    }
  }
}

template <typename TX, typename TO>
cudaError_t launch(const void* x, const void* q, const void* scale, void* out,
                   int M, int N, int K, int Kp, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_matmul_kernel<TX, TO><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<TO*>(out), M, N, K, Kp);
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes. x_dtype / out_dtype: 0 = float32, 1 = bfloat16 (a
// bf16 out needs a bf16 x). x (M, K), q (N' >= N, Kp >= K) int8 with row
// stride Kp, scale (N') f32, out (M, N); all device pointers of contiguous
// tensors; the launch goes on `stream`. Returns the cudaError_t of the
// launch (0 = success).
extern "C" int tnn_int8_matmul(const void* x, const void* q, const void* scale,
                               void* out, int x_dtype, int out_dtype, int M,
                               int N, int K, int Kp, void* stream) {
  if (M < 0 || N < 0 || K < 0 || Kp < K || (x_dtype != 0 && x_dtype != 1) ||
      (out_dtype != 0 && out_dtype != x_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (x_dtype == 0) {
    e = launch<float, float>(x, q, scale, out, M, N, K, Kp, st);
  } else if (out_dtype == 1) {
    e = launch<__nv_bfloat16, __nv_bfloat16>(x, q, scale, out, M, N, K, Kp,
                                             st);
  } else {
    e = launch<__nv_bfloat16, float>(x, q, scale, out, M, N, K, Kp, st);
  }
  return static_cast<int>(e);
}
