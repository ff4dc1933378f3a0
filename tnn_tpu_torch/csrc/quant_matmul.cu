// Weight-only int8 matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   tnn_tpu/ops/pallas/quant_matmul.py:int8_matmul (body _kernel)
// and computes what it computes: out[m, n] = (sum_k x[m, k] * q[n, k]) *
// scale[n], with x (M, K) bf16 or f32, q (N', K') int8 (the logical (K, N)
// weight stored transposed and zero-padded to multiples of 128), scale (N')
// f32, the sum in f32, the per-N scale applied once after the K sum, and the
// result cast to out's dtype (x's, or f32 for the head). int8 -> bf16 is
// exact (|q| <= 127) and a bf16 x bf16 product is exact in f32, so both
// bodies below compute the TPU kernel's sums up to their order.
//
// What bounds it on the H100: at decode-sized M the weight bytes (one byte
// per K*N; GPT-2 small's tied head is 38.6 MB, 11.5 us), at M in the
// hundreds the operations (2*M*N*K on the bf16 tensor cores).
//
// Two bodies; the caller (ops/quant_matmul.py:plan_int8_matmul) picks one
// by a fixed rule, with its tile, and this entry refuses what the
// chosen body cannot run:
//
// * the tensor-core body (bf16 x, K a positive multiple of 8, which TMA's
//   16-byte row strides need). The product is taken transposed, out^T tile
//   = W tile x^T tile, so that the weight is the wgmma A operand from
//   registers: a producer warp's TMA copies a 64-row x 64-deep int8 tile
//   (64-byte swizzle) and a tile_m-row x 64-deep bf16 x tile (128-byte
//   swizzle) into a four-stage ring; the consumer warpgroup loads the int8
//   bytes of its A fragments and widens them to bf16 in registers, so each
//   weight byte is read once as int8 and no widened copy is written back;
//   x is the B operand, K-major from shared memory. The per-N scale is a
//   per-accumulator-row multiply in the epilogue, and the stores are masked
//   (the head's f32 rows, 50257 x 4 B, are not 16-byte aligned, so no TMA
//   store). tile_m, the wgmma N, is 8 to 128, so the serving head's 8 rows
//   stream the weight at full width. Each block runs the whole K, so the
//   same bits come out on every run.
// * the SIMT body (f32 x, or bf16 x with K % 8 != 0): the TPU grid's
//   sequential K axis (an f32 VMEM accumulator carried across grid steps)
//   becomes a loop inside each block. One block of 256 threads computes a
//   64 x 64 output tile; per 32-deep K step it stages the x tile and the
//   int8 weight tile, converted to f32, in shared memory, and each thread
//   accumulates a 4 x 4 sub-tile (rows ty + 16 i, columns tx + 16 j) in
//   registers. The block masks the M, N and K edges itself.
//
// Neither body reads the weight's padding past the logical K or N.
//
// On the H100 (700 W): 64 weight rows a block (one consumer warpgroup) beat
// 128 (two) at every GPT-2 shape; a 128-row x tile beat 64 where it still
// gives half the SMs a block; K is not split: a K split (f32 partials
// summed in split order by the tile's last split) gained nothing beyond
// the noise at any GPT-2 shape, and 3 splits of proj (K = 3072) cost
// about 20%.
// ptxas (-Xptxas -v): 64 to 123 registers, no spills, no serialized
// products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

// -------------------------------------------------------------- SIMT body --

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

// ------------------------------------------------------ tensor-core body --

constexpr int kWg = 128;                   // threads of a warpgroup
constexpr int kTcThreads = kWg + 32;       // + one producer warp
constexpr int kTileN = 64;                 // weight rows of a block
constexpr int kTileK = 64;                 // K of a stage
constexpr int kStages = 4;
constexpr int kWBytes = kTileN * kTileK;   // int8 weight tile, 4 KiB

// BM x rows (the wgmma N) a block
template <int BM>
struct TcTiles {
  static constexpr int kXBytes = BM * 128;  // bf16 x tile, 64 columns
  static constexpr int kStageBytes = kWBytes + kXBytes;
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 16 * kStages;
};

// Two int8 values, bytes 2h and 2h + 1 of w (h = 0 or 1, given as the
// selector 0x7540 + 2h), as a bf16 pair (byte 2h in the low half), exactly:
// a byte with its sign bit flipped (x + 128, unsigned) becomes the low
// mantissa byte of 2^23, so the float is 2^23 + x + 128; subtracting
// 2^23 + 128 leaves x, whose float has at most 8 significant bits, so its
// top half is x's bf16.
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t w, uint32_t sel) {
  const uint32_t u = w ^ 0x80808080u;
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, sel)) -
                   8388736.f;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, sel + 1)) -
                   8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// One block: output columns (weight rows) n0 .. n0 + 63, x rows m0 .. m0 +
// BM - 1, the whole K. The consumer warpgroup widens the next chunk's A
// fragments while the tensor cores take this chunk's four products (two
// register sets; the next stage is waited for before the products are
// issued, so no branch lies between issue and wait).
template <int BM, typename TO>
__global__ void __launch_bounds__(kTcThreads)
    int8_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tw,
                             const __grid_constant__ CUtensorMap tx,
                             const float* __restrict__ scale,
                             TO* __restrict__ out, int M, int N, int K) {
  using C = TcTiles<BM>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* wsm = hopper::align_1024(smem_raw);
  uint8_t* xsm = wsm + kStages * kWBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(xsm + kStages * C::kXBytes);
  uint64_t* empty = full + kStages;

  const int n0 = blockIdx.x * kTileN;
  const int m0 = blockIdx.y * BM;
  const int nk = (K + kTileK - 1) / kTileK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 4);  // one per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == 4) {  // ---------------------------------------- producer --
    if (lane == 0) {
      for (int i = 0; i < nk; ++i) {
        const int st = i % kStages;
        const int k0 = i * kTileK;
        hopper::mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[st], C::kStageBytes);
        hopper::tma_load_2d(wsm + st * kWBytes, &tw, &full[st], k0, n0);
        hopper::tma_load_2d(xsm + st * C::kXBytes, &tx, &full[st], k0, m0);
      }
    }
    return;
  }
  // ------------------------------------------------------------ consumers --
  // Warp w holds weight rows ra = 16 w + g and ra + 8 (g = lane / 4) of
  // the A fragments: per 16-deep step s, the bf16 pairs at
  // k = 16 s + 2 c and 16 s + 8 + 2 c (c = lane % 4), that is 16-bit word c
  // and c + 4 of the row's 16-byte chunk s. A stage's rows are 64 bytes,
  // chunk s stored at s ^ ((row / 2) % 4) (TMA's 64-byte swizzle); ra and
  // ra + 8 share (row / 2) % 4 = (g / 2) % 4, and the eight rows of a warp's
  // load fall on distinct banks.
  const int g = lane / 4, c = lane % 4;
  const int ra = 16 * warp + g;
  const int swz = (g >> 1) & 3;
  const uint32_t sel = 0x7540u + 2 * (c & 1);
  const int wofs = 4 * (c >> 1);

  float acc[BM / 2];
#pragma unroll
  for (int e = 0; e < BM / 2; ++e) acc[e] = 0.f;

  using Frag = uint32_t[kTileK / 16][4];
  auto load_a = [&](Frag& a, int st) {  // stage st's A fragments, widened
    const uint8_t* wt = wsm + st * kWBytes;
#pragma unroll
    for (int s = 0; s < kTileK / 16; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows ra and ra + 8
        const uint8_t* p = wt + (ra + 8 * h) * 64 + ((s ^ swz) << 4) + wofs;
        a[s][h] = i8x2_to_bf16x2(*reinterpret_cast<const uint32_t*>(p), sel);
        a[s][2 + h] =
            i8x2_to_bf16x2(*reinterpret_cast<const uint32_t*>(p + 8), sel);
      }
    }
  };
  // chunk i's products with A from `cur`; with a next chunk, its stage is
  // waited for first and its fragments widened into `nxt` meanwhile
  auto step = [&](int i, Frag& cur, Frag& nxt, auto has_next) {
    const int st = i % kStages;
    if constexpr (decltype(has_next)::value)
      hopper::mbar_wait(&full[(i + 1) % kStages], ((i + 1) / kStages) & 1);
    hopper::wgmma_fence();
#pragma unroll
    for (int s = 0; s < kTileK / 16; ++s)
      hopper::wgmma_rs_k<BM>(
          acc, cur[s],
          hopper::sw128_desc(xsm + st * C::kXBytes + 32 * s, false), 1);
    hopper::wgmma_commit();
    if constexpr (decltype(has_next)::value) load_a(nxt, (i + 1) % kStages);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
#pragma unroll
    for (int s = 0; s < kTileK / 16; ++s) hopper::fence_regs(cur[s]);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);  // stage st read
  };
  Frag a0, a1;
  if (nk > 0) {
    hopper::mbar_wait(&full[0], 0);
    load_a(a0, 0);
  }
  int i = 0;
  for (; i + 2 < nk; i += 2) {
    step(i, a0, a1, std::true_type{});
    step(i + 1, a1, a0, std::true_type{});
  }
  if (nk - i == 2) {
    step(i, a0, a1, std::true_type{});
    step(i + 1, a1, a0, std::false_type{});
  } else if (nk - i == 1) {
    step(i, a0, a1, std::false_type{});
  }

  // accumulator element e: weight row ra + acc_row(e), x row acc_col(e) + 2c
  const int na = n0 + ra;
  const float sc[2] = {na < N ? scale[na] : 0.f,
                       na + 8 < N ? scale[na + 8] : 0.f};
#pragma unroll
  for (int e = 0; e < BM / 2; ++e) {
    const int n = na + hopper::acc_row(e);
    const int m = m0 + hopper::acc_col(e) + 2 * c;
    if (n < N && m < M)
      out[static_cast<size_t>(m) * N + n] =
          from_f32<TO>(acc[e] * sc[(e >> 1) & 1]);
  }
}

// ----------------------------------------------------------------- launch --

template <typename TX, typename TO>
cudaError_t launch_simt(const void* x, const void* q, const void* scale,
                        void* out, int M, int N, int K, int Kp,
                        cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_matmul_kernel<TX, TO><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<TO*>(out), M, N, K, Kp);
  return cudaGetLastError();
}

struct TcArgs {
  const void* x;
  const void* q;
  const float* scale;
  void* out;
  int M, N, K, Kp;
};

template <int BM, typename TO>
cudaError_t launch_tc(const TcArgs& a, cudaStream_t st) {
  using C = TcTiles<BM>;
  auto kernel = int8_matmul_wgmma_kernel<BM, TO>;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  CUtensorMap tw, tx;
  cudaError_t e = hopper_host::rows_map_2d(
      &tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.q, a.N, a.K, a.Kp, kTileK,
      kTileN, CU_TENSOR_MAP_SWIZZLE_64B);
  if (e == cudaSuccess)
    e = hopper_host::rows_map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.x,
                                 a.M, a.K, 2LL * a.K, kTileK, BM,
                                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.N + kTileN - 1) / kTileN, (a.M + BM - 1) / BM);
  kernel<<<grid, kTcThreads, C::kSmem, st>>>(
      tw, tx, a.scale, static_cast<TO*>(a.out), a.M, a.N, a.K);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t dispatch_tc(int tile_m, const TcArgs& a, cudaStream_t st) {
  switch (tile_m) {
    case 8: return launch_tc<8, TO>(a, st);
    case 16: return launch_tc<16, TO>(a, st);
    case 32: return launch_tc<32, TO>(a, st);
    case 64: return launch_tc<64, TO>(a, st);
    default: return launch_tc<128, TO>(a, st);
  }
}

}  // namespace

// C entry for ctypes. x_dtype / out_dtype: 0 = float32, 1 = bfloat16 (a
// bf16 out needs a bf16 x). x (M, K), q (N' >= N, Kp >= K) int8 with row
// stride Kp, scale (N') f32, out (M, N); all device pointers of contiguous
// tensors; the launch goes on `stream`. body 0 is the SIMT body (tiles 64 x
// 64); body 1 the tensor-core body: bf16 x, K a positive multiple of 8, Kp
// a multiple of 16, x and q 16-byte aligned, tile_m 8, 16, 32, 64 or 128.
// Returns the cudaError_t of the launch (0 = success); a request the body
// cannot run is cudaErrorInvalidValue.
extern "C" int tnn_int8_matmul(const void* x, const void* q, const void* scale,
                               void* out, int x_dtype, int out_dtype, int M,
                               int N, int K, int Kp, int body, int tile_m,
                               void* stream) {
  if (M < 0 || N < 0 || K < 0 || Kp < K || (x_dtype != 0 && x_dtype != 1) ||
      (out_dtype != 0 && out_dtype != x_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (body == 0) {
    if (tile_m != kBM) return static_cast<int>(cudaErrorInvalidValue);
  } else if (body == 1) {
    const bool tile_ok = tile_m == 8 || tile_m == 16 || tile_m == 32 ||
                         tile_m == 64 || tile_m == 128;
    if (x_dtype != 1 || K == 0 || K % 8 != 0 || Kp % 16 != 0 || !tile_ok ||
        reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(q) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0 || N == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (body == 1) {
    const TcArgs a{x, q, static_cast<const float*>(scale), out, M, N, K,
                   Kp};
    e = out_dtype == 1 ? dispatch_tc<__nv_bfloat16>(tile_m, a, st)
                       : dispatch_tc<float>(tile_m, a, st);
  } else if (x_dtype == 0) {
    e = launch_simt<float, float>(x, q, scale, out, M, N, K, Kp, st);
  } else if (out_dtype == 1) {
    e = launch_simt<__nv_bfloat16, __nv_bfloat16>(x, q, scale, out, M, N, K,
                                                  Kp, st);
  } else {
    e = launch_simt<__nv_bfloat16, float>(x, q, scale, out, M, N, K, Kp, st);
  }
  return static_cast<int>(e);
}
