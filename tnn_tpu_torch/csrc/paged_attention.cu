// Ragged paged attention for Hopper (sm_90a), bf16 or f32 pages.
//
// Replaces the Pallas TPU kernel
//   tnn_tpu/ops/pallas/paged_attention.py:_paged_attention_pallas / _attn_step
// and computes exactly what _attn_step computes:
//   * row b carries q_lens[b] query tokens; token t sits at absolute position
//     kv_lens[b] - q_lens[b] + t and attends causally over every earlier
//     position of the row, read through the row's block table in the pages
//     of `layer` (pages are (L, N, H_kv, bs, Dh), tables (B, nb) int32);
//   * a GQA group (g = H / H_kv query heads) shares every fetched page;
//   * pages at or past the row's live length and -1 table entries are skipped;
//   * the online softmax (m, l, acc) runs in f32, p is rounded to the page
//     dtype before the PV product (as the TPU kernel's p.astype(v.dtype)),
//     rows with l == 0 output exactly 0, and the output has q's dtype.
//
// What bounds it on the H100: bytes. A decode step at B=8, kv_len=512 on
// gpt2_small reads 8*512*12*64*2*2 B = 12.6 MB of K/V per layer launch,
// about 3.8 us at 3.35 TB/s, while its FLOPs are negligible.
//
// Design: the TPU grid's sequential page axis (whose VMEM scratch carries the
// softmax state) has no counterpart across CUDA blocks, so one thread block
// handles one (row, kv head, query tile) and loops over the row's LIVE pages
// itself, reading its own table entries (no scalar prefetch). Pages are
// staged through shared memory with 16-byte cp.async copies, up to 8 pages
// per set, double-buffered so the next set is in flight while the current
// one is computed. A block has 8 warps and a tile up to 16 query rows: each
// warp owns two rows; when the tile has fewer rows than warps (decode), the
// warps split the row's pages instead and merge their partial (m, l, acc)
// at the end. B*H_kv = 96 blocks at the decode shape above fill less than
// one wave of 132 SMs; splitting KV across blocks is the later fix, as are
// tensor-core QK/PV (mma/wgmma) and TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRowsPerWarp = 2;
constexpr int kMaxTileRows = kWarps * kMaxRowsPerWarp;
constexpr int kPagesPerSet = 8;  // pages staged per set, over all warps
// the launch splits the warps into nwr row warps x ks page groups, both
// powers of two; a tile of fewer rows than warps gives its rows a power of
// two of warps >= half its rows, so two rows per warp always suffice
static_assert((kWarps & (kWarps - 1)) == 0, "warps must be a power of two");
static_assert(kMaxRowsPerWarp >= 2, "rows per warp must be >= 2");
constexpr float kNegInf = -1e30f;  // the TPU kernel's _NEG_INF
constexpr size_t kStagingBudget = 160 * 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;        // (B, QW, H, DH)
  const void* pages_k;  // (L, N, HKV, BS, DH)
  const void* pages_v;
  const int* tables;    // (B, NB)
  const int* kv_lens;   // (B,)
  const int* q_lens;    // (B,)
  void* out;            // (B, QW, H, DH)
  int QW, H, HKV, N, BS, NB, g;
  long long layer_off;  // elements to the first page of `layer`
  float scale;
  int tile_rows;        // query rows (flattened t * g + gi) per block
  int nwr;              // warps sharing out the tile's rows
  int ks;               // warp groups splitting the pages (nwr * ks <= warps)
  int ppw;              // consecutive pages each group takes per staged set
  int lanes_per_key;    // lanes that split one key's dot product
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
  return __float2bfloat16(x);
}

// 16 bytes of page data -> f32 values
__device__ __forceinline__ void unpack16(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float* f,
                                         __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_0() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kVec = 16 / sizeof(T);       // elements per 16-byte copy
  constexpr int kRowStride = DH + kVec;      // 16-byte pad: no bank conflicts
  constexpr int kDimsPerLane = DH / 32;      // output dims each lane owns

  const int b = blockIdx.z;
  const int hk = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = p.g;
  const int r0 = blockIdx.x * p.tile_rows;
  const int tr = min(p.tile_rows, p.QW * g - r0);
  const int kv_len = p.kv_lens[b];
  const int q_len = p.q_lens[b];
  const int start = kv_len - q_len;  // absolute position of token 0

  // pages this tile needs: keys up to its last live token's position
  const int t_first = r0 / g;
  const int t_last = min((r0 + tr - 1) / g, q_len - 1);
  int npages = 0;
  if (t_last >= t_first && start + t_last >= 0) {
    npages = min((start + t_last) / p.BS + 1, p.NB);
  }

  // shared memory: the query tile in f32, then two stages of ks (K, V) pages
  float* q_s = reinterpret_cast<float*>(smem_raw);
  T* kv_s = reinterpret_cast<T*>(smem_raw + p.tile_rows * DH * sizeof(float));
  const int page_elems = p.BS * kRowStride;
  const int set_pages = p.ks * p.ppw;
  const int stage_elems = set_pages * 2 * page_elems;

  const T* q = static_cast<const T*>(p.q);
  for (int i = threadIdx.x; i < tr * DH; i += kThreads) {
    const int r = r0 + i / DH;
    const size_t off =
        ((static_cast<size_t>(b) * p.QW + r / g) * p.H + hk * g + r % g) * DH +
        i % DH;
    q_s[i] = to_f32(q[off]);
  }

  const T* pk = static_cast<const T*>(p.pages_k) + p.layer_off;
  const T* pv = static_cast<const T*>(p.pages_v) + p.layer_off;
  const int* table = p.tables + static_cast<size_t>(b) * p.NB;
  auto page_of = [&](int j) -> int {
    if (j >= npages) return -1;
    const int blk = table[j];
    return (blk >= 0 && blk < p.N) ? blk : -1;
  };
  // copy page set `set` (its set_pages pages) into stage `stage`
  auto issue = [&](int set, int stage) {
    constexpr int kChunksPerRow = DH / kVec;
    const int per_page = p.BS * kChunksPerRow;
    const int total = set_pages * 2 * per_page;
    T* base = kv_s + stage * stage_elems;
    for (int c = threadIdx.x; c < total; c += kThreads) {
      const int s = c / (2 * per_page);
      const int rem = c % (2 * per_page);
      const int kv = rem / per_page;
      const int row = (rem % per_page) / kChunksPerRow;
      const int col = (rem % kChunksPerRow) * kVec;
      const int blk = page_of(set * set_pages + s);
      if (blk < 0) continue;
      const T* src = (kv ? pv : pk) +
                     ((static_cast<size_t>(blk) * p.HKV + hk) * p.BS + row) *
                         DH +
                     col;
      cp_async16(base + (s * 2 + kv) * page_elems + row * kRowStride + col,
                 src);
    }
  };

  const int ks_id = warp / p.nwr;  // which pages of each set this warp takes
  const int rg = warp % p.nwr;     // rows rg, rg + nwr, ... of the tile
  const int L = p.lanes_per_key;
  const int key = lane / L;        // key of the page this lane scores
  const int part = lane % L;       // slice of the head dim it sums
  const int dpl = DH / L;

  float acc[kMaxRowsPerWarp][kDimsPerLane];
  float m[kMaxRowsPerWarp], l[kMaxRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kMaxRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kDimsPerLane; ++e) acc[i][e] = 0.f;
  }

  const int nsets = (npages + set_pages - 1) / set_pages;
  if (nsets > 0) issue(0, 0);
  cp_async_commit();
  for (int set = 0; set < nsets; ++set) {
    if (set + 1 < nsets) issue(set + 1, (set + 1) & 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    for (int u = 0; u < p.ppw; ++u) {
      const int slot = ks_id * p.ppw + u;
      const int j = set * set_pages + slot;
      if (ks_id < p.ks && page_of(j) >= 0) {
        const T* k_page =
            kv_s + (set & 1) * stage_elems + slot * 2 * page_elems;
        const T* v_page = k_page + page_elems;
        const int kpos0 = j * p.BS;
#pragma unroll
        for (int i = 0; i < kMaxRowsPerWarp; ++i) {
          const int rl = rg + i * p.nwr;
          if (rl >= tr) break;
          const int t = (r0 + rl) / g;
          if (t >= q_len) continue;  // padding token: output stays 0
          const int pos = start + t;
          if (pos < kpos0) continue;  // the whole page is in this row's future
          const int nvalid = min(p.BS, pos - kpos0 + 1);
          float part_dot[4] = {0.f, 0.f, 0.f, 0.f};  // short FMA chains
          if (key < nvalid) {
            const T* krow = k_page + key * kRowStride + part * dpl;
            const float* qrow = q_s + rl * DH + part * dpl;
            for (int d = 0; d < dpl; d += kVec) {
              float kf[kVec];
              unpack16(*reinterpret_cast<const uint4*>(krow + d), kf, T());
#pragma unroll
              for (int e = 0; e < kVec; ++e)
                part_dot[e % 4] += qrow[d + e] * kf[e];
            }
          }
          float dot = (part_dot[0] + part_dot[1]) + (part_dot[2] + part_dot[3]);
          for (int off = L / 2; off > 0; off >>= 1)
            dot += __shfl_xor_sync(kFull, dot, off);
          const bool valid = key < nvalid;
          const float s = valid ? dot * p.scale : kNegInf;
          float mx = s;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
          const float m_new = fmaxf(m[i], mx);
          const float pr = valid ? expf(s - m_new) : 0.f;
          float psum = part == 0 ? pr : 0.f;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            psum += __shfl_xor_sync(kFull, psum, off);
          const float alpha = expf(m[i] - m_new);
          l[i] = alpha * l[i] + psum;
          m[i] = m_new;
          const float pt = to_f32(from_f32<T>(pr));
#pragma unroll
          for (int e = 0; e < kDimsPerLane; ++e) acc[i][e] *= alpha;
#pragma unroll 4
          for (int jj = 0; jj < nvalid; ++jj) {
            const float pj = __shfl_sync(kFull, pt, jj * L);
            const T* vrow = v_page + jj * kRowStride;
#pragma unroll
            for (int e = 0; e < kDimsPerLane; ++e)
              acc[i][e] += pj * to_f32(vrow[lane + 32 * e]);
          }
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait_0();

  if (p.ks > 1) {
    // merge the page-split partials: warps ks_id > 0 park (m, l, acc) in the
    // (now idle) staging buffer, warps ks_id == 0 fold them in
    __syncthreads();
    float* red = reinterpret_cast<float*>(kv_s);
    if (ks_id > 0 && ks_id < p.ks) {
#pragma unroll
      for (int i = 0; i < kMaxRowsPerWarp; ++i) {
        const int rl = rg + i * p.nwr;
        if (rl >= tr) break;
        float* dst = red + (ks_id * p.tile_rows + rl) * (DH + 2);
#pragma unroll
        for (int e = 0; e < kDimsPerLane; ++e) dst[lane + 32 * e] = acc[i][e];
        if (lane == 0) {
          dst[DH] = m[i];
          dst[DH + 1] = l[i];
        }
      }
    }
    __syncthreads();
    if (ks_id == 0) {
#pragma unroll
      for (int i = 0; i < kMaxRowsPerWarp; ++i) {
        const int rl = rg + i * p.nwr;
        if (rl >= tr) break;
        float mm = m[i];
        for (int k = 1; k < p.ks; ++k)
          mm = fmaxf(mm, red[(k * p.tile_rows + rl) * (DH + 2) + DH]);
        const float a0 = expf(m[i] - mm);
        l[i] *= a0;
#pragma unroll
        for (int e = 0; e < kDimsPerLane; ++e) acc[i][e] *= a0;
        for (int k = 1; k < p.ks; ++k) {
          const float* src = red + (k * p.tile_rows + rl) * (DH + 2);
          const float a = expf(src[DH] - mm);
          l[i] += src[DH + 1] * a;
#pragma unroll
          for (int e = 0; e < kDimsPerLane; ++e)
            acc[i][e] += src[lane + 32 * e] * a;
        }
      }
    }
  }

  if (ks_id == 0) {
    T* out = static_cast<T*>(p.out);
#pragma unroll
    for (int i = 0; i < kMaxRowsPerWarp; ++i) {
      const int rl = rg + i * p.nwr;
      if (rl >= tr) break;
      const int r = r0 + rl;
      const float lsafe = l[i] == 0.f ? 1.f : l[i];  // dead rows -> 0
      const size_t row = (static_cast<size_t>(b) * p.QW + r / g) * p.H +
                         hk * g + r % g;
      T* dst = out + row * DH;
#pragma unroll
      for (int e = 0; e < kDimsPerLane; ++e)
        dst[lane + 32 * e] = from_f32<T>(acc[i][e] / lsafe);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const Params& p, dim3 grid, size_t smem,
                   cudaStream_t stream) {
  static size_t smem_opted_in = 48 * 1024;
  if (smem > smem_opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    smem_opted_in = smem;
  }
  paged_attention_kernel<T, DH><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes. dtype: 0 = float32, 1 = bfloat16. Every pointer is a
// device pointer of a contiguous tensor; the launch goes on `stream`.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int tnn_paged_attention(
    const void* q, const void* pages_k, const void* pages_v,
    const void* tables, const void* kv_lens, const void* q_lens, void* out,
    int dtype, int B, int QW, int H, int HKV, int DH, int N, int BS, int NB,
    int layer, float scale, void* stream) {
  if ((DH != 64 && DH != 128) || (dtype != 0 && dtype != 1) || BS < 4 ||
      BS > 32 || HKV < 1 || H % HKV != 0 || layer < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || QW == 0) return static_cast<int>(cudaSuccess);
  Params p;
  p.q = q;
  p.pages_k = pages_k;
  p.pages_v = pages_v;
  p.tables = static_cast<const int*>(tables);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.q_lens = static_cast<const int*>(q_lens);
  p.out = out;
  p.QW = QW;
  p.H = H;
  p.HKV = HKV;
  p.N = N;
  p.BS = BS;
  p.NB = NB;
  p.g = H / HKV;
  p.layer_off = static_cast<long long>(layer) * N * HKV * BS * DH;
  p.scale = scale;
  const int rows = QW * p.g;
  p.tile_rows = rows < kMaxTileRows ? rows : kMaxTileRows;
  int nwr = 1;
  while (nwr * 2 <= kWarps && nwr * 2 <= p.tile_rows) nwr *= 2;
  p.nwr = nwr;
  int bsp = 1;
  while (bsp < BS) bsp *= 2;
  p.lanes_per_key = 32 / bsp;

  const size_t elem = dtype == 0 ? 4 : 2;
  const size_t row_stride = DH + 16 / elem;
  // pages staged per set: one per idle-of-rows warp, within a 160 KB budget
  // for the two stages (f32 pages of 128 dims are 16 KB per K+V pair)
  const size_t set_page = 2 * 2 * static_cast<size_t>(BS) * row_stride * elem;
  p.ks = kWarps / nwr;
  while (p.ks > 1 && p.ks * set_page > kStagingBudget) p.ks /= 2;
  p.ppw = kPagesPerSet / p.ks > 1 ? kPagesPerSet / p.ks : 1;
  while (p.ppw > 1 && p.ks * p.ppw * set_page > kStagingBudget) p.ppw /= 2;
  const size_t staging = static_cast<size_t>(p.ks) * p.ppw * set_page;
  const size_t merge = static_cast<size_t>(p.ks) * p.tile_rows * (DH + 2) * 4;
  const size_t smem = static_cast<size_t>(p.tile_rows) * DH * 4 +
                      (staging > merge ? staging : merge);
  const dim3 grid((rows + p.tile_rows - 1) / p.tile_rows, HKV, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    e = DH == 64 ? launch<float, 64>(p, grid, smem, st)
                 : launch<float, 128>(p, grid, smem, st);
  } else {
    e = DH == 64 ? launch<__nv_bfloat16, 64>(p, grid, smem, st)
                 : launch<__nv_bfloat16, 128>(p, grid, smem, st);
  }
  return static_cast<int>(e);
}
