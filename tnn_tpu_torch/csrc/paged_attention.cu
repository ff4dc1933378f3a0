// Ragged paged attention for Hopper (sm_90a), over bf16 / f32 pages (K1) or
// int8 pages with a per-(position, head) f32 scale (K2).
//
// Replaces the Pallas TPU kernel
//   tnn_tpu/ops/pallas/paged_attention.py:_paged_attention_pallas / _attn_step
// with both of its bodies, _attn_kernel (K1) and _attn_kernel_int8 (K2), and
// computes exactly what _attn_step computes:
//   * row b carries q_lens[b] query tokens; token t sits at absolute position
//     kv_lens[b] - q_lens[b] + t and attends causally over every earlier
//     position of the row, read through the row's block table in the pages
//     of `layer` (pages are (L, N, H_kv, bs, Dh), tables (B, nb) int32);
//   * a GQA group (g = H / H_kv query heads) shares every fetched page;
//   * pages at or past the row's live length and -1 table entries are skipped;
//   * the online softmax (m, l, acc) runs in f32, p is rounded to the page
//     dtype before the PV product (as the TPU kernel's p.astype(v.dtype)),
//     rows with l == 0 output exactly 0, and the output has q's dtype.
//   * int8 pages (K2): each K/V element dequantizes to f32 as int8 * its
//     row's scale before it is used, as _attn_kernel_int8's load_kv does, so
//     QK, p (left unrounded: v is f32) and PV all run in f32.
// One templated body serves both: they differ only in the page type P, that
// is in how a page is staged and how a staged element becomes an f32 value,
// which keeps them in lockstep as _attn_step's load_kv keeps the TPU ones.
//
// K1s, the TPU kernel's stats=True form (_attn_step's m_ref / l_ref
// outputs), is the same body over either page type with two more outputs:
// given m_out / l_out (f32, (B, QW, H, 1)), every query row writes its
// final online-softmax state after the merges (the warps' page split, and
// the splits across blocks where there are several): m, the
// max of its scaled, masked scores (natural-exp domain: dot * scale, expf),
// and l, the normalizer at that max. A dead row (no live key: kv_len 0, a
// padding token past q_lens, or every block a -1 hole) writes -1e30 and 0.
// With null pointers nothing else changes. It adds 8 B of stats per
// (token, head) to K1's bytes.
//
// What bounds it on the H100: bytes. A decode step at B=8, kv_len=512 on
// gpt2_small reads 8*512*12*64*2*2 B = 12.6 MB of bf16 K/V per layer launch,
// about 3.8 us at 3.35 TB/s, while its FLOPs are negligible; int8 pages
// halve that and add 4 B of scale per (position, head) of K and of V.
//
// Design: the TPU grid's sequential page axis (whose VMEM scratch carries the
// softmax state) becomes split-KV across blocks. The grid is (query tile,
// kv head, row x split): a block takes split sp's fixed range of the row's
// table, entries [sp * pps, (sp + 1) * pps), and loops over the LIVE pages
// of that range itself, reading its own table entries (no scalar
// prefetch). The caller picks the split count from host-known shapes only
// (B, QW, H, H_kv, the table width NB and the SM count; never kv_lens), so
// the launch needs no sync. A block reads kv_lens and finds how many splits
// hold a live entry of its tile: splits past that leave at once, and a
// tile that one split holds (or none: split 0 writes its dead rows) needs
// no merge, so its block normalizes and writes the output. Otherwise each
// live split writes its partial (m, l, acc) in f32 to a workspace (B,
// splits, QW * H, DH + 2), and the last of them to arrive (an integer
// atomic on the tile's counter, which it resets to 0) merges the partials
// in split order with the same merge the block uses for its warps'
// partials (merge_partials), divides and casts: the same bits whatever the
// arrival order. A split range of only -1 holes gives the empty partial
// (-1e30, 0, 0). Each split rounds p at its own running max, as the warps'
// page split below already does.
//
// Pages are staged through shared memory with 16-byte cp.async copies, up
// to 8 pages per set, double-buffered when a split holds more than one set
// (one stage otherwise) so the next set is in flight while the current one
// is computed; int8 pages stage their scale rows (bs floats of K and of V
// per page, 16 B at bs = 4) the same way, beside the pages. A block has 8
// warps and a tile up to 16 query rows: each warp owns two rows; when the
// tile has fewer rows than warps (decode), the warps split the block's
// pages instead and merge their partial (m, l, acc) at the end. At the
// decode shape above, 8 rows x 12 kv heads made 96 blocks, less than one
// wave of 132 SMs, and the row of 1000 positions walked its 63 pages in one
// block; with splits of 8 entries (one set) it is 8 blocks. What holds the
// decode call back now is each block's chain of dependent steps (kv_lens,
// the table, the pages, the warps' merge, the count), about 4.8 us on the
// H100 with one page a row, not the bytes. Tensor-core QK / PV (mma.sync)
// for chunk rows and TMA are not used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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
  const void* pages_k;  // (L, N, HKV, BS, DH), bf16 / f32, or int8
  const void* pages_v;
  const float* scales_k;  // int8 pages: (L, N, HKV, BS, 1) f32, else null
  const float* scales_v;
  const int* tables;    // (B, NB)
  const int* kv_lens;   // (B,)
  const int* q_lens;    // (B,), or null: every row carries QW tokens
  void* out;            // (B, QW, H, DH)
  float* m_out;         // (B, QW, H, 1) f32 running max, or null (no stats)
  float* l_out;         // (B, QW, H, 1) f32 normalizer, or null
  int QW, H, HKV, N, BS, NB, g;
  long long layer_off;  // elements to the first page of `layer`
  long long layer_off_s;  // the same for the scales (layer_off / DH)
  float scale;
  int tile_rows;        // query rows (flattened t * g + gi) per block
  int nwr;              // warps sharing out the tile's rows
  int ks;               // warp groups splitting the pages (nwr * ks <= warps)
  int ppw;              // consecutive pages each group takes per staged set
  int lanes_per_key;    // lanes that split one key's dot product
  int splits;           // blocks splitting each row's table (grid z = B x)
  int pps;              // table entries a split takes
  int stages;           // staged page sets in flight: 1 or 2
  float* ws;            // splits > 1: (B, splits, QW * H, DH + 2) partials
  int* counters;        // splits > 1: one per (query tile, kv head, row), 0
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
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

// Page element types: P == the q dtype (K1), or int8_t (K2). kLoad is the
// elements one lane converts at a time in the QK loop (16 B of f32 / bf16,
// 8 B of int8, so that a lane's slice of the head dim, DH / lanes_per_key
// >= 8 elements, holds whole loads).
template <typename P>
struct Page {
  static constexpr bool kQuant = false;
  static constexpr int kLoad = 16 / sizeof(P);
};
template <>
struct Page<int8_t> {
  static constexpr bool kQuant = true;
  static constexpr int kLoad = 8;
};

// kLoad page elements from shared memory -> f32 values
__device__ __forceinline__ void load_vec(const float* src, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* src, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void load_vec(const int8_t* src, float* f) {
  const int2 u = *reinterpret_cast<const int2*>(src);
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // byte i of each word, sign-extended
    const int sh = 24 - 8 * i;
    f[i] = static_cast<float>(
        static_cast<int>(static_cast<unsigned>(u.x) << sh) >> 24);
    f[4 + i] = static_cast<float>(
        static_cast<int>(static_cast<unsigned>(u.y) << sh) >> 24);
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

// Merges online-softmax partials into the holder's own (m, l, acc), which
// is partial 0: m becomes the max of every m_k, and l and acc the sums of
// l_k e^(m_k - m) and acc_k e^(m_k - m), in the order k = 0, 1, ..., n - 1.
// part(k, i) reads element i of partial k >= 1: this lane's dims at i =
// lane + 32 e, m at i = DH, l at i = DH + 1. The empty partial (-1e30, 0, 0)
// adds nothing. Both merges use it: the block's warps' page split and the
// splits across blocks.
template <int DH, typename Part>
__device__ __forceinline__ void merge_partials(float& m, float& l,
                                               float (&acc)[DH / 32], int n,
                                               int lane, Part part) {
  // unrolled so that the reads of several partials are in flight at once
  float mm = m;
#pragma unroll 8
  for (int k = 1; k < n; ++k) mm = fmaxf(mm, part(k, DH));
  const float a0 = expf(m - mm);
  m = mm;
  l *= a0;
#pragma unroll
  for (int e = 0; e < DH / 32; ++e) acc[e] *= a0;
#pragma unroll 8
  for (int k = 1; k < n; ++k) {
    const float a = expf(part(k, DH) - mm);
    l += part(k, DH + 1) * a;
#pragma unroll
    for (int e = 0; e < DH / 32; ++e) acc[e] += part(k, lane + 32 * e) * a;
  }
}

// The final state of query row `row` (index into (B, QW, H)): out = acc / l
// in T (exactly 0 where l == 0: a dead row) and, for K1s, m and l.
template <typename T, int DH>
__device__ __forceinline__ void write_row(const Params& p, size_t row,
                                          int lane, float m, float l,
                                          const float (&acc)[DH / 32]) {
  const float lsafe = l == 0.f ? 1.f : l;
  T* dst = static_cast<T*>(p.out) + row * DH;
#pragma unroll
  for (int e = 0; e < DH / 32; ++e)
    dst[lane + 32 * e] = from_f32<T>(acc[e] / lsafe);
  if (p.m_out != nullptr && lane == 0) {  // K1s: m, l are warp-uniform
    p.m_out[row] = m;
    p.l_out[row] = l;
  }
}

template <typename T, typename P, int DH>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kQuant = Page<P>::kQuant;
  constexpr int kLoad = Page<P>::kLoad;
  constexpr int kVec = 16 / sizeof(P);       // elements per 16-byte copy
  constexpr int kRowStride = DH + kVec;      // 16-byte pad: no bank conflicts
  constexpr int kDimsPerLane = DH / 32;      // output dims each lane owns

  const int b = blockIdx.z / p.splits;
  const int sp = blockIdx.z % p.splits;
  const int hk = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = p.g;
  const int r0 = blockIdx.x * p.tile_rows;
  const int tr = min(p.tile_rows, p.QW * g - r0);
  const int kv_len = p.kv_lens[b];
  const int q_len = p.q_lens != nullptr ? p.q_lens[b] : p.QW;
  const int start = kv_len - q_len;  // absolute position of token 0

  // pages this tile needs: keys up to its last live token's position
  const int t_first = r0 / g;
  const int t_last = min((r0 + tr - 1) / g, q_len - 1);
  int npages = 0;
  if (t_last >= t_first && start + t_last >= 0) {
    npages = min((start + t_last) / p.BS + 1, p.NB);
  }
  // this split's table entries [j0, jend): live ones only. Splits past
  // the tile's last live entry hold nothing and leave at once; a tile whose
  // live entries one split holds (or none: split 0 writes its dead rows)
  // needs no merge.
  const int live_splits = npages > 0 ? (npages + p.pps - 1) / p.pps : 1;
  if (sp >= live_splits) return;
  const bool merged = live_splits > 1;
  const int j0 = sp * p.pps;
  const int jend = min(npages, j0 + p.pps);

  // shared memory: the query tile in f32, then (int8 pages) the stages of
  // the pages' scale rows, then the stages of ks (K, V) pages
  const int set_pages = p.ks * p.ppw;
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* sc_s = q_s + p.tile_rows * DH;
  const int stage_scales = kQuant ? set_pages * 2 * p.BS : 0;
  P* kv_s = reinterpret_cast<P*>(sc_s + p.stages * stage_scales);
  const int page_elems = p.BS * kRowStride;
  const int stage_elems = set_pages * 2 * page_elems;

  const T* q = static_cast<const T*>(p.q);
  for (int i = threadIdx.x; i < tr * DH; i += kThreads) {
    const int r = r0 + i / DH;
    const size_t off =
        ((static_cast<size_t>(b) * p.QW + r / g) * p.H + hk * g + r % g) * DH +
        i % DH;
    q_s[i] = to_f32(q[off]);
  }

  const P* pk = static_cast<const P*>(p.pages_k) + p.layer_off;
  const P* pv = static_cast<const P*>(p.pages_v) + p.layer_off;
  const int* table = p.tables + static_cast<size_t>(b) * p.NB;
  auto page_of = [&](int j) -> int {
    if (j >= jend) return -1;
    const int blk = table[j];
    return (blk >= 0 && blk < p.N) ? blk : -1;
  };
  // copy page set `set` (its set_pages pages) into stage `stage`
  auto issue = [&](int set, int stage) {
    constexpr int kChunksPerRow = DH / kVec;
    const int per_page = p.BS * kChunksPerRow;
    const int total = set_pages * 2 * per_page;
    P* base = kv_s + stage * stage_elems;
    for (int c = threadIdx.x; c < total; c += kThreads) {
      const int s = c / (2 * per_page);
      const int rem = c % (2 * per_page);
      const int kv = rem / per_page;
      const int row = (rem % per_page) / kChunksPerRow;
      const int col = (rem % kChunksPerRow) * kVec;
      const int blk = page_of(j0 + set * set_pages + s);
      if (blk < 0) continue;
      const P* src = (kv ? pv : pk) +
                     ((static_cast<size_t>(blk) * p.HKV + hk) * p.BS + row) *
                         DH +
                     col;
      cp_async16(base + (s * 2 + kv) * page_elems + row * kRowStride + col,
                 src);
    }
    if constexpr (kQuant) {
      // a page's scale rows are BS contiguous floats (BS % 4 == 0)
      const int per_scale = p.BS / 4;
      float* sbase = sc_s + stage * stage_scales;
      for (int c = threadIdx.x; c < set_pages * 2 * per_scale;
           c += kThreads) {
        const int s = c / (2 * per_scale);
        const int kv = (c / per_scale) % 2;
        const int col = (c % per_scale) * 4;
        const int blk = page_of(j0 + set * set_pages + s);
        if (blk < 0) continue;
        const float* src = (kv ? p.scales_v : p.scales_k) + p.layer_off_s +
                           (static_cast<size_t>(blk) * p.HKV + hk) * p.BS +
                           col;
        cp_async16(sbase + (s * 2 + kv) * p.BS + col, src);
      }
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

  const int nsets = jend > j0 ? (jend - j0 + set_pages - 1) / set_pages : 0;
  if (nsets > 0) issue(0, 0);
  cp_async_commit();
  for (int set = 0; set < nsets; ++set) {
    if (set + 1 < nsets) issue(set + 1, (set + 1) & 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    for (int u = 0; u < p.ppw; ++u) {
      const int slot = ks_id * p.ppw + u;
      const int j = j0 + set * set_pages + slot;
      if (ks_id < p.ks && page_of(j) >= 0) {
        const P* k_page =
            kv_s + (set & 1) * stage_elems + slot * 2 * page_elems;
        const P* v_page = k_page + page_elems;
        // int8 pages: this page's K and V scale rows (unused otherwise)
        const float* ks_page =
            sc_s + (set & 1) * stage_scales + slot * 2 * p.BS;
        const float* vs_page = ks_page + p.BS;
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
            const P* krow = k_page + key * kRowStride + part * dpl;
            const float* qrow = q_s + rl * DH + part * dpl;
            for (int d = 0; d < dpl; d += kLoad) {
              float kf[kLoad];
              load_vec(krow + d, kf);
              if constexpr (kQuant) {   // k = int8 * scale, in f32
                const float ksc = ks_page[key];
#pragma unroll
                for (int e = 0; e < kLoad; ++e) kf[e] *= ksc;
              }
#pragma unroll
              for (int e = 0; e < kLoad; ++e)
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
          // p.astype(v.dtype): rounded to the page dtype; int8 pages
          // dequantize to f32, so p stays f32
          float pt = pr;
          if constexpr (!kQuant) pt = to_f32(from_f32<P>(pr));
#pragma unroll
          for (int e = 0; e < kDimsPerLane; ++e) acc[i][e] *= alpha;
#pragma unroll 4
          for (int jj = 0; jj < nvalid; ++jj) {
            const float pj = __shfl_sync(kFull, pt, jj * L);
            const P* vrow = v_page + jj * kRowStride;
#pragma unroll
            for (int e = 0; e < kDimsPerLane; ++e) {
              float v = to_f32(vrow[lane + 32 * e]);
              if constexpr (kQuant) v *= vs_page[jj];  // int8 * scale, f32
              acc[i][e] += pj * v;
            }
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
        const float* base = red + rl * (DH + 2);
        const int stride = p.tile_rows * (DH + 2);
        merge_partials<DH>(m[i], l[i], acc[i], p.ks, lane,
                           [&](int k, int e) { return base[k * stride + e]; });
      }
    }
  }

  // query row (index into (B, QW, H)) of the tile's row rl
  auto row_of = [&](int rl) -> size_t {
    const int r = r0 + rl;
    return (static_cast<size_t>(b) * p.QW + r / g) * p.H + hk * g + r % g;
  };
  if (!merged) {
    if (ks_id == 0) {
#pragma unroll
      for (int i = 0; i < kMaxRowsPerWarp; ++i) {
        const int rl = rg + i * p.nwr;
        if (rl >= tr) break;
        write_row<T, DH>(p, row_of(rl), lane, m[i], l[i], acc[i]);
      }
    }
    return;
  }
  // this split's partials, unnormalized, to (B, splits, QW * H, DH + 2)
  const int qwh = p.QW * p.H;
  const size_t stride = static_cast<size_t>(qwh) * (DH + 2);
  auto partial = [&](int rl) {  // the row's partial of split 0
    return p.ws + static_cast<size_t>(b) * p.splits * stride +
           row_of(rl) % qwh * (DH + 2);
  };
  if (ks_id == 0) {
#pragma unroll
    for (int i = 0; i < kMaxRowsPerWarp; ++i) {
      const int rl = rg + i * p.nwr;
      if (rl >= tr) break;
      float* dst = partial(rl) + sp * stride;
#pragma unroll
      for (int e = 0; e < kDimsPerLane; ++e) dst[lane + 32 * e] = acc[i][e];
      if (lane == 0) {
        dst[DH] = m[i];
        dst[DH + 1] = l[i];
      }
    }
  }
  __syncthreads();
  __shared__ int last_split;
  const int group = (b * p.HKV + hk) * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) {
    last_split =
        hopper::arrive_count(&p.counters[group]) == live_splits - 1;
    if (last_split) hopper::acquire_fence();
  }
  __syncthreads();
  if (!last_split) return;
  if (ks_id == 0) {   // the last split merges every split's partial
#pragma unroll
    for (int i = 0; i < kMaxRowsPerWarp; ++i) {
      const int rl = rg + i * p.nwr;
      if (rl >= tr) break;
      const float* base = partial(rl);
      float mm = __ldcg(base + DH), ll = __ldcg(base + DH + 1);
      float aa[kDimsPerLane];
#pragma unroll
      for (int e = 0; e < kDimsPerLane; ++e)
        aa[e] = __ldcg(base + lane + 32 * e);
      merge_partials<DH>(mm, ll, aa, live_splits, lane, [&](int k, int e) {
        return __ldcg(base + k * stride + e);
      });
      write_row<T, DH>(p, row_of(rl), lane, mm, ll, aa);
    }
  }
  if (threadIdx.x == 0) p.counters[group] = 0;  // ready for the next call
}

template <typename T, typename P, int DH>
cudaError_t launch(const Params& p, dim3 grid, size_t smem,
                   cudaStream_t stream) {
  static size_t smem_opted_in = 48 * 1024;
  if (smem > smem_opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T, P, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    smem_opted_in = smem;
  }
  paged_attention_kernel<T, P, DH><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, bool quant, int DH, dim3 grid,
                     size_t smem, cudaStream_t st) {
  if (quant) {
    return DH == 64 ? launch<T, int8_t, 64>(p, grid, smem, st)
                    : launch<T, int8_t, 128>(p, grid, smem, st);
  }
  return DH == 64 ? launch<T, T, 64>(p, grid, smem, st)
                  : launch<T, T, 128>(p, grid, smem, st);
}

// Query rows a block takes: a row's QW tokens times the g heads of a kv
// head's group, flattened, up to kMaxTileRows.
int tile_rows_of(int QW, int g) {
  return QW * g < kMaxTileRows ? QW * g : kMaxTileRows;
}

// Blocks of one split: query tiles x kv heads x rows, each with its own
// arrival counter when the table splits.
long long groups_of(int B, int QW, int H, int HKV) {
  const int rows = QW * (H / HKV);
  if (rows == 0) return 0;
  const int tr = tile_rows_of(QW, H / HKV);
  return static_cast<long long>((rows + tr - 1) / tr) * HKV * B;
}

int run(const void* q, const void* pages_k, const void* pages_v,
        const float* scales_k, const float* scales_v, const void* tables,
        const void* kv_lens, const void* q_lens, void* out, void* m_out,
        void* l_out, int dtype, int B,
        int QW, int H, int HKV, int DH, int N, int BS, int NB, int layer,
        float scale, int splits, void* ws, void* counters, void* stream) {
  const bool quant = scales_k != nullptr;
  if ((DH != 64 && DH != 128) || (dtype != 0 && dtype != 1) || BS < 4 ||
      BS > 32 || (quant && BS % 4 != 0) || HKV < 1 || H % HKV != 0 ||
      layer < 0 || (m_out == nullptr) != (l_out == nullptr) || splits < 1 ||
      (splits > 1 && (ws == nullptr || counters == nullptr || splits > NB)) ||
      static_cast<long long>(B) * splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || QW == 0) return static_cast<int>(cudaSuccess);
  Params p;
  p.q = q;
  p.pages_k = pages_k;
  p.pages_v = pages_v;
  p.scales_k = scales_k;
  p.scales_v = scales_v;
  p.tables = static_cast<const int*>(tables);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.q_lens = static_cast<const int*>(q_lens);
  p.out = out;
  p.m_out = static_cast<float*>(m_out);
  p.l_out = static_cast<float*>(l_out);
  p.QW = QW;
  p.H = H;
  p.HKV = HKV;
  p.N = N;
  p.BS = BS;
  p.NB = NB;
  p.g = H / HKV;
  p.layer_off_s = static_cast<long long>(layer) * N * HKV * BS;
  p.layer_off = p.layer_off_s * DH;
  p.scale = scale;
  p.splits = splits;
  p.pps = (NB + splits - 1) / splits;
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<int*>(counters);
  const int rows = QW * p.g;
  p.tile_rows = tile_rows_of(QW, p.g);
  int nwr = 1;
  while (nwr * 2 <= kWarps && nwr * 2 <= p.tile_rows) nwr *= 2;
  p.nwr = nwr;
  int bsp = 1;
  while (bsp < BS) bsp *= 2;
  p.lanes_per_key = 32 / bsp;

  const size_t elem = quant ? 1 : (dtype == 0 ? 4 : 2);
  const size_t row_stride = DH + 16 / elem;
  // pages staged per set: one per idle-of-rows warp, within a 160 KB budget
  // for two stages (f32 pages of 128 dims are 16 KB per K+V pair); the int8
  // pages' scale rows count against it too. A split of at most one set
  // needs one stage.
  const size_t page_data = 2 * static_cast<size_t>(BS) * row_stride * elem;
  const size_t page_scales = quant ? 2 * static_cast<size_t>(BS) * 4 : 0;
  const size_t set_page = 2 * (page_data + page_scales);
  p.ks = kWarps / nwr;
  while (p.ks > 1 && p.ks * set_page > kStagingBudget) p.ks /= 2;
  p.ppw = kPagesPerSet / p.ks > 1 ? kPagesPerSet / p.ks : 1;
  while (p.ppw > 1 && p.ks * p.ppw * set_page > kStagingBudget) p.ppw /= 2;
  p.stages = p.pps <= p.ks * p.ppw ? 1 : 2;
  const size_t staging =
      static_cast<size_t>(p.stages) * p.ks * p.ppw * page_data;
  const size_t merge = static_cast<size_t>(p.ks) * p.tile_rows * (DH + 2) * 4;
  const size_t smem = static_cast<size_t>(p.tile_rows) * DH * 4 +
                      static_cast<size_t>(p.stages) * p.ks * p.ppw *
                          page_scales +
                      (staging > merge ? staging : merge);
  const dim3 grid((rows + p.tile_rows - 1) / p.tile_rows, HKV, B * splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      dtype == 0 ? dispatch<float>(p, quant, DH, grid, smem, st)
                 : dispatch<__nv_bfloat16>(p, quant, DH, grid, smem, st);
  return static_cast<int>(e);
}

}  // namespace

// C entries for ctypes. dtype (of q and out): 0 = float32, 1 = bfloat16.
// Every pointer is a device pointer of a contiguous tensor; the launches go
// on `stream`. Each returns the cudaError_t of the launches (0 = success).
// m_out / l_out are both null (K1, K2) or both f32 (B, QW, H, 1) (K1s).
// q_lens may be null: every row then carries QW tokens (the decode form).
// splits (1 to NB, B * splits <= 65535) blocks share each row's table; with
// splits > 1, ws is an f32 workspace of B * splits * QW * H * (DH + 2) and
// counters tnn_paged_attention_counters(B, QW, H, HKV) int32 zeros (the
// kernel leaves them 0).

// The arrival counters a split launch of these shapes needs (-1 for shapes
// no launch takes).
extern "C" long long tnn_paged_attention_counters(int B, int QW, int H,
                                                  int HKV) {
  if (B < 0 || QW < 0 || HKV < 1 || H % HKV != 0) return -1;
  return groups_of(B, QW, H, HKV);
}

// K1: pages of q's dtype.
extern "C" int tnn_paged_attention(
    const void* q, const void* pages_k, const void* pages_v,
    const void* tables, const void* kv_lens, const void* q_lens, void* out,
    void* m_out, void* l_out, int dtype, int B, int QW, int H, int HKV,
    int DH, int N, int BS, int NB, int layer, float scale, int splits,
    void* ws, void* counters, void* stream) {
  return run(q, pages_k, pages_v, nullptr, nullptr, tables, kv_lens, q_lens,
             out, m_out, l_out, dtype, B, QW, H, HKV, DH, N, BS, NB, layer,
             scale, splits, ws, counters, stream);
}

// K2: int8 pages (L, N, HKV, BS, DH) with f32 scales (L, N, HKV, BS, 1).
extern "C" int tnn_paged_attention_int8(
    const void* q, const void* data_k, const void* data_v,
    const void* scale_k, const void* scale_v, const void* tables,
    const void* kv_lens, const void* q_lens, void* out, void* m_out,
    void* l_out, int dtype, int B, int QW, int H, int HKV, int DH, int N,
    int BS, int NB, int layer, float scale, int splits, void* ws,
    void* counters, void* stream) {
  if (scale_k == nullptr || scale_v == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return run(q, data_k, data_v, static_cast<const float*>(scale_k),
             static_cast<const float*>(scale_v), tables, kv_lens, q_lens, out,
             m_out, l_out, dtype, B, QW, H, HKV, DH, N, BS, NB, layer, scale,
             splits, ws, counters, stream);
}
