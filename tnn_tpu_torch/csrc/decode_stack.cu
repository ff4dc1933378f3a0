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
// acc * sx * w_scale + bias in that order; softmax as p / sum(p), the sum
// taken over the whole row and divided once per output; the GELU output
// quantized per MLP chunk and the chunk parts added to the residual in
// chunk order. Products and sums whose order the reference fixes use
// __fmul_rn / __fadd_rn, so that nvcc does not contract them into FMAs,
// and the build has no --use_fast_math: "/" is correctly rounded. rsqrtf
// and tanhf are not XLA's functions, so a re-quantized code can move by
// one step at a tie against the JAX kernel (the tests' limits allow it).
//
// What bounds it on the H100: bytes. One step reads every int8 weight once
// (12 D^2 per layer: 85 MB for GPT-2 small) and rows 0..t of both caches;
// the operations (2 B per weight byte) are far below the int8 rate. At
// B <= 16 the step is held by latency: grid barriers, DRAM round trips and
// the row passes that stand between the phases.
//
// Design: one cooperative launch of one block per SM, each block 16
// consumer warps and one producer warp.
//   * Static partition: for every matrix each block owns one contiguous
//     range of output rows, [N blk / nb, N (blk + 1) / nb), the same in
//     every layer (ops/decode_stack.plan_partition), so a block's share of
//     a phase is one byte range of the stack (53.6 KB a layer for GPT-2
//     small on 132 blocks).
//   * The producer warp streams the block's ranges of the whole step, in
//     phase order (layer 0 qkv, out, fc, proj, layer 1 ...), into a ring of
//     24 KB stages with 1-D bulk copies (hopper::bulk_load), as deep as
//     shared memory allows; a consumer warp releases a stage through its
//     empty mbarrier. Weights depend on nothing the launch computes, so
//     they arrive phases ahead and no phase waits on DRAM for them. The
//     producer never takes part in a grid barrier.
//   * Five grid barriers a layer, for any chunk count: qkv | attention |
//     out | fc (all C chunks into a B x F f32 scratch) | proj (each block
//     adds its columns' C chunk parts, each at its own chunk scale, in
//     chunk order): 5 L - 1 a step. The barrier is hand-rolled (a
//     red.release.gpu arrive on a counter, an ld.acquire.gpu spin, bounded:
//     it traps on overrun), its counter in the wrapper's zeroed counters;
//     the last block to leave resets it, so no memset runs per step.
//   * Row passes over the whole block: LayerNorm stages the B rows in
//     shared memory (cp.async through L2), its vectors fetched a phase
//     ahead, and takes its statistics over all the block's threads; the
//     context and the GELU output are quantized in one pass over the
//     block, their row absmax published by the producing phase into
//     per-layer slots (an integer atomicMax on the float's bits: order-
//     free, so deterministic) and read in the pass's first round trip.
//   * Split attention: each (row, head) runs over S ranges of positions, S
//     from shapes only (the wrapper's plan_splits: B, H, t, blocks; t is a
//     host int, so no sync); partial (m, l, acc) are merged in split order
//     by the last split to arrive (an integer counter it resets), so a
//     repeat gives the same bits.
//   * The products run on __dp4a from shared memory, their unit loop
//     compiled for the power of two of rows at or above B: at B <= 16 a
//     phase is a few hundred dp4a a thread, and what its time goes to is
//     instruction issue (runtime row guards took half of it), not the
//     int8 rate, so int8 mma.sync would buy nothing a phase waits for.
//   * The four matrix phases of a layer run through one copy of the code
//     (a loop over qkv, out, fc, proj), as small as its instruction cache.
// What holds it on the H100 (NVIDIA H100 80GB HBM3, gpt2_small, B = 1):
// about 5 us a phase (chip_smoke.py's stamped launch), the grid barrier
// about 1 us of it (scripts/torch_grid_barrier_ab.py); the rest is the
// round trip of each row pass's input, the row passes' reductions and the
// issue of the passes and products; attention at t = 1023 adds its
// split's loads and the merge.
// Data written inside the launch is read back through L2 (__ldcg,
// cp.async.cg), never through a stale L1 line. Rows past the live batch of
// a padded engine step compute on whatever their caches hold and are never
// read. Integer sums are exact in any order, and every float reduction has
// a fixed order, so every run gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 16;                  // consumer warps
constexpr int kConsumers = kWarps * 32;
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kMaxB = 16;                   // ops/decode_stack.py MAX_BATCH
constexpr int kMaxChunks = 8;
constexpr int kStageBytes = 24 * 1024;      // one ring stage of weight rows
constexpr int kMinStages = 2;
constexpr int kMaxStages = 16;
constexpr int kMaxSplitLen = 1024;          // scores of one split in smem
constexpr int kMaxSplits = kMaxSplitLen / 4;  // the merge's (m, l, w) there
constexpr int kSmallBytes = 2048;           // scales, absmax bits, reductions
constexpr int kSmemLimit = 232448;          // a block's shared memory (H100)
constexpr int kBar = 1;                     // named barrier of the consumers
// spin bounds: a wait that outlasts seconds, where a phase takes
// microseconds, can only be a broken protocol, so it traps
constexpr unsigned kMaxPolls = 1u << 22;

enum { kQkv = 0, kOut = 1, kFc = 2, kProj = 3 };

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int up16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Byte offsets of the dynamic shared memory (ops/decode_stack._smem_bytes
// mirrors it): the stage barriers, the int8 codes of a D-wide matmul input,
// a union (the GELU codes B x F | LayerNorm's staged rows | one attention
// split's scores and p @ V partials), the next LayerNorm's vectors, two
// buffers of per-row vectors (this phase's, the next one's), the block's
// residual columns, the int32 sums of a phase, small scalars and the
// block's shares; then the ring, as many stages as fit.
struct Layout {
  int bars, hq, u, lnv, vec, own, red_i, small, fixed;
  int own_rows, vec_stride;  // rows; floats of one vector buffer
};

Layout plan_layout(int B, int D, int F, int C, int dh, int nb) {
  Layout l;
  const int rq = cdiv(3 * D, nb), rf = cdiv(F, nb), ro = cdiv(D, nb);
  l.own_rows = ro;
  int off = 0;
  l.bars = off;
  off += up16(2 * kMaxStages * 8);
  l.hq = off;
  off += up16(B * D);
  l.u = off;
  off += up16(imax(imax(B * F, 4 * B * D), 4 * (kMaxSplitLen + kWarps * dh)));
  l.lnv = off;
  off += up16(8 * D);
  l.vec = off;
  l.vec_stride = up16(4 * 3 * imax(rq, rf)) / 4;
  off += 8 * l.vec_stride;
  l.own = off;
  off += up16(4 * B * ro);
  l.red_i = off;
  off += up16(4 * B * imax(imax(rq, rf), C * ro));
  l.small = off;
  off += kSmallBytes;
  l.fixed = off;
  return l;
}

struct Params {
  const void* x;
  void* kc;
  void* vc;
  const float* ln1_s;
  const float* ln1_b;
  const float* ln2_s;
  const float* ln2_b;
  const int8_t* wq[4];  // qkv, out, fc, proj
  const float* ws[4];   // per-row weight scales
  const float* wb[4];   // biases (proj: none; its bias is proj_b)
  const float* proj_b;
  void* x_out;
  float* x_acc;     // (B, D) the residual after each layer
  float* x_mid;     // (B, D) after attention, LN2's input
  float* qbuf;      // (B, D) q of the layer
  float* ctx;       // (B, D) attention output
  float* g;         // (B, F) GELU outputs, all chunks
  float* part;      // (B, H, splits, dh + 4) split partials: acc, m, l
  float* cmax;      // (L, B) the context's absmax per row,
  float* gmax;      // (L, C, B) the GELU output's per chunk and row: int
                    // atomicMax on the bits, zeroed by block 0 at the start
  unsigned* counters;  // [0] barrier arrivals, [1] exits, [2 + b H + h] splits
  long long* stamps;   // null, or %globaltimer at start, barriers, end
  Layout lay;
  float scale;  // 1 / sqrt(head dim), rounded to f32 once on the host
  int B, D, T, L, F, chunks, H, t, depth, splits, pps;
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

__device__ __forceinline__ void consumer_sync() {
  hopper::named_sync(kBar, kConsumers);
}

__device__ __forceinline__ long long globaltimer() {
  long long v;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(v));
  return v;
}

// 16 bytes through L2 (data written in this launch) into shared memory
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(hopper::smem_addr(dst)), "l"(src) : "memory");
}
// 4 bytes of constant data into shared memory
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(hopper::smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait for this thread's cp.async groups but the `kPending` newest
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
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

// max or sum over the consumer threads; every one gets the result
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = kMax ? warp_max(v) : warp_sum(v);
  consumer_sync();  // red may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  consumer_sync();
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

// acc * sx * w_scale, in the reference's order
__device__ __forceinline__ float rescale(int acc, float sx, float ws) {
  return __fmul_rn(__fmul_rn(static_cast<float>(acc), sx), ws);
}

// -- the partition -------------------------------------------------------------

// A block's share of one matrix: rows [r0, r1) of N, each K bytes, in
// `stages` ring stages of `rps` rows (the last may hold fewer)
struct Share {
  int N, K, r0, r1, stages, rps;
};

// the first row of block blk's range of an n-row matrix (n nb < 2^32)
__device__ __forceinline__ int row_of(int n, int blk) {
  return static_cast<int>(static_cast<unsigned>(n) * blk / gridDim.x);
}

__device__ Share share_of(const Params& p, int m, int blk) {
  Share s;
  s.N = m == kQkv ? 3 * p.D : (m == kFc ? p.F : p.D);
  s.K = m == kProj ? p.F : p.D;
  s.r0 = row_of(s.N, blk);
  s.r1 = row_of(s.N, blk + 1);
  const int R = s.r1 - s.r0, cap = imax(1, kStageBytes / s.K);
  s.stages = cdiv(R, cap);
  s.rps = s.stages ? cdiv(R, s.stages) : 0;
  return s;
}

// wait until the phase of `bar` with the given parity has completed,
// polling with the non-blocking test_wait (the stage is there long before
// the consumers come for it; try_wait cost more per call), bounded as
// hopper::mbar_wait is, tighter
__device__ __forceinline__ void stage_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = hopper::smem_addr(bar);
  uint32_t done = 0;
  for (unsigned polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (polls == kMaxPolls) __trap();
  }
}

// A position in the ring: the slot, and the parity of its current lap
struct RingPos {
  int slot;
  uint32_t lap;
  __device__ __forceinline__ void next(int depth) {
    if (++slot == depth) {
      slot = 0;
      lap ^= 1;
    }
  }
};

// -- the producer warp ---------------------------------------------------------

__device__ void produce(const Params& p, unsigned char* ring, uint64_t* full,
                        uint64_t* empty) {
  int it = 0;
  RingPos pos = {0, 0};
  for (int layer = 0; layer < p.L; ++layer) {
    for (int m = kQkv; m <= kProj; ++m) {
      const Share sh = share_of(p, m, blockIdx.x);
      for (int s = 0; s < sh.stages; ++s, ++it, pos.next(p.depth)) {
        const int slot = pos.slot;
        if (it >= p.depth) stage_wait(&empty[slot], pos.lap ^ 1);
        const int r = sh.r0 + s * sh.rps;
        const int rows = min(sh.rps, sh.r1 - r);
        const uint32_t bytes = static_cast<uint32_t>(rows) * sh.K;
        const int8_t* src =
            p.wq[m] + (static_cast<size_t>(layer) * sh.N + r) * sh.K;
        hopper::mbar_arrive_expect_tx(&full[slot], bytes);
        hopper::bulk_load(ring + static_cast<size_t>(slot) * kStageBytes, src,
                          bytes, &full[slot]);
      }
    }
  }
  // leave no copy in flight: wait for the stages still held by the ring
  for (int j = it > p.depth ? it - p.depth : 0; j < it; ++j)
    stage_wait(&full[j % p.depth], (j / p.depth) & 1);
}

// -- consumer pieces -----------------------------------------------------------

// Grid barrier over the consumers of every block. Thread 0 arrives with a
// release add on counters[0] and spins with acquire loads until the count
// reaches `target` (nb per barrier so far); named barriers order the
// block's other threads around it.
__device__ void grid_barrier(const Params& p, unsigned& target) {
  target += gridDim.x;
  consumer_sync();
  if (threadIdx.x == 0) {
    unsigned* count = p.counters;
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n"
                 :: "l"(count), "r"(1u) : "memory");
    unsigned v = 0;
    for (unsigned polls = 0;; ++polls) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(v) : "l"(count) : "memory");
      if (v >= target) break;
      if (polls == kMaxPolls) __trap();
    }
    if (p.stamps != nullptr && blockIdx.x == 0)
      p.stamps[target / gridDim.x] = globaltimer();
  }
  consumer_sync();
}

// A phase's per-row vectors (up to three, each indexed like the rows) into
// shared memory, one phase ahead, in the caller's cp.async group.
__device__ void fetch_vecs(float* vec, const Share& sh, int layer,
                           const float* a, const float* b, const float* c) {
  const int R = sh.r1 - sh.r0;
  const size_t base = static_cast<size_t>(layer) * sh.N + sh.r0;
#pragma unroll 1
  for (int i = threadIdx.x; i < R; i += kConsumers) {
    cp_async4(vec + i, a + base + i);
    if (b != nullptr) cp_async4(vec + R + i, b + base + i);
    if (c != nullptr) cp_async4(vec + 2 * R + i, c + base + i);
  }
}

// A LayerNorm's scale and bias (D each) into lnv, one phase before the
// LayerNorm reads them; closes the cp.async group.
__device__ void fetch_ln(float* lnv, int D, const float* scale,
                         const float* bias) {
  if (scale != nullptr) {
#pragma unroll 1
    for (int e = threadIdx.x; e < D / 4; e += kConsumers) {
      cp_async16(lnv + 4 * e, scale + 4 * e);
      cp_async16(lnv + D + 4 * e, bias + 4 * e);
    }
  }
  cp_async_commit();
}

// LayerNorm's B input rows into shared memory `st` as f32: x_in (layer 0,
// plain loads) or src (written in this launch: cp.async through L2), as
// one cp.async group
template <typename TX>
__device__ void stage_x(const TX* x_in, const float* src, int n, float* st) {
  if (x_in != nullptr) {
#pragma unroll 1
    for (int e = threadIdx.x; e < n; e += kConsumers) st[e] = to_f32(x_in[e]);
  } else {
#pragma unroll 1
    for (int e = threadIdx.x; e < n / 4; e += kConsumers)
      cp_async16(st + 4 * e, src + 4 * e);
  }
  cp_async_commit();
}

// the sum over the first `n` lanes' v (zero elsewhere) by a butterfly:
// every lane gets the same bits
__device__ __forceinline__ float lanes_sum(float v, int n) {
  return warp_sum((threadIdx.x % 32) < n ? v : 0.f);
}

// One-pass LayerNorm of the B rows staged in `st` (stage_x; its group the
// second newest, the phase's vectors newest), with scale and bias in lnv,
// quantized per row into codes dst (B, D) and scales hs (B). Each row
// takes kConsumers / B' threads (B' the power of two at or above B);
// their partial sums and maxima meet by butterflies over the row's warps.
// (Every warp of a row taking the whole row itself, with no block
// reduction, measured slower: 16 warps repeating the row's work hold the
// SM's issue slots.)
__device__ void ln_rows(int B, int D, float* st, const float* lnv,
                        int8_t* dst, float* hs, float* red, float* red2) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  cp_async_wait<1>();
  consumer_sync();
  int rows = 1;
  while (rows < B) rows <<= 1;
  const int tpr = kConsumers / rows, wpr = tpr / 32;
  const int row = tid / tpr, lr = tid % tpr;
  const bool live = row < B;
  const int w0 = (live ? row : 0) * wpr;
  float* xr = st + (live ? row : 0) * D;
  float s = 0.f, s2 = 0.f;
  if (live) {
#pragma unroll 1
    for (int i = lr; i < D; i += tpr) {
      const float v = xr[i];
      s = __fadd_rn(s, v);
      s2 = __fadd_rn(s2, __fmul_rn(v, v));
    }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  if (lane == 0) {
    red[2 * warp] = s;
    red[2 * warp + 1] = s2;
  }
  consumer_sync();
  s = lanes_sum(red[2 * (w0 + lane % wpr)], wpr);
  s2 = lanes_sum(red[2 * (w0 + lane % wpr) + 1], wpr);
  const float mean = s / static_cast<float>(D);
  const float mean2 = s2 / static_cast<float>(D);
  const float var = fmaxf(__fsub_rn(mean2, __fmul_rn(mean, mean)), 0.f);
  const float r = rsqrtf(__fadd_rn(var, 1e-5f));
  float amax = 0.f;
  if (live) {
#pragma unroll 1
    for (int i = lr; i < D; i += tpr) {
      const float y = __fadd_rn(
          __fmul_rn(__fmul_rn(__fsub_rn(xr[i], mean), r), lnv[i]),
          lnv[D + i]);
      xr[i] = y;
      amax = fmaxf(amax, fabsf(y));
    }
  }
  amax = warp_max(amax);
  if (lane == 0) red2[warp] = amax;
  consumer_sync();
  const float q = row_scale(warp_max(lane < wpr ? red2[w0 + lane] : 0.f));
  if (live) {
    if (lr == 0) hs[row] = q;
#pragma unroll 1
    for (int i = lr; i < D; i += tpr)
      dst[static_cast<size_t>(row) * D + i] = quant_code(xr[i], q);
  }
  consumer_sync();
}

// B rows of width K (f32, in L2) to codes dst (B, K), element (b, col) at
// scale[b * sstride + col / seg] (the row's, or its chunk's, in shared
// memory): pre0 / pre1 are the thread's first two float4 loads, issued by
// the caller (prefetch) before the scales were known.
__device__ void quant_rows(const float* src, int B, int K, float4 pre0,
                           float4 pre1, int8_t* dst, const float* scale,
                           int seg, int sstride) {
  const int n4 = B * K / 4, k4 = K / 4;
  // e / k4 as a high product (exact: e k4 < 2^32)
  const unsigned inv = 0xffffffffu / k4 + 1;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  auto put = [&](int e, float4 v) {
    const int b = __umulhi(static_cast<unsigned>(e), inv);
    const int col = (e - b * k4) * 4;
    const float sc = scale[(col / seg) * sstride + b];
    char4 q;
    q.x = quant_code(v.x, sc);
    q.y = quant_code(v.y, sc);
    q.z = quant_code(v.z, sc);
    q.w = quant_code(v.w, sc);
    *reinterpret_cast<char4*>(dst + static_cast<size_t>(b) * K + col) = q;
  };
  int e = threadIdx.x;
  if (e < n4) put(e, pre0);
  e += kConsumers;
  if (e < n4) put(e, pre1);
#pragma unroll 4
  for (e += kConsumers; e < n4; e += kConsumers) put(e, __ldcg(s4 + e));
}

__device__ __forceinline__ void prefetch(const float* src, int n,
                                         float4& pre0, float4& pre1) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  const int e = threadIdx.x;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  pre0 = e < n / 4 ? __ldcg(s4 + e) : z;
  pre1 = e + kConsumers < n / 4 ? __ldcg(s4 + e + kConsumers) : z;
}

// The (row, segment, part) units of one ring stage over the warps: the
// exact int32 sums of a unit's weight bytes against kB >= B code rows
// `act` (row stride `stride`), met in red_i ((row, seg, b)) by integer
// atomics (exact in any order). segs and parts are powers of two.
template <int kB>
__device__ __forceinline__ void dot_units(const int8_t* w, int K,
                                          const int8_t* act, int stride,
                                          int seg_bytes, int seg_log,
                                          int part_log, int units, int row0,
                                          int B, int* red_i) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n16 = seg_bytes / 16, step = 32 << part_log;
#pragma unroll 1
  for (int u = warp; u < units; u += kWarps) {
    const int part = u & ((1 << part_log) - 1);
    const int seg = (u >> part_log) & ((1 << seg_log) - 1);
    const int row = u >> (part_log + seg_log);
    int acc[kB];
#pragma unroll
    for (int b = 0; b < kB; ++b) acc[b] = 0;
    const int4* w4 = reinterpret_cast<const int4*>(
        w + static_cast<size_t>(row) * K + seg * seg_bytes);
    const int8_t* a = act + seg * seg_bytes;
#pragma unroll 2
    for (int i = part * 32 + lane; i < n16; i += step) {
      const int4 wv = w4[i];
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        if (kB == 1 || b < B) {
          const int4 av = *reinterpret_cast<const int4*>(
              a + static_cast<size_t>(b) * stride + i * 16);
          acc[b] = __dp4a(av.x, wv.x, acc[b]);
          acc[b] = __dp4a(av.y, wv.y, acc[b]);
          acc[b] = __dp4a(av.z, wv.z, acc[b]);
          acc[b] = __dp4a(av.w, wv.w, acc[b]);
        }
      }
    }
    int* dst = red_i + (((row0 + row) << seg_log) + seg) * B;
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      if (kB == 1 || b < B) {
        const int v = warp_sum_i(acc[b]);
        if (lane == b) atomicAdd(dst + b, v);
      }
    }
  }
}

// The exact int32 sums of the block's share of one matrix against B code
// rows `act` into red_i: each ring stage of rows is waited for, its rows
// cut into 2^seg_log segments of seg_bytes (the MLP chunks of proj, else
// one), and the (row, segment) units, each cut into parts of K where there
// are fewer units than warps, are spread over the warps (dot_units, its
// loop compiled for the power of two of rows at or above B). Every warp
// waits for and releases every stage; `pos` moves past the share.
__device__ void dot_share(const Params& p, const Share& sh,
                         const unsigned char* ring, uint64_t* full,
                         uint64_t* empty, RingPos& pos, const int8_t* act,
                         int stride, int seg_log, int seg_bytes, int* red_i) {
  const int lane = threadIdx.x % 32, B = p.B;
  const int n16 = seg_bytes / 16;
  for (int s = 0; s < sh.stages; ++s, pos.next(p.depth)) {
    const int slot = pos.slot;
    const int row0 = s * sh.rps;
    const int rows = min(sh.rps, sh.r1 - sh.r0 - row0);
    const int units0 = rows << seg_log;
    int part_log = 0;  // split K while units stay at most the warps
    while ((units0 << (part_log + 1)) <= kWarps &&
           (32 << (part_log + 1)) <= n16 + 31)
      ++part_log;
    const int units = units0 << part_log;
    stage_wait(&full[slot], pos.lap);
    const int8_t* w = reinterpret_cast<const int8_t*>(
        ring + static_cast<size_t>(slot) * kStageBytes);
    if (B == 1)
      dot_units<1>(w, sh.K, act, stride, seg_bytes, seg_log, part_log, units,
                   row0, B, red_i);
    else if (B == 2)
      dot_units<2>(w, sh.K, act, stride, seg_bytes, seg_log, part_log, units,
                   row0, B, red_i);
    else if (B <= 4)
      dot_units<4>(w, sh.K, act, stride, seg_bytes, seg_log, part_log, units,
                   row0, B, red_i);
    else if (B <= 8)
      dot_units<8>(w, sh.K, act, stride, seg_bytes, seg_log, part_log, units,
                   row0, B, red_i);
    else
      dot_units<16>(w, sh.K, act, stride, seg_bytes, seg_log, part_log,
                    units, row0, B, red_i);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[slot]);
  }
  cp_async_wait<1>();  // the phase's vectors (the newest: the next phase's)
  consumer_sync();
}

// 8 consecutive cache elements (16 bytes of bf16, 32 of f32) as f32,
// through L2: row t was written by another block in this launch
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

// One split of one (row, head): softmax attention over positions [j0, j0 +
// n) of rows 0..t. Scores: dh / 8 threads a position, each 8 dims of q and
// of the key (16-byte loads), their sums met by shuffles; the thread's
// first two V chunks are loaded with them, so q, K and V take one round
// trip. m and l = sum exp(s - m) by block reductions. p @ V: thread
// (group, c) sums 8 dims (chunk c) over the positions of its group; the
// groups of a warp meet by shuffles, the warps in shared memory. One split
// writes the context at once; several write (acc, m, l) partials, and the
// last to arrive merges them in split order: M = max m_s, w_s = e^(m_s -
// M), L = sum l_s w_s, out = sum acc_s w_s / L (the same formula at S = 1),
// reading the partials into shared memory in one round trip.
// It also publishes the head's context absmax. The head dim is a power of
// two from 8 to 256 (ops/decode_stack.py checks).
template <typename TC>
__device__ void attend(const Params& p, int layer, int b, int h, int split,
                       float* sc, float* pv, float* red, int* flag) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int D = p.D, dh = D / p.H, S = p.splits;
  const int j0 = split * p.pps, n = min(p.pps, p.t + 1 - j0);
  const size_t base = (static_cast<size_t>(layer) * p.B + b) * p.T * D +
                      static_cast<size_t>(j0) * D + static_cast<size_t>(h) * dh;
  const TC* kb = static_cast<const TC*>(p.kc) + base;
  const TC* vb = static_cast<const TC*>(p.vc) + base;
  const int nvec = dh / 8;                 // 8-dim chunks of the head
  const int per = kConsumers / nvec;       // positions a pass
  const int c = tid % nvec, grp = tid / nvec;
  float q[8], v0[8], v1[8];
  load8(p.qbuf + static_cast<size_t>(b) * D + h * dh + c * 8, q);
  if (grp < n) load8(vb + static_cast<size_t>(grp) * D + c * 8, v0);
  if (grp + per < n) load8(vb + static_cast<size_t>(grp + per) * D + c * 8, v1);
  float m = -CUDART_INF_F;
#pragma unroll 2
  for (int jb = 0; jb < n; jb += per) {   // uniform trips: shuffles below
    const int j = jb + grp;
    float k[8], s = 0.f;
    if (j < n) {
      load8(kb + static_cast<size_t>(j) * D + c * 8, k);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += q[e] * k[e];
    }
    for (int o = nvec / 2; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    s = __fmul_rn(s, p.scale);
    if (j < n) {
      if (c == 0) sc[j] = s;
      m = fmaxf(m, s);
    }
  }
  m = block_reduce<true>(m, red);  // its barriers publish sc
  float l = 0.f;
#pragma unroll 1
  for (int j = tid; j < n; j += kConsumers) {
    const float e = expf(__fsub_rn(sc[j], m));
    sc[j] = e;
    l += e;
  }
  l = block_reduce<false>(l, red);
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  if (grp < n) {
    const float pj = sc[grp];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] += pj * v0[e];
  }
  if (grp + per < n) {
    const float pj = sc[grp + per];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] += pj * v1[e];
  }
#pragma unroll 4
  for (int j = grp + 2 * per; j < n; j += per) {
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
  if (lane < nvec)
#pragma unroll
    for (int e = 0; e < 8; ++e) pv[warp * dh + c * 8 + e] = acc[e];
  consumer_sync();
  float o = 0.f;
  if (tid < dh)
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += pv[w * dh + tid];
  const int bh = b * p.H + h;
  const int stride = dh + 4;
  float* parts = p.part + static_cast<size_t>(bh) * S * stride;
  float L = l;
  if (S > 1) {
    float* mine = parts + static_cast<size_t>(split) * stride;
    if (tid < dh) mine[tid] = o;
    if (tid == 0) {
      mine[dh] = m;
      mine[dh + 1] = l;
    }
    consumer_sync();
    if (tid == 0) {
      *flag = hopper::arrive_count(reinterpret_cast<int*>(p.counters) + 2 +
                                   bh) == S - 1;
      if (*flag) hopper::acquire_fence();
    }
    consumer_sync();
    if (!*flag) return;  // the last split merges
    // (m_s, l_s) quads to sc[4 s], the partials 16 splits at a time to pv,
    // through L2 in one round trip each; then w_s = e^(m_s - M) in
    // sc[4 s + 2], L and the output in split order
    for (int i = tid; i < S; i += kConsumers)
      cp_async16(sc + 4 * i, parts + i * stride + dh);
    float M = -CUDART_INF_F;
    L = 0.f;
    o = 0.f;
#pragma unroll 1
    for (int s0 = 0; s0 < S; s0 += kWarps) {
      const int ns = min(kWarps, S - s0), q4 = dh / 4;
#pragma unroll 1
      for (int i = tid; i < ns * q4; i += kConsumers) {
        const int sl = i / q4, d = i - sl * q4;
        cp_async16(pv + sl * dh + 4 * d, parts + (s0 + sl) * stride + 4 * d);
      }
      cp_async_commit();
      cp_async_wait<0>();
      consumer_sync();
      if (s0 == 0) {
#pragma unroll 8
        for (int s = 0; s < S; ++s) M = fmaxf(M, sc[4 * s]);
        for (int i = tid; i < S; i += kConsumers)
          sc[4 * i + 2] = expf(__fsub_rn(sc[4 * i], M));
        consumer_sync();
#pragma unroll 8
        for (int s = 0; s < S; ++s) L += sc[4 * s + 1] * sc[4 * s + 2];
      }
      if (tid < dh)
#pragma unroll 8
        for (int s = 0; s < ns; ++s) o += pv[s * dh + tid] * sc[4 * (s0 + s) + 2];
      consumer_sync();  // pv is refilled by the next splits
    }
  }
  float out = 0.f;
  if (tid < dh) {
    out = o / L;
    p.ctx[static_cast<size_t>(b) * D + h * dh + tid] = out;
  }
  if (S > 1 && tid == 0) p.counters[2 + bh] = 0;  // ready for the next layer
  const float a = warp_max(fabsf(out));
  if (lane == 0 && warp < cdiv(dh, 32)) red[warp] = a;
  consumer_sync();
  if (tid == 0) {
    float am = 0.f;
#pragma unroll 1
    for (int w = 0; w < cdiv(dh, 32); ++w) am = fmaxf(am, red[w]);
    atomicMax(reinterpret_cast<int*>(p.cmax) + layer * p.B + b,
              __float_as_int(am));
  }
  consumer_sync();  // sc, pv and red are reused by the next item
}

// -- the consumers -------------------------------------------------------------

template <typename TX, typename TC>
__device__ void consume(const Params& p, unsigned char* smem, uint64_t* full,
                        uint64_t* empty) {
  const int tid = threadIdx.x;
  const int B = p.B, D = p.D, F = p.F, C = p.chunks, H = p.H;
  const int fcw = F / C, nb = gridDim.x, blk = blockIdx.x;
  const int clog = C == 8 ? 3 : C == 4 ? 2 : C == 2 ? 1 : 0;  // log2 C
  const Layout& lay = p.lay;
  const unsigned char* ring = smem + lay.fixed;
  int8_t* hq = reinterpret_cast<int8_t*>(smem + lay.hq);
  float* u = reinterpret_cast<float*>(smem + lay.u);  // staged rows,
  int8_t* gq = reinterpret_cast<int8_t*>(u);          // GELU codes,
  float* sc = u;                                      // attention's scores
  float* pv = sc + kMaxSplitLen;                      // and p @ V partials
  float* lnv = reinterpret_cast<float*>(smem + lay.lnv);
  float* vecs = reinterpret_cast<float*>(smem + lay.vec);  // two buffers
  const int vstride = lay.vec_stride;
  float* own = reinterpret_cast<float*>(smem + lay.own);  // (B, own_rows)
  int* red_i = reinterpret_cast<int*>(smem + lay.red_i);
  float* hs = reinterpret_cast<float*>(smem + lay.small);  // kMaxB
  float* gs = hs + kMaxB;                                  // C x kMaxB
  int* fbits = reinterpret_cast<int*>(gs + kMaxChunks * kMaxB);
  float* red = reinterpret_cast<float*>(fbits + kMaxChunks * kMaxB);
  float* red2 = red + 2 * kWarps;
  int* flag = reinterpret_cast<int*>(red2 + kWarps);
  const int ro = lay.own_rows;
  const TX* x_in = static_cast<const TX*>(p.x);
  TC* kc = static_cast<TC*>(p.kc);
  TC* vc = static_cast<TC*>(p.vc);
  // the block's shares, the same in every layer
  Share* shares = reinterpret_cast<Share*>(flag + 4);
  if (tid <= kProj) shares[tid] = share_of(p, tid, blk);
  consumer_sync();
  unsigned target = 0;
  RingPos pos = {0, 0};
  float4 pre0, pre1;

  // cp.async groups: each phase commits its staging (maybe empty) and then
  // what the next phases read (the next phase's per-row vectors, into the
  // other buffer; the next LayerNorm's vectors), so every wait is "all but
  // the newest group"
  if (blk == 0)  // the absmax slots, before the first grid barrier
#pragma unroll 1
    for (int i = tid; i < p.L * B * (C + 1); i += kConsumers) p.cmax[i] = 0.f;
  fetch_vecs(vecs, shares[kQkv], 0, p.ws[kQkv], p.wb[kQkv], nullptr);
  fetch_ln(lnv, D, p.ln1_s, p.ln1_b);
  for (int layer = 0; layer < p.L; ++layer) {
    const size_t l = static_cast<size_t>(layer);
    const bool last_layer = layer == p.L - 1;
    // Four matrix phases a layer, each through the same code (one copy of
    // the row passes and the products keeps the kernel's instructions
    // in the SM's cache): qkv (LN1), out (the context), fc (LN2), proj
    // (the GELU output); attention between qkv and out.
#pragma unroll 1
    for (int m = kQkv; m <= kProj; ++m) {
      const Share& sh = shares[m];
      const int R = sh.r1 - sh.r0;
      const float* vec = vecs + (m & 1) * vstride;    // this phase's vectors
      float* next = vecs + ((m + 1) & 1) * vstride;  // the next phase's
      const bool ln = m == kQkv || m == kFc;
      const int segs = m == kProj ? C : 1;
      const int K = m == kProj ? F : D;
      int8_t* act = m == kProj ? gq : hq;
      // 1. the row pass, and the next phase's vectors
      if (ln) {
        stage_x<TX>(m == kQkv && layer == 0 ? x_in : nullptr,
                    m == kQkv ? p.x_acc : p.x_mid, B * D, u);
        if (m == kQkv)
          fetch_vecs(next, shares[kOut], layer, p.ws[kOut], p.wb[kOut],
                     p.proj_b);
        else
          fetch_vecs(next, shares[kProj], layer, p.ws[kProj], nullptr,
                     nullptr);
        cp_async_commit();
#pragma unroll 1
        for (int i = tid; i < R * B; i += kConsumers) red_i[i] = 0;
        if (m == kFc)
          for (int i = tid; i < C * B; i += kConsumers) fbits[i] = 0;
        ln_rows(B, D, u, lnv, hq, hs, red, red2);
      } else {
        // the context (out) or the GELU output (proj), at the absmax per row
        // (and chunk) its producing phase published
        const float* src = m == kOut ? p.ctx : p.g;
        prefetch(src, B * K, pre0, pre1);
        if (m == kOut) {
          fetch_vecs(next, shares[kFc], layer, p.ws[kFc], p.wb[kFc], nullptr);
          fetch_ln(lnv, D, p.ln2_s + l * D, p.ln2_b + l * D);
        } else if (last_layer) {
          cp_async_commit();  // an empty group: the waits leave the newest
        } else {
          fetch_vecs(next, shares[kQkv], layer + 1, p.ws[kQkv], p.wb[kQkv],
                     nullptr);
          fetch_ln(lnv, D, p.ln1_s + (l + 1) * D, p.ln1_b + (l + 1) * D);
        }
#pragma unroll 1
        for (int i = tid; i < R * segs * B; i += kConsumers) red_i[i] = 0;
        float* scale = m == kOut ? hs : gs;
        if (tid < (m == kOut ? B : C * B))
          scale[tid] = row_scale(__ldcg(
              m == kOut ? p.cmax + l * B + tid : p.gmax + l * C * B + tid));
        consumer_sync();
        quant_rows(src, B, K, pre0, pre1, act, scale,
                   m == kOut ? D : fcw, m == kOut ? 0 : B);
        consumer_sync();
      }
      // 2. the exact sums of the block's rows
      dot_share(p, sh, ring, full, empty, pos, act, K, m == kProj ? clog : 0,
                m == kProj ? fcw : D, red_i);
      // 3. the epilogue
#pragma unroll 1
      for (int i = tid; i < R * B; i += kConsumers) {
        const int b = i / R, row = i - b * R, n = sh.r0 + row;
        const size_t at = static_cast<size_t>(b) * D + n;
        if (m == kQkv) {  // q to scratch, k / v to row t of the cache
          const float v = __fadd_rn(
              rescale(red_i[row * B + b], hs[b], vec[row]), vec[R + row]);
          if (n < D) {
            p.qbuf[at] = v;
          } else {
            const size_t ct = ((l * B + b) * p.T + p.t) * D + (n % D);
            if (n < 2 * D)
              kc[ct] = from_f32<TC>(v);
            else
              vc[ct] = from_f32<TC>(v);
          }
        } else if (m == kOut) {  // x_mid, and the residual x_mid + proj_b
          const float x = layer == 0 ? to_f32(x_in[at]) : own[b * ro + row];
          const float xm = __fadd_rn(
              x, __fadd_rn(rescale(red_i[row * B + b], hs[b], vec[row]),
                           vec[R + row]));
          p.x_mid[at] = xm;
          own[b * ro + row] = __fadd_rn(xm, vec[2 * R + row]);
        } else if (m == kFc) {  // GELU, and the block's absmax per chunk
          const float gv = gelu(__fadd_rn(
              rescale(red_i[row * B + b], hs[b], vec[row]), vec[R + row]));
          p.g[static_cast<size_t>(b) * F + n] = gv;
          atomicMax(&fbits[(n / fcw) * B + b], __float_as_int(fabsf(gv)));
        } else {  // each chunk's part at its own scale, in chunk order
          float x = own[b * ro + row];
#pragma unroll 1
          for (int c = 0; c < C; ++c)
            x = __fadd_rn(x, rescale(red_i[(row * C + c) * B + b],
                                     gs[c * B + b], vec[row]));
          own[b * ro + row] = x;
          p.x_acc[at] = x;
          if (last_layer) static_cast<TX*>(p.x_out)[at] = from_f32<TX>(x);
        }
      }
      if (m == kFc) {  // the block's absmax into the layer's slots
        consumer_sync();
        for (int i = tid; i < C * B; i += kConsumers) {
          const int c = i / B;
          if (sh.r0 < sh.r1 && sh.r0 < (c + 1) * fcw && c * fcw < sh.r1)
            atomicMax(reinterpret_cast<int*>(p.gmax) + l * C * B + i,
                      fbits[i]);
        }
      }
      if (m == kProj && last_layer) break;
      grid_barrier(p, target);
      if (m == kQkv) {
        // attention, (row, head, split) items over the blocks
#pragma unroll 1
        for (int item = blk; item < B * H * p.splits; item += nb) {
          const int bh = item / p.splits, split = item - bh * p.splits;
          attend<TC>(p, layer, bh / H, bh % H, split, sc, pv, red, flag);
        }
        grid_barrier(p, target);
      }
    }
  }
  // the last block to leave resets the barrier counters for the next launch
  consumer_sync();
  if (tid == 0) {
    if (p.stamps != nullptr && blk == 0)
      p.stamps[target / nb + 1] = globaltimer();
    unsigned prev;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n"
                 : "=r"(prev) : "l"(p.counters + 1), "r"(1u) : "memory");
    if (prev == static_cast<unsigned>(nb) - 1) {
      p.counters[0] = 0;
      p.counters[1] = 0;
    }
  }
}

template <typename TX, typename TC>
__global__ void __launch_bounds__(kThreads, 1)
    decode_stack_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.lay.bars);
  uint64_t* empty = full + kMaxStages;
  if (threadIdx.x == 0) {
    for (int k = 0; k < p.depth; ++k) {
      hopper::mbar_init(&full[k], 1);
      hopper::mbar_init(&empty[k], kWarps);
    }
    hopper::fence_barrier_init();
    if (p.stamps != nullptr && blockIdx.x == 0) p.stamps[0] = globaltimer();
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) produce(p, smem + p.lay.fixed, full, empty);
    return;
  }
  consume<TX, TC>(p, smem, full, empty);
}

template <typename TX, typename TC>
int launch(const Params& p, int nb, int smem, cudaStream_t stream) {
  const void* kern = reinterpret_cast<const void*>(decode_stack_kernel<TX, TC>);
  static int smem_set = -1, per_sm = 0;
  if (smem != smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  Params args = p;
  void* argv[] = {&args};
  cudaError_t err = cudaLaunchCooperativeKernel(
      kern, dim3(nb), dim3(kThreads), argv, static_cast<size_t>(smem), stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool shapes_ok(int B, int D, int F, int chunks, int H, int L) {
  if (B < 1 || B > kMaxB || L < 1 || D < 16 || D % 16 || chunks < 1 ||
      chunks > kMaxChunks || (chunks & (chunks - 1)) || F % chunks ||
      (F / chunks) % 16 || H < 1 ||
      D % H || D > kStageBytes || F > kStageBytes)
    return false;
  const int dh = D / H;
  return dh >= 8 && dh <= 256 && (dh & (dh - 1)) == 0;
}

// the ring stages `smem` bytes leave after the fixed layout, or -1 if fewer
// than kMinStages (or more than the limit) fit
int ring_depth(const Layout& lay, int smem) {
  if (smem > kSmemLimit || smem < lay.fixed) return -1;
  const int depth = (smem - lay.fixed) / kStageBytes;
  if (depth < kMinStages) return -1;
  return depth < kMaxStages ? depth : kMaxStages;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return -1;
  return sms;
}

}  // namespace

// Counters the launch needs (int32, zeroed once; the kernel leaves them 0):
// the grid barrier's arrivals and exits, one per (row, head) for the splits.
extern "C" int tnn_fused_decode_stack_counters(int B, int H) {
  return 2 + B * H;
}

// The shared-memory plan at these shapes on `nb` blocks with `smem` bytes,
// as the entry below makes it: out[0] the fixed layout's bytes, out[1] the
// ring stages. Returns 0, or cudaErrorInvalidValue where the entry refuses.
extern "C" int tnn_fused_decode_stack_plan(int B, int D, int F, int chunks,
                                           int H, int nb, int smem, int* out) {
  if (!shapes_ok(B, D, F, chunks, H, 1) || nb < 1)
    return cudaErrorInvalidValue;
  const Layout lay = plan_layout(B, D, F, chunks, D / H, nb);
  const int depth = ring_depth(lay, smem);
  if (depth < 0) return cudaErrorInvalidValue;
  out[0] = lay.fixed;
  out[1] = depth;
  return 0;
}

// Plain C entry (ctypes). dtype codes: 0 = float32, 1 = bfloat16. splits
// (ops/decode_stack.plan_splits) cut each (row, head)'s positions 0..t into
// ranges of ceil((t + 1) / splits), none empty, none above kMaxSplitLen.
// scratch holds f32 x_acc, x_mid, q, ctx (B, D) each, the GELU outputs
// (B, F), the split partials (B, H, splits, Dh + 4) and the absmax slots
// of the context (L, B) and of the GELU output (L, chunks, B);
// counters tnn_fused_decode_stack_counters int32 zeros; stamps
// null, or 5 L + 1 int64 for block 0's %globaltimer at its start, after
// each grid barrier and at its end. One block per SM. Returns 0 or the
// CUDA error code; a refused cooperative launch is an error, never a
// fall-through, and so is `smem` below what the layout and two ring stages
// need.
extern "C" int tnn_fused_decode_stack(
    const void* x, void* kc, void* vc, const void* ln1_s, const void* ln1_b,
    const void* ln2_s, const void* ln2_b, const void* qkv_q, const void* qkv_s,
    const void* qkv_b, const void* out_q, const void* out_s, const void* out_b,
    const void* fc_q, const void* fc_s, const void* fc_b, const void* proj_q,
    const void* proj_s, const void* proj_b, void* x_out, void* scratch,
    int x_dtype, int cache_dtype, int B, int D, int T, int L, int F, int chunks,
    int H, int t, int smem, float scale, int splits, void* counters,
    void* stamps, void* stream) {
  if (!shapes_ok(B, D, F, chunks, H, L) || t < 0 || t >= T ||
      counters == nullptr || splits < 1 || splits > t + 1)
    return cudaErrorInvalidValue;
  const int pps = cdiv(t + 1, splits);
  if (cdiv(t + 1, pps) != splits || pps > kMaxSplitLen ||
      splits > kMaxSplits)
    return cudaErrorInvalidValue;
  const int nb = sm_count();
  if (nb < 1) return cudaErrorInvalidDevice;
  Params p;
  p.lay = plan_layout(B, D, F, chunks, D / H, nb);
  p.depth = ring_depth(p.lay, smem);
  if (p.depth < 0) return cudaErrorInvalidValue;
  p.splits = splits;
  p.pps = pps;
  p.x = x;
  p.kc = kc;
  p.vc = vc;
  p.ln1_s = static_cast<const float*>(ln1_s);
  p.ln1_b = static_cast<const float*>(ln1_b);
  p.ln2_s = static_cast<const float*>(ln2_s);
  p.ln2_b = static_cast<const float*>(ln2_b);
  p.wq[kQkv] = static_cast<const int8_t*>(qkv_q);
  p.wq[kOut] = static_cast<const int8_t*>(out_q);
  p.wq[kFc] = static_cast<const int8_t*>(fc_q);
  p.wq[kProj] = static_cast<const int8_t*>(proj_q);
  p.ws[kQkv] = static_cast<const float*>(qkv_s);
  p.ws[kOut] = static_cast<const float*>(out_s);
  p.ws[kFc] = static_cast<const float*>(fc_s);
  p.ws[kProj] = static_cast<const float*>(proj_s);
  p.wb[kQkv] = static_cast<const float*>(qkv_b);
  p.wb[kOut] = static_cast<const float*>(out_b);
  p.wb[kFc] = static_cast<const float*>(fc_b);
  p.wb[kProj] = nullptr;
  p.proj_b = static_cast<const float*>(proj_b);
  p.x_out = x_out;
  float* s = static_cast<float*>(scratch);
  const size_t bd = static_cast<size_t>(B) * D;
  const int dh = D / H;
  p.x_acc = s;
  p.x_mid = s + bd;
  p.qbuf = s + 2 * bd;
  p.ctx = s + 3 * bd;
  p.g = s + 4 * bd;
  p.part = p.g + static_cast<size_t>(B) * F;
  p.cmax = p.part + static_cast<size_t>(B) * H * p.splits * (dh + 4);
  p.gmax = p.cmax + static_cast<size_t>(L) * B;
  p.counters = static_cast<unsigned*>(counters);
  p.stamps = static_cast<long long*>(stamps);
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
  if (x_dtype == 0 && cache_dtype == 0)
    return launch<float, float>(p, nb, smem, st);
  if (x_dtype == 0 && cache_dtype == 1)
    return launch<float, __nv_bfloat16>(p, nb, smem, st);
  if (x_dtype == 1 && cache_dtype == 0)
    return launch<__nv_bfloat16, float>(p, nb, smem, st);
  if (x_dtype == 1 && cache_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(p, nb, smem, st);
  return cudaErrorInvalidValue;
}
