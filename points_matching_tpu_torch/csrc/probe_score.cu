// P3 / P4 — the RANSAC score probe's variants: K2's inlier counts with the
// gate and the products each variant of benchmarks/probe/score_variants.py
// computes, in two kernels templated on both.
//
// Replaces the TPU kernels of benchmarks/probe/score_variants.py:
//   build_fn (make_kernel) and build_fn_stacked (make_kernel_stacked).
// Their nine variants compute four functions:
//   prod, oneop           divide gate,   fp32 products   → <kDivide, kF32>
//   nodiv, stacked, ostack multiply gate, fp32 products  → K2 itself
//                                                          (csrc/ransac_score.cu)
//   def_prec              divide gate,   one bf16 pass   → <kDivide, kBf16x1>
//   split3, stack3, ostack3 multiply gate, 3-term bf16 split → <kMultiply, kBf16x3>
// with, per (hypothesis, point) cell,
//   a = F·p1h, b = Fᵀ·p2h (first two), r = a1·x2 + a2·y2 + a3,
//   denom = a1² + a2² + b1² + b2²,
//   divide:   r² / max(denom, 1e-12) < τ²,
//   multiply: r² < τ²·max(denom, 1e-12),
// and the correspondence valid.  The TPU's stacking of F rows is an MXU
// layout; here it becomes the layout of the mma fragments below.
//
// fp32 products (<kDivide, kF32>): the plain version's chain on the CUDA
// cores, each operation rounded once (--fmad=false) and the division IEEE
// `/`, so the counts equal the plain version bit for bit, as K2's do.
//
// bf16 products: the five dot products of a cell run on the tensor cores
// with fp32 accumulation, the gate then in fp32 on the CUDA cores.  K holds
// one point's homogeneous 3-vectors, p1's in k 0..7 and p2's in k 8..15:
//     B column (a point) = [x1h y1h 1 x1l y1l x1h y1h 1 | x2h y2h 1 x2l y2l x2h y2h 1]
// and an M row is one F row meeting p1, [Fh0 Fh1 Fh2 Fh0 Fh1 Fl0 Fl1 Fl2 | 0 ...],
// or one Fᵀ row meeting p2 ([0 ... | the same of F's column]).  So one
// product sums hi·hi + hi·lo + lo·hi, the 3-term split of split3_dot (hi =
// bf16_rn(x), lo = bf16_rn(x − hi); the homogeneous 1 has lo = 0), with K =
// 16; for the single pass the lo entries are 0 and it sums hi·hi alone.
// The tensor core sums a cell's products in its own order, not IEEE-rounded
// at each add, so a count may differ from the plain version's only by cells
// within a few ulp of the gate.  Two designs (`design`; the wrapper picks
// by the launch's size):
// * warp (0): probe_score_kernel below, mma.sync m16n8k16.  A warp owns 16
//   hypotheses and issues 5 MMAs per 8 points, their rows arranged so that
//   a lane gets all five values of its cells:
//     MMA 0: rows 0–7 a1, rows 8–15 a2 of hypotheses 0–7
//     MMA 1: a3 | b1 of 0–7      MMA 2: b2 of 0–7 | b2 of 8–15
//     MMA 3: a1 | a2 of 8–15     MMA 4: a3 | b1 of 8–15
//   (lane l holds rows l/4 and l/4 + 8, points 2·(l%4) + {0, 1}).  Grid:
//   (hypothesis blocks of 64) × (S point splits) × (pairs); a block is 4
//   warps and stages its split's points into shared memory 256 at a time:
//   each point's bf16 B column (32 bytes) and (x1, y1, x2, y2) in fp32, a
//   masked point or one past the split with x2 = NaN, which fails every
//   gate.  The fp32 instance runs here too.
// * warpgroup (1): probe_score_tc_kernel below, wgmma, 128 hypotheses a
//   block, the points staged once a block through an mbarrier ring by a
//   producer warp, each step's five products issued before the previous
//   step's gates run (see there).
// Counts are integer sums: with S > 1 they are added atomically into zeroed
// counts, exact in any order.
//
// What bounds it on the card: at the probe's 64 × 512 × 512 the gate's
// ~17 fp32 operations a cell on the CUDA cores (the 90 flops a cell of the
// split take 0.0015 ms on the tensor cores); the fp32 instance issues K2's
// ~36 a cell.  The gate's chain wants many warps an SM: the warpgroup
// design's 160 accumulator registers a thread (two sets of five m64n16
// products) leave it one block, 8 consumer warps, an SM, the warp design's
// 55 registers several blocks of 4, so the warp design is the faster one
// once a launch fills the card, the warpgroup design (the ring, the
// overlap) below that (on the H100: (multiply, bf16 × 3) up to 8 pairs of
// 512 hypotheses, (divide, bf16 × 1) up to 32).
#include "pmt_common.cuh"

#include <cuda_bf16.h>

namespace {

enum Gate { kDivide = 0, kMultiply = 1 };
enum Products { kF32 = 0, kBf16x1 = 1, kBf16x3 = 2 };

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kHypsPerWarp = 16;
constexpr int kHypsPerBlock = kHypsPerWarp * kWarps;
constexpr int kPass = 256;                    // points staged a pass
constexpr uint32_t kBf16One = 0x3F80u;

// max(x, lo) that returns NaN for a NaN x, as torch.clamp_min and jnp.maximum do
__device__ __forceinline__ float max_nan(float x, float lo) {
  float y;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(x), "f"(lo));
  return y;
}

__device__ __forceinline__ uint32_t pack(uint32_t lo, uint32_t hi) { return lo | (hi << 16); }

// hi and lo bf16 halves of x (lo = 0 without the split)
template <bool SPLIT>
__device__ __forceinline__ void split(float x, uint32_t* hi, uint32_t* lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  *hi = __bfloat16_as_ushort(h);
  *lo = SPLIT ? __bfloat16_as_ushort(__float2bfloat16_rn(x - __bfloat162float(h))) : 0u;
}

// word w ∈ 0..3 of a stacked M row over one point's 8 k-entries:
// [wh0 wh1 wh2 wh0 wh1 wl0 wl1 wl2] for the row (w0, w1, w2)
template <bool SPLIT>
__device__ __forceinline__ uint32_t row_word(float w0, float w1, float w2, int w) {
  uint32_t h0, l0, h1, l1, h2, l2;
  split<SPLIT>(w0, &h0, &l0);
  split<SPLIT>(w1, &h1, &l1);
  split<SPLIT>(w2, &h2, &l2);
  const uint32_t words[4] = {pack(h0, h1), pack(h2, h0), pack(h1, l0), pack(l1, l2)};
  return w == 0 ? words[0] : w == 1 ? words[1] : w == 2 ? words[2] : words[3];
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the gate of one cell, in the plain version's operation order
template <int GATE>
__device__ __forceinline__ int gate(float a1, float a2, float a3, float b1, float b2, float x2,
                                    float y2, float tau2) {
  const float r = a1 * x2 + a2 * y2 + a3;
  const float denom = a1 * a1 + a2 * a2 + b1 * b1 + b2 * b2;
  if (GATE == kDivide) return (r * r) / max_nan(denom, 1e-12f) < tau2;
  return r * r < tau2 * max_nan(denom, 1e-12f);
}

// a cell with fp32 products (f: one hypothesis, row-major), as ransac_score.cu
template <int GATE>
__device__ __forceinline__ int cell_f32(const float (&f)[9], float4 p, float tau2) {
  const float a1 = f[0] * p.x + f[1] * p.y + f[2];
  const float a2 = f[3] * p.x + f[4] * p.y + f[5];
  const float a3 = f[6] * p.x + f[7] * p.y + f[8];
  const float b1 = f[0] * p.z + f[3] * p.w + f[6];
  const float b2 = f[1] * p.z + f[4] * p.w + f[7];
  return gate<GATE>(a1, a2, a3, b1, b2, p.z, p.w, tau2);
}

template <int GATE, int PROD>
__global__ void __launch_bounds__(kThreads)
probe_score_kernel(const float* __restrict__ F, const float2* __restrict__ p1,
                   const float2* __restrict__ p2, const uint8_t* __restrict__ mask,
                   int* __restrict__ counts, int H, int N, int S, float tau2) {
  constexpr bool kSplit = PROD == kBf16x3;
  __shared__ uint4 cols[kPass][2];            // each point's B column: 16 bf16
  __shared__ float4 pts[kPass];               // (x1, y1, x2 or NaN, y2)

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, qd = lane % 4;
  const int b = blockIdx.z, s = blockIdx.y;
  const int h0 = blockIdx.x * kHypsPerBlock + warp * kHypsPerWarp;
  const int hyp[2] = {h0 + g, h0 + 8 + g};     // this lane's two hypotheses
  const size_t row = static_cast<size_t>(b) * N;
  const int begin = static_cast<int>(static_cast<long long>(s) * N / S);
  const int end = static_cast<int>(static_cast<long long>(s + 1) * N / S);
  const float nan = __int_as_float(0x7fc00000);

  float f[2][9];                               // the two hypotheses, row-major
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float* Fh = F + (static_cast<size_t>(b) * H + min(hyp[k], H - 1)) * 9;
#pragma unroll
    for (int i = 0; i < 9; ++i) f[k][i] = Fh[i];
  }
  // the A fragments of the 5 MMAs (see the header): a-rows in k 0..7,
  // b-rows (columns of F) in k 8..15; word qd of each row
  uint32_t A[10];
  if (PROD != kF32) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float(&e)[9] = f[k];
      A[5 * k + 0] = row_word<kSplit>(e[0], e[1], e[2], qd);   // a1
      A[5 * k + 1] = row_word<kSplit>(e[3], e[4], e[5], qd);   // a2
      A[5 * k + 2] = row_word<kSplit>(e[6], e[7], e[8], qd);   // a3
      A[5 * k + 3] = row_word<kSplit>(e[0], e[3], e[6], qd);   // b1
      A[5 * k + 4] = row_word<kSplit>(e[1], e[4], e[7], qd);   // b2
    }
  }

  int cnt[2] = {0, 0};
  for (int c = begin; c < end; c += kPass) {
    if (c != begin) __syncthreads();          // the previous pass is consumed
    for (int i = tid; i < kPass; i += kThreads) {
      const int e = c + i;
      float2 u = make_float2(0.f, 0.f), w = u;
      bool valid = false;
      if (e < end) {
        u = p1[row + e];
        w = p2[row + e];
        valid = mask[row + e];
      }
      pts[i] = make_float4(u.x, u.y, valid ? w.x : nan, w.y);
      if (PROD != kF32) {
        uint32_t xh, xl, yh, yl, zh, zl, wh, wl;
        split<kSplit>(u.x, &xh, &xl);
        split<kSplit>(u.y, &yh, &yl);
        split<kSplit>(w.x, &zh, &zl);
        split<kSplit>(w.y, &wh, &wl);
        cols[i][0] = make_uint4(pack(xh, yh), pack(kBf16One, xl), pack(yl, xh), pack(yh, kBf16One));
        cols[i][1] = make_uint4(pack(zh, wh), pack(kBf16One, zl), pack(wl, zh), pack(wh, kBf16One));
      }
    }
    __syncthreads();
    const int n = min(kPass, end - c);
    for (int p0 = 0; p0 < n; p0 += 8) {
      const float4 q0 = pts[p0 + 2 * qd], q1 = pts[p0 + 2 * qd + 1];
      if (PROD == kF32) {
#pragma unroll
        for (int k = 0; k < 2; ++k)
          cnt[k] += cell_f32<GATE>(f[k], q0, tau2) + cell_f32<GATE>(f[k], q1, tau2);
      } else {
        const uint32_t* bc = reinterpret_cast<const uint32_t*>(cols[p0 + g]);
        const uint32_t b0 = bc[qd], b1 = bc[4 + qd];
        float m[5][4];
        mma_bf16(m[0], A[0], A[1], 0u, 0u, b0, b1);       // a1 | a2   (hyp g)
        mma_bf16(m[1], A[2], 0u, 0u, A[3], b0, b1);       // a3 | b1   (hyp g)
        mma_bf16(m[2], 0u, 0u, A[4], A[9], b0, b1);       // b2 (g) | b2 (g + 8)
        mma_bf16(m[3], A[5], A[6], 0u, 0u, b0, b1);       // a1 | a2   (hyp g + 8)
        mma_bf16(m[4], A[7], 0u, 0u, A[8], b0, b1);       // a3 | b1   (hyp g + 8)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float4 p = j ? q1 : q0;
          cnt[0] += gate<GATE>(m[0][j], m[0][2 + j], m[1][j], m[1][2 + j], m[2][j], p.z, p.w, tau2);
          cnt[1] += gate<GATE>(m[3][j], m[3][2 + j], m[4][j], m[4][2 + j], m[2][2 + j], p.z, p.w,
                               tau2);
        }
      }
    }
  }
  // the 4 lanes that share a hypothesis
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    cnt[k] += __shfl_xor_sync(0xffffffffu, cnt[k], 1);
    cnt[k] += __shfl_xor_sync(0xffffffffu, cnt[k], 2);
  }
  if (qd != 0) return;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (hyp[k] >= H) continue;
    int* out = counts + static_cast<size_t>(b) * H + hyp[k];
    if (S == 1) *out = cnt[k];
    else atomicAdd(out, cnt[k]);
  }
}

// -- the tensor-core instances: wgmma, points staged once a block --------

constexpr int kTcWarpgroups = 2;                   // consumers, 64 hypotheses each
constexpr int kTcHyps = 64 * kTcWarpgroups;        // hypotheses of a block
constexpr int kTcConsumers = 128 * kTcWarpgroups;
constexpr int kTcThreads = kTcConsumers + 32;      // + the producer warp
constexpr int kTcPoints = 32;                      // points a stage
constexpr int kTcSub = 16;                         // points a wgmma: its N
constexpr int kTcSubs = kTcPoints / kTcSub;        // wgmma steps a stage
constexpr int kTcStages = 4;

// One block: hypotheses [x·128, +128) of pair b over the points of split s.
// The producer warp packs 32 points a stage (lane = point) into the ring:
// B, K-major without a swizzle (the 16-byte k-chunk c of point p at
// [p / 8][c][p % 8]: chunk 0 the point's p1 column, chunk 1 its p2 column),
// and (x2 or NaN, y2); its loads run a ring's length ahead in registers.
// A consumer warpgroup holds, for each of the five products, its 64
// hypotheses' stacked rows as wgmma A fragments (a-rows in k 0..7, b-rows in
// k 8..15).  It takes a stage in steps of kTcSub points: five wgmma
// m64n(kTcSub)k16 a step into one of two accumulator sets, and the gates of
// the previous step from the other set while they run.  Accumulator i of
// product P is the cell (hypothesis 16·warp + lane/4 + 8·((i/2) % 2),
// point 8·(i/4) + 2·(lane % 4) + i % 2 of the step).
template <int GATE, int PROD>
__global__ void __launch_bounds__(kTcThreads, 1)
probe_score_tc_kernel(const float* __restrict__ F, const float2* __restrict__ p1,
                      const float2* __restrict__ p2, const uint8_t* __restrict__ mask,
                      int* __restrict__ counts, int H, int N, int S, float tau2) {
  constexpr bool kSplit = PROD == kBf16x3;
  __shared__ __align__(128) uint4 cols[kTcStages][2 * kTcPoints];
  __shared__ __align__(16) float2 pts[kTcStages][kTcPoints];
  __shared__ uint64_t full[kTcStages], empty[kTcStages];

  const int tid = threadIdx.x, lane = tid % 32;
  const int b = blockIdx.z, s = blockIdx.y;
  const size_t row = static_cast<size_t>(b) * N;
  const int begin = static_cast<int>(static_cast<long long>(s) * N / S);
  const int end = static_cast<int>(static_cast<long long>(s + 1) * N / S);
  const int ntiles = (end - begin + kTcPoints - 1) / kTcPoints;

  if (tid == 0) {
    for (int i = 0; i < kTcStages; ++i) {
      pmt_mbar_init(&full[i], 1);
      pmt_mbar_init(&empty[i], kTcConsumers / 32);
    }
    pmt_mbar_init_fence();
  }
  __syncthreads();

  const int warp_id = pmt_warp_uniform(tid / 32);
  if (warp_id >= kTcConsumers / 32) {
    // -- the producer warp
    float2 u[kTcStages], w[kTcStages];
    bool v[kTcStages];
    const auto fetch = [&](int it, int k) {
      const int e = begin + it * kTcPoints + lane;
      const bool in = e < end;
      u[k] = in ? p1[row + e] : make_float2(0.f, 0.f);
      w[k] = in ? p2[row + e] : make_float2(0.f, 0.f);
      v[k] = in && mask[row + e];
    };
#pragma unroll
    for (int k = 0; k < kTcStages; ++k) fetch(k, k);
    const float nan = __int_as_float(0x7fc00000);
    for (int it0 = 0; it0 < ntiles; it0 += kTcStages) {
#pragma unroll
      for (int k = 0; k < kTcStages; ++k) {
        if (it0 + k >= ntiles) break;
        pmt_mbar_wait(&empty[k], ((it0 / kTcStages) & 1) ^ 1);
        uint32_t xh, xl, yh, yl, zh, zl, wh, wl;
        split<kSplit>(u[k].x, &xh, &xl);
        split<kSplit>(u[k].y, &yh, &yl);
        split<kSplit>(w[k].x, &zh, &zl);
        split<kSplit>(w[k].y, &wh, &wl);
        uint4* c = cols[k] + (lane / 8) * 16 + lane % 8;
        c[0] = make_uint4(pack(xh, yh), pack(kBf16One, xl), pack(yl, xh), pack(yh, kBf16One));
        c[8] = make_uint4(pack(zh, wh), pack(kBf16One, zl), pack(wl, zh), pack(wh, kBf16One));
        pts[k][lane] = make_float2(v[k] ? w[k].x : nan, w[k].y);
        pmt_fence_proxy_async();              // the B columns, for wgmma's reads
        __syncwarp();
        if (lane == 0) pmt_mbar_arrive(&full[k]);
        fetch(it0 + k + kTcStages, k);
      }
    }
    return;
  }

  // -- a consumer warpgroup
  const int wg = warp_id / 4, warp = warp_id % 4;
  const int qd = lane % 4;
  const int h0 = blockIdx.x * kTcHyps + wg * 64 + warp * 16 + lane / 4;
  const int hyp[2] = {h0, h0 + 8};            // this thread's two hypotheses
  // A[P]: product P's rows of the two hypotheses, word qd of each k half
  uint32_t A[5][4];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float* e = F + (static_cast<size_t>(b) * H + min(hyp[k], H - 1)) * 9;
    float f[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) f[i] = e[i];
    A[0][k] = row_word<kSplit>(f[0], f[1], f[2], qd);   // a1
    A[1][k] = row_word<kSplit>(f[3], f[4], f[5], qd);   // a2
    A[2][k] = row_word<kSplit>(f[6], f[7], f[8], qd);   // a3
    A[3][2 + k] = row_word<kSplit>(f[0], f[3], f[6], qd);   // b1
    A[4][2 + k] = row_word<kSplit>(f[1], f[4], f[7], qd);   // b2
    A[0][2 + k] = A[1][2 + k] = A[2][2 + k] = A[3][k] = A[4][k] = 0u;
  }

  // step h (stage h / kTcSubs, its points kTcSub·(h % kTcSubs) on) into
  // acc: one commit group
  const auto issue = [&](float(&acc)[5][kTcSub / 2], int h) {
    const int st = (h / kTcSubs) % kTcStages;
    if (h % kTcSubs == 0) pmt_mbar_wait(&full[st], (h / kTcSubs / kTcStages) & 1);
    const uint64_t desc = pmt_wgmma_desc(cols[st] + (h % kTcSubs) * 2 * kTcSub, 128, 256, 0);
#pragma unroll
    for (int p = 0; p < 5; ++p) pmt_fence_operands(acc[p]);
    pmt_wgmma_fence();
#pragma unroll
    for (int p = 0; p < 5; ++p) pmt_wgmma<kTcSub>(acc[p], A[p], desc, 0);
    pmt_wgmma_commit();
  };
  int cnt[2] = {0, 0};
  // step h's points of this thread: (x2, y2) of two points a group of 8
  float4 pp[kTcSub / 8];
  const auto points = [&](int h) {
    const int st = (h / kTcSubs) % kTcStages;
#pragma unroll
    for (int i = 0; i < kTcSub / 8; ++i)
      pp[i] = *reinterpret_cast<const float4*>(&pts[st][(h % kTcSubs) * kTcSub + 8 * i + 2 * qd]);
  };
  // step h's gates from acc and pp (loaded before the step after it was
  // issued); a stage's last step frees it
  const auto finish = [&](float(&acc)[5][kTcSub / 2], int h) {
#pragma unroll
    for (int p = 0; p < 5; ++p) pmt_fence_operands(acc[p]);
    const int st = (h / kTcSubs) % kTcStages;
#pragma unroll
    for (int i = 0; i < kTcSub / 8; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float x2 = c ? pp[i].z : pp[i].x, y2 = c ? pp[i].w : pp[i].y;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = 4 * i + 2 * r + c;
          cnt[r] += gate<GATE>(acc[0][j], acc[1][j], acc[2][j], acc[3][j], acc[4][j], x2, y2,
                               tau2);
        }
      }
    }
    if (h % kTcSubs == kTcSubs - 1) {
      __syncwarp();
      if (lane == 0) pmt_mbar_arrive(&empty[st]);
    }
  };

  // two accumulator sets: step h's products run while step h − 1's gates
  // read the other set
  float acc0[5][kTcSub / 2], acc1[5][kTcSub / 2];
#pragma unroll
  for (int p = 0; p < 5; ++p)
#pragma unroll
    for (int i = 0; i < kTcSub / 2; ++i) acc0[p][i] = acc1[p][i] = 0.f;
  // A software pipeline: one step in flight ahead of the epilogue, and no
  // branch around a wgmma inside the loop, so that only acc0's wgmma is in
  // flight at its head (ptxas then keeps the wgmma asynchronous).
  const int steps = kTcSubs * ntiles;
  if (steps > 0) {
    issue(acc0, 0);
    int h = 1;
    for (; h + 1 < steps; h += 2) {
      points(h - 1);
      issue(acc1, h);
      pmt_wgmma_wait<1>();
      finish(acc0, h - 1);
      points(h);
      issue(acc0, h + 1);
      pmt_wgmma_wait<1>();
      finish(acc1, h);
    }
    points(h - 1);
    if (h < steps) {
      issue(acc1, h);
      pmt_wgmma_wait<1>();
      finish(acc0, h - 1);
      points(h);
      pmt_wgmma_wait<0>();
      finish(acc1, h);
    } else {
      pmt_wgmma_wait<0>();
      finish(acc0, h - 1);
    }
  }

  // the 4 lanes that share a hypothesis
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    cnt[k] += __shfl_xor_sync(0xffffffffu, cnt[k], 1);
    cnt[k] += __shfl_xor_sync(0xffffffffu, cnt[k], 2);
  }
  if (qd != 0) return;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (hyp[k] >= H) continue;
    int* out = counts + static_cast<size_t>(b) * H + hyp[k];
    if (S == 1) *out = cnt[k];
    else atomicAdd(out, cnt[k]);
  }
}

template <int GATE, int PROD>
void launch(dim3 grid, cudaStream_t st, const float* f, const float2* a, const float2* c,
            const uint8_t* m, int* out, int H, int N, int S, float tau2) {
  probe_score_kernel<GATE, PROD><<<grid, kThreads, 0, st>>>(f, a, c, m, out, H, N, S, tau2);
}

template <int GATE, int PROD>
void launch_tc(int B, cudaStream_t st, const float* f, const float2* a, const float2* c,
               const uint8_t* m, int* out, int H, int N, int S, float tau2) {
  const dim3 grid((H + kTcHyps - 1) / kTcHyps, S, B);
  probe_score_tc_kernel<GATE, PROD><<<grid, kTcThreads, 0, st>>>(f, a, c, m, out, H, N, S, tau2);
}

}  // namespace

// F [B, H, 3, 3] f32, p1/p2 [B, N, 2] f32, mask [B, N] bool → counts [B, H]
// i32 (zeroed by the caller when S > 1).  gate: 0 divide, 1 multiply;
// products: 0 fp32, 1 one bf16 pass, 2 the 3-term bf16 split.  Built
// instances: (divide, fp32), (divide, bf16 × 1), (multiply, bf16 × 3).
// design: 0 the warp-level kernel (64 hypotheses a block; mma.sync for the
// bf16 instances), 1 the wgmma kernel (128 a block; bf16 instances only).
PMT_EXPORT int pmt_probe_score(const void* F, const void* p1, const void* p2, const void* mask,
                               void* counts, int B, int H, int N, int S, float tau2, int gate,
                               int products, int design, void* stream) {
  if (S < 1 || S > 65535 || B > 65535 || (N > 0 && S > N) || design < 0 || design > 1 ||
      (design == 1 && products == kF32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const float*>(F);
  const auto* a = static_cast<const float2*>(p1);
  const auto* c = static_cast<const float2*>(p2);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* out = static_cast<int*>(counts);
  const dim3 grid((H + kHypsPerBlock - 1) / kHypsPerBlock, S, B);
  if (gate == kDivide && products == kF32)
    launch<kDivide, kF32>(grid, st, f, a, c, m, out, H, N, S, tau2);
  else if (gate == kDivide && products == kBf16x1 && design == 0)
    launch<kDivide, kBf16x1>(grid, st, f, a, c, m, out, H, N, S, tau2);
  else if (gate == kMultiply && products == kBf16x3 && design == 0)
    launch<kMultiply, kBf16x3>(grid, st, f, a, c, m, out, H, N, S, tau2);
  else if (gate == kDivide && products == kBf16x1)
    launch_tc<kDivide, kBf16x1>(B, st, f, a, c, m, out, H, N, S, tau2);
  else if (gate == kMultiply && products == kBf16x3)
    launch_tc<kMultiply, kBf16x3>(B, st, f, a, c, m, out, H, N, S, tau2);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  PMT_RETURN_LAUNCH_STATUS();
}
