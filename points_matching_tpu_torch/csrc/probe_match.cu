// P1 / P2 — the matching probe's two tensor-core kernels: a bf16 q·tᵀ with
// fp32 accumulation and either a row minimum (P1) or a packed-key top-2
// (P2) as its epilogue, in two designs that the host picks between.
//
// Replace the TPU kernels of benchmarks/probe/match_variants.py:
//   P1 gemm_only (_gemm_only_kernel): out[i] = min_j ⟨bf16(q_i), bf16(t_j)⟩,
//      a raw dot product (no distance, no mask) — the GEMM alone;
//   P2 packed_top2 (_packed_kernel): d = t2_j − 2·⟨bf16(q_i), bf16(t_j)⟩,
//      keyed as the monotone int32 u ^ ((u >> 31) & 0x7FFFFFFF) of its bits
//      with the low idx_bits = bit_length(N2 − 1) bits replaced by the column
//      j; the best key is the minimum and the runner-up the minimum of the
//      rest; dist = max(unpacked key + ‖q_i‖², 0) with ‖q_i‖² in fp32 from
//      the fp32 row, idx = the key's low bits.
// Neither is on a path of the package: they measure what a bf16
// tensor-core K1 would cost (the probe examples/probe_match_variants_torch.py
// and chip_smoke.py's `probes` phase launch them).
//
// Rounding: operands go to bf16 once, with __float2bfloat16_rn (round to
// nearest even, as astype(bfloat16) and .to(torch.bfloat16)).  bf16 × bf16
// products are exact in fp32; the tensor core sums them in its own order,
// so a cell differs from the plain version's fp32 matmul by a few ulp of
// the sum.
//
// Grid: (query tiles) × (S train splits) × (pairs).  A block owns a query
// tile of one pair and loops over its split's train rows itself (on the TPU
// the row minimum was carried across grid steps; blocks share no such
// carry).  A split covers whole 8-column tiles.  With S > 1 each block
// leaves a partial per (split, row) and a merge kernel combines them: for P1
// the minimum; for P2, since keys are unique (the column sits in the low
// bits), the top-2 of two top-2s is the exact, order-free
// b1 = min(b1, k1), b2 = min(max(b1, k1), min(b2, k2)), the rule that also
// merges lanes and warps.
//
// Two designs (`design`; the wrapper picks by the launch's size and sets S):
// * mma (0): the warp-level tensor cores, mma.sync m16n8k16, 128 query rows
//   a block (see the namespace).  Short blocks: the faster design while a
//   launch is a few blocks of latency (P1 below 16 pairs of 512 rows, P2
//   below 8, on the H100).
// * tc (1): Hopper's warpgroup tensor cores.  A block is four consumer
//   warpgroups of 64 query rows and one producer warp.  The producer keeps
//   a ring of kStages fp32 train tiles (64 rows × D, and P2's 64 values of
//   t2) in shared memory: a tile is contiguous in device memory, so one
//   cp.async.bulk copies it and completes on the stage's `full` mbarrier;
//   where a tile's start or size is no multiple of 16 bytes (D % 4 ≠ 0, or
//   a pair that starts off 16 bytes) the warp copies it with plain loads and
//   arrives itself.  Each consumer warpgroup holds its 64 rows as wgmma A
//   fragments in registers for the block's life (the m16n8k16 fragment of
//   each warp's 16 rows: D/16 k-steps × 4 registers).  The consumers convert
//   each arrived tile once, together, to a bf16 B tile — K-major, 128-byte
//   rows of 64 columns with the 128-byte swizzle (16-byte chunk c of row n
//   at chunk c ^ (n % 8)), zero past D, D = 128 as two such panels — three
//   B tiles in turn, one barrier a tile; free the stage; and issue D/16
//   wgmma m64n32k16 a step of 32 columns into one of two accumulator sets,
//   running the previous step's epilogue from the other set while they run
//   (a software pipeline: wgmma.wait_group 1 between them).  A thread's
//   accumulators are the mma.sync ones: rows lane/4 and lane/4 + 8 of its
//   warp, columns 8·i + 2·(lane % 4) + {0, 1}; at the end the 4 lanes that
//   share a row merge by shuffles.  It runs one block an SM, so the host
//   splits the train axis only as far as one wave.
//
// What bounds it on the card: at the probe's 64 pairs × 512 × 512 × 64 the
// fp32 inputs (16.8 MB, 0.0050 ms at 3.35 TB/s) and, for P2, its epilogue
// (~7 instructions a cell); the products (2.15 GFLOP) take 0.0022 ms at the
// dense bf16 rate.  The 2 query tiles of a pair each stream its train rows
// (from L2 after the first): a cluster of the two sharing each tile by
// multicast bulk copies measured slower (the blocks wait on each other's
// releases), and is not built.  ptxas serialises every wgmma (C7518,
// C7517-like notes in examples/probe_match_variants_torch.py --ptxas) unless
// the role branch is warp-uniform (pmt_warp_uniform) and no branch or
// `break` surrounds a wgmma inside the consumer loop, hence its shape.
#include "pmt_common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kMergeThreads = 256;
constexpr int kKeySentinel = 0x7FFFFFFF;            // above every key of a finite distance

enum Epilogue { kRowMin = 0, kPackedTop2 = 1 };

// max(x, 0) that returns NaN for a NaN x, as jnp.maximum and torch.clamp_min do
__device__ __forceinline__ float max0_nan(float x) {
  float y;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(x), "f"(0.f));
  return y;
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

// two values as one 32-bit word of bf16, the first in the low half
__device__ __forceinline__ uint32_t pack2(float x, float y) {
  return bf16_bits(x) | (bf16_bits(y) << 16);
}

// d's bits as an int32 that orders like d (negative floats flip their
// magnitude bits), and back: the transform is its own inverse
__device__ __forceinline__ int monotone_key(int u) { return u ^ ((u >> 31) & 0x7FFFFFFF); }

// -- the warp-level design: mma.sync ----------------------------------------
//
// Block: 8 warps, 16 query rows a warp.  The block stages its 128 query rows
// once (bf16, rows padded by 8 values so that the fragment loads of a warp
// hit 32 distinct banks) and keeps each warp's A fragments in registers
// (D/16 k-steps × 4 registers); train rows arrive 64 at a time into a
// double-buffered shared tile, the next tile's fp32 loads in flight in
// registers while the current one is consumed, one barrier a tile.  A warp
// then runs D/16 mma.sync m16n8k16 per 8-column tile and its epilogue on
// the 4 cells a lane holds.
namespace mma {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;        // query rows of a block
constexpr int kTileCols = 64;             // train rows staged a step: 8 MMA tiles

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A row of D fp32 values, 4 at a time, as bf16 into shared memory: chunk c
// of a row holds columns 4c..4c+3, zero beyond D and on rows past `rows`.
// The fp32 values are returned too (P2 sums ‖q‖² from them).
__device__ __forceinline__ float4 load4(const float* __restrict__ src, int row, int rows, int k,
                                        int D) {
  if (row >= rows || k >= D) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* p = src + static_cast<size_t>(row) * D + k;
  if ((D & 3) == 0) return *reinterpret_cast<const float4*>(p);
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = k + i < D ? p[i] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4_bf16(uint16_t* dst, float4 v) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(bf16_bits(v.x) | (bf16_bits(v.y) << 16),
                                              bf16_bits(v.z) | (bf16_bits(v.w) << 16));
}

// the 32-bit word (two bf16 values, the lower column in the low half) of a
// shared-memory row at word index w
__device__ __forceinline__ uint32_t word(const uint16_t* row, int w) {
  return reinterpret_cast<const uint32_t*>(row)[w];
}

template <int KS>
struct Layout {
  static constexpr int kDpad = 16 * KS;         // staged width: k-steps of 16
  static constexpr int kStride = kDpad + 8;     // a row in shared memory, in bf16
  static constexpr int kChunks = kDpad / 4;     // float4 chunks of a staged row
  static constexpr int kTilePer = kTileCols * kChunks / kThreads;  // chunks a thread, a tile
  static constexpr int bytes() {
    return (kRows + 2 * kTileCols) * kStride * 2 + (2 * kTileCols + kRows) * 4;
  }
};

// One block: query rows [tile·128, +128) of pair b against the train
// columns of split s.  EPI selects the epilogue; with S = 1 the block
// writes the result, else a partial (P1: the minimum, P2: (b1, b2)).
// (D = 128: at most one block an SM, so that its 8 k-steps of A fragments
// fit the registers without spilling)
template <int KS, int EPI>
__global__ void __launch_bounds__(kThreads, KS > 4 ? 1 : 0)
probe_match_kernel(const float* __restrict__ q, const float* __restrict__ t,
                   const float* __restrict__ t2, float* __restrict__ out,
                   int* __restrict__ idx, void* __restrict__ part, float* __restrict__ q2buf,
                   int N1, int N2, int D, int S, int idx_bits) {
  using L = Layout<KS>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem);                // [kRows][kStride]
  uint16_t* ts = qs + kRows * L::kStride;                          // [2][kTileCols][kStride]
  float* t2s = reinterpret_cast<float*>(ts + 2 * kTileCols * L::kStride);  // [2][kTileCols]
  float* q2s = t2s + 2 * kTileCols;                                // [kRows]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, qd = lane % 4;
  const int b = blockIdx.z, s = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const float* qb = q + static_cast<size_t>(b) * N1 * D;
  const float* tb = t + static_cast<size_t>(b) * N2 * D;
  // this split's train columns: whole 8-column tiles [begin, end)
  const int tiles8 = (N2 + 7) / 8;
  const int begin = 8 * static_cast<int>(static_cast<long long>(s) * tiles8 / S);
  const int end = min(N2, 8 * static_cast<int>(static_cast<long long>(s + 1) * tiles8 / S));

  // -- the query tile, and (P2) ‖q‖² of its rows from the fp32 values: the
  // kChunks lanes of a row each sum theirs, then a shuffle tree
#pragma unroll
  for (int i = 0; i < kRows * L::kChunks / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / L::kChunks, k = (c % L::kChunks) * 4;
    const float4 v = load4(qb, row0 + r, N1, k, D);
    store4_bf16(qs + r * L::kStride + k, v);
    if (EPI == kPackedTop2) {
      float acc = v.x * v.x;
      acc = fmaf(v.y, v.y, acc);
      acc = fmaf(v.z, v.z, acc);
      acc = fmaf(v.w, v.w, acc);
#pragma unroll
      for (int m = L::kChunks / 2; m >= 1; m /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, m);
      if (c % L::kChunks == 0) q2s[r] = acc;
    }
  }
  // -- the first train tile; later ones are loaded a tile ahead
  float4 next[L::kTilePer];
  float next_t2 = 0.f;
  const auto fetch = [&](int base) {
#pragma unroll
    for (int i = 0; i < L::kTilePer; ++i) {
      const int c = tid + i * kThreads;
      next[i] = load4(tb, base + c / L::kChunks, end, (c % L::kChunks) * 4, D);
    }
    if (EPI == kPackedTop2 && tid < kTileCols && base + tid < end)
      next_t2 = t2[static_cast<size_t>(b) * N2 + base + tid];
  };
  const auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < L::kTilePer; ++i) {
      const int c = tid + i * kThreads;
      store4_bf16(ts + (buf * kTileCols + c / L::kChunks) * L::kStride + (c % L::kChunks) * 4,
                  next[i]);
    }
    if (EPI == kPackedTop2 && tid < kTileCols) t2s[buf * kTileCols + tid] = next_t2;
  };
  fetch(begin);
  stage(0);
  __syncthreads();

  // this warp's A fragments: rows g and g + 8 of its 16, k-words q and q + 4
  uint32_t a[KS][4];
  {
    const uint16_t* r0 = qs + (warp * 16 + g) * L::kStride;
    const uint16_t* r1 = r0 + 8 * L::kStride;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      a[ks][0] = word(r0, ks * 8 + qd);
      a[ks][1] = word(r1, ks * 8 + qd);
      a[ks][2] = word(r0, ks * 8 + 4 + qd);
      a[ks][3] = word(r1, ks * 8 + 4 + qd);
    }
  }

  const int low = (1 << idx_bits) - 1;
  // per row (g, g + 8): P1 the running minimum; P2 the best two keys
  float m0 = __int_as_float(0x7f800000), m1 = m0;
  int b10 = kKeySentinel, b20 = kKeySentinel, b11 = kKeySentinel, b21 = kKeySentinel;

  int buf = 0;
  for (int base = begin; base < end; base += kTileCols, buf ^= 1) {
    const bool more = base + kTileCols < end;
    if (more) fetch(base + kTileCols);
    const int ntiles = min(kTileCols, end - base + 7) / 8;
    for (int nt = 0; nt < ntiles; ++nt) {
      const uint16_t* tr = ts + (buf * kTileCols + nt * 8 + g) * L::kStride;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) mma_bf16(c, a[ks], word(tr, ks * 8 + qd), word(tr, ks * 8 + 4 + qd));
      const int j0 = base + nt * 8 + 2 * qd;      // the columns of c[0], c[1] (and c[2], c[3])
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + h;
        const bool ok = j < end;
        if (EPI == kRowMin) {
          m0 = ok ? fminf(m0, c[h]) : m0;
          m1 = ok ? fminf(m1, c[2 + h]) : m1;
        } else {
          const float tj = t2s[buf * kTileCols + nt * 8 + 2 * qd + h];
          const int k0 = ok ? (monotone_key(__float_as_int(fmaf(-2.f, c[h], tj))) & ~low) | j
                            : kKeySentinel;
          const int k1 = ok ? (monotone_key(__float_as_int(fmaf(-2.f, c[2 + h], tj))) & ~low) | j
                            : kKeySentinel;
          b20 = min(b20, max(b10, k0));
          b10 = min(b10, k0);
          b21 = min(b21, max(b11, k1));
          b11 = min(b11, k1);
        }
      }
    }
    if (more) stage(buf ^ 1);
    __syncthreads();
  }

  // the 4 lanes that share a row
#pragma unroll
  for (int m = 1; m <= 2; m *= 2) {
    if (EPI == kRowMin) {
      m0 = fminf(m0, __shfl_xor_sync(0xffffffffu, m0, m));
      m1 = fminf(m1, __shfl_xor_sync(0xffffffffu, m1, m));
    } else {
      const int o10 = __shfl_xor_sync(0xffffffffu, b10, m);
      const int o20 = __shfl_xor_sync(0xffffffffu, b20, m);
      const int o11 = __shfl_xor_sync(0xffffffffu, b11, m);
      const int o21 = __shfl_xor_sync(0xffffffffu, b21, m);
      b20 = min(max(b10, o10), min(b20, o20));
      b10 = min(b10, o10);
      b21 = min(max(b11, o11), min(b21, o21));
      b11 = min(b11, o11);
    }
  }
  if (qd != 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    const int i = row0 + r;
    if (i >= N1) continue;
    const size_t o = static_cast<size_t>(b) * N1 + i;
    if (EPI == kRowMin) {
      const float m = h ? m1 : m0;
      if (S == 1) out[o] = m;
      else static_cast<float*>(part)[(static_cast<size_t>(b) * S + s) * N1 + i] = m;
    } else {
      const int k1 = h ? b11 : b10, k2 = h ? b21 : b20;
      if (S == 1) {
        const float q2 = q2s[r];
        const int v1 = k1 & ~low, v2 = k2 & ~low;
        out[2 * o] = max0_nan(__int_as_float(monotone_key(v1)) + q2);
        out[2 * o + 1] = max0_nan(__int_as_float(monotone_key(v2)) + q2);
        idx[2 * o] = k1 & low;
        idx[2 * o + 1] = k2 & low;
      } else {
        static_cast<int2*>(part)[(static_cast<size_t>(b) * S + s) * N1 + i] = make_int2(k1, k2);
        if (s == 0) q2buf[o] = q2s[r];
      }
    }
  }
}

template <int KS, int EPI>
void launch(const float* q, const float* t, const float* t2, float* out, int* idx, void* part,
            float* q2buf, int B, int N1, int N2, int D, int S, int idx_bits, cudaStream_t st) {
  constexpr int smem = Layout<KS>::bytes();
  cudaFuncSetAttribute(probe_match_kernel<KS, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const dim3 grid((N1 + kRows - 1) / kRows, S, B);
  probe_match_kernel<KS, EPI><<<grid, kThreads, smem, st>>>(q, t, t2, out, idx, part, q2buf, N1,
                                                            N2, D, S, idx_bits);
}

}  // namespace mma

// -- the wgmma design (see the header) --------------------------------------
namespace tc {

constexpr int kWarpgroups = 4;                      // consumers, 64 query rows each
constexpr int kRows = 64 * kWarpgroups;             // query rows of a block
constexpr int kConsumers = 128 * kWarpgroups;
constexpr int kThreads = kConsumers + 32;           // + the producer warp
constexpr int kTileCols = 64;                       // train rows a stage
constexpr int kSub = 32;                            // train rows a wgmma: its N
constexpr int kSubs = kTileCols / kSub;             // wgmma steps a stage
constexpr int kStages = 4;
constexpr int kBBufs = 3;                           // bf16 B tiles (and t2 copies) in turn

// Shared memory, from a 1024-byte aligned base (the swizzle's period).
template <int KS>
struct Layout {
  static constexpr int kPanels = KS > 4 ? KS / 4 : 1;   // 64-column panels of a bf16 row
  static constexpr int kChunks = 2 * KS;                // 8-column chunks a row converts
  static constexpr int kPanelBytes = kTileCols * 128;
  static constexpr int kBBytes = kPanels * kPanelBytes;   // one bf16 B tile
  static constexpr int kStageFloats = kTileCols * 16 * KS;
  static constexpr int kB = 0;                                             // [kBBufs] B tiles
  static constexpr int kStage = kB + kBBufs * kBBytes;                     // [kStages] fp32 tiles
  static constexpr int kT2 = kStage + kStages * kStageFloats * 4;          // [kStages][64]
  static constexpr int kT2w = kT2 + kStages * kTileCols * 4;               // [kBBufs][64]
  static constexpr int kBar = kT2w + kBBufs * kTileCols * 4;               // full, empty
  static constexpr int bytes() { return kBar + 2 * kStages * 8 + 1024; }   // + alignment slack
};

// the running result of a thread's two rows (g, g + 8): P1 the minima,
// P2 the best two keys
struct Rows {
  float m0, m1;
  int b10, b20, b11, b21;
};

// one step's epilogue on a thread's kSub / 2 accumulators (columns from
// `base`, their t2 from tw); FULL: every column is below `end`
template <int EPI, bool FULL>
__device__ __forceinline__ void epilogue(Rows& r, const float (&c)[kSub / 2], const float* tw,
                                         int base, int end, int qd, int low) {
#pragma unroll
  for (int i = 0; i < kSub / 8; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 8 * i + 2 * qd + h;
      const int j = base + col;
      const bool ok = FULL || j < end;
      const float c0 = c[4 * i + h], c1 = c[4 * i + 2 + h];
      if (EPI == kRowMin) {
        r.m0 = ok ? fminf(r.m0, c0) : r.m0;
        r.m1 = ok ? fminf(r.m1, c1) : r.m1;
      } else {
        const float tj = tw[col];
        const int k0 = ok ? (monotone_key(__float_as_int(fmaf(-2.f, c0, tj))) & ~low) | j
                          : kKeySentinel;
        const int k1 = ok ? (monotone_key(__float_as_int(fmaf(-2.f, c1, tj))) & ~low) | j
                          : kKeySentinel;
        r.b20 = min(r.b20, max(r.b10, k0));
        r.b10 = min(r.b10, k0);
        r.b21 = min(r.b21, max(r.b11, k1));
        r.b11 = min(r.b11, k1);
      }
    }
  }
}

// One block: query rows [tile·128, +128) of pair b against the train
// columns of split s.  EPI selects the epilogue; with S = 1 the block
// writes the result, else a partial (P1: the minimum, P2: (b1, b2)).
template <int KS, int EPI>
__global__ void __launch_bounds__(kThreads, 1)
probe_match_kernel(const float* __restrict__ q, const float* __restrict__ t,
                   const float* __restrict__ t2, float* __restrict__ out,
                   int* __restrict__ idx, void* __restrict__ part, float* __restrict__ q2buf,
                   int N1, int N2, int D, int S, int idx_bits) {
  using L = Layout<KS>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (pmt_smem_addr(smem_raw) & 1023u)) & 1023u);
  float* stage_f = reinterpret_cast<float*>(smem + L::kStage);
  float* stage_t2 = reinterpret_cast<float*>(smem + L::kT2);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x, lane = tid % 32;
  const int b = blockIdx.z, s = blockIdx.y;
  // this split's train columns: whole 8-column tiles [begin, end)
  const int tiles8 = (N2 + 7) / 8;
  const int begin = 8 * static_cast<int>(static_cast<long long>(s) * tiles8 / S);
  const int end = min(N2, 8 * static_cast<int>(static_cast<long long>(s + 1) * tiles8 / S));
  const int ntiles = end > begin ? (end - begin + kTileCols - 1) / kTileCols : 0;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      pmt_mbar_init(&full[i], 1);
      pmt_mbar_init(&empty[i], 1);
    }
    pmt_mbar_init_fence();
  }
  __syncthreads();

  const int warp_id = pmt_warp_uniform(tid / 32);
  if (warp_id >= kConsumers / 32) {
    // -- the producer warp: fill the ring
    const float* tb = t + static_cast<size_t>(b) * N2 * D;
    for (int it = 0; it < ntiles; ++it) {
      const int st = it % kStages;
      pmt_mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
      const int base = begin + it * kTileCols;
      const int rows = min(kTileCols, end - base);
      const float* src = tb + static_cast<size_t>(base) * D;
      float* dst = stage_f + st * L::kStageFloats;
      const uint32_t bytes = static_cast<uint32_t>(rows * D) * 4u;
      const bool bulk = ((reinterpret_cast<uintptr_t>(src) | bytes) & 15u) == 0;
      if (!bulk)
        for (int i = lane; i < rows * D; i += 32) dst[i] = __ldg(src + i);
      const float* src2 = nullptr;
      float* dst2 = stage_t2 + st * kTileCols;
      const uint32_t bytes2 = static_cast<uint32_t>(rows) * 4u;
      bool bulk2 = false;
      if (EPI == kPackedTop2) {
        src2 = t2 + static_cast<size_t>(b) * N2 + base;
        bulk2 = bulk && ((reinterpret_cast<uintptr_t>(src2) | bytes2) & 15u) == 0;
        if (!bulk2)
          for (int i = lane; i < rows; i += 32) dst2[i] = __ldg(src2 + i);
      }
      __syncwarp();
      if (lane == 0) {
        const uint32_t tx = (bulk ? bytes : 0u) + (bulk2 ? bytes2 : 0u);
        if (tx == 0) {
          pmt_mbar_arrive(&full[st]);
        } else {
          pmt_mbar_arrive_expect_tx(&full[st], tx);
          if (bulk) pmt_bulk_copy_g2s(dst, src, bytes, &full[st]);
          if (bulk2) pmt_bulk_copy_g2s(dst2, src2, bytes2, &full[st]);
        }
      }
    }
    return;
  }

  // -- a consumer warpgroup
  const int wg = warp_id / 4, warp = warp_id % 4;
  const int g = lane / 4, qd = lane % 4;
  const int row0 = blockIdx.x * kRows + wg * 64 + warp * 16 + g;   // rows row0, row0 + 8

  // this warp's A fragments (rows g and g + 8, k-words qd and qd + 4 of
  // each k-step) from the fp32 rows, and P2's ‖q‖² of the two rows
  uint32_t a[KS][4];
  float qq[2] = {0.f, 0.f};
  {
    const float* qb = q + static_cast<size_t>(b) * N1 * D;
    const bool vec2 = (D & 1) == 0 && (reinterpret_cast<uintptr_t>(q) & 7u) == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      const float* qr = qb + static_cast<size_t>(r) * D;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int hk = 0; hk < 2; ++hk) {
          const int k = 16 * ks + 8 * hk + 2 * qd;
          float x = 0.f, y = 0.f;
          if (r < N1 && k < D) {
            if (vec2) {
              const float2 v = *reinterpret_cast<const float2*>(qr + k);
              x = v.x;
              y = v.y;
            } else {
              x = qr[k];
              if (k + 1 < D) y = qr[k + 1];
            }
          }
          a[ks][h + 2 * hk] = pack2(x, y);
          if (EPI == kPackedTop2) qq[h] = fmaf(y, y, fmaf(x, x, qq[h]));
        }
      }
    }
    if (EPI == kPackedTop2) {
#pragma unroll
      for (int m = 1; m <= 2; m *= 2) {
        qq[0] += __shfl_xor_sync(0xffffffffu, qq[0], m);
        qq[1] += __shfl_xor_sync(0xffffffffu, qq[1], m);
      }
    }
  }

  unsigned char* bw = smem + L::kB;                                  // the B tiles
  float* t2w = reinterpret_cast<float*>(smem + L::kT2w);

  // tile `it`: wait for its stage, convert it to bf16 into B tile
  // it % kBBufs (every consumer thread a share), free the stage.  Three B
  // tiles in turn and one barrier a tile: a warpgroup reaches tile it's
  // barrier only after its wgmma of tile it − 2 retired and its epilogue of
  // tile it − 2 ran, and no thread writes tile it + 1 before every
  // warpgroup has reached that barrier, so B tile (it + 1) % 3 is free.
  const auto convert = [&](int it) {
    const int st = it % kStages;
    pmt_mbar_wait(&full[st], (it / kStages) & 1);
    const int rows = min(kTileCols, end - (begin + it * kTileCols));
    const float* src = stage_f + st * L::kStageFloats;
    unsigned char* dst = bw + (it % kBBufs) * L::kBBytes;
    constexpr int kItems = kTileCols * L::kChunks;      // 16-byte chunks of the B tile
#pragma unroll
    for (int item = tid; item < kItems; item += kConsumers) {
      const int n = item / L::kChunks, kc = item % L::kChunks, k = 8 * kc;
      float v[8];
      if ((D & 3) == 0 && n < rows && k < D) {
        const float4 lo = *reinterpret_cast<const float4*>(src + n * D + k);
        const float4 hi = k + 4 < D ? *reinterpret_cast<const float4*>(src + n * D + k + 4)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
        v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
        v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = n < rows && k + i < D ? src[n * D + k + i] : 0.f;
      }
      *reinterpret_cast<uint4*>(dst + (kc / 8) * L::kPanelBytes + n * 128 +
                                (((kc % 8) ^ (n % 8)) * 16)) =
          make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                     pack2(v[6], v[7]));
    }
    if (EPI == kPackedTop2 && tid < kTileCols)
      t2w[(it % kBBufs) * kTileCols + tid] = stage_t2[st * kTileCols + tid];
    pmt_fence_proxy_async();                  // the B tile, for wgmma's reads
    pmt_named_barrier(1, kConsumers);
    if (tid == 0) pmt_mbar_arrive(&empty[st]);
  };
  // step h (stage h / kSubs, its columns kSub·(h % kSubs) on) into acc:
  // one wgmma a k-step, one commit group
  const auto issue = [&](float(&acc)[kSub / 2], int h) {
    const unsigned char* bt = bw + ((h / kSubs) % kBBufs) * L::kBBytes + (h % kSubs) * kSub * 128;
    pmt_fence_operands(acc);
    pmt_wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      pmt_wgmma<kSub>(acc, a[ks],
                      pmt_wgmma_desc(bt + (ks / 4) * L::kPanelBytes + (ks % 4) * 32, 16, 1024, 1),
                      ks);
    pmt_wgmma_commit();
  };
  const int low = (1 << idx_bits) - 1;
  Rows r{__int_as_float(0x7f800000), __int_as_float(0x7f800000), kKeySentinel, kKeySentinel,
         kKeySentinel, kKeySentinel};
  const auto finish = [&](float(&acc)[kSub / 2], int h) {
    pmt_fence_operands(acc);
    const int base = begin + (h / kSubs) * kTileCols + (h % kSubs) * kSub;
    const float* tw = t2w + ((h / kSubs) % kBBufs) * kTileCols + (h % kSubs) * kSub;
    if (base + kSub <= end) epilogue<EPI, true>(r, acc, tw, base, end, qd, low);
    else epilogue<EPI, false>(r, acc, tw, base, end, qd, low);
  };
  const auto step = [&](float(&acc)[kSub / 2], int h) {
    if (h % kSubs == 0) convert(h / kSubs);
    issue(acc, h);
  };

  // two accumulator sets: step h's products run while step h − 1's
  // epilogue reads the other set
  float acc0[kSub / 2], acc1[kSub / 2];
#pragma unroll
  for (int i = 0; i < kSub / 2; ++i) acc0[i] = acc1[i] = 0.f;
  // A software pipeline: one step in flight ahead of the epilogue, and no
  // branch around a wgmma inside the loop, so that only acc0's wgmma is in
  // flight at its head (ptxas then keeps the wgmma asynchronous).
  const int steps = kSubs * ntiles;
  if (steps > 0) {
    step(acc0, 0);
    int h = 1;
    for (; h + 1 < steps; h += 2) {
      step(acc1, h);
      pmt_wgmma_wait<1>();
      finish(acc0, h - 1);
      step(acc0, h + 1);
      pmt_wgmma_wait<1>();
      finish(acc1, h);
    }
    if (h < steps) {
      step(acc1, h);
      pmt_wgmma_wait<1>();
      finish(acc0, h - 1);
      pmt_wgmma_wait<0>();
      finish(acc1, h);
    } else {
      pmt_wgmma_wait<0>();
      finish(acc0, h - 1);
    }
  }

  // the 4 lanes that share a row
#pragma unroll
  for (int m = 1; m <= 2; m *= 2) {
    if (EPI == kRowMin) {
      r.m0 = fminf(r.m0, __shfl_xor_sync(0xffffffffu, r.m0, m));
      r.m1 = fminf(r.m1, __shfl_xor_sync(0xffffffffu, r.m1, m));
    } else {
      const int o10 = __shfl_xor_sync(0xffffffffu, r.b10, m);
      const int o20 = __shfl_xor_sync(0xffffffffu, r.b20, m);
      const int o11 = __shfl_xor_sync(0xffffffffu, r.b11, m);
      const int o21 = __shfl_xor_sync(0xffffffffu, r.b21, m);
      r.b20 = min(max(r.b10, o10), min(r.b20, o20));
      r.b10 = min(r.b10, o10);
      r.b21 = min(max(r.b11, o11), min(r.b21, o21));
      r.b11 = min(r.b11, o11);
    }
  }
  if (qd != 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row0 + 8 * h;
    if (i >= N1) continue;
    const size_t o = static_cast<size_t>(b) * N1 + i;
    if (EPI == kRowMin) {
      const float m = h ? r.m1 : r.m0;
      if (S == 1) out[o] = m;
      else static_cast<float*>(part)[(static_cast<size_t>(b) * S + s) * N1 + i] = m;
    } else {
      const int k1 = h ? r.b11 : r.b10, k2 = h ? r.b21 : r.b20;
      if (S == 1) {
        const float q2 = qq[h];
        out[2 * o] = max0_nan(__int_as_float(monotone_key(k1 & ~low)) + q2);
        out[2 * o + 1] = max0_nan(__int_as_float(monotone_key(k2 & ~low)) + q2);
        idx[2 * o] = k1 & low;
        idx[2 * o + 1] = k2 & low;
      } else {
        static_cast<int2*>(part)[(static_cast<size_t>(b) * S + s) * N1 + i] = make_int2(k1, k2);
        if (s == 0) q2buf[o] = qq[h];
      }
    }
  }
}

template <int KS, int EPI>
void launch(const float* q, const float* t, const float* t2, float* out, int* idx, void* part,
            float* q2buf, int B, int N1, int N2, int D, int S, int idx_bits, cudaStream_t st) {
  constexpr int smem = Layout<KS>::bytes();
  cudaFuncSetAttribute(probe_match_kernel<KS, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const dim3 grid((N1 + kRows - 1) / kRows, S, B);
  probe_match_kernel<KS, EPI><<<grid, kThreads, smem, st>>>(q, t, t2, out, idx, part, q2buf, N1,
                                                            N2, D, S, idx_bits);
}

}  // namespace tc

// S > 1: one thread a (pair, query row) combines the S partials
template <int EPI>
__global__ void __launch_bounds__(kMergeThreads)
probe_match_merge_kernel(const void* __restrict__ part, const float* __restrict__ q2buf,
                         float* __restrict__ out, int* __restrict__ idx, int B, int N1, int S,
                         int idx_bits) {
  const size_t o = static_cast<size_t>(blockIdx.x) * kMergeThreads + threadIdx.x;
  if (o >= static_cast<size_t>(B) * N1) return;
  const size_t b = o / N1, i = o % N1;
  if (EPI == kRowMin) {
    const float* p = static_cast<const float*>(part) + b * S * N1 + i;
    float m = p[0];
    for (int s = 1; s < S; ++s) m = fminf(m, p[static_cast<size_t>(s) * N1]);
    out[o] = m;
  } else {
    const int2* p = static_cast<const int2*>(part) + b * S * N1 + i;
    int b1 = kKeySentinel, b2 = kKeySentinel;
    for (int s = 0; s < S; ++s) {
      const int2 k = p[static_cast<size_t>(s) * N1];
      b2 = min(max(b1, k.x), min(b2, k.y));
      b1 = min(b1, k.x);
    }
    const int low = (1 << idx_bits) - 1;
    const float q2 = q2buf[o];
    out[2 * o] = max0_nan(__int_as_float(monotone_key(b1 & ~low)) + q2);
    out[2 * o + 1] = max0_nan(__int_as_float(monotone_key(b2 & ~low)) + q2);
    idx[2 * o] = b1 & low;
    idx[2 * o + 1] = b2 & low;
  }
}

// the main kernel of a design (0 mma.sync, 1 wgmma), then, for S > 1, the merge
template <int KS, int EPI>
int launch(int design, const float* q, const float* t, const float* t2, float* out, int* idx,
           void* part, float* q2buf, int B, int N1, int N2, int D, int S, int idx_bits,
           cudaStream_t st) {
  if (design) tc::launch<KS, EPI>(q, t, t2, out, idx, part, q2buf, B, N1, N2, D, S, idx_bits, st);
  else mma::launch<KS, EPI>(q, t, t2, out, idx, part, q2buf, B, N1, N2, D, S, idx_bits, st);
  if (S > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t rows = static_cast<size_t>(B) * N1;
    probe_match_merge_kernel<EPI><<<(rows + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0,
                                    st>>>(part, q2buf, out, idx, B, N1, S, idx_bits);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int EPI>
int dispatch(const void* q, const void* t, const void* t2, void* out, void* idx, void* part,
             void* q2buf, int B, int N1, int N2, int D, int S, int design, void* stream) {
  if (D < 1 || D > 128 || N2 < 1 || S < 1 || S > 65535 || B > 65535 ||
      (S > 1 && part == nullptr) || (EPI == kPackedTop2 && S > 1 && q2buf == nullptr) ||
      (design != 0 && design != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N1 == 0) return 0;
  int idx_bits = 1;                      // bit_length(N2 − 1), at least 1
  while ((1LL << idx_bits) < N2) ++idx_bits;
  const auto* qf = static_cast<const float*>(q);
  const auto* tf = static_cast<const float*>(t);
  const auto* t2f = static_cast<const float*>(t2);
  auto* of = static_cast<float*>(out);
  auto* xi = static_cast<int*>(idx);
  auto* q2 = static_cast<float*>(q2buf);
  const auto st = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return launch<2, EPI>(design, qf, tf, t2f, of, xi, part, q2, B, N1, N2, D, S, idx_bits, st);
  if (D <= 64)
    return launch<4, EPI>(design, qf, tf, t2f, of, xi, part, q2, B, N1, N2, D, S, idx_bits, st);
  return launch<8, EPI>(design, qf, tf, t2f, of, xi, part, q2, B, N1, N2, D, S, idx_bits, st);
}

}  // namespace

// P1: q [B, N1, D], t [B, N2, D] f32 (D ≤ 128) → out [B, N1] f32, the row
// minima of bf16(q)·bf16(t)ᵀ; part: [B, S, N1] f32 scratch when S > 1;
// design: 0 mma.sync (128 query rows a block), 1 wgmma (256)
PMT_EXPORT int pmt_probe_gemm_rowmin(const void* q, const void* t, void* out, void* part, int B,
                                     int N1, int N2, int D, int S, int design, void* stream) {
  return dispatch<kRowMin>(q, t, nullptr, out, nullptr, part, nullptr, B, N1, N2, D, S, design,
                           stream);
}

// P2: q [B, N1, D], t [B, N2, D], t2 [B, N2] f32 → dist [B, N1, 2] f32,
// idx [B, N1, 2] i32; part: [B, S, N1] int2 and q2 [B, N1] f32 scratch when S > 1
PMT_EXPORT int pmt_probe_packed_top2(const void* q, const void* t, const void* t2, void* dist,
                                     void* idx, void* part, void* q2, int B, int N1, int N2,
                                     int D, int S, int design, void* stream) {
  return dispatch<kPackedTop2>(q, t, t2, dist, idx, part, q2, B, N1, N2, D, S, design, stream);
}
