// P1 / P2 — the matching probe's two tensor-core kernels: a bf16 q·tᵀ on
// the warp-level tensor cores (mma.sync m16n8k16, fp32 accumulation) with
// either a row minimum (P1) or a packed-key top-2 (P2) as its epilogue.
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
// Rounding: operands go to bf16 once, as they are staged into shared memory,
// with __float2bfloat16_rn (round to nearest even, as astype(bfloat16) and
// .to(torch.bfloat16)).  bf16 × bf16 products are exact in fp32; the tensor
// core sums them in its own order, so a cell differs from the plain
// version's fp32 matmul by a few ulp of the sum.
//
// Grid: (query tiles of 128 rows) × (S train splits) × (pairs).  A block
// owns a query tile of one pair and loops over its split's train rows
// itself (on the TPU the row minimum was carried across grid steps; blocks
// share no such carry).  The wrapper picks S with _build.train_splits so
// that one pair still launches ≥ 132 blocks; a split covers whole 8-column
// MMA tiles.  With S > 1 each block leaves a partial per (split, row) and a
// merge kernel combines them: for P1 the minimum; for P2, since keys are
// unique (the column sits in the low bits), the top-2 of two top-2s is the
// exact, order-free  b1 = min(b1, k1), b2 = min(max(b1, k1), min(b2, k2)),
// the same rule that merges lanes and warps.
//
// Block: 8 warps, 16 query rows a warp.  The block stages its 128 query rows
// once (bf16, rows padded by 8 values so that the fragment loads of a warp
// hit 32 distinct banks) and keeps each warp's A fragments in registers
// (D/16 k-steps × 4 registers); train rows arrive 64 at a time into a
// double-buffered shared tile, the next tile's fp32 loads in flight in
// registers while the current one is consumed, one barrier a tile.  A warp
// then runs D/16 MMAs per 8-column tile and its epilogue on the 4 cells a
// lane holds (rows lane/4 and lane/4 + 8, columns 2·(lane%4) + {0, 1}),
// and at the end merges the 4 lanes that share a row by shuffles.
//
// What bounds it on the card: at the probe's 64 pairs × 512 × 512 × 64 the
// fp32 inputs (16.8 MB, 0.0050 ms at 3.35 TB/s) and, for P2, its epilogue
// (~7 instructions a cell); the products (2.15 GFLOP) take 0.0022 ms at the
// dense bf16 rate.  mma.sync reaches only part of that rate (wgmma and TMA
// are later work).  One pair is launch- and latency-bound.
#include "pmt_common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;        // query rows of a block
constexpr int kTileCols = 64;             // train rows staged a step: 8 MMA tiles
constexpr int kMergeThreads = 256;
constexpr int kKeySentinel = 0x7FFFFFFF;  // above every key of a finite distance

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

// d's bits as an int32 that orders like d (negative floats flip their
// magnitude bits), and back: the transform is its own inverse
__device__ __forceinline__ int monotone_key(int u) { return u ^ ((u >> 31) & 0x7FFFFFFF); }

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
template <int KS, int EPI>
__global__ void __launch_bounds__(kThreads)
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

template <int KS, int EPI>
int launch(const float* q, const float* t, const float* t2, float* out, int* idx, void* part,
           float* q2buf, int B, int N1, int N2, int D, int S, int idx_bits, cudaStream_t st) {
  constexpr int smem = Layout<KS>::bytes();
  cudaFuncSetAttribute(probe_match_kernel<KS, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const dim3 grid((N1 + kRows - 1) / kRows, S, B);
  probe_match_kernel<KS, EPI><<<grid, kThreads, smem, st>>>(q, t, t2, out, idx, part, q2buf, N1,
                                                            N2, D, S, idx_bits);
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
             void* q2buf, int B, int N1, int N2, int D, int S, void* stream) {
  if (D < 1 || D > 128 || N2 < 1 || S < 1 || S > 65535 || B > 65535 ||
      (S > 1 && part == nullptr) || (EPI == kPackedTop2 && S > 1 && q2buf == nullptr))
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
  if (D <= 32) return launch<2, EPI>(qf, tf, t2f, of, xi, part, q2, B, N1, N2, D, S, idx_bits, st);
  if (D <= 64) return launch<4, EPI>(qf, tf, t2f, of, xi, part, q2, B, N1, N2, D, S, idx_bits, st);
  return launch<8, EPI>(qf, tf, t2f, of, xi, part, q2, B, N1, N2, D, S, idx_bits, st);
}

}  // namespace

// P1: q [B, N1, D], t [B, N2, D] f32 (D ≤ 128) → out [B, N1] f32, the row
// minima of bf16(q)·bf16(t)ᵀ; part: [B, S, N1] f32 scratch when S > 1
PMT_EXPORT int pmt_probe_gemm_rowmin(const void* q, const void* t, void* out, void* part, int B,
                                     int N1, int N2, int D, int S, void* stream) {
  return dispatch<kRowMin>(q, t, nullptr, out, nullptr, part, nullptr, B, N1, N2, D, S, stream);
}

// P2: q [B, N1, D], t [B, N2, D], t2 [B, N2] f32 → dist [B, N1, 2] f32,
// idx [B, N1, 2] i32; part: [B, S, N1] int2 and q2 [B, N1] f32 scratch when S > 1
PMT_EXPORT int pmt_probe_packed_top2(const void* q, const void* t, const void* t2, void* dist,
                                     void* idx, void* part, void* q2, int B, int N1, int N2,
                                     int D, int S, void* stream) {
  return dispatch<kPackedTop2>(q, t, t2, dist, idx, part, q2, B, N1, N2, D, S, stream);
}
