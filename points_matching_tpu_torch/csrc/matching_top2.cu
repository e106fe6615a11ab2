// K1 / K1b — fused squared-L2 distance + top-2 matcher, with an optional
// epilogue that loads the best match's train point.
//
// Replaces the TPU kernels points_matching_tpu/ops/pallas/matching_kernel.py
// fused_l2_top2 (_top2_kernel) and fused_l2_top2_points
// (_top2_points_kernel).  Same contract: for each query row the best and
// second-best d = ‖t‖² − 2⟨q,t⟩ (+ ‖q‖² added at the end, clamped at 0) and
// their train indices; invalid train rows get ‖t‖² = 1e30; ties go to the
// lowest column; the [N1, N2] distance matrix never exists in memory.
//
// Grid: (query tiles of 128 rows) × (S train splits) × (pairs).  The
// wrapper picks S from the pair count and the SM count
// (`_build.train_splits`) so that one pair of 512 × 512 still launches ≥ 132
// blocks (4 query tiles × 33 splits); at 64 pairs S = 1 (256 blocks).
// Split s scans the train columns [s·N2/S, (s+1)·N2/S).
//
// Block: 128 threads, SGEMM-style register tiles.  The block's 128 query
// rows and a double-buffered ring of 64-row train tiles live in shared
// memory (133 KB at D = 128, 69 KB at D = 64, 37 KB at D = 32, dynamic;
// rows padded to D + 4 floats); train tiles arrive by
// cp.async while the previous tile is consumed, two barriers a tile.  Lane
// (qg, cg) of warp w holds a 4 × 16 micro-tile: query rows 32w + qg + 8r
// and tile columns cg + 4c.  The 8 lanes of a quarter-warp share their
// columns (a train load is one broadcast address per quarter) and read 8
// query rows that fall in disjoint bank groups, so 20 16-byte loads feed
// 256 FMAs a k-step of 4.  Each (query, train) cell is ONE fp32 fmaf chain
// over k = 0..D−1 in order, whatever the split or the tiling, so one pair
// alone and the same pair inside a batch give the same bits.  ‖t‖² and ‖q‖²
// are fp32, from the unrounded rows: four threads per row each sum D/4 k in
// one chain, then (s0 + s1) + (s2 + s3).  D is a template parameter, built
// for 32, 64 and 128; the wrapper pads any narrower width with zero columns
// up to the next of these, which changes no distance (a zero column adds 0
// to ⟨q,t⟩, ‖q‖² and ‖t‖²).
//
// Wider rows (D > 128, padded with zero columns to a multiple of 64) take the
// chunked kernel: the same grid, block, lanes and micro-tiles, but shared
// memory holds one 64-float chunk of the block's query rows and of a train
// tile, double-buffered, and a train tile is consumed in D / 64 steps.  A
// cell's accumulator stays in registers across the chunks of its tile and
// enters the top-2 only after the last one, so each cell is still ONE fmaf
// chain over k = 0..D−1 in order and the split merge stays exact.  The query
// chunks are re-read for every train tile (from L2; 105 KB of shared memory
// a block, two blocks an SM).  ‖q‖² and ‖t‖² add the chunks' four-lane sums
// in chunk order.
//
// Top-2: each thread visits its columns in increasing order with the strict
// `<` update (PmtTop2::push), starting from the sentinels (1e30, 0); the 4
// lanes that share query rows merge lexicographically by (d, column)
// through warp shuffles.  With S = 1 the block writes the result; with S > 1
// it leaves a partial (d1, i1, d2, i2) per (split, row) in scratch and a
// second kernel on the same stream merges the S partials in the same
// lexicographic order, adds ‖q‖², clamps, and (K1b) loads t_points[i1] —
// exact: a direct load (the TPU kernel needed a one-hot dot with a 3-term
// bf16 split for this).  The merge is exact (pmt_common.cuh: PmtTop2), so
// the answer is the in-order scan's and the plain version's two argmin
// passes' on every row, with (1e30, 0) where fewer than two rows are valid.
//
// What bounds it on the card: fp32 FFMA issue — 2·N1·N2·D flops per pair
// against (N1 + N2)·D·4 bytes, ~32 flop/byte at D = 64 before any tile
// reuse.  What holds it at about half of that (64 pairs): every 16-byte
// shared load holds the SM's shared-memory pipe for 2 clocks as a broadcast
// and 4 when the lanes of a quarter-warp read distinct rows, and 64 pairs of
// 512 rows give only ~8 warps an SM (examples/probe_sm_rates_torch.py
// measures both rates).  One pair is launch- and latency-bound.  A 3×TF32
// tensor-core path would move the bound but reorder the sums and flip
// near-ties; the contract is true fp32, so it is not here.
//
// compute_dtype='bf16': both operands are rounded to bf16 in shared memory
// after ‖·‖² is taken, and the products accumulate in fp32 — exactly what
// the MXU path computes (bf16 × bf16 products are exact in fp32).
#include "pmt_common.cuh"

#include <cuda_bf16.h>

#include <type_traits>

namespace {

// Descriptor widths D: 64 (SURF), 32 (the synthetic SfM sequences) and 128
// (SIFT).  A shared-memory row is padded to D + 4 floats; with D ∈ {32, 64,
// 128} that is 4 banks mod 32, so the 8 query rows a quarter-warp reads stay
// in disjoint bank groups.  At D = 128 a block takes 133 KB of the SM's
// 227 KB, so an SM holds one block (4 warps).
constexpr int kThreads = 128;
constexpr int kRowsPerBlock = kThreads;   // query rows of a block: 32 a warp
constexpr int kPrepRows = kThreads / 4;   // rows of one ‖·‖² pass
constexpr int kTileCols = 64;        // train rows of a tile: 4 lane groups × 16
template <int D>
constexpr int smem_bytes() {         // 136,192 at D = 128, 70,656 at D = 64, 37,888 at D = 32
  return ((kRowsPerBlock + 2 * kTileCols) * (D + 4) + 2 * kTileCols + kRowsPerBlock) * 4;
}
constexpr int kMergeThreads = 256;

__device__ __forceinline__ float4 round_bf16(float4 v) {
  return make_float4(__bfloat162float(__float2bfloat16_rn(v.x)),
                     __bfloat162float(__float2bfloat16_rn(v.y)),
                     __bfloat162float(__float2bfloat16_rn(v.z)),
                     __bfloat162float(__float2bfloat16_rn(v.w)));
}

// ‖row‖² of a D-float shared-memory row, four lanes per row: lane `part`
// sums k = (D/4)·part..(D/4)·(part+1)−1 in one chain; every lane of the four
// gets (s0 + s1) + (s2 + s3), bit for bit (IEEE addition commutes).  With
// BF16 the lane then rounds its quarter of the row in place: ‖·‖² is taken
// on the unrounded row, and no other lane reads that quarter in this phase.
template <int D, bool BF16>
__device__ __forceinline__ float prep_row(float* row, int part) {
  float4* x = reinterpret_cast<float4*>(row + (D / 4) * part);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    const float4 v = x[i];
    s = fmaf(v.x, v.x, s);
    s = fmaf(v.y, v.y, s);
    s = fmaf(v.z, v.z, s);
    s = fmaf(v.w, v.w, s);
    if (BF16) x[i] = round_bf16(v);
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s;
}

template <bool POINTS>
__device__ __forceinline__ void write_result(const PmtTop2<float>& p, float q2,
                                             size_t o, int b,
                                             const float* __restrict__ t_points,
                                             float* __restrict__ dist,
                                             int* __restrict__ idx,
                                             float* __restrict__ pts, int N2,
                                             int P) {
  dist[2 * o + 0] = fmaxf(p.d1 + q2, 0.f);
  dist[2 * o + 1] = fmaxf(p.d2 + q2, 0.f);
  idx[2 * o + 0] = p.i1;
  idx[2 * o + 1] = p.i2;
  if (POINTS) {
    const float* tp = t_points + (static_cast<size_t>(b) * N2 + p.i1) * P;
    for (int k = 0; k < P; ++k) pts[o * P + k] = N2 > 0 ? tp[k] : 0.f;
  }
}

template <int D, bool BF16, bool POINTS>
__global__ void __launch_bounds__(kThreads, 3)
l2_top2_kernel(const float* __restrict__ q, const float* __restrict__ t,
               const uint8_t* __restrict__ t_mask,
               const float* __restrict__ t_points, float* __restrict__ dist,
               int* __restrict__ idx, float* __restrict__ pts,
               int4* __restrict__ part, float* __restrict__ q2buf, int N1,
               int N2, int P) {
  constexpr int LD = D + 4;            // padded shared-memory row, in floats
  constexpr int kChunks = D / 4;       // 16-byte chunks of a row
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                // [kRowsPerBlock][LD]
  float* ts = qs + kRowsPerBlock * LD;             // [2][kTileCols][LD]
  float* t2s = ts + 2 * kTileCols * LD;            // [2][kTileCols]
  float* q2s = t2s + 2 * kTileCols;                // [kRowsPerBlock]

  const int tid = threadIdx.x;
  // compute: lane (qg, cg) of warp w holds query rows 32w + qg + 8r (r < 4)
  // and tile columns cg + 4c (c < 16)
  const int qg = tid & 7, cg = (tid >> 3) & 3, w = tid >> 5;
  const int pr = tid >> 2, pq = tid & 3;       // ‖·‖²: rows pr + kPrepRows·h; quarter
  const int b = blockIdx.z, s = blockIdx.y, S = gridDim.y;
  const int row0 = blockIdx.x * kRowsPerBlock;
  int begin, end;
  pmt_split_range(s, S, N2, &begin, &end);
  const int ntiles = (end - begin + kTileCols - 1) / kTileCols;

  const float* qb = q + static_cast<size_t>(b) * N1 * D;
  const float* tb = t + static_cast<size_t>(b) * N2 * D;
  const uint8_t* mb = t_mask + static_cast<size_t>(b) * N2;

  // rows past the end are zero-filled: a zero query row is never written
  // out, a zero train row gets ‖t‖² = 1e30 and never beats the sentinel
  for (int e = tid; e < kRowsPerBlock * kChunks; e += kThreads) {
    const int r = e / kChunks, c = 4 * (e % kChunks);
    const bool ok = row0 + r < N1;
    pmt_cp_async16_zfill(&qs[r * LD + c],
                         ok ? qb + static_cast<size_t>(row0 + r) * D + c : q, ok);
  }
  auto stage = [&](int tile, int buf) {
    const int base = begin + tile * kTileCols;
    float* dst = ts + buf * kTileCols * LD;
    for (int e = tid; e < kTileCols * kChunks; e += kThreads) {
      const int r = e / kChunks, c = 4 * (e % kChunks);
      const bool ok = base + r < end;
      pmt_cp_async16_zfill(&dst[r * LD + c],
                           ok ? tb + static_cast<size_t>(base + r) * D + c : t, ok);
    }
  };
  // the mask bits of this thread's ‖t‖² rows of a tile, loaded a tile ahead
  auto valid_bits = [&](int tile) -> int {
    int bits = 0;
#pragma unroll
    for (int h = 0; h < kTileCols / kPrepRows; ++h) {
      const int j = begin + tile * kTileCols + pr + kPrepRows * h;
      if (tile < ntiles && j < end && mb[j]) bits |= 1 << h;
    }
    return bits;
  };

  if (ntiles > 0) stage(0, 0);
  pmt_cp_async_commit();
  int m_cur = valid_bits(0);
  pmt_cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int h = 0; h < kRowsPerBlock / kPrepRows; ++h) {
    const float s2 = prep_row<D, BF16>(&qs[(pr + kPrepRows * h) * LD], pq);
    if (pq == 0) q2s[pr + kPrepRows * h] = s2;
  }

  PmtTop2<float> best[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) best[r] = PmtTop2<float>::empty(kPmtBig);

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    float* tile = ts + buf * kTileCols * LD;
    pmt_cp_async_wait<0>();                    // tile `it` has landed
    __syncthreads();                           // ... for all; tile it-1 consumed
    if (it + 1 < ntiles) stage(it + 1, buf ^ 1);
    pmt_cp_async_commit();
    const int m_next = valid_bits(it + 1);
#pragma unroll
    for (int h = 0; h < kTileCols / kPrepRows; ++h) {
      const float s2 = prep_row<D, BF16>(&tile[(pr + kPrepRows * h) * LD], pq);
      if (pq == 0) t2s[buf * kTileCols + pr + kPrepRows * h] = (m_cur >> h) & 1 ? s2 : kPmtBig;
    }
    __syncthreads();                           // ‖t‖² and (bf16) rounding done

    float acc[4][16];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[r][c] = 0.f;
    const float* qrow = &qs[(32 * w + qg) * LD];
    const float* tcol = &tile[cg * LD];
#pragma unroll 2
    for (int k = 0; k < D; k += 4) {
      float4 a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[r] = *reinterpret_cast<const float4*>(qrow + 8 * r * LD + k);
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float4 v = *reinterpret_cast<const float4*>(tcol + 4 * c * LD + k);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(a[r].x, v.x, acc[r][c]);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(a[r].y, v.y, acc[r][c]);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(a[r].z, v.z, acc[r][c]);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(a[r].w, v.w, acc[r][c]);
      }
    }
    const int base = begin + it * kTileCols;
#pragma unroll
    for (int c = 0; c < 16; ++c) {             // columns in increasing order
      const float t2 = t2s[buf * kTileCols + cg + 4 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r) best[r].push(t2 - 2.0f * acc[r][c], base + cg + 4 * c);
    }
    m_cur = m_next;
  }
  __syncthreads();                             // q2s is visible with no tile too

  // the 4 lanes with the same qg hold the same query rows: lanes differ in
  // bits 3 and 4
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    best[r].merge_lane(8);
    best[r].merge_lane(16);
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int lr = 32 * w + qg + 8 * r;        // lane cg writes its row r = cg
    if (cg != r || row0 + lr >= N1) continue;
    const size_t o = static_cast<size_t>(b) * N1 + row0 + lr;
    if (S == 1) {
      write_result<POINTS>(best[r], q2s[lr], o, b, t_points, dist, idx, pts, N2, P);
    } else {
      part[(static_cast<size_t>(b) * S + s) * N1 + row0 + lr] = pmt_pack(best[r]);
      if (s == 0) q2buf[o] = q2s[lr];
    }
  }
}

// The chunked path (D > 128): 64-float chunks of the width.
constexpr int kChunk = 64;
constexpr int kChunkLD = kChunk + 4;      // padded shared-memory row, in floats
constexpr int kChunkSmemBytes =            // 105,216
    (2 * (kRowsPerBlock + kTileCols) * kChunkLD + kTileCols + kRowsPerBlock) * 4;

template <bool BF16, bool POINTS>
__global__ void __launch_bounds__(kThreads, 2)
l2_top2_chunked_kernel(const float* __restrict__ q, const float* __restrict__ t,
                       const uint8_t* __restrict__ t_mask,
                       const float* __restrict__ t_points, float* __restrict__ dist,
                       int* __restrict__ idx, float* __restrict__ pts,
                       int4* __restrict__ part, float* __restrict__ q2buf, int N1,
                       int N2, int D, int P) {
  constexpr int LD = kChunkLD;
  constexpr int kPieces = kChunk / 4;    // 16-byte pieces of a chunk row
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                // [2][kRowsPerBlock][LD]
  float* ts = qs + 2 * kRowsPerBlock * LD;         // [2][kTileCols][LD]
  float* t2s = ts + 2 * kTileCols * LD;            // [kTileCols]
  float* q2s = t2s + kTileCols;                    // [kRowsPerBlock]

  const int tid = threadIdx.x;
  const int qg = tid & 7, cg = (tid >> 3) & 3, w = tid >> 5;
  const int pr = tid >> 2, pq = tid & 3;
  const int b = blockIdx.z, s = blockIdx.y, S = gridDim.y;
  const int row0 = blockIdx.x * kRowsPerBlock;
  int begin, end;
  pmt_split_range(s, S, N2, &begin, &end);
  const int ntiles = (end - begin + kTileCols - 1) / kTileCols;
  const int nchunks = D / kChunk;
  const int nsteps = ntiles * nchunks;

  const float* qb = q + static_cast<size_t>(b) * N1 * D;
  const float* tb = t + static_cast<size_t>(b) * N2 * D;
  const uint8_t* mb = t_mask + static_cast<size_t>(b) * N2;

  // step st stages chunk st % nchunks of the query rows and of train tile
  // st / nchunks; rows past the end are zero-filled, as on the fast path
  auto stage = [&](int st, int buf) {
    const int tile = st / nchunks, col = (st - tile * nchunks) * kChunk;
    float* qd = qs + buf * kRowsPerBlock * LD;
    for (int e = tid; e < kRowsPerBlock * kPieces; e += kThreads) {
      const int r = e / kPieces, c = 4 * (e % kPieces);
      const bool ok = row0 + r < N1;
      pmt_cp_async16_zfill(&qd[r * LD + c],
                           ok ? qb + static_cast<size_t>(row0 + r) * D + col + c : q, ok);
    }
    const int base = begin + tile * kTileCols;
    float* td = ts + buf * kTileCols * LD;
    for (int e = tid; e < kTileCols * kPieces; e += kThreads) {
      const int r = e / kPieces, c = 4 * (e % kPieces);
      const bool ok = base + r < end;
      pmt_cp_async16_zfill(&td[r * LD + c],
                           ok ? tb + static_cast<size_t>(base + r) * D + col + c : t, ok);
    }
  };
  if (nsteps > 0) stage(0, 0);
  pmt_cp_async_commit();

  // ‖q‖² from global memory, chunk by chunk: lane pq sums its 16 floats of a
  // chunk in one chain, the four lanes combine as (s0 + s1) + (s2 + s3), the
  // chunks add in order
  float q2acc[kRowsPerBlock / kPrepRows];
#pragma unroll
  for (int h = 0; h < kRowsPerBlock / kPrepRows; ++h) q2acc[h] = 0.f;
  for (int c = 0; c < nchunks; ++c) {
#pragma unroll
    for (int h = 0; h < kRowsPerBlock / kPrepRows; ++h) {
      const int r = row0 + pr + kPrepRows * h;
      float sum = 0.f;
      if (r < N1) {
        const float4* x = reinterpret_cast<const float4*>(
            qb + static_cast<size_t>(r) * D + c * kChunk + (kChunk / 4) * pq);
#pragma unroll
        for (int i = 0; i < kChunk / 16; ++i) {
          const float4 v = x[i];
          sum = fmaf(v.x, v.x, sum);
          sum = fmaf(v.y, v.y, sum);
          sum = fmaf(v.z, v.z, sum);
          sum = fmaf(v.w, v.w, sum);
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      q2acc[h] += sum;
    }
  }
  if (pq == 0) {
#pragma unroll
    for (int h = 0; h < kRowsPerBlock / kPrepRows; ++h) q2s[pr + kPrepRows * h] = q2acc[h];
  }

  PmtTop2<float> best[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) best[r] = PmtTop2<float>::empty(kPmtBig);
  float acc[4][16];
  float t2acc[kTileCols / kPrepRows];

  for (int st = 0; st < nsteps; ++st) {
    const int buf = st & 1;
    const int it = st / nchunks, c = st - it * nchunks;
    pmt_cp_async_wait<0>();                    // step st has landed
    __syncthreads();                           // ... for all; step st-1 consumed
    if (st + 1 < nsteps) stage(st + 1, buf ^ 1);
    pmt_cp_async_commit();
    float* qd = qs + buf * kRowsPerBlock * LD;
    float* td = ts + buf * kTileCols * LD;
    if (c == 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[r][j] = 0.f;
#pragma unroll
      for (int h = 0; h < kTileCols / kPrepRows; ++h) t2acc[h] = 0.f;
    }
#pragma unroll
    for (int h = 0; h < kTileCols / kPrepRows; ++h)
      t2acc[h] += prep_row<kChunk, BF16>(&td[(pr + kPrepRows * h) * LD], pq);
    if (BF16) {
#pragma unroll
      for (int h = 0; h < kRowsPerBlock / kPrepRows; ++h)
        prep_row<kChunk, true>(&qd[(pr + kPrepRows * h) * LD], pq);
    }
    const int base = begin + it * kTileCols;
    if (c == nchunks - 1 && pq == 0) {
#pragma unroll
      for (int h = 0; h < kTileCols / kPrepRows; ++h) {
        const int j = base + pr + kPrepRows * h;
        t2s[pr + kPrepRows * h] = j < end && mb[j] ? t2acc[h] : kPmtBig;
      }
    }
    __syncthreads();                           // chunk sums and rounding done

    const float* qrow = &qd[(32 * w + qg) * LD];
    const float* tcol = &td[cg * LD];
#pragma unroll 2
    for (int k = 0; k < kChunk; k += 4) {
      float4 a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[r] = *reinterpret_cast<const float4*>(qrow + 8 * r * LD + k);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(tcol + 4 * j * LD + k);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][j] = fmaf(a[r].x, v.x, acc[r][j]);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][j] = fmaf(a[r].y, v.y, acc[r][j]);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][j] = fmaf(a[r].z, v.z, acc[r][j]);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][j] = fmaf(a[r].w, v.w, acc[r][j]);
      }
    }
    if (c == nchunks - 1) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {           // columns in increasing order
        const float t2 = t2s[cg + 4 * j];
#pragma unroll
        for (int r = 0; r < 4; ++r) best[r].push(t2 - 2.0f * acc[r][j], base + cg + 4 * j);
      }
    }
  }
  __syncthreads();                             // q2s is visible with no step too

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    best[r].merge_lane(8);
    best[r].merge_lane(16);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int lr = 32 * w + qg + 8 * r;
    if (cg != r || row0 + lr >= N1) continue;
    const size_t o = static_cast<size_t>(b) * N1 + row0 + lr;
    if (S == 1) {
      write_result<POINTS>(best[r], q2s[lr], o, b, t_points, dist, idx, pts, N2, P);
    } else {
      part[(static_cast<size_t>(b) * S + s) * N1 + row0 + lr] = pmt_pack(best[r]);
      if (s == 0) q2buf[o] = q2s[lr];
    }
  }
}

// one thread per (pair, query row): the S partials merged in split order
template <bool POINTS>
__global__ void __launch_bounds__(kMergeThreads)
l2_top2_merge_kernel(const int4* __restrict__ part, const float* __restrict__ q2buf,
                     const float* __restrict__ t_points, float* __restrict__ dist,
                     int* __restrict__ idx, float* __restrict__ pts, int B, int N1,
                     int N2, int P, int S) {
  const size_t o = static_cast<size_t>(blockIdx.x) * kMergeThreads + threadIdx.x;
  if (o >= static_cast<size_t>(B) * N1) return;
  const int b = static_cast<int>(o / N1), row = static_cast<int>(o % N1);
  const int4* pp = part + static_cast<size_t>(b) * S * N1 + row;
  PmtTop2<float> best, next;
  pmt_unpack(pp[0], &best);
  for (int s = 1; s < S; ++s) {
    pmt_unpack(pp[static_cast<size_t>(s) * N1], &next);
    best.merge(next);
  }
  write_result<POINTS>(best, q2buf[o], o, b, t_points, dist, idx, pts, N2, P);
}

// D = 0: the chunked kernel over Dc columns (a multiple of kChunk)
template <int D, bool BF16, bool POINTS>
void launch(const float* q, const float* t, const uint8_t* t_mask,
            const float* t_points, float* dist, int* idx, float* pts, int4* part,
            float* q2buf, int B, int N1, int N2, int Dc, int P, int S,
            cudaStream_t stream) {
  const dim3 grid((N1 + kRowsPerBlock - 1) / kRowsPerBlock, S, B);
  if constexpr (D == 0) {
    cudaFuncSetAttribute(l2_top2_chunked_kernel<BF16, POINTS>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kChunkSmemBytes);
    l2_top2_chunked_kernel<BF16, POINTS><<<grid, kThreads, kChunkSmemBytes, stream>>>(
        q, t, t_mask, t_points, dist, idx, pts, part, q2buf, N1, N2, Dc, P);
  } else {
    constexpr int kSmemBytes = smem_bytes<D>();
    cudaFuncSetAttribute(l2_top2_kernel<D, BF16, POINTS>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    l2_top2_kernel<D, BF16, POINTS><<<grid, kThreads, kSmemBytes, stream>>>(
        q, t, t_mask, t_points, dist, idx, pts, part, q2buf, N1, N2, P);
  }
  if (S > 1) {
    const size_t rows = static_cast<size_t>(B) * N1;
    const unsigned blocks = static_cast<unsigned>((rows + kMergeThreads - 1) / kMergeThreads);
    l2_top2_merge_kernel<POINTS><<<blocks, kMergeThreads, 0, stream>>>(
        part, q2buf, t_points, dist, idx, pts, B, N1, N2, P, S);
  }
}

}  // namespace

// q [B, N1, D] f32, t [B, N2, D] f32, t_mask [B, N2] bool,
// t_points [B, N2, P] f32 or NULL → dist [B, N1, 2] f32, idx [B, N1, 2] i32,
// pts [B, N1, P] f32 (when t_points is given).  D must be 32, 64, 128 or a
// multiple of 64 above 128 (the chunked kernel).  S train
// splits; with S > 1, part [B, S, N1] int4 and q2buf [B, N1] f32 are the
// wrapper's scratch.  Returns the status of the launches.
PMT_EXPORT int pmt_l2_top2(const void* q, const void* t, const void* t_mask,
                           const void* t_points, void* dist, void* idx,
                           void* pts, void* part, void* q2buf, int B, int N1,
                           int N2, int D_in, int P, int S, int bf16,
                           void* stream) {
  const bool chunked = D_in > 128 && D_in % kChunk == 0;
  if ((D_in != 32 && D_in != 64 && D_in != 128 && !chunked) || S < 1 || S > 65535 ||
      B > 65535 ||
      (S > 1 && (part == nullptr || q2buf == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N1 == 0) return 0;
  const auto* qf = static_cast<const float*>(q);
  const auto* tf = static_cast<const float*>(t);
  const auto* mf = static_cast<const uint8_t*>(t_mask);
  const auto* tp = static_cast<const float*>(t_points);
  auto* df = static_cast<float*>(dist);
  auto* xi = static_cast<int*>(idx);
  auto* pf = static_cast<float*>(pts);
  auto* pa = static_cast<int4*>(part);
  auto* q2 = static_cast<float*>(q2buf);
  auto st = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if (bf16) {
      if (tp) launch<kD, true, true>(qf, tf, mf, tp, df, xi, pf, pa, q2, B, N1, N2, D_in, P, S, st);
      else launch<kD, true, false>(qf, tf, mf, tp, df, xi, pf, pa, q2, B, N1, N2, D_in, P, S, st);
    } else {
      if (tp) launch<kD, false, true>(qf, tf, mf, tp, df, xi, pf, pa, q2, B, N1, N2, D_in, P, S, st);
      else launch<kD, false, false>(qf, tf, mf, tp, df, xi, pf, pa, q2, B, N1, N2, D_in, P, S, st);
    }
  };
  if (chunked) go(std::integral_constant<int, 0>{});
  else if (D_in == 128) go(std::integral_constant<int, 128>{});
  else if (D_in == 64) go(std::integral_constant<int, 64>{});
  else go(std::integral_constant<int, 32>{});
  PMT_RETURN_LAUNCH_STATUS();
}

PMT_EXPORT const char* pmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
