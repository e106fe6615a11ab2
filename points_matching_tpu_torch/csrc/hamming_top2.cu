// K4 — fused popcount-Hamming distance + top-2 matcher for packed binary
// (ORB/BRIEF) descriptors, batched over pairs.
//
// Replaces the TPU kernel points_matching_tpu/ops/pallas/hamming.py
// fused_hamming_top2 (_hamming_top2_kernel, _popcount_u32).  Same contract:
// d(i, j) = Σ_w popcount(q[i, w] ⊕ t[j, w]) over the W words of a
// descriptor, +1e30 on invalid train rows; per query row the
// smallest and the runner-up distance (f32 counts) and their columns; the
// [N1, N2] distance matrix never exists in memory.
//
// Grid (K1's): (query tiles of 256 rows) × (S train splits) × (pairs).  The
// wrapper picks S from the pair count and the SM count
// (`_build.train_splits`) so that one pair of 1024 × 1024 still launches ≥
// 132 blocks (4 query tiles × 33 splits); at 64 pairs S = 1.  Split s scans
// the train columns [s·N2/S, (s+1)·N2/S).
//
// Block: 128 threads, each holding 2 query rows (rows tid and tid + 128 of
// the tile) in registers, 2·W words.  Train rows arrive in a
// double-buffered ring of 256-row tiles (32·W bytes) by cp.async while the
// previous tile is consumed, and are read back as warp broadcasts (every
// thread of a warp reads the same address): each W/4 16-byte loads feed
// 2·W XOR + __popc, two distances.  An invalid train row adds kSentinel,
// which no valid count reaches; its mask byte is loaded one tile ahead.
//
// W is a template parameter, built for 8 (256-bit ORB/BRIEF) and 16
// (512-bit); the wrapper pads any narrower width with zero words up to the
// next of these, which adds no bits to any XOR.
//
// Wider rows (W > 16, padded with zero words to a multiple of 8) take the
// chunked kernel: the same grid and rows a thread, but a train tile of 32
// rows is consumed in W / 8 steps of one 8-word chunk each (the query rows'
// chunk read from global memory, the tile's from a double-buffered ring in
// shared memory).  Each thread keeps a count per (query row, tile row) in
// registers across the chunks, and a count enters the top-2 only after the
// tile's last chunk: the counts are exact integer sums, so every result is
// the fast path's.
//
// Top-2: each thread visits its columns in increasing order with the strict
// `<` update (PmtTop2::push) from the sentinels (kSentinel, 0).  With S = 1
// the block writes the result; with S > 1 it leaves a partial (d1, i1, d2,
// i2) per (split, row) in scratch and a second kernel on the same stream
// merges the S partials lexicographically by (d, column) — exact
// (pmt_common.cuh: PmtTop2).  So column 0 is the lowest index attaining the
// minimum and column 1 the lowest index other than column 0 attaining the
// runner-up — the answer of two argmin passes (the plain version and the
// reference's XLA knn_match) on every row.  The TPU kernel's cross-tile duel
// can return another index tied at the runner-up distance, so the parity
// tests against it hold column 1 only to "attains the runner-up distance".
// Sentinels are reported as 1e30, which reproduces the reference's answer
// when fewer than two train rows are valid.
//
// What bounds it on the card: POPC throughput.  sm_90 retires 16 population
// counts per clock per SM (one quarter of its integer-ALU rate), and the
// kernel needs B·N1·N2·W of them; the XORs and adds go to the 64-wide
// integer pipe and the broadcast loads to the LSU.  At 64 pairs × 1024 ×
// 1024 × 8 words that is 5.4e8 POPC ≈ 0.13 ms at 1.98 GHz on 132 SMs,
// against 4 MB of inputs (~1.3 µs at 3.35 TB/s); one pair needs 8.4e6 POPC,
// ~2 µs, below the time a launch takes.  A tensor-core path
// (mma .b1 .and.popc: popc(a) + popc(b) − 2·popc(a & b)) is a later option.
#include "pmt_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerThread = 2;
constexpr int kRowsPerBlock = kThreads * kRowsPerThread;
constexpr int kTileRows = 256;           // 32·W bytes of train rows per tile
constexpr int kSentinel = 1 << 30;       // "1e30": above any count (≤ 32·W)
constexpr int kMergeThreads = 256;

// popcount(q ⊕ t) over the W / 4 16-byte chunks of a descriptor, in order
template <int W>
__device__ __forceinline__ int hamming(const uint4 (&q)[W / 4], const uint4 (&t)[W / 4]) {
  int d = 0;
#pragma unroll
  for (int c = 0; c < W / 4; ++c)
    d += __popc(q[c].x ^ t[c].x) + __popc(q[c].y ^ t[c].y) + __popc(q[c].z ^ t[c].z) +
         __popc(q[c].w ^ t[c].w);
  return d;
}

__device__ __forceinline__ void write_result(const PmtTop2<int>& p, size_t o,
                                             float* __restrict__ dist,
                                             int* __restrict__ idx) {
  dist[2 * o + 0] = p.d1 >= kSentinel ? kPmtBig : static_cast<float>(p.d1);
  dist[2 * o + 1] = p.d2 >= kSentinel ? kPmtBig : static_cast<float>(p.d2);
  idx[2 * o + 0] = p.i1;
  idx[2 * o + 1] = p.i2;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
hamming_top2_kernel(const uint32_t* __restrict__ q,
                    const uint32_t* __restrict__ t,
                    const uint8_t* __restrict__ t_mask,
                    float* __restrict__ dist, int* __restrict__ idx,
                    int4* __restrict__ part, int N1, int N2) {
  __shared__ uint4 ts[2][kTileRows * (W / 4)];
  __shared__ int bias[2][kTileRows];

  const int tid = threadIdx.x;
  const int b = blockIdx.z, s = blockIdx.y, S = gridDim.y;
  const int row0 = blockIdx.x * kRowsPerBlock;
  int begin, end;
  pmt_split_range(s, S, N2, &begin, &end);
  const int ntiles = (end - begin + kTileRows - 1) / kTileRows;

  const uint4* tb = reinterpret_cast<const uint4*>(t) +
                    static_cast<size_t>(b) * N2 * (W / 4);
  const uint8_t* mb = t_mask + static_cast<size_t>(b) * N2;

  auto stage = [&](int tile, int buf) {
    const int base = begin + tile * kTileRows;
    const int n = min(kTileRows, end - base) * (W / 4);
    const uint4* src = tb + static_cast<size_t>(base) * (W / 4);
    for (int e = tid; e < n; e += kThreads) pmt_cp_async16(&ts[buf][e], src + e);
  };
  // the bias of this thread's rows tid and tid + 128 of a tile, two bits
  auto valid_bits = [&](int tile) -> int {
    int bits = 0;
#pragma unroll
    for (int h = 0; h < kTileRows / kThreads; ++h) {
      const int j = begin + tile * kTileRows + tid + h * kThreads;
      if (tile < ntiles && j < end && mb[j]) bits |= 1 << h;
    }
    return bits;
  };

  if (ntiles > 0) stage(0, 0);
  pmt_cp_async_commit();
  int m_cur = valid_bits(0);

  uint4 qw[kRowsPerThread][W / 4];
#pragma unroll
  for (int h = 0; h < kRowsPerThread; ++h) {
    const int row = row0 + tid + h * kThreads;
    const uint4* qv = reinterpret_cast<const uint4*>(q) +
                      (static_cast<size_t>(b) * N1 + row) * (W / 4);
#pragma unroll
    for (int c = 0; c < W / 4; ++c) qw[h][c] = row < N1 ? qv[c] : make_uint4(0u, 0u, 0u, 0u);
  }

  PmtTop2<int> best[kRowsPerThread];
#pragma unroll
  for (int h = 0; h < kRowsPerThread; ++h) best[h] = PmtTop2<int>::empty(kSentinel);

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) stage(it + 1, buf ^ 1);
    pmt_cp_async_commit();
    const int m_next = valid_bits(it + 1);
#pragma unroll
    for (int h = 0; h < kTileRows / kThreads; ++h)
      bias[buf][tid + h * kThreads] = (m_cur >> h) & 1 ? 0 : kSentinel;
    pmt_cp_async_wait<1>();                    // tile `it` has landed
    __syncthreads();

    const int base = begin + it * kTileRows;
    const int rows = min(kTileRows, end - base);
    const uint4* tv = ts[buf];
    const int* bv = bias[buf];
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      uint4 u[W / 4];
#pragma unroll
      for (int c = 0; c < W / 4; ++c) u[c] = tv[(W / 4) * r + c];
      const int bb = bv[r];
#pragma unroll
      for (int h = 0; h < kRowsPerThread; ++h)
        best[h].push(hamming<W>(qw[h], u) + bb, base + r);
    }
    m_cur = m_next;
    __syncthreads();                           // tile consumed before refill
  }

#pragma unroll
  for (int h = 0; h < kRowsPerThread; ++h) {
    const int row = row0 + tid + h * kThreads;
    if (row >= N1) continue;
    const size_t o = static_cast<size_t>(b) * N1 + row;
    if (S == 1)
      write_result(best[h], o, dist, idx);
    else
      part[(static_cast<size_t>(b) * S + s) * N1 + row] = pmt_pack(best[h]);
  }
}

// The chunked path (W > 16): 8-word chunks of the width, 32-row tiles.
constexpr int kChunkWords = 8;
constexpr int kChunkTileRows = 32;

__global__ void __launch_bounds__(kThreads)
hamming_top2_chunked_kernel(const uint32_t* __restrict__ q,
                            const uint32_t* __restrict__ t,
                            const uint8_t* __restrict__ t_mask,
                            float* __restrict__ dist, int* __restrict__ idx,
                            int4* __restrict__ part, int N1, int N2, int W) {
  constexpr int kPieces = kChunkWords / 4;     // 16-byte pieces of a chunk row
  __shared__ uint4 ts[2][kChunkTileRows * kPieces];

  const int tid = threadIdx.x;
  const int b = blockIdx.z, s = blockIdx.y, S = gridDim.y;
  const int row0 = blockIdx.x * kRowsPerBlock;
  int begin, end;
  pmt_split_range(s, S, N2, &begin, &end);
  const int ntiles = (end - begin + kChunkTileRows - 1) / kChunkTileRows;
  const int nchunks = W / kChunkWords;
  const int nsteps = ntiles * nchunks;

  const uint32_t* qb = q + static_cast<size_t>(b) * N1 * W;
  const uint32_t* tb = t + static_cast<size_t>(b) * N2 * W;
  const uint8_t* mb = t_mask + static_cast<size_t>(b) * N2;

  // step st stages chunk st % nchunks of train tile st / nchunks
  auto stage = [&](int st, int buf) {
    const int tile = st / nchunks, col = (st - tile * nchunks) * kChunkWords;
    const int base = begin + tile * kChunkTileRows;
    const int n = min(kChunkTileRows, end - base) * kPieces;
    for (int e = tid; e < n; e += kThreads) {
      const int r = e / kPieces, c = e % kPieces;
      pmt_cp_async16(&ts[buf][e], reinterpret_cast<const uint4*>(
                                      tb + static_cast<size_t>(base + r) * W + col) + c);
    }
  };
  if (nsteps > 0) stage(0, 0);
  pmt_cp_async_commit();

  PmtTop2<int> best[kRowsPerThread];
#pragma unroll
  for (int h = 0; h < kRowsPerThread; ++h) best[h] = PmtTop2<int>::empty(kSentinel);
  int acc[kRowsPerThread][kChunkTileRows];

  for (int st = 0; st < nsteps; ++st) {
    const int buf = st & 1;
    const int it = st / nchunks, c = st - it * nchunks;
    if (st + 1 < nsteps) stage(st + 1, buf ^ 1);
    pmt_cp_async_commit();
    uint4 qw[kRowsPerThread][kPieces];
#pragma unroll
    for (int h = 0; h < kRowsPerThread; ++h) {
      const int row = row0 + tid + h * kThreads;
      const uint4* qv = reinterpret_cast<const uint4*>(
          qb + static_cast<size_t>(row) * W + c * kChunkWords);
#pragma unroll
      for (int k = 0; k < kPieces; ++k) qw[h][k] = row < N1 ? qv[k] : make_uint4(0u, 0u, 0u, 0u);
    }
    if (c == 0) {
#pragma unroll
      for (int h = 0; h < kRowsPerThread; ++h)
#pragma unroll
        for (int r = 0; r < kChunkTileRows; ++r) acc[h][r] = 0;
    }
    pmt_cp_async_wait<1>();                    // step st has landed
    __syncthreads();

    const uint4* tv = ts[buf];
#pragma unroll
    for (int r = 0; r < kChunkTileRows; ++r) {
      uint4 u[kPieces];
#pragma unroll
      for (int k = 0; k < kPieces; ++k) u[k] = tv[kPieces * r + k];
#pragma unroll
      for (int h = 0; h < kRowsPerThread; ++h) acc[h][r] += hamming<kChunkWords>(qw[h], u);
    }
    if (c == nchunks - 1) {
      const int base = begin + it * kChunkTileRows;
#pragma unroll
      for (int r = 0; r < kChunkTileRows; ++r) {   // columns in increasing order
        const int j = base + r;
        if (j >= end) break;
        const int bb = mb[j] ? 0 : kSentinel;
#pragma unroll
        for (int h = 0; h < kRowsPerThread; ++h) best[h].push(acc[h][r] + bb, j);
      }
    }
    __syncthreads();                           // step consumed before refill
  }

#pragma unroll
  for (int h = 0; h < kRowsPerThread; ++h) {
    const int row = row0 + tid + h * kThreads;
    if (row >= N1) continue;
    const size_t o = static_cast<size_t>(b) * N1 + row;
    if (S == 1)
      write_result(best[h], o, dist, idx);
    else
      part[(static_cast<size_t>(b) * S + s) * N1 + row] = pmt_pack(best[h]);
  }
}

// one thread per (pair, query row): the S partials merged in split order
__global__ void __launch_bounds__(kMergeThreads)
hamming_top2_merge_kernel(const int4* __restrict__ part, float* __restrict__ dist,
                          int* __restrict__ idx, int B, int N1, int S) {
  const size_t o = static_cast<size_t>(blockIdx.x) * kMergeThreads + threadIdx.x;
  if (o >= static_cast<size_t>(B) * N1) return;
  const int b = static_cast<int>(o / N1), row = static_cast<int>(o % N1);
  const int4* pp = part + static_cast<size_t>(b) * S * N1 + row;
  PmtTop2<int> best, next;
  pmt_unpack(pp[0], &best);
  for (int s = 1; s < S; ++s) {
    pmt_unpack(pp[static_cast<size_t>(s) * N1], &next);
    best.merge(next);
  }
  write_result(best, o, dist, idx);
}

}  // namespace

// q [B, N1, W] u32, t [B, N2, W] u32, t_mask [B, N2] bool →
// dist [B, N1, 2] f32 counts, idx [B, N1, 2] i32.  W must be 8, 16 or a
// multiple of 8 above 16 (the chunked kernel).  S
// train splits; with S > 1, part [B, S, N1] int4 is the wrapper's scratch.
// Returns the status of the launches.
PMT_EXPORT int pmt_hamming_top2(const void* q, const void* t, const void* t_mask,
                                void* dist, void* idx, void* part, int B, int N1,
                                int N2, int W_in, int S, void* stream) {
  const bool chunked = W_in > 16 && W_in % kChunkWords == 0;
  if ((W_in != 8 && W_in != 16 && !chunked) || S < 1 || S > 65535 || B > 65535 ||
      (S > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N1 == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N1 + kRowsPerBlock - 1) / kRowsPerBlock, S, B);
  const auto* qu = static_cast<const uint32_t*>(q);
  const auto* tu = static_cast<const uint32_t*>(t);
  const auto* mu = static_cast<const uint8_t*>(t_mask);
  if (chunked)
    hamming_top2_chunked_kernel<<<grid, kThreads, 0, st>>>(
        qu, tu, mu, static_cast<float*>(dist), static_cast<int*>(idx),
        static_cast<int4*>(part), N1, N2, W_in);
  else if (W_in == 16)
    hamming_top2_kernel<16><<<grid, kThreads, 0, st>>>(
        qu, tu, mu, static_cast<float*>(dist), static_cast<int*>(idx),
        static_cast<int4*>(part), N1, N2);
  else
    hamming_top2_kernel<8><<<grid, kThreads, 0, st>>>(
        qu, tu, mu, static_cast<float*>(dist), static_cast<int*>(idx),
        static_cast<int4*>(part), N1, N2);
  if (S > 1) {
    const size_t rows = static_cast<size_t>(B) * N1;
    hamming_top2_merge_kernel<<<static_cast<unsigned>((rows + kMergeThreads - 1) /
                                                      kMergeThreads),
                                kMergeThreads, 0, st>>>(
        static_cast<const int4*>(part), static_cast<float*>(dist),
        static_cast<int*>(idx), B, N1, S);
  }
  PMT_RETURN_LAUNCH_STATUS();
}
