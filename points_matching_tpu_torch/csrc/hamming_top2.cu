// K4 — fused popcount-Hamming distance + top-2 matcher for packed binary
// (ORB/BRIEF) descriptors, batched over pairs.
//
// Replaces the TPU kernel points_matching_tpu/ops/pallas/hamming.py
// fused_hamming_top2 (_hamming_top2_kernel, _popcount_u32).  Same contract:
// d(i, j) = Σ_w popcount(q[i, w] ⊕ t[j, w]) over the W = 8 words of a
// 256-bit descriptor, +1e30 on invalid train rows; per query row the
// smallest and the runner-up distance (f32 counts) and their columns; the
// [N1, N2] distance matrix never exists in memory.
//
// Design (K1's, with integers): one block = one pair × 128 query rows, one
// thread per query row.  The row's 8 query words live in registers; train
// rows are staged through shared memory in tiles of 1024 rows (32 KB) and
// read back as broadcasts (every thread of a warp reads the same address),
// two 16-byte loads per train row.  A distance is 8 XORs, 8 __popc and the
// adds; an invalid train row adds kSentinel, which no valid count reaches.
// Each thread scans the columns in increasing order and keeps (b1, b2, i1,
// i2) in registers with the strict `<` update
//     d < b1 → (b2, i2) = (b1, i1), (b1, i1) = (d, j);  else d < b2 → (b2, i2) = (d, j)
// which gives column 0 = the lowest index attaining the minimum and column
// 1 = the lowest index other than column 0 attaining the runner-up — the
// answer of two argmin passes (the plain version and the reference's XLA
// knn_match).  The TPU kernel's cross-tile duel can return another index
// tied at the runner-up distance, so the tests hold column 1 only to
// "attains the runner-up distance".  The sentinels start at (kSentinel,
// index 0) and are reported as 1e30, which reproduces the reference's
// answer when fewer than two train rows are valid.
//
// What bounds it on the card: POPC throughput.  sm_90 retires 16 population
// counts per clock per SM (one quarter of its integer-ALU rate), and the
// kernel needs B·N1·N2·W of them; the XORs and adds go to the 64-wide
// integer pipe and the broadcast loads to the LSU.  At 64 pairs × 1024 ×
// 1024 × 8 words that is 5.4e8 POPC ≈ 0.13 ms at 1.98 GHz on 132 SMs,
// against 4 MB of inputs (~1.3 µs at 3.35 TB/s).  One pair of 1024 rows
// fills only 8 blocks of 128 threads on a 132-SM card: the single-pair
// path is occupancy-bound until the train axis is split across blocks.
#include "pmt_common.cuh"

namespace {

constexpr int kRowsPerBlock = 128;
constexpr int kTileRows = 1024;          // 32 KB of train rows per tile
constexpr int W = 8;                     // 32-bit words per descriptor: 256-bit ORB
constexpr int kSentinel = 1 << 30;       // "1e30": above any count (≤ 32·W)

__global__ void __launch_bounds__(kRowsPerBlock)
hamming_top2_kernel(const uint32_t* __restrict__ q,
                    const uint32_t* __restrict__ t,
                    const uint8_t* __restrict__ t_mask,
                    float* __restrict__ dist, int* __restrict__ idx, int N1,
                    int N2) {
  __shared__ uint4 ts[kTileRows * (W / 4)];
  __shared__ int bias[kTileRows];

  const int b = blockIdx.y;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x;
  const bool active = row < N1;
  const uint4* tb = reinterpret_cast<const uint4*>(t) +
                    static_cast<size_t>(b) * N2 * (W / 4);
  const uint8_t* mb = t_mask + static_cast<size_t>(b) * N2;

  uint4 q0 = make_uint4(0u, 0u, 0u, 0u), q1 = q0;
  if (active) {
    const uint4* qv = reinterpret_cast<const uint4*>(q) +
                      (static_cast<size_t>(b) * N1 + row) * (W / 4);
    q0 = qv[0];
    q1 = qv[1];
  }

  int b1 = kSentinel, b2 = kSentinel;
  int i1 = 0, i2 = 0;

  for (int base = 0; base < N2; base += kTileRows) {
    const int rows = min(kTileRows, N2 - base);
    __syncthreads();  // the previous tile is fully consumed
    const uint4* src = tb + static_cast<size_t>(base) * (W / 4);
    for (int e = threadIdx.x; e < rows * (W / 4); e += kRowsPerBlock) ts[e] = src[e];
    for (int r = threadIdx.x; r < rows; r += kRowsPerBlock)
      bias[r] = mb[base + r] ? 0 : kSentinel;
    __syncthreads();

    if (active) {
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const uint4 u = ts[2 * r];
        const uint4 v = ts[2 * r + 1];
        const int d = __popc(q0.x ^ u.x) + __popc(q0.y ^ u.y) +
                      __popc(q0.z ^ u.z) + __popc(q0.w ^ u.w) +
                      __popc(q1.x ^ v.x) + __popc(q1.y ^ v.y) +
                      __popc(q1.z ^ v.z) + __popc(q1.w ^ v.w) + bias[r];
        const int j = base + r;
        if (d < b1) {
          b2 = b1;
          i2 = i1;
          b1 = d;
          i1 = j;
        } else if (d < b2) {
          b2 = d;
          i2 = j;
        }
      }
    }
  }

  if (!active) return;
  const size_t o = static_cast<size_t>(b) * N1 + row;
  dist[2 * o + 0] = b1 >= kSentinel ? kPmtBig : static_cast<float>(b1);
  dist[2 * o + 1] = b2 >= kSentinel ? kPmtBig : static_cast<float>(b2);
  idx[2 * o + 0] = i1;
  idx[2 * o + 1] = i2;
}

}  // namespace

// q [B, N1, W] u32, t [B, N2, W] u32, t_mask [B, N2] bool →
// dist [B, N1, 2] f32 counts, idx [B, N1, 2] i32.  W must be 8.
PMT_EXPORT int pmt_hamming_top2(const void* q, const void* t, const void* t_mask,
                                void* dist, void* idx, int B, int N1, int N2,
                                int W_in, void* stream) {
  if (W_in != W) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N1 == 0) return 0;
  const dim3 grid((N1 + kRowsPerBlock - 1) / kRowsPerBlock, B);
  hamming_top2_kernel<<<grid, kRowsPerBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(t),
      static_cast<const uint8_t*>(t_mask), static_cast<float*>(dist),
      static_cast<int*>(idx), N1, N2);
  PMT_RETURN_LAUNCH_STATUS();
}
