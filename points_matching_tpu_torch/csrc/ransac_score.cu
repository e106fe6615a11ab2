// K2 — RANSAC hypothesis scoring: per-hypothesis inlier counts under the
// Sampson gate, reduced on chip so only the [B, H] counts reach memory.
//
// Replaces the TPU kernel points_matching_tpu/ops/pallas/ransac_kernel.py
// ransac_score_hypotheses (_score_kernel).  Same gate, in the same
// multiply-compare form:
//     a = F·p1h, b = Fᵀ·p2h, r = p2ᵀF p1 = a1·x2 + a2·y2 + a3,
//     denom = a1² + a2² + b1² + b2²,
//     inlier ⇔ r² < τ²·max(denom, 1e-12)  and  the correspondence is valid.
// The products are written in the association order of
// geometry/fundamental.py:sampson_distance; built with --fmad=false, each
// operation rounds once, exactly as the plain PyTorch version does.
//
// Design: one warp per (pair, hypothesis); F sits in registers; the pair's
// correspondences are staged through shared memory in chunks of 1024
// (x1, y1, x2, y2, valid) and the 32 lanes stride over them; the count is
// a warp-shuffle sum.  A block holds 8 hypotheses of one pair, so every
// staged chunk is reused 8 times.
//
// What bounds it on the card: fp32 issue — ~35 flops per (h, n) cell
// against 17 bytes per point per block; the K = 3 products are too small
// for tensor cores.  At H = N = 512 a pair is 9 Mflop, a few µs of one SM.
#include "pmt_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kChunk = 1024;

__global__ void __launch_bounds__(kWarps * 32)
ransac_score_kernel(const float* __restrict__ F, const float* __restrict__ p1,
                    const float* __restrict__ p2,
                    const uint8_t* __restrict__ mask, int* __restrict__ counts,
                    int H, int N, float tau2) {
  __shared__ float4 pts[kChunk];  // (x1, y1, x2, y2)
  __shared__ uint8_t valid[kChunk];

  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.x * kWarps + warp;
  const bool active = h < H;

  float f[9];
#pragma unroll
  for (int i = 0; i < 9; ++i)
    f[i] = active ? F[(static_cast<size_t>(b) * H + h) * 9 + i] : 0.f;

  int cnt = 0;
  for (int base = 0; base < N; base += kChunk) {
    const int n = min(kChunk, N - base);
    __syncthreads();  // the previous chunk is fully consumed
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const size_t g = static_cast<size_t>(b) * N + base + e;
      const float2 u = reinterpret_cast<const float2*>(p1)[g];
      const float2 v = reinterpret_cast<const float2*>(p2)[g];
      pts[e] = make_float4(u.x, u.y, v.x, v.y);
      valid[e] = mask[g];
    }
    __syncthreads();
    if (!active) continue;
    for (int e = lane; e < n; e += 32) {
      const float4 p = pts[e];
      const float a1 = f[0] * p.x + f[1] * p.y + f[2];
      const float a2 = f[3] * p.x + f[4] * p.y + f[5];
      const float a3 = f[6] * p.x + f[7] * p.y + f[8];
      const float b1 = f[0] * p.z + f[3] * p.w + f[6];
      const float b2 = f[1] * p.z + f[4] * p.w + f[7];
      const float r = a1 * p.z + a2 * p.w + a3;
      const float denom = a1 * a1 + a2 * a2 + b1 * b1 + b2 * b2;
      cnt += (r * r < tau2 * fmaxf(denom, 1e-12f)) && valid[e];
    }
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, o);
  if (active && lane == 0) counts[static_cast<size_t>(b) * H + h] = cnt;
}

}  // namespace

// F [B, H, 3, 3] f32, p1/p2 [B, N, 2] f32, mask [B, N] bool → counts [B, H] i32
PMT_EXPORT int pmt_ransac_score(const void* F, const void* p1, const void* p2,
                                const void* mask, void* counts, int B, int H,
                                int N, float tau2, void* stream) {
  if (B == 0 || H == 0) return 0;
  const dim3 grid((H + kWarps - 1) / kWarps, B);
  ransac_score_kernel<<<grid, kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(F), static_cast<const float*>(p1),
      static_cast<const float*>(p2), static_cast<const uint8_t*>(mask),
      static_cast<int*>(counts), H, N, tau2);
  PMT_RETURN_LAUNCH_STATUS();
}
