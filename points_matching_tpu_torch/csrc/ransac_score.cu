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
// operation rounds once, exactly as the plain PyTorch version does, and the
// max propagates NaN as clamp_min does.  Counts are integer sums, so any
// order of summation gives the plain version's counts bit for bit.
//
// What bounds it on the card: fp32 issue — ~36 operations per (hypothesis,
// point) cell against 17 bytes per point and 40 per hypothesis; the K = 3
// products are too small for tensor cores (and would round otherwise).  At
// one pair (the two-view paths) it is the latency of a launch, one load of
// the points and a lane's chain of cells.
//
// Design: a warp scores one hypothesis at a time, its 32 lanes splitting
// the pair's points.  A block stages a pass of 32 · kRegs points into
// shared memory once, a masked point with x1 = NaN (no gate passes a NaN,
// so the mask costs no operation per cell); each lane then holds kRegs
// points in registers and runs them through every hypothesis of its warp,
// so a loaded point serves per_warp hypotheses and a cell is its gate and
// one add.  A warp's count is one REDUX (__reduce_add_sync); lane j keeps
// the count of the warp's j-th hypothesis.  The wrapper picks the warps a
// block and the hypotheses a warp from the shape and the SM count
// (_build.ransac_score_tile): at one pair, two warps a block and one
// hypothesis a warp spread the pair over every SM; at many pairs, eight
// warps a block and up to sixteen hypotheses a warp reuse each point.
#include "pmt_common.cuh"

namespace {

// max(x, lo) that returns NaN for a NaN x, as torch.clamp_min does
__device__ __forceinline__ float max_nan(float x, float lo) {
  float y;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(x), "f"(lo));
  return y;
}

// the gate of one cell, in the plain version's operation order
__device__ __forceinline__ int inlier(const float (&f)[9], float4 p, float tau2) {
  const float a1 = f[0] * p.x + f[1] * p.y + f[2];
  const float a2 = f[3] * p.x + f[4] * p.y + f[5];
  const float a3 = f[6] * p.x + f[7] * p.y + f[8];
  const float b1 = f[0] * p.z + f[3] * p.w + f[6];
  const float b2 = f[1] * p.z + f[4] * p.w + f[7];
  const float r = a1 * p.z + a2 * p.w + a3;
  const float denom = a1 * a1 + a2 * a2 + b1 * b1 + b2 * b2;
  return r * r < tau2 * max_nan(denom, 1e-12f);
}

template <int kWarps, int kRegs>
__global__ void __launch_bounds__(kWarps * 32)
ransac_score_kernel(const float* __restrict__ F, const float2* __restrict__ p1,
                    const float2* __restrict__ p2, const uint8_t* __restrict__ mask,
                    int* __restrict__ counts, int H, int N, float tau2, int per_warp) {
  constexpr int kPass = 32 * kRegs;            // points a pass
  constexpr int kThreads = 32 * kWarps;
  constexpr int kPer = kPass / kThreads;       // points a thread stages a pass
  __shared__ float4 pts[kPass];                // (x1 or NaN, y1, x2, y2)

  const int lane = threadIdx.x % 32;
  const int b = blockIdx.y;
  const int h0 = (blockIdx.x * kWarps + threadIdx.x / 32) * per_warp;
  const int nk = min(per_warp, H - h0);        // this warp's hypotheses: h0 + [0, nk)
  const size_t row = static_cast<size_t>(b) * N;
  const float* Fw = F + (static_cast<size_t>(b) * H + min(h0, H - 1)) * 9;
  const float nan = __int_as_float(0x7fc00000);
  float f0[9];                                 // the first hypothesis, loaded with the points
#pragma unroll
  for (int i = 0; i < 9; ++i) f0[i] = Fw[i];

  int total = 0;                               // lane j: the count of hypothesis h0 + j
  for (int c = 0; c < N; c += kPass) {
    if (c != 0) __syncthreads();               // the previous pass is consumed
    // every load first, then the stores: one round trip to memory
    float2 u[kPer], v[kPer];
    uint8_t m[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = c + i * kThreads + threadIdx.x;
      u[i] = v[i] = make_float2(0.f, 0.f);
      m[i] = 0;
      if (e < N) {
        u[i] = p1[row + e];
        v[i] = p2[row + e];
        m[i] = mask[row + e];
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      pts[i * kThreads + threadIdx.x] = make_float4(m[i] ? u[i].x : nan, u[i].y, v[i].x, v[i].y);
    __syncthreads();
    float4 pt[kRegs];
#pragma unroll
    for (int i = 0; i < kRegs; ++i) pt[i] = pts[i * 32 + lane];
    float fn[9];                               // the next hypothesis, loaded a turn ahead
#pragma unroll
    for (int i = 0; i < 9; ++i) fn[i] = f0[i];
    for (int j = 0; j < nk; ++j) {
      float f[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) f[i] = fn[i];
      if (j + 1 < nk) {
#pragma unroll
        for (int i = 0; i < 9; ++i) fn[i] = Fw[(j + 1) * 9 + i];
      }
      int cnt = 0;
#pragma unroll
      for (int i = 0; i < kRegs; ++i) cnt += inlier(f, pt[i], tau2);
      cnt = __reduce_add_sync(0xffffffffu, cnt);
      if (lane == j) total += cnt;
    }
  }
  if (lane < nk) counts[static_cast<size_t>(b) * H + h0 + lane] = total;
}

template <int kRegs>
void launch(dim3 grid, int warps, cudaStream_t st, const float* f, const float2* a,
            const float2* c, const uint8_t* m, int* out, int H, int N, float tau2,
            int per_warp) {
  if (warps == 2)
    ransac_score_kernel<2, kRegs><<<grid, 64, 0, st>>>(f, a, c, m, out, H, N, tau2, per_warp);
  else
    ransac_score_kernel<8, kRegs><<<grid, 256, 0, st>>>(f, a, c, m, out, H, N, tau2, per_warp);
}

}  // namespace

// F [B, H, 3, 3] f32, p1/p2 [B, N, 2] f32, mask [B, N] bool → counts [B, H] i32;
// `warps` ∈ {2, 8} a block, `per_warp` ∈ 1..16 hypotheses a warp
PMT_EXPORT int pmt_ransac_score(const void* F, const void* p1, const void* p2,
                                const void* mask, void* counts, int B, int H,
                                int N, float tau2, int warps, int per_warp,
                                void* stream) {
  if (B == 0 || H == 0) return 0;
  if ((warps != 2 && warps != 8) || per_warp < 1 || per_warp > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((H + warps * per_warp - 1) / (warps * per_warp), B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(F);
  const float2* a = static_cast<const float2*>(p1);
  const float2* c = static_cast<const float2*>(p2);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int* out = static_cast<int*>(counts);
  // a lane holds 8 points where N ≤ 256, else 16 (N ≤ 512 in one pass)
  if (N <= 256)
    launch<8>(grid, warps, st, f, a, c, m, out, H, N, tau2, per_warp);
  else
    launch<16>(grid, warps, st, f, a, c, m, out, H, N, tau2, per_warp);
  PMT_RETURN_LAUNCH_STATUS();
}
