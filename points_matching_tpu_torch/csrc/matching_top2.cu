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
// Design: one block = one pair × 128 query rows, one thread per query row.
// The query row lives in registers; train rows are staged through shared
// memory in tiles of 32 KB and read back as broadcasts (every thread of a
// warp reads the same address), so each float4 shared load feeds 4 FMAs.
// Each thread scans the train columns in increasing order and keeps its
// running (b1, b2, i1, i2) in registers; the strict `<` update
//     d < b1 → (b2, i2) = (b1, i1), (b1, i1) = (d, j);  else d < b2 → (b2, i2) = (d, j)
// reproduces the reference's "lowest column on ties" and its true 2-NN.
// The sentinels start at (1e30, index 0), which reproduces the reference's
// answer when fewer than two train rows are valid.
//
// What bounds it on the card: fp32 FFMA issue plus one shared-memory
// broadcast load per 4 FMAs — 2·N1·N2·D flops per pair against
// (N1 + N2)·D·4 bytes, i.e. compute-bound (D = 64: ~32 flop/byte per
// pair even before the tile reuse).  Tensor cores (wgmma) are the later
// speed-up; the f32 path would need 3×TF32 to stay exact.
//
// compute_dtype='bf16': both operands are rounded to bf16 and the products
// accumulate in fp32 — exactly what the MXU path computes (bf16 × bf16
// products are exact in fp32).  ‖t‖² and ‖q‖² stay fp32, as in the reference.
#include "pmt_common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kRowsPerBlock = 128;
constexpr int kTileFloats = 8192;  // 32 KB of train rows per tile
constexpr int D = 64;              // descriptor width: 64-d SURF

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float4 round_bf16(float4 v) {
  return make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z),
                     round_bf16(v.w));
}

template <bool BF16, bool POINTS>
__global__ void __launch_bounds__(kRowsPerBlock)
l2_top2_kernel(const float* __restrict__ q, const float* __restrict__ t,
               const uint8_t* __restrict__ t_mask,
               const float* __restrict__ t_points, float* __restrict__ dist,
               int* __restrict__ idx, float* __restrict__ pts, int N1, int N2,
               int P) {
  constexpr int TT = kTileFloats / D;  // train rows per tile
  __shared__ __align__(16) float ts[TT * D];
  __shared__ float t2s[TT];

  const int b = blockIdx.y;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x;
  const bool active = row < N1;
  const float* tb = t + static_cast<size_t>(b) * N2 * D;
  const uint8_t* mb = t_mask + static_cast<size_t>(b) * N2;

  float qr[D];
  float q2 = 0.f;
  if (active) {
    const float4* qv = reinterpret_cast<const float4*>(
        q + (static_cast<size_t>(b) * N1 + row) * D);
#pragma unroll
    for (int k = 0; k < D / 4; ++k) {
      const float4 v = qv[k];
      qr[4 * k + 0] = v.x;
      qr[4 * k + 1] = v.y;
      qr[4 * k + 2] = v.z;
      qr[4 * k + 3] = v.w;
    }
#pragma unroll
    for (int k = 0; k < D; ++k) q2 = fmaf(qr[k], qr[k], q2);
    if (BF16) {
#pragma unroll
      for (int k = 0; k < D; ++k) qr[k] = round_bf16(qr[k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < D; ++k) qr[k] = 0.f;
  }

  float b1 = kPmtBig, b2 = kPmtBig;
  int i1 = 0, i2 = 0;

  for (int base = 0; base < N2; base += TT) {
    const int rows = min(TT, N2 - base);
    __syncthreads();  // the previous tile is fully consumed
    const float4* src = reinterpret_cast<const float4*>(
        tb + static_cast<size_t>(base) * D);
    float4* dst = reinterpret_cast<float4*>(ts);
    for (int e = threadIdx.x; e < rows * (D / 4); e += kRowsPerBlock) {
      const float4 v = src[e];
      dst[e] = BF16 ? round_bf16(v) : v;
    }
    // ‖t‖² of the UNROUNDED row (fp32, as the reference computes it);
    // the re-read hits the cache lines the staging loop just brought in
    for (int r = threadIdx.x; r < rows; r += kRowsPerBlock) {
      const float4* tr = reinterpret_cast<const float4*>(
          tb + static_cast<size_t>(base + r) * D);
      float s = 0.f;
#pragma unroll 4
      for (int k = 0; k < D / 4; ++k) {
        const float4 v = tr[k];
        s = fmaf(v.x, v.x, s);
        s = fmaf(v.y, v.y, s);
        s = fmaf(v.z, v.z, s);
        s = fmaf(v.w, v.w, s);
      }
      t2s[r] = mb[base + r] ? s : kPmtBig;
    }
    __syncthreads();

    if (active) {
      for (int r = 0; r < rows; ++r) {
        const float4* tv = reinterpret_cast<const float4*>(ts + r * D);
        // four partial sums: independent FMA chains for latency hiding
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
        for (int k = 0; k < D / 4; ++k) {
          const float4 v = tv[k];
          a0 = fmaf(qr[4 * k + 0], v.x, a0);
          a1 = fmaf(qr[4 * k + 1], v.y, a1);
          a2 = fmaf(qr[4 * k + 2], v.z, a2);
          a3 = fmaf(qr[4 * k + 3], v.w, a3);
        }
        const float dot = (a0 + a1) + (a2 + a3);
        const float d = t2s[r] - 2.0f * dot;
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
  dist[2 * o + 0] = fmaxf(b1 + q2, 0.f);
  dist[2 * o + 1] = fmaxf(b2 + q2, 0.f);
  idx[2 * o + 0] = i1;
  idx[2 * o + 1] = i2;
  if (POINTS) {
    // exact: a direct load of t_points[i1] (the TPU kernel needed a
    // one-hot dot with a 3-term bf16 split for this)
    const float* tp = t_points + (static_cast<size_t>(b) * N2 + i1) * P;
    for (int p = 0; p < P; ++p) pts[o * P + p] = tp[p];
  }
}

void launch(const float* q, const float* t, const uint8_t* t_mask,
            const float* t_points, float* dist, int* idx, float* pts, int B,
            int N1, int N2, int P, bool bf16, cudaStream_t stream) {
  const dim3 grid((N1 + kRowsPerBlock - 1) / kRowsPerBlock, B);
  const dim3 block(kRowsPerBlock);
  if (bf16) {
    if (t_points)
      l2_top2_kernel<true, true><<<grid, block, 0, stream>>>(
          q, t, t_mask, t_points, dist, idx, pts, N1, N2, P);
    else
      l2_top2_kernel<true, false><<<grid, block, 0, stream>>>(
          q, t, t_mask, t_points, dist, idx, pts, N1, N2, P);
  } else {
    if (t_points)
      l2_top2_kernel<false, true><<<grid, block, 0, stream>>>(
          q, t, t_mask, t_points, dist, idx, pts, N1, N2, P);
    else
      l2_top2_kernel<false, false><<<grid, block, 0, stream>>>(
          q, t, t_mask, t_points, dist, idx, pts, N1, N2, P);
  }
}

}  // namespace

// q [B, N1, D] f32, t [B, N2, D] f32, t_mask [B, N2] bool,
// t_points [B, N2, P] f32 or NULL → dist [B, N1, 2] f32, idx [B, N1, 2] i32,
// pts [B, N1, P] f32 (when t_points is given).  D must be 64.
PMT_EXPORT int pmt_l2_top2(const void* q, const void* t, const void* t_mask,
                           const void* t_points, void* dist, void* idx,
                           void* pts, int B, int N1, int N2, int D_in, int P,
                           int bf16, void* stream) {
  if (D_in != D) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N1 == 0) return 0;
  launch(static_cast<const float*>(q), static_cast<const float*>(t),
         static_cast<const uint8_t*>(t_mask),
         static_cast<const float*>(t_points), static_cast<float*>(dist),
         static_cast<int*>(idx), static_cast<float*>(pts), B, N1, N2, P, bf16,
         static_cast<cudaStream_t>(stream));
  PMT_RETURN_LAUNCH_STATUS();
}

PMT_EXPORT const char* pmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
