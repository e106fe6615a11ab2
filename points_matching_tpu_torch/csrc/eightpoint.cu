// K3 — batched minimal 8-point solve, the RANSAC hypothesis factory.
//
// Replaces the TPU kernel points_matching_tpu/ops/pallas/eightpoint_kernel.py
// minimal_eight_point (_eightpoint_kernel, _hartley, _chol_unrolled,
// _chol_solve_unrolled, _smallest_eigvec).  Same chain, same constants:
//   Hartley normalization (max(mean_dist, 1e-9)) → AᵀA (9×9) →
//   Cholesky of AᵀA + εI (ε = 1e-5·tr/9 + 1e-20, sqrt(max(·, 1e-30)) pivots)
//   → 4 inverse iterations from the golden-angle start cos(i·2.399963)+0.1
//   → rank-2 projection via the smallest eigenvector of FᵀF (3×3, ε with
//   n = 3, 8 iterations) → denormalization → unit Frobenius norm and the
//   sign pivot (largest |entry| positive, first on ties).
//
// Design: one thread per hypothesis, every loop fully unrolled so the 9×9
// and 3×3 matrices live in registers; the 32 input floats and 9 output
// floats per hypothesis are the only memory traffic.  Built with
// --fmad=false and written in the operation order of the plain PyTorch
// version (ops/kernels/eightpoint_kernel.py), so the two agree to the last
// bit wherever the card's sqrt and division are IEEE-exact (they are
// without --use_fast_math).
//
// What bounds it on the card: fp32 issue and registers — ~2.1 kflop per
// hypothesis against 164 bytes, so memory is irrelevant; at 64 × 512
// hypotheses the batch is 32 k threads, a fraction of one wave at the
// register count this chain needs.
#include "pmt_common.cuh"

namespace {

constexpr int kThreads = 128;

// golden-angle start vector cos(i·2.399963) + 0.1, rounded to fp32
__constant__ float kStart[9] = {
    1.100000023841858f,   -0.6373687386512756f, 0.18742527067661285f,
    0.7084394097328186f,  -0.8847136497497559f, 0.9437546730041504f,
    -0.15960296988487244f, -0.3609084486961365f, 1.0393218994140625f};

// Inverse-iteration smallest eigenvector of the symmetric PSD matrix whose
// lower triangle is M[i][j], j ≤ i.
template <int N, int ITERS>
__device__ __forceinline__ void smallest_eigvec(const float (&M)[N][N],
                                                float (&v)[N]) {
  constexpr float kEpsScale = static_cast<float>(1e-5 / N);
  float tr = M[0][0];
#pragma unroll
  for (int i = 1; i < N; ++i) tr = tr + M[i][i];
  const float eps = tr * kEpsScale + 1e-20f;

  float L[N][N];
  float invd[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float s = M[j][j] + eps;
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    const float d = sqrtf(fmaxf(s, 1e-30f));
    const float inv = 1.0f / d;
    L[j][j] = d;
    invd[j] = inv;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      float s2 = M[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s2 = s2 - L[i][k] * L[j][k];
      L[i][j] = s2 * inv;
    }
  }

#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = kStart[i];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    float y[N], x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = v[i];
#pragma unroll
      for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
      y[i] = s * invd[i];
    }
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
      float s = y[i];
#pragma unroll
      for (int k = i + 1; k < N; ++k) s = s - L[k][i] * x[k];
      x[i] = s * invd[i];
    }
    float ss = x[0] * x[0];
#pragma unroll
    for (int i = 1; i < N; ++i) ss = ss + x[i] * x[i];
    const float norm = sqrtf(ss);
    const bool ok = norm > 1e-20f && isfinite(norm);
    const float inv = 1.0f / fmaxf(norm, 1e-20f);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = ok ? x[i] * inv : (i == 0 ? 1.f : 0.f);
  }
}

// Unweighted Hartley normalization of 8 points, in place.
__device__ __forceinline__ void hartley(float (&xs)[8], float (&ys)[8],
                                        float& cx, float& cy, float& s) {
  cx = xs[0];
  cy = ys[0];
#pragma unroll
  for (int p = 1; p < 8; ++p) {
    cx = cx + xs[p];
    cy = cy + ys[p];
  }
  cx = cx * 0.125f;
  cy = cy * 0.125f;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    xs[p] = xs[p] - cx;
    ys[p] = ys[p] - cy;
  }
  float md = sqrtf(xs[0] * xs[0] + ys[0] * ys[0]);
#pragma unroll
  for (int p = 1; p < 8; ++p) md = md + sqrtf(xs[p] * xs[p] + ys[p] * ys[p]);
  md = md * 0.125f;
  s = 1.4142135623730951f / fmaxf(md, 1e-9f);
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    xs[p] = xs[p] * s;
    ys[p] = ys[p] * s;
  }
}

__global__ void __launch_bounds__(kThreads)
eight_point_kernel(const float* __restrict__ sp1, const float* __restrict__ sp2,
                   float* __restrict__ out, int count) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= count) return;

  float x1[8], y1[8], x2[8], y2[8];
  const float2* a = reinterpret_cast<const float2*>(sp1) + static_cast<size_t>(g) * 8;
  const float2* c = reinterpret_cast<const float2*>(sp2) + static_cast<size_t>(g) * 8;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const float2 u = a[p];
    const float2 v = c[p];
    x1[p] = u.x;
    y1[p] = u.y;
    x2[p] = v.x;
    y2[p] = v.y;
  }
  float cx1, cy1, s1, cx2, cy2, s2;
  hartley(x1, y1, cx1, cy1, s1);
  hartley(x2, y2, cx2, cy2, s2);

  // AᵀA over the constraint rows [x2x1, x2y1, x2, y2x1, y2y1, y2, x1, y1, 1]
  float ATA[9][9];
#pragma unroll
  for (int i = 0; i < 9; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) ATA[i][j] = 0.f;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const float r[9] = {x2[p] * x1[p], x2[p] * y1[p], x2[p],
                        y2[p] * x1[p], y2[p] * y1[p], y2[p],
                        x1[p],         y1[p],         1.f};
#pragma unroll
    for (int i = 0; i < 9; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) ATA[i][j] = ATA[i][j] + r[i] * r[j];
  }

  float f[9];
  smallest_eigvec<9, 4>(ATA, f);

  // rank-2 projection: Fn ← Fn − (Fn v₃) v₃ᵀ, v₃ from FnᵀFn
  float M[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = f[i] * f[j];
#pragma unroll
      for (int k = 1; k < 3; ++k) s = s + f[3 * k + i] * f[3 * k + j];
      M[i][j] = s;
    }
  float v3[3];
  smallest_eigvec<3, 8>(M, v3);
  float Fr[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float fv = f[3 * i] * v3[0] + f[3 * i + 1] * v3[1] + f[3 * i + 2] * v3[2];
#pragma unroll
    for (int j = 0; j < 3; ++j) Fr[i][j] = f[3 * i + j] - fv * v3[j];
  }

  // denormalize: F = T2ᵀ Fr T1, T = [[s, 0, -s·cx], [0, s, -s·cy], [0, 0, 1]]
  float G[3][3], F[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    G[i][0] = Fr[i][0] * s1;
    G[i][1] = Fr[i][1] * s1;
    G[i][2] = Fr[i][2] - cx1 * G[i][0] - cy1 * G[i][1];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    F[0][j] = G[0][j] * s2;
    F[1][j] = G[1][j] * s2;
    F[2][j] = G[2][j] - cx2 * F[0][j] - cy2 * F[1][j];
  }

  // unit Frobenius norm, then the largest-|entry| (first on ties) positive
  float ss = F[0][0] * F[0][0];
#pragma unroll
  for (int k = 1; k < 9; ++k) ss = ss + F[k / 3][k % 3] * F[k / 3][k % 3];
  const float inv = 1.0f / fmaxf(sqrtf(ss), 1e-12f);
  float flat[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) flat[k] = F[k / 3][k % 3] * inv;
  float best_abs = fabsf(flat[0]);
  float best = flat[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) {
    const float ak = fabsf(flat[k]);
    if (ak > best_abs) {
      best_abs = ak;
      best = flat[k];
    }
  }
  const float sign = best < 0.f ? -1.f : 1.f;
  float* o = out + static_cast<size_t>(g) * 9;
#pragma unroll
  for (int k = 0; k < 9; ++k) o[k] = flat[k] * sign;
}

}  // namespace

// sp1, sp2 [count, 8, 2] f32 → F [count, 3, 3] f32
PMT_EXPORT int pmt_eight_point(const void* sp1, const void* sp2, void* F,
                               int count, void* stream) {
  if (count == 0) return 0;
  const int grid = (count + kThreads - 1) / kThreads;
  eight_point_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sp1), static_cast<const float*>(sp2),
      static_cast<float*>(F), count);
  PMT_RETURN_LAUNCH_STATUS();
}
